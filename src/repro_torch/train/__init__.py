"""Training substrate of the port: AdamW, the train step, checkpoints,
gradient compression and the heterogeneous batch split
(``src/repro/train/``)."""
from .checkpoint import CheckpointManager
from .compression import compress_grads, dequantize_int8, quantize_int8
from .hetero_batch import heterogeneous_batch_split
from .optimizer import adamw_init, adamw_update
from .train_step import (loss_and_grads, make_loss_fn, make_train_step,
                         named_parameters)

__all__ = ["adamw_init", "adamw_update", "make_train_step", "make_loss_fn",
           "CheckpointManager", "quantize_int8", "dequantize_int8",
           "compress_grads", "heterogeneous_batch_split", "loss_and_grads",
           "named_parameters"]
