"""LM path of the port: dense GQA, MLA, SSM, MoE, hybrid and
embedding-input decoders, for serving and training."""
from .config import ModelConfig
from .model import (Decoder, active_param_count, decode_step, forward,
                    init_cache, init_params, param_count,
                    reference_path)

__all__ = ["ModelConfig", "Decoder", "forward", "init_params", "init_cache",
           "decode_step", "param_count", "active_param_count",
           "reference_path"]
