"""LM serving path of the port: dense GQA, SSM, MoE and hybrid decoders."""
from .config import ModelConfig
from .model import (Decoder, active_param_count, decode_step, forward,
                    init_cache, init_params, param_count)

__all__ = ["ModelConfig", "Decoder", "forward", "init_params", "init_cache",
           "decode_step", "param_count", "active_param_count"]
