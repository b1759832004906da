"""LM serving path of the port: dense GQA and SSM decoders."""
from .config import ModelConfig
from .model import (Decoder, decode_step, forward, init_cache, init_params)

__all__ = ["ModelConfig", "Decoder", "forward", "init_params", "init_cache",
           "decode_step"]
