"""qwen3-4b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=9728, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, mlp_type="swiglu",
)

REDUCED = ModelConfig(
    name="qwen3-4b-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512,
    qk_norm=True, mlp_type="swiglu", dtype="float32",
)
