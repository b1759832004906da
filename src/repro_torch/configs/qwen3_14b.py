"""qwen3-14b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=17408, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, mlp_type="swiglu",
)

REDUCED = ModelConfig(
    name="qwen3-14b-smoke", family="dense",
    num_layers=2, d_model=160, num_heads=5, num_kv_heads=1,
    head_dim=32, d_ff=320, vocab_size=512,
    qk_norm=True, mlp_type="swiglu", dtype="float32",
)
