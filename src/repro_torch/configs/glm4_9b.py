"""glm4-9b [dense] — RoPE (partial), GQA kv=2 [hf:THUDM/glm-4-9b]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    rope_fraction=0.5, mlp_type="swiglu",
)

REDUCED = ModelConfig(
    name="glm4-9b-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    rope_fraction=0.5, mlp_type="swiglu", dtype="float32",
)
