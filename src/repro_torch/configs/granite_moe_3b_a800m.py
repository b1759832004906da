"""granite-moe-3b-a800m [moe] — 40 experts top-8, per-expert d_ff=512
[hf:ibm-granite family]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    head_dim=64, d_ff=512, vocab_size=49155,
    num_experts=40, experts_per_token=8, moe_every=1,
    mlp_type="swiglu",
)

REDUCED = ModelConfig(
    name="granite-moe-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=64, vocab_size=512,
    num_experts=8, experts_per_token=2, moe_every=1,
    mlp_type="swiglu", dtype="float32",
)
