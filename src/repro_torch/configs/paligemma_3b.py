"""paligemma-3b [vlm] — SigLIP + gemma backbone [arXiv:2407.07726].
Backbone only: the vision tower is a stub; input_specs() provides
precomputed patch+text embeddings (B, S, d_model)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=257216,
    mlp_type="geglu", input_mode="embeddings",
)

REDUCED = ModelConfig(
    name="paligemma-smoke", family="vlm",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
    head_dim=32, d_ff=256, vocab_size=512,
    mlp_type="geglu", input_mode="embeddings", dtype="float32",
)
