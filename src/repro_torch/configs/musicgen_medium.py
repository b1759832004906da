"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].  Modality frontend is a stub: input_specs() provides
precomputed frame embeddings (B, S, d_model)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    head_dim=64, d_ff=6144, vocab_size=2048,
    mlp_type="gelu", input_mode="embeddings",
)

REDUCED = ModelConfig(
    name="musicgen-smoke", family="audio",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=256,
    mlp_type="gelu", input_mode="embeddings", dtype="float32",
)
