"""mamba2-780m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=0, vocab_size=50280,
    attn_type="none", mlp_type="none",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-780m-smoke", family="ssm",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=512,
    attn_type="none", mlp_type="none",
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_groups=1,
    ssd_chunk=16, tie_embeddings=True, dtype="float32",
)
