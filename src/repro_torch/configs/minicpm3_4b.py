"""minicpm3-4b [dense] — MLA (multi-head latent attention) [hf:openbmb/MiniCPM3-4B]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    attn_type="mla", kv_lora_rank=256, q_lora_rank=768,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    mlp_type="swiglu",
)

REDUCED = ModelConfig(
    name="minicpm3-4b-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    attn_type="mla", kv_lora_rank=32, q_lora_rank=48,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    mlp_type="swiglu", dtype="float32",
)
