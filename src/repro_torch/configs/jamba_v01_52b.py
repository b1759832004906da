"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
on every other layer [arXiv:2403.19887].

Note: Jamba's SSM layers are Mamba-1 in the original; the reference
implements them with the SSD (Mamba-2) formulation (same state size and
interface, the chunked scan), and so does the port (the ``ssd`` kernel).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_every=2,
    attn_every=8,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    mlp_type="swiglu",
)

REDUCED = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=128, vocab_size=512,
    num_experts=4, experts_per_token=2, moe_every=2,
    attn_every=8,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_groups=1,
    ssd_chunk=16, mlp_type="swiglu", dtype="float32",
)
