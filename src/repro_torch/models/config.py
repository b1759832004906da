"""Architecture configuration for the composable decoder stack."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm | moe | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    # attention flavor
    attn_type: str = "gqa"        # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0    # glm4 rotates half the head dim

    # MLA (minicpm3)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1            # jamba: MoE on every 2nd layer
    capacity_factor: float = 1.25

    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 128

    # hybrid pattern: one attention layer per `attn_every` (jamba 1:7)
    attn_every: int = 0

    # misc
    mlp_type: str = "swiglu"      # swiglu | geglu | gelu | none
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    input_mode: str = "tokens"    # tokens | embeddings (audio/vlm stubs)
    max_seq_len: int = 131072
    dtype: str = "bfloat16"

    # ---- performance knobs (hillclimbed in EXPERIMENTS.md §Perf) -------
    act_shard: str = "none"       # none | batch: pin residual stream to DP
                                  # sharding | seq: Megatron-SP over S
    moe_ep: bool = False          # constrain expert buffers to EP sharding
    moe_groups: int = 0           # >0: group-local token dispatch (sorts
                                  # stay shard-local; one all-to-all into
                                  # expert sharding instead of global sort)
    pad_group_to: int = 0         # GQA in-group q-head padding: pad each
                                  # kv group to this size (exact semantics,
                                  # enables clean head TP for 40-head archs)
    block_q: int = 512            # flash-attention tile sizes
    block_k: int = 1024

    # ----- derived -----------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:     # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def num_heads_padded(self) -> int:
        """Q heads after in-group padding (pad_group_to); == num_heads when
        the knob is off.  Padded slots carry zero weights (exact semantics)
        and make the head count divisible for clean TP."""
        if self.attn_type != "gqa" or not self.pad_group_to:
            return self.num_heads
        g = self.num_heads // self.num_kv_heads
        if self.pad_group_to <= g:
            return self.num_heads
        return self.num_kv_heads * self.pad_group_to

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for the mixer of layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            # 1:7 interleave — one attention layer per attn_every block.
            return "attn" if (i % self.attn_every) == self.attn_every // 2 \
                else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return (i % self.moe_every) == self.moe_every - 1

    @property
    def pattern_period(self) -> int:
        """Layers per scanned super-block (lcm of mixer / moe patterns)."""
        if self.family == "hybrid":
            import math
            return math.lcm(self.attn_every, self.moe_every)
        return self.moe_every if self.num_experts else 1
