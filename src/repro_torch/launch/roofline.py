"""Roofline terms of one (arch × shape) cell on the card's own constants.

The closed-form FLOP and HBM-traffic models of the reference's
``benchmarks/roofline.py`` (``flops_fwd``, ``flops_step``,
``model_flops``, ``bytes_step``, ``_cache_bytes``), copied formula for
formula and held equal to it on every ``cells()`` entry by
``tests/test_torch_launch.py``.  Each step function also takes ``batch=``,
the sequences one card runs in place of the shape's global batch.

    compute = FLOPs / PEAK_FLOPS      memory = HBM bytes / HBM_BW

MODEL_FLOPS = 6·N_active·T for training, 2·N_active·T for serving; the gap
to the analytic total is remat recompute, the attention's quadratic terms
and MoE capacity padding.
"""
from __future__ import annotations

from ..configs import SHAPES
from ..models import active_param_count, param_count

#: NVIDIA H100 SXM5 80GB: bf16 dense tensor-core peak (data sheet, 700 W)
PEAK_FLOPS = 989.4e12
#: NVIDIA H100 SXM5 80GB: HBM3 bandwidth (data sheet)
HBM_BW = 3.35e12


# ---------------------------------------------------------------------------
# analytic FLOP model
# ---------------------------------------------------------------------------

def _matmul_params(cfg) -> int:
    """Active params participating in matmuls (embedding lookup is free)."""
    n = active_param_count(cfg)
    if cfg.input_mode == "tokens" and not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model          # the lookup table
    return n


def _attn_layers(cfg) -> int:
    return sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn")


def _ssm_layers(cfg) -> int:
    return cfg.num_layers - _attn_layers(cfg)


def flops_fwd(cfg, B: int, S: int, ctx: int | None = None) -> float:
    """Forward FLOPs for B sequences of S new tokens (ctx = KV history)."""
    T = B * S
    f = 2.0 * _matmul_params(cfg) * T
    hd, H = cfg.head_dim_, cfg.num_heads
    la, ls = _attn_layers(cfg), _ssm_layers(cfg)
    if la:
        if ctx is None:                      # causal self-attention
            f += la * 2.0 * B * S * S * H * hd
        else:                                # decode: attend over ctx
            qk = (cfg.kv_lora_rank + cfg.qk_rope_dim
                  if cfg.attn_type == "mla" else hd)
            vd = cfg.kv_lora_rank if cfg.attn_type == "mla" else hd
            f += la * 2.0 * B * S * ctx * H * (qk + vd)
    if ls:
        nh, dh, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        L = cfg.ssd_chunk
        if ctx is None:
            f += ls * 2.0 * T * nh * (L * (ds + dh) + 2.0 * ds * dh)
        else:                                # single-step recurrence
            f += ls * 4.0 * B * S * nh * ds * dh
    return f


def _batch(shape: str, batch: int | None) -> tuple[int, int, str]:
    sh = SHAPES[shape]
    B = sh["global_batch"] if batch is None else batch
    return B, sh["seq_len"], sh["kind"]


def flops_step(cfg, shape: str, as_compiled: bool = True, *,
               batch: int | None = None) -> float:
    """Whole-step FLOPs (of ``batch`` sequences where given)."""
    B, S, kind = _batch(shape, batch)
    if kind == "train":
        fwd = flops_fwd(cfg, B, S)
        mult = 4.0 if as_compiled else 3.0   # remat re-forward
        f = fwd * mult
    elif kind == "prefill":
        f = flops_fwd(cfg, B, S)
    else:
        f = flops_fwd(cfg, B, 1, ctx=S)
    if as_compiled and cfg.num_experts:
        f *= cfg.capacity_factor             # expert-buffer padding waste
    return f


def model_flops(cfg, shape: str, *, batch: int | None = None) -> float:
    """MODEL_FLOPS: 6·N_active·D training, 2·N_active·D serving (D =
    tokens processed)."""
    B, S, kind = _batch(shape, batch)
    tokens = B * (S if kind != "decode" else 1)
    n = active_param_count(cfg)
    return (6.0 if kind == "train" else 2.0) * n * tokens


# ---------------------------------------------------------------------------
# analytic HBM-traffic model (per device)
# ---------------------------------------------------------------------------

def bytes_step(cfg, shape: str, devices: int, model_par: int = 16,
               data_par: int | None = None, *,
               batch: int | None = None) -> float:
    B, S, kind = _batch(shape, batch)
    data_par = data_par or max(1, devices // model_par)
    P = param_count(cfg)
    n_params_dev = P / model_par
    if P > 12e9:                              # FSDP'd archs
        n_params_dev /= data_par
    B_dev = max(1, B // data_par)
    d, L = cfg.d_model, cfg.num_layers
    if kind == "train":
        # params: fwd read + bwd read (bf16) + grad w/r (f32) + m,v r/w
        # (f32) + param write — ≈ 30 bytes per element-shard.
        pb = n_params_dev * 30.0
        # activations: ~12 (B,S,d)-sized reads+writes per layer (remat'd),
        # bf16.
        ab = L * B_dev * S * d * 12.0 * 2.0
        return pb + ab
    if kind == "prefill":
        pb = n_params_dev * 2.0
        ab = L * B_dev * S * d * 6.0 * 2.0
        cache = _cache_bytes(cfg, B_dev, S, model_par)
        return pb + ab + cache
    # decode: params once + full cache read per token
    pb = n_params_dev * 2.0
    cache = _cache_bytes(cfg, B_dev, S, model_par)
    return pb + cache


def _cache_bytes(cfg, B_dev, S, model_par) -> float:
    la, ls = _attn_layers(cfg), _ssm_layers(cfg)
    out = 0.0
    if la:
        if cfg.attn_type == "mla":
            per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
        else:
            per_tok = 2 * cfg.num_kv_heads * cfg.head_dim_
        out += la * B_dev * S * per_tok * 2.0 / model_par  # seq- or kv-split
    if ls:
        out += ls * B_dev * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4.0
    return out


def one_card_terms(cfg, shape: str, batch: int) -> dict:
    """The roofline terms of ``batch`` sequences of ``shape`` on one card:
    the compute and memory times, the dominant one, and the FLOP counts."""
    f = flops_step(cfg, shape, batch=batch)
    b = bytes_step(cfg, shape, 1, model_par=1, data_par=1, batch=batch)
    t_c, t_m = f / PEAK_FLOPS, b / HBM_BW
    mf = model_flops(cfg, shape, batch=batch)
    return {"t_compute_s": t_c, "t_memory_s": t_m,
            "dominant": "compute" if t_c >= t_m else "memory",
            "model_flops": mf, "analytic_flops": f,
            "useful_ratio": mf / f, "analytic_bytes": b}
