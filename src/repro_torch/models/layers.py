"""Neural layers of the LM path: norms, RoPE, GQA and MLA attention, MLP,
MoE and the Mamba-2 mixer, as plain functions over tensors.

Ported from ``src/repro/models/layers.py``, same parameter names and
layouts.  Where the reference computes a Pallas kernel's function in plain
JAX, the port calls the hand-written kernel: single-token ``attention``
with a cache calls ``kernels.decode_attn.decode_attention`` (the twin of
``flash_attention(..., causal=False, kv_lengths=...)`` at S == 1), and
``ssm_mixer`` calls ``kernels.ssd.ssd_chunked`` where the reference calls
``ssd_jax`` (an ``autograd.Function`` on the card, so training
differentiates through it).  Prefill and training attention, and MLA at
every S, stay the plain blockwise ``flash_attention`` as in the reference
(MLA's keys are r + dr wide and its values r wide, which the decode
kernel does not take); the MoE FFN's expert products are plain batched
matrix products (the reference leaves them to XLA).

The reference's cast points are kept: ``rms_norm`` computes in float32 and
casts back, ``xdt`` and ``d_skip`` are cast to x's dtype, the SSM state is
float32.  ``mlp``'s gelu is the tanh approximation (``jax.nn.gelu``'s
default).  The decode cache is updated in place.  Every function is
differentiable: an in-place update never touches a tensor that autograd
saves, outside the decode cache's writes.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..kernels.decode_attn import decode_attention
from ..kernels.ssd import ssd_chunked
from .config import ModelConfig

MASKED = -1e30
gelu = functools.partial(F.gelu, approximate="tanh")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(gen, shape, dtype, scale):
    if gen.device.type == "meta":       # param_count: shapes only
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype) * scale


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (..., S, H, D). Rotates the first ``fraction·D`` dims."""
    D = x.shape[-1]
    rot = int(D * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., :, None, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Blockwise attention (plain torch, prefill and training)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, q_offset=0,
                    kv_lengths=None, block_q: int = 512, block_k: int = 1024):
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, Dv).

    Online softmax over KV blocks inside a loop over Q blocks, so live
    memory is O(block_q · block_k); padding to block multiples and the
    -1e30 mask as in the reference.  q_offset: absolute position of q[0];
    kv_lengths: (B,) valid KV prefix.
    """
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    nq, nk = -(-Sq // bq), -(-Skv // bk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * bq - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * bk - Skv))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * bk - Skv))
    qp = qp.reshape(B, nq, bq, KVH, G, D)
    kp = kp.reshape(B, nk, bk, KVH, D)
    vp = vp.reshape(B, nk, bk, KVH, Dv)
    dev = q.device
    blocks = []
    for qi in range(nq):
        qb = qp[:, qi].float()                             # (B,bq,KVH,G,D)
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, KVH, G, bq), MASKED, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KVH, G, bq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KVH, G, bq, Dv), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kb, vb = kp[:, ki].float(), vp[:, ki].float()  # (B,bk,KVH,D)
            k_pos = ki * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            mask = (k_pos < Skv)[None, :]                  # drop pad
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if kv_lengths is not None:
                mask = mask[None] & (
                    k_pos[None, None, :] < kv_lengths[:, None, None])
                s = torch.where(mask[:, None, None], s, MASKED)
            else:
                s = torch.where(mask[None, None, None], s, MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vb)
            m = m_new
        o = o / torch.clamp(l, min=1e-30)[..., None]
        blocks.append(o.permute(0, 3, 1, 2, 4))            # (B,bq,KVH,G,Dv)
    out = torch.stack(blocks, dim=1).reshape(B, nq * bq, H, Dv)
    return out[:, :Sq].to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def head_pad_mask(cfg: ModelConfig, device=None):
    """(Hp,) 1.0 for real q-head slots, 0.0 for in-group padding slots
    (kv group j owns slots [j·P, (j+1)·P), the first G real); None when
    there is no padding."""
    Hp, H, KVH = cfg.num_heads_padded, cfg.num_heads, cfg.num_kv_heads
    if Hp == H:
        return None
    g, P = H // KVH, Hp // KVH
    real = torch.arange(KVH, device=device)[:, None] * P \
        + torch.arange(g, device=device)[None, :]
    mask = torch.zeros((Hp,), dtype=torch.float32, device=device)
    mask[real.reshape(-1)] = 1.0
    return mask


def init_attention(cfg: ModelConfig, gen: torch.Generator):
    hd, KVH, d = cfg.head_dim_, cfg.num_kv_heads, cfg.d_model
    Hp, dt = cfg.num_heads_padded, _dtype(cfg)
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, Hp, hd), dt, s),
        "wk": _normal(gen, (d, KVH, hd), dt, s),
        "wv": _normal(gen, (d, KVH, hd), dt, s),
        "wo": _normal(gen, (Hp, hd, d), dt, s / math.sqrt(cfg.num_layers)),
    }
    mask = head_pad_mask(cfg, gen.device)
    if mask is not None:
        p["wq"] = p["wq"] * mask[None, :, None].to(dt)
        p["wo"] = p["wo"] * mask[:, None, None].to(dt)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
    return p


def attention(cfg: ModelConfig, p, x, positions, *, cache=None,
              cache_len=None):
    """x: (B, S, d).  cache: dict(k, v: (B, Smax, KVH, hd)), written in
    place at ``cache_len``; S > 1 with a cache is prefill from an empty
    cache, S == 1 is a decode step (the ``decode_attn`` kernel)."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    new_cache = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        idx = cache_len[:, None] + torch.arange(S, device=x.device)[None, :]
        rows = torch.arange(B, device=x.device)[:, None]
        ck[rows, idx] = k
        cv[rows, idx] = v
        new_cache = {"k": ck, "v": cv}
        if S == 1:
            out = decode_attention(q[:, 0], ck, cv, cache_len + 1)[:, None]
        else:
            out = flash_attention(q, ck, cv, causal=True,
                                  kv_lengths=cache_len + S,
                                  block_q=cfg.block_q, block_k=cfg.block_k)
    else:
        out = flash_attention(q, k, v, causal=True,
                              block_q=cfg.block_q, block_k=cfg.block_k)
    mask = head_pad_mask(cfg, x.device)
    if mask is not None:
        out = out * mask[None, None, :, None].to(out.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3 / DeepSeek-style latent KV)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, gen: torch.Generator):
    d, H, dt = cfg.d_model, cfg.num_heads, _dtype(cfg)
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    s = 1.0 / math.sqrt(d)
    p = {
        "w_dkv": _normal(gen, (d, r), dt, s),
        "kv_norm": torch.ones((r,), dtype=dt, device=gen.device),
        "w_uk": _normal(gen, (r, H, dn), dt, 1.0 / math.sqrt(r)),
        "w_uv": _normal(gen, (r, H, dv), dt, 1.0 / math.sqrt(r)),
        "w_kr": _normal(gen, (d, dr), dt, s),
        "wo": _normal(gen, (H, dv, d), dt,
                      1.0 / math.sqrt(H * dv * cfg.num_layers)),
    }
    if qr:
        p["w_dq"] = _normal(gen, (d, qr), dt, s)
        p["q_norm"] = torch.ones((qr,), dtype=dt, device=gen.device)
        p["w_uq"] = _normal(gen, (qr, H, dn + dr), dt, 1.0 / math.sqrt(qr))
    else:
        p["wq"] = _normal(gen, (d, H, dn + dr), dt, s)
    return p


def mla_attention(cfg: ModelConfig, p, x, positions, *, cache=None,
                  cache_len=None):
    """Multi-head latent attention in the absorbed form: the score is
    ``(q_nope·W_uk)·latent + q_rope·k_rope`` over one shared KV head, the
    values are the latent, and ``W_uv`` and ``wo`` apply after attention.
    cache: dict(latent (B, Smax, r), k_rope (B, Smax, dr)), written in
    place at ``cache_len``.  The softmax scale is ``1/√(r + dr)``, the
    reference's (``flash_attention`` over keys r + dr wide)."""
    B, S, _ = x.shape
    dn = cfg.qk_nope_dim
    if cfg.q_lora_rank:
        ql = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dq"]),
                      p["q_norm"], cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", ql, p["w_uq"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    latent = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dkv"]),
                      p["kv_norm"], cfg.norm_eps)
    k_rope = rope(torch.einsum("bsd,dk->bsk", x, p["w_kr"])[:, :, None, :],
                  positions, cfg.rope_theta)[:, :, 0, :]

    new_cache, lengths = None, None
    if cache is not None:
        cl, cr = cache["latent"], cache["k_rope"]
        idx = cache_len[:, None] + torch.arange(S, device=x.device)[None, :]
        rows = torch.arange(B, device=x.device)[:, None]
        cl[rows, idx] = latent
        cr[rows, idx] = k_rope
        new_cache = {"latent": cl, "k_rope": cr}
        latent, k_rope = cl, cr
        lengths = cache_len + S

    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"])
    qq = torch.cat([q_lat, q_rope], dim=-1)                 # (B,S,H,r+dr)
    kk = torch.cat([latent, k_rope], dim=-1)[:, :, None, :]  # (B,Sk,1,r+dr)
    ctx = flash_attention(qq, kk, latent[:, :, None, :],
                          causal=cache is None or S > 1, kv_lengths=lengths,
                          block_q=cfg.block_q, block_k=cfg.block_k)
    out = torch.einsum("bshr,rhv->bshv", ctx, p["w_uv"])    # (B,S,H,dv)
    return torch.einsum("bshv,hvd->bsd", out, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator):
    d, f, dt = cfg.d_model, cfg.d_ff, _dtype(cfg)
    s = 1.0 / math.sqrt(d)
    p = {"w_down": _normal(gen, (f, d), dt, 1.0 / math.sqrt(f * cfg.num_layers))}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _normal(gen, (d, f), dt, s)
        p["w_up"] = _normal(gen, (d, f), dt, s)
    else:
        p["w_up"] = _normal(gen, (d, f), dt, s)
    return p


def mlp(cfg: ModelConfig, p, x):
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else gelu
        h = act(torch.einsum("bsd,df->bsf", x, p["w_gate"])) \
            * torch.einsum("bsd,df->bsf", x, p["w_up"])
    else:
        h = gelu(torch.einsum("bsd,df->bsf", x, p["w_up"]))
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, gen: torch.Generator):
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, _dtype(cfg)
    s = 1.0 / math.sqrt(d)
    return {
        "router": _normal(gen, (d, E), torch.float32, s),
        "w_gate": _normal(gen, (E, d, f), dt, s),
        "w_up": _normal(gen, (E, d, f), dt, s),
        "w_down": _normal(gen, (E, f, d), dt,
                          1.0 / math.sqrt(f * cfg.num_layers)),
    }


def moe_groups(cfg: ModelConfig, N: int) -> int:
    """Token groups of ``N`` tokens, each sorted and capped on its own:
    ``cfg.moe_groups`` where it divides N into groups of at least K."""
    G, K = cfg.moe_groups, cfg.experts_per_token
    return G if (G and N % G == 0 and N // G >= K) else 1


def moe_capacity(cfg: ModelConfig, n: int) -> int:
    """Slots an expert of a group of ``n`` tokens: cf-scaled, clamped so
    small serving batches (decode: one token a sequence) never drop."""
    K, E = cfg.experts_per_token, cfg.num_experts
    return max(1, int(cfg.capacity_factor * n * K / E), min(n, 128))


def moe_route(cfg: ModelConfig, p, xf):
    """The router on xf (G, n, d): each token's top-K experts by float32
    logit, in descending order, and their softmax weights, (G, n, K)."""
    logits = torch.einsum("gnd,de->gne", xf.float(), p["router"])
    gates, idx = torch.topk(logits, cfg.experts_per_token, dim=-1,
                            sorted=True)
    return torch.softmax(gates, dim=-1), idx


def moe_combine(table, slot, weight, order, K: int):
    """out[t] = Σ table[slot[j]] · weight[j] over the K entries j of token
    t, in table's dtype, added one at a time in ascending sorted position:
    the order in which the reference's serial scatter-add
    ``out.at[gtok].add(...)`` meets them, so the sum rounds as it does.

    table (R, d); slot (G, n·K) rows of ``table`` and weight (G, n·K) in
    table's dtype, both in sorted order; order (G, n·K) the sort
    permutation: sorted entry j of group g is entry ``t·K + k`` of the
    group's tokens.  Returns (G·n, d).  Deterministic: no atomics."""
    G, nK = order.shape
    n = nK // K
    sorted_pos = torch.empty_like(order).scatter_(
        -1, order, torch.arange(nK, device=order.device).expand(G, nK))
    # each token's entries, in the order the serial scatter meets them
    mine = sorted_pos.reshape(G, n, K).sort(dim=-1).values
    flat = (torch.arange(G, device=order.device)[:, None, None] * nK
            + mine).reshape(G * n, K)
    terms = table[slot.reshape(-1)[flat]] \
        * weight.reshape(-1)[flat][..., None]              # (G·n, K, d)
    out = torch.zeros((G * n, table.shape[-1]), dtype=table.dtype,
                      device=table.device)
    for j in range(K):
        out = out + terms[:, j]
    return out


def silu_stepwise(x):
    """x · sigmoid(x) as ``jax.nn.silu`` computes it, ``x · (1 / (1 +
    exp(-x)))`` with one rounding to x's dtype after each step (``F.silu``
    rounds once): in bfloat16 the MoE FFN then agrees with the reference's
    on the CPU.  Where autograd records, out of place (it saves exp's and
    the reciprocal's outputs); elsewhere, as in serving, in one buffer
    besides x.  Both give the same bits."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.reciprocal(torch.exp(torch.neg(x)) + 1) * x
    return torch.neg(x).exp_().add_(1).reciprocal_().mul_(x)


def moe_ffn(cfg: ModelConfig, p, x):
    """Token-choice top-k MoE with sort-based capacity dispatch.

    Fixed shapes throughout (a stable argsort, a gather into the expert
    buffer, the deterministic ``moe_combine``), and no host sync: the
    capacity comes from shapes.  With ``cfg.moe_groups = G`` the tokens
    form G groups, each sorted and capped on its own.  ``cfg.moe_ep`` is a
    sharding constraint in the reference, a no-op on one device, and is
    ignored here.
    """
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * S
    G = moe_groups(cfg, N)
    n = N // G
    dev = x.device
    xf = x.reshape(G, n, d)
    weights, idx = moe_route(cfg, p, xf)                   # (G, n, K)
    flat_e = idx.reshape(G, n * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)     # per-group sort
    se = flat_e.gather(-1, order)
    stok = order // K                                      # token of entry
    sw = weights.reshape(G, n * K).gather(-1, order)
    seg_start = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(G, E).contiguous(),
        right=False)
    pos = torch.arange(n * K, device=dev)[None, :] - seg_start.gather(-1, se)
    cap = moe_capacity(cfg, n)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, E * cap)      # overflow -> dump
    gslot = torch.arange(G, device=dev)[:, None] * (E * cap + 1) + slot
    gtok = torch.arange(G, device=dev)[:, None] * n + stok
    # each kept entry fills its slot once; empty slots and the dump row
    # read a zero row (index N), as the reference's zero buffer holds
    src = torch.full((G * (E * cap + 1),), N, dtype=torch.long, device=dev)
    src[gslot.reshape(-1)] = torch.where(keep, gtok, N).reshape(-1)
    rows = torch.cat([x.reshape(N, d), x.new_zeros((1, d))])
    h = rows[src].reshape(G, E * cap + 1, d)[:, :-1].reshape(G, E, cap, d)
    act = silu_stepwise if cfg.mlp_type != "gelu" else gelu
    # in place: autograd saves neither act's output nor the product
    hidden = act(torch.einsum("gecd,edf->gecf", h, p["w_gate"])).mul_(
        torch.einsum("gecd,edf->gecf", h, p["w_up"]))
    out_e = torch.einsum("gecf,efd->gecd", hidden, p["w_down"])
    table = torch.cat([out_e.reshape(G, E * cap, d),
                       x.new_zeros((G, 1, d))], dim=1).reshape(-1, d)
    out = moe_combine(table, gslot, (sw * keep).to(x.dtype), order, K)
    return out.reshape(B, S, d)


# ---------------------------------------------------------------------------
# Mamba-2 mixer (SSD)
# ---------------------------------------------------------------------------

def init_ssm(cfg: ModelConfig, gen: torch.Generator):
    d, di = cfg.d_model, cfg.d_inner
    nh, ds, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_ch = di + 2 * G * ds
    dt, dev, f32 = _dtype(cfg), gen.device, torch.float32
    return {
        "in_proj": _normal(gen, (d, 2 * di + 2 * G * ds + nh), dt,
                           1.0 / math.sqrt(d)),
        "conv_w": _normal(gen, (cfg.conv_width, conv_ch), dt,
                          1.0 / math.sqrt(cfg.conv_width)),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "a_log": torch.zeros((nh,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=dev),
        "d_skip": torch.ones((nh,), dtype=f32, device=dev),
        "out_norm": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": _normal(gen, (di, d), dt,
                            1.0 / math.sqrt(di * cfg.num_layers)),
    }


def _causal_conv(u, w, b):
    """u: (B, T, C) depthwise causal conv, width W; returns same shape.

    A sum of shifted products, as in the reference: ``F.conv1d`` would run
    in TF32 under cuDNN's default on the card."""
    W, T = w.shape[0], u.shape[1]
    # shifted i: position t sees u[t - (W-1-i)]
    out = sum(F.pad(u, (0, 0, W - 1 - i, i))[:, :T] * w[i][None, None, :]
              for i in range(W))
    return out + b[None, None, :]


def ssm_mixer(cfg: ModelConfig, p, x, *, state=None):
    """Mamba-2 block.  state: dict(conv: (B, W-1, C), ssm: (B,nh,ds,dh))
    for single-step decode; "prefill" to also return the state after x;
    None for full-sequence (training)."""
    B, T, _ = x.shape
    di, nh, ds, G = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    dh = cfg.ssm_head_dim
    proj = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xs, bc, dt = torch.split(proj, [di, di, 2 * G * ds, nh], dim=-1)
    conv_in = torch.cat([xs, bc], dim=-1)                  # (B,T,C)
    new_state = None
    decode = isinstance(state, dict)
    if decode:
        # roll the conv buffer one step (T == 1)
        hist = torch.cat([state["conv"], conv_in], dim=1)  # (B,W,C)
        conv = F.silu(torch.einsum("bwc,wc->bc", hist, p["conv_w"])
                      + p["conv_b"])[:, None, :]
        new_conv = hist[:, 1:]
    else:
        conv = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, b, c = torch.split(conv, [di, G * ds, G * ds], dim=-1)
    xh = xs.reshape(B, T, nh, dh)
    bh = b.reshape(B, T, G, ds)
    ch = c.reshape(B, T, G, ds)
    dt = F.softplus(dt.float() + p["dt_bias"])             # (B,T,nh)
    a = -torch.exp(p["a_log"])[None, None, :] * dt         # log decay
    xdt = xh * dt[..., None].to(xh.dtype)
    if state == "prefill":
        y, h_last = ssd_chunked(xdt, bh, ch, a, chunk=cfg.ssd_chunk,
                                return_state=True)
        new_state = {"conv": conv_in[:, -(cfg.conv_width - 1):],
                     "ssm": h_last}
    elif state is None:
        y = ssd_chunked(xdt, bh, ch, a, chunk=cfg.ssd_chunk)
    else:
        # single-step recurrence: h = exp(a) h + B x ; y = C h
        rep = nh // G
        b1 = bh[:, 0].repeat_interleave(rep, dim=1).float()  # (B,nh,ds)
        c1 = ch[:, 0].repeat_interleave(rep, dim=1).float()
        x1 = xdt[:, 0].float()                             # (B,nh,dh)
        h = torch.exp(a[:, 0])[..., None, None] * state["ssm"] \
            + b1[..., :, None] * x1[..., None, :]
        y = torch.einsum("bhs,bhsd->bhd", c1, h)[:, None].to(x.dtype)
        new_state = {"conv": new_conv, "ssm": h}
    y = y.reshape(B, T, nh, dh)
    y = y + p["d_skip"][None, None, :, None].to(y.dtype) * \
        xdt.reshape(B, T, nh, dh)
    y = y.reshape(B, T, di)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    return torch.einsum("bsk,kd->bsd", y, p["out_proj"]), new_state
