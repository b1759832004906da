"""Decoder stack of the LM path: a ``Decoder`` module of sub-layers.

Ported from ``src/repro/models/model.py``.  The reference scans
``num_layers / pattern_period`` super-blocks over parameters stacked on
that axis; here each sub-layer is its own ``Block`` in an ``nn.ModuleList``
(layer ``i`` is super-block ``i // period``, pattern position
``i % period``), run by a Python loop.  The reference's ``_constrain_act``
(a sharding constraint between sub-layers) is a no-op on one device and is
left out.

API:
  init_params(cfg, seed, device) -> Decoder   (frozen)
  forward(cfg, params, inputs, remat=False)
                                          -> logits                (B, S, V)
  init_cache(cfg, batch, max_len, device) -> cache
  decode_step(cfg, params, cache, tokens, cache_len)
                                          -> (logits, cache)
      S > 1 with an all-zero cache_len acts as prefill.
  param_count(cfg), active_param_count(cfg) -> int  (from shapes)
  meta_params(cfg) -> Decoder on the meta device   (names, shapes, dtypes)

The cache keeps the reference's pytree layout, ``{"pos{p}": {leaf: tensor
stacked on n_super}}``, and ``decode_step`` updates it in place (the
returned cache is the same object).  Every arch of the reference is
ported: dense GQA, MLA, SSM, MoE, hybrid (jamba: attention at i % 8 == 4,
MoE at odd i, period 8) and the embedding-input stubs.

``init_params`` returns frozen parameters; ``forward`` builds an autograd
graph once they require gradients (``params.requires_grad_()``, the
module's own method); ``decode_step`` and
``serve.generate`` run under ``torch.no_grad()``.  ``remat=True`` wraps
each super-block in ``torch.utils.checkpoint`` (non-reentrant), where the
reference applies ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable``: the same numbers, another saved set
(the port saves only each super-block's input).
"""
from __future__ import annotations

import math
import types

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Block(nn.Module):
    """One sub-layer: ``ln1``, ``mixer`` (attention or SSM), and with
    ``d_ff > 0`` ``ln2`` and ``ffn`` (an MLP, or experts where
    ``cfg.layer_is_moe``), named as in the reference."""

    def __init__(self, cfg: ModelConfig, pos: int, tensors: dict):
        super().__init__()
        self.kind = cfg.layer_kind(pos)
        self.moe = cfg.layer_is_moe(pos)
        self.ln1 = nn.Parameter(tensors["ln1"], requires_grad=False)
        self.mixer = _params(tensors["mixer"])
        if cfg.d_ff > 0:
            self.ln2 = nn.Parameter(tensors["ln2"], requires_grad=False)
            self.ffn = _params(tensors["ffn"])


class Decoder(nn.Module):
    """Parameters of the decoder: ``embed``/``unembed``, ``final_norm`` and
    ``layers`` (one ``Block`` per sub-layer), frozen until
    ``requires_grad_()``."""

    def __init__(self, cfg: ModelConfig, blocks: list[dict], top: dict):
        super().__init__()
        period = cfg.pattern_period
        self.layers = nn.ModuleList(Block(cfg, i % period, t)
                                    for i, t in enumerate(blocks))
        for name, t in top.items():
            setattr(self, name, nn.Parameter(t, requires_grad=False))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_sublayer(cfg: ModelConfig, pos: int, gen: torch.Generator):
    dev, dt = gen.device, _dt(cfg)
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
    if cfg.layer_kind(pos) == "attn":
        p["mixer"] = (L.init_mla if cfg.attn_type == "mla"
                      else L.init_attention)(cfg, gen)
    else:
        p["mixer"] = L.init_ssm(cfg, gen)
    if cfg.d_ff > 0:
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
        p["ffn"] = (L.init_moe if cfg.layer_is_moe(pos) else L.init_mlp)(
            cfg, gen)
    return p


def _init_top(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = _dt(cfg)
    top = {"final_norm": torch.ones((cfg.d_model,), dtype=dt,
                                    device=gen.device)}
    if cfg.input_mode == "tokens":
        top["embed"] = L._normal(gen, (cfg.vocab_size, cfg.d_model), dt,
                                 0.02)
    if cfg.input_mode != "tokens" or not cfg.tie_embeddings:
        top["unembed"] = L._normal(gen, (cfg.d_model, cfg.vocab_size), dt,
                                   1.0 / math.sqrt(cfg.d_model))
    return top


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Decoder:
    """Random weights with the reference's scales and per-leaf dtypes,
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``
    (other bits than the reference's ``jax.random``), frozen; training
    calls ``requires_grad_()`` on the result."""
    dev = resolve_device(device)
    period = cfg.pattern_period
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} % period "
                         f"{period} != 0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = [_init_sublayer(cfg, i % period, gen)
              for i in range(cfg.num_layers)]
    return Decoder(cfg, blocks, _init_top(cfg, gen))


# ---------------------------------------------------------------------------
# sub-layer application
# ---------------------------------------------------------------------------

def _apply_block(cfg, blk: Block, x, positions, cache, cache_len, mode):
    h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
    if blk.kind == "attn":
        attn = L.mla_attention if cfg.attn_type == "mla" else L.attention
        y, new_cache = attn(cfg, blk.mixer, h, positions, cache=cache,
                            cache_len=cache_len)
    else:
        state = cache if mode == "decode" else (
            "prefill" if mode == "prefill" else None)
        y, new_cache = L.ssm_mixer(cfg, blk.mixer, h, state=state)
    x = x + y
    if cfg.d_ff > 0:
        h = L.rms_norm(x, blk.ln2, cfg.norm_eps)
        x = x + (L.moe_ffn if blk.moe else L.mlp)(cfg, blk.ffn, h)
    return x, new_cache


def _super_block(cfg, blocks, x, positions):
    for blk in blocks:
        x, _ = _apply_block(cfg, blk, x, positions, None, None, "train")
    return x


def _stack(cfg, params: Decoder, x, positions, cache, cache_len, mode,
           remat: bool = False):
    """Run every block; with a cache, write each block's new state into its
    slot of the stacked cache.  ``remat`` (no cache) recomputes each
    super-block in the backward pass from its input."""
    period = cfg.pattern_period
    if remat and cache is None:
        for s in range(0, len(params.layers), period):
            x = checkpoint(_super_block, cfg, params.layers[s:s + period], x,
                           positions, use_reentrant=False)
        return x
    for i, blk in enumerate(params.layers):
        slot = None if cache is None else {
            k: t[i // period] for k, t in cache[f"pos{i % period}"].items()}
        x, new = _apply_block(cfg, blk, x, positions, slot, cache_len, mode)
        if slot is not None:
            for k, t in new.items():
                if t is not slot[k]:
                    slot[k].copy_(t)
    return x


def _embed_in(cfg, params, inputs):
    if cfg.input_mode == "tokens":
        return params.embed[inputs].to(_dt(cfg))
    return inputs.to(_dt(cfg))


def _logits_out(cfg, params, x):
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.input_mode == "tokens" and cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params.embed)
    return torch.einsum("bsd,dv->bsv", x, params.unembed)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Decoder, inputs, *,
            remat: bool = False):
    """Full-sequence forward: inputs (B, S) tokens or (B, S, d) embeddings.
    Differentiable; ``remat`` checkpoints each super-block."""
    x = _embed_in(cfg, params, inputs)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _stack(cfg, params, x, positions, None, None, mode="train",
               remat=remat)
    return _logits_out(cfg, params, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               dtype=None):
    """Decode cache, stacked (n_super, ...) per pattern position, zeros."""
    dev = resolve_device(device)
    dt = dtype or _dt(cfg)
    n_super = cfg.num_layers // cfg.pattern_period
    hd, KVH = cfg.head_dim_, cfg.num_kv_heads
    out = {}
    for pos in range(cfg.pattern_period):
        if cfg.layer_kind(pos) == "attn" and cfg.attn_type == "mla":
            c = {"latent": torch.zeros((n_super, batch, max_len,
                                        cfg.kv_lora_rank), dtype=dt,
                                       device=dev),
                 "k_rope": torch.zeros((n_super, batch, max_len,
                                        cfg.qk_rope_dim), dtype=dt,
                                       device=dev)}
        elif cfg.layer_kind(pos) == "attn":
            shape = (n_super, batch, max_len, KVH, hd)
            c = {"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev)}
        else:
            conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            c = {"conv": torch.zeros((n_super, batch, cfg.conv_width - 1,
                                      conv_ch), dtype=dt, device=dev),
                 "ssm": torch.zeros((n_super, batch, cfg.ssm_heads,
                                     cfg.ssm_state, cfg.ssm_head_dim),
                                    dtype=torch.float32, device=dev)}
        out[f"pos{pos}"] = c
    return out


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Decoder, cache, tokens, cache_len):
    """One serving step.

    tokens: (B, S) or (B, S, d); S == 1 => decode, S > 1 (cache_len == 0)
    => prefill.  Returns (logits (B, S, vocab), cache), the cache updated
    in place.
    """
    S = tokens.shape[1]
    mode = "decode" if S == 1 else "prefill"
    x = _embed_in(cfg, params, tokens)
    positions = cache_len[:, None] + torch.arange(S, device=x.device)[None, :]
    x = _stack(cfg, params, x, positions, cache, cache_len, mode)
    return _logits_out(cfg, params, x), cache


# ---------------------------------------------------------------------------
# parameter accounting
# ---------------------------------------------------------------------------

def meta_params(cfg: ModelConfig) -> Decoder:
    """The :class:`Decoder` of ``init_params(cfg)`` on the ``meta``
    device: its parameters' names, shapes and dtypes, nothing allocated."""
    meta = types.SimpleNamespace(device=torch.device("meta"))
    period = cfg.pattern_period
    return Decoder(cfg, [_init_sublayer(cfg, i % period, meta)
                         for i in range(cfg.num_layers)],
                   _init_top(cfg, meta))


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``init_params(cfg)``, from :func:`meta_params`."""
    return sum(p.numel() for p in meta_params(cfg).parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """Per-token active params (MoE: only top-k experts count)."""
    total = param_count(cfg)
    if cfg.num_experts == 0:
        return total
    # subtract inactive expert weights
    d, f, E, K = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.experts_per_token
    per_layer_expert = 3 * d * f
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.layer_is_moe(i))
    return int(total - n_moe * (E - K) * per_layer_expert)


def reference_path(cfg: ModelConfig, name: str) -> tuple[str, int]:
    """Where the parameter ``name`` of a :class:`Decoder` (``named_parameters``)
    lies in the reference's pytree: its ``/``-joined path, and its index on
    the leaf's stacked ``n_super`` axis (0 for an unstacked leaf).  Sorting
    by it gives the reference's leaf order (``jax.tree.leaves``: sorted
    dict keys), layer by layer within a stacked leaf."""
    parts = name.split(".")
    if parts[0] != "layers":
        return "/".join(parts), 0
    i, period = int(parts[1]), cfg.pattern_period
    return "/".join(["blocks", f"pos{i % period}", *parts[2:]]), i // period
