"""Gradient compression: int8 symmetric quantization with per-tensor scale.

Ported from ``src/repro/train/compression.py``: the numerics of an
int8-compressed all-reduce (quantize → dequantize), not the wire format.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

#: tensors of at most this many elements (norms, biases) stay exact
EXACT_NUMEL = 1024


def quantize_int8(x):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    return _quantize(x, scale), scale


def _quantize(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_grads(grads, leaf_of=None):
    """Round-trip every tensor of ``grads`` (a tensor or a dict of them,
    nested) through int8, keeping its dtype; small tensors stay exact.

    ``leaf_of(name)`` (a flat dict's keys) names the reference leaf a
    tensor is part of: the tensors of one leaf (a model's layers, which
    the reference stacks) share one scale, their largest magnitude, and
    the size rule counts the whole leaf."""
    if not isinstance(grads, dict):
        return _roundtrip([grads])[0]
    if leaf_of is None:
        return {k: compress_grads(v) for k, v in grads.items()}
    groups: dict = {}
    for name in grads:
        groups.setdefault(leaf_of(name), []).append(name)
    out = {}
    for names in groups.values():
        out.update(zip(names, _roundtrip([grads[n] for n in names])))
    return {k: out[k] for k in grads}


def _roundtrip(parts: list) -> list:
    """The tensors of one leaf through int8 at the leaf's one scale."""
    if sum(g.numel() for g in parts) <= EXACT_NUMEL:
        return parts
    scale = torch.clamp(torch.stack([g.abs().max().float() for g in parts])
                        .max(), min=1e-12) / 127.0
    return [dequantize_int8(_quantize(g.float(), scale), scale).to(g.dtype)
            for g in parts]
