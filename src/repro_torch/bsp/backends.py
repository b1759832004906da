"""Edge-kernel backends: how a BSP superstep combines messages over edges.

Every edge-centric superstep is one semiring SpMV against each machine's
local adjacency (``y_i = ⊕_j A_ij ⊗ x_j``, symmetric A).  A backend
supplies that product: ``prepare(rt, semiring, weights)`` returns
``(extras, combine)``, where ``extras`` is a dict of ``(p, ...)`` tensors
merged into the superstep's static tree and ``combine(sa, x)`` maps the
``(p, Vmax)`` vertex values to their ⊕-combined neighborhood values.

``scatter``
    The gather-scatter loop (``out[dst] ⊕= x[src] ⊗ w``, one scatter per
    direction): the oracle every other backend is held against.
``pallas``
    The Block-ELL hand kernel (``kernels/bsr_spmv``) over
    ``rt.local_bsr()``'s degree-sorted per-machine layout: ``x[gather]``,
    the kernel, then ``y[rank]``.  The name is the reference's, so that
    ``--backend pallas`` drives the counterpart in both command lines.

(+, ×) results agree across backends to float32 reassociation; (min, +)
and (or, and) are exact.  ``message_dtype`` takes ``"float32"`` only in
this package so far.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..kernels.bsr_spmv import bsr_spmv, get_semiring
from .engine import exchange
from .partition_runtime import WEIGHT_KINDS

#: message dtypes this package accepts
MESSAGE_DTYPES = ("float32",)


def _message_dtype(name: str) -> torch.dtype:
    if str(name) not in MESSAGE_DTYPES:
        raise ValueError(f"message_dtype must be one of {MESSAGE_DTYPES}, "
                         f"got {name!r}")
    return torch.float32


@dataclasses.dataclass(frozen=True)
class EdgeBackend:
    """A named edge-combine strategy (see module docstring)."""

    name: str
    description: str
    prepare: Callable          # (rt, semiring, weights) -> (extras, combine)

    def prepare_exchanged(self, rt, semiring: str, weights: str,
                          mode: str, r_pad: int):
        """``prepare`` with the replica :func:`~.engine.exchange` fused into
        the combine epilogue: ``combine(sa, x)`` yields post-exchange
        neighborhood values."""
        extras, combine = self.prepare(rt, semiring, weights)

        def combine_exchanged(sa, x):
            return exchange(combine(sa, x), sa["rep_slot"], r_pad, mode)

        return extras, combine_exchanged


def _scatter_prepare_factory(message_dtype: str = "float32"):
    def prepare(rt, semiring: str, weights: str):
        sr = get_semiring(semiring)
        mdt = _message_dtype(message_dtype)
        if weights not in WEIGHT_KINDS:
            raise ValueError(f"weights must be one of {WEIGHT_KINDS}, "
                             f"got {weights!r}")

        def combine(sa, x):
            p, vmax = x.shape
            # flat machine-major indices: machine i's vertex v is i*Vmax + v
            base = torch.arange(p, device=x.device)[:, None] * vmax
            src = (sa["edges"][:, :, 0] + base).reshape(-1)
            dst = (sa["edges"][:, :, 1] + base).reshape(-1)
            w_raw = sa["edge_weight"]
            if weights == "unit":
                w_raw = torch.ones_like(w_raw)
            elif weights == "zero":
                w_raw = torch.zeros_like(w_raw)
            w = sr.weights(w_raw, sa["edge_valid"]).reshape(-1).to(mdt)
            xm = x.reshape(-1).to(mdt)
            out = torch.full((p * vmax,), sr.zero, dtype=x.dtype,
                             device=x.device)
            sr.scatter_accum(out, dst, sr.times(w, xm[src]).to(x.dtype))
            sr.scatter_accum(out, src, sr.times(w, xm[dst]).to(x.dtype))
            return out.reshape(p, vmax)

        return {}, combine

    return prepare


def _pallas_prepare_factory(block_size: int = 128,
                            message_dtype: str = "float32"):
    def prepare(rt, semiring: str, weights: str):
        sr = get_semiring(semiring)
        mdt = _message_dtype(message_dtype)
        bsr = rt.local_bsr(block_size=block_size, semiring=sr.name,
                           weights=weights)
        extras = {"eb_bsr_cols": bsr.cols, "eb_bsr_blocks": bsr.blocks,
                  "eb_bsr_gather": bsr.gather, "eb_bsr_rank": bsr.rank}

        def combine(sa, x):
            xb = torch.gather(x, 1, sa["eb_bsr_gather"]).to(mdt)
            y = bsr_spmv(sa["eb_bsr_cols"], sa["eb_bsr_blocks"], xb, sr.name)
            return torch.gather(y, 1, sa["eb_bsr_rank"]).to(x.dtype)

        return extras, combine

    return prepare


_REGISTRY = {
    "scatter": lambda message_dtype="float32": EdgeBackend(
        "scatter", "gather-scatter oracle (⊕-scatter per direction)",
        _scatter_prepare_factory(message_dtype)),
    "pallas": lambda block_size=128, message_dtype="float32": EdgeBackend(
        "pallas", "Block-ELL hand kernel",
        _pallas_prepare_factory(block_size, message_dtype)),
}

BACKENDS = tuple(_REGISTRY)


def get_backend(name, **opts) -> EdgeBackend:
    """Resolve a backend by name (``EdgeBackend`` passes through).

    Every backend takes ``message_dtype`` (``"float32"``); ``pallas`` adds
    ``block_size`` (default 128).
    """
    if isinstance(name, EdgeBackend):
        return name
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown edge-kernel backend {name!r} "
                         f"(choices: {sorted(_REGISTRY)})") from None
    return factory(**opts)
