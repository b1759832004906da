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
``segment``
    Sorted-CSR reduction over the output-major incidence, with a trailing
    dump segment for padding: (+, ×) differences a running sum at the row
    pointers, (min, +) and (or, and) reduce each sorted segment.
``pallas``
    The row-layout hand kernel (``kernels/bsr_spmv/rows.py``) over
    ``rt.local_rows()``'s degree-sorted per-machine rows, whose bytes follow
    the edges: ``x[gather]``, the kernel, then ``y[rank]``.  The name is
    the reference's, so that ``--backend pallas`` drives the counterpart
    in both command lines; ``block_size`` keeps the reference's meaning
    for 16-bit (+, ×), the column group each rounded sum covers.  (The
    dense Block-ELL layout, ``rt.local_bsr()``, and its kernel
    ``bsr_spmv`` read every cell of each nonzero 128 × 128 block: 37 GB
    for 16.9 MB of work at ``graph500:16``.)

(+, ×) results agree across backends to float32 reassociation; (min, +)
and (or, and) are exact, so the sparse apps agree bitwise.

Two knobs every backend understands, as in the reference:

``message_dtype`` (default ``"float32"``)
    The ⊗ operand precision.  ``scatter``/``segment`` round messages and
    edge weights to the message dtype, take ⊗ there and ⊕ in the state
    dtype (float32).  The ⊗ rounds as the reference's does when XLA runs
    it: a float16 product is rounded to float16, a bfloat16 product is
    kept in float32 (XLA widens bfloat16 arithmetic and, under its
    default ``xla_allow_excess_precision``, drops the rounding before the
    cast back).  ``pallas`` stores its values in the message dtype and
    ⊕-accumulates in it too (``kernels/bsr_spmv``).

``frontier_cap`` (``scatter`` only, default ``None``)
    Active-frontier compaction: the combine takes the first ``cap``
    vertices carrying a live message per machine, in ascending id (the
    reference's ``jnp.nonzero(size=cap, fill_value=0)``; excess live
    vertices are dropped as there), and ⊕-scatters only their rows of a
    per-vertex ELL incidence.  :func:`frontier_entries` gives the cap a
    run needs.  The compaction is a cumsum over ``live`` and a scatter
    into a fixed ``(p, cap)`` buffer: no host sync, so a CUDA graph can
    capture it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..kernels.bsr_spmv import bsr_spmv_rows, get_semiring
from .engine import exchange
from .partition_runtime import (MESSAGE_DTYPES, WEIGHT_KINDS, edge_operand,
                                message_dtype as _torch_dtype)


def _no_message(sr) -> float:
    """The x value meaning "this vertex sends nothing": its ⊗ product is
    the ⊕ identity for every edge weight ((min,+): +inf; else 0)."""
    return float("inf") if sr.name == "min_plus" else 0.0


@dataclasses.dataclass(frozen=True)
class EdgeBackend:
    """A named edge-combine strategy (see module docstring)."""

    name: str
    description: str
    prepare: Callable          # (rt, semiring, weights) -> (extras, combine)

    def prepare_exchanged(self, rt, semiring: str, weights: str,
                          mode: str, r_pad: int, *, mesh=None):
        """``prepare`` with the replica :func:`~.engine.exchange` fused into
        the combine epilogue: ``combine(sa, x)`` yields post-exchange
        neighborhood values.  Under ``mesh``, ``rt`` is this rank's
        machine (``distributed.machine_slice``) and the exchange
        all-reduces across the ranks."""
        extras, combine = self.prepare(rt, semiring, weights)

        def combine_exchanged(sa, x):
            return exchange(combine(sa, x), sa["rep_slot"], r_pad, mode,
                            mesh=mesh)

        return extras, combine_exchanged


def frontier_entries(rt, changed: np.ndarray) -> np.ndarray:
    """(p,) live (message-carrying) vertices per machine for a changed
    mask: the exact lower bound for the ``scatter`` backend's
    ``frontier_cap``.

    ``changed``: (p, Vmax) bool, True where the vertex carries a message
    this superstep (the ``"changed"`` state leaf of the monotone apps;
    ``dist == step`` for BFS).
    """
    changed = np.asarray(changed, dtype=bool)
    return (changed & rt.vertex_valid).sum(axis=1).astype(np.int64)


def _directed(rt, weights: str):
    """Both directions of every local edge: (src, dst, valid, w), each
    (p, 2·Emax)."""
    w_raw = edge_operand(rt.edge_weight, weights)
    src2 = np.concatenate([rt.local_edges[:, :, 0],
                           rt.local_edges[:, :, 1]], axis=1)
    dst2 = np.concatenate([rt.local_edges[:, :, 1],
                           rt.local_edges[:, :, 0]], axis=1)
    valid2 = np.concatenate([rt.edge_valid, rt.edge_valid], axis=1)
    w2 = np.concatenate([w_raw, w_raw], axis=1).astype(np.float32)
    return src2, dst2, valid2, w2


def _times(sr, w: torch.Tensor, x: torch.Tensor, mdt: torch.dtype,
           out: torch.dtype) -> torch.Tensor:
    """``w ⊗ x`` on operands rounded to the message dtype ``mdt``, in the
    state dtype ``out``; the product is rounded to ``mdt`` except in
    bfloat16 (see the module docstring)."""
    if mdt == torch.bfloat16:
        return sr.times(w.to(mdt).to(out), x.to(mdt).to(out))
    return sr.times(w.to(mdt), x.to(mdt)).to(out)


def _flat(idx: torch.Tensor, width: int) -> torch.Tensor:
    """Machine-major flat indices of ``(p, ...)`` per-machine indices into
    ``(p, width)`` rows."""
    base = torch.arange(idx.shape[0], device=idx.device) * width
    return (idx + base.view(-1, *([1] * (idx.dim() - 1)))).reshape(-1)


# ---------------------------------------------------------------------------
# scatter: the oracle (gather + ⊕-scatter per direction)
# ---------------------------------------------------------------------------

def _scatter_prepare_factory(message_dtype: str = "float32",
                             frontier_cap: int | None = None):
    def prepare(rt, semiring: str, weights: str):
        sr = get_semiring(semiring)
        mdt = _torch_dtype(message_dtype)
        if weights not in WEIGHT_KINDS:
            raise ValueError(f"weights must be one of {WEIGHT_KINDS}, "
                             f"got {weights!r}")

        if frontier_cap is None:
            def combine(sa, x):
                p, vmax = x.shape
                src = _flat(sa["edges"][:, :, 0], vmax)
                dst = _flat(sa["edges"][:, :, 1], vmax)
                w_raw = sa["edge_weight"]
                if weights == "unit":
                    w_raw = torch.ones_like(w_raw)
                elif weights == "zero":
                    w_raw = torch.zeros_like(w_raw)
                w = sr.weights(w_raw, sa["edge_valid"]).reshape(-1)
                xf = x.reshape(-1)
                out = torch.full((p * vmax,), sr.zero, dtype=x.dtype,
                                 device=x.device)
                sr.scatter_accum(out, dst, _times(sr, w, xf[src], mdt,
                                                  x.dtype))
                sr.scatter_accum(out, src, _times(sr, w, xf[dst], mdt,
                                                  x.dtype))
                return out.reshape(p, vmax)

            return {}, combine

        # frontier mode: per-vertex ELL of the directed incidence — row v
        # holds v's outgoing (dst, w) entries, padded to the machine-max
        # degree with the dump row / the ⊗ annihilator
        cap = int(frontier_cap)
        if cap < 1:
            raise ValueError(f"frontier_cap must be >= 1, got {cap}")
        p, vmax = rt.p, rt.vmax
        src2, dst2, valid2, w2 = _directed(rt, weights)
        deg = np.zeros((p, vmax), dtype=np.int64)
        for i in range(p):
            np.add.at(deg[i], src2[i][valid2[i]], 1)
        dmax = max(1, int(deg.max()))
        ell_dst = np.full((p, vmax, dmax), vmax, dtype=np.int32)
        ell_w = np.full((p, vmax, dmax), np.float32(sr.absent),
                        dtype=np.float32)
        for i in range(p):
            s = src2[i][valid2[i]]
            order = np.argsort(s, kind="stable")
            s = s[order]
            slot = np.arange(len(s)) - np.searchsorted(s, s)
            ell_dst[i][s, slot] = dst2[i][valid2[i]][order]
            ell_w[i][s, slot] = w2[i][valid2[i]][order]
        dev = rt.device
        extras = {"eb_fr_dst": torch.from_numpy(ell_dst).to(dev),
                  "eb_fr_w": torch.from_numpy(ell_w).to(dev)}
        none = _no_message(sr)

        def combine(sa, x):
            p, vmax = x.shape
            dev = x.device
            live = sa["vertex_valid"] & (x != none)
            # the first ``cap`` live ids in ascending order, zero-filled:
            # each live vertex's rank among the live ones is its slot, and
            # the rest go to a dump column
            rank = live.cumsum(dim=1) - 1
            slot = torch.where(live & (rank < cap), rank, cap)
            ids = torch.zeros((p, cap + 1), dtype=torch.int64, device=dev)
            ids.scatter_(1, slot, torch.arange(vmax, device=dev)
                         .expand(p, vmax))
            ids = ids[:, :cap]
            ok = (torch.arange(cap, device=dev)[None, :]
                  < live.sum(dim=1, keepdim=True))[..., None]  # real rows
            rows = ids[..., None].expand(p, cap, dmax)
            rows_d = torch.gather(sa["eb_fr_dst"], 1, rows).long()
            rows_w = torch.gather(sa["eb_fr_w"], 1, rows)
            xs = torch.gather(x, 1, ids)[..., None]
            vals = _times(sr, rows_w, xs, mdt, x.dtype)
            vals = torch.where(ok, vals, sr.zero)
            d = torch.where(ok, rows_d, vmax)          # pad -> dump row
            out = torch.full((p * (vmax + 1),), sr.zero, dtype=x.dtype,
                             device=dev)
            sr.scatter_accum(out, _flat(d, vmax + 1), vals.reshape(-1))
            return out.view(p, vmax + 1)[:, :vmax]

        return extras, combine

    return prepare


# ---------------------------------------------------------------------------
# segment: sorted-CSR reduction (cumsum difference for ⊕ = +)
# ---------------------------------------------------------------------------

def _segment_prepare_factory(message_dtype: str = "float32"):
    def prepare(rt, semiring: str, weights: str):
        sr = get_semiring(semiring)
        mdt = _torch_dtype(message_dtype)
        p, vmax = rt.p, rt.vmax
        # both directions of every edge, output-major: entry j receives
        # x[inc_in[j]] ⊗ w[j] into output vertex inc_out[j]
        inc_in, inc_out, valid2, w2 = _directed(rt, weights)
        # invalid entries sort to a trailing dump segment (id = Vmax) and
        # carry the semiring's annihilator, so they add the ⊕ identity
        inc_out = np.where(valid2, inc_out, vmax).astype(np.int64)
        w2 = np.where(valid2, w2, np.float32(sr.absent))
        order = np.argsort(inc_out, axis=1, kind="stable")
        inc_out = np.take_along_axis(inc_out, order, 1)
        inc_in = np.take_along_axis(inc_in, order, 1).astype(np.int64)
        w2 = np.take_along_axis(w2, order, 1)
        ptr = np.zeros((p, vmax + 1), dtype=np.int64)
        for i in range(p):
            counts = np.bincount(inc_out[i][inc_out[i] < vmax],
                                 minlength=vmax)
            ptr[i, 1:] = np.cumsum(counts)
        dev = rt.device
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        extras = {"eb_seg_out": as_t(inc_out), "eb_seg_in": as_t(inc_in),
                  "eb_seg_w": as_t(w2), "eb_seg_ptr": as_t(ptr)}

        def combine(sa, x):
            vals = _times(sr, sa["eb_seg_w"],
                          torch.gather(x, 1, sa["eb_seg_in"]), mdt, x.dtype)
            if sr.name == "plus_times":
                s = torch.cat([torch.zeros_like(vals[:, :1]),
                               vals.cumsum(dim=1)], dim=1)
                ptr_ = sa["eb_seg_ptr"]
                return (torch.gather(s, 1, ptr_[:, 1:])
                        - torch.gather(s, 1, ptr_[:, :-1]))
            # empty segments come back as the reduction's own identity
            # (+inf / -inf), as the reference's segment_min/max gives them;
            # (or, and) clamps to its zero
            low = sr.name == "min_plus"
            y = torch.full((x.shape[0], x.shape[1] + 1),
                           float("inf") if low else float("-inf"),
                           dtype=x.dtype, device=x.device)
            y.scatter_reduce_(1, sa["eb_seg_out"], vals,
                              "amin" if low else "amax", include_self=True)
            y = y[:, :-1]
            return y if low else torch.clamp_min(y, sr.zero)

        return extras, combine

    return prepare


# ---------------------------------------------------------------------------
# pallas: the row-layout hand kernel over the degree-sorted local adjacency
# ---------------------------------------------------------------------------

def _pallas_prepare_factory(block_size: int = 128,
                            message_dtype: str = "float32"):
    def prepare(rt, semiring: str, weights: str):
        sr = get_semiring(semiring)
        mdt = _torch_dtype(message_dtype)
        rows = rt.local_rows(block_size=block_size, semiring=sr.name,
                             weights=weights, dtype=message_dtype)
        extras = {"eb_rows_units": rows.units, "eb_rows_cols": rows.cols,
                  "eb_rows_vals": rows.vals, "eb_rows_gather": rows.gather,
                  "eb_rows_rank": rows.rank}

        def combine(sa, x):
            # values are stored in the message dtype; x joins them, so the
            # kernel rounds (and, unlike scatter/segment, ⊕-accumulates
            # 16-bit (+, ×) groups) in that dtype
            xb = torch.gather(x, 1, sa["eb_rows_gather"]).to(mdt)
            y = bsr_spmv_rows(sa["eb_rows_units"], sa["eb_rows_cols"],
                              sa["eb_rows_vals"], xb, sr.name, block_size)
            return torch.gather(y, 1, sa["eb_rows_rank"]).to(x.dtype)

        return extras, combine

    return prepare


_REGISTRY = {
    "scatter": lambda message_dtype="float32", frontier_cap=None:
        EdgeBackend("scatter", "gather-scatter oracle (⊕-scatter per "
                    "direction)",
                    _scatter_prepare_factory(message_dtype, frontier_cap)),
    "segment": lambda message_dtype="float32": EdgeBackend(
        "segment", "sorted-CSR reduction (cumsum difference)",
        _segment_prepare_factory(message_dtype)),
    "pallas": lambda block_size=128, message_dtype="float32": EdgeBackend(
        "pallas", "row-layout hand kernel",
        _pallas_prepare_factory(block_size, message_dtype)),
}

BACKENDS = tuple(_REGISTRY)


def get_backend(name, **opts) -> EdgeBackend:
    """Resolve a backend by name (``EdgeBackend`` passes through).

    Every backend takes ``message_dtype`` (one of ``MESSAGE_DTYPES``);
    ``scatter`` adds ``frontier_cap``; ``pallas`` adds ``block_size``
    (default 128).
    """
    if isinstance(name, EdgeBackend):
        return name
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown edge-kernel backend {name!r} "
                         f"(choices: {sorted(_REGISTRY)})") from None
    return factory(**opts)
