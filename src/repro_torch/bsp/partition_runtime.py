"""Fixed-shape per-machine arrays from an edge partition.

Every machine gets the same padded shapes, so the BSP supersteps run over a
leading machine axis ``(p, ...)``:

* ``local_vertex_gid``: (p, Vmax) global id of each local vertex (pad: -1)
* ``local_edges``:      (p, Emax, 2) endpoints in *local* indices (pad: 0)
* ``edge_valid``:       (p, Emax) bool
* ``edge_weight``:      (p, Emax) float32
* ``vertex_valid``:     (p, Vmax) bool
* ``global_degree``:    (p, Vmax) degree of the vertex in G (pad: 1)
* ``weighted_degree``:  (p, Vmax) sum of incident edge weights (pad: 1)
* ``rep_slot``:         (p, Vmax) slot into the replica exchange table,
                        -1 if the vertex lives on a single machine.

These are packed on the host in numpy, exactly as the reference packs
them; ``device`` says where the BSP apps put their tensors.
:meth:`PartitionRuntime.local_rows` builds each machine's local adjacency
as rows of (column, value) entries (:class:`LocalRows`), the layout the
``pallas`` backend reads; :meth:`PartitionRuntime.local_bsr` builds the
dense Block-ELL counterpart of the reference's layout (:class:`LocalBSR`),
whose blocks are filled on the device.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from .. import obs
from ..core.graph import Graph
from ..device import resolve_device
from ..kernels.bsr_spmv import get_semiring

#: weight kinds an app may ask for: the stored ⊗ operand per edge
WEIGHT_KINDS = ("weight", "unit", "zero")

#: message (block storage) dtypes, by the reference's names
MESSAGE_DTYPES = ("float32", "bfloat16", "float16")


def message_dtype(name: str) -> torch.dtype:
    """The torch dtype of a message dtype name; raises on any other name."""
    if str(name) not in MESSAGE_DTYPES:
        raise ValueError(f"message_dtype must be one of {MESSAGE_DTYPES}, "
                         f"got {name!r}")
    return getattr(torch, str(name))


def edge_operand(edge_weight: np.ndarray, weights: str) -> np.ndarray:
    """Raw ⊗ operand per edge for a weight kind (same shape as the weights)."""
    if weights == "weight":
        return edge_weight
    if weights == "unit":
        return np.ones_like(edge_weight)
    if weights == "zero":
        return np.zeros_like(edge_weight)
    raise ValueError(f"weights must be one of {WEIGHT_KINDS}, "
                     f"got {weights!r}")


@dataclasses.dataclass(frozen=True)
class LocalBSR:
    """Per-machine blocked local adjacency, stacked over machines.

    Each machine's ``local_edges`` become one Block-ELL matrix over its
    padded local vertex space, after a *degree-sorted local relabeling*
    (descending local degree, so hub rows and columns cluster into the
    leading blocks).  All machines share (R, K, bm); K is padded to the
    machine-wise max with absent blocks.

    ``gather`` maps each padded BSR position to the local vertex whose
    value it reads (pad positions read slot 0; their entries are all
    absent); ``rank`` maps each local vertex to its BSR position.
    """

    cols: torch.Tensor      # (p, R, K) int32 block-column ids
    blocks: torch.Tensor    # (p, R, K, bm, bm) message dtype (absent-padded)
    gather: torch.Tensor    # (p, R*bm) int64: BSR position -> local index
    rank: torch.Tensor      # (p, Vmax) int64: local index -> BSR position
    block_size: int
    semiring: str
    fill_stats: tuple       # per-machine dicts, counted from the edge lists

    @property
    def p(self) -> int:
        return self.cols.shape[0]

    @property
    def padded(self) -> int:
        return self.gather.shape[1]

    def aggregate_fill(self) -> dict:
        """ELL fill/padding over all machines."""
        tot = lambda k: sum(s[k] for s in self.fill_stats)
        slots = sum(s["rows"] * s["ell_k"] for s in self.fill_stats)
        cells = sum(s["nnz_blocks"] * s["block_size"] ** 2
                    for s in self.fill_stats)
        return {
            "machines": len(self.fill_stats),
            "block_size": self.block_size,
            "ell_k_max": max(s["ell_k"] for s in self.fill_stats),
            "nnz": tot("nnz"),
            "nnz_blocks": tot("nnz_blocks"),
            "block_fill": tot("nnz_blocks") / max(1, slots),
            "entry_fill": tot("nnz") / max(1, cells),
        }

    @classmethod
    def build(cls, rt: "PartitionRuntime", *, block_size: int = 128,
              semiring: str = "plus_times", weights: str = "weight",
              dtype: str = "float32") -> "LocalBSR":
        """Blocked adjacency from ``rt.local_edges`` on ``rt.device``.

        ``cols``, ``gather`` and ``rank`` come from the host exactly as
        the reference computes them.  The dense blocks never exist on the
        host: they start as ``absent`` on the device and every edge, in
        both directions, is ⊕-accumulated at its (block-row, ELL slot,
        row, col) cell, so parallel edges combine as the reference's
        ``np_accum_at`` combines them.

        ``dtype`` is the stored block precision (the message dtype).  As
        in the reference, blocks are built in float32 and rounded once;
        here one machine at a time, through a float32 staging tensor of
        one machine's blocks, so a 16-bit layout never sits beside its
        whole float32 counterpart (37 GB at ``graph500:16``).

        Two spans time it: ``layout.host`` (degrees, order, ELL slots,
        ``cols``/``gather``/``rank`` and each edge's cell) and
        ``layout.device`` (the fill, the ⊕-scatter and the copies to the
        device, which end on one synchronize where the device is CUDA).
        """
        sr = get_semiring(semiring)
        dt = message_dtype(dtype)
        p, vmax, bm = rt.p, rt.vmax, int(block_size)
        R = max(1, -(-vmax // bm))
        dev = rt.device
        with obs.span("layout.host"):
            per, orders, ranks, stats = [], [], [], []
            for i in range(p):
                ev = rt.edge_valid[i]
                e = rt.local_edges[i][ev].astype(np.int64)
                deg = np.zeros(vmax, dtype=np.int64)
                np.add.at(deg, e[:, 0], 1)
                np.add.at(deg, e[:, 1], 1)
                order = np.argsort(-deg, kind="stable").astype(np.int32)
                rank = rank_of(order, vmax)
                w = edge_operand(rt.edge_weight[i][ev],
                                 weights).astype(np.float32)
                e = rank[e].astype(np.int64)
                rows = np.concatenate([e[:, 0], e[:, 1]])
                cols = np.concatenate([e[:, 1], e[:, 0]])
                w = np.concatenate([w, w])
                # ELL slots: a row's nonzero blocks in ascending block column
                key = (rows // bm) * R + cols // bm
                uniq, inv = np.unique(key, return_inverse=True)
                urow = uniq // R
                uslot = np.arange(len(uniq)) - np.searchsorted(urow, urow)
                k_i = max(1, int(uslot.max(initial=-1)) + 1)
                nnz = len(np.unique(rows * (R * bm) + cols))
                per.append((urow, uslot, uniq % R, rows, cols, uslot[inv], w,
                            k_i))
                orders.append(order)
                ranks.append(rank)
                stats.append({
                    "rows": R, "ell_k": k_i, "block_size": bm,
                    "nnz": nnz, "nnz_blocks": len(uniq),
                    "block_fill": len(uniq) / max(1, R * k_i),
                    "entry_fill": nnz / max(1, len(uniq) * bm * bm),
                    "pad_frac": (R * bm - vmax) / max(1, R * bm),
                })
            K = max(k_i for *_, k_i in per)
            cols_np = np.zeros((p, R, K), dtype=np.int32)
            cells_of = []       # each machine's flat cell ids and operands
            for i, (urow, uslot, ucol, rows, cols, slot, w, _) in \
                    enumerate(per):
                cols_np[i, urow, uslot] = ucol
                flat = (((rows // bm) * K + slot) * bm + rows % bm) * bm \
                    + cols % bm
                cells_of.append((flat, w))
            del per
            gather = np.zeros((p, R * bm), dtype=np.int64)
            gather[:, :vmax] = np.stack(orders)
            rank_np = np.stack(ranks).astype(np.int64)
        with obs.span("layout.device"):
            blocks = torch.empty((p, R, K, bm, bm), dtype=dt, device=dev)
            stage = None if dt == torch.float32 else torch.empty(
                (R, K, bm, bm), dtype=torch.float32, device=dev)
            for i, (flat, w) in enumerate(cells_of):
                cells = blocks[i] if stage is None else stage
                cells.fill_(sr.absent)
                sr.scatter_accum(cells.view(-1),
                                 torch.from_numpy(flat).to(dev),
                                 torch.from_numpy(w).to(dev))
                if stage is not None:
                    blocks[i].copy_(stage)          # one rounding to ``dt``
            del stage
            out = cls(cols=torch.from_numpy(cols_np).to(dev), blocks=blocks,
                      gather=torch.from_numpy(gather).to(dev),
                      rank=torch.from_numpy(rank_np).to(dev),
                      block_size=bm, semiring=sr.name,
                      fill_stats=tuple(stats))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return out


@dataclasses.dataclass(frozen=True)
class LocalRows:
    """Per-machine local adjacency as rows of (column, value) entries,
    stacked over machines: the layout of ``kernels/bsr_spmv/rows.py``,
    whose bytes follow the edges.

    Rows and columns are :class:`LocalBSR`'s positions (the same
    degree-sorted relabeling, and the same ``gather`` and ``rank``), over
    ``padded`` ids a machine.  Each cell is the dense layout's cell at the
    same (row, col), bitwise; the absent cells are not stored, and a
    machine with fewer vertices than Vmax stores no rows for the rest.
    ``block_size`` is the dense layout's, the column group of 16-bit
    (+, ×).  ``fill_stats`` holds per machine the entries, the rows each
    kind of work unit handles and the padding cells.
    """

    units: torch.Tensor     # (U, 4) int32 work units
    cols: torch.Tensor      # (N,) int32 column positions (-1: padding)
    vals: torch.Tensor      # (N,) message dtype
    gather: torch.Tensor    # (p, padded) int64: position -> local index
    rank: torch.Tensor      # (p, Vmax) int64: local index -> position
    block_size: int
    semiring: str
    fill_stats: tuple

    @property
    def p(self) -> int:
        return self.gather.shape[0]

    @property
    def padded(self) -> int:
        return self.gather.shape[1]

    @property
    def nbytes(self) -> int:
        """Device bytes of the layout's tensors."""
        return sum(t.numel() * t.element_size() for t in (
            self.units, self.cols, self.vals, self.gather, self.rank))

    @classmethod
    def build(cls, rt: "PartitionRuntime", *, block_size: int = 128,
              semiring: str = "plus_times", weights: str = "weight",
              dtype: str = "float32") -> "LocalRows":
        """Row layout from ``rt.local_edges`` on ``rt.device``.

        On the host (span ``layout.host``): each machine's order, ranks and
        ``gather`` exactly as :meth:`LocalBSR.build` computes them; every
        edge in both directions at its (row, col) cell, parallel edges
        ⊕-merged in float32 in the order ``LocalBSR`` scatters them
        (``np_accum_at``, as the reference accumulates a cell); then the
        units and entries (``rows.pack_rows``).  On the device (span
        ``layout.device``): the copies, the values rounded once to the
        message dtype, ending on one synchronize where the device is CUDA.
        The layout's device bytes are counted once (``layout.bytes``)."""
        from ..kernels.bsr_spmv.rows import pack_rows
        sr = get_semiring(semiring)
        dt = message_dtype(dtype)
        p, vmax, bm = rt.p, rt.vmax, int(block_size)
        n = max(1, -(-vmax // bm)) * bm
        dev = rt.device
        with obs.span("layout.host"):
            machines, orders, ranks = [], [], []
            for i in range(p):
                ev = rt.edge_valid[i]
                e = rt.local_edges[i][ev].astype(np.int64)
                deg = np.zeros(vmax, dtype=np.int64)
                np.add.at(deg, e[:, 0], 1)
                np.add.at(deg, e[:, 1], 1)
                order = np.argsort(-deg, kind="stable").astype(np.int32)
                rank = rank_of(order, vmax)
                w = edge_operand(rt.edge_weight[i][ev],
                                 weights).astype(np.float32)
                e = rank[e].astype(np.int64)
                key = np.concatenate([e[:, 0] * n + e[:, 1],
                                      e[:, 1] * n + e[:, 0]])
                cells, inv = np.unique(key, return_inverse=True)
                vals = np.full(len(cells), sr.absent, dtype=np.float32)
                sr.np_accum_at(vals, inv.reshape(-1),
                               np.concatenate([w, w]))
                machines.append((cells // n, (cells % n).astype(np.int32),
                                 vals))
                orders.append(order)
                ranks.append(rank)
            units, cols, vals, stats = pack_rows(machines, n, sr.absent)
            del machines
            gather = np.zeros((p, n), dtype=np.int64)
            gather[:, :vmax] = np.stack(orders)
            rank_np = np.stack(ranks).astype(np.int64)
        with obs.span("layout.device"):
            out = cls(units=torch.from_numpy(units).to(dev),
                      cols=torch.from_numpy(cols).to(dev),
                      vals=torch.from_numpy(vals).to(dev).to(dt),
                      gather=torch.from_numpy(gather).to(dev),
                      rank=torch.from_numpy(rank_np).to(dev),
                      block_size=bm, semiring=sr.name, fill_stats=stats)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        obs.count("layout.bytes", out.nbytes)
        return out


def rank_of(order: np.ndarray, n: int) -> np.ndarray:
    """Inverse permutation: position of each of ``n`` items in ``order``."""
    rank = np.empty(n, dtype=np.int32)
    rank[order] = np.arange(n, dtype=np.int32)
    return rank


@dataclasses.dataclass(frozen=True)
class PartitionRuntime:
    """A partition packed for the BSP apps (the module docstring lists its
    arrays).  Its cache holds what is built from it on ``device`` once and
    reused: the :class:`LocalRows` and :class:`LocalBSR` layouts, and the
    apps' static tree of its arrays (``apps._static_tree``).  A runtime
    made from another (``dataclasses.replace``, a machine slice,
    :meth:`apply_delta`) starts with an empty cache."""

    p: int
    num_vertices: int
    num_replicas: int                  # R
    local_vertex_gid: np.ndarray       # (p, Vmax) int32
    vertex_valid: np.ndarray           # (p, Vmax) bool
    local_edges: np.ndarray            # (p, Emax, 2) int32 (local indices)
    edge_valid: np.ndarray             # (p, Emax) bool
    edge_weight: np.ndarray            # (p, Emax) float32
    global_degree: np.ndarray          # (p, Vmax) int32
    weighted_degree: np.ndarray        # (p, Vmax) float32 (pad: 1)
    rep_slot: np.ndarray               # (p, Vmax) int32
    verts_per_machine: np.ndarray      # (p,)
    edges_per_machine: np.ndarray      # (p,)
    device: torch.device               # where the apps run

    @property
    def vmax(self) -> int:
        return self.local_vertex_gid.shape[1]

    @property
    def emax(self) -> int:
        return self.local_edges.shape[1]

    @functools.cached_property
    def _bsr_cache(self) -> dict:
        return {}

    def local_bsr(self, *, block_size: int = 128,
                  semiring: str = "plus_times", weights: str = "weight",
                  dtype: str = "float32") -> LocalBSR:
        """The blocked per-machine adjacency (:class:`LocalBSR`), built once
        per (block_size, semiring, weights, dtype) and cached on the
        runtime; ``dtype`` is the stored block precision (the message
        dtype)."""
        key = (int(block_size), get_semiring(semiring).name, str(weights),
               str(dtype))
        if key not in self._bsr_cache:
            self._bsr_cache[key] = LocalBSR.build(
                self, block_size=block_size, semiring=semiring,
                weights=weights, dtype=dtype)
        return self._bsr_cache[key]

    def local_rows(self, *, block_size: int = 128,
                   semiring: str = "plus_times", weights: str = "weight",
                   dtype: str = "float32") -> LocalRows:
        """The per-machine row layout (:class:`LocalRows`), built once per
        (block_size, semiring, weights, dtype) and cached on the runtime
        beside :meth:`local_bsr`'s layouts."""
        key = ("rows", int(block_size), get_semiring(semiring).name,
               str(weights), str(dtype))
        if key not in self._bsr_cache:
            self._bsr_cache[key] = LocalRows.build(
                self, block_size=block_size, semiring=semiring,
                weights=weights, dtype=dtype)
        return self._bsr_cache[key]

    def clear_bsr_cache(self) -> None:
        """Drop every cached :class:`LocalBSR` and :class:`LocalRows` and
        the apps' static tree, so that their device memory is freed once no
        app holds them (a dense layout at ``graph500:16`` is 18.6–37.2 GB);
        the next query builds its tree again."""
        self._bsr_cache.clear()

    @classmethod
    def create(cls, source=None, *, assign=None, p=None, cluster=None,
               method=None, edge_weights=None, device="cuda",
               **knobs) -> "PartitionRuntime":
        """One keyword-routed constructor for every runtime source.

        * ``create(graph, assign=assign, p=p)`` packs a runtime from an
          in-memory edge assignment; ``cluster=`` may replace ``p=``.
        * ``create(graph, method="windgp", cluster=cl, **knobs)``
          partitions through the registry first; ``knobs`` are validated
          by the registry entry.
        * ``create(assignment_or_path)`` packs out-of-core from an on-disk
          :class:`StreamAssignment`; ``edge_weights`` may be a callable
          ``(edges_i, i) -> (k_i,)``.

        ``device`` (default ``"cuda"``) is where the apps and the blocked
        layout put their tensors; it raises if CUDA is absent.  Conflicting
        or missing keywords raise ``ValueError``.  The aliases
        :meth:`build`, :meth:`from_partitioner` and :meth:`from_stream`
        build the same runtimes.
        """
        from .stream_assignment import StreamAssignment
        dev = resolve_device(device)
        if source is None:
            raise ValueError(
                "PartitionRuntime.create requires source=: a Graph (with "
                "assign=+p=/cluster= or method=+cluster=), or a "
                "StreamAssignment / its directory path")
        if isinstance(source, (StreamAssignment, str, os.PathLike)):
            bad = {"assign": assign, "p": p, "cluster": cluster,
                   "method": method}
            bad = sorted(k for k, v in bad.items() if v is not None)
            if bad or knobs:
                raise ValueError(
                    f"create(source=<stream assignment>) takes only "
                    f"edge_weights=; got {bad + sorted(knobs)}")
            with obs.span("pack"):
                return cls._pack_from_stream(source, edge_weights, dev)
        if not (hasattr(source, "edges") and hasattr(source, "num_vertices")):
            raise ValueError(
                f"create: source must be a Graph or a StreamAssignment "
                f"(or its path), got {type(source).__name__}")
        if method is not None:
            if assign is not None or p is not None:
                raise ValueError(
                    "create(source=graph, method=...) partitions the graph "
                    "itself — drop assign=/p= (or drop method= to pack a "
                    "precomputed assignment)")
            if cluster is None:
                raise ValueError(
                    "create(source=graph, method=...) requires cluster= "
                    "(the heterogeneous machine spec the partitioner "
                    "targets)")
            from ..core.partitioners import get
            assign = get(method)(source, cluster, **knobs)
            with obs.span("pack"):
                return cls._pack_from_assignment(source, assign, cluster.p,
                                                 edge_weights, dev)
        if assign is None:
            raise ValueError(
                "create(source=graph) needs either assign= (+ p= or "
                "cluster=) for a precomputed assignment, or method= "
                "(+ cluster=) to partition via the registry")
        if knobs:
            raise ValueError(
                f"create(source=graph, assign=...) got partitioner knobs "
                f"{sorted(knobs)} — knobs only apply with method=")
        if p is None:
            if cluster is None:
                raise ValueError(
                    "create(source=graph, assign=...) requires p= or "
                    "cluster= for the machine count")
            p = cluster.p
        with obs.span("pack"):
            return cls._pack_from_assignment(source, assign, p,
                                             edge_weights, dev)

    @classmethod
    def build(cls, g: Graph, assign: np.ndarray, p: int,
              edge_weights: np.ndarray | None = None,
              device="cuda") -> "PartitionRuntime":
        """Thin alias of :meth:`create` (``source=g, assign=, p=``)."""
        return cls.create(g, assign=assign, p=p, edge_weights=edge_weights,
                          device=device)

    @classmethod
    def from_partitioner(cls, g: Graph, cluster, method: str = "windgp",
                         edge_weights: np.ndarray | None = None,
                         device="cuda", **knobs) -> "PartitionRuntime":
        """Thin alias of :meth:`create` (``source=g, method=, cluster=``)."""
        return cls.create(g, method=method, cluster=cluster,
                          edge_weights=edge_weights, device=device, **knobs)

    @classmethod
    def from_stream(cls, assignment, edge_weights=None,
                    device="cuda") -> "PartitionRuntime":
        """Thin alias of :meth:`create` (``source=assignment``)."""
        return cls.create(assignment, edge_weights=edge_weights,
                          device=device)

    @classmethod
    def _pack_from_assignment(cls, g: Graph, assign: np.ndarray, p: int,
                              edge_weights: np.ndarray | None,
                              device: torch.device) -> "PartitionRuntime":
        assign = np.asarray(assign)
        if len(assign) and ((assign < 0).any() or assign.max() >= p):
            raise ValueError(f"assign must lie in [0, {p})")
        deg = g.degree().astype(np.int32)
        if edge_weights is None:
            edge_weights = np.ones(g.num_edges, dtype=np.float32)

        from ..core.partition_state import edge_incidence_counts
        member = edge_incidence_counts(g, assign, p) > 0     # (p, V)

        locals_, edges_, weights_ = [], [], []
        lut = np.full(g.num_vertices, -1, dtype=np.int64)
        for i in range(p):
            eids = np.flatnonzero(assign == i)
            verts = np.flatnonzero(member[i])   # sorted endpoints of E_i
            lut[verts] = np.arange(len(verts))
            locals_.append(verts)
            edges_.append(lut[g.edges[eids]])
            weights_.append(edge_weights[eids])

        vmax = max(1, max(len(v) for v in locals_))
        emax = max(1, max(len(e) for e in edges_))
        member_count = member.sum(axis=0).astype(np.int32)
        rep_vertices = np.flatnonzero(member_count >= 2)
        rep_index = np.full(g.num_vertices, -1, dtype=np.int32)
        rep_index[rep_vertices] = np.arange(len(rep_vertices), dtype=np.int32)

        # global weighted degree: the (+,×) message normalizer
        wdeg = np.zeros(g.num_vertices, dtype=np.float64)
        np.add.at(wdeg, g.edges[:, 0], edge_weights)
        np.add.at(wdeg, g.edges[:, 1], edge_weights)

        lv = np.full((p, vmax), -1, dtype=np.int32)
        vv = np.zeros((p, vmax), dtype=bool)
        le = np.zeros((p, emax, 2), dtype=np.int32)
        ev = np.zeros((p, emax), dtype=bool)
        ew = np.zeros((p, emax), dtype=np.float32)
        gd = np.ones((p, vmax), dtype=np.int32)
        wd = np.ones((p, vmax), dtype=np.float32)
        rs = np.full((p, vmax), -1, dtype=np.int32)
        for i in range(p):
            nv, ne = len(locals_[i]), len(edges_[i])
            lv[i, :nv] = locals_[i]
            vv[i, :nv] = True
            gd[i, :nv] = deg[locals_[i]]
            wd[i, :nv] = wdeg[locals_[i]]
            rs[i, :nv] = rep_index[locals_[i]]
            if ne:
                le[i, :ne] = edges_[i]
                ev[i, :ne] = True
                ew[i, :ne] = weights_[i]
        return cls(
            p=p, num_vertices=g.num_vertices,
            num_replicas=len(rep_vertices),
            local_vertex_gid=lv, vertex_valid=vv, local_edges=le,
            edge_valid=ev, edge_weight=ew, global_degree=gd,
            weighted_degree=wd, rep_slot=rs,
            verts_per_machine=np.array([len(v) for v in locals_]),
            edges_per_machine=np.array([len(e) for e in edges_]),
            device=device)

    @classmethod
    def _pack_from_stream(cls, assignment, edge_weights,
                          device: torch.device) -> "PartitionRuntime":
        """Pack the runtime from an on-disk :class:`StreamAssignment`.

        The out-of-core counterpart of :meth:`_pack_from_assignment`: no
        ``Graph`` and no global edge array.  Vertex membership, global
        degrees and the replica table come from the assignment's streamed
        state, and each machine's shard is read one at a time, so peak
        residency is one machine's edge set plus the fixed-shape output.
        ``edge_weights`` may be a callable ``(edges_i, i) -> (k_i,)``.
        """
        from .stream_assignment import StreamAssignment
        if not isinstance(assignment, StreamAssignment):
            assignment = StreamAssignment.open(assignment)
        p, V = assignment.p, assignment.num_vertices
        member = assignment.membership()
        deg = assignment.degree.astype(np.int32)

        member_count = member.sum(axis=0).astype(np.int32)
        rep_vertices = np.flatnonzero(member_count >= 2)
        rep_index = np.full(V, -1, dtype=np.int32)
        rep_index[rep_vertices] = np.arange(len(rep_vertices), dtype=np.int32)

        verts_per = member.sum(axis=1).astype(np.int64)
        edges_per = assignment.edges_per.astype(np.int64)
        vmax = max(1, int(verts_per.max(initial=0)))
        emax = max(1, int(edges_per.max(initial=0)))

        lv = np.full((p, vmax), -1, dtype=np.int32)
        vv = np.zeros((p, vmax), dtype=bool)
        le = np.zeros((p, emax, 2), dtype=np.int32)
        ev = np.zeros((p, emax), dtype=bool)
        ew = np.zeros((p, emax), dtype=np.float32)
        gd = np.ones((p, vmax), dtype=np.int32)
        wd = np.ones((p, vmax), dtype=np.float32)
        rs = np.full((p, vmax), -1, dtype=np.int32)
        lut = np.full(V, -1, dtype=np.int64)
        # every edge lives on exactly one machine, so the global weighted
        # degree accumulates across the one-shard-at-a-time loop
        wdeg = np.zeros(V, dtype=np.float64)
        for i in range(p):
            verts = np.flatnonzero(member[i])
            lut[verts] = np.arange(len(verts))
            edges_i = assignment.machine_edges(i)     # one shard at a time
            nv, ne = len(verts), len(edges_i)
            if ne != edges_per[i]:
                raise ValueError(f"machine {i}: shard holds {ne} edges, "
                                 f"the meta {edges_per[i]}")
            lv[i, :nv] = verts
            vv[i, :nv] = True
            gd[i, :nv] = deg[verts]
            rs[i, :nv] = rep_index[verts]
            if ne:
                le[i, :ne] = lut[edges_i]
                ev[i, :ne] = True
                w_i = (np.ones(ne, dtype=np.float32)
                       if edge_weights is None
                       else np.asarray(edge_weights(edges_i, i),
                                       dtype=np.float32))
                ew[i, :ne] = w_i
                np.add.at(wdeg, edges_i[:, 0], w_i)
                np.add.at(wdeg, edges_i[:, 1], w_i)
        for i in range(p):
            wd[i, vv[i]] = wdeg[lv[i, vv[i]]]
        return cls(
            p=p, num_vertices=V, num_replicas=len(rep_vertices),
            local_vertex_gid=lv, vertex_valid=vv, local_edges=le,
            edge_valid=ev, edge_weight=ew, global_degree=gd,
            weighted_degree=wd, rep_slot=rs,
            verts_per_machine=verts_per, edges_per_machine=edges_per,
            device=device)

    def apply_delta(self, assignment, delta,
                    device="cuda") -> "PartitionRuntime":
        """Repack after a dynamic epoch, reusing every untouched machine.

        ``assignment`` is the :class:`StreamAssignment` (or its path)
        *after* its ``apply_delta(delta, ...)`` ran; ``delta`` is that same
        :class:`~repro_torch.core.dynamic.AssignmentDelta`.  Machines whose
        edge set did not change keep their packed local-vertex and
        local-edge rows verbatim; only changed machines re-read their shard
        and relabel.  The replica table and global degrees are always
        rebuilt.  The new runtime lives on ``device`` and starts with an
        empty layout cache.

        Only valid for unit edge weights (the runtimes the dynamic layer
        produces); weighted runtimes repack via :meth:`from_stream`.
        """
        from .stream_assignment import StreamAssignment
        dev = resolve_device(device)
        if not isinstance(assignment, StreamAssignment):
            assignment = StreamAssignment.open(assignment)
        p, V = assignment.p, assignment.num_vertices
        if p != self.p:
            raise ValueError(f"delta runtime repack across machine counts "
                             f"({self.p} -> {p})")
        if not bool(np.all(self.edge_weight[self.edge_valid] == 1.0)):
            raise ValueError("apply_delta supports unit edge weights only "
                             "— repack weighted runtimes via from_stream")
        touched = delta.machines_touched(p)
        member = assignment.membership()
        deg = assignment.degree.astype(np.int32)
        member_count = member.sum(axis=0).astype(np.int32)
        rep_vertices = np.flatnonzero(member_count >= 2)
        rep_index = np.full(V, -1, dtype=np.int32)
        rep_index[rep_vertices] = np.arange(len(rep_vertices),
                                            dtype=np.int32)
        verts_per = member.sum(axis=1).astype(np.int64)
        edges_per = assignment.edges_per.astype(np.int64)
        vmax = max(1, int(verts_per.max(initial=0)))
        emax = max(1, int(edges_per.max(initial=0)))

        lv = np.full((p, vmax), -1, dtype=np.int32)
        vv = np.zeros((p, vmax), dtype=bool)
        le = np.zeros((p, emax, 2), dtype=np.int32)
        ev = np.zeros((p, emax), dtype=bool)
        ew = np.zeros((p, emax), dtype=np.float32)
        gd = np.ones((p, vmax), dtype=np.int32)
        wd = np.ones((p, vmax), dtype=np.float32)
        rs = np.full((p, vmax), -1, dtype=np.int32)
        lut = np.full(V, -1, dtype=np.int64)
        for i in range(p):
            nv, ne = int(verts_per[i]), int(edges_per[i])
            if not touched[i]:
                # unchanged machine: row content beyond (nv, ne) is pad
                lv[i, :nv] = self.local_vertex_gid[i, :nv]
                le[i, :ne] = self.local_edges[i, :ne]
            else:
                verts = np.flatnonzero(member[i])
                lut[verts] = np.arange(len(verts))
                edges_i = assignment.machine_edges(i)
                if len(verts) != nv or len(edges_i) != ne:
                    raise ValueError(f"machine {i}: shard/membership "
                                     f"disagree with the meta counts")
                lv[i, :nv] = verts
                if ne:
                    le[i, :ne] = lut[edges_i]
            vv[i, :nv] = True
            ev[i, :ne] = True
            ew[i, :ne] = 1.0
            gids = lv[i, :nv]
            gd[i, :nv] = deg[gids]
            wd[i, :nv] = deg[gids]       # unit weights: wdeg == degree
            rs[i, :nv] = rep_index[gids]
        return type(self)(
            p=p, num_vertices=V, num_replicas=len(rep_vertices),
            local_vertex_gid=lv, vertex_valid=vv, local_edges=le,
            edge_valid=ev, edge_weight=ew, global_degree=gd,
            weighted_degree=wd, rep_slot=rs,
            verts_per_machine=verts_per, edges_per_machine=edges_per,
            device=dev)

    def gather_global(self, local_values: np.ndarray,
                      fill: float = 0.0) -> np.ndarray:
        """Merge per-machine local vertex values into a (V,) global array.

        Replicated vertices must agree across machines (post-exchange)."""
        out = np.full(self.num_vertices, fill,
                      dtype=np.asarray(local_values).dtype)
        for i in range(self.p):
            m = self.vertex_valid[i]
            out[self.local_vertex_gid[i, m]] = local_values[i, m]
        return out

    def scatter_global(self, global_values: np.ndarray,
                       fill: float = 0.0) -> np.ndarray:
        """Spread a (V,) global array onto (p, Vmax) local vertex values —
        the inverse of :meth:`gather_global` (replicas all receive the same
        value; pad slots and vertices past the array's end get ``fill``)."""
        g = np.asarray(global_values)
        if len(g) < self.num_vertices:
            g = np.concatenate(
                [g, np.full(self.num_vertices - len(g), fill,
                            dtype=g.dtype)])
        out = np.full((self.p, self.vmax), fill, dtype=g.dtype)
        for i in range(self.p):
            m = self.vertex_valid[i]
            out[i, m] = g[self.local_vertex_gid[i, m]]
        return out
