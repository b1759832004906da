"""Unified incremental per-(machine, vertex) accounting for edge partitions.

One state layer shared by every phase that mutates or scores an edge
assignment — expansion (``core/expand.py``), subgraph-local search
(``core/sls.py``), the driver's repair pass (``core/windgp.py``), the
baselines' capacity spill handling, and the BSP runtime packer
(``bsp/partition_runtime.py``).  Historically the same bookkeeping was
implemented twice (``ExpansionState`` plus the batched engine's private
counters, and ``sls.IncrementalTC``); this module is the single home.

Field ↔ paper-term map (Definition 4 / Eq. 3–5):

* ``cnt[i, v]``     — number of partition-i edges incident on v.  ``cnt > 0``
  is the vertex-membership matrix: v ∈ V_i ⇔ cnt[i, v] > 0 (Definition 3).
* ``edges_per[i]``  — |E_i|, ``verts_per[i]`` — |V_i|: the two factors of the
  computation cost  T_i^cal = C_i^node·|V_i| + C_i^edge·|E_i|   (Eq. 3).
* ``replicas[v]``   — |S(v)|, the number of machines holding a replica of v.
* ``com_sum[v]``    — Σ_{j ∈ S(v)} C_j^com, the communication mass of v's
  replica set; together with ``replicas`` it closes the communication cost
  T_i^com = Σ_{v ∈ V_i} Σ_{j ≠ i, v ∈ V_j} (C_i^com + C_j^com)    (Eq. 4)
  in O(1) per membership change.
* ``t_cal``/``t_com`` — the per-machine Eq. 3/Eq. 4 totals; ``tc`` is their
  max (the TC objective).  ``delta_t_batch`` scores hypothetical edge
  additions — the repair-side analogue of the expansion score w(v) (Eq. 5):
  both charge a candidate by the new replicas it would create.

All arrays hold integer-valued float64 (costs are integral in the paper's
machine quantification), so the batch recount path and the scalar
incremental path produce bit-identical state — the equivalence tests rely
on this.

Batch-first API: ``remove_edges``/``add_edges`` apply whole edge sets with
an exact *wave-local recount* — membership-derived quantities of the
touched vertex columns are recomputed from ``cnt`` rather than replayed
edge by edge — and ``delta_t_batch``/``mem_after_batch`` score
|edges| × |machines| hypothetical placements in one broadcast.  The scalar
methods survive as the oracle path (and for one-off callers).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # avoid runtime cycles: machines.py imports the helpers
    from .graph import Graph
    from .machines import Cluster


# ---------------------------------------------------------------------------
# membership helpers (shared with machines.evaluate / bsp runtime)
# ---------------------------------------------------------------------------

def edge_incidence_counts(g: "Graph", assign: np.ndarray, p: int) -> np.ndarray:
    """(p, V) int32 — partition-i edges incident on v (unassigned skipped)."""
    cnt = np.zeros((p, g.num_vertices), dtype=np.int32)
    ok = assign >= 0
    np.add.at(cnt, (assign[ok], g.edges[ok, 0]), 1)
    np.add.at(cnt, (assign[ok], g.edges[ok, 1]), 1)
    return cnt


def cumcount(a: np.ndarray) -> np.ndarray:
    """Occurrence rank of each element among equal values, in array order."""
    order = np.argsort(a, kind="stable")
    sa = a[order]
    fresh = np.concatenate([[True], sa[1:] != sa[:-1]])
    starts = np.flatnonzero(fresh)
    sizes = np.diff(np.append(starts, len(sa)))
    rank_sorted = np.arange(len(sa)) - np.repeat(starts, sizes)
    out = np.empty(len(a), dtype=np.int64)
    out[order] = rank_sorted
    return out


def t_com_from_membership(member: np.ndarray, replicas: np.ndarray,
                          com_sum: np.ndarray, c_com: np.ndarray) -> np.ndarray:
    """Vectorized Eq. 4:  T_i^com = Σ_{v∈V_i} [(|S(v)|−1)·C_i^com
    + (com_sum(v) − C_i^com)], as one masked matmul over [com_sum, |S|]."""
    m = member.astype(np.float64)
    cols = m @ np.stack([com_sum, replicas.astype(np.float64)], axis=1)
    return cols[:, 0] + c_com * cols[:, 1] - 2.0 * c_com * m.sum(axis=1)


# ---------------------------------------------------------------------------
# compacting working-CSR view
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkingCSR:
    """The live slice of a graph's CSR adjacency.

    As edges are consumed (assigned), dead entries accumulate; ``view``
    recompacts geometrically once fewer than ``compact_below`` of the stored
    entries are live.  Dropping dead entries preserves adjacency order, so
    it changes no engine decision — only how much dead data each gather
    touches.  Shared by the batched expansion engine and PartitionState.
    """

    indptr: np.ndarray
    indices: np.ndarray
    eids: np.ndarray

    @classmethod
    def from_graph(cls, g: "Graph") -> "WorkingCSR":
        return cls(indptr=g.indptr, indices=g.indices, eids=g.edge_ids)

    def view(self, edge_live, live_edges: int,
             compact_below: float = 0.75):
        """(indptr, indices, eids) of the live adjacency.

        ``edge_live`` is a (E,) bool over canonical edge ids — or a zero-arg
        callable producing it, evaluated only when compaction triggers;
        ``live_edges`` is its popcount (each live edge stores two slots).
        """
        stored = len(self.eids)
        if stored and 2 * live_edges < compact_below * stored:
            if callable(edge_live):
                edge_live = edge_live()
            live = edge_live[self.eids]
            cum = np.concatenate(
                [np.zeros(1, dtype=np.int64), np.cumsum(live)])
            self.indptr = cum[self.indptr]
            self.indices = self.indices[live]
            self.eids = self.eids[live]
        return self.indptr, self.indices, self.eids


# ---------------------------------------------------------------------------
# the unified incremental state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PartitionState:
    """Incrementally-maintained per-machine costs for an edge assignment."""

    g: "Graph"
    cluster: "Cluster"
    assign: np.ndarray            # (E,) int32, machine per edge (-1 = unassigned)
    cnt: np.ndarray               # (p, V) int32: partition-i edges incident on v
    edges_per: np.ndarray         # (p,)  |E_i|            (Eq. 3)
    verts_per: np.ndarray         # (p,)  |V_i|            (Eq. 3)
    t_cal: np.ndarray             # (p,)  Eq. 3 totals
    t_com: np.ndarray             # (p,)  Eq. 4 totals
    com_sum: np.ndarray           # (V,)  Σ_{i∈S(v)} C_i^com
    replicas: np.ndarray          # (V,)  |S(v)|
    #: optional (V,) float64 per-vertex calculation weight — the
    #: training-aware balance term: ``1 + train_balance`` on train
    #: vertices, 1 elsewhere, so Eq. 3 charges machines extra for every
    #: labeled vertex they host and the scorers spread the training set.
    #: ``None`` (default) keeps every cost bit-identical to the unweighted
    #: accounting; ``verts_per``/memory always stay plain counts.
    node_weight: np.ndarray | None = None

    def __post_init__(self):
        # Cluster views are rebuilt per call; cache them once for hot loops.
        self._c_node = self.cluster.c_node()
        self._c_edge = self.cluster.c_edge()
        self._c_com = self.cluster.c_com()
        self._mem = self.cluster.memory()
        self._wcsr: WorkingCSR | None = None
        self._wcsr_edges = -1           # graph size the CSR view was cut at
        self._costs_stale = False       # set by light-path admit_block

    @classmethod
    def build(cls, g: "Graph", assign: np.ndarray, cluster: "Cluster", *,
              train_mask: np.ndarray | None = None,
              train_balance: float = 0.0):
        """Build from scratch — the reference for every incremental path.

        ``train_mask`` (V,) bool + ``train_balance`` > 0 switch on the
        training-aware node weight: Eq. 3 charges ``c_node * (1 +
        train_balance)`` per hosted train vertex, so every scorer that
        reads ``t_cal``/``placement_scores`` balances the labeled set
        across machines, not just edges.  Defaults reproduce the plain
        accounting bit for bit.
        """
        p = cluster.p
        cnt = edge_incidence_counts(g, assign, p)
        member = cnt > 0
        ok = assign >= 0
        edges_per = np.bincount(assign[ok], minlength=p).astype(np.float64)
        verts_per = member.sum(axis=1).astype(np.float64)
        c_com = cluster.c_com()
        replicas = member.sum(axis=0).astype(np.int64)
        com_sum = member.T.astype(np.float64) @ c_com
        node_weight = None
        if train_mask is not None and train_balance:
            tm = np.asarray(train_mask, dtype=bool)
            if tm.shape != (g.num_vertices,):
                raise ValueError(
                    f"train_mask must be ({g.num_vertices},) bool, got "
                    f"shape {tm.shape}")
            node_weight = 1.0 + float(train_balance) * tm.astype(np.float64)
        if node_weight is None:
            t_cal = (cluster.c_node() * verts_per
                     + cluster.c_edge() * edges_per)
        else:
            t_cal = (cluster.c_node() * (member.astype(np.float64)
                                         @ node_weight)
                     + cluster.c_edge() * edges_per)
        t_com = t_com_from_membership(member, replicas, com_sum, c_com)
        return cls(g=g, cluster=cluster, assign=np.asarray(assign, dtype=np.int32).copy(),
                   cnt=cnt, edges_per=edges_per, verts_per=verts_per,
                   t_cal=t_cal, t_com=t_com, com_sum=com_sum,
                   replicas=replicas, node_weight=node_weight)

    # -- objective views ----------------------------------------------------
    @property
    def p(self) -> int:
        return self.cluster.p

    @property
    def t_total(self) -> np.ndarray:
        return self.t_cal + self.t_com

    @property
    def tc(self) -> float:
        return float(self.t_total.max())

    def mem_used(self, i: int) -> float:
        return (self.cluster.m_node * self.verts_per[i]
                + self.cluster.m_edge * self.edges_per[i])

    def mem_used_all(self) -> np.ndarray:
        return (self.cluster.m_node * self.verts_per
                + self.cluster.m_edge * self.edges_per)

    @property
    def mem_limits(self) -> np.ndarray:
        """Per-machine memory caps M_i (cached cluster view)."""
        return self._mem

    def working_csr(self, compact_below: float = 0.75):
        """Live (unassigned-edge) adjacency view, recompacted geometrically.

        Appended edges (:meth:`append_edges`) invalidate the cached view:
        the next call recuts it from the grown adjacency, so CSR consumers
        never see a stale edge universe.
        """
        if self._wcsr is None or self._wcsr_edges != self.g.num_edges:
            self._wcsr = WorkingCSR.from_graph(self.g)
            self._wcsr_edges = self.g.num_edges
        return self._wcsr.view(self.assign < 0,
                               int((self.assign < 0).sum()),
                               compact_below=compact_below)

    # -- scalar oracle path -------------------------------------------------
    def _vertex_enter(self, i: int, v: int) -> None:
        c_com = self._c_com
        # v becomes present on i: pairs (i, j) for each j already holding v.
        self.t_com[i] += self.replicas[v] * c_com[i] + self.com_sum[v]
        holders = np.flatnonzero(self.cnt[:, v] > 0)
        self.t_com[holders] += c_com[holders] + c_com[i]
        self.replicas[v] += 1
        self.com_sum[v] += c_com[i]
        self.verts_per[i] += 1
        if self.node_weight is None:
            self.t_cal[i] += self._c_node[i]
        else:
            self.t_cal[i] += self._c_node[i] * self.node_weight[v]

    def _vertex_leave(self, i: int, v: int) -> None:
        c_com = self._c_com
        self.replicas[v] -= 1
        self.com_sum[v] -= c_com[i]
        self.t_com[i] -= self.replicas[v] * c_com[i] + self.com_sum[v]
        holders = np.flatnonzero(self.cnt[:, v] > 0)
        holders = holders[holders != i]
        self.t_com[holders] -= c_com[holders] + c_com[i]
        self.verts_per[i] -= 1
        if self.node_weight is None:
            self.t_cal[i] -= self._c_node[i]
        else:
            self.t_cal[i] -= self._c_node[i] * self.node_weight[v]

    def remove_edge(self, e: int) -> None:
        i = int(self.assign[e])
        if i < 0:
            raise ValueError(f"remove_edge: edge {e} is unassigned")
        u, v = self.g.edges[e]
        self.assign[e] = -1
        self.edges_per[i] -= 1
        self.t_cal[i] -= self._c_edge[i]
        for x in (int(u), int(v)):
            self.cnt[i, x] -= 1
            if self.cnt[i, x] == 0:
                self._vertex_leave(i, x)

    def add_edge(self, e: int, i: int) -> None:
        if self.assign[e] != -1:
            raise ValueError(f"add_edge: edge {e} is already assigned "
                             f"to machine {int(self.assign[e])}")
        if not 0 <= i < self.p:
            raise ValueError(f"add_edge: machine {i} outside [0, {self.p})")
        u, v = self.g.edges[e]
        for x in (int(u), int(v)):
            if self.cnt[i, x] == 0:
                self._vertex_enter(i, x)
            self.cnt[i, x] += 1
        self.assign[e] = i
        self.edges_per[i] += 1
        self.t_cal[i] += self._c_edge[i]

    def delta_t_if_added(self, e: int, i: int) -> float:
        """Resulting T_i if edge e were added to machine i (no mutation)."""
        u, v = self.g.edges[e]
        c_com = self._c_com
        dt = self._c_edge[i]
        for x in (int(u), int(v)):
            if self.cnt[i, x] == 0:
                c_n = (self._c_node[i] if self.node_weight is None
                       else self._c_node[i] * self.node_weight[x])
                dt += c_n + self.replicas[x] * c_com[i] + self.com_sum[x]
        return float(self.t_total[i] + dt)

    def mem_after(self, e: int, i: int) -> float:
        u, v = self.g.edges[e]
        new_v = sum(1 for x in (int(u), int(v)) if self.cnt[i, x] == 0)
        return (self.cluster.m_node * (self.verts_per[i] + new_v)
                + self.cluster.m_edge * (self.edges_per[i] + 1))

    # -- batch-first API ----------------------------------------------------
    def _tcom_contrib(self, member: np.ndarray, replicas: np.ndarray,
                      com_sum: np.ndarray) -> np.ndarray:
        return t_com_from_membership(member, replicas, com_sum, self._c_com)

    def _recount_columns(self, A: np.ndarray, mutate_cnt) -> None:
        """Exact wave-local recount: apply ``mutate_cnt`` (which edits the
        vertex columns A of ``cnt``), then rebuild every membership-derived
        quantity of those columns from scratch and apply the delta.  Exact
        regardless of how the wave's edges interact (shared endpoints,
        same-machine pileups), because Eq. 3/4 are separable per vertex."""
        mem_old = self.cnt[:, A] > 0
        old = self._tcom_contrib(mem_old, self.replicas[A], self.com_sum[A])
        mutate_cnt()
        mem_new = self.cnt[:, A] > 0
        self.replicas[A] = mem_new.sum(axis=0)
        self.com_sum[A] = mem_new.T.astype(np.float64) @ self._c_com
        new = self._tcom_contrib(mem_new, self.replicas[A], self.com_sum[A])
        self.t_com += new - old
        dv = (mem_new.sum(axis=1) - mem_old.sum(axis=1)).astype(np.float64)
        self.verts_per += dv
        if self.node_weight is None:
            self.t_cal += self._c_node * dv
        else:
            dvw = ((mem_new.astype(np.float64) - mem_old.astype(np.float64))
                   @ self.node_weight[A])
            self.t_cal += self._c_node * dvw

    def remove_edges(self, es: np.ndarray) -> None:
        """Batch ``remove_edge`` over an edge-id array.

        Preconditions (``ValueError``, never a stripped-out ``assert``):
        every id must be currently assigned, and ids must be unique within
        the batch — a duplicated id would hit ``np.subtract.at`` twice but
        the membership recount once, silently corrupting ``cnt``.
        """
        es = np.asarray(es, dtype=np.int64)
        if es.size == 0:
            return
        if len(np.unique(es)) != len(es):
            raise ValueError("remove_edges: duplicate edge ids in batch")
        ms = self.assign[es].astype(np.int64)
        if (ms < 0).any():
            bad = es[ms < 0][:8]
            raise ValueError(f"remove_edges: unassigned edge ids {bad}")
        u = self.g.edges[es, 0].astype(np.int64)
        v = self.g.edges[es, 1].astype(np.int64)
        A = np.unique(np.concatenate([u, v]))

        def mutate():
            np.subtract.at(self.cnt, (ms, u), 1)
            np.subtract.at(self.cnt, (ms, v), 1)

        self._recount_columns(A, mutate)
        self.assign[es] = -1
        dm = np.bincount(ms, minlength=self.p).astype(np.float64)
        self.edges_per -= dm
        self.t_cal -= self._c_edge * dm

    def add_edges(self, es: np.ndarray, ms: np.ndarray) -> None:
        """Batch ``add_edge``: place es[j] on machine ms[j].

        Preconditions (``ValueError``, never a stripped-out ``assert``):
        every id must be currently unassigned, machines in ``[0, p)``, and
        ids unique within the batch — a duplicated id would double-count
        in ``np.add.at`` while ``assign[es] = ms`` lands once.
        """
        es = np.asarray(es, dtype=np.int64)
        if es.size == 0:
            return
        ms = np.asarray(ms, dtype=np.int64)
        if es.shape != ms.shape:
            raise ValueError(f"add_edges: {len(es)} edge ids vs "
                             f"{len(ms)} machines")
        if len(np.unique(es)) != len(es):
            raise ValueError("add_edges: duplicate edge ids in batch")
        if ((ms < 0) | (ms >= self.p)).any():
            raise ValueError(f"add_edges: machine ids outside [0, {self.p})")
        if (self.assign[es] != -1).any():
            bad = es[self.assign[es] != -1][:8]
            raise ValueError(f"add_edges: already-assigned edge ids {bad}")
        u = self.g.edges[es, 0].astype(np.int64)
        v = self.g.edges[es, 1].astype(np.int64)
        A = np.unique(np.concatenate([u, v]))

        def mutate():
            np.add.at(self.cnt, (ms, u), 1)
            np.add.at(self.cnt, (ms, v), 1)

        self._recount_columns(A, mutate)
        self.assign[es] = ms
        dm = np.bincount(ms, minlength=self.p).astype(np.float64)
        self.edges_per += dm
        self.t_cal += self._c_edge * dm

    # -- dynamic growth (true insertion) ------------------------------------
    def append_edges(self, uv: np.ndarray) -> np.ndarray:
        """Grow the edge universe: append genuinely-new edges (and any new
        vertices), returning their fresh canonical edge ids — unassigned,
        ready for :meth:`add_edges` or the streaming wave engine.

        This is what ``add_edges`` alone cannot do: its ``assign[es] == -1``
        precondition re-places ids already present in ``self.g.edges``,
        whereas a live insert stream delivers pairs the graph has never
        seen.  Requires the graph to be a :class:`~.graph.
        GrowableGraph` (build the state over
        ``GrowableGraph.from_graph(g)``); ``uv`` must be canonical
        (``u < v``), loop-free, batch-unique, and absent from the graph —
        the graph's id index enforces absence, so a re-inserted deleted
        edge must go through its existing id instead.

        Every per-vertex structure (``cnt`` columns, ``replicas``,
        ``com_sum``) grows with the vertex space, and ``assign`` with the
        edge space, so shapes always match a fresh build.  No cost changes:
        an unassigned edge contributes nothing to Eq. 3/4, so the state
        stays exactly consistent with a fresh ``build`` on the grown graph.
        """
        if not hasattr(self.g, "append"):
            raise ValueError(
                "append_edges needs a growable graph — build the state "
                "over core.graph.GrowableGraph.from_graph(g)")
        uv = np.asarray(uv, dtype=np.int64).reshape(-1, 2)
        if len(uv) == 0:
            return np.empty(0, dtype=np.int64)
        eids = self.g.append(uv)       # validates canonical/unique/absent
        nv = self.g.num_vertices
        if nv > self.cnt.shape[1]:
            grow = nv - self.cnt.shape[1]
            self.cnt = np.pad(self.cnt, ((0, 0), (0, grow)))
            self.replicas = np.pad(self.replicas, (0, grow))
            self.com_sum = np.pad(self.com_sum, (0, grow))
        grow_e = self.g.num_edges - len(self.assign)
        if grow_e > 0:
            self.assign = np.concatenate(
                [self.assign, np.full(grow_e, -1, dtype=self.assign.dtype)])
        return eids

    def placement_scores(self, es: np.ndarray,
                         cands: np.ndarray | None = None):
        """One-gather scoring kernel for the repair waves.

        Returns ``(T, mem, free_u, free_v)``, all (|es|, |cands|): the
        resulting T and memory footprint of adding each edge to each
        candidate (``delta_t_if_added``/``mem_after`` broadcast — every
        entry scored *independently*; wave admission bounds the
        staleness), plus the would-be-new-endpoint masks, so callers need
        no second pass over the ``cnt`` columns (``share = ~free``).
        """
        es = np.asarray(es, dtype=np.int64)
        cands = (np.arange(self.p, dtype=np.int64) if cands is None
                 else np.asarray(cands, dtype=np.int64))
        u = self.g.edges[es, 0].astype(np.int64)
        v = self.g.edges[es, 1].astype(np.int64)
        free_u = self.cnt[np.ix_(cands, u)] == 0          # (c, e)
        free_v = self.cnt[np.ix_(cands, v)] == 0
        c_node = self._c_node[cands][:, None]
        c_com = self._c_com[cands][:, None]
        if self.node_weight is None:
            c_node_u = c_node_v = c_node
        else:   # training-aware Eq. 3: per-endpoint weighted node charge
            c_node_u = c_node * self.node_weight[u][None, :]
            c_node_v = c_node * self.node_weight[v][None, :]
        # same summation order as the scalar oracle: c_edge, +u-term, +v-term
        dt = (self._c_edge[cands][:, None]
              + free_u * (c_node_u + self.replicas[u][None, :] * c_com
                          + self.com_sum[u][None, :])
              + free_v * (c_node_v + self.replicas[v][None, :] * c_com
                          + self.com_sum[v][None, :]))
        new_v = free_u.astype(np.float64) + free_v
        mem = (self.cluster.m_node * (self.verts_per[cands][:, None] + new_v)
               + self.cluster.m_edge * (self.edges_per[cands][:, None] + 1.0))
        return ((self.t_total[cands][:, None] + dt).T, mem.T,
                free_u.T, free_v.T)

    def delta_t_batch(self, es: np.ndarray,
                      cands: np.ndarray | None = None) -> np.ndarray:
        """(|es|, |cands|) resulting T — ``delta_t_if_added`` broadcast."""
        return self.placement_scores(es, cands)[0]

    def mem_after_batch(self, es: np.ndarray,
                        cands: np.ndarray | None = None) -> np.ndarray:
        """(|es|, |cands|) memory footprint — ``mem_after`` broadcast."""
        return self.placement_scores(es, cands)[1]

    # -- block-streaming hooks ---------------------------------------------
    def endpoint_presence(self, u: np.ndarray, v: np.ndarray):
        """(|u|, p) bool pair: is each endpoint already present on machine i.

        The replication term of every streaming scorer reads the shared
        membership matrix (``cnt > 0``) through this one gather — the
        block-stream engine's analogue of ``placement_scores``'s
        ``free_u``/``free_v`` masks (``pres == ~free``).
        """
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        return (self.cnt[:, u] > 0).T, (self.cnt[:, v] > 0).T

    def admit_block(self, u: np.ndarray, v: np.ndarray,
                    es: np.ndarray | None, ms: np.ndarray,
                    verts_delta: np.ndarray | None = None) -> None:
        """Admit one block-stream wave: edge ``es[j] = (u[j], v[j])`` onto
        machine ``ms[j]``.

        Without ``verts_delta`` this routes through ``add_edges`` (full
        Eq. 3/4 accounting).  With it — the engine passes the exact
        per-machine count of new (machine, vertex) cells, computed from
        its wave-leader bits — the admission takes the *light* path: cnt,
        assign, |E_i|/|V_i| and Eq. 3 update exactly, while the Eq. 4
        replica quantities (replicas/com_sum/t_com) go stale until one
        vectorized :meth:`refresh_costs` at stream end.  The streaming
        scorers never read the stale fields mid-stream.
        """
        assert es is not None, "PartitionState admission needs edge ids"
        if verts_delta is None or self.node_weight is not None:
            # the light path charges c_node per new vertex uniformly, which
            # is wrong under a train-weighted Eq. 3 — take the exact path
            self.add_edges(es, ms)
            return
        np.add.at(self.cnt, (ms, u), 1)
        np.add.at(self.cnt, (ms, v), 1)
        self.assign[es] = ms
        dm = np.bincount(ms, minlength=self.p).astype(np.float64)
        self.edges_per += dm
        self.verts_per += verts_delta
        self.t_cal += self._c_edge * dm + self._c_node * verts_delta
        self._costs_stale = True

    def admit_single(self, u: int, v: int, e, i: int,
                     verts_delta: float) -> None:
        """Light-path admission of one edge — the block engine's scalar
        drain calls this per replica-creating edge, so it carries none of
        :meth:`admit_block`'s batch scaffolding.  Same staleness contract:
        Eq. 4 quantities wait for :meth:`refresh_costs`.
        """
        if self.node_weight is not None:
            self.add_edge(int(e), int(i))   # exact path, as in admit_block
            return
        self.cnt[i, u] += 1
        self.cnt[i, v] += 1
        self.assign[e] = i
        self.edges_per[i] += 1.0
        self.verts_per[i] += verts_delta
        self.t_cal[i] += self._c_edge[i] + self._c_node[i] * verts_delta
        self._costs_stale = True

    def train_counts(self, train_mask: np.ndarray) -> np.ndarray:
        """(p,) count of train vertices each machine hosts a member of —
        the numerator of the train-skew metric (max/mean of this)."""
        tm = np.asarray(train_mask, dtype=bool)
        return (self.cnt[:, tm] > 0).sum(axis=1).astype(np.int64)

    def refresh_costs(self) -> None:
        """Rebuild the Eq. 4 quantities after light-path admissions."""
        member = self.cnt > 0
        self.replicas = member.sum(axis=0).astype(np.int64)
        self.com_sum = member.T.astype(np.float64) @ self._c_com
        self.t_com = t_com_from_membership(member, self.replicas,
                                           self.com_sum, self._c_com)
        self._costs_stale = False


# ---------------------------------------------------------------------------
# graph-free membership state for out-of-core edge streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamMembership:
    """The membership slice of ``PartitionState`` without a ``Graph``.

    Holds exactly the quantities the block-stream scorers read — the
    ``(p, V)`` incidence counts plus |E_i| / |V_i| — so the same engine can
    partition an edge stream that never materializes as a single array
    (``data/io.iter_edge_blocks``).  Update semantics match
    ``PartitionState`` bit for bit: a vertex is a member of machine i iff an
    incident edge is assigned there, and the per-machine totals are float64
    holding exact integers.
    """

    cnt: np.ndarray               # (p, V) int32 incidence counts
    edges_per: np.ndarray         # (p,) float64 |E_i|
    verts_per: np.ndarray         # (p,) float64 |V_i|
    #: spill/dedup accounting when the stream ran with ``dedup="two_pass"``
    #: (a ``SpillStats`` of the reference's data/io.py), else None
    spill_stats: object = None

    @classmethod
    def empty(cls, num_vertices: int, p: int) -> "StreamMembership":
        return cls(cnt=np.zeros((p, num_vertices), dtype=np.int32),
                   edges_per=np.zeros(p, dtype=np.float64),
                   verts_per=np.zeros(p, dtype=np.float64))

    @property
    def p(self) -> int:
        return len(self.edges_per)

    def endpoint_presence(self, u: np.ndarray, v: np.ndarray):
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        return (self.cnt[:, u] > 0).T, (self.cnt[:, v] > 0).T

    def admit_block(self, u: np.ndarray, v: np.ndarray,
                    es: np.ndarray | None, ms: np.ndarray,
                    verts_delta: np.ndarray | None = None) -> None:
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        ms = np.asarray(ms, dtype=np.int64)
        if verts_delta is None:         # recount the touched columns
            A = np.unique(np.concatenate([u, v]))
            before = (self.cnt[:, A] > 0).sum(axis=1)
            np.add.at(self.cnt, (ms, u), 1)
            np.add.at(self.cnt, (ms, v), 1)
            after = (self.cnt[:, A] > 0).sum(axis=1)
            verts_delta = (after - before).astype(np.float64)
        else:                           # engine-supplied exact delta
            np.add.at(self.cnt, (ms, u), 1)
            np.add.at(self.cnt, (ms, v), 1)
        self.verts_per += verts_delta
        self.edges_per += np.bincount(ms, minlength=self.p).astype(np.float64)

    def admit_single(self, u: int, v: int, e, i: int,
                     verts_delta: float) -> None:
        """One-edge admission without the batch scaffolding (scalar drain).

        ``e`` is accepted for signature parity with ``PartitionState`` and
        ignored — the stream state tracks no per-edge assignment."""
        self.cnt[i, u] += 1
        self.cnt[i, v] += 1
        self.edges_per[i] += 1.0
        self.verts_per[i] += verts_delta

    # -- delta exchange (the parallel-scoring epoch barrier) -----------------
    def totals(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-machine ``(|E_i|, |V_i|)`` snapshot — the scalar half of the
        epoch-barrier payload workers exchange in ``core/parallel.py``."""
        return self.edges_per.copy(), self.verts_per.copy()

    def apply_admissions(self, u: np.ndarray, v: np.ndarray,
                         ms: np.ndarray) -> None:
        """Merge admissions recorded on another replica of this state.

        Routes through :meth:`admit_block`'s recount path, which derives
        the exact per-machine ``|V_i|`` delta from the incidence counts —
        every replica that applies the same admission sequence from equal
        state lands on bitwise-equal state, which is the invariant the
        parallel scoring pipeline's epoch barrier relies on.
        """
        self.admit_block(u, v, None, ms, verts_delta=None)

    def revert_admissions(self, u: np.ndarray, v: np.ndarray,
                          ms: np.ndarray,
                          verts_delta: np.ndarray) -> None:
        """Exact integer inverse of admissions previously applied here.

        ``verts_delta`` must be the per-machine ``|V_i|`` delta those
        admissions actually produced (the admission log records it);
        incidence counts and totals subtract back to their prior values
        exactly — all updates are integer-valued, so no float drift.
        """
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        ms = np.asarray(ms, dtype=np.int64)
        np.subtract.at(self.cnt, (ms, u), 1)
        np.subtract.at(self.cnt, (ms, v), 1)
        self.edges_per -= np.bincount(ms, minlength=self.p).astype(np.float64)
        self.verts_per -= verts_delta

    @property
    def replicas(self) -> np.ndarray:
        """(V,) |S(v)| — derived, for end-of-stream RF reporting."""
        return (self.cnt > 0).sum(axis=0)

    def replication_factor(self) -> float:
        r = self.replicas
        covered = r > 0
        return float(r[covered].sum() / max(1, covered.sum()))
