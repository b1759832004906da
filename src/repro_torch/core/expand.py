"""Partition expansion via best-first search (paper Algorithms 2-3).

For machine i with capacity δ_i we grow edge set E_i by repeatedly expanding
the boundary vertex minimizing

    w(v) = (1+α)|N(v)\\S| − (α + I_B(v)·β)|N(v)|            (paper Eq. 5)

where S is the boundary set, C ⊆ S the core set (all remaining edges
consumed) and B the global border set.  Neighborhoods are taken in the
working graph of partition i — ``E(G) \\ Σ_{j<i} E_j`` (the input of
Algorithm 2) — frozen at the start of this partition's expansion:

* |N(v)|   = remaining degree of v when partition i starts;
* |N(v)\\S| = those neighbors not yet in S (edges assigned *during* this
  partition count toward cohesion |N(v)∩S|; edges consumed by earlier
  partitions never count).

Expanding x (AllocEdges, Alg. 3) pulls every unassigned neighbor y of x
into S and assigns all unassigned edges between y and S.  Invariant: within
one partition's expansion, every unassigned edge incident to S leads
outside S.

Two engines implement the same expansion:

* ``engine="heap"`` — the reference oracle: a per-vertex lazy min-heap
  (the paper's Min-Heap optimization), O(|E_i| + |V_i| log |V_i|) per
  partition, but interpreter-bound (one Python iteration per expansion
  vertex, one ``heappush`` per touched neighbor).
* ``engine="batched"`` — the production engine: Eq. 5 scores are quantized
  to integers (``w·QUANT_SCALE`` with exactly-linear integer coefficients,
  so the ordering matches the float heap whenever ``(1+α)·scale`` and
  ``(α+β)·scale`` are integral) and kept *fresh* in a per-vertex array;
  each step scans the live frontier (a duplicate-tolerant id buffer with
  geometric compaction — see ``_FrontierBuffer``) and expands the whole
  best-score-window slice with fully vectorized AllocEdges — no
  per-neighbor Python work.  ``strict_ties=True`` degrades the slice to
  one vertex per step (min id at the best score), which makes the batched
  engine bit-identical to the heap oracle whenever the quantization is
  exact — the equivalence tests rely on this.  Adjacency access is
  degree-split (``hub_split``/``hub_degree``): a row gathered alone is a
  zero-copy CSR view, and hub-dominated multi-row gathers copy dense
  contiguous row slices while the tail keeps the ragged flat-index
  gather — identical output, far less index arithmetic on power-law
  graphs.

Set membership is uint8 bitmaps (the paper's bitmap optimization) in both.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .graph import Graph
from .partition_state import WorkingCSR

#: Integer score quantization for the batched engine: q(v) =
#: round((1+α)·S)·ext(v) − round((α+β·I_B(v))·S)·deg0(v).  64 keeps the
#: coefficients exact for α, β that are multiples of 1/64 (incl. 0.25, 0.5)
#: and within ~1% for the paper's α=0.1/0.3 — coefficient fidelity is what
#: keeps the batched TC close to the oracle; bucket merging comes from the
#: admission window, not from coarse quantization.
QUANT_SCALE = 64

ENGINES = ("heap", "batched")


@dataclasses.dataclass
class ExpansionState:
    """Shared state across the p sequential partition expansions."""

    g: Graph
    epoch: np.ndarray             # (E,) int32: partition that took e, -1 free
    rem_deg: np.ndarray           # (V,) int64: unassigned incident edges
    in_border: np.ndarray         # (V,) uint8: B, replicated-vertex set
    seed_heap: list | None        # lazy (rem_deg, v) heap for vertexSelection
    unassigned_edges: int
    # Working CSR for the batched engine: the live (unassigned) slice of
    # g's adjacency, recompacted geometrically as partitions consume edges
    # (shared compaction machinery: ``partition_state.WorkingCSR``).
    wcsr: WorkingCSR | None = None

    @classmethod
    def fresh(cls, g: Graph) -> "ExpansionState":
        deg = g.degree().astype(np.int64)
        return cls(
            g=g,
            epoch=np.full(g.num_edges, -1, dtype=np.int32),
            rem_deg=deg.copy(),
            in_border=np.zeros(g.num_vertices, dtype=np.uint8),
            seed_heap=None,   # built on first _vertex_selection call
            unassigned_edges=g.num_edges,
        )

    def working_csr(self, compact_below: float = 0.75):
        """(indptr, indices, eids) of the live adjacency, recompacting when
        fewer than ``compact_below`` of the stored entries are still live."""
        if self.wcsr is None:
            self.wcsr = WorkingCSR.from_graph(self.g)
        return self.wcsr.view(lambda: self.epoch == -1,
                              self.unassigned_edges,
                              compact_below=compact_below)

    @property
    def assigned(self) -> np.ndarray:
        return self.epoch >= 0


def _vertex_selection(st: ExpansionState, in_s: np.ndarray) -> int:
    """Pick a fresh seed: minimum remaining degree among untouched vertices."""
    if st.seed_heap is None:
        st.seed_heap = [(int(d), int(v))
                        for v, d in enumerate(st.rem_deg) if d > 0]
        heapq.heapify(st.seed_heap)
    h = st.seed_heap
    while h:
        d, v = h[0]
        rd = st.rem_deg[v]
        if rd <= 0 or in_s[v]:
            heapq.heappop(h)
            continue
        if rd != d:  # stale priority: refresh lazily
            heapq.heapreplace(h, (int(rd), v))
            continue
        return v
    return -1


def expand_partition(
    st: ExpansionState,
    part_id: int,
    delta: int,
    alpha: float,
    beta: float,
    *,
    memory_limit: float | None = None,
    m_node: float = 1.0,
    m_edge: float = 2.0,
    record_order: list | None = None,
    engine: str = "heap",
    **engine_kw,
) -> np.ndarray:
    """Grow one partition of up to ``delta`` edges; returns its edge ids.

    If ``memory_limit`` is given, expansion stops early once the *actual*
    memory footprint m_node·|V_i| + m_edge·|E_i| would exceed it (the δ from
    preprocessing bounds it only through the |V|/|E| estimate).

    ``engine`` selects the scalar heap oracle or the batched bucket-queue
    engine (see module docstring); extra kwargs go to the batched engine.
    """
    if engine == "batched":
        return expand_partition_batched(
            st, part_id, delta, alpha, beta, memory_limit=memory_limit,
            m_node=m_node, m_edge=m_edge, record_order=record_order,
            **engine_kw)
    if engine != "heap":
        raise ValueError(f"unknown expansion engine {engine!r}")
    if engine_kw:
        raise TypeError(
            f"engine='heap' takes no engine kwargs; got {sorted(engine_kw)}")
    return _expand_partition_heap(
        st, part_id, delta, alpha, beta, memory_limit=memory_limit,
        m_node=m_node, m_edge=m_edge, record_order=record_order)


def _expand_partition_heap(
    st: ExpansionState,
    part_id: int,
    delta: int,
    alpha: float,
    beta: float,
    *,
    memory_limit: float | None = None,
    m_node: float = 1.0,
    m_edge: float = 2.0,
    record_order: list | None = None,
) -> np.ndarray:
    """The scalar lazy-min-heap reference engine (paper Algorithms 2-3)."""
    g, V = st.g, st.g.num_vertices
    indptr, indices, eids = g.indptr, g.indices, g.edge_ids
    epoch, rem_deg, in_border = st.epoch, st.rem_deg, st.in_border
    in_s = np.zeros(V, dtype=np.uint8)
    in_c = np.zeros(V, dtype=np.uint8)
    deg0 = rem_deg.copy()                   # |N(v)| in this partition's graph
    ext = deg0.copy()                       # |N(v)\S|, starts at |N(v)|
    edge_list: list[int] = []
    heap: list[tuple[float, int]] = []
    w_cur = np.zeros(V, dtype=np.float64)
    n_vertices = 0
    target = int(delta)

    def join_s(y: int) -> None:
        """Add y to S; assign all unassigned y→S edges (vectorized)."""
        nonlocal n_vertices
        in_s[y] = 1
        n_vertices += 1
        nb = indices[indptr[y]:indptr[y + 1]]
        es = eids[indptr[y]:indptr[y + 1]]
        live = epoch[es] == -1              # edges still in the working graph
        nb_live, es_live = nb[live], es[live]
        ext[nb_live] -= 1                   # y entered S (working-graph nbrs)
        s_nb = in_s[nb_live] == 1
        e_new, z_new = es_live[s_nb], nb_live[s_nb]
        room = target - len(edge_list)
        if len(e_new) > room:               # respect δ_i exactly (Alg.3 L8)
            e_new, z_new = e_new[:room], z_new[:room]
        if len(e_new):
            epoch[e_new] = part_id
            rem_deg[z_new] -= 1
            rem_deg[y] -= len(e_new)
            st.unassigned_edges -= len(e_new)
            edge_list.extend(e_new.tolist())
        # Refresh frontier priorities for affected S\C vertices (incl. y).
        front = nb_live[s_nb & (in_c[nb_live] == 0)]
        if in_c[y] == 0:
            front = np.append(front, y)
        if len(front):
            ws = ((1.0 + alpha) * ext[front]
                  - (alpha + beta * in_border[front]) * deg0[front])
            w_cur[front] = ws
            for w, v in zip(ws.tolist(), front.tolist()):
                heapq.heappush(heap, (w, v))

    while len(edge_list) < target and st.unassigned_edges > 0:
        if memory_limit is not None and (
                m_node * (n_vertices + 1) + m_edge * (len(edge_list) + 1)
                > memory_limit + 1e-9):
            break
        # --- select the expansion vertex x (Alg.2 L4-7) -------------------
        x = -1
        while heap:
            w, v = heap[0]
            if in_c[v] or not in_s[v] or w != w_cur[v]:
                heapq.heappop(heap)        # stale or consumed
                continue
            x = v
            break
        if x == -1:
            x = _vertex_selection(st, in_s)
            if x == -1:
                break                      # nothing expandable remains
            join_s(x)
            if len(edge_list) >= target:
                in_c[x] = 1
                break
        # --- AllocEdges(C, S, E_i, x, E) (Alg.3) ---------------------------
        in_c[x] = 1
        sl = slice(indptr[x], indptr[x + 1])
        nbs = indices[sl][epoch[eids[sl]] == -1]     # unassigned edges only
        for y in nbs[in_s[nbs] == 0].tolist():
            if in_s[y]:                    # joined via an earlier sibling
                continue
            join_s(y)
            if len(edge_list) >= target:
                break

    # B ← B ∪ (S \ C); plus core vertices that still have remaining edges
    # (they will replicate into later partitions).
    touched = np.flatnonzero(in_s)
    in_border[touched[in_c[touched] == 0]] = 1
    core = touched[in_c[touched] == 1]
    in_border[core[rem_deg[core] > 0]] = 1
    if record_order is not None:
        record_order.extend(edge_list)
    return np.asarray(edge_list, dtype=np.int64)


# ---------------------------------------------------------------------------
# batched engine
# ---------------------------------------------------------------------------

class _FrontierBuffer:
    """Duplicate-tolerant id buffer over the live frontier (S \\ C).

    The predecessor of this structure was a monotone bucket queue keyed by
    exact quantized score; on skewed graphs the scores are near-unique, so
    every refresh opened ~hundreds of distinct buckets (one dict + heap op
    each) and the queue cost dominated the engine.  This buffer stores
    vertex *ids only* — scores are always read fresh from ``qscore`` at
    scan time, so there is no score staleness at all — and tolerates
    duplicates and departed vertices, compacting geometrically: when the
    live entries fall under half the buffer, or the buffer outgrows twice
    the true frontier, it collapses to ``unique(live)``.  A best-first
    admission step is then one vectorized scan of the live entries.
    """

    __slots__ = ("buf", "pend")

    def __init__(self):
        self.buf = np.zeros(0, dtype=np.int64)
        self.pend: list[np.ndarray] = []

    def push(self, verts: np.ndarray) -> None:
        self.pend.append(verts)

    def live(self, fr: np.ndarray, frontier_size: int) -> np.ndarray:
        """Current live entries (duplicates possible), compacting lazily."""
        if self.pend:
            arrs = ([self.buf] if len(self.buf) else []) + self.pend
            self.buf = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
            self.pend.clear()
        if not len(self.buf):
            return self.buf
        live = self.buf[fr[self.buf]]
        if (2 * len(live) < len(self.buf)
                or len(self.buf) > 2 * frontier_size + 64):
            self.buf = np.unique(live).astype(np.int64, copy=False)
            return self.buf
        return live


def expand_partition_batched(
    st: ExpansionState,
    part_id: int,
    delta: int,
    alpha: float,
    beta: float,
    *,
    memory_limit: float | None = None,
    m_node: float = 1.0,
    m_edge: float = 2.0,
    record_order: list | None = None,
    scale: int = QUANT_SCALE,
    strict_ties: bool = False,
    batch_target: int = 512,
    batch_frac: float = 0.5,
    batch_window: float = 6.0,
    hub_split: bool = True,
    hub_degree: int = 1024,
) -> np.ndarray:
    """Batched AllocEdges over bucket-queue frontier slices.

    Semantics match ``_expand_partition_heap`` with three deliberate
    deviations: (1) all frontier vertices sharing the best quantized score
    expand in one step (``strict_ties=True`` restores one-at-a-time pops
    for oracle equivalence); (2) successive buckets are drained best-first
    into one slice, bounded three ways — at most ``batch_target`` vertices,
    at most ``batch_frac`` of the live frontier (admitting a large fraction
    at once suppresses the cohesion feedback that makes best-first beat
    BFS, which is what degrades TC on skewed graphs), and only while the
    next bucket's score stays within ``batch_window`` w-units of the
    slice's best (must exceed one ext step, (1+α), to batch across mesh
    wavefronts at all); (3) under ``memory_limit`` the batched engine
    truncates joins so the footprint never exceeds the limit (the heap
    engine only pre-checks and may overshoot within one AllocEdges).

    ``hub_split`` enables the degree-split gather: adjacency rows with
    ≥ ``hub_degree`` stored entries (hubs) are materialized as dense
    contiguous row slices — a memcpy, or a zero-copy view when a row is
    gathered alone — while the tail keeps the ragged flat-index gather;
    the split path engages only when hub rows dominate the gather, where
    skipping their per-slot index arithmetic is a guaranteed win.  It is
    bit-neutral: the assembled output is identical either way (slot order
    preserved), so the split changes *no* engine decision, only its cost.
    """
    g, V = st.g, st.g.num_vertices
    indptr, indices, eids = st.working_csr()
    epoch, rem_deg, in_border = st.epoch, st.rem_deg, st.in_border
    in_s = np.zeros(V, dtype=np.uint8)
    in_c = np.zeros(V, dtype=np.uint8)
    fr = np.zeros(V, dtype=bool)            # frontier bitmap: S \ C
    # int32 score arithmetic is the fast path; fall back to int64 whenever
    # coef·maxdeg could approach 2^31 (huge hubs or a large user scale) —
    # a wrapped score would silently corrupt the best-first order.
    ca = round((1.0 + alpha) * scale)
    cd = round((alpha + beta) * scale)
    maxdeg = int(rem_deg.max(initial=0))
    qdtype = np.int32 if max(ca, cd) * max(1, maxdeg) < 2 ** 30 else np.int64
    deg0 = rem_deg.astype(qdtype)           # |N(v)| in this partition's graph
    ext = deg0.copy()                       # |N(v)\S|, starts at |N(v)|
    coef_a = qdtype(ca)
    coef_d = np.where(in_border != 0, qdtype(cd),
                      qdtype(round(alpha * scale))).astype(qdtype)
    qscore = np.zeros(V, dtype=qdtype)
    fb = _FrontierBuffer()
    rank_buf = np.full(V, -1, dtype=np.int32)   # batch rank scratch
    big = max(64, V // 8)   # ufunc.at beats bincount below this size

    def _dec(arr: np.ndarray, idx: np.ndarray) -> None:
        """arr[idx] -= 1 with repeats; bincount for large index sets."""
        if len(idx) > big:
            arr -= np.bincount(idx, minlength=V).astype(arr.dtype)
        else:
            np.subtract.at(arr, idx, 1)
    chunks: list[np.ndarray] = []
    n_edges = 0
    n_vertices = 0
    n_core = 0
    target = int(delta)
    window_q = int(round(batch_window * scale))
    def refresh(front: np.ndarray) -> None:
        """Recompute quantized priorities for S\\C vertices and enqueue."""
        qscore[front] = coef_a * ext[front] - coef_d[front] * deg0[front]
        fb.push(front)

    def gather_adj(verts: np.ndarray):
        """Ragged gather of verts' adjacency slices from the working CSR.

        Returns (nb, es, reps, offs): neighbor / edge-id arrays flattened
        in verts order, the owner rank of each flat slot, and each owner's
        start offset into the flat arrays.

        Degree-split: hub rows (≥ hub_degree entries) are copied as dense
        contiguous slices, the tail through the flat-index gather; a lone
        vertex returns zero-copy CSR views.  Output is identical in all
        paths — only the assembly cost differs.
        """
        starts = indptr[verts]
        counts = indptr[verts + 1] - starts
        total = int(counts.sum())
        offs = np.cumsum(counts) - counts
        if len(verts) == 1:             # dense row slice, no copy at all
            s0, s1 = int(starts[0]), int(starts[0] + counts[0])
            return (indices[s0:s1], eids[s0:s1],
                    np.zeros(total, dtype=np.int32), offs)
        reps = np.repeat(np.arange(len(verts), dtype=np.int32), counts)
        hubs = (np.flatnonzero(counts >= hub_degree)
                if hub_split and total >= 4096
                else np.zeros(0, dtype=np.int64))
        # The split pays ~3 index passes on the hub mass against ~1 extra
        # pass on the tail, so engage it only when hub rows dominate.
        if len(hubs) == 0 or 2 * int(counts[hubs].sum()) < total:
            flat = np.arange(total, dtype=np.int64) \
                + np.repeat(starts - offs, counts)
            return indices[flat], eids[flat], reps, offs
        nb = np.empty(total, dtype=indices.dtype)
        es = np.empty(total, dtype=eids.dtype)
        tail = np.ones(len(verts), dtype=bool)
        tail[hubs] = False
        tc, ts, to = counts[tail], starts[tail], offs[tail]
        tt = int(tc.sum())
        if tt:
            w = np.arange(tt, dtype=np.int64) - np.repeat(
                np.cumsum(tc) - tc, tc)
            dest = np.repeat(to, tc) + w
            src = np.repeat(ts, tc) + w
            nb[dest] = indices[src]
            es[dest] = eids[src]
        for j in hubs.tolist():
            o, s, c = int(offs[j]), int(starts[j]), int(counts[j])
            nb[o:o + c] = indices[s:s + c]
            es[o:o + c] = eids[s:s + c]
        return nb, es, reps, offs

    def batch_join(ys: np.ndarray) -> np.ndarray:
        """Vectorized join_s over an *ordered* batch of non-S vertices.

        Replicates the sequential heap semantics: y_j joins iff the edge
        budget (and, batched-only, the memory budget) is not exhausted
        before its turn; its S-incident edges (S = old S ∪ {y_i : i<j})
        assign in adjacency order, truncated exactly at the budget.
        Returns the vertices that actually joined.
        """
        nonlocal n_edges, n_vertices
        k = len(ys)
        if k == 0:
            return ys
        nb, es, reps, offs = gather_adj(ys)
        live = epoch[es] == -1
        rank_buf[ys] = np.arange(k, dtype=np.int32)
        rnb = rank_buf[nb]
        # assignable: live edge into old S, or into an earlier batch member
        cand = live & ((in_s[nb] == 1) | ((rnb >= 0) & (rnb < reps)))
        cum = np.cumsum(cand, dtype=np.int32)
        # candidates strictly before each owner's adjacency slice
        owner_before = cum[offs] - cand[offs]
        room = target - n_edges
        n_join = int(np.searchsorted(owner_before, room, side="left"))
        e_allowed = room
        if memory_limit is not None:
            # vertex feasibility: owner j joins only while the footprint of
            # (nv + j + 1) vertices plus the edges already taken fits.
            fits = m_node * (n_vertices + np.arange(1, k + 1)) \
                + m_edge * (n_edges + np.minimum(owner_before, room))
            n_fit = int(np.searchsorted(fits, memory_limit + 1e-9,
                                        side="right"))
            n_join = min(n_join, n_fit)
            if n_join > 0:
                e_allowed = min(room, int(
                    (memory_limit + 1e-9
                     - m_node * (n_vertices + n_join)) // m_edge) - n_edges)
        if n_join <= 0:
            rank_buf[ys] = -1
            return ys[:0]
        jmask = reps < n_join
        lj = live if n_join == k else live & jmask
        sel = cand & (cum <= e_allowed) if n_join == k \
            else cand & jmask & (cum <= e_allowed)
        joined = ys[:n_join]
        in_s[joined] = 1
        fr[joined] = True
        n_vertices += n_join
        # y entering S: every live working-graph neighbor loses one ext link
        nbl = nb[lj]
        _dec(ext, nbl)
        e_sel = es[sel]
        z_sel = None
        if len(e_sel):
            z_sel = nb[sel]
            y_sel = ys[reps[sel]]
            epoch[e_sel] = part_id
            _dec(rem_deg, z_sel)
            _dec(rem_deg, y_sel)
            st.unassigned_edges -= len(e_sel)
            n_edges += len(e_sel)
            chunks.append(e_sel)
        # refresh every touched frontier vertex (joiners included).  On the
        # fast path the frontier members whose ext changed are exactly the
        # in-S endpoints of the assigned edges (an unassigned live edge
        # into S only survives a *truncated* batch, which ends the
        # partition); strict mode mirrors the heap's full-neighborhood
        # refresh bit for bit.
        if strict_ties:
            front = np.concatenate([nbl, joined.astype(nbl.dtype)])
        elif z_sel is not None:
            front = np.concatenate([z_sel, joined.astype(z_sel.dtype)])
        else:
            front = joined
        front = front[fr[front]]
        rank_buf[ys] = -1
        if len(front):
            refresh(np.unique(front))
        return joined

    while n_edges < target and st.unassigned_edges > 0:
        if memory_limit is not None and (
                m_node * (n_vertices + 1) + m_edge * (n_edges + 1)
                > memory_limit + 1e-9):
            break
        # --- select the expansion slice (Alg.2 L4-7, batched) -------------
        # One scan of the live frontier (buffer + hub side array): take
        # every vertex within ``window_q`` of the best current score, in
        # (score, vertex id) order, capped.  Scores are read fresh from
        # ``qscore``, so the admitted set equals what draining an exact
        # best-first queue would admit — there is nothing stale to skip.
        X = None
        cap = 1 if strict_ties else max(
            1, min(batch_target, int((n_vertices - n_core) * batch_frac)))
        live = fb.live(fr, n_vertices - n_core)
        if len(live):
            ql = qscore[live]
            s_best = int(ql.min())
            thr = s_best if strict_ties else s_best + window_q
            cand = np.unique(live[ql <= thr]).astype(np.int64, copy=False)
            if strict_ties:
                X = cand[:1]           # all at s_best; sorted ⇒ min id,
                                       # the heap oracle's tie-break
            elif len(cand) > cap:
                order = np.argsort(qscore[cand], kind="stable")
                X = np.sort(cand[order[:cap]])
            else:
                X = cand
        if X is None:
            if strict_ties:
                x = _vertex_selection(st, in_s)
            else:
                # vectorized seed scan: exact min (rem_deg, v); avoids
                # materializing the shared lazy heap on the fast path
                d = np.where((rem_deg > 0) & (in_s == 0), rem_deg,
                             np.iinfo(np.int64).max)
                x = int(d.argmin())
                if d[x] == np.iinfo(np.int64).max:
                    x = -1
            if x == -1:
                break                      # nothing expandable remains
            X = np.array([x], dtype=np.int64)
            batch_join(X)
            if n_edges >= target:
                in_c[X] = 1
                fr[X] = False
                n_core += 1
                break
        # --- AllocEdges over the whole slice (Alg.3, batched) -------------
        in_c[X] = 1
        fr[X] = False
        n_core += len(X)
        nbs, ess, _, _ = gather_adj(X)
        open_nb = nbs[(epoch[ess] == -1) & (in_s[nbs] == 0)]
        if len(open_nb):
            # first-occurrence dedup keeps the heap engine's join order
            _, first = np.unique(open_nb, return_index=True)
            batch_join(open_nb[np.sort(first)])

    # B ← B ∪ (S \ C); plus core vertices that still have remaining edges
    # (they will replicate into later partitions).
    touched = np.flatnonzero(in_s)
    in_border[touched[in_c[touched] == 0]] = 1
    core = touched[in_c[touched] == 1]
    in_border[core[rem_deg[core] > 0]] = 1
    edge_list = (np.concatenate(chunks).astype(np.int64) if chunks
                 else np.zeros(0, dtype=np.int64))
    if record_order is not None:
        record_order.extend(edge_list.tolist())
    return edge_list


def run_expansion(
    g: Graph,
    deltas: np.ndarray,
    alpha: float = 0.3,
    beta: float = 0.3,
    *,
    memories: np.ndarray | None = None,
    m_node: float = 1.0,
    m_edge: float = 2.0,
    order: str = "asc_capacity",
    state: ExpansionState | None = None,
    engine: str = "heap",
    **engine_kw,
) -> tuple[np.ndarray, list[list[int]]]:
    """Run Algorithm 2 for every machine; returns (assign, per-part order).

    assign[e] = machine id, or -1 if the edge could not be placed under the
    memory guard (callers must repair; WindGP's driver does).
    ``order`` controls the machine visit order; ascending capacity keeps the
    big-capacity machines for last so they absorb the irregular tail.
    ``engine`` picks the expansion implementation (see module docstring).
    """
    p = len(deltas)
    st = state if state is not None else ExpansionState.fresh(g)
    orders: list[list[int]] = [[] for _ in range(p)]
    if order == "asc_capacity":
        visit = np.argsort(np.asarray(deltas), kind="stable")
    elif order == "desc_capacity":
        visit = np.argsort(-np.asarray(deltas), kind="stable")
    else:
        visit = np.arange(p)
    for i in visit:
        lim = None if memories is None else float(memories[i])
        rec: list[int] = []
        expand_partition(
            st, int(i), int(deltas[i]), alpha, beta,
            memory_limit=lim, m_node=m_node, m_edge=m_edge, record_order=rec,
            engine=engine, **engine_kw)
        orders[int(i)] = rec
        if st.unassigned_edges == 0:
            break
    assign = st.epoch.astype(np.int32).copy()
    return assign, orders
