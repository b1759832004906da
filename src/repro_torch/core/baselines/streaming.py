"""Streaming edge partitioners: hash, DBH, PowerGraph-greedy, HDRF, EBV.

All receive the same heterogeneous-memory adaptation the paper applies to
its baselines: a per-machine edge-capacity cap derived from M_i (identical
to the one WindGP's preprocessing uses), with overflow spilling to the
best-scoring machine that still has room.  The hash-family overflow pass
(hash, DBH) runs through the shared incremental layer
(``core/partition_state.py``): overflow edges beyond each machine's cap
are repaired in vectorized greedy waves instead of a per-edge Python scan
over its own bincounts.

The order-sensitive scorers (greedy, HDRF, EBV) run through the
**block-stream engine**: edges are consumed in blocks of ``block_size``
stream positions, each block is scored against *all* machines in one
broadcast (the replication term reads the shared ``(p, V)`` membership
matrix via ``PartitionState.endpoint_presence``; balance terms read its
``edges_per``/``verts_per`` totals), and conflict-free within-block
assignments are admitted in waves:

* only the stream-first edge per endpoint may be admitted in a wave, so
  every admitted edge's replication term is exact w.r.t. the pre-wave
  state (wave-mates are pairwise endpoint-disjoint);
* per machine, wave-mates are admitted in stream order only while the
  capacity cap still fits (``counts + rank < cap``) and within a
  ``ceil(candidates / p)`` spread quota, so the stale balance term cannot
  pile a whole wave onto one machine — refused edges stay pending and are
  rescored next wave against fresh state.

``block_size=1`` degrades to one edge per wave, which reproduces the
per-edge loops decision for decision (identical float arithmetic, same
first-argmax tie-breaks) — those loops survive below as ``*_oracle``, the
test reference rather than the implementation, mirroring the SLS repair
waves' ``strict`` mode.  ``stream_partition`` runs the same engine over an
edge-block iterator with the graph-free ``StreamMembership`` state, for
graphs that never materialize as a single array.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..capacity import _mem_cap
from ..graph import Graph
from ..machines import Cluster
from ..partition_state import (PartitionState, StreamMembership, cumcount)
from ..sls import repair_edges

#: Fallback stream-block size (the public methods use ``auto_block_size``
#: via the per-method ``ENGINE_DEFAULTS``): large enough that per-wave
#: broadcasts amortize the Python dispatch, small enough that stale
#: balance terms self-correct within a fraction of a machine's capacity.
DEFAULT_BLOCK = 1024


def auto_block_size(num_edges: int) -> int:
    """Default block: ~1/48 of the stream, clamped to [256, 8192].

    What degrades block quality is the *fraction* of the stream scored
    against one membership snapshot, not the absolute block size — the
    same 1024-edge block is a 2% slice of the LJ proxy but an 8% slice of
    the CI smoke proxy.  E/48 reproduces the LJ-tuned 1024 at LJ scale
    and shrinks/grows proportionally elsewhere.
    """
    return int(max(256, min(8192, num_edges // 48)))


def _caps(cluster: Cluster, g: Graph) -> np.ndarray:
    return np.floor(_mem_cap(cluster, g.num_vertices, g.num_edges)).astype(np.int64)


def _spill(scores: np.ndarray, counts: np.ndarray, caps: np.ndarray) -> int:
    """Best-scoring machine with room (scores higher = better)."""
    ok = counts < caps
    if not ok.any():
        return int(np.argmin(counts - caps))   # least-overfull fallback
    masked = np.where(ok, scores, -np.inf)
    return int(np.argmax(masked))


def _cap_spill(g: Graph, cluster: Cluster, assign: np.ndarray,
               caps: np.ndarray) -> np.ndarray:
    """Deterministic overflow pass for the hash-family partitioners.

    Each machine keeps its first ``caps[i]`` edges in stream order; the
    overflow is re-placed by the shared vectorized BalancedGreedyRepair
    (memory-aware, TC-accounted) instead of the old per-edge count scan.
    """
    if np.all(np.bincount(assign, minlength=cluster.p) <= caps):
        return assign
    over = cumcount(assign) >= caps[assign]
    assign = assign.copy()
    assign[over] = -1
    obj = PartitionState.build(g, assign, cluster)
    repair_edges(obj, np.flatnonzero(over), [[] for _ in range(cluster.p)])
    return obj.assign


def random_hash(g: Graph, cluster: Cluster, seed: int = 0) -> np.ndarray:
    """f(e) = hash(e) % p with memory spill."""
    p = cluster.p
    h = (g.edges[:, 0].astype(np.uint64) * np.uint64(2654435761)
         ^ g.edges[:, 1].astype(np.uint64) * np.uint64(40503)) % np.uint64(p)
    return _cap_spill(g, cluster, h.astype(np.int32), _caps(cluster, g))


def dbh(g: Graph, cluster: Cluster, seed: int = 0) -> np.ndarray:
    """Degree-Based Hashing [Xie et al. 2014]: hash the low-degree endpoint."""
    p = cluster.p
    deg = g.degree()
    u, v = g.edges[:, 0], g.edges[:, 1]
    low = np.where(deg[u] <= deg[v], u, v).astype(np.uint64)
    assign = ((low * np.uint64(2654435761)) % np.uint64(p)).astype(np.int32)
    return _cap_spill(g, cluster, assign, _caps(cluster, g))


# ---------------------------------------------------------------------------
# per-edge reference loops (the stream-order oracles)
# ---------------------------------------------------------------------------

def powergraph_greedy_oracle(g: Graph, cluster: Cluster,
                             seed: int = 0) -> np.ndarray:
    """PowerGraph's greedy vertex-cut [Gonzalez et al. 2012], per edge.

    Prefer machines holding both endpoints, then either, then least loaded;
    ties broken by load.  Kept as the block engine's bit-exact reference.
    """
    p = cluster.p
    caps = _caps(cluster, g)
    member = np.zeros((p, g.num_vertices), dtype=bool)
    counts = np.zeros(p, dtype=np.int64)
    assign = np.empty(g.num_edges, dtype=np.int32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(g.num_edges)       # stream order
    load_score = lambda: -counts / np.maximum(1, caps)
    for e in order:
        u, v = g.edges[e]
        au, av = member[:, u], member[:, v]
        both, either = au & av, au | av
        base = load_score()
        if both.any():
            scores = np.where(both, base + 4, -np.inf)
        elif either.any():
            scores = np.where(either, base + 2, -np.inf)
        else:
            scores = base
        i = _spill(scores, counts, caps)
        assign[e] = i
        member[i, u] = member[i, v] = True
        counts[i] += 1
    return assign


def hdrf_oracle(g: Graph, cluster: Cluster, seed: int = 0,
                lam: float = 1.0, eps: float = 1.0) -> np.ndarray:
    """High-Degree Replicated First [Petroni et al. 2015], per edge."""
    p = cluster.p
    caps = _caps(cluster, g)
    member = np.zeros((p, g.num_vertices), dtype=bool)
    counts = np.zeros(p, dtype=np.int64)
    pdeg = np.zeros(g.num_vertices, dtype=np.int64)   # partial degrees
    assign = np.empty(g.num_edges, dtype=np.int32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(g.num_edges)
    for e in order:
        u, v = g.edges[e]
        pdeg[u] += 1
        pdeg[v] += 1
        du, dv = pdeg[u], pdeg[v]
        theta_u = du / (du + dv)
        theta_v = 1.0 - theta_u
        g_u = np.where(member[:, u], 1.0 + (1.0 - theta_u), 0.0)
        g_v = np.where(member[:, v], 1.0 + (1.0 - theta_v), 0.0)
        maxs, mins = counts.max(), counts.min()
        c_bal = lam * (maxs - counts) / (eps + maxs - mins)
        i = _spill(g_u + g_v + c_bal, counts, caps)
        assign[e] = i
        member[i, u] = member[i, v] = True
        counts[i] += 1
    return assign


def ebv_oracle(g: Graph, cluster: Cluster, seed: int = 0,
               w_e: float = 1.0, w_v: float = 1.0) -> np.ndarray:
    """Efficient-and-Balanced Vertex-cut [Zhang et al. 2021], per edge.

    Streams edges sorted by end-degree sum ascending; score for machine i:
    I(u∉V_i) + I(v∉V_i) + w_e·p|E_i|/|E| + w_v·p|V_i|/|V|  (minimized).
    """
    p = cluster.p
    caps = _caps(cluster, g)
    member = np.zeros((p, g.num_vertices), dtype=bool)
    counts = np.zeros(p, dtype=np.int64)
    vcounts = np.zeros(p, dtype=np.int64)
    assign = np.empty(g.num_edges, dtype=np.int32)
    deg = g.degree()
    order = np.argsort(deg[g.edges[:, 0]] + deg[g.edges[:, 1]], kind="stable")
    nE, nV = g.num_edges, max(1, g.num_vertices)
    for e in order:
        u, v = g.edges[e]
        rep = (~member[:, u]).astype(np.float64) + (~member[:, v])
        score = rep + w_e * p * counts / nE + w_v * p * vcounts / nV
        i = _spill(-score, counts, caps)
        assign[e] = i
        if not member[i, u]:
            member[i, u] = True
            vcounts[i] += 1
        if not member[i, v]:
            member[i, v] = True
            vcounts[i] += 1
        counts[i] += 1
    return assign


# ---------------------------------------------------------------------------
# block-stream scorers: one (n, p) broadcast per wave, oracle float-for-float
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GreedyScorer:
    """PowerGraph-greedy score, vectorized row-per-edge."""

    name = "greedy"

    def stream_order(self, g: Graph, seed: int) -> np.ndarray:
        return np.random.default_rng(seed).permutation(g.num_edges)

    def block_aux(self, u: np.ndarray, v: np.ndarray) -> np.ndarray | None:
        return None

    def score(self, state, u, v, pres_u, pres_v, aux, caps,
              nE: int, nV: int) -> np.ndarray:
        base = -state.edges_per / np.maximum(1, caps)        # (p,)
        both = pres_u & pres_v
        either = pres_u | pres_v
        s_both = np.where(both, base + 4, -np.inf)
        s_either = np.where(either, base + 2, -np.inf)
        s_base = np.broadcast_to(base, both.shape)
        return np.where(both.any(axis=1)[:, None], s_both,
                        np.where(either.any(axis=1)[:, None],
                                 s_either, s_base))

    def wave_penalty(self, state, caps, nE: int, nV: int) -> np.ndarray:
        return 1.0 / np.maximum(1, caps)

    def fresh_priority(self, state, caps, nE: int, nV: int):
        c = np.maximum(1, caps)
        return state.edges_per / c, 1.0 / c


@dataclasses.dataclass
class HDRFScorer:
    """HDRF score; partial degrees are stream-position facts, so they are
    computed exactly per block (running totals + within-block occurrence
    ranks) regardless of how waves defer placements."""

    lam: float = 1.0
    eps: float = 1.0
    name = "hdrf"

    def __post_init__(self):
        self._pdeg: np.ndarray | None = None

    def reset(self, num_vertices: int) -> None:
        self._pdeg = np.zeros(num_vertices, dtype=np.int64)

    def grow(self, num_vertices: int) -> None:
        """Extend the partial-degree history to a grown vertex space
        (dynamic insert streams) without erasing it — new vertices start
        at degree 0, exactly as if they had been allocated up front."""
        if self._pdeg is None:
            self.reset(num_vertices)
        elif num_vertices > len(self._pdeg):
            self._pdeg = np.concatenate(
                [self._pdeg,
                 np.zeros(num_vertices - len(self._pdeg), dtype=np.int64)])

    def stream_order(self, g: Graph, seed: int) -> np.ndarray:
        return np.random.default_rng(seed).permutation(g.num_edges)

    def block_aux(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        ends = np.empty(2 * len(u), dtype=np.int64)
        ends[0::2] = u
        ends[1::2] = v
        occ = cumcount(ends)
        du = self._pdeg[u] + occ[0::2] + 1
        dv = self._pdeg[v] + occ[1::2] + 1
        np.add.at(self._pdeg, ends, 1)
        return np.stack([du, dv], axis=1)

    def score(self, state, u, v, pres_u, pres_v, aux, caps,
              nE: int, nV: int) -> np.ndarray:
        du, dv = aux[:, 0], aux[:, 1]
        theta_u = du / (du + dv)
        theta_v = 1.0 - theta_u
        g_u = np.where(pres_u, 1.0 + (1.0 - theta_u)[:, None], 0.0)
        g_v = np.where(pres_v, 1.0 + (1.0 - theta_v)[:, None], 0.0)
        counts = state.edges_per
        maxs, mins = counts.max(), counts.min()
        c_bal = self.lam * (maxs - counts) / (self.eps + maxs - mins)
        return g_u + g_v + c_bal[None, :]

    def wave_penalty(self, state, caps, nE: int, nV: int) -> np.ndarray:
        counts = state.edges_per
        spread = self.eps + counts.max() - counts.min()
        return np.full(len(caps), self.lam / spread)

    def fresh_priority(self, state, caps, nE: int, nV: int):
        # c_bal is strictly decreasing in the own count and uniform
        # otherwise, so fresh placement greedily fills the lowest count
        return state.edges_per.copy(), np.ones(len(caps))


@dataclasses.dataclass
class EBVScorer:
    """EBV score (minimized in the oracle; negated here, higher = better)."""

    w_e: float = 1.0
    w_v: float = 1.0
    name = "ebv"

    def stream_order(self, g: Graph, seed: int) -> np.ndarray:
        deg = g.degree()
        return np.argsort(deg[g.edges[:, 0]] + deg[g.edges[:, 1]],
                          kind="stable")

    def block_aux(self, u: np.ndarray, v: np.ndarray) -> np.ndarray | None:
        return None

    def score(self, state, u, v, pres_u, pres_v, aux, caps,
              nE: int, nV: int) -> np.ndarray:
        p = state.p
        rep = (~pres_u).astype(np.float64) + (~pres_v)
        score = (rep + self.w_e * p * state.edges_per / nE
                 + self.w_v * p * state.verts_per / nV)
        return -score

    def wave_penalty(self, state, caps, nE: int, nV: int) -> np.ndarray:
        # each admitted edge adds 1 to |E_i| and at most 2 to |V_i|
        p = state.p
        return np.full(len(caps),
                       self.w_e * p / nE + 2.0 * self.w_v * p / nV)

    def fresh_priority(self, state, caps, nE: int, nV: int):
        p = state.p
        a = (self.w_e * p * state.edges_per / nE
             + self.w_v * p * state.verts_per / nV)
        b = np.full(len(caps), self.w_e * p / nE + 2.0 * self.w_v * p / nV)
        return a, b


#: scorer factories by method name (the ``blocked`` capability surface)
SCORERS = {
    "greedy": GreedyScorer,
    "hdrf": HDRFScorer,
    "ebv": EBVScorer,
}


# ---------------------------------------------------------------------------
# the block-stream engine
# ---------------------------------------------------------------------------

class _BlockEngine:
    """Wave admission over a stream-ordered pending buffer with carry.

    ``push`` appends one block (auxiliary stream facts — HDRF's partial
    degrees — are stamped at arrival, so deferral never changes them) and
    runs at most ``max_waves`` admission waves; unadmitted rows *carry*
    into the next block's pending, where they ride along with its full
    waves instead of draining through many tiny straggler waves — and see
    membership several blocks ahead, which is what the replica throttle
    needs.  ``flush`` drains to empty at stream end.  Rows keep stream
    order throughout, so the leader/quota logic stays order-faithful.

    Admission is the sum of three guards (the scalar oracles reduce to
    the quota path at one row per wave):

    * fresh edges → exact water-fill of the scorer's linear balance score;
    * membership-tiered edges → per-machine rank quota anchored to the
      block size, with a rank-*stability* override (the batched form of
      the oracle's continuous balance steering) and a replica throttle
      (creations wait a wave to see the membership just built);
    * per-machine capacity prefix (each wave-mate adds exactly one edge).
    """

    def __init__(self, state, scorer, caps, nE, nV, *,
                 block_size: int = 4096, max_waves: int = 3,
                 replica_frac: float = 0.5, creator_scalar: bool = False,
                 sink=None):
        self.state, self.scorer, self.caps = state, scorer, caps
        self.nE, self.nV, self.max_waves, self.sink = nE, nV, max_waves, sink
        self.block_size = max(1, int(block_size))
        self.replica_frac = replica_frac
        self.creator_scalar = creator_scalar
        self.u = np.empty(0, dtype=np.int64)
        self.v = np.empty(0, dtype=np.int64)
        self.eids: np.ndarray | None = None
        self.aux: np.ndarray | None = None
        self._scratch = np.full(max(1, nV), -1, dtype=np.int64)

    def push(self, u, v, eids=None, aux=None) -> None:
        # aux may arrive precomputed (the parallel pipeline stamps stream
        # facts centrally, in arrival order, before shipping units out)
        if aux is None:
            aux = self.scorer.block_aux(u, v)
        self.u = np.concatenate([self.u, u])
        self.v = np.concatenate([self.v, v])
        if eids is not None:
            self.eids = (eids if self.eids is None
                         else np.concatenate([self.eids, eids]))
        if aux is not None:
            self.aux = (aux if self.aux is None
                        else np.concatenate([self.aux, aux]))
        self._drain(self.max_waves)

    def flush(self) -> None:
        self._drain(None)

    def _emit(self, sel, ms, verts_delta=None) -> None:
        e = None if self.eids is None else self.eids[sel]
        self.state.admit_block(self.u[sel], self.v[sel], e, ms,
                               verts_delta=verts_delta)
        if self.sink is not None:
            self.sink(np.stack([self.u[sel], self.v[sel]], axis=1), ms)

    def _shrink(self, taken: np.ndarray) -> None:
        keep = np.ones(len(self.u), dtype=bool)
        keep[taken] = False
        self.u, self.v = self.u[keep], self.v[keep]
        if self.eids is not None:
            self.eids = self.eids[keep]
        if self.aux is not None:
            self.aux = self.aux[keep]

    def _drain(self, max_waves: int | None) -> None:
        waves = 0
        while len(self.u) and (max_waves is None or waves < max_waves):
            waves += 1
            if not self._wave():
                break

    def _wave(self) -> bool:
        """One admission wave; returns False on the overflow fallback."""
        state, scorer, caps = self.state, self.scorer, self.caps
        nE, nV = self.nE, self.nV
        u, v = self.u, self.v
        n = len(u)
        p = state.p
        pres_u, pres_v = state.endpoint_presence(u, v)
        scores = scorer.score(state, u, v, pres_u, pres_v,
                              self.aux, caps, nE, nV)
        counts = state.edges_per
        ok = counts < caps
        if not ok.any():
            # Global overflow (least-overfull fallback): the argmin moves
            # with every placement, so drain scalar — the oracle's path.
            for j in range(n):
                i = np.argmin(state.edges_per - caps)
                self._emit(np.array([j]), np.array([i], dtype=np.int64))
            self._shrink(np.arange(n))
            return False
        masked = np.where(ok[None, :], scores, -np.inf)
        best = np.argmax(masked, axis=1)         # first-max = scalar _spill
        # (1) endpoint leaders: the stream-first toucher of each vertex
        # this wave, found by a reversed scatter-write (first write wins
        # after reversal; stale scratch entries are never read because
        # every slot is written before it is read).  An edge may join the
        # wave iff each endpoint is steered to the same machine as that
        # endpoint's leader — same-machine followers only reinforce the
        # membership their leader creates, so hub edges co-admit in one
        # wave; disagreeing edges defer and are rescored against fresh
        # state.
        ends = np.empty(2 * n, dtype=np.int64)
        ends[0::2] = u
        ends[1::2] = v
        idx = np.arange(2 * n)
        self._scratch[ends[::-1]] = idx[::-1]
        lead_slot = self._scratch[ends]
        is_first = lead_slot == idx
        stream_first = is_first[0::2] & is_first[1::2]
        any_u = pres_u.any(axis=1)
        any_v = pres_v.any(axis=1)
        fresh = ~(any_u | any_v)
        # (2a) *fresh* edges — no endpoint present anywhere, so their score
        # rows are identical and stale argmax would pile a whole wave onto
        # one machine.  Their balance score is linear in the own-machine
        # count (a_i + b_i·t), so the oracle's repeated-argmax placement
        # sequence is exactly the ascending merge of the per-machine
        # priority ladders — water-fill them in one argsort, capped by
        # each machine's remaining room.  Only stream-first fresh edges
        # join (followers defer one wave and return membership-tiered).
        fcand = np.flatnonzero(fresh & stream_first)
        falloc = np.zeros(p, dtype=np.int64)
        take_parts = []
        m_parts = []
        lead_m = best.copy()                    # leaders' *actual* machines
        if len(fcand) > 1:
            a, b = scorer.fresh_priority(state, caps, nE, nV)
            k = len(fcand)
            room = np.where(ok, caps - counts.astype(np.int64), 0)
            t = np.arange(min(k, int(room.max())), dtype=np.float64)
            ladder = a[:, None] + b[:, None] * t[None, :]
            ladder[t[None, :] >= room[:, None]] = np.inf
            flat = np.argsort(ladder, axis=None, kind="stable")[:k]
            seq = (flat // len(t)).astype(np.int64)
            seq = seq[np.isfinite(ladder.ravel()[flat])]
            fc = fcand[:len(seq)]        # room-limited leftovers defer
            falloc = np.bincount(seq, minlength=p)
            take_parts.append(fc)
            m_parts.append(seq)
            lead_m[fc] = seq
            nfmask = ~fresh
        else:
            nfmask = ~fresh | stream_first
        # follower agreement checks the machine its endpoint leader was
        # actually sent to (water-filled fresh leaders included)
        first_m = lead_m[lead_slot // 2]
        nfmask &= (first_m[0::2] == best) & (first_m[1::2] == best)
        # (2b) membership-tiered edges: cap + balance guard per machine in
        # stream order.  Each earlier wave-mate (fresh water-fill included)
        # adds exactly one edge (cap check).  The per-machine rank quota is
        # anchored to the *block size*, not the pending size, so carried
        # stragglers never coarsen admission.  Beyond the quota an edge
        # needs rank-*stability*: after charging the scorer's per-edge
        # balance penalty for every earlier wave-mate on its machine, its
        # score must still beat the row's second-best allowed machine.
        # Replica-*creating* placements (an endpoint present elsewhere but
        # not on the chosen machine) additionally respect the quota as a
        # global rate limit: deferring the rest one wave lets them see the
        # membership the admitted edges just built — the oracle's
        # continuously-discovered co-location at wave granularity.
        cand = np.flatnonzero(nfmask)
        scalar_rows = np.empty(0, dtype=np.int64)
        if len(cand):
            m = best[cand]
            creating = ((any_u[cand] & ~pres_u[cand, m])
                        | (any_v[cand] & ~pres_v[cand, m]))
            if self.creator_scalar:
                # hub_split idiom: the replica-*creating* minority (the
                # placements the binary-presence scorers are staleness-
                # sensitive to) drains through the exact per-edge path
                # after the wave; the non-creating majority stays
                # vectorized.  No throttle needed — creators see fully
                # fresh membership.
                scalar_rows = cand[creating]
                cand = cand[~creating]
                m = best[cand]
                creating = np.zeros(len(cand), dtype=bool)
            r = cumcount(m) + falloc[m]
            quota = max(1, -(-min(len(cand), self.block_size) // p))
            rc = np.zeros(len(cand), dtype=np.int64)
            rc[creating] = np.arange(int(creating.sum()))
            rc_quota = max(1, int(self.replica_frac * quota))
            in_quota = ((r - falloc[m] < quota)
                        & (~creating | (rc < rc_quota)))
            capok = counts[m] + r < caps[m]
            keep_c = capok & in_quota
            # stability override — non-fresh, non-creating rows only,
            # computed lazily on the rows that actually need it
            over = capok & ~in_quota & ~fresh[cand] & ~creating
            if over.any() and p >= 2:
                pen = scorer.wave_penalty(state, caps, nE, nV)
                second = np.partition(masked[cand[over]], -2, axis=1)[:, -2]
                stable = (masked[cand[over], m[over]]
                          - r[over] * pen[m[over]] >= second)
                keep_c[over] = stable
            take_parts.append(cand[keep_c])
            m_parts.append(m[keep_c])
        take = np.concatenate(take_parts) if take_parts else \
            np.empty(0, dtype=np.int64)
        ms = np.concatenate(m_parts) if m_parts else \
            np.empty(0, dtype=np.int64)
        ms = ms.astype(np.int64)
        # progress: the globally stream-first pending edge is either a
        # fresh leader (water-fill places it first) or its own endpoint
        # leader at rank 0 with a machine ``best`` knows has room — every
        # wave admits at least one edge.
        # exact |V_i| delta from admitted-set leader bits: all admitted
        # touchers of a vertex share a machine, so the 0→1 cell events are
        # exactly the admitted leaders landing where their endpoint is absent
        et = np.empty(2 * len(take), dtype=np.int64)
        et[0::2] = u[take]
        et[1::2] = v[take]
        it = np.arange(2 * len(take))
        self._scratch[et[::-1]] = it[::-1]
        lead_t = self._scratch[et] == it
        new_u = lead_t[0::2] & ~pres_u[take, ms]
        new_v = lead_t[1::2] & ~pres_v[take, ms]
        dv = (np.bincount(ms[new_u], minlength=p)
              + np.bincount(ms[new_v], minlength=p)).astype(np.float64)
        self._emit(take, ms, verts_delta=dv)
        if len(scalar_rows):
            self._scalar_drain(scalar_rows)
            take = np.concatenate([take, scalar_rows])
        self._shrink(take)
        return True

    def _scalar_drain(self, rows: np.ndarray) -> None:
        """Exact per-edge placement for replica-creating rows.

        Each row rescores against fully fresh state and places through the
        oracle's decision rule (first-argmax over machines with room, else
        least-overfull), so a wave's creating placements are decision-
        identical to the per-edge loop run at this point in the stream —
        the vectorized majority pays none of that cost.  State mutation
        goes through the one-edge light path (``admit_single``); the sink
        sees the drained rows as one batch at the end, in placement order.
        """
        state, scorer, caps = self.state, self.scorer, self.caps
        cnt, eper = state.cnt, state.edges_per
        ms = np.empty(len(rows), dtype=np.int64)
        for t, j in enumerate(rows):
            uj, vj = self.u[j], self.v[j]
            pu, pv = cnt[:, uj] > 0, cnt[:, vj] > 0
            aux = None if self.aux is None else self.aux[j:j + 1]
            sc = scorer.score(state, self.u[j:j + 1], self.v[j:j + 1],
                              pu[None], pv[None], aux, caps,
                              self.nE, self.nV)[0]
            ok = eper < caps
            if ok.any():
                i = int(np.argmax(np.where(ok, sc, -np.inf)))
            else:
                i = int(np.argmin(eper - caps))
            dv = float(~pu[i]) + float((uj != vj) & ~pv[i])
            state.admit_single(uj, vj,
                               None if self.eids is None else self.eids[j],
                               i, dv)
            ms[t] = i
        if self.sink is not None:
            self.sink(np.stack([self.u[rows], self.v[rows]], axis=1), ms)


def block_stream_assign(g: Graph, cluster: Cluster, scorer, *,
                        block_size: int = DEFAULT_BLOCK, seed: int = 0,
                        order: np.ndarray | None = None,
                        max_waves: int = 3,
                        replica_frac: float = 0.5,
                        creator_scalar: bool = False) -> np.ndarray:
    """Run a block-stream scorer over an in-memory graph.

    The shared ``(p, V)`` membership matrix and per-machine totals live in
    ``PartitionState`` (built all-unassigned), so the engine's accounting is
    the same layer expansion/SLS/overflow already use; ``order`` overrides
    the scorer's stream order (tests use this to cross-check the graph-free
    path).  ``block_size=1`` reproduces the ``*_oracle`` loops bit for bit.
    """
    state = PartitionState.build(
        g, np.full(g.num_edges, -1, dtype=np.int32), cluster)
    caps = _caps(cluster, g)
    if order is None:
        order = scorer.stream_order(g, seed)
    if hasattr(scorer, "reset"):
        scorer.reset(g.num_vertices)
    B = max(1, int(block_size))
    eu = g.edges[:, 0].astype(np.int64)
    ev = g.edges[:, 1].astype(np.int64)
    eng = _BlockEngine(state, scorer, caps, g.num_edges,
                       max(1, g.num_vertices), block_size=B,
                       max_waves=max_waves, replica_frac=replica_frac,
                       creator_scalar=creator_scalar)
    for lo in range(0, len(order), B):
        blk = order[lo:lo + B]
        eng.push(eu[blk], ev[blk], blk)
    eng.flush()
    return state.assign


def _resolve_stream_source(source, num_vertices, num_edges, *,
                           dedup: str, spill_dir, bucket_rows, io_block):
    """Normalize ``stream_partition``'s edge source to (blocks, |V|, |E|).

    ``source`` may be a block iterable (the historical contract), an
    edge-list path, or a prepared :class:`repro_torch.data.TwoPassDedup`.  With
    ``dedup="two_pass"`` a path is spilled/deduplicated out of core first
    (exact counts come back from the spill accounting); with
    ``dedup="block"`` a path streams through ``iter_edge_blocks`` with
    per-block dedup only, counting once when counts were not supplied.
    Returns ``(blocks, num_vertices, num_edges, spill, owned)`` — ``spill``
    is the TwoPassDedup in play (for its accounting), ``owned`` marks that
    it was created here and must be closed at stream end.
    """
    import os
    from ...data import io as _io
    if dedup not in ("block", "two_pass"):
        raise ValueError(f"dedup must be 'block' or 'two_pass', got {dedup!r}")
    if isinstance(source, _io.TwoPassDedup):
        nv, ne = source.prepare()
        return source, nv, ne, source, False
    if isinstance(source, (str, os.PathLike)):
        if dedup == "two_pass":
            tp = _io.TwoPassDedup(source, spill_dir,
                                  bucket_rows=bucket_rows)
            nv, ne = tp.prepare()
            return tp, nv, ne, tp, True
        io_block = io_block or _io.DEFAULT_BLOCK_LINES
        if num_vertices is None or num_edges is None:
            num_vertices, num_edges = _io.count_edge_list(source, io_block)
        return _io.iter_edge_blocks(source, io_block), \
            num_vertices, num_edges, None, False
    if dedup == "two_pass":
        raise ValueError(
            "dedup='two_pass' needs a re-readable edge-list path (or a "
            "prepared TwoPassDedup), not an exhaustible block iterator")
    if num_vertices is None or num_edges is None:
        raise ValueError("block iterables need explicit num_vertices/"
                         "num_edges (use a path to let the stream count)")
    return source, num_vertices, num_edges, None, False


def stream_partition(source, num_vertices: int | None = None,
                     num_edges: int | None = None,
                     cluster: Cluster = None, method: str = "hdrf", *,
                     dedup: str = "block", spill_dir: str | None = None,
                     bucket_rows: int = 1 << 16,
                     block_size: int | None = None,
                     max_waves: int | None = None,
                     replica_frac: float | None = None,
                     creator_scalar: bool | None = None, sink=None,
                     workers: int = 1, sync_blocks: int | None = None,
                     **scorer_kw) -> StreamMembership:
    """Partition an edge stream that never materializes as one array.

    ``source`` yields (B, 2) int arrays (``data/io.iter_edge_blocks``), or
    is an edge-list path, or a prepared ``TwoPassDedup``; stream order is
    arrival order (EBV's degree sort is not available without a sort pass
    — documented deviation).  ``num_vertices`` and ``num_edges`` come from
    a counting pass (both are needed for the memory caps; EBV also
    normalizes by them) and may be ``None`` when ``source`` can count
    itself (a path or a TwoPassDedup).

    ``dedup`` picks the cross-block duplicate discipline: ``"block"`` (the
    single-pass mode — within-block dedup only, duplicates that span
    blocks are partitioned twice) or ``"two_pass"`` (exact global dedup
    via bounded spill buckets on disk; the engine then sees every edge
    exactly once, in first-occurrence order, so its decisions are
    comparable to the in-memory path on the deduplicated graph).

    Each incoming block is re-chunked to ``block_size`` and pushed through
    the same wave engine as the in-memory path, over the graph-free
    ``StreamMembership`` state; ``sink(edges, ms)`` receives ``((k, 2)
    endpoints, (k,) machines)`` slices as placements finalize —
    admission-wave order, not arrival order, since deferred edges carry
    across blocks.  Returns the end-of-stream membership state (RF,
    counts); after a two-pass run its ``spill_stats`` attribute carries
    the :class:`repro_torch.data.SpillStats` accounting.

    ``workers > 1`` hands the whole call to the multi-process pipeline
    (``core/parallel.py``): sharded spill/dedup plus W-worker wave
    scoring against membership snapshots synced every ``sync_blocks``
    engine blocks.  Results are worker-count invariant (the schedule
    depends only on ``sync_blocks``), and ``sync_blocks=1`` is
    bit-identical to this sequential path; ``sync_blocks`` is ignored at
    ``workers=1``, where every wave sees fresh state.
    """
    if workers is not None and int(workers) > 1:
        from ..parallel import parallel_stream_partition
        return parallel_stream_partition(
            source, num_vertices, num_edges, cluster, method,
            workers=int(workers), sync_blocks=sync_blocks, dedup=dedup,
            spill_dir=spill_dir, bucket_rows=bucket_rows,
            block_size=block_size, max_waves=max_waves,
            replica_frac=replica_frac, creator_scalar=creator_scalar,
            sink=sink, **scorer_kw)
    blocks, num_vertices, num_edges, spill, owned = _resolve_stream_source(
        source, num_vertices, num_edges, dedup=dedup, spill_dir=spill_dir,
        bucket_rows=bucket_rows, io_block=block_size)
    scorer = SCORERS[method](**scorer_kw)
    if hasattr(scorer, "reset"):
        scorer.reset(num_vertices)
    state = StreamMembership.empty(num_vertices, cluster.p)
    caps = np.floor(_mem_cap(cluster, num_vertices,
                             num_edges)).astype(np.int64)
    dflt = ENGINE_DEFAULTS[method]
    if block_size is None:
        block_size = dflt["block_size"] or auto_block_size(num_edges)
    B = max(1, int(block_size))
    eng = _BlockEngine(
        state, scorer, caps, num_edges, max(1, num_vertices), block_size=B,
        max_waves=dflt["max_waves"] if max_waves is None else max_waves,
        replica_frac=(dflt["replica_frac"] if replica_frac is None
                      else replica_frac),
        creator_scalar=(dflt["creator_scalar"] if creator_scalar is None
                        else creator_scalar), sink=sink)
    try:
        # re-chunk the source to exact engine-block boundaries: the wave
        # engine's admission quotas key off its block size, so decisions
        # must not depend on how the *source* happened to chunk the stream
        # (spill-merge emit sizes, reader line blocks, ...)
        pend: list = []
        npend = 0
        for edges in blocks:
            edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
            if not len(edges):
                continue
            pend.append(edges)
            npend += len(edges)
            if npend < B:
                continue
            buf = np.concatenate(pend) if len(pend) > 1 else pend[0]
            lo = 0
            while lo + B <= len(buf):
                eng.push(buf[lo:lo + B, 0].copy(), buf[lo:lo + B, 1].copy())
                lo += B
            pend = [buf[lo:]] if lo < len(buf) else []
            npend = len(buf) - lo
        if npend:
            buf = np.concatenate(pend) if len(pend) > 1 else pend[0]
            eng.push(buf[:, 0].copy(), buf[:, 1].copy())
        eng.flush()
    finally:
        if owned:
            spill.close()
    if spill is not None:
        state.spill_stats = spill.stats
    return state


#: Per-method engine defaults, picked from the LJ-proxy grid
#: (benchmarks/partition_time.run_streaming_compare): block size, waves
#: per block before stragglers carry, the replica-throttle fraction, and
#: whether replica-*creating* placements drain through the exact scalar
#: path.  EBV's binary-presence score is the staleness-sensitive one —
#: it sequentializes exactly the creating minority (``creator_scalar``,
#: the hub_split idiom) and keeps the non-creating ~85% vectorized, which
#: replaces the old full-drain + hard-throttle compromise.
ENGINE_DEFAULTS = {
    "greedy": dict(block_size=None, max_waves=6, replica_frac=0.5,
                   creator_scalar=False),
    "hdrf": dict(block_size=None, max_waves=3, replica_frac=1.0,
                 creator_scalar=False),
    "ebv": dict(block_size=None, max_waves=3, replica_frac=0.25,
                creator_scalar=True),
}


def _block_method(name, key, scorer_cls):
    dflt = ENGINE_DEFAULTS[key]

    def run(g: Graph, cluster: Cluster, seed: int = 0,
            block_size: int | None = None, max_waves: int | None = None,
            replica_frac: float | None = None,
            creator_scalar: bool | None = None, **scorer_kw) -> np.ndarray:
        if block_size is None:
            block_size = (dflt["block_size"]
                          or auto_block_size(g.num_edges))
        return block_stream_assign(
            g, cluster, scorer_cls(**scorer_kw), seed=seed,
            block_size=block_size,
            max_waves=dflt["max_waves"] if max_waves is None else max_waves,
            replica_frac=(dflt["replica_frac"] if replica_frac is None
                          else replica_frac),
            creator_scalar=(dflt["creator_scalar"] if creator_scalar is None
                            else creator_scalar))
    run.__name__ = name
    run.__doc__ = (f"Block-stream {name} (see module docstring); "
                   f"``block_size=1`` bit-reproduces ``{name}_oracle``.")
    return run


powergraph_greedy = _block_method("powergraph_greedy", "greedy", GreedyScorer)
hdrf = _block_method("hdrf", "hdrf", HDRFScorer)
ebv = _block_method("ebv", "ebv", EBVScorer)


# ---------------------------------------------------------------------------
# registry entries
# ---------------------------------------------------------------------------

from ..partitioners import Partitioner, register  # noqa: E402

register(Partitioner(
    "hash", random_hash, "streaming",
    "random edge hash + memory spill", frozenset(), ("seed",)))
register(Partitioner(
    "dbh", dbh, "streaming",
    "degree-based hashing [Xie et al. 2014]", frozenset(), ("seed",)))
_ENGINE_KNOBS = ("seed", "block_size", "max_waves", "replica_frac",
                 "creator_scalar")
#: knobs of the graph-free ``stream`` entry (``Partitioner.stream``):
#: engine knobs minus ``seed`` (stream order is arrival order), plus the
#: dedup discipline, spill controls, the placement sink, and the
#: multi-process pipeline's worker count / sync period (the ``parallel``
#: capability).
_STREAM_KNOBS = ("block_size", "max_waves", "replica_frac",
                 "creator_scalar", "dedup", "spill_dir", "bucket_rows",
                 "sink", "workers", "sync_blocks")


def _stream_entry(key):
    def run(source, num_vertices=None, num_edges=None, cluster=None,
            **kw) -> StreamMembership:
        return stream_partition(source, num_vertices, num_edges, cluster,
                                method=key, **kw)
    run.__name__ = f"stream_{key}"
    return run


register(Partitioner(
    "greedy", powergraph_greedy, "streaming",
    "PowerGraph greedy vertex-cut, block-stream engine",
    frozenset({"blocked", "streamable", "parallel"}), _ENGINE_KNOBS,
    stream_fn=_stream_entry("greedy"), stream_knobs=_STREAM_KNOBS))
register(Partitioner(
    "hdrf", hdrf, "streaming",
    "HDRF [Petroni et al. 2015], block-stream engine",
    frozenset({"blocked", "streamable", "parallel"}),
    _ENGINE_KNOBS + ("lam", "eps"),
    stream_fn=_stream_entry("hdrf"),
    stream_knobs=_STREAM_KNOBS + ("lam", "eps")))
register(Partitioner(
    "ebv", ebv, "streaming",
    "EBV [Zhang et al. 2021], block-stream engine",
    frozenset({"blocked", "streamable", "parallel"}),
    _ENGINE_KNOBS + ("w_e", "w_v"),
    stream_fn=_stream_entry("ebv"),
    stream_knobs=_STREAM_KNOBS + ("w_e", "w_v")))
register(Partitioner(
    "greedy_oracle", powergraph_greedy_oracle, "streaming",
    "per-edge PowerGraph greedy (block-engine test reference)",
    frozenset({"oracle"}), ("seed",)))
register(Partitioner(
    "hdrf_oracle", hdrf_oracle, "streaming",
    "per-edge HDRF (block-engine test reference)",
    frozenset({"oracle"}), ("seed", "lam", "eps")))
register(Partitioner(
    "ebv_oracle", ebv_oracle, "streaming",
    "per-edge EBV (block-engine test reference)",
    frozenset({"oracle"}), ("seed", "w_e", "w_v")))
