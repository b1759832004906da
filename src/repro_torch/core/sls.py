"""Post-processing: Subgraph-Local Search (paper Algorithms 4-7).

Two operators over the current edge assignment:

* **destroy-and-repair** (Alg. 5): machines with T_i above the γ-quantile
  threshold lose a θ-fraction of their edges (last-in-first-out, preserving
  connectivity of what stays), which are re-inserted by
  BalancedGreedyRepair (Alg. 6) preferring machines already holding both
  endpoints, then either endpoint, then anybody — always the feasible
  machine with the lowest resulting T.
* **re-partition** (Alg. 7): on N0 consecutive non-improvements, the worst
  machine and its k-1 largest-replica-overlap peers are merged and re-expanded
  with Algorithm 2 to escape local optima.

All objective updates run through the shared incremental layer
(``core/partition_state.py``).  The repair sweep is *vectorized*: every
removed edge is scored against every machine in one broadcast
(``delta_t_batch``) and repairs are admitted in waves — the best-scoring
fraction of the pending edges per wave, with a conservative per-machine
memory prefix so caps are never violated — mirroring the batched expansion
engine's score-window admission.  State updates per wave are exact
(wave-local recount); only the *scores* of not-yet-admitted edges go stale
within a wave, which is the same deliberate approximation the batched
engine makes.  ``strict=True`` degrades to one edge per wave in removal
order, which reproduces the scalar oracle decision-for-decision (integer
cost arithmetic makes both paths bit-exact) — the equivalence tests rely
on this, like the expansion engine's ``strict_ties``.
"""
from __future__ import annotations

import numpy as np

from . import expand
from .graph import Graph, from_edge_list
from .machines import Cluster
from .partition_state import PartitionState, cumcount

#: Backwards-compatible name: the accounting that used to live here.
IncrementalTC = PartitionState


def balanced_greedy_repair(obj: PartitionState, e: int, cands) -> int:
    """Algorithm 6: feasible candidate with the lowest resulting T, or -1."""
    best, best_t = -1, np.inf
    mem = obj.mem_limits
    for i in cands:
        i = int(i)
        if obj.mem_after(e, i) > mem[i] + 1e-9:
            continue
        t = obj.delta_t_if_added(e, i)
        if t < best_t:
            best, best_t = i, t
    return best


def _repair_edge_scalar(obj: PartitionState, e: int,
                        orders: list[list[int]]) -> int:
    """One edge through the Alg. 5 L11-20 cascade (the scalar oracle)."""
    u, v = obj.g.edges[e]
    a_u = np.flatnonzero(obj.cnt[:, u] > 0)
    a_v = np.flatnonzero(obj.cnt[:, v] > 0)
    both = np.intersect1d(a_u, a_v)
    either = np.union1d(a_u, a_v)
    i = -1
    if len(both):
        i = balanced_greedy_repair(obj, e, both)
    if i < 0 and len(either):
        i = balanced_greedy_repair(obj, e, either)
    if i < 0:
        i = balanced_greedy_repair(obj, e, range(obj.cluster.p))
    if i < 0:
        # No memory anywhere (should not happen when input feasible):
        # force the machine with most free memory.
        free = obj.cluster.memory() - obj.mem_used_all()
        i = int(np.argmax(free))
    obj.add_edge(e, int(i))
    orders[int(i)].append(int(e))
    return int(i)


def _choose_machines(obj: PartitionState, es: np.ndarray):
    """Vectorized Alg. 6 cascade for every pending edge at once.

    Returns (best_m, best_t, best_mem, ok): per-edge chosen machine, its
    resulting T, its exact post-add footprint, and whether any feasible
    machine existed (rows with ok=False need the force-place fallback).
    """
    T, memA, free_u, free_v = obj.placement_scores(es)   # all (n, p)
    feas = memA <= obj.mem_limits[None, :] + 1e-9
    share_u, share_v = ~free_u, ~free_v
    allowed = feas & share_u & share_v              # tier 1: both endpoints
    need = ~allowed.any(axis=1)
    if need.any():                                  # tier 2: either endpoint
        allowed[need] = feas[need] & (share_u[need] | share_v[need])
        need = ~allowed.any(axis=1)
        if need.any():                              # tier 3: anybody feasible
            allowed[need] = feas[need]
    ok = allowed.any(axis=1)
    masked = np.where(allowed, T, np.inf)
    best_m = np.argmin(masked, axis=1)              # first-min = lowest id,
    rows = np.arange(len(es))                       # same as the scalar scan
    return best_m, masked[rows, best_m], memA[rows, best_m], ok


def repair_edges(obj: PartitionState, es: np.ndarray,
                 orders: list[list[int]], *,
                 strict: bool = False, wave_frac: float = 0.75,
                 wave_window: float | None = None) -> None:
    """BalancedGreedyRepair over an edge set, in vectorized waves.

    Each wave scores all pending edges × machines in one broadcast, then
    admits the best-scoring ``wave_frac`` of them.  ``wave_window`` (in
    (0, 1]) optionally tightens that to edges within the given fraction of
    the selected wave's score spread above its best — a *relative* window,
    so one setting transfers across graphs and cost scales.  Per machine,
    wave-mates are admitted in score order only while a *conservative*
    footprint bound (each earlier mate adds ≤ 1 edge + 2 vertices) still
    fits — refused edges simply stay pending for the next wave, where
    their scores are fresh; the wave's best edge always passes (exact
    check), so every wave makes progress.  ``strict=True``: one edge per
    wave in input order — the scalar oracle.
    """
    pending = np.asarray(es, dtype=np.int64)
    if strict:
        for e in pending.tolist():
            _repair_edge_scalar(obj, e, orders)
        return
    m_node, m_edge = obj.cluster.m_node, obj.cluster.m_edge
    mem = obj.mem_limits
    while len(pending):
        best_m, best_t, best_mem, ok = _choose_machines(obj, pending)
        if not ok.all():
            # nothing feasible for these rows: force-place (rare), then
            # rescore — the forced adds invalidate this wave's T/footprints
            for e in pending[~ok].tolist():
                free = mem - obj.mem_used_all()
                i = int(np.argmax(free))
                obj.add_edge(e, i)
                orders[i].append(int(e))
            pending = pending[ok]
            continue
        order = np.argsort(best_t, kind="stable")
        sel = order[:max(1, int(np.ceil(wave_frac * len(pending))))]
        if wave_window is not None and len(sel) > 1:
            spread = best_t[sel[-1]] - best_t[sel[0]]
            sel = sel[best_t[sel] <= best_t[sel[0]] + wave_window * spread]
        rank = cumcount(best_m[sel])
        fits = (best_mem[sel] + rank * (2.0 * m_node + m_edge)
                <= mem[best_m[sel]] + 1e-9)
        adm = sel[fits]
        adm_e, adm_m = pending[adm], best_m[adm]
        obj.add_edges(adm_e, adm_m)
        for i in np.unique(adm_m):
            orders[int(i)].extend(adm_e[adm_m == i].tolist())
        keep = np.ones(len(pending), dtype=bool)
        keep[adm] = False
        pending = pending[keep]


def destroy_repair(obj: PartitionState, orders: list[list[int]],
                   gamma: float, theta: float,
                   rng: np.random.Generator | None = None, *,
                   strict: bool = False, wave_frac: float = 0.75,
                   wave_window: float | None = None) -> bool:
    """Algorithm 5. Returns True iff TC strictly improved.

    The destroy phase is unchanged (LIFO stacks per overloaded machine);
    the repair phase runs through ``repair_edges`` — vectorized waves by
    default, the scalar oracle under ``strict=True``.
    """
    tc_before = obj.tc
    t = obj.t_total
    thd = t.min() + gamma * (t.max() - t.min())
    removed: list[int] = []
    seen: set[int] = set()             # an edge can sit twice in one stack
    for i in range(obj.cluster.p):
        if t[i] < thd - 1e-12 or obj.edges_per[i] == 0:
            continue
        k = max(1, int(np.ceil(theta * obj.edges_per[i])))
        stack = orders[i]
        # LIFO removal preserves the connectivity of the kept prefix.
        take = []
        while stack and len(take) < k:
            e = stack.pop()
            if obj.assign[e] == i and e not in seen:  # may have moved
                take.append(e)
                seen.add(e)
        removed.extend(take)
    removed_arr = np.asarray(removed, dtype=np.int64)
    obj.remove_edges(removed_arr)
    # Repair, endpoint-sharing machines first (Alg. 5 L11-20).
    repair_edges(obj, removed_arr, orders,
                 strict=strict, wave_frac=wave_frac, wave_window=wave_window)
    return obj.tc < tc_before - 1e-9


def repartition(obj: PartitionState, orders: list[list[int]],
                deltas: np.ndarray, k: int,
                alpha: float, beta: float,
                engine: str = "heap", strict: bool = False,
                **engine_kw) -> PartitionState:
    """Algorithm 7: re-run expansion over the worst machine + k-1 peers.

    ``engine`` selects the expansion implementation (heap oracle or the
    batched bucket-queue engine) — the same switch as ``run_expansion``;
    ``engine_kw`` passes batched-engine knobs through unchanged.
    """
    p = obj.cluster.p
    i = int(np.argmax(obj.t_total))
    # n_{i,j}: replica-node overlap with machine i.
    mi = obj.cnt[i] > 0
    n_ij = (obj.cnt > 0)[:, mi].sum(axis=1)
    n_ij[i] = -1
    k = min(k, p)
    peers = np.argsort(-n_ij, kind="stable")[:max(0, k - 1)]
    sel = sorted(set([i] + [int(j) for j in peers]))
    edge_pool = np.flatnonzero(np.isin(obj.assign, sel))
    if len(edge_pool) == 0:
        return obj
    # Expand the union with each member's capacity, on the union subgraph.
    sub = from_edge_list(obj.g.edges[edge_pool], num_vertices=obj.g.num_vertices)
    # Map: sub edge ids -> global edge ids (from_edge_list sorts by (u,v) key).
    u, v = obj.g.edges[edge_pool, 0], obj.g.edges[edge_pool, 1]
    order_key = np.argsort(
        u.astype(np.int64) * obj.g.num_vertices + v.astype(np.int64))
    sub_to_global = edge_pool[order_key]
    st = expand.ExpansionState.fresh(sub)
    # Seed the border set with vertices replicated on *unselected* machines.
    outside = np.ones(p, dtype=bool)
    outside[sel] = False
    st.in_border[:] = ((obj.cnt[outside] > 0).any(axis=0)).astype(np.uint8)
    assign = obj.assign.copy()
    new_orders = [list(o) for o in orders]
    mem = obj.cluster.memory()
    for j in sorted(sel, key=lambda m: deltas[m]):
        rec: list[int] = []
        eids = expand.expand_partition(
            st, int(j), int(deltas[j]), alpha, beta,
            memory_limit=float(mem[j]),
            m_node=obj.cluster.m_node, m_edge=obj.cluster.m_edge,
            record_order=rec, engine=engine, **engine_kw)
        assign[sub_to_global[eids]] = j
        new_orders[j] = [int(x) for x in sub_to_global[eids]]
    # Any leftover edges in the pool: greedy repair below.
    left = sub_to_global[~st.assigned]
    assign[left] = -1
    new_obj = PartitionState.build(obj.g, assign, obj.cluster)
    repair_edges(new_obj, left, new_orders, strict=strict)
    orders[:] = new_orders
    return new_obj


def sls(g: Graph, assign: np.ndarray, cluster: Cluster,
        orders: list[list[int]], deltas: np.ndarray, *,
        t0: int = 8, n0: int = 5, gamma: float = 0.9, theta: float = 0.01,
        k: int = 3, alpha: float = 0.3, beta: float = 0.3,
        seed: int = 0, engine: str = "heap", repair: str = "vectorized",
        **engine_kw) -> tuple[np.ndarray, float]:
    """Algorithm 4: the SLS driver.  Returns (best assignment, best TC).

    ``repair`` selects the destroy-repair sweep implementation:
    ``"vectorized"`` (wave admission, the default) or ``"scalar"`` (the
    per-edge oracle — same decisions, interpreter-bound).
    """
    assert repair in ("vectorized", "scalar"), repair
    strict = repair == "scalar"
    rng = np.random.default_rng(seed)
    obj = PartitionState.build(g, assign, cluster)
    best_assign, best_tc = obj.assign.copy(), obj.tc
    n = 0
    budget = t0
    while budget > 0:
        if destroy_repair(obj, orders, gamma, theta, rng, strict=strict):
            n = 0
        else:
            n += 1
        if obj.tc < best_tc - 1e-9:
            best_assign, best_tc = obj.assign.copy(), obj.tc
        if n > n0:
            obj = repartition(obj, orders, deltas, k, alpha, beta,
                              engine=engine, strict=strict, **engine_kw)
            if obj.tc < best_tc - 1e-9:
                best_assign, best_tc = obj.assign.copy(), obj.tc
            n = 0
        budget -= 1
    return best_assign, best_tc
