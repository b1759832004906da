"""Graph-oriented preprocessing: per-partition edge capacities (Alg. 1).

Solves (a simplification of) the MIP in paper Eq. (1)/(2):

    minimize  λ = max_i C_i |E_i|
    s.t.      Σ_i |E_i| = |E|
              (M^edge + M^node |V|/|E|) |E_i| <= M_i
              |E_i| integer >= 0

with C_i = C_i^edge + (|V|/|E|) C_i^node.  The heuristic water-fills the
unclamped machines so C_i δ_i is constant, clamps any machine whose memory
binds, and repeats on the remainder.  Error bound vs the LP optimum is
p²/|E| (paper Theorem 1).  ``exact_capacity`` solves the relaxed problem
exactly for cross-checking in tests.
"""
from __future__ import annotations

import numpy as np

from .machines import Cluster


def _mem_cap(cluster: Cluster, num_vertices: int, num_edges: int) -> np.ndarray:
    """δ_i^2: max edges machine i can hold, via |V_i| ≈ (|V|/|E|)|E_i|."""
    ratio = num_vertices / max(1, num_edges)
    per_edge_mem = cluster.m_edge + cluster.m_node * ratio
    return cluster.memory() / per_edge_mem


def effective_cost(cluster: Cluster, num_vertices: int, num_edges: int) -> np.ndarray:
    """C_i = C_i^edge + (|V|/|E|) C_i^node."""
    ratio = num_vertices / max(1, num_edges)
    return cluster.c_edge() + ratio * cluster.c_node()


def capacities(cluster: Cluster, num_vertices: int, num_edges: int) -> np.ndarray:
    """Algorithm 1: integer capacities δ_i with Σδ_i = |E|.

    Raises ValueError if no feasible assignment exists (Σ mem caps < |E|).
    """
    p = cluster.p
    C = effective_cost(cluster, num_vertices, num_edges)
    mem = np.floor(_mem_cap(cluster, num_vertices, num_edges)).astype(np.int64)
    if mem.sum() < num_edges:
        raise ValueError(
            f"infeasible: total memory capacity {mem.sum()} < |E|={num_edges}")

    delta = np.full(p, -1, dtype=np.int64)
    remaining = int(num_edges)
    active = np.ones(p, dtype=bool)
    # Water-fill: repeat until no machine newly clamps.
    while remaining > 0 and active.any():
        inv = (1.0 / C)[active]
        T = inv.sum()
        want = remaining / T * (1.0 / C)           # δ_i^1 for all (masked below)
        clamped = active & (want > mem)
        if clamped.any():
            delta[clamped] = mem[clamped]
            remaining -= int(mem[clamped].sum())
            active &= ~clamped
            continue
        # No clamping: distribute proportionally, floor, then hand out the
        # remainder one edge at a time to the cheapest machines (keeps the
        # Theorem-1 error bound).
        idx = np.flatnonzero(active)
        share = np.floor(want[idx]).astype(np.int64)
        share = np.minimum(share, mem[idx])
        delta[idx] = share
        remaining -= int(share.sum())
        active[:] = False
        if remaining > 0:
            room = mem[idx] - share
            order = idx[np.argsort(C[idx])]
            for i in order:
                if remaining == 0:
                    break
                take = int(min(room[np.where(idx == i)[0][0]], remaining))
                delta[i] += take
                remaining -= take
    if remaining > 0:
        # All machines clamped but memory is globally sufficient: top up.
        room = mem - delta
        order = np.argsort(C)
        for i in order:
            take = int(min(room[i], remaining))
            delta[i] += take
            remaining -= take
            if remaining == 0:
                break
    assert remaining == 0 and delta.sum() == num_edges, (delta, num_edges)
    return delta


def exact_capacity_relaxed(cluster: Cluster, num_vertices: int,
                           num_edges: int, iters: int = 64) -> np.ndarray:
    """Exact solution of the *relaxed* (continuous) problem, by bisection on λ.

    Feasible(λ): Σ_i min(λ/C_i, mem_i) >= |E|.  The optimal real-valued
    capacities are δ_i = min(λ*/C_i, mem_i).  Used as the test oracle for
    Lemma 1 / Theorem 1.
    """
    C = effective_cost(cluster, num_vertices, num_edges)
    mem = _mem_cap(cluster, num_vertices, num_edges)
    if mem.sum() < num_edges:
        raise ValueError("infeasible")
    lo, hi = 0.0, float(num_edges * C.max())
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if np.minimum(mid / C, mem).sum() >= num_edges:
            hi = mid
        else:
            lo = mid
    delta = np.minimum(hi / C, mem)
    # Scale the unclamped part so the sum is exact.
    slack = num_edges - delta.sum()
    un = delta < mem - 1e-12
    if un.any():
        delta[un] += slack * (1.0 / C[un]) / (1.0 / C[un]).sum()
    return delta
