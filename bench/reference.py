"""The plain reference that decides ``correct``: NumPy and plain PyTorch
over the global edge list, in float64.  What is common to every query;
each app's own answer is in ``references/<app>.py``, found by the app's
name.

It imports nothing of the program.  It takes the edges, the weights and
the cluster's numbers from the benchmark, which hands the same arrays to
the program, and reads the program's outputs (ranks, distances, an edge
assignment) only to judge them.

* :func:`canonical` is the edge set both sides use: each undirected edge
  once as (u, v) with u < v, loops dropped, repeats merged, sorted by
  ``u · n + v``.
* :func:`cluster_machines` is the WindGP paper's heterogeneous cluster
  scaled to a graph (3 units of memory an edge, times the slack, split
  10 : 3 between a super and a normal machine).
* :func:`directed` gives both directions of every edge, with weights.
* :func:`relax` runs rounds of ``d_v = min(d_v, min_u d_u + w_uv)``.
* :func:`rel_err` is the gap that a query's answer is held to.
* :func:`assignment_violations` counts what breaks the partition's
  guarantees: an assignment of the wrong length, an edge on no machine in
  range, a machine over its memory cap.
"""
from __future__ import annotations

import numpy as np
import torch

#: rounds of :func:`relax` between looks for a fixpoint
ROUNDS_PER_LOOK = 8


def canonical(raw: np.ndarray, n: int) -> np.ndarray:
    """(E, 2) int64 canonical undirected edges of an (m, 2) edge draw."""
    raw = np.asarray(raw, dtype=np.int64).reshape(-1, 2)
    u = np.minimum(raw[:, 0], raw[:, 1])
    v = np.maximum(raw[:, 0], raw[:, 1])
    keep = u != v
    key = np.unique(u[keep] * np.int64(n) + v[keep])
    return np.stack([key // n, key % n], axis=1)


def cluster_machines(cluster: dict, num_edges: int) -> list[tuple]:
    """(memory, c_node, c_edge, c_com) of each machine, super ones first."""
    total = cluster["units_per_edge"] * num_edges * cluster["slack"]
    ratio_super, ratio_normal = cluster["memory_ratio"]
    denom = ratio_super * cluster["super"] + ratio_normal * cluster["normal"]
    sm = ratio_super * total / denom
    nm = ratio_normal * total / denom
    return ([(sm, *cluster["super_costs"])] * cluster["super"]
            + [(nm, *cluster["normal_costs"])] * cluster["normal"])


def directed(edges: np.ndarray, weights: np.ndarray | None, device):
    """Both directions of every edge as device tensors, the weights in
    float64 (ones where ``weights`` is None)."""
    e = torch.as_tensor(edges, dtype=torch.int64, device=device)
    src = torch.cat([e[:, 0], e[:, 1]])
    dst = torch.cat([e[:, 1], e[:, 0]])
    if weights is None:
        w = torch.ones(len(edges), dtype=torch.float64, device=device)
    else:
        w = torch.as_tensor(weights, device=device).to(torch.float64)
    return src, dst, torch.cat([w, w])


def relax(src, dst, w, dist, rounds: int) -> np.ndarray:
    """(n,) float64 ``dist`` after rounds of ``d_v = min(d_v, min_u d_u +
    w_uv)`` over the directed edges, until a round changes nothing or
    ``rounds`` have run: the answer of ``rounds`` synchronous supersteps."""
    for r in range(rounds):
        cand = torch.full_like(dist, float("inf"))
        cand.scatter_reduce_(0, dst, dist[src] + w, "amin")
        new = torch.minimum(dist, cand)
        if r % ROUNDS_PER_LOOK == ROUNDS_PER_LOOK - 1 and \
                not bool((new < dist).any()):
            break
        dist = new
    return dist.cpu().numpy()


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """Widest gap between the program's values and the reference's, over
    the largest finite reference value; +inf where the two disagree on
    which values are finite or the lengths differ."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)):
        return float("inf")
    if not fin.any():
        return 0.0
    scale = max(float(np.abs(want[fin]).max()), np.finfo(np.float64).tiny)
    return float(np.abs(got[fin] - want[fin]).max() / scale)


def assignment_violations(assign: np.ndarray, edges: np.ndarray, n: int,
                          machines: list[tuple], m_node: float,
                          m_edge: float) -> int:
    """Edges placed on no machine in range, plus machines whose
    ``m_node · |V_i| + m_edge · |E_i|`` exceeds their memory; the whole
    edge count where the assignment's length is wrong."""
    assign = np.asarray(assign).reshape(-1)
    p = len(machines)
    if len(assign) != len(edges):
        return len(edges)
    ok = (assign >= 0) & (assign < p)
    bad = int((~ok).sum())
    a = assign[ok].astype(np.int64)
    e = edges[ok]
    edges_per = np.bincount(a, minlength=p)
    member = np.zeros((p, n), dtype=bool)
    member[a, e[:, 0]] = True
    member[a, e[:, 1]] = True
    need = m_node * member.sum(axis=1) + m_edge * edges_per
    memory = np.array([m[0] for m in machines], dtype=np.float64)
    return bad + int((need > memory + 1e-9).sum())
