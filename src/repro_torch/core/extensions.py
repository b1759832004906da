"""Paper §4 extensions: Map-Reduce objective, vertex-centric conversion.

* **Map-Reduce engines** (GraphX/Giraph): communication only starts after
  every machine finishes local compute, so the makespan is
  ``max_i(max_j T_j^cal + T_i^com)`` instead of ``max_i(T_i^cal+T_i^com)``.
  ``evaluate_mapreduce`` scores it; ``windgp(..)`` results can be re-tuned
  against it by passing ``objective="mapreduce"`` to the SLS phase through
  ``sls_mapreduce``.
* **Vertex-centric partition** (edge-cut) derived from WindGP's vertex-cut:
  each vertex goes to the machine holding its largest partial degree (the
  paper's max deg_k(u)/(deg(u)+1) rule), memory-capped; each edge then
  lives on whichever endpoint machine keeps it internal, and the edge-cut
  is counted for Table-10-style comparisons.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph
from .machines import Cluster, evaluate


def evaluate_mapreduce(g: Graph, assign: np.ndarray, cluster: Cluster):
    """Map-Reduce makespan: max_i ( max_j T_j^cal + T_i^com )."""
    s = evaluate(g, assign, cluster)
    return float(s.t_cal.max() + s.t_com.max()), s


def vertex_partition_from_edge_partition(g: Graph, assign: np.ndarray,
                                         cluster: Cluster) -> np.ndarray:
    """Paper §4: place vertex u on machine argmax_k deg_k(u)/(deg(u)+1),
    subject to machine memory (falls back to next-best machine).

    Returns (V,) machine id per vertex (-1 for isolated vertices).
    """
    p = cluster.p
    V = g.num_vertices
    partial = np.zeros((p, V), dtype=np.int64)
    e = g.edges
    np.add.at(partial, (assign, e[:, 0]), 1)
    np.add.at(partial, (assign, e[:, 1]), 1)
    deg = g.degree()
    score = partial / (deg[None, :] + 1.0)
    place = np.full(V, -1, dtype=np.int64)
    cap = cluster.memory() / max(cluster.m_node, 1e-9)
    used = np.zeros(p)
    # heavy vertices first (they are hardest to place once machines fill)
    for v in np.argsort(-deg, kind="stable"):
        if deg[v] == 0:
            continue
        for k in np.argsort(-score[:, v], kind="stable"):
            if used[k] + 1 <= cap[k]:
                place[v] = k
                used[k] += 1
                break
        if place[v] < 0:
            place[v] = int(np.argmin(used / np.maximum(cap, 1)))
            used[place[v]] += 1
    return place


def edge_cut(g: Graph, vertex_assign: np.ndarray) -> int:
    """Number of edges whose endpoints live on different machines."""
    a = vertex_assign[g.edges[:, 0]]
    b = vertex_assign[g.edges[:, 1]]
    return int(np.sum((a != b) & (a >= 0) & (b >= 0)))


def vertex_balance(vertex_assign: np.ndarray, p: int) -> float:
    """max_i |V_i| / (|V|/p) — the α' of edge-cut partitioning."""
    counts = np.bincount(vertex_assign[vertex_assign >= 0], minlength=p)
    return float(counts.max() / max(1e-9, counts.sum() / p))
