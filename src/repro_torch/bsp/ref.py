"""Single-machine numpy oracles for the BSP apps (test references)."""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph


def pagerank(g: Graph, num_iters: int = 20, damping: float = 0.85):
    n = g.num_vertices
    deg = np.maximum(1, g.degree()).astype(np.float64)
    pr = np.full(n, 1.0 / n)
    u, v = g.edges[:, 0], g.edges[:, 1]
    for _ in range(num_iters):
        msg = pr / deg
        nxt = np.zeros(n)
        np.add.at(nxt, v, msg[u])
        np.add.at(nxt, u, msg[v])
        pr = (1 - damping) / n + damping * nxt
    return pr


def sssp(g: Graph, source: int = 0, weights: np.ndarray | None = None,
         num_iters: int = 30):
    n = g.num_vertices
    w = np.ones(g.num_edges) if weights is None else weights
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    u, v = g.edges[:, 0], g.edges[:, 1]
    for _ in range(num_iters):
        cand = np.full(n, np.inf)
        np.minimum.at(cand, v, dist[u] + w)
        np.minimum.at(cand, u, dist[v] + w)
        new = np.minimum(dist, cand)
        if np.array_equal(new, dist, equal_nan=True):
            break
        dist = new
    return dist


def bfs(g: Graph, source: int = 0, num_iters: int = 30):
    return sssp(g, source, np.ones(g.num_edges), num_iters)


def triangle_count(g: Graph) -> int:
    count = 0
    for u, v in g.edges:
        count += len(np.intersect1d(g.neighbors(u), g.neighbors(v),
                                    assume_unique=True))
    return count // 3
