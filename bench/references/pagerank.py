"""PageRank as the system defines it on an undirected graph
(``repro_torch.bsp.apps.pagerank``): every vertex with an edge starts at
1/n, a superstep sends ``pr_u / wdeg_u`` along each edge scaled by its
weight, and ``pr_v = (1 - d)/n + d · Σ``; a vertex with no edge holds
``(1 - d)/n``.  ``num_iters`` supersteps, or fewer where ``tol`` is given
and a superstep changes no rank by more than it."""
from __future__ import annotations

import numpy as np
import torch

import reference


def expected(edges: np.ndarray, n: int, weights: np.ndarray | None,
             source, args: dict, device) -> np.ndarray:
    """(n,) float64 ranks; ``args`` are the query's keyword arguments."""
    num_iters = args.get("num_iters", 20)
    damping = args.get("damping", 0.85)
    tol = args.get("tol")
    src, dst, w = reference.directed(edges, weights, device)
    wdeg = torch.zeros(n, dtype=torch.float64, device=device)
    wdeg.index_add_(0, src, w)
    has_edge = torch.zeros(n, dtype=torch.bool, device=device)
    has_edge[src] = True
    pr = torch.where(has_edge, 1.0 / n, 0.0).to(torch.float64)
    for _ in range(num_iters):
        msg = torch.where(has_edge, pr / torch.where(has_edge, wdeg, 1.0),
                          0.0)
        total = torch.zeros(n, dtype=torch.float64, device=device)
        total.index_add_(0, dst, w * msg[src])
        new = (1.0 - damping) / n + damping * total
        done = tol is not None and \
            float((new - pr)[has_edge].abs().max()) <= tol
        pr = new
        if done:
            break
    return pr.cpu().numpy()
