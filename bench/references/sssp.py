"""Single-source shortest paths by edge weight
(``repro_torch.bsp.apps.sssp``): Bellman-Ford rounds from ``source``, at
most ``num_iters``; unreached vertices stay at +inf."""
from __future__ import annotations

import numpy as np
import torch

import reference


def expected(edges: np.ndarray, n: int, weights: np.ndarray | None,
             source: int, args: dict, device) -> np.ndarray:
    """(n,) float64 distances from ``source``."""
    src, dst, w = reference.directed(edges, weights, device)
    dist = torch.full((n,), float("inf"), dtype=torch.float64,
                      device=device)
    dist[source] = 0.0
    return reference.relax(src, dst, w, dist, args.get("num_iters", 30))
