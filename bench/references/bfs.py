"""Breadth-first search (``repro_torch.bsp.apps.bfs``): hop distances
from ``source`` after at most ``num_iters`` layers; unreached vertices
stay at +inf."""
from __future__ import annotations

import numpy as np
import torch

import reference


def expected(edges: np.ndarray, n: int, weights: np.ndarray | None,
             source: int, args: dict, device) -> np.ndarray:
    """(n,) float64 hop counts from ``source``; the weights play no part."""
    src, dst, w = reference.directed(edges, None, device)
    dist = torch.full((n,), float("inf"), dtype=torch.float64,
                      device=device)
    dist[source] = 0.0
    return reference.relax(src, dst, w, dist, args.get("num_iters", 30))
