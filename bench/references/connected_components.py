"""Connected components by min-label propagation
(``repro_torch.bsp.apps.connected_components``): each vertex with an edge
takes the least vertex id within ``num_iters`` hops (its component's
least id once that many hops span it); a vertex with no edge holds
+inf."""
from __future__ import annotations

import numpy as np
import torch

import reference


def expected(edges: np.ndarray, n: int, weights: np.ndarray | None,
             source, args: dict, device) -> np.ndarray:
    """(n,) float64 labels; the weights play no part."""
    src, dst, w = reference.directed(edges, None, device)
    has_edge = torch.zeros(n, dtype=torch.bool, device=device)
    has_edge[src] = True
    ids = torch.arange(n, dtype=torch.float64, device=device)
    lab = torch.where(has_edge, ids, float("inf"))
    return reference.relax(src, dst, torch.zeros_like(w), lab,
                           args.get("num_iters", 30))
