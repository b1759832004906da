"""Graph500's Kronecker (R-MAT) generator, in plain NumPy.

A frozen copy of the draw that ``repro_torch.data.rmat`` makes: ``scale``
bit levels, each choosing a quadrant with probabilities (a, b, c, 1-a-b-c)
for every edge at once, then a random permutation of the vertex ids.  The
benchmark owns this copy so that the graphs it measures stay the same
whatever later changes make to the program's generator.
"""
from __future__ import annotations

import numpy as np


def raw_edges(scale: int, edgefactor: int, a: float, b: float, c: float,
              seed: int) -> tuple[np.ndarray, int]:
    """(m, 2) int64 directed edges as drawn (loops and repeats kept), and
    the vertex count 2**scale."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edgefactor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = rng.random(m)
        go_right = (r >= a) & (r < ab)
        go_down = (r >= ab) & (r < abc)
        go_diag = r >= abc
        src = (src << 1) | (go_down | go_diag)
        dst = (dst << 1) | (go_right | go_diag)
    perm = rng.permutation(n)
    return np.stack([perm[src], perm[dst]], axis=1), n


def make(cfg: dict, graph_seed: int) -> tuple[np.ndarray, int]:
    """The configuration's graph drawn from ``graph_seed``."""
    return raw_edges(cfg["scale"], cfg["edgefactor"], cfg["a"], cfg["b"],
                     cfg["c"], graph_seed)
