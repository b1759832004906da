"""Synthetic graph generators.

* ``rmat``: recursive-matrix power-law generator (Chakrabarti et al. 2004),
  with the Graph500 parameterization (a,b,c,d)=(.57,.19,.19,.05) used by the
  paper's scalability study (Section 5.3, Table 12).
* ``road_mesh``: 2-D lattice with rewired diagonals — a mesh-like, nearly
  degree-regular stand-in for roadNet-CA (RN).
* ``erdos_renyi``: uniform random graph (control case).
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph, from_edge_list


def rmat(scale: int, edge_factor: int = 16, *,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         seed: int = 0) -> Graph:
    """R-MAT graph with 2**scale vertices and ~edge_factor·V edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        go_right = (r >= a) & (r < ab)          # src stays, dst moves
        go_down = (r >= ab) & (r < abc)          # src moves, dst stays
        go_diag = r >= abc                       # both move
        src = (src << 1) | (go_down | go_diag)
        dst = (dst << 1) | (go_right | go_diag)
    # Permute vertex ids to break the implicit locality of the recursion.
    perm = rng.permutation(n)
    return from_edge_list(np.stack([perm[src], perm[dst]], axis=1),
                          num_vertices=n)


def graph500(scale: int, seed: int = 0) -> Graph:
    """Graph500 reference settings: edge factor 16, (.57,.19,.19,.05)."""
    return rmat(scale, edge_factor=16, seed=seed)


def road_mesh(side: int, *, rewire: float = 0.02, seed: int = 0) -> Graph:
    """side×side 4-connected lattice; ``rewire`` fraction of extra chords.

    Mesh-like (max degree ~8, like roadNet-CA's 8): models the paper's RN.
    """
    rng = np.random.default_rng(seed)
    n = side * side
    idx = np.arange(n).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    edges = [right, down]
    k = int(rewire * 2 * n)
    if k:
        u = rng.integers(0, n, k)
        # short-range chords only (keep it mesh-like)
        off = rng.integers(1, 4, k) * rng.choice([1, side, side + 1], k)
        v = np.clip(u + off, 0, n - 1)
        edges.append(np.stack([u, v], axis=1))
    return from_edge_list(np.concatenate(edges, axis=0), num_vertices=n)


def erdos_renyi(n: int, avg_degree: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2 * 1.1)
    e = rng.integers(0, n, size=(m, 2))
    return from_edge_list(e, num_vertices=n)
