"""Host Block-ELL layout: ``BsrMatrix`` and ``bsr_from_edges`` (numpy).

The BSP runtime builds its stacked per-machine blocks on the device
(``bsp/partition_runtime.py``); this numpy builder is the small-size
layout the tests hold that device build and the kernel against.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .semiring import Semiring, get_semiring


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Symmetric adjacency (optionally weighted) in Block-ELL layout.

    Missing entries hold ``semiring.absent`` (0 for (+,×)/(or,and), +inf
    for (min,+)), so zero-padding blocks and ELL fill slots contribute the
    ⊕ identity to every product.
    """

    cols: np.ndarray     # (R, K) int32 block-column ids
    blocks: np.ndarray   # (R, K, bm, bm) float32 dense blocks
    n: int               # logical dimension (<= R*bm)
    block_size: int
    semiring: str = "plus_times"

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def padded(self):
        return self.cols.shape[0] * self.block_size


def bsr_from_edges(edges: np.ndarray, n: int, values: np.ndarray | None = None,
                   block_size: int = 128, symmetric: bool = True,
                   semiring: str | Semiring = "plus_times") -> BsrMatrix:
    """Build a Block-ELL matrix from an (E, 2) edge list.

    ``A[u, v] ⊕= w`` (and ``A[v, u] ⊕= w`` when symmetric) under the
    semiring's ⊕.  Missing entries hold ``semiring.absent``; padding
    blocks point at block-column 0.  Block-column slots of a row are in
    ascending column order, the order the device build reproduces.
    """
    sr = get_semiring(semiring)
    bm = block_size
    R = max(1, -(-n // bm))
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    w = np.ones(len(e), dtype=np.float32) if values is None \
        else np.asarray(values, dtype=np.float32)
    if symmetric and len(e):
        e = np.concatenate([e, e[:, ::-1]], axis=0)
        w = np.concatenate([w, w])
    if not len(e):
        return BsrMatrix(
            cols=np.zeros((R, 1), dtype=np.int32),
            blocks=np.full((R, 1, bm, bm), sr.absent, dtype=np.float32),
            n=n, block_size=bm, semiring=sr.name)
    bi, bj = e[:, 0] // bm, e[:, 1] // bm
    key = bi * R + bj
    order = np.argsort(key, kind="stable")
    e, w, bi, bj, key = e[order], w[order], bi[order], bj[order], key[order]
    uniq, start = np.unique(key, return_index=True)
    counts_per_row = np.bincount((uniq // R).astype(np.int64), minlength=R)
    K = max(1, int(counts_per_row.max()))
    cols = np.zeros((R, K), dtype=np.int32)
    blocks = np.full((R, K, bm, bm), sr.absent, dtype=np.float32)
    slot = np.zeros(R, dtype=np.int64)
    bounds = np.append(start, len(e))
    for s, t in zip(bounds[:-1], bounds[1:]):
        r, c = int(bi[s]), int(bj[s])
        k = slot[r]
        cols[r, k] = c
        sr.np_accum_at(blocks[r, k], (e[s:t, 0] % bm, e[s:t, 1] % bm), w[s:t])
        slot[r] += 1
    return BsrMatrix(cols=cols, blocks=blocks, n=n, block_size=bm,
                     semiring=sr.name)
