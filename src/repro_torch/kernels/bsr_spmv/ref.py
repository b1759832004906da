"""Plain versions of the Block-ELL semiring SpMV: torch and numpy oracles."""
from __future__ import annotations

import numpy as np
import torch

from .ops import BsrMatrix
from .semiring import get_semiring


def dense_from_bsr(m: BsrMatrix) -> np.ndarray:
    """Materialize the dense matrix (missing entries = ``absent``)."""
    sr = get_semiring(m.semiring)
    bm = m.block_size
    R, K = m.cols.shape
    out = np.full((m.padded, m.padded), sr.absent, dtype=np.float32)
    for r in range(R):
        for k in range(K):
            c = int(m.cols[r, k])
            blk = m.blocks[r, k]
            tgt = out[r * bm:(r + 1) * bm, c * bm:(c + 1) * bm]
            if sr.name == "plus_times":
                tgt += blk
            elif sr.name == "min_plus":
                np.minimum(tgt, blk, out=tgt)
            else:                                   # or_and
                np.maximum(tgt, blk, out=tgt)
    return out[:m.n, :m.n]


def dense_semiring_mv(dense: np.ndarray, x: np.ndarray,
                      semiring: str) -> np.ndarray:
    """y_i = ⊕_j (A_ij ⊗ x_j) on a dense numpy matrix — the ground truth
    the kernel and its plain version are both held against."""
    sr = get_semiring(semiring)
    if sr.name == "plus_times":
        return dense @ x
    if sr.name == "min_plus":
        return (dense + x[None, :]).min(axis=1)
    return (dense * x[None, :]).max(axis=1)         # or_and


def bsr_spmv_ref(cols: torch.Tensor, blocks: torch.Tensor, x: torch.Tensor,
                 semiring: str = "plus_times") -> torch.Tensor:
    """``y[r] = ⊕_k blocks[r,k] ⊗ x[cols[r,k]]`` in plain torch.

    Shapes ``cols (R,K)``, ``blocks (R,K,bm,bm)``, ``x (C·bm,)`` ->
    ``y (R·bm,)`` in ``x.dtype``, or the same with a leading machine axis
    ``(p, ...)``.  Each ELL slot is ⊗-combined and ⊕-reduced over its
    columns, then folded into ``y`` in ascending ``k``: one
    ``(…, R, bm, bm)`` temporary at a time instead of the whole
    ``(…, R, K, bm, bm)`` product, so the plain version runs at the
    runtime's full layout size on the card as well.
    """
    sr = get_semiring(semiring)
    batched = cols.dim() == 3
    if not batched:
        cols, blocks, x = cols[None], blocks[None], x[None]
    p, R, K = cols.shape
    bm = blocks.shape[-1]
    xb = x.reshape(p, -1, bm)                                   # (p, C, bm)
    machine = torch.arange(p, device=x.device)[:, None, None]
    gathered = xb[machine, cols.long()]                         # (p, R, K, bm)
    y = torch.full((p, R, bm), sr.zero, dtype=x.dtype, device=x.device)
    for k in range(K):
        comb = sr.times(blocks[:, :, k], gathered[:, :, k, None, :])
        y = sr.plus(y, sr.plus_reduce(comb, -1).to(x.dtype))
    y = y.reshape(p, R * bm)
    return y if batched else y[0]
