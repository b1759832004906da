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

    Rounding, as the reference's Pallas body rounds (``y`` is held in
    ``x.dtype``): under (+, ×) a slot's products and their row sum are
    float32 (``jnp.dot(..., preferred_element_type=y.dtype)``), rounded
    once to ``x.dtype`` and then added to ``y`` with one more rounding;
    under (min, +) and (or, and) each product is rounded once to
    ``x.dtype`` and min/max is exact.  In float32 no step rounds twice.
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
        a, xk = blocks[:, :, k], gathered[:, :, k, None, :]
        if sr.name == "plus_times":
            slot = (a.float() * xk.float()).sum(-1)
        else:
            slot = sr.plus_reduce(sr.times(a, xk), -1)
        y = sr.plus(y, slot.to(x.dtype))
    y = y.reshape(p, R * bm)
    return y if batched else y[0]


def plus_times_bounds(cols: torch.Tensor, blocks: torch.Tensor,
                      x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` in ``x.dtype``, shaped as ``bsr_spmv_ref``'s result:
    the least and the largest ``y`` that the 16-bit (+, ×) rounding
    contract admits on finite inputs, whatever order each slot's float32
    row sum takes.

    A float32 sum of ``bm`` terms, in any order, lies within
    ``γ·Σ|terms|`` of the exact sum (γ = bm·2⁻²⁴/(1 − bm·2⁻²⁴)).  The
    exact slot sums are taken here in float64 (16-bit products are exact
    there); rounding to ``x.dtype`` and the fold into ``y`` are monotone,
    so folding the rounded ends of every slot's interval gives the ends
    of ``y``'s.  ``lo == hi`` wherever no slot sum lies near a rounding
    boundary, so the hold is bitwise there."""
    batched = cols.dim() == 3
    if not batched:
        cols, blocks, x = cols[None], blocks[None], x[None]
    p, R, K = cols.shape
    bm = blocks.shape[-1]
    u = 2.0 ** -24
    # float32 order, plus the float64 sum's own error; and float32
    # underflow, half a subnormal unit a product (none in an empty slot)
    gamma = bm * u / (1 - bm * u) + bm * 2.0 ** -52
    slack = bm * 2.0 ** -150
    xb = x.reshape(p, -1, bm)
    machine = torch.arange(p, device=x.device)[:, None, None]
    gathered = xb[machine, cols.long()]                         # (p, R, K, bm)
    lo = torch.zeros((p, R, bm), dtype=x.dtype, device=x.device)
    hi = torch.zeros_like(lo)
    for k in range(K):
        prod = blocks[:, :, k].double() * gathered[:, :, k, None, :].double()
        exact = prod.sum(-1)
        absum = prod.abs().sum(-1)
        err = gamma * absum + slack * (absum > 0)
        lo = lo + (exact - err).to(x.dtype)
        hi = hi + (exact + err).to(x.dtype)
    lo, hi = lo.reshape(p, R * bm), hi.reshape(p, R * bm)
    return (lo, hi) if batched else (lo[0], hi[0])
