"""Fixed-fanout neighbor sampling on device tensors + its NumPy oracle.

Both paths take the *same* uniforms, so the oracle is a bitwise pin, not
a statistical one.  The uniforms are an argument of :func:`fanout_hop`:
:func:`sample_fanout` draws them from a ``torch.Generator``, and the
parity tests hand in the JAX package's own ``jax.random.uniform`` draws
(whose threefry bits no torch generator reproduces).

* **with replacement** (fast path): a ``(B, fanout)`` uniform block;
  neighbor index = ``floor(u * degree)`` clamped to the row — a single
  gather, no per-row work.
* **without replacement** (exact path): a ``(B, max(D, fanout))``
  uniform block; each row keeps its first ``degree`` uniforms, masks the
  rest to +inf, and takes the ``fanout`` smallest, ties to the lower
  lane — exactly a uniform random permutation prefix of the true
  neighbor list (every neighbor's key is i.i.d. uniform, so any ordering
  is equally likely).

Rows are indices into a padded ``(R, D)`` neighbor table (``-1``-padded,
as :class:`~repro_torch.sampling.machine_csc.MachineCSC` packs it).
Invalid rows (``row < 0``) and zero-degree rows sample ``-1``
everywhere; rows with ``degree < fanout`` pad their tail with ``-1`` in
the without-replacement path (a fanout draw never repeats a neighbor).

The NumPy oracle re-implements both selection rules with per-row Python
loops over the same uniforms — an independent derivation of the same
bits, which the tests and ``chip_smoke.py`` compare bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

SELECTS = ("sort", "top_k")


def hop_width(max_degree: int, fanout: int, replace: bool) -> int:
    """Columns of one hop's uniform block: ``fanout`` with replacement,
    ``max(D, fanout)`` without (a fanout above the table width pads)."""
    return int(fanout) if replace else max(int(max_degree), int(fanout))


def fanout_hop(table: torch.Tensor, deg: torch.Tensor, rows: torch.Tensor,
               u: torch.Tensor, fanout: int, replace: bool,
               select: str = "sort") -> torch.Tensor:
    """One fanout hop over ``(B, hop_width)`` float32 uniforms ``u``.

    The single source of the selection math: :func:`sample_fanout` and
    both paths of :class:`~repro_torch.sampling.service.SamplingService`
    call it.  ``select`` picks the without-replacement lowering:
    ``"sort"``, a stable sort of the keyed row and its first ``fanout``
    columns; or ``"top_k"``, ``torch.topk`` over int64 keys whose high
    half is the key's float32 bit pattern (monotone for keys >= 0, +inf
    included) and whose low half is the lane, so no two keys tie and the
    lower lane wins exactly as in the stable sort (``torch.topk`` on the
    float keys promises no tie order on CUDA).  Both give identical bits.

    Returns ``(B, fanout)`` int32 global ids, ``-1`` where no sample
    exists.
    """
    if select not in SELECTS:
        raise ValueError(f"select must be one of {SELECTS}, got {select!r}")
    R, D = table.shape
    B = rows.shape[0]
    width = hop_width(D, fanout, replace)
    if tuple(u.shape) != (B, width) or u.dtype != torch.float32:
        raise ValueError(f"u must be ({B}, {width}) float32, got "
                         f"{tuple(u.shape)} {u.dtype}")
    safe = rows.clamp(0, R - 1).long()
    d = torch.where(rows >= 0, deg[safe], 0)                  # (B,)
    if replace:
        # floor(u * d) < d for exact arithmetic; the clamp guards the
        # float32 rounding edge u*d == d.  Zero-degree rows mask below.
        idx = (u * d[:, None].to(torch.float32)).to(torch.int32)
        idx = torch.minimum(idx, (d[:, None] - 1).clamp(min=0))
        out = table[safe[:, None], idx.long()]
        return torch.where(d[:, None] > 0, out, -1)
    lanes = torch.arange(width, device=u.device)
    keyed = torch.where(lanes[None, :] < d[:, None], u, torch.inf)
    if select == "sort":
        order = torch.sort(keyed, dim=1, stable=True).indices[:, :fanout]
    else:
        composite = (keyed.view(torch.int32).to(torch.int64) << 32) | lanes
        order = torch.topk(composite, fanout, dim=1, largest=False,
                           sorted=True).values & 0xFFFFFFFF
    # A lane >= D (fanout > D) lies past every live lane, so only masked
    # positions hold one: clamp it into the table instead of padding it.
    out = table[safe[:, None], order.clamp(max=D - 1)]
    live_out = (torch.arange(fanout, device=u.device)[None, :]
                < d.clamp(max=fanout)[:, None])
    return torch.where(live_out, out, -1)


def sample_fanout(table: torch.Tensor, deg: torch.Tensor, rows, fanout: int,
                  *, generator: torch.Generator, replace: bool = False,
                  select: str = "sort") -> torch.Tensor:
    """Sample ``fanout`` neighbors for each of ``rows`` from ``table``,
    drawing the uniforms from ``generator`` on ``table``'s device.

    ``table`` — (R, D) int32 padded neighbor lists (global ids, -1 pad);
    ``deg`` — (R,) true neighbor count per row; ``rows`` — (B,) row
    indices, ``-1`` for invalid entries.  Returns (B, fanout) int32
    sampled global ids, ``-1`` where no sample exists.
    """
    rows = torch.as_tensor(rows, dtype=torch.int32, device=table.device)
    width = hop_width(table.shape[1], fanout, replace)
    u = torch.rand((rows.shape[0], width), generator=generator,
                   device=table.device)
    return fanout_hop(table, deg, rows, u, int(fanout), bool(replace),
                      select)


def sample_fanout_np(table, deg, rows, u, fanout: int, *,
                     replace: bool = False) -> np.ndarray:
    """NumPy oracle for :func:`fanout_hop` — same uniforms, same bits,
    per-row Python loops; the device path must match it bitwise."""
    table = np.asarray(table)
    deg = np.asarray(deg)
    rows = np.asarray(rows)
    u = np.asarray(u)
    B, D = len(rows), table.shape[1]
    fanout = int(fanout)
    out = np.full((B, fanout), -1, dtype=np.int32)
    if replace:
        for b in range(B):
            r = int(rows[b])
            if r < 0:
                continue
            d = int(deg[r])
            if d == 0:
                continue
            for j in range(fanout):
                idx = min(int(np.float32(u[b, j]) * np.float32(d)), d - 1)
                out[b, j] = table[r, idx]
        return out
    for b in range(B):
        r = int(rows[b])
        if r < 0:
            continue
        d = int(deg[r])
        keyed = u[b].copy()
        keyed[d:] = np.inf
        order = np.argsort(keyed, kind="stable")
        for j in range(min(d, fanout)):
            out[b, j] = table[r, order[j]]
    return out
