"""BSP superstep engine over a leading machine axis.

Every state and static tensor is machine-stacked ``(p, ...)``; a superstep
runs all machines at once (the reference maps one superstep body over the
machines with ``vmap``).  The replica exchange is the only cross-machine
communication: each machine scatters its replicated-vertex values into a
``(r_pad+1,)`` row of a ``(p, r_pad+1)`` buffer, the rows reduce over the
machine dim (the reference's ``psum``/``pmin``/``pmax``), and every machine
gathers the combined value back.

Superstep contract: ``superstep(state, static) -> (state, (p,) active)``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _extreme(dtype: torch.dtype, sign: int):
    """Dtype-safe stand-in for ±∞: the most extreme representable value.

    Floats keep the true infinities; integer dtypes get ``iinfo`` max/min
    (an infinity cast to int32 would wrap).
    """
    if dtype.is_floating_point:
        return float("inf") if sign > 0 else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if sign > 0 else info.min


def exchange(partial: torch.Tensor, rep_slot: torch.Tensor, r_pad: int,
             mode: str = "sum") -> torch.Tensor:
    """Synchronize replicated-vertex values across machines.

    partial: (p, Vmax) each machine's local value per local vertex;
    rep_slot: (p, Vmax) replica-table slot, -1 for single-machine vertices.
    Returns (p, Vmax) with replicated entries replaced by the cross-machine
    combination (sum / min / max); non-replicated entries pass through.
    """
    if mode == "sum":
        ident = 0
    elif mode == "min":
        ident = _extreme(partial.dtype, +1)
    elif mode == "max":
        ident = _extreme(partial.dtype, -1)
    else:
        raise ValueError(mode)
    rep = rep_slot >= 0
    slot = torch.where(rep, rep_slot, r_pad).long()     # pad -> dump slot
    vals = torch.where(rep, partial, ident)
    buf = torch.full((partial.shape[0], r_pad + 1), ident,
                     dtype=partial.dtype, device=partial.device)
    if mode == "sum":
        tot = buf.scatter_add_(1, slot, vals).sum(dim=0, dtype=partial.dtype)
    else:
        red = "amin" if mode == "min" else "amax"
        buf.scatter_reduce_(1, slot, vals, red, include_self=True)
        tot = buf.amin(dim=0) if mode == "min" else buf.amax(dim=0)
    return torch.where(rep, tot[slot], partial)


def make_step(superstep: Callable, static):
    """One BSP superstep with the static tree bound: state -> (state, act)."""
    return lambda state: superstep(state, static)


def _num_machines(state) -> int:
    """p from a state dict: every leaf is machine-stacked on dim 0."""
    return next(iter(state.values())).shape[0]


def run_bsp(superstep: Callable, state, static, num_steps: int):
    """Iterate the superstep; returns (final_state, (steps, p) actives).

    One host sync per superstep, on the ``(p,)`` active counts.
    """
    step = make_step(superstep, static)
    actives = []
    for _ in range(num_steps):
        state, act = step(state)
        actives.append(act.cpu().numpy())
    if not actives:
        # zero steps still contract to a (0, p) actives array
        return state, np.zeros((0, _num_machines(state)))
    return state, np.stack(actives)
