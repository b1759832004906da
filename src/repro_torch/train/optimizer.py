"""AdamW with float32 moments (parameters may be bf16) and decoupled
weight decay, ported from ``src/repro/train/optimizer.py``.

Parameters, gradients and moments are flat ``{name: tensor}`` dicts, or a
module for the parameters (its ``named_parameters``); the gradients' dict
order is the order in which the global norm sums the leaves (the train
step gives the reference's: ``train_step.named_parameters``).  The update
runs in place under ``torch.no_grad()``, one tensor at a time, and keeps
the reference's roundings: the clipped gradient ``g · scale`` in float32,
each moment term rounded before the sum, the bias corrections
``1 - b ** step`` in float32.
"""
from __future__ import annotations

import torch
from torch import nn


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> dict:
    named = _named(params)
    dev = next(iter(named.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": {k: zeros(p) for k, p in named.items()},
            "v": {k: zeros(p) for k, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params, *, lr, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.0, grad_clip=1.0):
    """One AdamW step.  Returns ``(params, opt_state, gnorm)``: the
    parameters and moments updated in place, the step counter advanced,
    and the float32 global gradient norm before clipping (0 without
    clipping)."""
    named = _named(params)
    step = opt_state["step"] + 1
    dev = step.device
    if grad_clip:
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for g in grads.values():
            total = total + g.float().square().sum()
        gnorm = torch.sqrt(total)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    else:
        gnorm, scale = torch.zeros((), dtype=torch.float32, device=dev), None
    t = step.float()
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=dev) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=dev) ** t
    for name, g in grads.items():
        p, m, v = named[name], opt_state["m"][name], opt_state["v"][name]
        g = g.float() * scale if scale is not None else g.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square().mul_(1 - b2))
        del g
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        p32 = p.float()
        delta.add_(p32 * weight_decay)
        p.copy_(p32.sub_(delta.mul_(lr)))
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, gnorm
