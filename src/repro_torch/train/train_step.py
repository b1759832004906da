"""Train step: optionally remat'd forward, microbatched gradient
accumulation, optional int8 gradient compression, AdamW.

Ported from ``src/repro/train/train_step.py``.  Gradients come from
``torch.autograd.grad`` over the model's parameters (made trainable with
``params.requires_grad_()``), taken in the reference's leaf order
(``named_parameters``).  With ``microbatches = k > 1`` each microbatch's
gradients are divided by k in their own dtype and added in float32, in
order, as the reference's ``scan`` does; the loss likewise.
"""
from __future__ import annotations

import torch

from ..models import forward, reference_path
from .compression import compress_grads
from .optimizer import adamw_update


def named_parameters(cfg, params) -> dict:
    """``{name: parameter}`` of a Decoder in the reference's leaf order
    (``models.reference_path``)."""
    named = dict(params.named_parameters())
    return {k: named[k] for k in sorted(
        named, key=lambda k: reference_path(cfg, k))}


def make_loss_fn(cfg, *, remat: bool = True):
    """``loss_fn(params, inputs, labels)``: mean of ``logsumexp - gold``
    over the float32 logits."""
    def loss_fn(params, inputs, labels):
        logits = forward(cfg, params, inputs, remat=remat).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
        return (logz - gold).mean()
    return loss_fn


def loss_and_grads(cfg, params, batch, *, microbatches: int = 1,
                   remat: bool = True):
    """(loss, {name: gradient}) of one batch ``{"inputs", "labels"}``, the
    gradients in ``named_parameters`` order: in each parameter's dtype, or
    float32 when accumulated over ``microbatches``."""
    loss_fn = make_loss_fn(cfg, remat=remat)
    named = named_parameters(cfg, params)
    if any(not p.requires_grad for p in named.values()):
        raise ValueError("the parameters must be trainable: call "
                         "params.requires_grad_()")
    leaves = list(named.values())

    def grad(loss):
        # a parameter the loss does not reach gets zeros, as in JAX
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]
    inputs, labels = batch["inputs"], batch["labels"]
    if microbatches == 1:
        loss = loss_fn(params, inputs, labels)
        return loss.detach(), dict(zip(named, grad(loss)))
    k, B = microbatches, inputs.shape[0]
    if B % k:
        raise ValueError(f"batch {B} is not a multiple of {k} microbatches")
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in named.items()}
    total = torch.zeros((), dtype=torch.float32, device=inputs.device)
    for mb_in, mb_lb in zip(inputs.chunk(k), labels.chunk(k)):
        loss = loss_fn(params, mb_in, mb_lb)
        for a, g in zip(acc.values(), grad(loss)):
            a.add_(g / k)
        total = total + loss.detach() / k
    return total, acc


def make_train_step(cfg, *, lr=3e-4, weight_decay=0.01, grad_clip=1.0,
                    microbatches: int = 1, remat: bool = True,
                    compress: str | None = None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``, updating ``params`` and ``opt_state`` in place.

    batch: {"inputs": (B, S) or (B, S, d), "labels": (B, S)} on the
    parameters' device; metrics: {"loss", "grad_norm"} (0-d tensors).
    """
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got {compress!r}")

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch,
                                     microbatches=microbatches, remat=remat)
        if compress == "int8":
            grads = compress_grads(
                grads, leaf_of=lambda n: reference_path(cfg, n)[0])
        params, opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay,
            grad_clip=grad_clip)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
