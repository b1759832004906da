"""Plain version of flash-decode attention: the dense softmax, batched."""
from __future__ import annotations

import torch

#: additive bias of a position past ``lengths`` (the reference's -1e30)
MASKED = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, dh); k, v: (B, S, KVH, dh); lengths: (B,) valid KV prefix.

    Scores in float32 with scale 1/sqrt(dh) plus a bias of 0 (valid) or
    -1e30 (position >= lengths[b]); softmax over all S; output in q's dtype.
    With ``lengths[b] == 0`` every score is -1e30, so the weights are
    uniform and the output is the mean of V over all S, as in the reference
    (``src/repro/kernels/decode_attn/ref.py``).
    """
    B, H, dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / (dh ** 0.5)
    qg = q.reshape(B, KVH, G, dh).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    if lengths is not None:
        pos = torch.arange(S, device=q.device)
        bias = torch.where(pos[None, :] < lengths[:, None], 0.0, MASKED)
        scores = scores + bias[:, None, None, :].float()
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return out.reshape(B, H, dh).to(q.dtype)
