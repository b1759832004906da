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


def decode_attention_splits(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            lengths: torch.Tensor | None = None, *,
                            split_len: int) -> torch.Tensor:
    """The kernel's algorithm in plain torch, for tests: S cut into splits
    of ``split_len`` positions, each reduced to a partial (m, l, acc), then
    merged as the kernel's last CTA merges them.

    A split visits its positions below ``n = min(lengths[b], S)``, or all
    of S where ``lengths[b] <= 0``; a split with nothing to visit is empty
    (m = -inf, l = 0, acc = 0) and gets weight 0 in the merge.  Same
    arguments and result as ``decode_attention_ref``.
    """
    B, H, dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / (dh ** 0.5)
    qg = q.reshape(B, KVH, G, dh).float()
    lens = (torch.full((B,), S, device=q.device) if lengths is None
            else lengths.long())
    n = torch.where(lens >= 1, lens.clamp(max=S), S)
    pos = torch.arange(S, device=q.device)
    parts = []
    for lo in range(0, S, split_len):
        hi = min(lo + split_len, S)
        scores = torch.einsum("bhgd,bshd->bhgs", qg,
                              k[:, lo:hi].float()) * scale
        bias = torch.where(pos[None, lo:hi] < lens[:, None], 0.0, MASKED)
        scores = scores + bias[:, None, None, :].float()
        visited = (pos[None, lo:hi] < n[:, None])[:, None, None, :]
        m = torch.where(visited, scores, float("-inf")).amax(dim=-1)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(visited, torch.exp(scores - m_safe[..., None]), 0.0)
        acc = torch.einsum("bhgs,bshd->bhgd", p, v[:, lo:hi].float())
        parts.append((m, p.sum(dim=-1), acc))
    m = torch.stack([pm for pm, _, _ in parts])           # (nsplit, B, KVH, G)
    l = torch.stack([pl for _, pl, _ in parts])
    acc = torch.stack([pa for _, _, pa in parts])         # (..., dh)
    w = torch.exp(m - m.amax(dim=0))                      # split 0 is finite
    den = (w * l).sum(dim=0).clamp(min=1e-30)
    out = (w[..., None] * acc).sum(dim=0) / den[..., None]
    return out.reshape(B, H, dh).to(q.dtype)
