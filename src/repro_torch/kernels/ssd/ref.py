"""Plain versions of the Mamba-2 SSD scan: the sequential recurrence and
the chunked (state-space-duality) form.

The recurrence takes the JAX kernel's flat layout, x ``(BH, T, dh)``, b/c
``(BH, T, ds)``, a ``(BH, T)``; the chunked form takes the model's
head-major one, x ``(B, T, nh, dh)``, b/c ``(B, T, G, ds)`` with head h
reading group ``h // (nh // G)``, a ``(B, T, nh)`` (a flat input is its
``[:, :, None]``).  ``a`` is the log-decay (<= 0).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_ref(x, b, c, a):
    """Flat layout; y ``(BH, T, dh)`` from the exact per-step recurrence

        h_t = exp(a_t) h_{t-1} + b_t x_tᵀ,   y_t = c_tᵀ h_t

    in float32 (``src/repro/kernels/ssd/ref.py``), in x's dtype."""
    BH, T, dh = x.shape
    ds = b.shape[-1]
    xf, bf, cf, af = x.float(), b.float(), c.float(), a.float()
    h = torch.zeros((BH, ds, dh), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        h = torch.exp(af[:, t])[:, None, None] * h \
            + bf[:, t, :, None] * xf[:, t, None, :]
        ys.append(torch.einsum("bs,bsd->bd", cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked_ref(x, b, c, a, *, chunk: int = 128,
                    return_state: bool = False):
    """Chunked SSD in plain torch (``src/repro/models/layers.py::ssd_jax``).

    Head-major layout (module docstring).  Returns y ``(B, T, nh, dh)`` in
    x's dtype and, if ``return_state``, the final state ``(B, nh, ds, dh)``
    in float32.
    """
    B, T, nh, dh = x.shape
    G, ds = b.shape[2], b.shape[3]
    L = min(chunk, T)
    pad = (-T) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // L
    rep = nh // G
    xc = x.reshape(B, nc, L, nh, dh).float()
    bc = b.reshape(B, nc, L, G, ds).repeat_interleave(rep, dim=3).float()
    cc = c.reshape(B, nc, L, G, ds).repeat_interleave(rep, dim=3).float()
    ac = a.reshape(B, nc, L, nh).float()
    cum = torch.cumsum(ac, dim=2)                            # (B,nc,L,nh)

    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,L,L,nh)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    tri = tri[None, None, :, :, None]
    decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    scores = torch.einsum("bnlhs,bnmhs->bnlmh", cc, bc) * decay
    y_intra = torch.einsum("bnlmh,bnmhd->bnlhd", scores, xc)

    # chunk states, then the sequential pass over chunks (carry-in per chunk)
    wdec = torch.exp(cum[:, :, -1:, :] - cum)                # (B,nc,L,nh)
    s_c = torch.einsum("bnlhs,bnlhd->bnhsd", wdec[..., None] * bc, xc)
    d_c = torch.exp(cum[:, :, -1, :])                        # (B,nc,nh)
    h = torch.zeros((B, nh, ds, dh), dtype=torch.float32, device=x.device)
    h_in = []
    for n in range(nc):
        h_in.append(h)
        h = d_c[:, n, :, None, None] * h + s_c[:, n]
    h_in = torch.stack(h_in, dim=1)                          # (B,nc,nh,ds,dh)
    y_inter = torch.einsum("bnlhs,bnhsd->bnlhd",
                           cc * torch.exp(cum)[..., None], h_in)
    y = (y_intra + y_inter).reshape(B, Tp, nh, dh)[:, :T].to(x.dtype)
    return (y, h) if return_state else y
