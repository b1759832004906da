"""Mamba-2 SSD chunk scan: wrapper of the hand-written CUDA kernel.

Replaces ``src/repro/kernels/ssd/kernel.py::ssd_pallas`` and its padding
wrapper ``ops.py::ssd_chunked``; in the model it stands where the reference
calls ``models/layers.py::ssd_jax``.  It takes the model's head-major layout,
x ``(B, T, nh, dh)``, b/c ``(B, T, G, ds)``, a ``(B, T, nh)``; the kernel
reads b/c of group ``h // (nh // G)`` without repeating them.  T need not be
a multiple of ``chunk``: the kernel masks the last chunk.

x, b, c are float32 or bfloat16 (alike), a is float32; y has x's dtype and
the final state (``return_state``) is float32.  The bfloat16 instance runs
its products on the tensor cores in sub-chunks of ``SUB_CHUNK`` steps
whatever ``chunk`` is (the chunked form computes one recurrence for every
chunk length; ``chunk`` moves only the rounding) and takes dh <= 64 and
ds <= 128, multiples of 8; the float32 instance walks ``chunk``-step
chunks on the CUDA cores (``csrc/ssd.cu``).

A tensor on the CPU goes to the plain version (``ref.ssd_chunked_ref``),
which autograd differentiates; a tensor on a CUDA device launches the
kernel or raises.  Nothing falls back.  ``ssd_chunked.launches`` counts
kernel launches, never plain calls.

On the card every call runs as ``SSDFunction``, whose forward is the
kernel and whose backward is the VJP of the plain version, recomputed from
the saved inputs (where no input requires a gradient, autograd records
nothing).  That is the
reference's own arithmetic (it differentiates the plain ``ssd_jax``; its
Pallas kernel has no backward), so no backward kernel exists to port.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .._build import Built, load_library
from .ref import ssd_chunked_ref

SOURCE = pathlib.Path(__file__).with_name("csrc") / "ssd.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: steps a sub-chunk of the bfloat16 (tensor-core) instance
SUB_CHUNK = 32
#: the largest dh and ds of the bfloat16 instance
TC_MAX_DH, TC_MAX_DS = 64, 128


@functools.cache
def build() -> Built:
    """Compile (at first use) and load the kernel library."""
    built = load_library(SOURCE)
    fn = built.lib.ssd_scan
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int64] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = built.lib.ssd_occupancy
    occ.argtypes = [ctypes.c_int] + [ctypes.c_int64] * 3 \
        + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    built.lib.ssd_error_string.argtypes = [ctypes.c_int]
    built.lib.ssd_error_string.restype = ctypes.c_char_p
    return built


@functools.cache
def occupancy(device: torch.device, dtype: torch.dtype, dh: int, ds: int,
              chunk: int) -> int:
    """CTAs of the kernel's launch for (dtype, dh, ds, chunk) that one SM
    of ``device`` holds at once, as the CUDA runtime reports it for the
    kernel, block and shared memory the launch uses."""
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build().lib.ssd_occupancy(_DTYPE_CODES[dtype], dh, ds, chunk,
                                        ctypes.byref(ctas))
    if err != 0 or ctas.value < 1:
        raise RuntimeError(f"ssd occupancy query failed (error {err}, "
                           f"{ctas.value} CTAs an SM) for {dtype}, dh={dh}, "
                           f"ds={ds}, chunk {chunk}")
    return ctas.value


def _check(x, b, c, a) -> None:
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape or a.dim() != 3:
        raise ValueError(f"need x (B,T,nh,dh), b/c (B,T,G,ds), a (B,T,nh); "
                         f"got {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}, {tuple(a.shape)}")
    B, T, nh, _ = x.shape
    if b.shape[:2] != (B, T) or a.shape != (B, T, nh) or T == 0 \
            or nh % b.shape[2]:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, a {tuple(a.shape)} (T >= 1 and "
                         f"heads a multiple of groups)")
    if not (x.dtype == b.dtype == c.dtype) or a.dtype != torch.float32:
        raise TypeError(f"x, b, c must share a dtype and a be float32; got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}, {a.dtype}")
    if not (x.device == b.device == c.device == a.device):
        raise ValueError("x, b, c, a must share a device")


def ssd_chunked(x, b, c, a, *, chunk: int = 128, return_state: bool = False):
    """SSD scan (see module docstring): y, or (y, final state)."""
    _check(x, b, c, a)
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, b, c, a, chunk=chunk,
                               return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked runs on 'cpu' or 'cuda', got "
                         f"{x.device}")
    y, h_last = SSDFunction.apply(x, b, c, a, chunk, return_state)
    return (y, h_last) if return_state else y


class SSDFunction(torch.autograd.Function):
    """The kernel forward, the plain version's VJP backward (module
    docstring).  Returns (y, final state or None)."""

    @staticmethod
    def forward(ctx, x, b, c, a, chunk: int, return_state: bool):
        ctx.save_for_backward(x, b, c, a)
        ctx.chunk = chunk
        ctx.return_state = return_state
        out = _launch(x, b, c, a, chunk, return_state)
        return out if return_state else (out, None)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(saved, ctx.needs_input_grad[:4])]
        with torch.enable_grad():
            out = ssd_chunked_ref(*inputs, chunk=ctx.chunk,
                                  return_state=ctx.return_state)
        # an unused state's gradient arrives as zeros (materialized)
        outs = out if ctx.return_state else (out,)
        got = iter(torch.autograd.grad(
            outs, [t for t in inputs if t.requires_grad],
            (grad_y, grad_h)[:len(outs)]))
        return (*(next(got) if t.requires_grad else None for t in inputs),
                None, None)


def _launch(x, b, c, a, chunk: int, return_state: bool):
    """One launch of the kernel on CUDA tensors checked by ``_check``."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    x, b, c, a = (t.contiguous() for t in (x, b, c, a))
    B, T, nh, dh = x.shape
    G, ds = b.shape[2], b.shape[3]
    if x.dtype == torch.bfloat16:
        if dh % 8 or ds % 8 or dh > TC_MAX_DH or ds > TC_MAX_DS:
            raise ValueError(f"ssd bfloat16 kernel takes dh <= {TC_MAX_DH} and "
                             f"ds <= {TC_MAX_DS}, multiples of 8; got dh={dh},"
                             f" ds={ds}")
        # 16-byte copies: a view that starts off a 16-byte boundary is copied
        x, b, c = (t.clone() if t.data_ptr() % 16 else t for t in (x, b, c))
    L = min(chunk, T)
    y = torch.empty_like(x)
    h_last = torch.empty((B, nh, ds, dh), dtype=torch.float32,
                         device=x.device) if return_state else None
    lib = build().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan(
            _DTYPE_CODES[x.dtype], x.data_ptr(), b.data_ptr(),
            c.data_ptr(), a.data_ptr(), y.data_ptr(),
            None if h_last is None else h_last.data_ptr(),
            B, T, nh, G, dh, ds, L, stream)
    if err != 0:
        # e.g. dh or ds not a multiple of 4, more than 65535 sequences, or a
        # chunk whose working set exceeds a CTA's shared memory
        raise RuntimeError(f"ssd kernel launch failed: "
                           f"{lib.ssd_error_string(err).decode()} (B={B}, "
                           f"nh={nh}, dh={dh}, ds={ds}, chunk {L})")
    ssd_chunked.launches += 1
    return (y, h_last) if return_state else y


ssd_chunked.launches = 0
