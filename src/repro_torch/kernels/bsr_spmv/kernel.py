"""Block-ELL semiring SpMV: wrapper of the hand-written CUDA kernel.

Replaces ``src/repro/kernels/bsr_spmv/kernel.py::spmv_pallas``.  The
machine axis the reference adds with ``vmap`` is an explicit leading
dimension here, and the kernel (``csrc/bsr_spmv.cu``) runs it as a grid
dimension.

Layouts (leading machine axis ``p`` optional):

* ``cols``   ``(p, R, K)``        int32 block-column ids (pad slots -> 0)
* ``blocks`` ``(p, R, K, bm, bm)`` dense blocks (``absent``-padded)
* ``x``      ``(p, C*bm)``         input, padded to a block multiple
* ``y``      ``(p, R*bm)``         output

``blocks``, ``x`` and ``y`` share one dtype: float32, bfloat16 or float16
(the BSP message dtype), each its own instance of the kernel.  The
rounding contract of the 16-bit instances is ``ref.bsr_spmv_ref``'s.

A tensor on the CPU goes to the plain version (``ref.bsr_spmv_ref``); a
tensor on a CUDA device launches the kernel or raises.  Nothing falls
back.  ``bsr_spmv.launches`` counts kernel launches (never plain calls).
A call made while a CUDA graph captures the stream launches nothing: it
adds a kernel node to the graph, which each replay launches, so it does
not count; a profiler's trace records the replayed launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .._build import Built, load_library
from .ref import bsr_spmv_ref
from .semiring import get_semiring

SOURCE = pathlib.Path(__file__).with_name("csrc") / "bsr_spmv.cu"

#: the kernel stages 8 x slices of bm floats in (static-limit) shared memory
MAX_BLOCK_SIZE = 48 * 1024 // (8 * 4)

#: storage dtype -> C entry point of its kernel instance
ENTRY_POINTS = {torch.float32: "bsr_spmv_f32", torch.bfloat16: "bsr_spmv_bf16",
                torch.float16: "bsr_spmv_f16"}

#: CUDA's limit on the grid's y (block-rows) and z (machines) dimensions
MAX_GRID_YZ = 65535


@functools.cache
def build() -> Built:
    """Compile (at first use) and load the kernel library."""
    built = load_library(SOURCE)
    for name in ENTRY_POINTS.values():
        fn = getattr(built.lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    built.lib.bsr_spmv_error_string.argtypes = [ctypes.c_int]
    built.lib.bsr_spmv_error_string.restype = ctypes.c_char_p
    return built


def _check(cols: torch.Tensor, blocks: torch.Tensor, x: torch.Tensor) -> None:
    if cols.dim() not in (2, 3):
        raise ValueError(f"cols must be (R, K) or (p, R, K), got "
                         f"{tuple(cols.shape)}")
    if not (cols.device == blocks.device == x.device):
        raise ValueError(f"cols, blocks and x must share a device, got "
                         f"{cols.device}, {blocks.device}, {x.device}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if blocks.dtype != x.dtype or x.dtype not in ENTRY_POINTS:
        raise TypeError(f"blocks and x must share one dtype of "
                        f"{sorted(str(d) for d in ENTRY_POINTS)}, got "
                        f"{blocks.dtype} and {x.dtype}")
    lead = tuple(cols.shape[:-2])
    if blocks.dim() != cols.dim() + 2 or blocks.shape[:-2] != cols.shape \
            or blocks.shape[-1] != blocks.shape[-2]:
        raise ValueError(f"blocks must be {tuple(cols.shape)} + (bm, bm), "
                         f"got {tuple(blocks.shape)}")
    bm = blocks.shape[-1]
    if bm < 1 or x.dim() != len(lead) + 1 or tuple(x.shape[:-1]) != lead \
            or x.shape[-1] % bm or x.shape[-1] == 0:
        raise ValueError(f"x must be {lead} + (C*{bm},) with C >= 1, got "
                         f"{tuple(x.shape)}")
    if not (cols.is_contiguous() and blocks.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("cols, blocks and x must be contiguous")


def bsr_spmv(cols: torch.Tensor, blocks: torch.Tensor, x: torch.Tensor,
             semiring: str = "plus_times") -> torch.Tensor:
    """``y[r] = ⊕_k blocks[r,k] ⊗ x[cols[r,k]]`` (see module docstring)."""
    sr = get_semiring(semiring)
    _check(cols, blocks, x)
    if x.device.type == "cpu":
        return bsr_spmv_ref(cols, blocks, x, sr)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmv runs on 'cpu' or 'cuda', got {x.device}")
    batched = cols.dim() == 3
    if not batched:
        cols, blocks, x = cols[None], blocks[None], x[None]
    p, R, K = cols.shape
    bm = blocks.shape[-1]
    if bm > MAX_BLOCK_SIZE or R > MAX_GRID_YZ or p > MAX_GRID_YZ:
        raise ValueError(f"bsr_spmv kernel takes bm <= {MAX_BLOCK_SIZE} and "
                         f"R, p <= {MAX_GRID_YZ}; got bm={bm}, R={R}, p={p}")
    lib = build().lib
    y = torch.empty((p, R * bm), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, ENTRY_POINTS[x.dtype])(
            cols.data_ptr(), blocks.data_ptr(), x.data_ptr(), y.data_ptr(),
            p, R, K, x.shape[-1] // bm, bm, sr.code, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmv kernel launch failed: "
                           f"{lib.bsr_spmv_error_string(err).decode()}")
    if not torch.cuda.is_current_stream_capturing():
        bsr_spmv.launches += 1
    return y if batched else y[0]


bsr_spmv.launches = 0
