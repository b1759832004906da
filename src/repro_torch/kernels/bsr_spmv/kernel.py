"""Block-ELL semiring SpMV: wrapper of the hand-written CUDA kernel.

Replaces ``src/repro/kernels/bsr_spmv/kernel.py::spmv_pallas``.  The
machine axis the reference adds with ``vmap`` is an explicit leading
dimension here.

Layouts (leading machine axis ``p`` optional):

* ``cols``   ``(p, R, K)``        int32 block-column ids (pad slots -> 0)
* ``blocks`` ``(p, R, K, bm, bm)`` dense blocks (``absent``-padded)
* ``x``      ``(p, C*bm)``         input, padded to a block multiple
* ``y``      ``(p, R*bm)``         output

``blocks``, ``x`` and ``y`` share one dtype: float32, bfloat16 or float16
(the BSP message dtype), each its own instance of the kernel.  The
rounding contract of the 16-bit instances is ``ref.bsr_spmv_ref``'s.

The kernel (``csrc/bsr_spmv.cu``) runs one CTA a tile of ``rows`` rows of
a block-row, with K inside the CTA, and streams each slot's block slab and
x slice through a ring of ``stages`` stages in shared memory, filled by a
producer warp.  ``plan_tiles`` sizes the tile and lays out the ring, which
the kernel takes as launch arguments; its mode is chosen by shape: ``"bulk"`` (one bulk copy a slab) where a block row is a
multiple of 16 bytes and ``blocks`` and ``x`` are 16-byte aligned,
``"loads"`` (the producer's own loads) anywhere else, e.g. bm = 30 in 16
bits.

A tensor on the CPU goes to the plain version (``ref.bsr_spmv_ref``); a
tensor on a CUDA device launches the kernel or raises.  Nothing falls
back.  ``bsr_spmv.launches`` counts kernel launches (never plain calls).
A call made while a CUDA graph captures the stream launches nothing: it
adds a kernel node to the graph, which each replay launches, so it does
not count; a profiler's trace records the replayed launches.  The first
call on a device raises the kernel's shared-memory limit there
(``bsr_spmv_init``), so it must not be made under capture.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from .._build import Built, load_library
from .ref import bsr_spmv_ref
from .semiring import get_semiring

SOURCE = pathlib.Path(__file__).with_name("csrc") / "bsr_spmv.cu"

#: the largest block the kernel takes: at one row a tile, two stages of a
#: row and its x slice fit a block's shared memory at far larger bm
MAX_BLOCK_SIZE = 1536

#: storage dtype -> C entry point of its kernel instance
ENTRY_POINTS = {torch.float32: "bsr_spmv_f32", torch.bfloat16: "bsr_spmv_bf16",
                torch.float16: "bsr_spmv_f16"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: CUDA's limit on the grid's x dimension (one CTA a tile)
MAX_GRID_X = 2 ** 31 - 1

#: consumer threads a CTA at most (rows × lanes a row: the kernel's launch
#: bounds), and lanes a row
MAX_CONSUMERS = 128
LANES = (4, 2, 1)
#: what a plan aims at: ~16 KB of blocks a stage, ~64 KB a ring, 2 to 8
#: stages (tools/sweep_bsr_spmv.py; PERF.md)
STAGE_BYTES = 16 * 1024
RING_BYTES = 64 * 1024
MIN_STAGES = 2
MAX_STAGES = 8
#: the two mbarriers (full, empty) of a stage, after the last stage
BARRIER_BYTES = 16


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A launch of the kernel and its ring's layout: ``rows`` of a
    block-row a CTA, ``lanes`` threads an output row, ``stages`` stages
    ``stage_bytes`` apart, each the tile's slab and, ``x_offset`` bytes
    in, its x slice, the stages' barriers after the last one; ``smem``
    bytes of dynamic shared memory, ``threads`` a CTA (the consumers and
    one producer warp), ``mode`` ``"bulk"`` or ``"loads"``, and ``grid``
    CTAs for ``p·R`` block-rows."""

    rows: int
    lanes: int
    stages: int
    x_offset: int
    stage_bytes: int
    smem: int
    threads: int
    mode: str
    grid: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _stage_bytes(rows: int, row_bytes: int) -> int:
    return _round_up(_round_up(rows * row_bytes, 16) + row_bytes, 128)


def plan_tiles(bm: int, dtype: torch.dtype, smem_limit: int, *, p: int = 1,
               R: int = 1, rows: int | None = None, stages: int | None = None,
               aligned: bool = True) -> TilePlan:
    """The tile plan for blocks of ``bm`` in ``dtype``, for ``p · R``
    block-rows, where a block may use ``smem_limit`` bytes of shared
    memory.  It alone lays out the ring; the kernel takes the layout as
    launch arguments and refuses one that does not hold a stage's data.

    Rows a tile: a power of two near ``STAGE_BYTES`` of blocks, at most bm;
    lanes a row: the most of 4, 2, 1 that keep ``rows · lanes`` within
    ``MAX_CONSUMERS`` and divide a row's 16-byte vectors; stages: about
    ``RING_BYTES`` a ring, ``MIN_STAGES`` to ``MAX_STAGES``; then stages
    and rows shrink until the ring fits ``smem_limit``.  ``rows`` and
    ``stages`` override the choice (the sweep's knobs).  Mode ``"bulk"``
    where a block row is a multiple of 16 bytes and ``aligned`` (``blocks``
    and ``x`` 16-byte aligned), else ``"loads"``."""
    if dtype not in ENTRY_POINTS:
        raise TypeError(f"bsr_spmv has no {dtype} instance")
    if not 1 <= bm <= MAX_BLOCK_SIZE:
        raise ValueError(f"need 1 <= bm <= {MAX_BLOCK_SIZE}, got {bm}")
    row_bytes = bm * dtype.itemsize
    vec = row_bytes % 16 == 0
    units = row_bytes // 16 if vec else bm
    want_rows = rows is None
    if want_rows:
        rows = min(bm, 1 << max(0, (STAGE_BYTES // row_bytes).bit_length() - 1))
    if not 1 <= rows <= bm:
        raise ValueError(f"rows must lie in [1, {bm}], got {rows}")
    want_stages = stages is None
    if want_stages:
        stages = min(MAX_STAGES, max(MIN_STAGES, -(-RING_BYTES // _stage_bytes(
            rows, row_bytes))))
    if not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"stages must lie in [1, {MAX_STAGES}], got {stages}")

    def smem(r: int, s: int) -> int:
        return s * (_stage_bytes(r, row_bytes) + BARRIER_BYTES)
    while smem(rows, stages) > smem_limit and want_stages \
            and stages > MIN_STAGES:
        stages -= 1
    while smem(rows, stages) > smem_limit and want_rows and rows > 1:
        rows //= 2
    if smem(rows, stages) > smem_limit:
        raise ValueError(f"bsr_spmv: {stages} stages of {rows} rows at "
                         f"bm={bm} in {dtype} need {smem(rows, stages)} "
                         f"bytes of shared memory, more than {smem_limit}")
    lanes = next(n for n in LANES if n == 1 or (
        vec and rows * n <= MAX_CONSUMERS and units % n == 0))
    if rows * lanes > MAX_CONSUMERS:
        raise ValueError(f"rows must be at most {MAX_CONSUMERS}, got {rows}")
    return TilePlan(rows=rows, lanes=lanes, stages=stages,
                    x_offset=_round_up(rows * row_bytes, 16),
                    stage_bytes=_stage_bytes(rows, row_bytes),
                    smem=smem(rows, stages),
                    threads=_round_up(rows * lanes, 32) + 32,
                    mode="bulk" if vec and aligned else "loads",
                    grid=p * R * -(-bm // rows))


@functools.cache
def build() -> Built:
    """Compile (at first use) and load the kernel library, and raise its
    shared-memory limit on the current device."""
    built = load_library(SOURCE)
    for name in ENTRY_POINTS.values():
        fn = getattr(built.lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 \
            + [ctypes.c_void_p] + [ctypes.c_int64] * 8
        fn.restype = ctypes.c_int
    built.lib.bsr_spmv_init.argtypes = [ctypes.POINTER(ctypes.c_int)]
    built.lib.bsr_spmv_init.restype = ctypes.c_int
    occ = built.lib.bsr_spmv_occupancy
    occ.argtypes = [ctypes.c_int] + [ctypes.c_int64] * 4 \
        + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    built.lib.bsr_spmv_error_string.argtypes = [ctypes.c_int]
    built.lib.bsr_spmv_error_string.restype = ctypes.c_char_p
    _init(built, torch.cuda.current_device())
    return built


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"bsr_spmv {what} failed: "
                           f"{lib.bsr_spmv_error_string(err).decode()}")


#: device index -> the shared memory a block may opt into there
_SMEM_LIMITS: dict = {}


def _init(built: Built, index: int) -> None:
    """Raise the kernel's shared-memory limit on device ``index`` and keep
    the limit, once; never under a CUDA graph's capture."""
    if index in _SMEM_LIMITS:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"bsr_spmv: the first call on cuda:{index} must "
                           f"not be under a CUDA graph's capture: it raises "
                           f"the kernel's shared-memory limit there")
    limit = ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise(built.lib, built.lib.bsr_spmv_init(ctypes.byref(limit)),
               "init")
    _SMEM_LIMITS[index] = limit.value


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _ready(device: torch.device):
    """The library, its limit raised on ``device``."""
    built = build()
    _init(built, _index(device))
    return built.lib


def smem_limit(device: torch.device) -> int:
    """The dynamic shared memory a block of the kernel may use on
    ``device``, as the device reports it."""
    _ready(device)
    return _SMEM_LIMITS[_index(device)]


@functools.cache
def occupancy(device: torch.device, dtype: torch.dtype, semiring: str,
              bm: int, plan: TilePlan) -> int:
    """CTAs of a launch with ``plan`` that one SM of ``device`` holds at
    once, as the CUDA runtime reports it for the instance, block and
    shared memory the launch uses."""
    lib = _ready(device)
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.bsr_spmv_occupancy(_DTYPE_CODES[dtype],
                                     get_semiring(semiring).code, bm,
                                     plan.threads, plan.smem,
                                     ctypes.byref(ctas))
    _raise(lib, err, "occupancy query")
    return ctas.value


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


def launch_plan(cols: torch.Tensor, blocks: torch.Tensor,
                x: torch.Tensor) -> TilePlan:
    """The plan ``bsr_spmv`` launches with for these CUDA tensors (with a
    machine axis): bulk mode only where ``blocks`` and ``x`` are 16-byte
    aligned."""
    p, R, _ = cols.shape
    aligned = blocks.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    return plan_tiles(blocks.shape[-1], x.dtype, smem_limit(x.device), p=p,
                      R=R, aligned=aligned)


def launch(cols: torch.Tensor, blocks: torch.Tensor, x: torch.Tensor,
           semiring: str, plan: TilePlan) -> torch.Tensor:
    """Launch the kernel with ``plan`` on CUDA tensors with a machine axis
    (checked by the caller); returns y.  Counts nothing."""
    p, R, K = cols.shape
    bm = blocks.shape[-1]
    if plan.grid > MAX_GRID_X:
        raise ValueError(f"bsr_spmv kernel takes at most {MAX_GRID_X} tiles, "
                         f"got {plan.grid}")
    lib = _ready(x.device)
    y = torch.empty((p, R * bm), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, ENTRY_POINTS[x.dtype])(
            cols.data_ptr(), blocks.data_ptr(), x.data_ptr(), y.data_ptr(),
            p, R, K, x.shape[-1] // bm, bm, get_semiring(semiring).code,
            stream, plan.rows, plan.lanes, plan.stages,
            int(plan.mode == "bulk"), plan.x_offset, plan.stage_bytes,
            plan.threads, plan.smem)
    _raise(lib, err, "kernel launch")
    return y


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
    y = launch(cols, blocks, x, sr.name, launch_plan(cols, blocks, x))
    if not torch.cuda.is_current_stream_capturing():
        bsr_spmv.launches += 1
    return y if batched else y[0]


bsr_spmv.launches = 0
