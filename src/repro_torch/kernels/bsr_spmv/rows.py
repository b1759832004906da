"""Row-layout semiring SpMV: the layout's packer, the wrapper of its
hand-written CUDA kernel, and the kernel's plain version.

``y[m, r] = ⊕_{(c, a) in row r of machine m} a ⊗ x[m, c]`` over per-machine
rows whose bytes follow the edges: (column id, value) pairs, int32 and the
message dtype, and a table of work units (``csrc/bsr_spmv_rows.cu`` says
what each kind reads).  Shapes:

* ``units``  ``(U, 4)``  int32: entry offset (low, high word), first row as
  ``m·n + r``, kind in the top two bits of the last word and a length
* ``cols``   ``(N,)``    int32 column ids (``-1``: a slice's padding)
* ``vals``   ``(N,)``    message dtype
* ``x``      ``(p, n)``  message dtype; ``y`` the same

``block_size`` is the column group of 16-bit (+, ×): each group's entries
are summed in float32 and the sum is rounded once and folded into ``y`` in
ascending group order, the dense kernel's slot (``ref.plus_times_bounds``
holds both).  The layout's ``block_size`` is that of the dense layout it
equals (``bsp/partition_runtime.py``'s ``LocalRows``).

A tensor on the CPU goes to the plain version (``bsr_spmv_rows_ref``); a
tensor on a CUDA device launches the kernel or raises.  Nothing falls back.
``bsr_spmv_rows.launches`` counts kernel launches, never plain calls, and
not a call under a CUDA graph's capture (which adds a node that each replay
launches).  The first call on a device loads the kernel there
(``bsr_spmv_rows_init``), so it must not be made under capture.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np
import torch

from .._build import Built, load_library
from .semiring import get_semiring

SOURCE = pathlib.Path(__file__).with_name("csrc") / "bsr_spmv_rows.cu"

#: storage dtype -> C entry point of its kernel instance
ENTRY_POINTS = {torch.float32: "bsr_spmv_rows_f32",
                torch.bfloat16: "bsr_spmv_rows_bf16",
                torch.float16: "bsr_spmv_rows_f16"}

#: unit kinds (the top two bits of a unit's last word)
SLICE, ROW, CTA, FILL = 0, 1, 2, 3
#: rows of a slice (a lane each), and the longest row a slice takes
SLICE_ROWS = 32
#: warps of a CTA: a CTA row's unit is repeated this often in the table
CTA_WARPS = 8
#: rows longer than this are a CTA's, the rest of the long prefix a warp's
CTA_MIN = 256
#: rows of a FILL unit at most
FILL_ROWS = 1024
LEN_BITS = 30


def pack_rows(machines: list, n: int, absent: float):
    """The layout of per-machine rows over ``n`` row and column ids.

    ``machines[m]`` is ``(rows, cols, vals)`` of machine m's entries in
    ascending (row, col), one entry a cell, ``vals`` float32.  Rows up to
    the last one longer than ``SLICE_ROWS`` are a warp's (a CTA's above
    ``CTA_MIN``) and stored in order; the rest up to the last nonempty row
    go in slices of ``SLICE_ROWS``, column-major, padded with column -1
    and ``absent``; the empty rows after them in FILL units.  Units come
    longest first: CTA rows, warp rows, slices, fills.

    Returns ``(units (U, 4) int32, cols (N,) int32, vals (N,) float32,
    stats)``, ``stats`` a dict a machine."""
    if len(machines) * n >= 2 ** 31:
        raise ValueError(f"{len(machines)} machines of {n} rows exceed the "
                         f"units' int32 row ids")

    def unit(start, row, length, kind):
        if (length >= 1 << LEN_BITS).any():
            raise ValueError(f"a unit of {int(length.max())} entries or rows "
                             f"exceeds its {LEN_BITS} bits")
        return np.stack([start, row, length | (kind << LEN_BITS)], axis=1)

    cta, warp, slices, fills = [], [], [], []
    col_parts, val_parts, stats = [], [], []
    off = 0
    for m, (r, c, v) in enumerate(machines):
        r = np.asarray(r, dtype=np.int64)
        ln = np.bincount(r, minlength=n)
        ptr = np.concatenate([[0], np.cumsum(ln)])
        nonempty = np.flatnonzero(ln)
        used = int(nonempty[-1]) + 1 if len(nonempty) else 0
        long_ = np.flatnonzero(ln > SLICE_ROWS)
        h = int(long_[-1]) + 1 if len(long_) else 0
        base = m * n
        # the long prefix, row-major as given
        heads = np.arange(h)
        big = ln[:h] > CTA_MIN
        cta.append(unit(off + ptr[:h][big], base + heads[big], ln[:h][big],
                        CTA))
        warp.append(unit(off + ptr[:h][~big], base + heads[~big],
                         ln[:h][~big], ROW))
        # slices: rows [h, h + 32·ns), entry k of lane l at 32·k + l
        ns = -(-(used - h) // SLICE_ROWS) if used > h else 0
        lens = np.zeros(ns * SLICE_ROWS, dtype=np.int64)
        lens[:min(len(lens), n - h)] = ln[h:h + len(lens)]
        width = lens.reshape(ns, SLICE_ROWS).max(axis=1, initial=0)
        start = ptr[h] + SLICE_ROWS * np.concatenate([[0], np.cumsum(width)])
        slices.append(unit(off + start[:-1],
                           base + h + SLICE_ROWS * np.arange(ns), width,
                           SLICE))
        size = int(start[-1])
        cols_m = np.full(size, -1, dtype=np.int32)
        vals_m = np.full(size, absent, dtype=np.float32)
        cols_m[:ptr[h]] = c[:ptr[h]]
        vals_m[:ptr[h]] = v[:ptr[h]]
        light = np.arange(ptr[h], len(r))
        rr = r[light] - h
        pos = start[rr // SLICE_ROWS] + SLICE_ROWS * (
            light - ptr[r[light]]) + rr % SLICE_ROWS
        cols_m[pos] = c[light]
        vals_m[pos] = v[light]
        # the empty rows after the slices
        first = min(h + ns * SLICE_ROWS, n)
        f0 = np.arange(first, n, FILL_ROWS)
        fills.append(unit(np.zeros_like(f0), base + f0,
                          np.minimum(FILL_ROWS, n - f0), FILL))
        col_parts.append(cols_m)
        val_parts.append(vals_m)
        off += size
        stats.append({"entries": len(r), "rows": used,
                      "warp_rows": int((~big).sum()),
                      "cta_rows": int(big.sum()), "slices": ns,
                      "slice_rows": min(ns * SLICE_ROWS, n - h),
                      "padded_cells": size - len(r),
                      "fill_rows": n - first})
    cta = np.concatenate(cta)
    cta = np.repeat(cta[np.argsort(-cta[:, 2], kind="stable")], CTA_WARPS,
                    axis=0)
    warp = np.concatenate(warp)
    warp = warp[np.argsort(-warp[:, 2], kind="stable")]
    table = np.concatenate([cta, warp] + slices + fills).astype(np.int64)
    units = np.stack([table[:, 0] & 0xFFFFFFFF, table[:, 0] >> 32,
                      table[:, 1], table[:, 2]], axis=1)
    units = units.astype(np.uint32).view(np.int32)
    return (units, np.concatenate(col_parts), np.concatenate(val_parts),
            tuple(stats))


def unit_entries(units: torch.Tensor, n: int):
    """Each stored entry's position in ``cols``/``vals`` and its row (as
    ``m·n + r``), from the units table, padding included; int64, on the
    table's device."""
    u = units.long()
    off = (u[:, 0] & 0xFFFFFFFF) | (u[:, 1] << 32)
    row, word = u[:, 2], u[:, 3] & 0xFFFFFFFF
    kind, length = word >> LEN_BITS, word & ((1 << LEN_BITS) - 1)
    first = torch.ones_like(kind, dtype=torch.bool)
    first[1:] = (u[1:] != u[:-1]).any(dim=1)       # a CTA row once
    rows = ((kind == ROW) | (kind == CTA)) & first
    sl = kind == SLICE
    cells = torch.where(rows, length, torch.where(sl, SLICE_ROWS * length, 0))
    owner = torch.repeat_interleave(torch.arange(len(u), device=u.device),
                                    cells)
    k = torch.arange(len(owner), device=u.device) - torch.repeat_interleave(
        torch.cumsum(cells, 0) - cells, cells)
    pos = off[owner] + k
    lane = torch.where(sl[owner], k % SLICE_ROWS, 0)
    return pos, row[owner] + lane


def _stored(units: torch.Tensor, cols: torch.Tensor, n: int):
    """``unit_entries`` without the padding, and each entry's column."""
    pos, row = unit_entries(units, n)
    c = cols[pos].long()
    keep = c >= 0
    return pos[keep], row[keep], c[keep]


def _groups(row: torch.Tensor, c: torch.Tensor, n: int, bm: int):
    """The entries' order by (row, column group), each entry's group among
    the groups present in that order, and each group's row."""
    groups = -(-n // bm)
    key = row * groups + c // bm
    order = torch.argsort(key, stable=True)
    seg, inv = torch.unique_consecutive(key[order], return_inverse=True)
    return order, inv, seg // groups


def bsr_spmv_rows_ref(units: torch.Tensor, cols: torch.Tensor,
                      vals: torch.Tensor, x: torch.Tensor,
                      semiring: str = "plus_times",
                      block_size: int = 128) -> torch.Tensor:
    """The plain version of ``bsr_spmv_rows``: the same products and the
    same rounding contract, with float32 sums in another order.

    Under (min, +) and (or, and) each row's ⊕ of its float32 products is
    rounded once to ``x.dtype`` (bitwise the kernel's); float32 (+, ×)
    sums each row in float32; 16-bit (+, ×) sums each column group in
    float32, rounds it once and folds the groups into ``y`` in ascending
    order."""
    sr = get_semiring(semiring)
    p, n = x.shape
    pos, row, c = _stored(units, cols, n)
    xf = x.reshape(-1).float()
    prod = sr.times(vals[pos].float(), xf[row // n * n + c])
    y = torch.full((p * n,), sr.zero, dtype=torch.float32, device=x.device)
    if sr.name != "plus_times":
        y.scatter_reduce_(0, row, prod, sr.reduce, include_self=True)
        return y.to(x.dtype).view(p, n)
    if x.dtype == torch.float32:
        return y.index_add_(0, row, prod).view(p, n)
    order, inv, seg_row = _groups(row, c, n, block_size)
    sums = torch.zeros(len(seg_row), dtype=torch.float32, device=x.device)
    sums.index_add_(0, inv, prod[order])
    return _fold(seg_row, sums.to(x.dtype), p * n).view(p, n)


def plus_times_bounds_rows(units: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor, x: torch.Tensor,
                           block_size: int = 128
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` in ``x.dtype``, shaped as ``x``: the least and the
    largest ``y`` that the 16-bit (+, ×) contract admits on finite inputs,
    whatever order each column group's float32 sum takes: the bounds of
    ``ref.plus_times_bounds`` on the row layout (a group holds at most
    ``block_size`` entries, as a dense slot's row does), for layouts whose
    dense counterpart is too large to build."""
    p, n = x.shape
    bm = int(block_size)
    pos, row, c = _stored(units, cols, n)
    prod = vals[pos].double() * x.reshape(-1).double()[row // n * n + c]
    order, inv, seg_row = _groups(row, c, n, bm)
    exact = torch.zeros(len(seg_row), dtype=torch.float64, device=x.device)
    absum = torch.zeros_like(exact)
    exact.index_add_(0, inv, prod[order])
    absum.index_add_(0, inv, prod[order].abs())
    u = 2.0 ** -24
    err = (bm * u / (1 - bm * u) + bm * 2.0 ** -52) * absum \
        + bm * 2.0 ** -150 * (absum > 0)
    return tuple(_fold(seg_row, s.to(x.dtype), p * n).view(p, n)
                 for s in (exact - err, exact + err))


def _fold(seg_row: torch.Tensor, sums: torch.Tensor, rows: int
          ) -> torch.Tensor:
    """``rows`` values of ``sums.dtype``, 0 where no group lands, each the
    fold of its groups' ``sums`` (ascending ``seg_row``, a row's groups in
    ascending order) with one rounding a fold."""
    y = torch.zeros(rows, dtype=sums.dtype, device=sums.device)
    starts = torch.ones_like(seg_row, dtype=torch.bool)
    starts[1:] = seg_row[1:] != seg_row[:-1]
    nth = torch.arange(len(seg_row), device=sums.device)
    nth = nth - torch.cummax(torch.where(starts, nth, 0), 0).values
    for k in range(int(nth.max()) + 1 if len(nth) else 0):
        at = nth == k
        y[seg_row[at]] = (y[seg_row[at]].float()
                          + sums[at].float()).to(sums.dtype)
    return y


@functools.cache
def build() -> Built:
    """Compile (at first use) and load the kernel library."""
    built = load_library(SOURCE)
    for name in ENTRY_POINTS.values():
        fn = getattr(built.lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64] \
            + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    built.lib.bsr_spmv_rows_init.argtypes = []
    built.lib.bsr_spmv_rows_init.restype = ctypes.c_int
    built.lib.bsr_spmv_rows_error_string.argtypes = [ctypes.c_int]
    built.lib.bsr_spmv_rows_error_string.restype = ctypes.c_char_p
    return built


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"bsr_spmv_rows {what} failed: "
                           f"{lib.bsr_spmv_rows_error_string(err).decode()}")


#: devices whose instances are loaded
_READY: set = set()


def _ready(device: torch.device):
    """The library, every instance loaded on ``device`` once; never under
    a CUDA graph's capture."""
    lib = build().lib
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _READY:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"bsr_spmv_rows: the first call on "
                               f"cuda:{index} must not be under a CUDA "
                               f"graph's capture: it loads the kernel there")
        with torch.cuda.device(index):
            _raise(lib, lib.bsr_spmv_rows_init(), "init")
        _READY.add(index)
    return lib


def _check(units, cols, vals, x) -> None:
    if not (units.device == cols.device == vals.device == x.device):
        raise ValueError(f"units, cols, vals and x must share a device, got "
                         f"{units.device}, {cols.device}, {vals.device}, "
                         f"{x.device}")
    if units.dtype != torch.int32 or units.dim() != 2 \
            or units.shape[1] != 4:
        raise ValueError(f"units must be (U, 4) int32, got "
                         f"{tuple(units.shape)} {units.dtype}")
    if cols.dtype != torch.int32 or cols.dim() != 1 \
            or vals.shape != cols.shape:
        raise ValueError(f"cols must be (N,) int32 and vals (N,), got "
                         f"{tuple(cols.shape)} {cols.dtype} and "
                         f"{tuple(vals.shape)}")
    if vals.dtype != x.dtype or x.dtype not in ENTRY_POINTS:
        raise TypeError(f"vals and x must share one dtype of "
                        f"{sorted(str(d) for d in ENTRY_POINTS)}, got "
                        f"{vals.dtype} and {x.dtype}")
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be (p, n) with n >= 1, got "
                         f"{tuple(x.shape)}")
    if not all(t.is_contiguous() for t in (units, cols, vals, x)):
        raise ValueError("units, cols, vals and x must be contiguous")


def bsr_spmv_rows(units: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor, x: torch.Tensor,
                  semiring: str = "plus_times",
                  block_size: int = 128) -> torch.Tensor:
    """``y[m, r] = ⊕ a ⊗ x[m, c]`` over row r's entries (see the module
    docstring); ``y`` is ``x``'s shape and dtype."""
    sr = get_semiring(semiring)
    _check(units, cols, vals, x)
    if x.device.type == "cpu":
        return bsr_spmv_rows_ref(units, cols, vals, x, sr, block_size)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmv_rows runs on 'cpu' or 'cuda', got "
                         f"{x.device}")
    lib = _ready(x.device)
    p, n = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, ENTRY_POINTS[x.dtype])(
            units.data_ptr(), units.shape[0], cols.data_ptr(),
            vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
            int(block_size), sr.code, stream)
    _raise(lib, err, "kernel launch")
    if not torch.cuda.is_current_stream_capturing():
        bsr_spmv_rows.launches += 1
    return y


bsr_spmv_rows.launches = 0
