"""GQA flash-decode attention: wrapper of the hand-written CUDA kernel.

Replaces ``src/repro/kernels/decode_attn/kernel.py::decode_attn_pallas``
and its batched wrapper ``ops.py::decode_attention``.  The reference's
``vmap`` over the batch is the grid's z dimension here, and its additive
bias is computed in the kernel from ``lengths`` on the device.

Layouts: q ``(B, H, dh)``; k, v ``(B, Smax, KVH, dh)`` (one layer of the
decode cache); lengths ``(B,)`` valid KV prefix, or None for all of Smax.
float32 or bfloat16, all three alike; the output has q's dtype.

The kernel (``csrc/decode_attn.cu``; bf16 with G <= 8 runs q·Kᵀ on the
tensor cores) splits S over CTAs and the last CTA of each (sequence, KV
head) merges the partial softmax states, in one launch.  ``plan_splits``
sizes the splits from Smax, the card's SM count and the CTAs an SM holds
(which the library reports for its own launch), so the grid is about one
wave; the scratch for the partials and the per-(sequence, KV head)
tickets are allocated here.
``lengths`` stays on the device: the wrapper never reads it on the host,
so a decode step makes no host sync.

A tensor on the CPU goes to the plain version (``ref.decode_attention_ref``);
a tensor on a CUDA device launches the kernel or raises.  Nothing falls
back.  ``decode_attention.launches`` counts kernel launches (one per call),
never plain calls.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .._build import Built, load_library
from .ref import decode_attention_ref

SOURCE = pathlib.Path(__file__).with_name("csrc") / "decode_attn.cu"

#: KV positions a tile of the kernel; every split is a multiple of it
TILE = 32

#: the kernel keeps dh/32 accumulators a lane and one warp per query head
HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 32
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535

#: CTAs an SM the split plan aims at (at most what an SM holds): on an
#: H100 3 beat filling every slot at the serving shape, and at longer
#: caches the split count moves the time by under 2 %
#: (tools/sweep_decode_attn.py; PERF.md)
CTAS_PER_SM = 3

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def build() -> Built:
    """Compile (at first use) and load the kernel library."""
    built = load_library(SOURCE)
    fn = built.lib.decode_attn
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 \
        + [ctypes.c_int64] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = built.lib.decode_attn_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    built.lib.decode_attn_error_string.argtypes = [ctypes.c_int]
    built.lib.decode_attn_error_string.restype = ctypes.c_char_p
    return built


def plan_splits(smax: int, rows: int, sms: int,
                per_sm: int) -> tuple[int, int]:
    """(split_len, nsplit) for ``rows`` = B·KVH sequences × KV heads over
    ``smax`` positions on a card of ``sms`` SMs that each hold ``per_sm``
    of the kernel's CTAs at once.

    Each (b, kvh) gets ``max(1, slots // rows)`` splits or fewer, each a
    whole number of 32-position tiles, where ``slots`` is
    ``min(per_sm, CTAS_PER_SM)`` CTAs an SM: the grid of ``rows · nsplit``
    CTAs is at most one wave (or ``rows`` CTAs where that exceeds it)."""
    if min(smax, rows, sms, per_sm) < 1:
        raise ValueError(f"need smax, rows, sms, per_sm >= 1; got {smax}, "
                         f"{rows}, {sms}, {per_sm}")
    want = max(1, sms * min(per_sm, CTAS_PER_SM) // rows)
    tiles = -(-smax // TILE)
    split_len = -(-tiles // want) * TILE
    return split_len, -(-smax // split_len)


@functools.cache
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def occupancy(device: torch.device, dtype: torch.dtype, dh: int,
              group: int) -> int:
    """CTAs of the kernel's launch for (dtype, dh, G) that one SM of
    ``device`` holds at once, as the CUDA runtime reports it for the
    kernel, block and shared memory the launch uses."""
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build().lib.decode_attn_occupancy(_DTYPE_CODES[dtype], dh,
                                                group, ctypes.byref(ctas))
    if err != 0 or ctas.value < 1:
        raise RuntimeError(f"decode_attn occupancy query failed (error {err},"
                           f" {ctas.value} CTAs an SM) for {dtype}, dh={dh},"
                           f" G={group}")
    return ctas.value


def plan(q: torch.Tensor, k: torch.Tensor) -> dict:
    """The launch ``decode_attention`` makes for these q and k on their
    CUDA device: split length, splits, CTAs, and the card's SMs and the
    CTAs an SM holds."""
    B, H, dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    sms = _num_sms(q.device)
    per_sm = occupancy(q.device, q.dtype, dh, H // KVH)
    split_len, nsplit = plan_splits(S, B * KVH, sms, per_sm)
    return {"split_len": split_len, "nsplit": nsplit,
            "ctas": B * KVH * nsplit, "sms": sms, "per_sm": per_sm}


_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 tickets, one per (b, kvh), kept per device and stream:
    the kernel's last CTA of each (b, kvh) sets its ticket back to 0, so
    calls in order on one stream reuse them without a memset."""
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B,H,dh) and k, v (B,S,KVH,dh) alike; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or k.shape[1] == 0 \
            or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}"
                         f" (same B and dh, S >= 1, H a multiple of KVH)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share a device")
    if lengths is not None and (lengths.shape != (B,)
                                or lengths.device != q.device
                                or lengths.dtype.is_floating_point):
        raise ValueError(f"lengths must be an integer (B,) tensor on "
                         f"{q.device}, got {tuple(lengths.shape)} "
                         f"{lengths.dtype} on {lengths.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Batched GQA decode attention (see module docstring) -> (B, H, dh)."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on 'cpu' or 'cuda', got "
                         f"{q.device}")
    B, H, dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if dh not in HEAD_DIMS or G > MAX_GROUP or B > MAX_GRID_YZ \
            or KVH > MAX_GRID_YZ:
        raise ValueError(f"decode_attention kernel takes dh in {HEAD_DIMS}, "
                         f"H/KVH <= {MAX_GROUP}, B and KVH <= {MAX_GRID_YZ}; "
                         f"got dh={dh}, G={G}, B={B}, KVH={KVH}")
    if not (k.is_contiguous() and v.is_contiguous()) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be contiguous and 16-byte aligned")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
    launch = plan(q, k)
    split_len, nsplit = launch["split_len"], launch["nsplit"]
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((B, H, nsplit), **f32)
    part_l = torch.empty((B, H, nsplit), **f32)
    part_acc = torch.empty((B, H, nsplit, dh), **f32)
    out = torch.empty_like(q)
    lib = build().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counters(q.device, stream, B * KVH)
        err = lib.decode_attn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            counters.data_ptr(), out.data_ptr(), B, S, KVH, G, dh, split_len,
            1.0 / dh ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: "
                           f"{lib.decode_attn_error_string(err).decode()}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
