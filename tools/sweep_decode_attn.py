#!/usr/bin/env python3
"""Sweep ``decode_attn``'s split count over cache lengths and layouts.

    python3 tools/sweep_decode_attn.py

Builds ``decode_attn.cu`` as the port does, then times it at qwen3-4b's
serving widths (B 8, 32/8 heads, dh 128, bf16) at Smax 2113 (lengths
2049-2112, the serving shape) and at Smax 8192, 16384 and 32768 (full
lengths), for 2 to 8 splits a (b, KV head), beside
``F.scaled_dot_product_attention`` on the same inputs.  At 16384 and
32768 it also times the same bytes and heads-per-KV-head with one KV head
and B 64 (4 query heads): each KV head's rows are then contiguous in the
cache instead of ``KVH · dh`` elements apart.  Times are CUDA events
around 100 back-to-back calls, the best of 5 (the kernel is called through
its C entry, so the host issues a call in a few microseconds).  Every
output is held against the plain version at the bf16 tolerance of
``chip_smoke.py``.  Prints the card and one JSON object with, per case,
the split count ``plan_splits`` picks.  Nothing of the port calls this
script: it shows how that choice compares with its neighbours, and how
the layout moves the streaming rate.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.decode_attn import kernel as K  # noqa: E402
from repro_torch.kernels.decode_attn.ref import decode_attention_ref  # noqa: E402

#: (B, KVH, Smax): qwen3-4b's B and KV heads, then one KV head over the
#: same bytes
CASES = ((8, 8, 2113), (8, 8, 8192), (8, 8, 16384), (8, 8, 32768),
         (64, 1, 16384), (64, 1, 32768))
G = 4
SPLITS = range(2, 9)
TOL = dict(rtol=2 ** -7, atol=1e-4)


def best_ms(fn, reps: int = 100) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return min(out)


def caller(lib, q, k, v, lengths, split_len):
    B, H, dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    nsplit = -(-S // split_len)
    part_m = torch.empty((B, H, nsplit), device="cuda")
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, nsplit, dh), device="cuda")
    out = torch.empty_like(q)
    counters = torch.zeros(B * KVH, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.decode_attn(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            counters.data_ptr(), out.data_ptr(), B, S, KVH, H // KVH, dh,
            split_len, 1.0 / dh ** 0.5, stream)
        if err:
            raise RuntimeError(f"decode_attn launch failed ({err})")
    return call, out


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_decode_attn: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    lib = K.build().lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for B, KVH, S in CASES:
        lengths = (torch.randint(2049, 2113, (B,), generator=gen,
                                 device="cuda", dtype=torch.int32)
                   if S == 2113 else torch.full((B,), S, device="cuda",
                                                dtype=torch.int32))
        q = torch.randn((B, KVH * G, 128), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((B, S, KVH, 128), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((B, S, KVH, 128), generator=gen,
                        device="cuda").bfloat16()
        want = decode_attention_ref(q, k, v, lengths).float()
        mask = (torch.arange(S, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        row = {"sdpa_ms": best_ms(sdpa),
               "planned_splits": K.plan(q, k)["nsplit"], "ms": {}}
        for nsplit in SPLITS:
            per = -(-S // nsplit)
            split_len = -(-per // K.TILE) * K.TILE
            call, out = caller(lib, q, k, v, lengths, split_len)
            call()
            torch.testing.assert_close(out.float(), want, **TOL)
            row["ms"][f"splits{-(-S // split_len)}"] = best_ms(call)
        row["sdpa_ms_again"] = best_ms(sdpa)
        result[f"B{B}_KVH{KVH}_S{S}"] = row
        del q, k, v, want, mask
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
