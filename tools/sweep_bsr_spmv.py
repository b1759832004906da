#!/usr/bin/env python3
"""Sweep ``bsr_spmv``'s tile rows and ring stages at the graph path's shape.

    python3 tools/sweep_bsr_spmv.py [--rows 16,32,64,128] [--stages 2,3,4,6,8]

Builds ``bsr_spmv.cu`` as the port does, then, on a random Block-ELL layout
of the graph path's shape (p 9, R = K = C = 251, bm 128: 37.2 GB of blocks
in float32, 18.6 GB in bfloat16), times the kernel's (+,×) instance with
the plan ``plan_tiles`` picks and with every (rows, stages) of the grid
that fits a block's shared memory, each passed to the kernel as launch
arguments (``kernel.launch``); then the (min,+) instance on the same bytes
with the picked plan, and ``torch.matmul`` over the ELL slots in the same
dtype, the yardstick ``chip_smoke.py`` times.  Float32 first, then the same
layout rounded to bfloat16.  Times are CUDA events around 5 back-to-back
calls, the best of 3.  Every plan's output is held against the plain version's as
``chip_smoke.py`` holds it: float32 at rtol 1e-5, bfloat16 inside
``plus_times_bounds``.  Prints the card's name and power limit and one
JSON object: per layout, each plan's ms, its share of the bytes bound, the
CTAs an SM holds (``bsr_spmv_occupancy``) and the waves of its grid.
Nothing of the port calls this script.
"""
from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.bsr_spmv import bsr_spmv_ref, plus_times_bounds  # noqa: E402
from repro_torch.kernels.bsr_spmv import kernel as K  # noqa: E402

P, R, BM = 9, 251, 128     # the large layout's shape
HBM_BYTES_PER_S = 3.35e12


def best_ms(fn, reps: int = 5, tries: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return min(out)


def held(y, want, bounds) -> bool:
    if bounds is None:
        return bool(torch.allclose(y, want, rtol=1e-5, atol=0.0))
    lo, hi = bounds
    return bool(((lo <= y) & (y <= hi)).all())


def sweep(cols, blocks, x, rows_grid, stages_grid) -> dict:
    dtype = x.dtype
    p, r, _ = cols.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = bsr_spmv_ref(cols, blocks, x)
    bounds = None if dtype == torch.float32 else plus_times_bounds(cols, blocks,
                                                                   x)
    nbytes = (blocks.numel() * blocks.element_size() + 4 * cols.numel()
              + (x.numel() + p * r * BM) * x.element_size())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    picked = K.launch_plan(cols, blocks, x)
    plans = [picked]
    limit = K.smem_limit(x.device)
    for rows, stages in itertools.product(rows_grid, stages_grid):
        try:
            plans.append(K.plan_tiles(BM, dtype, limit, p=p, R=r, rows=rows,
                                      stages=stages))
        except ValueError:          # its ring exceeds a block's limit
            pass
    out = []
    for plan in plans:
        y = K.launch(cols, blocks, x, "plus_times", plan)
        ms = best_ms(lambda: K.launch(cols, blocks, x, "plus_times", plan))
        per_sm = K.occupancy(x.device, dtype, "plus_times", BM, plan)
        out.append({"rows": plan.rows, "lanes": plan.lanes,
                    "stages": plan.stages, "smem": plan.smem,
                    "threads": plan.threads, "grid": plan.grid,
                    "ctas_per_sm": per_sm,
                    "waves": plan.grid / (sms * per_sm),
                    "ms": ms, "share_of_bound": bound_ms / ms,
                    "held": held(y, want, bounds)})
        print(json.dumps({str(dtype): out[-1]}), file=sys.stderr, flush=True)
    min_plus_ms = best_ms(lambda: K.launch(cols, blocks, x, "min_plus",
                                           picked))
    xg = x.view(p, -1, BM)[torch.arange(p, device="cuda")[:, None, None],
                           cols.long()]
    flat = blocks.view(-1, BM, BM)
    library_ms = best_ms(lambda: torch.matmul(flat, xg.view(-1, BM, 1)).view(
        *cols.shape, BM).sum(dim=2))
    return {"bound_ms": bound_ms, "picked": out[0], "plans": out[1:],
            "min_plus_ms_picked_plan": min_plus_ms,
            "library_ms": library_ms,
            "all_held": all(row["held"] for row in out)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="16,32,64,128")
    ap.add_argument("--stages", default="2,3,4,6,8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_bsr_spmv: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    rows_grid = [int(v) for v in args.rows.split(",")]
    stages_grid = [int(v) for v in args.stages.split(",")]
    K.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cols = torch.randint(0, R, (P, R, R), generator=gen, device="cuda",
                         dtype=torch.int32)
    blocks = torch.rand((P, R, R, BM, BM), generator=gen, device="cuda")
    x = torch.rand((P, R * BM), generator=gen, device="cuda")
    result = {"card": smi, "shape": {"p": P, "R": R, "K": R, "C": R,
                                     "bm": BM}}
    result["float32"] = sweep(cols, blocks, x, rows_grid, stages_grid)
    blocks = blocks.to(torch.bfloat16)
    torch.cuda.empty_cache()
    result["bfloat16"] = sweep(cols, blocks, x.to(torch.bfloat16), rows_grid,
                               stages_grid)
    print(json.dumps(result))
    return 0 if result["float32"]["all_held"] \
        and result["bfloat16"]["all_held"] else 1


if __name__ == "__main__":
    sys.exit(main())
