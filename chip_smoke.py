#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. build the hand-written CUDA kernel (``bsr_spmv``) from the sources in
   this checkout;
2. hold the kernel against its plain PyTorch version on the card, for each
   semiring, at bm = 128 on random layouts with ELL padding slots:
   bitwise for (min,+) and (or,and), rtol=1e-5 for (+,×);
3. drive the main path through the port's CLI entry: ``graph500:16``,
   WindGP on the default cluster (3 super + 6 normal machines), PageRank
   for 20 supersteps on the ``pallas`` backend (the kernel), on ``cuda``.
   On the same runtime, the ``scatter`` backend and the float64 numpy
   oracle must agree within 1e-5·max(pr), and the PageRank mass within
   1e-5 relative;
4. time the kernel, its plain version and a library yardstick on the
   main path's layout, and the superstep of both backends.

It prints JSON lines (sizes, memory, superstep time, the kernel table
line), the ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it fails before printing any result.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet; full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12            # float32 outside the tensor cores

GRAPH = "graph500:16"
ITERS = 20
BM = 128


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call device times (ms) of ``fn()`` by CUDA events, after one
    warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def random_layout(gen, semiring, p=3, R=16, K=5, C=16, bm=BM):
    """cols/blocks/x with ELL padding slots (column 0, absent blocks)."""
    absent = float("inf") if semiring == "min_plus" else 0.0
    dev = "cuda"
    cols = torch.randint(0, C, (p, R, K), generator=gen, device=dev,
                         dtype=torch.int32)
    u = torch.rand((p, R, K, bm, bm), generator=gen, device=dev)
    keep = torch.rand((p, R, K, bm, bm), generator=gen, device=dev) < 0.3
    x = torch.rand((p, C * bm), generator=gen, device=dev)
    if semiring == "or_and":
        blocks = keep.float()
        x = (x < 0.5).float()
    elif semiring == "min_plus":
        blocks = torch.where(keep, u, float("inf"))
        x = torch.where(x < 0.2, float("inf"), x)
    else:
        blocks = torch.where(keep, u, 0.0)
    cols[:, ::2, -1] = 0
    blocks[:, ::2, -1] = absent
    return cols, blocks.contiguous(), x


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bsp import build_pagerank, pagerank, ref
    from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_ref, kernel
    from repro_torch.launch import partition as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    # -- phase 1: build --------------------------------------------------
    built = kernel.build()
    log(f"phase 1: built {built.path.name} in {built.seconds:.1f}s")
    if built.log:
        print(built.log, file=sys.stderr)

    # -- phase 2: kernel vs plain version, per semiring --------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    semiring_err = {}
    for sr in ("plus_times", "min_plus", "or_and"):
        cols, blocks, x = random_layout(gen, sr)
        got = bsr_spmv(cols, blocks, x, sr)
        want = bsr_spmv_ref(cols, blocks, x, sr)
        torch.cuda.synchronize()
        if sr == "plus_times":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
        else:
            check(torch.equal(got, want), f"{sr}: kernel != plain bitwise")
        fin = torch.isfinite(want)
        semiring_err[sr] = float((got[fin] - want[fin]).abs().max())
    log(f"phase 2: kernel == plain per semiring, max_abs_err {semiring_err}")

    # -- phase 3: the main path through the CLI entry ----------------------
    torch.cuda.reset_peak_memory_stats()
    bsr_spmv.launches = 0
    t0 = time.perf_counter()
    res = cli.run(["--graph", GRAPH, "--method", "windgp", "--pagerank",
                   "--pagerank-iters", str(ITERS), "--backend", "pallas",
                   "--device", "cuda"])
    torch.cuda.synchronize()
    launches = bsr_spmv.launches
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(launches >= 1, "the main path never launched bsr_spmv")
    g, rt, pr = res.graph, res.runtime, res.pagerank
    check(pr.shape == (g.num_vertices,) and bool(np.isfinite(pr).all()),
          "PageRank is not a finite (V,) vector")
    pr_s, _ = pagerank(rt, num_iters=ITERS, backend="scatter")
    oracle = ref.pagerank(g, num_iters=ITERS)
    scale = float(pr.max())
    d_scatter = float(np.abs(pr - pr_s).max())
    d_oracle = float(np.abs(pr - oracle).max())
    mass_rel = abs(float(pr.sum()) - float(pr_s.sum())) / float(pr_s.sum())
    check(d_scatter <= 1e-5 * scale, f"pallas vs scatter {d_scatter}")
    check(d_oracle <= 1e-5 * scale, f"pallas vs numpy oracle {d_oracle}")
    check(mass_rel <= 1e-5, f"mass differs by {mass_rel} relative")
    log(f"phase 3: main path in {main_s:.1f}s, {launches} launches, "
        f"max|d| scatter {d_scatter:.3g} oracle {d_oracle:.3g}")

    # -- phase 4: timings on the main path's layout ------------------------
    bsr = rt.local_bsr(block_size=BM, semiring="plus_times",
                       weights="weight")
    p, R, K = bsr.cols.shape
    step_ms = {}
    for backend, opts in (("pallas", {"block_size": BM}), ("scatter", {})):
        spec = build_pagerank(rt, backend=backend, **opts)
        state = [spec.state]

        def step():
            state[0], _ = spec.superstep(state[0], spec.static)
        step_ms[backend] = statistics.median(cuda_ms(step, 10))

    x = torch.rand((p, R * BM), generator=gen, device="cuda")
    y = bsr_spmv(bsr.cols, bsr.blocks, x)
    kernel_ms = statistics.median(cuda_ms(
        lambda: bsr_spmv(bsr.cols, bsr.blocks, x), 10))
    y_plain = bsr_spmv_ref(bsr.cols, bsr.blocks, x)
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-6)
    max_abs_err = float((y - y_plain).abs().max())
    plain_ms = statistics.median(cuda_ms(
        lambda: bsr_spmv_ref(bsr.cols, bsr.blocks, x), 3))
    # yardstick, never called by the port: one batched matmul over every
    # ELL slot, then the sum over K (einsum would copy the blocks)
    xg = x.view(p, R, BM)[torch.arange(p, device="cuda")[:, None, None],
                          bsr.cols.long()]
    flat_blocks = bsr.blocks.view(-1, BM, BM)

    def library():
        return torch.matmul(flat_blocks, xg.view(-1, BM, 1)).view(
            p, R, K, BM).sum(dim=2)
    torch.testing.assert_close(library().view(p, -1), y_plain, rtol=1e-5,
                               atol=1e-6)
    library_ms = statistics.median(cuda_ms(library, 10))
    nbytes = 4 * (bsr.blocks.numel() + bsr.cols.numel() + x.numel()
                  + y.numel())
    ops = 2 * bsr.blocks.numel()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    log(f"phase 4: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library {library_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.3f} ms")

    blocks_bytes = 4 * bsr.blocks.numel()
    total = torch.cuda.get_device_properties(0).total_memory
    print(json.dumps({"graph": GRAPH, "V": g.num_vertices, "E": g.num_edges,
                      "p": rt.p, "vmax": rt.vmax, "emax": rt.emax,
                      "replicas": rt.num_replicas, "bm": BM, "R": R, "K": K,
                      "TC": res.report["TC"], "RF": res.report["RF"]}))
    print(json.dumps({"blocks_gb": blocks_bytes / 1e9,
                      "blocks_share_of_hbm": blocks_bytes / total,
                      "fill": bsr.aggregate_fill()}))
    print(json.dumps({"max_memory_allocated_gb": peak / 1e9,
                      "main_path_s": main_s}))
    print(json.dumps({"superstep_ms_median": step_ms,
                      "pagerank_check": {"max_abs_vs_scatter": d_scatter,
                                         "max_abs_vs_oracle": d_oracle,
                                         "mass_rel": mass_rel},
                      "semiring_max_abs_err": semiring_err}))
    print(json.dumps({"kernels": [{
        "name": "bsr_spmv", "route": "cuda",
        "source": "src/repro_torch/kernels/bsr_spmv/csrc/bsr_spmv.cu",
        "replaces": "src/repro/kernels/bsr_spmv/kernel.py:70",
        "launches": launches, "launches_per_superstep": launches / ITERS,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "library": "torch.matmul (p*R*K,bm,bm)@(p*R*K,bm,1) + sum over K"}]}))
    print(json.dumps({"nvidia_smi": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
