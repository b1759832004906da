#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (every check is stated with its tolerance; any failed check makes
the script exit non-zero after it has printed what it measured):

1. build the hand-written CUDA kernels (``bsr_spmv``, ``decode_attn``,
   ``ssd``) from the sources in this checkout, one ``nvcc`` each, all at
   once;
2. hold ``bsr_spmv`` against its plain PyTorch version on the card, for
   each semiring, on random layouts with ELL padding slots at bm = 128
   (the ring filled by bulk copies) and bm = 30 (filled by the producer's
   own loads): bitwise for (min,+) and (or,and), rtol=1e-5 for (+,×);
   2b: the same for its bfloat16 and float16 instances, (+,×) inside the
   interval any float32 order of the slot sums admits
   (``plus_times_bounds``, bitwise where no slot sum lies near a rounding
   boundary);
3. drive the graph path through the port's CLI entry: ``graph500:16``,
   WindGP on the default cluster (3 super + 6 normal machines), PageRank
   for 20 supersteps on the ``pallas`` backend (the kernel), on ``cuda``.
   On the same runtime, the ``scatter`` backend and the float64 numpy
   oracle must agree within 1e-5·max(pr), and the PageRank mass within
   1e-5 relative;
4. time ``bsr_spmv``, its plain version and a library yardstick on the
   graph path's layout, and the superstep of both backends; then free the
   graph path's 37 GB of blocks.  On the same runtime, one 37.2 GB
   float32 layout at a time: 4b. SSSP, BFS (from the hub vertex) and CC
   through the ``pallas`` route, stepwise and fused (chunk 8, CUDA
   graphs), bitwise against ``scatter`` and the numpy/scipy oracles,
   fused equal to stepwise, with superstep times, walls and launches
   (a fused run's launches, the graph replays' and the predicated tail's
   included, read from the profiler's trace of that run); 4c. SSSP on
   ``scatter`` with ``frontier_cap`` at the run's largest frontier,
   bitwise against the dense run; 4d. PageRank with bfloat16 messages
   through the CLI entry (``--fused --tol 1e-7``), then float16, each
   within 1e-4·max(pr) of the same run with the kernel's plain version and
   against float32 ``scatter`` within 1e-2·max(pr) (bfloat16) or
   5e-2·max(pr) (float16), launches from the run's trace; the 16-bit
   kernel held on its 18.6 GB layout inside ``plus_times_bounds``, where
   two planted faults must fail the hold, and timed;
   4e. ``triangle_count`` against the oracle at ``rmat:15``
   (at ``graph500:16`` nearly every edge takes the host fallback);
   4f. the paper's comparison at ``graph500:16`` on the default cluster:
   each of hash, dbh, greedy, hdrf, ebv, ne, metis and windgp through the
   CLI entry with ``pallas`` PageRank, within 1e-5·max(pr) of ``scatter``,
   and SSSP from the hub bitwise equal to ``scatter``, with the host
   partition seconds, TC, RF, the layout's R, K, GB and build seconds,
   both supersteps and the peak memory, one layout at a time;
   4g. the out-of-core route: ``graph500:16``'s edge list written under
   ``build/``, streamed through the CLI (``--stream --method hdrf --dedup
   two_pass --out-dir D --pagerank --backend pallas``) with PageRank held
   as in 4f on the runtime packed from the shards; ``--workers 4
   --sync-blocks 1`` in a fresh process, its shards byte-equal to the
   one-worker run's; ``--compact D``;
   4h. dynamic repartitioning seeded from D: 3 epochs of inserts and
   deletes of 1 % of E each, drawn from ``--seed``, through
   ``StreamAssignment.apply_delta`` and ``PartitionRuntime.apply_delta``,
   whose runtime must equal a fresh ``from_stream`` repack field for
   field, with SSSP on ``pallas`` bitwise equal to ``scatter`` on it;
5. hold ``decode_attn`` and ``ssd`` against their plain versions in
   float32 and bfloat16, on edge inputs: ``decode_attn`` at the serving
   batch and widths, so with the main path's split plan, ragged lengths on
   the split edges below a Smax that is no multiple of any block, a
   ``lengths == 0`` row, and the newest key left out, which the hold must
   reject; ``ssd`` with T no multiple of the chunk, strong decay
   (a = -5), and the final SSD state;
6. serve qwen3-4b at its published config (bf16, 36 layers, random
   weights from a seeded generator on the card) through
   ``serve.generate``: 8 prompts of 2048 random tokens, 64 new tokens,
   greedy.  ``decode_attn`` must launch exactly 36 × 64 times, and the
   decode steps' logits must agree with ``forward`` over prompt + output
   (blockwise prefill attention, no kernel) at the same positions, in
   bf16 and in a float32 replay of 8 tokens on 2 prompts; a profile of 3
   decode steps gives the device time by kernel.  The bf16 check is also
   read with a wrong decode attention (query heads on the wrong KV group),
   which must exceed its limit, and with the newest key left out, which it
   cannot see and the float32 replay must;
7. the same for mamba2-780m: ``ssd`` launches 48 times in the prefill,
   and the decode steps' logits (the single-step recurrence) must agree
   with ``forward`` (the kernel).  The bf16 check is also read with the
   plain SSD in ``forward`` in place of the kernel, which must pass as
   the kernel does, and with two wrong SSD functions, which must fail;
8. time ``decode_attn`` at the serving shape and at S = 32768, and
   ``ssd`` at the serving shape, beside their plain versions, a library
   call where one exists, and their bounds.  These times are device time
   from torch.profiler (``ms``, the kernel's mean event, and by kernel
   with launches per call); the grid and block of the timed launches are
   read from the profiler's trace, and the CTAs an SM holds from the CUDA
   runtime's occupancy query for the kernel's own launch.  ``bsr_spmv``'s
   6–12 ms launches, its plain version and its library yardstick are
   timed with CUDA events around 10 back-to-back calls (3 for the plain
   version; the profiler's per-event mean has missed and split records
   of them, and events around one call count the host's launch time);
   every instance's row carries the profiler's time beside, the grid,
   block, registers and shared memory of its profiled launches (trace),
   held against the tile plan the wrapper launched with, and the CTAs an
   SM (``bsr_spmv_occupancy``).

It prints JSON lines (sizes, memory, times, checks, the kernel table
line), the ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it fails before printing any result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
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
BF16_TC_FLOPS = 989e12       # bf16 on the tensor cores, dense

#: the ssd bfloat16 kernel: bf16 passes of each product with a float32
#: operand (its hi and lo parts)
SSD_SPLIT_PASSES = 2

GRAPH = "graph500:16"
ITERS = 20
BM = 128
SPARSE_ITERS = 30            # the sparse apps' default budget
CHUNK = 8                    # the fused runner's default chunk
# bf16/f16 PageRank (phase 4d), the CLI's --tol and two holds relative
# to max(pr).  The sharp one: the run against the same run with the
# kernel's plain version, which differ only where a slot sum lies near a
# rounding boundary; 1e-4 lies far below either dtype's gap from float32
# (0.81 % and 2.6 % of max(pr) on an H100, PERF.md), so a kernel that
# ignored its rounding contract fails it.  The coarse one, against float32
# scatter: bfloat16 within the reference's own 1e-2
# (tests/test_bsp_fused.py), here relative; float16 within 5e-2, since
# graph500:16's ranks (mean 1/V = 1.5e-5) and messages lie below float16's
# smallest normal (6.1e-5), where it keeps fewer bits than bfloat16.  An
# all-zero vector is 1.0 away; a run equal to float32 fails too.
PR_LOW_TOL = 1e-7
PR_LOW_PLAIN_REL = 1e-4
PR_LOW_VS_F32_REL = {"bfloat16": 1e-2, "float16": 5e-2}
# triangle counting (phase 4e): the reference's ELL bound, and the graph
TRI_MAX_DEGREE = 64
TRI_GRAPH = "rmat:15"

# the paper's comparison (phase 4f): every method it compares WindGP with,
# at the graph path's graph and cluster
METHODS = ("hash", "dbh", "greedy", "hdrf", "ebv", "ne", "metis", "windgp")

# the out-of-core route and dynamic repartitioning (phases 4g, 4h)
STREAM_METHOD = "hdrf"
STREAM_WORKERS = 4
WORKERS_TIMEOUT_S = 300      # the --workers subprocess (it forks)
EPOCHS = 3
CHURN = 0.01                 # inserts and deletes an epoch, each 1 % of E

# the LM serving traffic: 8 prompts of 2048 tokens, 64 new tokens each
BATCH, PROMPT, NEW = 8, 2048, 64
CHECK_ROWS = 2               # sequences re-run through forward for the check

# tolerances of the kernel checks (phase 5):
# float32 as the JAX package's kernel tests hold the Pallas kernels;
# bfloat16 outputs: the two versions see identical bf16 inputs and differ
# only in float32 summation order, which can move the rounded output by
# one bf16 unit (2^-8 relative); the SSD state stays float32 (2e-4).
TOL = {torch.float32: {"decode": dict(rtol=2e-5, atol=2e-5),
                       "ssd": dict(rtol=2e-4, atol=2e-4)},
       torch.bfloat16: {"decode": dict(rtol=2 ** -7, atol=1e-4),
                        "ssd": dict(rtol=2 ** -7, atol=1e-3)}}
STATE_TOL = dict(rtol=2e-4, atol=2e-4)

# decode-vs-forward logits (phases 6 and 7).
# float32 replay (the sharp check): the same model in float32 (TF32 off),
# where the two paths differ only in summation order: 1e-4 relative (L2);
# the reduced configs agree with JAX to 1e-4 on the CPU.
F32_LOGITS_REL_L2 = 1e-4
REPLAY_NEW = 8
# bf16 serving run: each layer rounds its activations to bf16 (2^-9) in an
# order that depends on the batch shape (1 token against 2112), and a
# randomly initialised deep stack amplifies it, mamba2-780m's 48 SSM layers
# most.  Each model's limit lies between its sound readings (for
# mamba2-780m also the plain SSD's in place of the kernel) and the readings
# of wrong functions that the run takes too and that must exceed it; on an
# H100: qwen3-4b 0.0137 against 1.32, mamba2-780m 0.274 and 0.276 against
# 1.29 and 1.34 (PERF.md).
BF16_LOGITS_REL_L2 = {"qwen3-4b": 0.05, "mamba2-780m": 0.5}

FAILURES: list[str] = []


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def check(ok: bool, msg: str) -> None:
    """Record a failed check; the script fails at the end of the run."""
    if not ok:
        FAILURES.append(msg)
        log(f"CHECK FAILED: {msg}")


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


def median_ms(fn, reps: int) -> float:
    return statistics.median(cuda_ms(fn, reps))


def burst_ms(fn, reps: int) -> float:
    """Device time (ms) a call of ``fn()``, by CUDA events around ``reps``
    back-to-back calls after one warm-up call: the host enqueues ahead of
    the device, so of the host's own time only the first call's launch
    latency counts, a ``reps``-th of it (around a single call it all
    counts)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def is_device_event(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def profile_calls(fn, reps: int):
    """torch.profiler over ``reps`` calls of ``fn()``.  The first launches
    after the profiler starts can go unrecorded, so a few spin kernels
    (``torch.cuda._sleep``) run before and after the calls; leave them out
    with ``device_events``."""
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(8):
            torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spin()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        spin()
    check(sum(e.self_device_time_total for e in device_events(prof)) > 0,
          "the profiler recorded no device time")
    return prof


def device_events(prof) -> list:
    """Device events by kernel (``key_averages``), the spin kernels left
    out."""
    return [e for e in prof.key_averages() if is_device_event(e)
            and "spin_kernel" not in e.key]


def device_ms(fn, reps: int) -> float:
    """Device time (ms) per call of ``fn()``: the time of the kernels and
    copies it ran, as torch.profiler records them over ``reps`` calls.
    CUDA events around a call would also count the host's launch
    overhead, which can exceed a short kernel's own time."""
    events = device_events(profile_calls(fn, reps))
    return sum(e.self_device_time_total for e in events) / reps / 1e3


#: kernel launch attributes of the profiler's trace (CUPTI's records)
TRACE_ARGS = ("grid", "block", "registers per thread", "shared memory",
              "est. achieved occupancy %")


def trace_kernels(prof) -> list:
    """The device kernel events of a profile's trace, one per launch
    (CUDA-graph replays included)."""
    path = ROOT / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    path.unlink()
    return [e for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel"]


def traced_launches(prof, key: str) -> dict:
    """The launches of device kernels whose name holds ``key`` in a
    profile, as its trace records them: how many, and the attributes of
    ``TRACE_ARGS`` they share (an attribute that differs between launches
    fails a check; one the trace lacks is left out)."""
    launches = [e.get("args", {}) for e in trace_kernels(prof)
                if key in e.get("name", "")]
    out = {"traced": len(launches)}
    for arg in TRACE_ARGS:
        values = {json.dumps(a[arg]) for a in launches if arg in a}
        check(len(values) <= 1, f"{key} launches differ in {arg}: {values}")
        if len(values) == 1:
            out[arg] = json.loads(values.pop())
    if "grid" in out:
        out["ctas"] = int(np.prod(out["grid"]))
    return out


def timing(fn, reps: int, wrapper, key: str) -> dict:
    """Device time of a kernel's wrapper ``fn()``, which launches its
    kernel once a call (``wrapper.launches`` counts them), over ``reps``
    calls: ``ms``, the kernel's device time a launch (the mean of its
    profiler events, whose name holds ``key``); ``profiler_ms``, all
    device time a call; ``kernels``, events a call and ms an event by
    name; ``launch``, the timed launches' grid and block from the trace."""
    before = wrapper.launches
    prof = profile_calls(fn, reps)
    check(wrapper.launches - before == reps + 1,
          f"{wrapper.__name__} launched {wrapper.launches - before} times "
          f"for {reps + 1} calls")
    events = device_events(prof)
    kernels = {e.key[:80]: {"events_per_call": e.count / reps,
                            "ms_per_event": e.self_device_time_total
                            / max(e.count, 1) / 1e3} for e in events}
    mine = [e for e in events if key in e.key]
    check(len(mine) == 1, f"expected one {key} kernel in the profile, got "
          f"{list(kernels)}")
    ms = (mine[0].self_device_time_total / max(mine[0].count, 1) / 1e3
          if mine else float("nan"))
    return {"ms": ms, "profiler_ms": sum(e.self_device_time_total
                                         for e in events) / reps / 1e3,
            "kernels": kernels, "launch": traced_launches(prof, key)}


def exceeds(got, want, tol) -> float:
    """The largest ``|got - want| / (atol + rtol·|want|)``: above 1 where
    ``close`` would fail."""
    err = (got.float() - want.float()).abs()
    return float((err / (tol["atol"] + tol["rtol"] * want.float().abs()))
                 .max())


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def close(got, want, tol, what: str) -> float:
    """Check ``|got - want| <= atol + rtol·|want|`` elementwise; returns the
    largest absolute difference."""
    err = (got.float() - want.float()).abs()
    limit = tol["atol"] + tol["rtol"] * want.float().abs()
    check(bool((err <= limit).all()), f"{what}: max |d| {float(err.max())}")
    return float(err.max())


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


def reset_launches():
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.ssd import ssd_chunked
    for fn in (bsr_spmv, decode_attention, ssd_chunked):
        fn.launches = 0
    return bsr_spmv, decode_attention, ssd_chunked


# ---------------------------------------------------------------------------
# phases 2-4: the graph path
# ---------------------------------------------------------------------------

def graph_path(gen, lines: list):
    """Phases 2-4; returns the kernel table entry of ``bsr_spmv`` and the
    CLI run (graph, runtime), its layout released."""
    from repro_torch.bsp import build_pagerank, pagerank, ref
    from repro_torch.kernels.bsr_spmv import bsr_spmv_ref
    from repro_torch.launch import partition as cli

    # -- phase 2: kernel vs plain version, per semiring --------------------
    bsr_spmv = reset_launches()[0]
    semiring_err = {}
    for bm in (BM, 30):
        for sr in ("plus_times", "min_plus", "or_and"):
            tag = sr if bm == BM else f"{sr}_bm{bm}"
            cols, blocks, x = random_layout(gen, sr, bm=bm)
            got = bsr_spmv(cols, blocks, x, sr)
            want = bsr_spmv_ref(cols, blocks, x, sr)
            torch.cuda.synchronize()
            if sr == "plus_times":
                close(got, want, dict(rtol=1e-5, atol=0.0), tag)
            else:
                check(torch.equal(got, want),
                      f"{tag}: kernel != plain bitwise")
            fin = torch.isfinite(want)
            semiring_err[tag] = float((got[fin] - want[fin]).abs().max())
    log(f"phase 2: bsr_spmv == plain per semiring, max_abs_err "
        f"{semiring_err}")

    # -- phase 3: the graph path through the CLI entry ---------------------
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = cli.run(["--graph", GRAPH, "--method", "windgp", "--pagerank",
                   "--pagerank-iters", str(ITERS), "--backend", "pallas",
                   "--device", "cuda"])
    torch.cuda.synchronize()
    launches = bsr_spmv.launches
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(launches >= 1, "the graph path never launched bsr_spmv")
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
    log(f"phase 3: graph path in {main_s:.1f}s, {launches} launches, "
        f"max|d| scatter {d_scatter:.3g} oracle {d_oracle:.3g}")

    # -- phase 4: timings on the graph path's layout -----------------------
    bsr = rt.local_bsr(block_size=BM, semiring="plus_times",
                       weights="weight")
    p, R, K = bsr.cols.shape
    step_ms = {}
    for backend, opts in (("pallas", {"block_size": BM}), ("scatter", {})):
        spec = build_pagerank(rt, backend=backend, **opts)
        state = [spec.state]

        def step():
            state[0], _ = spec.superstep(state[0], spec.static)
        step_ms[backend] = median_ms(step, 10)

    x = torch.rand((p, R * BM), generator=gen, device="cuda")
    y = bsr_spmv(bsr.cols, bsr.blocks, x)
    kernel_ms = burst_ms(lambda: bsr_spmv(bsr.cols, bsr.blocks, x), 10)
    times = timing(lambda: bsr_spmv(bsr.cols, bsr.blocks, x), 10, bsr_spmv,
                   "bsr_spmv_kernel")
    launch = spmv_launch(bsr, x, times["launch"], "float32")
    y_plain = bsr_spmv_ref(bsr.cols, bsr.blocks, x)
    close(y, y_plain, dict(rtol=1e-5, atol=1e-6), "bsr_spmv on the layout")
    max_abs_err = max_err(y, y_plain)
    plain_ms = burst_ms(lambda: bsr_spmv_ref(bsr.cols, bsr.blocks, x), 3)
    # yardstick, never called by the port: one batched matmul over every
    # ELL slot, then the sum over K (einsum would copy the blocks)
    xg = x.view(p, R, BM)[torch.arange(p, device="cuda")[:, None, None],
                          bsr.cols.long()]
    flat_blocks = bsr.blocks.view(-1, BM, BM)

    def library():
        return torch.matmul(flat_blocks, xg.view(-1, BM, 1)).view(
            p, R, K, BM).sum(dim=2)
    close(library().view(p, -1), y_plain, dict(rtol=1e-5, atol=1e-6),
          "bsr_spmv library yardstick")
    library_ms = burst_ms(library, 10)
    nbytes = 4 * (bsr.blocks.numel() + bsr.cols.numel() + x.numel()
                  + y.numel())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * bsr.blocks.numel() / F32_FLOPS * 1e3
    log(f"phase 4: bsr_spmv {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library {library_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.3f} ms")

    blocks_bytes = 4 * bsr.blocks.numel()
    total = torch.cuda.get_device_properties(0).total_memory
    lines.append({"graph": GRAPH, "V": g.num_vertices, "E": g.num_edges,
                  "p": rt.p, "vmax": rt.vmax, "emax": rt.emax,
                  "replicas": rt.num_replicas, "bm": BM, "R": R, "K": K,
                  "TC": res.report["TC"], "RF": res.report["RF"]})
    lines.append({"blocks_gb": blocks_bytes / 1e9,
                  "blocks_share_of_hbm": blocks_bytes / total,
                  "fill": bsr.aggregate_fill()})
    lines.append({"max_memory_allocated_gb": peak / 1e9,
                  "main_path_s": main_s})
    lines.append({"superstep_ms_median": step_ms,
                  "pagerank_check": {"max_abs_vs_scatter": d_scatter,
                                     "max_abs_vs_oracle": d_oracle,
                                     "mass_rel": mass_rel},
                  "semiring_max_abs_err": semiring_err})
    rt.clear_bsr_cache()
    return res, {
        "name": "bsr_spmv", "route": "cuda",
        "source": "src/repro_torch/kernels/bsr_spmv/csrc/bsr_spmv.cu",
        "replaces": "src/repro/kernels/bsr_spmv/kernel.py:70",
        "launches": launches, "launches_per_superstep": launches / ITERS,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "profiler_ms": times["ms"], "profiler_kernels": times["kernels"],
        **launch, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "library": "torch.matmul (p*R*K,bm,bm)@(p*R*K,bm,1) + sum over K",
        "dtype": "float32"}


# ---------------------------------------------------------------------------
# phases 2b and 4b-4f: 16-bit kernel, sparse apps, frontier compaction,
# low-precision PageRank, triangles
# ---------------------------------------------------------------------------

def within_bounds(y, lo, hi) -> bool:
    return bool(((lo <= y) & (y <= hi)).all())


def spmv_launch(bsr, x, got: dict, dtype: str) -> dict:
    """What a ``bsr_spmv`` row of the kernels line reports of its timed
    launches: the tile plan the wrapper launched with, the grid, block,
    registers and shared memory the trace records (``got``, held against
    the plan), and the CTAs an SM the CUDA runtime reports for that
    launch."""
    from repro_torch.kernels.bsr_spmv import kernel as k_spmv
    plan = k_spmv.launch_plan(bsr.cols, bsr.blocks, x)
    per_sm = k_spmv.occupancy(x.device, x.dtype, "plus_times", BM, plan)
    check([got.get("grid"), got.get("block"), got.get("shared memory")]
          == [[plan.grid, 1, 1], [plan.threads, 1, 1], plan.smem],
          f"bsr_spmv {dtype}: the traced launch {got} is not the plan's "
          f"{plan}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"launch": got, "plan": dataclasses.asdict(plan),
            "ctas_per_sm": per_sm, "sms": sms,
            "waves": plan.grid / (sms * per_sm)}


def hold_16bit(got, want, cols, blocks, x, sr: str, what: str) -> dict:
    """Hold a 16-bit instance against its plain version: bitwise for
    (min,+) and (or,and); for (+,×) both inside ``plus_times_bounds``.
    Returns the largest absolute difference over finite values and, for
    (+,×), how many outputs the bounds leave open (lo < hi)."""
    from repro_torch.kernels.bsr_spmv import plus_times_bounds
    out = {}
    if sr == "plus_times":
        lo, hi = plus_times_bounds(cols, blocks, x)
        check(within_bounds(got, lo, hi), f"{what}: kernel outside bounds")
        check(within_bounds(want, lo, hi), f"{what}: plain outside bounds")
        out["open_outputs"] = int((lo != hi).sum())
    else:
        check(torch.equal(got, want), f"{what}: kernel != plain bitwise")
    fin = torch.isfinite(want)
    out["max_abs_err"] = float((got.float()[fin] - want.float()[fin])
                               .abs().max())
    return out


def hold_16bit_kernel(gen) -> dict:
    """Phase 2b: the bf16 and f16 instances of ``bsr_spmv`` against their
    plain versions on random layouts at bm = 128 and 30, per semiring."""
    from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_ref
    errs = {}
    for bm, dtype in itertools.product((BM, 30),
                                       (torch.bfloat16, torch.float16)):
        for sr in ("plus_times", "min_plus", "or_and"):
            cols, blocks, x = random_layout(gen, sr, bm=bm)
            blocks, x = blocks.to(dtype), x.to(dtype)
            got = bsr_spmv(cols, blocks, x, sr)
            want = bsr_spmv_ref(cols, blocks, x, sr)
            torch.cuda.synchronize()
            tag = f"{sr}_{str(dtype).split('.')[-1]}"
            if bm != BM:
                tag += f"_bm{bm}"
            errs[tag] = hold_16bit(got, want, cols, blocks, x, sr,
                                   tag)["max_abs_err"]
    return errs


def counted(fn):
    """``fn()`` with ``bsr_spmv``'s count set to 0 just before; returns
    (result, launches, wall seconds)."""
    bsr_spmv = reset_launches()[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, bsr_spmv.launches, time.perf_counter() - t0


#: the template argument of each storage type in the kernel's name
KERNEL_TYPE = {"float32": ", float, ", "bfloat16": ", __nv_bfloat16, ",
               "float16": ", __half, "}


def fused_traced(fn, dtype: str, what: str):
    """A fused run ``fn()`` under torch.profiler (device activity, spin
    kernels padding the window), with ``bsr_spmv``'s count set to 0 just
    before.  The wrapper counts its eager launches; a call under a CUDA
    graph's capture launches nothing, so the graph replays' launches are
    read from the run's trace, which records every launch.  Returns
    (result, the ``bsr_spmv`` kernel names the trace shows, eager
    launches, wall seconds of ``fn()``)."""
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(8):
            torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
    bsr_spmv = reset_launches()[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spin()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spin()
    names = [e.get("name", "") for e in trace_kernels(prof)
             if "bsr_spmv_kernel" in e.get("name", "")]
    check(all(KERNEL_TYPE[dtype] in n for n in names),
          f"{what}: the trace shows other bsr_spmv instances than "
          f"{dtype}'s: {sorted(set(names))}")
    return out, names, bsr_spmv.launches, wall


def fused_counts(names: list, eager: int, steps_run: int, what: str) -> dict:
    """The launches of a fused run that ran ``steps_run`` supersteps: the
    traced ones, the eager ones (the warm-up step) and those of the graph
    replays, whose tail past ``steps_run`` is the predicated tail (less
    than one chunk)."""
    graph = len(names) - eager
    check(eager == 1, f"{what}: {eager} eager launches, expected the one "
          f"warm-up step")
    check(steps_run <= graph < steps_run + CHUNK,
          f"{what}: the trace shows {graph} graph launches for {steps_run} "
          f"supersteps run in chunks of {CHUNK}")
    return {"steps_run": steps_run, "traced": len(names), "eager": eager,
            "graph": graph, "predicated_tail": graph - steps_run}


def cc_oracle(g) -> np.ndarray:
    """Min vertex id of each vertex's component (+inf for an isolated
    vertex, which no partition holds), by scipy."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    n = g.num_vertices
    adj = sp.coo_matrix((np.ones(g.num_edges), (g.edges[:, 0],
                                                g.edges[:, 1])),
                        shape=(n, n))
    _, comp = connected_components(adj, directed=False)
    low = np.full(comp.max() + 1, n)
    np.minimum.at(low, comp, np.arange(n))
    out = low[comp].astype(np.float64)
    out[g.degree() == 0] = np.inf
    return out


def hub(g) -> int:
    """The source of SSSP and BFS: the vertex of highest degree (an
    isolated vertex, which no machine holds, would end the run at once)."""
    return int(np.argmax(g.degree()))


def sparse_apps(g, rt, lines: list) -> dict:
    """Phase 4b: SSSP, BFS and CC at ``graph500:16`` through the pallas
    route, stepwise and fused, against ``scatter`` and the oracles; one
    float32 layout (37.2 GB) at a time."""
    from repro_torch.bsp import (bfs, build_app, connected_components,
                                 make_fused_runner, ref, run_bsp, sssp)
    source = hub(g)
    apps = {"sssp": (sssp, {"source": source}),
            "bfs": (bfs, {"source": source}),
            "cc": (connected_components, {})}
    oracles = {"sssp": lambda: ref.sssp(g, source, np.ones(g.num_edges),
                                        SPARSE_ITERS),
               "bfs": lambda: ref.bfs(g, source, SPARSE_ITERS),
               "cc": lambda: cc_oracle(g)}
    out = {}
    for app, (fn, kw) in apps.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        spec = build_app(rt, app, backend="pallas", block_size=BM, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        pallas = dict(backend="pallas", block_size=BM, **kw)
        (res, acts), step_launches, step_s = counted(
            lambda: fn(rt, num_iters=SPARSE_ITERS, **pallas))
        check(step_launches == SPARSE_ITERS, f"{app}: stepwise launched "
              f"bsr_spmv {step_launches} times in {SPARSE_ITERS} supersteps")
        (res_f, acts_f), names, eager, fused_s = fused_traced(
            lambda: fn(rt, num_iters=SPARSE_ITERS, fused=True, chunk=CHUNK,
                       **pallas), "float32", f"{app} fused")
        steps = len(acts_f)
        fused = fused_counts(names, eager, steps, f"{app} fused")
        check(np.array_equal(res_f, res), f"{app}: fused != stepwise")
        check(np.array_equal(acts_f, acts[:steps])
              and not acts[steps:].any(),
              f"{app}: fused actives are not the stepwise prefix")
        scatter, acts_s = fn(rt, num_iters=SPARSE_ITERS, **kw)
        check(np.array_equal(res, scatter) and np.array_equal(acts, acts_s),
              f"{app}: pallas != scatter bitwise")
        oracle = oracles[app]()
        check(np.array_equal(res.astype(np.float64), oracle),
              f"{app}: != the numpy oracle")
        # CUDA events over one superstep from the initial state (the
        # pallas superstep streams the whole layout whatever the frontier)
        step_ms = median_ms(lambda: spec.superstep(spec.state, spec.static),
                            10)
        # the fused runner reused: replays only (its graphs exist)
        runner = make_fused_runner(spec.superstep, spec.static, chunk=CHUNK)
        runner(spec.state, SPARSE_ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(spec.state, SPARSE_ITERS)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_bsp(spec.superstep, spec.state, spec.static, steps)
        torch.cuda.synchronize()
        stepwise_same_s = time.perf_counter() - t0
        # scatter: stepwise against fused, the same supersteps
        sc = build_app(rt, app, backend="scatter", **kw)
        sc_step_ms = median_ms(lambda: sc.superstep(sc.state, sc.static), 10)
        sc_runner = make_fused_runner(sc.superstep, sc.static, chunk=CHUNK)
        sc_runner(sc.state, SPARSE_ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc_out, _ = sc_runner(sc.state, SPARSE_ITERS)
        torch.cuda.synchronize()
        sc_fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sc_step_out, _ = run_bsp(sc.superstep, sc.state, sc.static, steps)
        torch.cuda.synchronize()
        sc_stepwise_s = time.perf_counter() - t0
        check(all(torch.equal(sc_out[k], sc_step_out[k]) for k in sc_out
                  if k != "step"), f"{app}: scatter fused != stepwise")
        peak = torch.cuda.max_memory_allocated()
        check(peak < torch.cuda.get_device_properties(0).total_memory,
              f"{app}: peak memory {peak}")
        out[app] = {
            "source": source, "supersteps_to_convergence": steps,
            "actives_per_step": acts_f.sum(axis=1).astype(int).tolist(),
            "layout_build_s": build_s, "superstep_ms_median": step_ms,
            "stepwise_s": {"budget": SPARSE_ITERS, "wall": step_s,
                           "wall_same_steps_as_fused": stepwise_same_s},
            "fused_s": {"first_call_with_capture_traced": fused_s,
                        "replay": replay_s},
            "launches": {"stepwise": step_launches, "fused": fused},
            "scatter": {"superstep_ms_median": sc_step_ms,
                        "stepwise_s_same_steps": sc_stepwise_s,
                        "fused_replay_s": sc_fused_s},
            "max_memory_allocated_gb": peak / 1e9}
        log(f"phase 4b: {app} {steps} supersteps, superstep "
            f"{step_ms:.3f} ms (scatter {sc_step_ms:.3f}), stepwise "
            f"{stepwise_same_s:.3f}s vs fused replay {replay_s:.3f}s, "
            f"peak {peak / 1e9:.1f} GB")
        del spec, runner, sc, sc_runner, sc_out, sc_step_out
        rt.clear_bsr_cache()
    torch.cuda.empty_cache()
    lines.append({"sparse_apps": out})
    return out


def frontier_phase(g, rt, lines: list) -> dict:
    """Phase 4c: SSSP on ``scatter`` with ``frontier_cap`` = the largest
    live-vertex count of any machine and superstep (``frontier_entries``
    over the dense run), bitwise against the dense ``scatter`` run,
    stepwise and fused, over the supersteps the dense run takes to
    converge: a compacted superstep costs cap × dmax whatever the
    frontier, and the hubs make dmax large here."""
    from repro_torch.bsp import (build_app, frontier_entries, run_bsp,
                                 run_bsp_fused)
    dense = build_app(rt, "sssp", backend="scatter", source=hub(g))
    state, live = dense.state, []
    for _ in range(SPARSE_ITERS):
        live.append(frontier_entries(rt, state["changed"].cpu().numpy()))
        state, act = dense.superstep(state, dense.static)
        if int(act.sum()) == 0:
            break
    cap, steps = int(np.max(live)), len(live)
    want, want_acts = run_bsp(dense.superstep, dense.state, dense.static,
                              steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec = build_app(rt, "sssp", backend="scatter", source=hub(g),
                     frontier_cap=cap)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    got, acts = run_bsp(spec.superstep, spec.state, spec.static, steps)
    fused, acts_f = run_bsp_fused(spec.superstep, spec.state, spec.static,
                                  steps, chunk=CHUNK)
    for k in want:
        check(torch.equal(got[k], want[k]), f"frontier_cap stepwise {k}")
        check(torch.equal(fused[k], want[k]), f"frontier_cap fused {k}")
    check(np.array_equal(acts, want_acts)
          and np.array_equal(acts_f, want_acts[:len(acts_f)]),
          "frontier_cap actives")
    step_ms = median_ms(lambda: spec.superstep(spec.state, spec.static), 10)
    dense_ms = median_ms(lambda: dense.superstep(dense.state, dense.static),
                         10)
    peak = torch.cuda.max_memory_allocated()
    ell = spec.static["eb_fr_dst"]
    out = {"frontier_cap": cap, "vmax": rt.vmax, "dmax": ell.shape[-1],
           "ell_gb": 2 * ell.numel() * 4 / 1e9, "prepare_s": prepare_s,
           "supersteps": len(acts_f),
           "superstep_ms_median_first_step": step_ms,
           "dense_superstep_ms_median_first_step": dense_ms,
           "max_memory_allocated_gb": peak / 1e9}
    log(f"phase 4c: frontier_cap {cap} bitwise vs dense scatter, "
        f"superstep {step_ms:.3f} ms (dense {dense_ms:.3f}), peak "
        f"{peak / 1e9:.1f} GB")
    del spec, dense
    torch.cuda.empty_cache()
    lines.append({"frontier": out})
    return out


def low_precision_pagerank(gen, lines: list) -> list:
    """Phase 4d: PageRank with bfloat16 messages through the CLI entry
    (``--backend pallas --message-dtype bfloat16 --fused --tol 1e-7``),
    then float16 on the same runtime; each against the same run with the
    kernel's plain version, against float32 ``scatter``, and stepwise.
    The 16-bit kernel is held and timed on its layout.  Returns the kernel
    table rows of the two instances."""
    from unittest import mock

    from repro_torch.bsp import backends, build_pagerank, make_fused_runner
    from repro_torch.bsp import pagerank
    from repro_torch.kernels.bsr_spmv import (bsr_spmv, bsr_spmv_ref,
                                              plus_times_bounds)
    from repro_torch.launch import partition as cli
    rows, out, rt = [], {}, None
    for dtype in ("bfloat16", "float16"):
        dt = getattr(torch, dtype)
        what = f"pagerank {dtype}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if dtype == "bfloat16":
            res, names, eager, fused_s = fused_traced(lambda: cli.run([
                "--graph", GRAPH, "--method", "windgp", "--pagerank",
                "--pagerank-iters", str(ITERS), "--backend", "pallas",
                "--message-dtype", dtype, "--fused", "--tol",
                str(PR_LOW_TOL), "--device", "cuda"]), dtype, what)
            pr, steps = res.pagerank, len(res.actives)
            rt = res.runtime
        else:                           # the CLI run's runtime
            (pr, acts), names, eager, fused_s = fused_traced(
                lambda: pagerank(rt, num_iters=ITERS, backend="pallas",
                                 block_size=BM, message_dtype=dtype,
                                 tol=PR_LOW_TOL), dtype, what)
            steps = len(acts)
        fused = fused_counts(names, eager, steps, f"{what} fused")
        peak = torch.cuda.max_memory_allocated()
        check(pr.shape == (rt.num_vertices,) and bool(np.isfinite(pr).all()),
              f"{what}: not a finite (V,) vector")
        pr32, _ = pagerank(rt, num_iters=steps, backend="scatter")
        scale = float(pr32.max())
        err = float(np.abs(pr - pr32).max())
        check(0 < err <= PR_LOW_VS_F32_REL[dtype] * scale,
              f"{what} vs float32 scatter {err / scale} of max(pr), not in "
              f"(0, {PR_LOW_VS_F32_REL[dtype]}]")
        # the same run with the kernel's plain version in its place
        with mock.patch.object(backends, "bsr_spmv", bsr_spmv_ref):
            pr_plain, _ = pagerank(rt, num_iters=steps, backend="pallas",
                                   block_size=BM, message_dtype=dtype)
        d_plain = float(np.abs(pr - pr_plain).max())
        check(d_plain <= PR_LOW_PLAIN_REL * scale, f"{what} vs the plain "
              f"version's run {d_plain / scale} of max(pr) > "
              f"{PR_LOW_PLAIN_REL}")
        (pr_s, _), step_launches, step_s = counted(
            lambda: pagerank(rt, num_iters=steps, backend="pallas",
                             block_size=BM, message_dtype=dtype))
        check(step_launches == steps, f"{what}: stepwise launched "
              f"{step_launches} times in {steps} supersteps")
        # the reference's fused-vs-stepwise bound for PageRank
        d_fused = float(np.abs(pr - pr_s).max())
        check(d_fused <= 1e-6, f"{what}: fused vs stepwise {d_fused}")
        # the kernel on this layout: held inside its bounds, where planted
        # faults must fail; profiler time a launch, beside its plain
        # version, a library call in the dtype and its bound
        spec = build_pagerank(rt, backend="pallas", block_size=BM,
                              message_dtype=dtype)
        bsr = rt.local_bsr(block_size=BM, semiring="plus_times",
                           weights="weight", dtype=dtype)
        p, R, K = bsr.cols.shape
        x = torch.rand((p, R * BM), generator=gen, device="cuda").to(dt)
        y = bsr_spmv(bsr.cols, bsr.blocks, x)
        y_plain = bsr_spmv_ref(bsr.cols, bsr.blocks, x)
        hold = hold_16bit(y, y_plain, bsr.cols, bsr.blocks, x, "plus_times",
                          f"bsr_spmv {dtype} layout")
        lo, hi = plus_times_bounds(bsr.cols, bsr.blocks, x)
        faults = {
            "first_slot_skipped": bsr_spmv_ref(bsr.cols[..., 1:],
                                               bsr.blocks[:, :, 1:], x),
            "two_units_high": y * (1 + 2 * torch.finfo(dt).eps)}
        for fault, bad in faults.items():
            check(not within_bounds(bad, lo, hi),
                  f"bsr_spmv {dtype} layout: the planted fault {fault} "
                  f"passed the hold")
        hold["planted_faults_rejected"] = sorted(faults)
        del lo, hi, faults, bad
        # times by CUDA events around back-to-back calls, as the float32
        # row's: for these 6 ms launches the profiler's per-event mean has
        # missed and split records (PERF.md); its profile gives the trace
        # and profiler_ms
        times = timing(lambda: bsr_spmv(bsr.cols, bsr.blocks, x), 10,
                       bsr_spmv, "bsr_spmv_kernel")
        kernel_ms = burst_ms(lambda: bsr_spmv(bsr.cols, bsr.blocks, x), 10)
        launch = spmv_launch(bsr, x, times["launch"], dtype)
        # the same bytes through the (min,+) instance, which rounds no slot
        # sum: what the 16-bit (+,×) rounding contract costs
        min_plus_ms = burst_ms(lambda: bsr_spmv(bsr.cols, bsr.blocks, x,
                                                 "min_plus"), 10)
        plain_ms = burst_ms(lambda: bsr_spmv_ref(bsr.cols, bsr.blocks, x),
                             3)
        xg = x.view(p, R, BM)[torch.arange(p, device="cuda")[:, None, None],
                              bsr.cols.long()]
        flat_blocks = bsr.blocks.view(-1, BM, BM)

        def library():
            return torch.matmul(flat_blocks, xg.view(-1, BM, 1)).view(
                p, R, K, BM).sum(dim=2)
        library_ms = burst_ms(library, 10)
        nbytes = (bsr.blocks.numel() * bsr.blocks.element_size()
                  + 4 * bsr.cols.numel()
                  + (x.numel() + y.numel()) * x.element_size())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the kernel widens to float32: its products are float32 FMAs
        ops_ms = 2 * bsr.blocks.numel() / F32_FLOPS * 1e3
        # the fused runner reused: replays only (its graphs exist)
        runner = make_fused_runner(spec.superstep, spec.static, chunk=CHUNK,
                                   tol=PR_LOW_TOL)
        runner(spec.state, ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(spec.state, ITERS)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        out[dtype] = {"steps_run": steps, "tol": PR_LOW_TOL,
                      "max_abs_vs_float32_scatter": err,
                      "max_abs_vs_float32_scatter_over_max_pr": err / scale,
                      "bound_over_max_pr": PR_LOW_VS_F32_REL[dtype],
                      "max_abs_vs_plain_kernel_run_over_max_pr":
                          d_plain / scale,
                      "plain_bound_over_max_pr": PR_LOW_PLAIN_REL,
                      "fused_vs_stepwise_max_abs": d_fused,
                      "blocks_gb": bsr.blocks.numel()
                      * bsr.blocks.element_size() / 1e9,
                      "max_memory_allocated_gb_main_path": peak / 1e9,
                      "fused_s_first_call_traced": fused_s,
                      "fused_replay_s": replay_s,
                      "stepwise_s_same_steps": step_s,
                      "layout_hold": hold,
                      "trace_kernel_name": sorted(set(names))[:1]}
        rows.append({
            "name": f"bsr_spmv_{'bf16' if dtype == 'bfloat16' else 'f16'}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/bsr_spmv/csrc/bsr_spmv.cu",
            "replaces": "src/repro/kernels/bsr_spmv/kernel.py:70",
            "dtype": dtype, "launches": fused["traced"],
            "launches_fused": fused, "launches_stepwise": step_launches,
            "max_abs_err": hold["max_abs_err"], "ms": kernel_ms,
            "kernel_ms": kernel_ms, "profiler_ms": times["ms"],
            "profiler_kernels": times["kernels"], **launch,
            "ms_min_plus_same_bytes": min_plus_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "library": f"torch.matmul in {dtype} (p*R*K,bm,bm)@(p*R*K,bm,1) "
                       f"+ sum over K"})
        log(f"phase 4d: {what} {steps} steps, vs float32 "
            f"{err / scale:.3g}·max(pr), vs plain run "
            f"{d_plain / scale:.3g}·max(pr); bsr_spmv {kernel_ms:.3f} ms "
            f"(bound {max(bytes_ms, ops_ms):.3f}, library {library_ms:.3f}), "
            f"peak {peak / 1e9:.1f} GB")
        del spec, bsr, runner, x, y, y_plain, xg, flat_blocks
        rt.clear_bsr_cache()
    torch.cuda.empty_cache()
    lines.append({"low_precision_pagerank": out})
    return rows


def triangle_phase(g, lines: list) -> dict:
    """Phase 4e: ``triangle_count`` against ``ref.triangle_count``.  Its
    hub fallback is host numpy, one sorted intersection per edge with an
    endpoint above the ELL bound, as in the reference; at ``graph500:16``
    nearly every edge has one, so the count runs at ``TRI_GRAPH``."""
    from repro_torch.bsp import PartitionRuntime, ref, triangle_count
    from repro_torch.core import scaled_paper_cluster, windgp
    from repro_torch.launch.partition import load_graph
    deg = g.degree()
    hub_edges = int(((deg[g.edges[:, 0]] > TRI_MAX_DEGREE)
                     | (deg[g.edges[:, 1]] > TRI_MAX_DEGREE)).sum())
    tg = load_graph(TRI_GRAPH)
    cl = scaled_paper_cluster(3, 6, tg.num_edges, slack=1.8)
    rt = PartitionRuntime.create(tg, assign=windgp(tg, cl).assign,
                                 cluster=cl, device="cuda")
    t0 = time.perf_counter()
    got = triangle_count(rt, tg, max_degree=TRI_MAX_DEGREE)
    port_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ref.triangle_count(tg)
    oracle_s = time.perf_counter() - t0
    check(got == want, f"triangle_count {got} != oracle {want}")
    tdeg = tg.degree()
    out = {"graph": TRI_GRAPH, "V": tg.num_vertices, "E": tg.num_edges,
           "triangles": got, "port_s": port_s, "oracle_s": oracle_s,
           "hub_edges": int(((tdeg[tg.edges[:, 0]] > TRI_MAX_DEGREE)
                             | (tdeg[tg.edges[:, 1]] > TRI_MAX_DEGREE)).sum()),
           "why_not_" + GRAPH: f"{hub_edges} of its {g.num_edges} edges have "
           f"an endpoint of degree > {TRI_MAX_DEGREE} and take the per-edge "
           f"host fallback"}
    log(f"phase 4e: triangle_count {got} at {TRI_GRAPH} in {port_s:.2f}s "
        f"(oracle {oracle_s:.2f}s)")
    lines.append({"triangles": out})
    return out


# ---------------------------------------------------------------------------
# phases 4f-4h: the partition front end feeding bsr_spmv
# ---------------------------------------------------------------------------

def pagerank_hold(rt, pr, what: str) -> float:
    """PageRank on ``pallas`` against ``scatter`` on the same runtime,
    within 1e-5·max(pr) (phase 3's hold)."""
    from repro_torch.bsp import pagerank
    pr_s, _ = pagerank(rt, num_iters=ITERS, backend="scatter")
    d = float(np.abs(pr - pr_s).max())
    check(bool(np.isfinite(pr).all()) and d <= 1e-5 * float(pr.max()),
          f"{what}: pagerank pallas vs scatter {d}")
    return d


def sssp_hold(rt, source: int, what: str) -> int:
    """SSSP from ``source`` on ``pallas`` bitwise against ``scatter``;
    returns the kernel's launches in the pallas run."""
    from repro_torch.bsp import sssp
    (got, acts), launches, _ = counted(
        lambda: sssp(rt, source=source, num_iters=SPARSE_ITERS,
                     backend="pallas", block_size=BM))
    want, acts_s = sssp(rt, source=source, num_iters=SPARSE_ITERS)
    check(np.array_equal(got, want) and np.array_equal(acts, acts_s),
          f"{what}: sssp pallas != scatter bitwise")
    check(launches == SPARSE_ITERS, f"{what}: sssp launched bsr_spmv "
          f"{launches} times in {SPARSE_ITERS} supersteps")
    rt.clear_bsr_cache()
    return launches


def layout_bound_ms(bsr) -> float:
    """The float32 kernel's bytes bound on a layout (x and y included)."""
    p, R, K = bsr.cols.shape
    nbytes = 4 * (bsr.blocks.numel() + bsr.cols.numel() + 2 * p * R * BM)
    return nbytes / HBM_BYTES_PER_S * 1e3


def paper_comparison(lines: list) -> dict:
    """Phase 4f: each method of the paper's comparison through the CLI
    entry (``--method m --pagerank --backend pallas``) at the graph path's
    graph and cluster; per method its partition, its float32 layout, the
    ``pallas`` and ``scatter`` PageRank supersteps on one runtime, and the
    holds: PageRank within 1e-5·max(pr) of ``scatter``, SSSP from the hub
    bitwise equal to ``scatter``.  One layout at a time."""
    from repro_torch.bsp import build_pagerank
    from repro_torch.core import partitioners
    from repro_torch.launch import partition as cli
    check(set(METHODS) <= set(partitioners.names(exclude={"oracle"})),
          f"the registry lacks a method of {METHODS}")
    out = {}
    for m in METHODS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, launches, wall = counted(lambda: cli.run(
            ["--graph", GRAPH, "--method", m, "--pagerank",
             "--pagerank-iters", str(ITERS), "--backend", "pallas",
             "--device", "cuda"]))
        check(launches == ITERS, f"{m}: pagerank launched bsr_spmv "
              f"{launches} times in {ITERS} supersteps")
        rt = res.runtime
        d_scatter = pagerank_hold(rt, res.pagerank, m)
        rt.clear_bsr_cache()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bsr = rt.local_bsr(block_size=BM, semiring="plus_times",
                           weights="weight")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _, R, K = bsr.cols.shape
        step_ms = {}
        for backend, opts in (("pallas", {"block_size": BM}),
                              ("scatter", {})):
            spec = build_pagerank(rt, backend=backend, **opts)
            state = [spec.state]

            def step():
                state[0], _ = spec.superstep(state[0], spec.static)
            step_ms[backend] = median_ms(step, 10)
        layout_gb = 4 * bsr.blocks.numel() / 1e9
        bound_ms = layout_bound_ms(bsr)
        del spec, state, bsr
        rt.clear_bsr_cache()
        torch.cuda.empty_cache()
        sssp_launches = sssp_hold(rt, hub(res.graph), m)
        peak = torch.cuda.max_memory_allocated()
        out[m] = {"host_partition_s": res.report["seconds"],
                  "TC": res.report["TC"], "RF": res.report["RF"],
                  "feasible": res.report["feasible"],
                  "vmax": rt.vmax, "emax": rt.emax,
                  "replicas": rt.num_replicas,
                  "R": R, "K": K, "layout_gb": layout_gb,
                  "layout_build_s": build_s,
                  "pallas_superstep_ms": step_ms["pallas"],
                  "scatter_superstep_ms": step_ms["scatter"],
                  "kernel_bound_ms": bound_ms,
                  "cli_wall_s": wall, "max_memory_allocated_gb": peak / 1e9,
                  "pagerank_max_abs_vs_scatter": d_scatter,
                  "launches": {"pagerank": launches, "sssp": sssp_launches}}
        log(f"phase 4f: {m} partition {res.report['seconds']}s TC "
            f"{res.report['TC']} RF {res.report['RF']}, layout R={R} K={K} "
            f"{layout_gb:.1f} GB built in {build_s:.2f}s, superstep pallas "
            f"{step_ms['pallas']:.3f} ms scatter {step_ms['scatter']:.3f} "
            f"ms, peak {peak / 1e9:.1f} GB")
        del res, rt
        torch.cuda.empty_cache()
    lines.append({"paper_comparison": {"graph": GRAPH, "bm": BM,
                                       "methods": out}})
    return out


def runtime_fields_equal(a, b) -> bool:
    from repro_torch.convert import RUNTIME_ARRAYS
    return all(getattr(a, f) == getattr(b, f)
               for f in ("p", "num_vertices", "num_replicas")) and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        and getattr(a, f).dtype == getattr(b, f).dtype
        for f in RUNTIME_ARRAYS)


def stream_route(lines: list):
    """Phase 4g: the out-of-core route at the graph path's graph.  Its edge
    list is written under ``build/`` and streamed through the CLI entry
    (``--stream --method hdrf --dedup two_pass --out-dir D --pagerank
    --backend pallas``); PageRank is held against ``scatter`` on the
    runtime packed from the shards.  Then ``--workers 4 --sync-blocks 1``
    in a fresh process (the pipeline forks, and this one holds a CUDA
    context), whose shards must equal the one-worker run's byte for byte,
    and ``--compact D``.  Returns (D, the runtime, the launches)."""
    import os
    import shutil

    from repro_torch.data import write_edge_list
    from repro_torch.launch import partition as cli
    work = ROOT / "build" / "chip_smoke_stream"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    g = cli.load_graph(GRAPH)
    path = work / "edges.txt"
    t0 = time.perf_counter()
    write_edge_list(g, str(path))
    write_s = time.perf_counter() - t0
    argv = ["--graph", str(path), "--stream", "--method", STREAM_METHOD,
            "--dedup", "two_pass"]
    one, four = work / "w1", work / "w4"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(lambda: cli.run(
        [*argv, "--out-dir", str(one), "--pagerank", "--pagerank-iters",
         str(ITERS), "--backend", "pallas", "--device", "cuda"]))
    check(launches == ITERS, f"stream: pagerank launched bsr_spmv "
          f"{launches} times in {ITERS} supersteps")
    check(res.report["spill"]["duplicate_rows"] == 0
          and sum(res.report["edges_per_machine"]) == g.num_edges,
          f"stream: {res.report['edges_per_machine']} edges placed of "
          f"{g.num_edges}")
    rt = res.runtime
    bsr = rt.local_bsr(block_size=BM, semiring="plus_times",
                       weights="weight")
    _, R, K = bsr.cols.shape
    layout_gb = 4 * bsr.blocks.numel() / 1e9
    del bsr
    d_scatter = pagerank_hold(rt, res.pagerank, "stream")
    rt.clear_bsr_cache()
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.partition", *argv,
         "--out-dir", str(four), "--workers", str(STREAM_WORKERS),
         "--sync-blocks", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=WORKERS_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    workers_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"--workers {STREAM_WORKERS} exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    same = [(one / f"shard{i}.edges").read_bytes()
            == (four / f"shard{i}.edges").read_bytes() for i in range(rt.p)]
    check(all(same), f"--workers {STREAM_WORKERS} --sync-blocks 1 shards "
          f"differ from the one-worker run's: {same}")
    meta = [json.loads((d / "meta.json").read_text()) for d in (one, four)]
    check(meta[0] == meta[1], "--workers meta differs from one worker's")

    compact = cli.run(["--compact", str(one), "--device", "cuda"]).report
    check(compact["tomb_rows_left"] == 0
          and compact["num_edges"] == g.num_edges, f"compact {compact}")
    out = {"graph": GRAPH, "method": STREAM_METHOD, "dedup": "two_pass",
           "edge_list_mb": path.stat().st_size / 1e6, "write_s": write_s,
           "stream_partition_s": res.report["seconds"], "cli_wall_s": wall,
           "TC": res.report["TC"], "RF": res.report["RF"],
           "spill": res.report["spill"], "R": R, "K": K,
           "layout_gb": layout_gb, "max_memory_allocated_gb": peak / 1e9,
           "pagerank_max_abs_vs_scatter": d_scatter, "launches": launches,
           "workers": {"workers": STREAM_WORKERS, "sync_blocks": 1,
                       "process_wall_s": workers_s,
                       "shards_equal": all(same)},
           "compact": compact}
    log(f"phase 4g: stream {STREAM_METHOD} two_pass in "
        f"{res.report['seconds']}s TC {res.report['TC']}, layout "
        f"{layout_gb:.1f} GB, pallas vs scatter {d_scatter:.3g}; "
        f"--workers {STREAM_WORKERS} in {workers_s:.1f}s, shards equal "
        f"{all(same)}; compact {compact['seconds']}s")
    lines.append({"stream_route": out})
    return one, rt, launches


def seed_from_assignment(sa):
    """The graph of a finalized assignment's live edges (canonical order)
    and each edge's machine: the seed of the dynamic layer."""
    from repro_torch.core import from_edge_list
    edges = np.concatenate([sa.machine_edges(i) for i in range(sa.p)])
    ms = np.repeat(np.arange(sa.p), sa.edges_per)
    g = from_edge_list(edges, sa.num_vertices)
    order = np.argsort(edges[:, 0] * sa.num_vertices + edges[:, 1])
    check(np.array_equal(edges[order], g.edges),
          "the assignment's edges are not one canonical edge set")
    return g, ms[order]


def dynamic_phase(out_dir, rt, seed: int, lines: list) -> list:
    """Phase 4h: a ``DynamicPartitioner`` seeded from the streamed
    assignment; ``EPOCHS`` epochs of inserts and deletes of 1 % of E each,
    drawn from ``seed``.  Each delta goes to ``StreamAssignment.apply_delta``
    and then ``PartitionRuntime.apply_delta``, whose runtime must equal a
    fresh ``from_stream`` repack field for field, with SSSP on ``pallas``
    bitwise equal to ``scatter`` on it.  Returns the launches an epoch."""
    from repro_torch.bsp import PartitionRuntime, StreamAssignment
    from repro_torch.core import DynamicPartitioner, scaled_paper_cluster
    sa = StreamAssignment.open(out_dir)
    t0 = time.perf_counter()
    g, assign = seed_from_assignment(sa)
    cl = scaled_paper_cluster(3, 6, g.num_edges, slack=1.8)
    dp = DynamicPartitioner(g, cl, assign, method=STREAM_METHOD)
    seed_s = time.perf_counter() - t0
    check(cl.p == rt.p and runtime_fields_equal(
        rt, PartitionRuntime.from_stream(sa, device="cuda")),
          "the streamed runtime differs from a repack of its assignment")
    rng = np.random.default_rng(seed)
    epochs, launches = [], []
    for epoch in range(EPOCHS):
        n = int(CHURN * dp.num_live_edges)
        t0 = time.perf_counter()
        snap = dp.snapshot()
        inserted = dp.insert(rng.integers(0, dp.g.num_vertices, (n, 2)))
        live = np.flatnonzero(dp.state.assign >= 0)
        deleted = dp.delete(dp.g.edges[rng.choice(live, n, replace=False)])
        delta = dp.delta_since(snap)
        dynamic_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sa.apply_delta(delta, dp.membership(), {"epoch": epoch + 1})
        shards_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt = rt.apply_delta(sa, delta, device="cuda")
        delta_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = PartitionRuntime.from_stream(sa, device="cuda")
        repack_s = time.perf_counter() - t0
        check(runtime_fields_equal(rt, full), f"epoch {epoch + 1}: "
              f"apply_delta != a fresh from_stream repack")
        check(not rt._bsr_cache, "apply_delta's runtime holds a layout")
        n_launch = sssp_hold(rt, int(np.argmax(sa.degree)),
                             f"epoch {epoch + 1}")
        launches.append(n_launch)
        epochs.append({"inserted": inserted, "deleted": deleted,
                       "changes": delta.num_changes,
                       "machines_touched": int(
                           delta.machines_touched(rt.p).sum()),
                       "repairs": len(dp.repairs), "TC": dp.tc,
                       "RF": sa.replication_factor(),
                       "dynamic_s": dynamic_s, "shards_s": shards_s,
                       "apply_delta_s": delta_s, "repack_s": repack_s,
                       "sssp_launches": n_launch})
        log(f"phase 4h: epoch {epoch + 1}: +{inserted} -{deleted}, "
            f"{delta.num_changes} changes on "
            f"{epochs[-1]['machines_touched']} machines, apply_delta "
            f"{delta_s:.2f}s vs repack {repack_s:.2f}s, sssp bitwise")
    lines.append({"dynamic": {"seed": seed, "seed_s": seed_s,
                              "epochs": epochs}})
    return launches


# ---------------------------------------------------------------------------
# phase 5: the LM kernels against their plain versions
# ---------------------------------------------------------------------------

def decode_inputs(gen, B, H, KVH, dh, S, dtype):
    dev = "cuda"
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, KVH, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, KVH, dh), generator=gen, device=dev).to(dtype)
    return q, k, v


def ssd_inputs(gen, B, T, nh, G, dh, ds, dtype, decay=None):
    """x, b, c in ``dtype`` and the log-decay a (float32) as the model
    makes it, -softplus(·), or constant ``-decay``."""
    dev = "cuda"
    x = torch.randn((B, T, nh, dh), generator=gen, device=dev).to(dtype)
    b = (0.5 * torch.randn((B, T, G, ds), generator=gen,
                           device=dev)).to(dtype)
    c = (0.5 * torch.randn((B, T, G, ds), generator=gen,
                           device=dev)).to(dtype)
    if decay is None:
        a = -torch.nn.functional.softplus(
            torch.randn((B, T, nh), generator=gen, device=dev))
    else:
        a = torch.full((B, T, nh), -decay, device=dev)
    return x, b, c, a


def hold_lm_kernels(gen) -> dict:
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_ref)
    from repro_torch.kernels.decode_attn.kernel import plan as attn_plan
    from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        # the serving batch and widths, Smax = 2113 (prompt + new + 1): no
        # multiple of the 32-row tile or of the planned split; lengths on
        # the split's edges, ragged, and a 0
        B, H, KVH, dh, S = BATCH, 32, 8, 128, PROMPT + NEW + 1
        q, k, v = decode_inputs(gen, B, H, KVH, dh, S, dtype)
        split = attn_plan(q, k)["split_len"]
        lens = torch.tensor([S, 0, 1000, 1, split - 1, split, split + 1,
                             S - 1], dtype=torch.int32, device="cuda")
        got = decode_attention(q, k, v, lens)
        want = decode_attention_ref(q, k, v, lens)
        tol = TOL[dtype]["decode"]
        errs[f"decode_attn_{name}"] = close(got, want, tol,
                                            f"decode_attn {name}")
        uniform = v[1].float().mean(0).repeat_interleave(H // KVH, dim=0)
        close(got[1], uniform, tol, f"decode_attn {name} lengths == 0")
        # the newest key left out, on the rows that keep a key: the hold
        # must reject it
        kept = lens >= 2
        wrong = exceeds(decode_attention(q, k, v, lens - 1)[kept],
                        want[kept], tol)
        errs[f"decode_attn_{name}_missing_newest_excess"] = wrong
        check(wrong > 1, f"decode_attn {name}: the hold passes the newest "
              f"key left out ({wrong} of its limit)")
        # ssd at the mamba2 width, T = 300 (no multiple of 128), with the
        # final state; then strong decay
        for T, decay in ((300, None), (1000, 5.0)):
            x, b, c, a = ssd_inputs(gen, 2, T, 48, 1, 64, 128, dtype, decay)
            y, h = ssd_chunked(x, b, c, a, chunk=128, return_state=True)
            y_ref, h_ref = ssd_chunked_ref(x, b, c, a, chunk=128,
                                           return_state=True)
            tag = f"ssd_{name}_T{T}" + ("_decay5" if decay else "")
            errs[tag] = close(y, y_ref, TOL[dtype]["ssd"], tag)
            errs[tag + "_state"] = close(h, h_ref, STATE_TOL,
                                         tag + " final state")
            check(bool(torch.isfinite(y.float()).all()), f"{tag} not finite")
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------------------
# phases 6-7: serving at full width
# ---------------------------------------------------------------------------

def forward_at(cfg, params, prompts, tokens) -> torch.Tensor:
    """``forward`` over prompt + tokens, float32 logits at the positions
    that produced ``tokens`` (B, n, V)."""
    from repro_torch.models import forward
    P, n = prompts.shape[1], tokens.shape[1]
    ref = forward(cfg, params, torch.cat([prompts, tokens], dim=1))
    return ref[:, P - 1:P - 1 + n].float()


def rel(got, ref) -> float:
    return float((got.float() - ref).norm() / ref.norm())


def logits_check(cfg, params, prompts, tokens, logits) -> dict:
    """Decode logits (B, n, V) against ``forward`` over prompt + tokens at
    the same positions: relative L2 overall, for the prefill's last
    position (step 0) and for the decode steps, and argmax agreement."""
    n = tokens.shape[1]
    ref = forward_at(cfg, params, prompts, tokens)
    got = logits.float()
    return {"rows": prompts.shape[0], "steps": n, "rel_l2": rel(got, ref),
            "rel_l2_step0": rel(got[:, 0], ref[:, 0]),
            "rel_l2_decode_steps": rel(got[:, 1:], ref[:, 1:]),
            "max_abs": max_err(got, ref),
            "max_abs_ref": float(ref.abs().max()),
            "argmax_agreement": float(
                (got.argmax(-1) == ref.argmax(-1)).float().mean())}


def profile_decode(cfg, params, cache, lens, steps: int = 3) -> dict:
    """Device time by kernel over ``steps`` decode steps (torch.profiler),
    and the device's busy share of that window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    tok = torch.zeros((lens.shape[0], 1), dtype=torch.long, device="cuda")
    decode_step(cfg, params, cache, tok, lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            decode_step(cfg, params, cache, tok, lens + 1 + i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    events = [e for e in prof.key_averages() if is_device_event(e)]
    total = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    if total == 0:    # the profiler saw no device activity: not measured
        return {"steps": steps, "device_ms_per_step": None}
    return {"steps": steps, "wall_ms_per_step_profiled": wall_us / steps / 1e3,
            "device_ms_per_step": total / steps / 1e3,
            "device_busy_share": total / wall_us,
            "top_device_ms_per_step": {
                e.key[:80]: e.self_device_time_total / steps / 1e3
                for e in top},
            "cpu_ms_per_step": sum(e.self_cpu_time_total
                                   for e in prof.key_averages())
            / steps / 1e3}


@contextlib.contextmanager
def model_calls(name: str, fn):
    """Run the model with ``models.layers.<name>`` (a kernel's wrapper)
    replaced by ``fn``."""
    from repro_torch.models import layers
    kept = getattr(layers, name)
    setattr(layers, name, fn)
    try:
        yield
    finally:
        setattr(layers, name, kept)


def ssd_decay_after_input(x, b, c, a, **kw):
    """A wrong SSD: h_t = exp(a_t) (h_{t-1} + b_t x_tᵀ), the decay applied
    after the input instead of before it."""
    from repro_torch.kernels.ssd import ssd_chunked_ref
    xd = (x.float() * torch.exp(a)[..., None]).to(x.dtype)
    return ssd_chunked_ref(xd, b, c, a, **kw)


def ssd_no_diagonal(x, b, c, a, **kw):
    """A wrong SSD: the causal mask one step short (s < t), so y_t loses
    its own term (c_t · b_t) x_t."""
    from repro_torch.kernels.ssd import ssd_chunked_ref
    y = ssd_chunked_ref(x, b, c, a, **kw)
    cb = (c.float() * b.float()).sum(-1)                   # (B, T, G)
    cb = cb.repeat_interleave(x.shape[2] // b.shape[2], dim=2)
    return (y.float() - cb[..., None] * x.float()).to(y.dtype)


def attn_missing_newest(q, k, v, lengths):
    """A wrong decode attention: the newest position of the cache left
    out (lengths - 1)."""
    from repro_torch.kernels.decode_attn import decode_attention
    return decode_attention(q, k, v, lengths - 1)


def attn_wrong_group(q, k, v, lengths):
    """A wrong decode attention: query head h reads KV head h % KVH instead
    of h // (H / KVH)."""
    from repro_torch.kernels.decode_attn import decode_attention
    H, KVH = q.shape[1], k.shape[2]
    perm = torch.tensor([(h % KVH) * (H // KVH) + h // KVH for h in range(H)],
                        device=q.device)
    qp = torch.empty_like(q)
    qp[:, perm] = q
    return decode_attention(qp, k, v, lengths)[:, perm]


def bf16_readings(cfg, params, prompts, tokens, logits) -> dict:
    """The bf16 decode-vs-forward reading (rel L2) with the kernel's plain
    version or a wrong function in the kernel's place.  The SSD kernel
    serves ``forward``, so its stand-ins replace it there; decode attention
    serves the decode steps, so its stand-in runs ``generate`` again."""
    from repro_torch.kernels.ssd import ssd_chunked_ref
    from repro_torch.serve import generate
    out = {}
    if cfg.family == "ssm":
        ref = forward_at(cfg, params, prompts, tokens)
        for name, fn in (("plain_ssd", ssd_chunked_ref),
                         ("wrong_decay_after_input", ssd_decay_after_input),
                         ("wrong_no_diagonal", ssd_no_diagonal)):
            with model_calls("ssd_chunked", fn):
                other = forward_at(cfg, params, prompts, tokens)
            out[name] = rel(logits, other)
            if name == "plain_ssd":     # the same function, two summations
                out["forward_kernel_vs_plain_ssd"] = rel(ref, other)
            del other
    else:
        # leaving out one of ~2,100 keys moves near-uniform random-init
        # attention too little for this check ("blind_"); the float32
        # replay sees it
        for name, fn in (("wrong_kv_group", attn_wrong_group),
                         ("blind_missing_newest", attn_missing_newest)):
            with model_calls("decode_attention", fn):
                toks, lg = generate(cfg, params, prompts, tokens.shape[1],
                                    return_logits=True)
            out[name] = logits_check(cfg, params, prompts, toks,
                                     lg)["rel_l2"]
    return out


def serve_model(arch: str, lines: list) -> dict:
    """Serve ``arch`` at its published config; returns its launch counts
    and times."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serve import generate

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device="cuda")
    torch.cuda.synchronize()

    _, attn, ssd = reset_launches()
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompts, NEW, return_logits=True)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"decode_attn": attn.launches, "ssd": ssd.launches}
    peak = torch.cuda.max_memory_allocated()

    # the prefill alone, as generate runs it, for the prefill/decode split
    cache = init_cache(cfg, BATCH, PROMPT + NEW + 1, device="cuda")
    zeros = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    decode_step(cfg, params, cache, prompts, zeros)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_s = total_s - prefill_s
    prof = profile_decode(cfg, params, cache,
                          torch.full((BATCH,), PROMPT, dtype=torch.int32,
                                     device="cuda"))
    del cache

    check(tuple(tokens.shape) == (BATCH, NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
        f"{arch}: tokens out of shape or range")
    check(bool(torch.isfinite(logits.float()).all()),
          f"{arch}: decode logits not finite")
    # decode steps against forward over prompt + output, same positions
    ssd_before = ssd.launches
    bf16_check = logits_check(cfg, params, prompts[:CHECK_ROWS],
                              tokens[:CHECK_ROWS], logits[:CHECK_ROWS])
    torch.cuda.synchronize()
    forward_ssd = ssd.launches - ssd_before
    limit = BF16_LOGITS_REL_L2[arch]
    check(bf16_check["rel_l2"] <= limit,
          f"{arch}: bf16 decode vs forward logits rel L2 "
          f"{bf16_check['rel_l2']} > {limit}")
    # the limit passes the same function and fails wrong ones
    readings = bf16_readings(cfg, params, prompts[:CHECK_ROWS],
                             tokens[:CHECK_ROWS], logits[:CHECK_ROWS])
    for name, value in readings.items():
        if name == "plain_ssd":
            check(value <= limit, f"{arch}: bf16 reading with the plain "
                  f"SSD {value} > {limit}")
        elif name.startswith("wrong_"):
            check(value > limit, f"{arch}: bf16 reading of a wrong function "
                  f"({name}) {value} <= {limit}")
    bf16_check["limit"] = limit
    bf16_check["readings"] = readings
    del params, logits
    torch.cuda.empty_cache()
    # the same in float32: the kernels' float32 instances on the decode
    # and forward paths must compute one function
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device="cuda")
    p32 = prompts[:CHECK_ROWS]
    toks32, logits32 = generate(cfg32, params, p32, REPLAY_NEW,
                                return_logits=True)
    f32_check = logits_check(cfg32, params, p32, toks32, logits32)
    check(f32_check["rel_l2"] <= F32_LOGITS_REL_L2,
          f"{arch}: float32 decode vs forward logits rel L2 "
          f"{f32_check['rel_l2']}")
    if cfg.family == "dense":     # the fault the bf16 check cannot see
        with model_calls("decode_attention", attn_missing_newest):
            toks_w, logits_w = generate(cfg32, params, p32, REPLAY_NEW,
                                        return_logits=True)
        wrong = logits_check(cfg32, params, p32, toks_w, logits_w)["rel_l2"]
        f32_check["wrong_missing_newest"] = wrong
        check(wrong > F32_LOGITS_REL_L2, f"{arch}: float32 reading of a "
              f"wrong function (missing newest key) {wrong}")
    del params
    torch.cuda.empty_cache()
    out = {"arch": arch, "params": n_params, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "batch": BATCH, "prompt": PROMPT,
           "new_tokens": NEW, "init_s": init_s, "generate_s": total_s,
           "prefill_s": prefill_s, "decode_s": decode_s,
           "decode_tokens_per_s": BATCH * NEW / decode_s,
           "decode_step_ms": decode_s / NEW * 1e3,
           "max_memory_allocated_gb": peak / 1e9,
           "launches": launches, "forward_check_ssd_launches": forward_ssd,
           "logits_check_bf16": bf16_check, "logits_check_f32": f32_check,
           "decode_profile": prof}
    lines.append(out)
    log(f"{arch}: prefill {prefill_s:.2f}s, decode "
        f"{out['decode_tokens_per_s']:.0f} tokens/s, peak "
        f"{peak / 1e9:.1f} GB, launches {launches}, rel L2 bf16 "
        f"{bf16_check['rel_l2']:.3g} f32 {f32_check['rel_l2']:.3g}")
    return out


# ---------------------------------------------------------------------------
# phase 8: LM kernel timings
# ---------------------------------------------------------------------------

def time_decode_attn(gen, S: int, lengths: torch.Tensor) -> dict:
    """decode_attn at qwen3-4b's serving width (B = 8, 32/8 heads,
    dh = 128, bf16) over a cache of ``S`` positions."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_ref)
    from repro_torch.kernels.decode_attn.kernel import occupancy
    B, H, KVH, dh = BATCH, 32, 8, 128
    q, k, v = decode_inputs(gen, B, H, KVH, dh, S, torch.bfloat16)
    got = decode_attention(q, k, v, lengths)
    want = decode_attention_ref(q, k, v, lengths)
    err = close(got, want, TOL[torch.bfloat16]["decode"],
                f"decode_attn at S={S}")
    times = timing(lambda: decode_attention(q, k, v, lengths), 50,
                   decode_attention, "decode_attn")
    ms = times["ms"]
    plain_ms = device_ms(lambda: decode_attention_ref(q, k, v, lengths), 5)
    # yardstick, never called by the port: SDPA over the cache's layout
    mask = (torch.arange(S, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)
    # (SDPA may hold the softmax weights in bf16: one bf16 unit of the
    # weights, 2^-8, plus the output's)
    close(library()[:, :, 0], want, dict(rtol=2e-2, atol=2e-2),
          f"SDPA yardstick at S={S}")
    library_ms = device_ms(library, 50)
    kv_bytes = 2 * int(lengths.sum()) * KVH * dh * k.element_size()
    bound_ms = (kv_bytes + 2 * q.numel() * q.element_size()) \
        / HBM_BYTES_PER_S * 1e3
    # q·Kᵀ has operands of the cache's type; p·V a float32 p
    qk_flops = 2 * int(lengths.sum()) * H * dh
    qk_rate = BF16_TC_FLOPS if k.dtype == torch.bfloat16 else F32_FLOPS
    ops_ms = (qk_flops / qk_rate + qk_flops / F32_FLOPS) * 1e3
    return {"S": S, "lengths": [int(n) for n in lengths.tolist()],
            "max_abs_err": err, "ms": ms, "timing": times,
            "launch": times["launch"],
            "ctas_per_sm": occupancy(q.device, q.dtype, dh, H // KVH),
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bound_ms, ops_ms),
            "bound_by": "bytes" if bound_ms >= ops_ms else "operations"}


def ssd_flops(B, T, nh, G, L, dh, ds) -> tuple[int, int]:
    """Operations (2 per multiply-add) the causal SSD scan needs: C·Bᵀ on
    each chunk's lower triangle, once per group; then, per head, the
    masked scores times X on the lower triangle, the carry-in C·h and the
    state update.  The exps and the mask's multiplies are not counted."""
    lens = [L] * (T // L) + ([T % L] if T % L else [])
    tri = sum(n * (n + 1) // 2 for n in lens)
    return 2 * B * G * tri * ds, 2 * B * nh * (tri * dh + 2 * T * ds * dh)


def time_ssd(gen) -> dict:
    """ssd at mamba2-780m's prefill shape (B = 8, T = 2048, 48 heads of
    dh = 64, ds = 128, one group, chunk 128, bf16), with the final state
    as the prefill asks for it."""
    from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_ref
    from repro_torch.kernels.ssd.kernel import SUB_CHUNK, occupancy
    B, T, nh, G, dh, ds, L = BATCH, PROMPT, 48, 1, 64, 128, 128
    x, b, c, a = ssd_inputs(gen, B, T, nh, G, dh, ds, torch.bfloat16)
    y, h = ssd_chunked(x, b, c, a, chunk=L, return_state=True)
    y_ref, h_ref = ssd_chunked_ref(x, b, c, a, chunk=L, return_state=True)
    err = close(y, y_ref, TOL[torch.bfloat16]["ssd"], "ssd at serving shape")
    close(h, h_ref, STATE_TOL, "ssd state at serving shape")
    times = timing(lambda: ssd_chunked(x, b, c, a, chunk=L,
                                       return_state=True), 10, ssd_chunked,
                   "ssd_scan")
    ms = times["ms"]
    plain_ms = device_ms(lambda: ssd_chunked_ref(x, b, c, a, chunk=L,
                                                 return_state=True), 3)
    nbytes = (2 * x.numel() * x.element_size()
              + (b.numel() + c.numel()) * b.element_size()
              + a.numel() * 4 + h.numel() * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # the bound counts the products as the kernel performs them, on the
    # bf16 tensor cores: its own sub-chunks, C·Bᵀ (bf16 operands, exact)
    # once per group, and each product with a float32 operand (the decayed
    # scores, h, w ⊙ x) in two passes, its hi and lo bf16 parts
    cb_flops, f32_flops = ssd_flops(B, T, nh, G, SUB_CHUNK, dh, ds)
    ops_ms = (cb_flops + SSD_SPLIT_PASSES * f32_flops) / BF16_TC_FLOPS * 1e3
    # beside it, the reference's arithmetic at the caller's chunk: C·Bᵀ on
    # the bf16 tensor cores, the float32-operand products at 67 TFLOP/s
    ref_cb, ref_f32 = ssd_flops(B, T, nh, G, L, dh, ds)
    ref_ops_ms = (ref_cb / BF16_TC_FLOPS + ref_f32 / F32_FLOPS) * 1e3
    return {"shape": {"B": B, "T": T, "nh": nh, "G": G, "dh": dh, "ds": ds,
                      "chunk": L, "sub_chunk": SUB_CHUNK},
            "launch": times["launch"],
            "ctas_per_sm": occupancy(x.device, x.dtype, dh, ds, L),
            "max_abs_err": err, "ms": ms, "timing": times,
            "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD scan",
            "flops_bf16_operands": cb_flops, "flops_f32_operands": f32_flops,
            "bf16_passes_of_f32_operands": SSD_SPLIT_PASSES,
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_ms_reference_arithmetic": max(bytes_ms, ref_ops_ms)}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (see the module docstring).")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 4h's inserts and deletes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.bsr_spmv import kernel as k_spmv
    from repro_torch.kernels.decode_attn import kernel as k_attn
    from repro_torch.kernels.ssd import kernel as k_ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    # -- phase 1: build, one nvcc per source, all at once ------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        built = list(pool.map(lambda m: m.build(), (k_spmv, k_attn, k_ssd)))
    log(f"phase 1: built {[b.path.name for b in built]} in "
        f"{time.perf_counter() - t0:.1f}s")
    for b in built:
        if b.log:
            print(b.log, file=sys.stderr)

    gen = torch.Generator(device="cuda").manual_seed(0)
    lines: list = []
    errs16 = hold_16bit_kernel(gen)
    log(f"phase 2b: bsr_spmv bf16/f16 vs plain per semiring, max_abs_err "
        f"{errs16}")
    lines.append({"bsr_spmv_16bit_max_abs_err": errs16})
    res, spmv_entry = graph_path(gen, lines)
    torch.cuda.empty_cache()
    apps = sparse_apps(res.graph, res.runtime, lines)
    spmv_entry["launches_sparse_apps"] = {
        app: a["launches"] for app, a in apps.items()}
    frontier_phase(res.graph, res.runtime, lines)
    graph = res.graph
    del res
    torch.cuda.empty_cache()
    spmv_16bit = low_precision_pagerank(gen, lines)
    triangle_phase(graph, lines)
    torch.cuda.empty_cache()

    # -- phases 4f-4h: the partition front end -----------------------------
    methods = paper_comparison(lines)
    spmv_entry["launches_paper_comparison"] = {
        m: r["launches"] for m, r in methods.items()}
    out_dir, stream_rt, stream_launches = stream_route(lines)
    spmv_entry["launches_stream_route"] = stream_launches
    torch.cuda.empty_cache()
    spmv_entry["launches_dynamic_sssp"] = dynamic_phase(
        out_dir, stream_rt, args.seed, lines)
    del stream_rt
    torch.cuda.empty_cache()

    # -- phase 5 ----------------------------------------------------------
    reset_launches()
    kernel_errs = hold_lm_kernels(gen)
    log(f"phase 5: decode_attn and ssd vs plain, max |d| {kernel_errs}")
    lines.append({"lm_kernel_checks_max_abs_err": kernel_errs})

    # -- phases 6-7 -------------------------------------------------------
    qwen = serve_model("qwen3-4b", lines)
    check(qwen["launches"] == {"decode_attn": 36 * NEW, "ssd": 0},
          f"qwen3-4b launches {qwen['launches']} != 36 x {NEW} decode_attn")
    torch.cuda.empty_cache()
    mamba = serve_model("mamba2-780m", lines)
    check(mamba["launches"] == {"decode_attn": 0, "ssd": 48},
          f"mamba2-780m launches {mamba['launches']} != 48 ssd")
    check(mamba["forward_check_ssd_launches"] == 48,
          "mamba2-780m forward did not launch ssd 48 times")
    torch.cuda.empty_cache()

    # -- phase 8 ----------------------------------------------------------
    serve_lengths = torch.randint(PROMPT + 1, PROMPT + NEW + 1, (BATCH,),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
    attn_t = time_decode_attn(gen, PROMPT + NEW + 1, serve_lengths)
    attn_32k = time_decode_attn(
        gen, 32768, torch.full((BATCH,), 32768, dtype=torch.int32,
                               device="cuda"))
    ssd_t = time_ssd(gen)
    share = 36 * attn_t["ms"] / qwen["decode_step_ms"]
    lines.append({"decode_attn_serving": attn_t, "decode_attn_32k": attn_32k,
                  "ssd_serving": ssd_t,
                  "decode_attn_share_of_qwen_decode_step": share})
    log(f"phase 8: decode_attn {attn_t['ms']:.4f} ms (bound "
        f"{attn_t['bound_ms']:.4f}), at 32k {attn_32k['ms']:.4f} ms (bound "
        f"{attn_32k['bound_ms']:.4f}); ssd {ssd_t['ms']:.3f} ms (bound "
        f"{ssd_t['bound_ms']:.3f})")

    for line in lines:
        print(json.dumps(line))
    print(json.dumps({"kernels": [spmv_entry, *spmv_16bit, {
        "name": "decode_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/kernel.py:59",
        "launches": qwen["launches"]["decode_attn"],
        "max_abs_err": attn_t["max_abs_err"], "ms": attn_t["ms"],
        "plain_ms": attn_t["plain_ms"], "bound_ms": attn_t["bound_ms"],
        "bound_by": attn_t["bound_by"], "library_ms": attn_t["library_ms"],
        "library": "F.scaled_dot_product_attention(enable_gqa=True, "
                   "boolean length mask)",
        "kernels_by_name": attn_t["timing"]["kernels"],
        "grid": attn_t["launch"].get("grid"),
        "ctas": attn_t["launch"].get("ctas"),
        "ctas_per_sm": attn_t["ctas_per_sm"], "sms": sms,
        "ms_32k": attn_32k["ms"], "bound_ms_32k": attn_32k["bound_ms"],
        "library_ms_32k": attn_32k["library_ms"],
        "grid_32k": attn_32k["launch"].get("grid")}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:66",
        "launches": mamba["launches"]["ssd"],
        "max_abs_err": ssd_t["max_abs_err"], "ms": ssd_t["ms"],
        "plain_ms": ssd_t["plain_ms"], "bound_ms": ssd_t["bound_ms"],
        "bound_by": ssd_t["bound_by"], "library_ms": None,
        "library": ssd_t["library"], "grid": ssd_t["launch"].get("grid"),
        "ctas": ssd_t["launch"].get("ctas"),
        "ctas_per_sm": ssd_t["ctas_per_sm"], "sms": sms,
        "bound_ms_reference_arithmetic":
            ssd_t["bound_ms_reference_arithmetic"]}]}))
    print(json.dumps({"nvidia_smi": smi}))
    if FAILURES:
        raise RuntimeError(f"{len(FAILURES)} check(s) failed: {FAILURES}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
