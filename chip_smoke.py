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
   4i. partitioned GNN sampling on 4f's WindGP (the CLI's defaults), HDRF
   and hash partitions, one method's tables at a time: ``MachineCSC``
   (its padded neighbour table on the card), ``SamplingService`` at
   fanouts (10, 5) with 1024 seeds a batch, 2 batches without
   replacement and 1 with for every home machine; the fused path bitwise
   equal to the loop path on the same uniforms, hop 1 and the first 512
   rows of hop 2 bitwise equal to ``sample_fanout_np``, every id a true
   neighbour of its parent (the graph's CSR), no repeat without
   replacement, ``min(deg, fanout)`` ids a row, ``hop_stats`` equal to a
   host recount with ``np.unique``; ``FeatureStore`` (128 float32
   features a vertex from ``--seed``) with a ``HaloCache`` a home (4096
   rows, half hubs), ``gather`` bitwise equal to ``gather_global`` with
   misses at most the hops' ``fetched_unique``; ``PrefetchPipeline`` at
   depth 0 and 2 (6 batches, home 0, with the cache and without) bitwise
   equal; WindGP's mean hop-1 halo fraction below hash's.  Prints, a
   method, the CSC build seconds and table GB, minibatches/s and sampled
   vertices/s fused and loop (median of 10 batches, synchronised wall),
   a profile of one batch (device ms, busy share, top kernels),
   ``gather`` ms with and without the cache, halo fractions,
   ``fetched_unique``, the cache hit rate, the pipeline's batches/s and
   the peak device memory;
   4j. the multi-device BSP path on 4f's WindGP partition: 9 gloo ranks
   (``spawn_machines``), one machine each, all on the one card, each
   holding only its machine's layout (its own ELL width K).  Each rank
   runs float32 PageRank on ``pallas`` stepwise and fused, SSSP, BFS (from
   the hub) and CC on ``pallas`` and ``scatter`` stepwise and fused, and
   bfloat16 PageRank on ``pallas``: SSSP, BFS and CC bitwise equal to
   4b's stacked runs, actives included, float32 PageRank within
   1e-5·max(pr) of phase 3's, bfloat16 within 4d's holds (1e-4·max(pr) of
   4d's stacked run, within 1e-2·max(pr) of float32), every rank
   launching ``bsr_spmv`` once a superstep (under a mesh the fused chunk
   is not captured, so its predicated tail launches too), every rank
   returning the same and no rank's peak memory reaching the stacked
   layout's.  Prints per rank its K, layout GB, peak GB, kernel ms (10
   back-to-back calls by CUDA events, the ranks taking turns) beside
   ``simulate_superstep_times``' modelled time, and the median exchange
   ``all_reduce`` ms and the superstep wall;
5. hold ``decode_attn`` and ``ssd`` against their plain versions in
   float32 and bfloat16, on edge inputs: ``decode_attn`` at the serving
   batch and at qwen3-4b's and jamba's widths (32 heads over 8 of 128),
   granite's (24 over 8 of 64: G = 3, padded to 4 on the tensor
   cores), glm4-9b's (32 over 2 of 128: G = 16, the CUDA-core body in
   bf16), qwen3-14b's (40 over 8: G = 5), musicgen-medium's (24 over 24
   of 64: G = 1) and paligemma-3b's (8 over 1 of 256), so with the main
   path's split plan, ragged lengths on the
   split edges below a Smax that is no multiple of any block, a
   ``lengths == 0`` row, and the newest key left out, which the hold must
   reject; ``ssd`` at mamba2-780m's widths (48 heads, ds 128) and
   jamba's (128 heads, ds 16: half the tensor-core instance's 32 state
   columns padding), with T no multiple of the chunk, strong decay
   (a = -5), and the final SSD state; and its ``autograd.Function`` at
   both widths (T = 300, final state too): one launch forward, a
   ``grad_fn`` on each output, the gradients of x, b, c and a bitwise
   autograd's through the plain version (its backward is that VJP);
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
   cannot see and the float32 replay must (the replay also reads the wrong
   KV group);
7. the same for mamba2-780m: ``ssd`` launches 48 times in the prefill,
   and the decode steps' logits (the single-step recurrence) must agree
   with ``forward`` (the kernel).  The bf16 check is also read with the
   plain SSD in ``forward`` in place of the kernel, which must pass as
   the kernel does, and with two wrong SSD functions, which must fail;
   7b. the same for granite-moe-3b-a800m at its published config (32
   layers, 40 experts, top 8): ``decode_attn`` launches exactly 32 × 64
   times and ``ssd`` never.  Random weights route most tokens to a few
   experts, so the capacity (factor 1.25) drops entries, and a token's
   output then depends on the batch it is routed with: the decode and
   forward holds run the same weights and prompts at a capacity that
   drops nothing (factor E / K), with the served run's reading beside
   them.  The bf16 check is also read with a wrong MoE combine in
   ``forward`` (each token's K gate weights reversed across its
   experts), which must fail, and the float32 replay with the newest key
   left out and the wrong KV group, which must fail.  It prints the
   entries each MoE layer's capacity dropped in the prefill and in
   ``forward``, ``param_count`` and ``active_param_count``;
   7c. the same for jamba-v0.1-52b at full width, its depth cut from 32
   to 8 layers (one pattern period: 1 attention, 7 SSM, 4 MoE layers;
   the whole model's 103 GB of bf16 weights exceed the card):
   ``decode_attn`` launches 64 times, ``ssd`` 7 in the prefill and 7 in
   ``forward``, and the bf16 check is read with the plain SSD (must pass),
   the two wrong SSDs, the wrong KV group and the wrong MoE combine (must
   fail);
   7d. WindGP expert placement over the live router: the top-8 ids of
   granite's MoE layers 0, 8, 16 and 24 in 7b's prefill (16,384 tokens
   each) through ``sharding.place_experts`` on the three pods of
   ``examples/hetero_moe_placement.py`` (memory scaled by 40/16): every
   expert placed, no pod above its memory + 1 experts, the same placement
   on a second call; it prints both makespans (WindGP and round-robin),
   the co-activation graph's size and the seconds of its parts;
   7e. the remaining archs at their published configs, full depth,
   served as in 6: glm4-9b, qwen3-14b, minicpm3-4b (MLA: the plain
   blockwise attention at every S, no kernel), musicgen-medium and
   paligemma-3b (embedding-input stubs: (8, 2048, d) prompts drawn from
   the seed, each token fed back as ``jax.nn.one_hot``'s row).
   ``decode_attn`` launches layers × 64 times (minicpm3-4b never).  Each
   is held decode-vs-``forward`` in bf16 and in the float32 replay, and
   read with wrong decode attentions that must exceed the limits: MLA
   with ``k_rope`` left out of the score; the wrong KV group (MHA: the
   next head), or with one KV head the wrong sequence's cache; the
   newest key left out (float32);
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
   SM (``bsr_spmv_occupancy``);
9. training, through ``train.make_train_step`` (bf16, remat, AdamW at
   1e-3) on ``SyntheticLM`` batches of 2048 tokens: mamba2-780m at its
   published config, 8 sequences, 5 steps, through the ``ssd`` kernel
   (forward and remat recompute, 2 × 48 launches a step) and its plain
   VJP backward.  Held: the float32 gradients at full depth through the
   kernel against through the plain SSD on the first batch, leaf by
   leaf (``GRAD_F32_REL_L2``), with the ssd gradient dropped as the wrong
   reading; every parameter's gradient finite and nonzero; a checkpoint
   at step 2 restored on the card into other weights bitwise, and steps
   3–5 resumed from it against the straight run (``RESUME_REL``).  Then
   qwen3-4b at its published config, 1 sequence (its 53 GB of bf16
   weights and gradients and float32 moments).  For both, the loss on
   one held-out batch (the stream's next, never trained on), before the
   first step and after each, must fall by more than the spread of the
   training batches' losses at the initial weights.  Prints step ms, tokens/s and peak GB, and the ``ssd``
   kernel's forward ms and its plain backward's ms a step.

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
import math
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

# partitioned GNN sampling (phase 4i): the reference benchmark's methods
# (benchmarks/sampling_service.py) on phase 4f's partitions, and the
# reference's default fanouts
SAMPLING_METHODS = ("windgp", "hdrf", "hash")
FANOUTS = (10, 5)
SAMPLE_SEEDS = 1024          # seeds a minibatch
FEAT_DIM = 128               # float32 features a vertex
CACHE_ROWS, HUB_FRAC = 4096, 0.5
ORACLE_HOP2_ROWS = 512       # hop-2 rows held against the numpy oracle
TIMED_BATCHES = 10
PIPE_BATCHES, PIPE_DEPTH = 6, 2

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
# the reduced configs agree with JAX to 1e-4 on the CPU.  A MoE arch's
# holds run at a capacity that drops nothing (``dropless``).
F32_LOGITS_REL_L2 = 1e-4
REPLAY_NEW = 8
# bf16 serving run: each layer rounds its activations to bf16 (2^-9) in an
# order that depends on the batch shape (1 token against 2112), and a
# randomly initialised deep stack amplifies it, the SSM layers most.  Each
# model's limit lies between its sound readings (for the SSM archs also
# the plain SSD's in place of the kernel) and the readings of wrong
# functions that the run takes too and that must exceed it; on an H100:
# qwen3-4b 0.0137 against 1.32, mamba2-780m 0.274 and 0.276 against 1.29
# and 1.34, granite-moe-3b-a800m 0.0229 against 0.375 (wrong combine) and
# 1.29, jamba-v0.1-52b 0.150 and 0.158 against 0.211 (wrong KV group, its
# one attention layer in 8), 0.563, 1.06 and 1.11; glm4-9b 0.0195 against
# 1.07, qwen3-14b 0.0193 against 1.27, minicpm3-4b 0.0210 against 0.106
# (k_rope left out), musicgen-medium 0.0196 against 0.697, paligemma-3b
# 0.0248 against 1.41 (wrong sequence) (PERF.md).  The float32 replay
# holds the attention faults sharply.
BF16_LOGITS_REL_L2 = {"qwen3-4b": 0.05, "mamba2-780m": 0.5,
                      "granite-moe-3b-a800m": 0.1, "jamba-v0.1-52b": 0.185,
                      "glm4-9b": 0.05, "qwen3-14b": 0.05, "minicpm3-4b": 0.05,
                      "musicgen-medium": 0.05, "paligemma-3b": 0.05}
# phase 7e: the archs served at their published configs, full depth
NEW_ARCHS = ("glm4-9b", "qwen3-14b", "minicpm3-4b", "musicgen-medium",
             "paligemma-3b")
# jamba-v0.1-52b (phase 7c): its full width at one pattern period of depth
JAMBA_LAYERS = 8

# WindGP expert placement (phase 7d): granite's MoE layers whose prefill
# routing is placed, and the three pods of examples/hetero_moe_placement.py
# (relative compute cost, experts a pod holds scaled by 40/16, link cost)
PLACED_LAYERS = (0, 8, 16, 24)
POD_COMPUTE = [0.5, 1.0, 1.0]
POD_MEMORY = [20, 15, 15]
POD_LINK = [1.0, 1.0, 1.5]

# the multi-device path (phase 4j): one machine a gloo rank, every rank on
# the one card, the launcher's limit on the ranks' run
MESH_TIMEOUT_S = 480

# phase 9, training: bf16, remat, AdamW at the train CLI's default rate,
# on SyntheticLM batches of 2048 tokens (seed 0); mamba2-780m at 8
# sequences, qwen3-4b at 1 (its weights, gradients and float32 moments
# are ~53 GB); a checkpoint at step 2
TRAIN_STEPS, TRAIN_SEQ, TRAIN_LR, CKPT_STEP = 5, 2048, 1e-3, 2
TRAIN_BATCH = {"mamba2-780m": 8, "qwen3-4b": 1}
# mamba2-780m's gradients through the ssd kernel against those through
# the plain SSD, float32, full depth, on the first batch: the largest
# relative L2 of a parameter's gradient.  The two differ only in the
# forward's summation order; on an H100 the largest reads 9.6e-5 (a deep
# layer's dt_bias, a sum over 16,384 tokens that mostly cancels) and the
# ssd gradient dropped 55 (PERF.md)
GRAD_F32_REL_L2 = 1e-3
# the loss must fall: the held-out batch's loss before the first step
# less its loss after the last above the training batches' spread
# (largest less smallest of their losses at the initial weights).  On one
# batch the difference is the weights' alone; an optimizer that does
# nothing reads 0, bitwise
# the run resumed from the step-2 checkpoint against the one that went
# straight through: losses and each parameter within 1e-6 relative (the
# same kernels on the same inputs; the reading records whether bitwise)
RESUME_REL = 1e-6

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


def profile_calls(fn, reps: int, attempts: int = 5):
    """torch.profiler over ``reps`` calls of ``fn()``, after one warm-up
    call; returns (profile, calls of ``fn`` made).  The first launches
    after the profiler starts can go unrecorded, so a few spin kernels
    (``torch.cuda._sleep``) run before and after the calls; leave them out
    with ``device_events``.  A session can also keep only its first
    record (one spin kernel) and lose the rest; one that recorded no
    device time outside the spin kernels is taken again, up to
    ``attempts`` sessions, and the last one counts."""
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(8):
            torch.cuda._sleep(10_000)
        torch.cuda.synchronize()

    def recorded(prof) -> float:
        return sum(e.self_device_time_total for e in device_events(prof))
    fn()
    torch.cuda.synchronize()
    calls = 1
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            spin()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            spin()
        calls += reps
        if recorded(prof) > 0:
            break
    check(recorded(prof) > 0, "the profiler recorded no device time")
    return prof, calls


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
    events = device_events(profile_calls(fn, reps)[0])
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
    prof, calls = profile_calls(fn, reps)
    check(wrapper.launches - before == calls,
          f"{wrapper.__name__} launched {wrapper.launches - before} times "
          f"for {calls} calls")
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

def graph_path(gen, lines: list, stacked: dict):
    """Phases 2-4; returns the kernel table entry of ``bsr_spmv`` and the
    CLI run (graph, runtime), its layout released.  Keeps in ``stacked``
    what phase 4j holds its ranks against: the assignment, PageRank and
    its actives, K and the float32 layout's bytes."""
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
    stacked.update(assign=res.assign, pagerank=(pr, res.actives), K=K,
                   blocks_bytes=blocks_bytes)
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


def sparse_apps(g, rt, lines: list, stacked: dict) -> dict:
    """Phase 4b: SSSP, BFS and CC at ``graph500:16`` through the pallas
    route, stepwise and fused, against ``scatter`` and the oracles; one
    float32 layout (37.2 GB) at a time.  Keeps each app's results and
    actives, stepwise and fused, in ``stacked`` for phase 4j."""
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
        stacked[app] = {"stepwise": (res, acts), "fused": (res_f, acts_f)}
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


def low_precision_pagerank(gen, lines: list, stacked: dict) -> list:
    """Phase 4d: PageRank with bfloat16 messages through the CLI entry
    (``--backend pallas --message-dtype bfloat16 --fused --tol 1e-7``),
    then float16 on the same runtime; each against the same run with the
    kernel's plain version, against float32 ``scatter``, and stepwise.
    The 16-bit kernel is held and timed on its layout.  Returns the kernel
    table rows of the two instances.  Keeps the bfloat16 stepwise run, its
    steps, the float32 run of as many steps and the assignment in
    ``stacked`` for phase 4j."""
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
        if dtype == "bfloat16":
            stacked["pagerank_bfloat16"] = {"pr": pr_s, "steps": steps,
                                            "float32": pr32,
                                            "assign": res.assign}
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
    bitwise equal to ``scatter``.  One layout at a time.  Returns the
    methods' lines and (graph, cluster, the assignments of
    ``SAMPLING_METHODS``) for phase 4i."""
    from repro_torch.bsp import build_pagerank
    from repro_torch.core import partitioners
    from repro_torch.launch import partition as cli
    check(set(METHODS) <= set(partitioners.names(exclude={"oracle"})),
          f"the registry lacks a method of {METHODS}")
    out, assigns = {}, {}
    for m in METHODS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, launches, wall = counted(lambda: cli.run(
            ["--graph", GRAPH, "--method", m, "--pagerank",
             "--pagerank-iters", str(ITERS), "--backend", "pallas",
             "--device", "cuda"]))
        if m in SAMPLING_METHODS:
            assigns[m] = res.assign
            kept = res.graph, res.cluster
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
    return out, (*kept, assigns)


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
# phase 4i: partitioned GNN sampling
# ---------------------------------------------------------------------------

def edge_keys(g) -> np.ndarray:
    """Sorted ``u * V + v`` of every directed edge of ``g``'s CSR."""
    V = g.num_vertices
    src = np.repeat(np.arange(V, dtype=np.int64), np.diff(g.indptr))
    return np.sort(src * V + g.indices.astype(np.int64))


def hold_minibatch(g, keys, svc, mb, us, home: int, what: str) -> None:
    """Phase 4i's holds on one minibatch, hop by hop: bitwise equal to
    ``sample_fanout_np`` on the same uniforms (every row of hop 1, the
    first ``ORACLE_HOP2_ROWS`` of later hops), every id a neighbour of its
    parent in ``g``'s CSR, ``min(deg, fanout)`` ids a row and no repeat
    without replacement (``fanout`` with it), and ``hop_stats`` equal to a
    host recount with ``np.unique``."""
    from repro_torch.sampling import sample_fanout_np
    csc, V = svc.csc, g.num_vertices
    table = csc.nbr.reshape(-1, csc.max_degree)
    deg, rowmap, gdeg = csc.deg.reshape(-1), csc.flat_rowmap(), g.degree()
    parent = mb.seeds.cpu().numpy()
    for h, (fanout, hop) in enumerate(zip(svc.fanouts, mb.hops)):
        out = hop.cpu().numpy().reshape(-1, fanout)
        n = len(parent) if h == 0 else min(ORACLE_HOP2_ROWS, len(parent))
        rows = np.where(parent[:n] >= 0,
                        rowmap[np.clip(parent[:n], 0, V - 1)], -1)
        want = sample_fanout_np(table, deg, rows, us[h][:n].cpu().numpy(),
                                fanout, replace=svc.replace)
        check(np.array_equal(out[:n], want), f"{what}: hop {h + 1} differs "
              f"from sample_fanout_np on its first {n} rows")
        ok = out >= 0
        par = np.broadcast_to(parent[:, None], out.shape)[ok]
        key = par.astype(np.int64) * V + out[ok]
        at = np.searchsorted(keys, key).clip(max=len(keys) - 1)
        check(bool((par >= 0).all() and (keys[at] == key).all()),
              f"{what}: hop {h + 1} sampled an id that is no neighbour of "
              f"its parent")
        d = np.where(parent >= 0, gdeg[np.clip(parent, 0, V - 1)], 0)
        rows_want = (np.where(d > 0, fanout, 0) if svc.replace
                     else np.minimum(d, fanout))
        check(np.array_equal(ok.sum(axis=1), rows_want),
              f"{what}: hop {h + 1} rows hold other counts than "
              f"{'fanout' if svc.replace else 'min(deg, fanout)'}")
        if not svc.replace:
            srt = np.sort(out, axis=1)
            check(not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(),
                  f"{what}: hop {h + 1} repeats a neighbour in a row")
        flat = out.reshape(-1)
        valid = flat >= 0
        remote = valid & (csc.owner[np.clip(flat, 0, V - 1)] != home)
        recount = (int(valid.sum()), int(remote.sum()),
                   len(np.unique(flat[remote])))
        check(dataclasses.astuple(mb.hop_stats[h]) == recount,
              f"{what}: hop {h + 1} stats {mb.hop_stats[h]} != host "
              f"recount {recount}")
        parent = flat


def synced(fn):
    """``fn()`` and its wall seconds, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def batch_profile(fn, wall_ms: float, reps: int = 3) -> dict:
    """Where a call of ``fn()`` spends the card's time: device ms a call
    (kernels and copies, torch.profiler over ``reps`` calls), its share of
    the call's synchronised wall ``wall_ms`` (the busy share; the rest is
    the device idle behind the host), and the kernels that take most."""
    events = device_events(profile_calls(fn, reps)[0])
    device = sum(e.self_device_time_total for e in events) / reps / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {"device_ms": device, "busy_share": device / wall_ms,
            "top": [{"kernel": e.key[:90], "calls": e.count / reps,
                     "ms": e.self_device_time_total / reps / 1e3}
                    for e in top]}


def cache_state(c) -> tuple:
    return (c.hits, c.misses, c.evictions, c.bytes_fetched, c.lru_ids(),
            c.hub_ids.tolist())


def pipeline_rates(svc, store, seed: int, method: str, cached: bool
                   ) -> dict:
    """``PrefetchPipeline`` on home 0 at depth 0 and ``PIPE_DEPTH``, each
    run ``PIPE_BATCHES`` batches with a fresh cache (or none): the two
    streams and cache states must be bitwise equal.  Returns batches/s
    (synchronised wall) at each depth."""
    from repro_torch.sampling import HaloCache, PrefetchPipeline
    runs = []
    for depth in (0, PIPE_DEPTH):
        cache = (HaloCache.for_home(store, 0, CACHE_ROWS, HUB_FRAC)
                 if cached else None)

        def run_pipeline():
            with PrefetchPipeline(svc, home=0, batch_size=SAMPLE_SEEDS,
                                  num_batches=PIPE_BATCHES, seed=seed,
                                  depth=depth, store=store,
                                  cache=cache) as pl:
                return list(pl)
        got, dt = synced(run_pipeline)
        runs.append((got, cache_state(cache) if cached else None, dt))
    (a, sa, dt0), (b, sb, dt2) = runs
    check(len(a) == len(b) == PIPE_BATCHES and sa == sb and all(
        all(torch.equal(x, y) for x, y in zip(ma.hops, mb.hops))
        and ma.hop_stats == mb.hop_stats and torch.equal(fa, fb)
        for (ma, fa), (mb, fb) in zip(a, b)),
          f"{method}: the pipeline at depth {PIPE_DEPTH} differs from depth "
          f"0 ({'with' if cached else 'without'} the cache)")
    return {"depth_0": PIPE_BATCHES / dt0,
            f"depth_{PIPE_DEPTH}": PIPE_BATCHES / dt2}


def sample_method(g, cl, assign, method: str, seed: int, feats, keys
                  ) -> dict:
    """Phase 4i for one partition: its tables, the held batches of every
    home in both replacement modes, the timings and the pipeline."""
    from repro_torch.bsp import PartitionRuntime
    from repro_torch.sampling import (FeatureStore, HaloCache, MachineCSC,
                                      SamplingService, batch_generators)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    csc = MachineCSC.build(PartitionRuntime.create(g, assign=assign,
                                                   cluster=cl, device="cuda"))
    csc_s = time.perf_counter() - t0
    store = FeatureStore.build(csc, feats, device="cuda")
    caches = [HaloCache.for_home(store, h, CACHE_ROWS, HUB_FRAC)
              for h in range(csc.p)]
    batch = itertools.count()
    out = {"method": method, "graph": GRAPH, "p": csc.p, "omax": csc.omax,
           "max_degree": csc.max_degree, "csc_build_s": csc_s,
           "fanouts": list(FANOUTS), "seeds_a_batch": SAMPLE_SEEDS,
           "feat_dim": FEAT_DIM, "cache_rows": CACHE_ROWS,
           "hub_frac": HUB_FRAC}
    for replace, per_home in ((False, 2), (True, 1)):
        mode = "with_replacement" if replace else "without_replacement"
        svc, upload_s = synced(lambda: SamplingService(
            csc, fanouts=FANOUTS, replace=replace, device="cuda"))
        sizes, fracs, fetched, misses = [], [], [], []
        for home in range(csc.p):
            for _ in range(per_home):
                what = f"{method} {mode} home {home}"
                g_seed, g_hop = batch_generators(seed, next(batch), "cuda")
                seeds = svc.local_seeds(home, SAMPLE_SEEDS, g_seed)
                us = svc.draw_uniforms(len(seeds), g_hop)
                mb = svc.sample_khop(seeds, us, home)
                loop = svc.sample_khop(seeds, us, home, fused=False)
                check(all(torch.equal(a, b)
                          for a, b in zip(mb.hops, loop.hops))
                      and mb.hop_stats == loop.hop_stats,
                      f"{what}: fused != loop on the same uniforms")
                hold_minibatch(g, keys, svc, mb, us, home, what)
                ids = mb.all_ids()
                rows, st = store.gather(ids, home, caches[home])
                bound = sum(s.fetched_unique for s in mb.hop_stats)
                check(torch.equal(rows, store.gather_global(ids))
                      and st.misses <= bound,
                      f"{what}: gather != gather_global or {st.misses} "
                      f"misses above the bound {bound}")
                sizes.append(len(seeds))
                fracs.append(mb.halo_fracs())
                fetched.append([s.fetched_unique for s in mb.hop_stats])
                misses.append(st.misses)
        fused_t, loop_t, verts, gather_t = [], [], [], {"cache": [],
                                                        "no_cache": []}
        for k in range(TIMED_BATCHES + 1):        # the first is a warm-up
            i, home = next(batch), k % csc.p
            seeds = svc.local_seeds(home, SAMPLE_SEEDS,
                                    batch_generators(seed, i, "cuda")[0])
            mb, dt = synced(lambda: svc.sample(
                seeds, batch_generators(seed, i, "cuda")[1], home))
            loop, dt_loop = synced(lambda: svc.sample(
                seeds, batch_generators(seed, i, "cuda")[1], home,
                fused=False))
            check(all(torch.equal(a, b) for a, b in zip(mb.hops, loop.hops)),
                  f"{method} {mode}: timed fused != loop")
            ids = mb.all_ids()
            _, dt_c = synced(lambda: store.gather(ids, home, caches[home]))
            _, dt_n = synced(lambda: store.gather(ids, home))
            if k:
                fused_t.append(dt)
                loop_t.append(dt_loop)
                verts.append(mb.num_sampled())
                gather_t["cache"].append(dt_c)
                gather_t["no_cache"].append(dt_n)
        med = statistics.median
        i = next(batch)
        seeds = svc.local_seeds(0, SAMPLE_SEEDS,
                                batch_generators(seed, i, "cuda")[0])
        profiles = {
            name: batch_profile(lambda: svc.sample(
                seeds, batch_generators(seed, i, "cuda")[1], 0,
                fused=fused), 1e3 * med(times))
            for name, fused, times in (("fused", True, fused_t),
                                       ("loop", False, loop_t))}
        ids = svc.sample(seeds, batch_generators(seed, i, "cuda")[1],
                         0).all_ids()
        profiles["gather_cache"] = batch_profile(
            lambda: store.gather(ids, 0, caches[0]),
            1e3 * med(gather_t["cache"]))
        entry = {
            "table_upload_s": upload_s,
            "table_gb": svc._table.numel() * 4 / 1e9,
            "batches_held": len(fracs), "seeds_min": min(sizes),
            "halo_frac_mean_by_hop": np.mean(fracs, axis=0).tolist(),
            "fetched_unique_mean_by_hop": np.mean(fetched, axis=0).tolist(),
            "gather_misses_mean": float(np.mean(misses)),
            "fused_minibatches_per_s": 1 / med(fused_t),
            "loop_minibatches_per_s": 1 / med(loop_t),
            "fused_sampled_vertices_per_s": med(
                [v / t for v, t in zip(verts, fused_t)]),
            "loop_sampled_vertices_per_s": med(
                [v / t for v, t in zip(verts, loop_t)]),
            "fused_ms_median": 1e3 * med(fused_t),
            "loop_ms_median": 1e3 * med(loop_t),
            "gather_ms_cache": 1e3 * med(gather_t["cache"]),
            "gather_ms_no_cache": 1e3 * med(gather_t["no_cache"]),
            "profile": profiles}
        if not replace:
            entry["pipeline_batches_per_s"] = {
                "cache": pipeline_rates(svc, store, seed, method, True),
                "no_cache": pipeline_rates(svc, store, seed, method, False)}
        out[mode] = entry
        del svc
        torch.cuda.empty_cache()
    out["cache_hit_rate_by_home"] = [c.hit_rate for c in caches]
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def sampling_phase(g, cl, assigns: dict, seed: int, lines: list) -> dict:
    """Phase 4i: partitioned GNN sampling at the graph path's graph on
    phase 4f's partitions (WindGP at the CLI's defaults), repacked by
    ``PartitionRuntime.create(g, assign=...)``, one method's tables at a
    time; WindGP's mean hop-1 halo fraction must lie below hash's."""
    feats = np.random.default_rng(seed).standard_normal(
        (g.num_vertices, FEAT_DIM), dtype=np.float32)
    keys = edge_keys(g)
    out = {}
    for m in SAMPLING_METHODS:
        r = sample_method(g, cl, assigns[m], m, seed, feats, keys)
        out[m] = r
        lines.append({"sampling": r})
        w = r["without_replacement"]
        log(f"phase 4i: {m} Omax {r['omax']} D {r['max_degree']}, CSC "
            f"{r['csc_build_s']:.1f}s, table {w['table_gb']:.2f} GB; fused "
            f"{w['fused_minibatches_per_s']:.1f} batches/s, loop "
            f"{w['loop_minibatches_per_s']:.1f}; gather "
            f"{w['gather_ms_cache']:.2f} ms cached "
            f"{w['gather_ms_no_cache']:.2f} ms not; halo "
            f"{w['halo_frac_mean_by_hop']}; peak "
            f"{r['max_memory_allocated_gb']:.1f} GB")
        torch.cuda.empty_cache()
    hop1 = {m: out[m]["without_replacement"]["halo_frac_mean_by_hop"][0]
            for m in SAMPLING_METHODS}
    check(hop1["windgp"] < hop1["hash"], f"windgp's mean hop-1 halo "
          f"fraction {hop1['windgp']} is not below hash's {hop1['hash']}")
    return out


# ---------------------------------------------------------------------------
# phase 4j: the multi-device BSP path, one machine a gloo rank on the card
# ---------------------------------------------------------------------------

def mesh_runs(source: int, bf16_steps: int) -> dict:
    """key -> (app, kwargs) of the runs every rank of phase 4j makes."""
    pallas = dict(backend="pallas", block_size=BM)
    fused = dict(fused=True, chunk=CHUNK)
    runs = {"pagerank/pallas/stepwise": ("pagerank",
                                         dict(num_iters=ITERS, **pallas)),
            "pagerank/pallas/fused": ("pagerank",
                                      dict(num_iters=ITERS, **pallas,
                                           **fused))}
    for app in ("sssp", "bfs", "cc"):
        base = dict(num_iters=SPARSE_ITERS)
        if app != "cc":
            base["source"] = source
        for be, opts in (("pallas", pallas), ("scatter", {})):
            runs[f"{app}/{be}/stepwise"] = (app, dict(**base, **opts))
            runs[f"{app}/{be}/fused"] = (app, dict(**base, **opts, **fused))
    runs["pagerank_bfloat16/pallas/stepwise"] = (
        "pagerank", dict(num_iters=bf16_steps, message_dtype="bfloat16",
                         **pallas))
    return runs


def fused_launches(steps: int, budget: int) -> int:
    """Supersteps a fused run under a mesh launches: every superstep of
    each chunk it ran, the predicated ones too (nothing is captured)."""
    lengths = [min(CHUNK, budget - i) for i in range(0, budget, CHUNK)]
    return sum(lengths[:-(-steps // CHUNK)])


def mesh_rank(rt, mesh, runs: dict) -> dict:
    """One rank of phase 4j (a ``spawn_machines`` rank function): each
    run of ``runs`` with ``bsr_spmv``'s count set to 0 just before and
    read just after; then this machine's float32 PageRank layout (K, GB),
    its kernel timed by CUDA events with the card to itself (the ranks
    take turns), the exchange's ``all_reduce`` of the replica buffer, and
    the superstep wall; and the rank's peak memory."""
    import torch.distributed as dist
    from repro_torch.bsp import (bfs, build_pagerank, connected_components,
                                 pagerank, run_bsp, sssp)
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    fns = {"pagerank": pagerank, "sssp": sssp, "bfs": bfs,
           "cc": connected_components}
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": mesh.rank, "runs": {}}
    for key, (app, kw) in runs.items():
        torch.cuda.synchronize()
        dist.barrier()
        bsr_spmv.launches = 0
        t0 = time.perf_counter()
        res, acts = fns[app](rt, mesh=mesh, **kw)
        torch.cuda.synchronize()
        out["runs"][key] = {"res": res, "acts": acts,
                            "launches": bsr_spmv.launches,
                            "wall_s": time.perf_counter() - t0}
    spec = build_pagerank(rt, backend="pallas", block_size=BM, mesh=mesh)
    cols, blocks = spec.static["eb_bsr_cols"], spec.static["eb_bsr_blocks"]
    x = torch.rand((1, cols.shape[1] * BM), device=blocks.device)
    for r in range(mesh.size):          # one rank at a time on the card
        torch.cuda.synchronize()
        dist.barrier()
        if r == mesh.rank:
            out["kernel_ms"] = burst_ms(lambda: bsr_spmv(cols, blocks, x),
                                        10)
    # the exchange's all_reduce of the replica buffer on the card, and
    # beside it the same bytes from host memory (gloo's transport alone)
    # and their copies to the host and back (no collective)
    # and the fused runner's gate, one element
    buf = torch.zeros(max(1, rt.num_replicas) + 1, device=blocks.device)
    host = torch.zeros(buf.shape)
    gate = torch.zeros(1, device=blocks.device)
    times = {"exchange": [], "exchange_host_buffer": [], "copies": [],
             "gate": []}
    for _ in range(20):
        for what, fn in (
                ("exchange", lambda: mesh.all_reduce(buf, "sum")),
                ("exchange_host_buffer", lambda: mesh.all_reduce(host,
                                                                 "sum")),
                ("copies", lambda: buf.copy_(buf.cpu())),
                ("gate", lambda: mesh.all_reduce(gate, "max"))):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[what].append((time.perf_counter() - t0) * 1e3)
    run_bsp(spec.superstep, spec.state, spec.static, 1, mesh=mesh)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    run_bsp(spec.superstep, spec.state, spec.static, ITERS, mesh=mesh)
    torch.cuda.synchronize()
    nbytes = (blocks.numel() * blocks.element_size() + 4 * cols.numel()
              + 2 * x.numel() * x.element_size())
    out.update(K=int(cols.shape[2]), R=int(cols.shape[1]),
               layout_gb=blocks.numel() * blocks.element_size() / 1e9,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               **{f"{k}_ms_median": statistics.median(v)
                  for k, v in times.items()},
               superstep_wall_ms=(time.perf_counter() - t0) * 1e3 / ITERS,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def mesh_phase(g, cl, assign, stacked: dict, lines: list) -> dict:
    """Phase 4j: the multi-device BSP path at ``graph500:16`` on phase
    4f's WindGP partition, one machine a gloo rank, all 9 ranks on the one
    card (time-sliced: a rehearsal of the distributed mode, not a
    multi-GPU reading).  Each rank runs PageRank in float32 on ``pallas``
    stepwise and fused, SSSP, BFS (from the hub) and CC on ``pallas`` and
    ``scatter`` stepwise and fused, and bfloat16 PageRank on ``pallas``.
    Holds: SSSP, BFS and CC bitwise equal to phase 4b's stacked runs,
    actives included; float32 PageRank within 1e-5·max(pr) of phase 3's;
    bfloat16 PageRank within 1e-4·max(pr) of phase 4d's stacked stepwise
    run and within (0, 1e-2·max(pr)] of float32 (phase 4d's holds); every
    rank launching ``bsr_spmv`` once a superstep; every rank returning the
    same; no rank's peak memory reaching the stacked float32 layout's.
    Returns the ranks' ``bsr_spmv`` launches on the runs by message dtype
    (the kernel's instance): ``{dtype: [launches of rank r]}``."""
    from repro_torch.bsp import (PartitionRuntime, simulate_superstep_times,
                                 spawn_machines)
    low = stacked["pagerank_bfloat16"]
    check(np.array_equal(assign, stacked["assign"])
          and np.array_equal(assign, low["assign"]),
          "phase 4j: phase 4f's WindGP assignment is not phases 3 and 4d's")
    p = cl.p
    runs = mesh_runs(hub(g), low["steps"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_machines(mesh_rank, p, graph=g, assign=assign,
                           args=(runs,), device="cuda",
                           timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    first = ranks[0]["runs"]
    for r in ranks[1:]:
        for key, run in r["runs"].items():
            check(np.array_equal(run["res"], first[key]["res"])
                  and np.array_equal(run["acts"], first[key]["acts"]),
                  f"phase 4j {key}: rank {r['rank']} differs from rank 0")
    held = {}
    for key, (app, kw) in runs.items():
        res, acts = first[key]["res"], first[key]["acts"]
        mode = key.split("/")[-1]
        check(acts.shape[1:] == (p,), f"phase 4j {key}: actives "
              f"{acts.shape} are not (steps, {p})")
        if app in ("sssp", "bfs", "cc"):
            want, want_acts = stacked[app][mode]
            check(np.array_equal(res, want)
                  and np.array_equal(acts, want_acts),
                  f"phase 4j {key}: != the stacked run bitwise")
            held[key] = "bitwise"
        elif "message_dtype" not in kw:
            want, want_acts = stacked["pagerank"]
            scale = float(want.max())
            d = float(np.abs(res - want).max())
            check(d <= 1e-5 * scale and np.array_equal(acts, want_acts),
                  f"phase 4j {key}: {d} from the stacked run")
            held[key] = d / scale
        else:
            scale = float(low["float32"].max())
            d = float(np.abs(res - low["pr"]).max())
            d32 = float(np.abs(res - low["float32"]).max())
            check(d <= PR_LOW_PLAIN_REL * scale, f"phase 4j {key}: "
                  f"{d / scale} of max(pr) from the stacked run")
            check(0 < d32 <= PR_LOW_VS_F32_REL["bfloat16"] * scale,
                  f"phase 4j {key}: {d32 / scale} of max(pr) from float32")
            held[key] = {"vs_stacked": d / scale, "vs_float32": d32 / scale}
        if kw.get("backend") == "pallas":
            steps = len(acts)
            want_l = (fused_launches(steps, kw["num_iters"])
                      if mode == "fused" else steps)
            got_l = [r["runs"][key]["launches"] for r in ranks]
            check(got_l == [want_l] * p, f"phase 4j {key}: ranks launched "
                  f"bsr_spmv {got_l} times, expected {want_l} each")
    peak = [r["peak_gb"] for r in ranks]
    check(max(peak) * 1e9 < stacked["blocks_bytes"], f"phase 4j: a rank's "
          f"peak {max(peak)} GB reaches the stacked layout's "
          f"{stacked['blocks_bytes'] / 1e9} GB")
    rt = PartitionRuntime.build(g, assign, p, device="cuda")   # host arrays
    modelled = simulate_superstep_times(rt, cl)[0]
    per_rank = [{"rank": r["rank"], "K": r["K"], "layout_gb": r["layout_gb"],
                 "peak_gb": r["peak_gb"], "kernel_ms": r["kernel_ms"],
                 "bound_ms": r["bound_ms"],
                 "modelled_superstep": float(modelled[r["rank"]]),
                 "exchange_ms_median": r["exchange_ms_median"],
                 "exchange_host_buffer_ms_median":
                     r["exchange_host_buffer_ms_median"],
                 "copies_ms_median": r["copies_ms_median"],
                 "gate_ms_median": r["gate_ms_median"],
                 "superstep_wall_ms": r["superstep_wall_ms"]}
                for r in ranks]
    launches = {dt: [sum(r["runs"][k]["launches"] for k, (_, kw) in
                         runs.items()
                         if kw.get("message_dtype", "float32") == dt)
                     for r in ranks] for dt in ("float32", "bfloat16")}
    out = {"graph": GRAPH, "ranks": p, "backend": "gloo",
           "devices": "cuda:0, shared", "R": ranks[0]["R"],
           "stacked_K": stacked["K"],
           "stacked_layout_gb": stacked["blocks_bytes"] / 1e9,
           "layout_gb_sum": sum(r["layout_gb"] for r in ranks),
           "kernel_ms_sum": sum(r["kernel_ms"] for r in ranks),
           "bound_ms_sum": sum(r["bound_ms"] for r in ranks),
           "per_rank": per_rank,
           "exchange_all_reduce_ms_median": statistics.median(
               r["exchange_ms_median"] for r in ranks),
           "exchange_host_buffer_ms_median": statistics.median(
               r["exchange_host_buffer_ms_median"] for r in ranks),
           "gate_all_reduce_ms_median": statistics.median(
               r["gate_ms_median"] for r in ranks),
           "superstep_wall_ms": ranks[0]["superstep_wall_ms"],
           "run_wall_s": {k: v["wall_s"] for k, v in first.items()},
           "steps": {k: len(v["acts"]) for k, v in first.items()},
           "holds": held, "spawn_wall_s": wall,
           "launches_per_rank": launches}
    lines.append({"mesh": out})
    for r in per_rank:
        log(f"phase 4j: rank {r['rank']} K={r['K']} "
            f"{r['layout_gb']:.2f} GB, peak {r['peak_gb']:.2f} GB, kernel "
            f"{r['kernel_ms']:.3f} ms (bound {r['bound_ms']:.3f}), modelled "
            f"{r['modelled_superstep']:.4g}")
    log(f"phase 4j: {p} ranks in {wall:.1f}s, exchange all_reduce "
        f"{out['exchange_all_reduce_ms_median']:.3f} ms (from host memory "
        f"{out['exchange_host_buffer_ms_median']:.3f}, gate "
        f"{out['gate_all_reduce_ms_median']:.3f}), superstep wall "
        f"{out['superstep_wall_ms']:.2f} ms, K {min(r['K'] for r in per_rank)}"
        f"-{max(r['K'] for r in per_rank)} (stacked {stacked['K']})")
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


#: (H, KVH, dh) of decode_attn's holds: qwen3-4b's and jamba's widths,
#: granite's (G = 3, dh 64), glm4-9b's (G = 16: the CUDA-core body in
#: bf16), qwen3-14b's (G = 5), musicgen-medium's (G = 1) and
#: paligemma-3b's (dh 256, G = 8); (nh, G, dh, ds) of ssd's: mamba2-780m's
#: and jamba's (ds 16)
DECODE_WIDTHS = {"": (32, 8, 128), "_granite": (24, 8, 64),
                 "_glm4": (32, 2, 128), "_qwen3_14b": (40, 8, 128),
                 "_musicgen": (24, 24, 64), "_paligemma": (8, 1, 256)}
SSD_WIDTHS = {"": (48, 1, 64, 128), "_jamba": (128, 1, 64, 16)}


def hold_lm_kernels(gen) -> dict:
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_ref)
    from repro_torch.kernels.decode_attn.kernel import plan as attn_plan
    from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for arch, (H, KVH, dh) in DECODE_WIDTHS.items():
            # the serving batch, Smax = 2113 (prompt + new + 1): no
            # multiple of the 32-row tile or of the planned split; lengths
            # on the split's edges, ragged, and a 0
            B, S = BATCH, PROMPT + NEW + 1
            tag = f"decode_attn_{name}{arch}"
            q, k, v = decode_inputs(gen, B, H, KVH, dh, S, dtype)
            split = attn_plan(q, k)["split_len"]
            lens = torch.tensor([S, 0, 1000, 1, split - 1, split, split + 1,
                                 S - 1], dtype=torch.int32, device="cuda")
            got = decode_attention(q, k, v, lens)
            want = decode_attention_ref(q, k, v, lens)
            tol = TOL[dtype]["decode"]
            errs[tag] = close(got, want, tol, tag)
            uniform = v[1].float().mean(0).repeat_interleave(H // KVH, dim=0)
            close(got[1], uniform, tol, f"{tag} lengths == 0")
            # the newest key left out, on the rows that keep a key: the
            # hold must reject it
            kept = lens >= 2
            wrong = exceeds(decode_attention(q, k, v, lens - 1)[kept],
                            want[kept], tol)
            errs[f"{tag}_missing_newest_excess"] = wrong
            check(wrong > 1, f"{tag}: the hold passes the newest key left "
                  f"out ({wrong} of its limit)")
        # ssd, T = 300 (no multiple of 128), with the final state; then
        # strong decay
        for arch, (nh, G, dh, ds) in SSD_WIDTHS.items():
            for T, decay in ((300, None), (1000, 5.0)):
                x, b, c, a = ssd_inputs(gen, 2, T, nh, G, dh, ds, dtype,
                                        decay)
                y, h = ssd_chunked(x, b, c, a, chunk=128, return_state=True)
                y_ref, h_ref = ssd_chunked_ref(x, b, c, a, chunk=128,
                                               return_state=True)
                tag = f"ssd_{name}{arch}_T{T}" + ("_decay5" if decay else "")
                errs[tag] = close(y, y_ref, TOL[dtype]["ssd"], tag)
                errs[tag + "_state"] = close(h, h_ref, STATE_TOL,
                                             tag + " final state")
                check(bool(torch.isfinite(y.float()).all()),
                      f"{tag} not finite")
        # the autograd.Function: gradients of x, b, c, a against autograd
        # through the plain version, bitwise (its backward is that VJP)
        for arch, (nh, G, dh, ds) in SSD_WIDTHS.items():
            tag = f"ssd_grad_{name}{arch}"
            errs[tag] = hold_ssd_gradients(gen, nh, G, dh, ds, dtype, tag)
    torch.cuda.synchronize()
    return errs


def hold_ssd_gradients(gen, nh, G, dh, ds, dtype, tag: str) -> float:
    """The ``ssd`` autograd.Function at (nh, G, dh, ds), T = 300 and the
    final state asked for: one kernel launch forward, ``grad_fn`` on both
    outputs, and the gradients of x, b, c and a equal to autograd's
    through the plain version bitwise.  Returns the largest |d|."""
    from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_ref
    x, b, c, a = ssd_inputs(gen, 2, 300, nh, G, dh, ds, dtype)
    wy = torch.randn(x.shape, generator=gen, device="cuda")
    wh = torch.randn((2, nh, ds, dh), generator=gen, device="cuda")

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, b, c, a)]
        y, h = fn(*ins, chunk=128, return_state=True)
        check(y.grad_fn is not None and h.grad_fn is not None,
              f"{tag}: an output without grad_fn")
        ((y.float() * wy).sum() + (h * wh).sum()).backward()
        return [t.grad for t in ins]
    before = ssd_chunked.launches
    got = grads(ssd_chunked)
    torch.cuda.synchronize()
    check(ssd_chunked.launches == before + 1,
          f"{tag}: {ssd_chunked.launches - before} launches, not 1")
    want = grads(ssd_chunked_ref)
    for n, g, w in zip("xbca", got, want):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"{tag}: d{n} differs from the plain VJP by {max_err(g, w)}")
    return max(max_err(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# phases 6-7: serving at full width
# ---------------------------------------------------------------------------

def forward_at(cfg, params, prompts, tokens) -> torch.Tensor:
    """``forward`` over prompt + tokens (fed as ``generate`` feeds them
    back), float32 logits at the positions that produced ``tokens``
    (B, n, V)."""
    from repro_torch.models import forward
    from repro_torch.serve import next_inputs
    P, n = prompts.shape[1], tokens.shape[1]
    fed = [next_inputs(cfg, tokens[:, i]) for i in range(n)]
    ref = forward(cfg, params, torch.cat([prompts, *fed], dim=1))
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
    from repro_torch.serve import next_inputs
    tok = next_inputs(cfg, torch.zeros(lens.shape[0], dtype=torch.long,
                                       device="cuda"))
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
def swapped(module, name: str, fn):
    """Run with ``module.<name>`` replaced by ``fn``."""
    kept = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kept)


def model_calls(name: str, fn):
    """Run the model with ``models.layers.<name>`` (a kernel's wrapper, or
    the MoE router) replaced by ``fn``."""
    from repro_torch.models import layers
    return swapped(layers, name, fn)


def dropless(cfg):
    """``cfg`` at a capacity that drops nothing: cf = E / K makes
    ``moe_capacity`` n, every token of a group once at every expert."""
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


def layer_kinds(cfg) -> set:
    return {cfg.layer_kind(i) for i in range(cfg.pattern_period)}


def recorded_routing(records: list):
    """Run the model with ``models.layers.moe_route`` wrapped so that each
    call appends its top-K expert ids (G, n, K), on the device, to
    ``records``: one a MoE layer, in layer order."""
    from repro_torch.models import layers
    route = layers.moe_route

    def record(cfg, p, xf):
        weights, idx = route(cfg, p, xf)
        records.append(idx)
        return weights, idx
    return model_calls("moe_route", record)


def capacity_drops(cfg, records: list) -> list:
    """The entries each recorded MoE call dropped: per group and expert,
    those beyond ``moe_capacity`` (the expert keeps its first ``cap`` in
    sorted order)."""
    from repro_torch.models.layers import moe_capacity
    E, out = cfg.num_experts, []
    for idx in records:
        G, n, _ = idx.shape
        groups = torch.arange(G, device=idx.device)[:, None, None]
        counts = torch.bincount((idx + E * groups).reshape(-1),
                                minlength=G * E)
        out.append(int((counts - moe_capacity(cfg, n)).clamp_min(0).sum()))
    return out


def reversed_gates(route):
    """A wrong MoE combine: ``route``'s routing with each token's K gate
    weights reversed across its experts (the largest on the K-th)."""
    def wrong(cfg, p, xf):
        weights, idx = route(cfg, p, xf)
        return weights.flip(-1), idx
    return wrong


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
    of h // (H / KVH); with one query head a group (MHA), KV head h + 1."""
    from repro_torch.kernels.decode_attn import decode_attention
    H, KVH = q.shape[1], k.shape[2]
    G = H // KVH
    perm = torch.tensor([(h % KVH) * G + h // KVH if G > 1 else (h + 1) % H
                         for h in range(H)], device=q.device)
    qp = torch.empty_like(q)
    qp[:, perm] = q
    return decode_attention(qp, k, v, lengths)[:, perm]


def attn_wrong_sequence(q, k, v, lengths):
    """A wrong decode attention: sequence b reads the cache of sequence
    b + 1 (the one fault a single KV head leaves to a group mapping)."""
    from repro_torch.kernels.decode_attn import decode_attention
    return decode_attention(q, k.roll(-1, 0), v.roll(-1, 0),
                            lengths.roll(-1, 0))


def mla_without_rope(cfg):
    """A wrong MLA decode step: ``k_rope`` left out of the score (the
    query's rope part zeroed at S == 1, where only the decode steps call
    ``flash_attention`` with one query position)."""
    from repro_torch.models import layers
    plain, dr = layers.flash_attention, cfg.qk_rope_dim

    def wrong(q, k, v, **kw):
        if q.shape[1] == 1:
            q = torch.cat([q[..., :-dr], torch.zeros_like(q[..., -dr:])], -1)
        return plain(q, k, v, **kw)
    return wrong


def decode_faults(cfg, float32: bool) -> list:
    """(name, ``models.layers`` attribute, stand-in) of the wrong decode
    attentions a decode-vs-forward hold reads: MLA's missing ``k_rope``;
    for GQA the wrong KV group (with one KV head, the wrong sequence) and
    the newest key left out, which near-uniform random-init attention
    hides from the bf16 reading ("blind_") and the float32 replay sees."""
    if cfg.attn_type == "mla":
        return [("wrong_no_k_rope", "flash_attention", mla_without_rope(cfg))]
    group = (("wrong_kv_group", attn_wrong_group) if cfg.num_kv_heads > 1
             else ("wrong_sequence", attn_wrong_sequence))
    newest = ("wrong_missing_newest" if float32 else "blind_missing_newest",
              attn_missing_newest)
    return [(n, "decode_attention", fn) for n, fn in (group, newest)]


def bf16_readings(cfg, params, prompts, tokens, logits) -> dict:
    """The bf16 decode-vs-forward reading (rel L2) with the kernel's plain
    version or a wrong function in its place.  The SSD kernel and the MoE
    router serve ``forward``, so their stand-ins replace them there
    (against the sound decode logits); decode attention serves the decode
    steps, so its stand-in runs ``generate`` again."""
    from repro_torch.kernels.ssd import ssd_chunked_ref
    from repro_torch.models import layers
    from repro_torch.serve import generate
    kinds = layer_kinds(cfg)
    out = {}
    in_forward = []
    if "ssm" in kinds:
        in_forward += [("ssd_chunked", "plain_ssd", ssd_chunked_ref),
                       ("ssd_chunked", "wrong_decay_after_input",
                        ssd_decay_after_input),
                       ("ssd_chunked", "wrong_no_diagonal", ssd_no_diagonal)]
        ref = forward_at(cfg, params, prompts, tokens)
    if cfg.num_experts:
        in_forward.append(("moe_route", "wrong_moe_combine",
                           reversed_gates(layers.moe_route)))
    for attr, name, fn in in_forward:
        with model_calls(attr, fn):
            other = forward_at(cfg, params, prompts, tokens)
        out[name] = rel(logits, other)
        if name == "plain_ssd":         # the same function, two summations
            out["forward_kernel_vs_plain_ssd"] = rel(ref, other)
        del other
    if "attn" in kinds:
        for name, attr, fn in decode_faults(cfg, float32=False):
            with model_calls(attr, fn):
                toks, lg = generate(cfg, params, prompts, tokens.shape[1],
                                    return_logits=True)
            out[name] = logits_check(cfg, params, prompts, toks,
                                     lg)["rel_l2"]
    return out


def serve_model(arch: str, lines: list, num_layers: int | None = None,
                routing: dict | None = None) -> dict:
    """Serve ``arch`` at its published config (at ``num_layers`` of depth
    where given: a cut); returns its launch counts and times.  For a MoE
    arch, ``routing`` (where given) receives the prefill's top-K expert
    ids of the MoE layers in ``PLACED_LAYERS``, (tokens, K) numpy each."""
    from repro_torch.configs import get_config
    from repro_torch.models import (active_param_count, decode_step,
                                    init_cache, init_params, param_count)
    from repro_torch.models.layers import moe_capacity
    from repro_torch.serve import generate

    cfg = get_config(arch)
    cut = None
    if num_layers is not None and num_layers != cfg.num_layers:
        cut = {"num_layers": [cfg.num_layers, num_layers],
               "param_count_published": param_count(cfg)}
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == param_count(cfg), f"{arch}: {n_params} parameters, "
          f"param_count {param_count(cfg)}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    if cfg.input_mode == "tokens":
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                generator=gen, device="cuda")
    else:   # an embedding-input stub: frame or patch embeddings
        prompts = torch.randn((BATCH, PROMPT, cfg.d_model), generator=gen,
                              device="cuda")
    torch.cuda.synchronize()

    _, attn, ssd = reset_launches()
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompts, NEW, return_logits=True)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"decode_attn": attn.launches, "ssd": ssd.launches}
    peak = torch.cuda.max_memory_allocated()

    # the prefill alone, as generate runs it, for the prefill/decode split
    # (and the routing of its MoE layers)
    cache = init_cache(cfg, BATCH, PROMPT + NEW + 1, device="cuda")
    zeros = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    prefill_routes: list = []
    with (recorded_routing(prefill_routes) if cfg.num_experts
          else contextlib.nullcontext()):
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
    # decode steps against forward over prompt + output, same positions.
    # Where a MoE layer's capacity drops entries, a token's output depends
    # on the batch it is routed with (the prefill's 16,384 tokens against
    # forward's 4,224), so the two paths compute one function only at a
    # capacity that drops nothing: the holds run there, on the same
    # weights and prompts, and the published capacity is read beside them
    p_chk = prompts[:CHECK_ROWS]
    ccfg = dropless(cfg)
    forward_routes: list = []
    published = None
    if cfg.num_experts:
        with recorded_routing(forward_routes):
            published = logits_check(cfg, params, p_chk, tokens[:CHECK_ROWS],
                                     logits[:CHECK_ROWS])
        tok_chk, lg_chk = generate(ccfg, params, p_chk, NEW,
                                   return_logits=True)
    else:
        tok_chk, lg_chk = tokens[:CHECK_ROWS], logits[:CHECK_ROWS]
    ssd_before = ssd.launches
    bf16_check = logits_check(ccfg, params, p_chk, tok_chk, lg_chk)
    torch.cuda.synchronize()
    forward_ssd = ssd.launches - ssd_before
    limit = BF16_LOGITS_REL_L2[arch]
    check(bf16_check["rel_l2"] <= limit,
          f"{arch}: bf16 decode vs forward logits rel L2 "
          f"{bf16_check['rel_l2']} > {limit}")
    # the limit passes the same function and fails wrong ones
    readings = bf16_readings(ccfg, params, p_chk, tok_chk, lg_chk)
    for name, value in readings.items():
        if name == "plain_ssd":
            check(value <= limit, f"{arch}: bf16 reading with the plain "
                  f"SSD {value} > {limit}")
        elif name.startswith("wrong_"):
            check(value > limit, f"{arch}: bf16 reading of a wrong function "
                  f"({name}) {value} <= {limit}")
    bf16_check["limit"] = limit
    bf16_check["readings"] = readings
    if published is not None:
        bf16_check["published_capacity"] = published
    del params, logits, lg_chk
    torch.cuda.empty_cache()
    # the same in float32: the kernels' float32 instances on the decode
    # and forward paths must compute one function
    torch.cuda.reset_peak_memory_stats()
    cfg32 = dataclasses.replace(ccfg, dtype="float32")
    params = init_params(cfg32, seed=0, device="cuda")
    p32 = prompts[:CHECK_ROWS]
    toks32, logits32 = generate(cfg32, params, p32, REPLAY_NEW,
                                return_logits=True)
    f32_check = logits_check(cfg32, params, p32, toks32, logits32)
    check(f32_check["rel_l2"] <= F32_LOGITS_REL_L2,
          f"{arch}: float32 decode vs forward logits rel L2 "
          f"{f32_check['rel_l2']}")
    if "attn" in layer_kinds(cfg):     # the faults the bf16 check can miss
        for name, attr, fn in decode_faults(cfg32, float32=True):
            with model_calls(attr, fn):
                toks_w, logits_w = generate(cfg32, params, p32, REPLAY_NEW,
                                            return_logits=True)
            wrong = logits_check(cfg32, params, p32, toks_w,
                                 logits_w)["rel_l2"]
            f32_check[name] = wrong
            check(wrong > F32_LOGITS_REL_L2, f"{arch}: float32 reading of "
                  f"a wrong function ({name}) {wrong}")
    peak32 = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    out = {"arch": arch, "params": n_params, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "cut": cut, "batch": BATCH,
           "prompt": PROMPT, "new_tokens": NEW, "init_s": init_s,
           "generate_s": total_s,
           "prefill_s": prefill_s, "decode_s": decode_s,
           "decode_tokens_per_s": BATCH * NEW / decode_s,
           "decode_step_ms": decode_s / NEW * 1e3,
           "max_memory_allocated_gb": peak / 1e9,
           "max_memory_allocated_gb_f32_replay": peak32 / 1e9,
           "launches": launches, "forward_check_ssd_launches": forward_ssd,
           "logits_check_bf16": bf16_check, "logits_check_f32": f32_check,
           "decode_profile": prof}
    if cfg.num_experts:
        n_pre, n_fwd = BATCH * PROMPT, CHECK_ROWS * (PROMPT + NEW)
        out["param_count"] = param_count(cfg)
        out["active_param_count"] = active_param_count(cfg)
        out["moe_layers"] = len(prefill_routes)
        out["capacity_dropped"] = {
            "prefill": {"tokens": n_pre, "cap": moe_capacity(cfg, n_pre),
                        "by_layer": capacity_drops(cfg, prefill_routes)},
            "forward": {"tokens": n_fwd, "cap": moe_capacity(cfg, n_fwd),
                        "by_layer": capacity_drops(cfg, forward_routes)}}
        check(all(moe_capacity(ccfg, n) >= n for n in (
            CHECK_ROWS, CHECK_ROWS * PROMPT, CHECK_ROWS * (PROMPT + NEW))),
            f"{arch}: the holds' capacity drops entries")
        out["hold_capacity_factor"] = ccfg.capacity_factor
        check(len(prefill_routes) == len(forward_routes) == sum(
            cfg.layer_is_moe(i) for i in range(cfg.num_layers)),
            f"{arch}: MoE calls {len(prefill_routes)} in the prefill, "
            f"{len(forward_routes)} in forward")
        if routing is not None:
            for layer in PLACED_LAYERS:
                routing[layer] = prefill_routes[layer].reshape(
                    -1, cfg.experts_per_token).cpu().numpy()
    del prefill_routes, forward_routes
    lines.append(out)
    log(f"{arch}: prefill {prefill_s:.2f}s, decode "
        f"{out['decode_tokens_per_s']:.0f} tokens/s, peak "
        f"{peak / 1e9:.1f} GB (f32 replay {peak32 / 1e9:.1f}), launches "
        f"{launches}, rel L2 bf16 {bf16_check['rel_l2']:.3g} f32 "
        f"{f32_check['rel_l2']:.3g}, readings {readings}")
    return out


def placement_phase(routing: dict, num_experts: int, lines: list) -> dict:
    """Phase 7d: WindGP expert placement on the routing that granite's
    prefill recorded (layer -> (tokens, K) expert ids), against
    round-robin.  Returns the line it appends."""
    from repro_torch.sharding import windgp_placement as wp
    p = len(POD_MEMORY)
    out = {"pods": {"compute": POD_COMPUTE, "memory_experts": POD_MEMORY,
                    "link": POD_LINK}, "layers": {}}
    for layer, r in routing.items():
        t0 = time.perf_counter()
        edges, weights, loads = wp.coactivation_graph(r)
        graph_s = time.perf_counter() - t0
        spent = {"coactivation_graph": 0.0, "windgp": 0.0}

        def timed(name):
            fn = getattr(wp, name)

            def run(*args, **kw):
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    spent[name] += time.perf_counter() - t
            return run
        with swapped(wp, "coactivation_graph", timed("coactivation_graph")), \
                swapped(wp, "windgp", timed("windgp")):
            t0 = time.perf_counter()
            place = wp.place_experts(num_experts, r, POD_COMPUTE, POD_MEMORY,
                                     POD_LINK)
            total_s = time.perf_counter() - t0
        again = wp.place_experts(num_experts, r, POD_COMPUTE, POD_MEMORY,
                                 POD_LINK)
        held = np.bincount(place, minlength=p)
        check(place.shape == (num_experts,) and bool(
            ((place >= 0) & (place < p)).all()),
            f"phase 7d layer {layer}: an expert is not placed: {place}")
        check(bool((held <= np.array(POD_MEMORY) + 1).all()),
              f"phase 7d layer {layer}: pods hold {held.tolist()} experts, "
              f"memory {POD_MEMORY} (+1)")
        check(np.array_equal(place, again),
              f"phase 7d layer {layer}: a second call placed otherwise")
        rr = np.arange(num_experts) % p
        t0 = time.perf_counter()
        cost = wp.placement_cost(place, r, POD_COMPUTE, POD_LINK)
        cost_s = time.perf_counter() - t0
        cost_rr = wp.placement_cost(rr, r, POD_COMPUTE, POD_LINK)
        out["layers"][layer] = {
            "tokens": int(r.shape[0]), "k": int(r.shape[1]),
            "edges": int(len(edges)), "edge_weight_sum": float(weights.sum()),
            "edge_weight_min": float(weights.min()),
            "edge_weight_max": float(weights.max()),
            "expert_load_min": int(loads.min()),
            "expert_load_max": int(loads.max()),
            "pod_experts": held.tolist(), "pod_experts_round_robin":
                np.bincount(rr, minlength=p).tolist(),
            "makespan_windgp": cost, "makespan_round_robin": cost_rr,
            "windgp_beats_round_robin": bool(cost < cost_rr),
            "coactivation_graph_s": graph_s,
            "place_experts_s": total_s,
            "place_experts_coactivation_graph_s":
                spent["coactivation_graph"],
            "place_experts_windgp_s": spent["windgp"],
            "place_experts_rest_s": total_s - spent["coactivation_graph"]
            - spent["windgp"],
            "placement_cost_s": cost_s}
        log(f"phase 7d: layer {layer}: {len(edges)} co-activation edges, "
            f"makespan windgp {cost} round-robin {cost_rr}, pods "
            f"{held.tolist()}, place_experts {total_s:.2f}s (windgp "
            f"{spent['windgp']:.2f}s)")
    lines.append({"expert_placement": out})
    return out


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------

def ssd_no_grad(x, b, c, a, **kw):
    """A wrong SSD for training: the kernel on detached inputs, so nothing
    before it in a layer (in-projection, conv, dt) gets a gradient through
    it, as the wrapper behaved before its autograd.Function."""
    from repro_torch.kernels.ssd import ssd_chunked
    return ssd_chunked(x.detach(), b.detach(), c.detach(), a.detach(), **kw)


def synthetic_batches(cfg, batch: int, steps: int) -> list:
    """``steps`` SyntheticLM batches (seed 0) of ``batch`` × TRAIN_SEQ
    tokens, on the card."""
    from repro_torch.data.lm_data import LMDataState, SyntheticLM
    data, state = SyntheticLM(cfg.vocab_size, seed=0), LMDataState(0, 0)
    out = []
    for _ in range(steps):
        b, state = data.batch(state, batch, TRAIN_SEQ)
        out.append({k: torch.from_numpy(v).to("cuda") for k, v in b.items()})
    return out


def gradient_hold(cfg, batch) -> dict:
    """float32 gradients of ``cfg`` (full depth) on ``batch``, remat on:
    through the ssd kernel and its autograd.Function against through the
    plain SSD; every parameter's finite and nonzero; and a wrong reading,
    the ssd gradient dropped (``ssd_no_grad``), which must exceed the
    limit."""
    from repro_torch.kernels.ssd import ssd_chunked_ref
    from repro_torch.models import init_params
    from repro_torch.train import loss_and_grads
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device="cuda").requires_grad_()
    with model_calls("ssd_chunked", ssd_chunked_ref):
        plain_loss, plain = loss_and_grads(cfg32, params, batch, remat=True)

    def reading(grads) -> tuple[float, str]:
        return max((rel(g, plain[n].float()), n) for n, g in grads.items())
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(cfg32, params, batch, remat=True)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    bad = [n for n, g in grads.items()
           if not (bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0))]
    check(not bad, f"{cfg.name}: parameters without a finite, nonzero "
          f"gradient: {bad}")
    sound, sound_leaf = reading(grads)
    del grads
    with model_calls("ssd_chunked", ssd_no_grad):
        _, wrong = loss_and_grads(cfg32, params, batch, remat=True)
    dropped, dropped_leaf = reading(wrong)
    del wrong, plain, params
    torch.cuda.empty_cache()
    check(sound <= GRAD_F32_REL_L2, f"{cfg.name}: float32 gradients through "
          f"the ssd kernel {sound} ({sound_leaf}) from the plain SSD's")
    check(dropped > GRAD_F32_REL_L2, f"{cfg.name}: the hold passes the ssd "
          f"gradient dropped ({dropped})")
    return {"layers": cfg.num_layers, "limit": GRAD_F32_REL_L2,
            "loss_kernel": float(loss), "loss_plain": float(plain_loss),
            "rel_l2_max": sound, "rel_l2_max_leaf": sound_leaf,
            "wrong_ssd_grad_dropped": dropped,
            "wrong_ssd_grad_dropped_leaf": dropped_leaf,
            "f32_step_s": step_s}


def batch_loss(cfg, params, batch, counters=()) -> float:
    """The training loss of ``params`` on ``batch`` (no gradient), its
    kernel launches left out of ``counters``' counts."""
    from repro_torch.train import make_loss_fn
    counts = [k.launches for k in counters]
    with torch.no_grad():
        loss = float(make_loss_fn(cfg, remat=False)(
            params, batch["inputs"], batch["labels"]))
    for k, n in zip(counters, counts):
        k.launches = n
    return loss


def states_equal(a, b) -> bool:
    """The same parameters, moments and step, bitwise."""
    pa, pb = dict(a[0].named_parameters()), dict(b[0].named_parameters())
    return int(a[1]["step"]) == int(b[1]["step"]) and all(
        torch.equal(pa[n], pb[n]) and torch.equal(a[1]["m"][n], b[1]["m"][n])
        and torch.equal(a[1]["v"][n], b[1]["v"][n]) for n in pa)


def train_model(arch: str, lines: list, holds: bool = False) -> dict:
    """Train ``arch`` at its published config for TRAIN_STEPS steps of
    ``make_train_step`` (bf16, remat), the launches counted over those
    steps, and the held-out loss before the first step and after each
    against the training batches' spread.  With ``holds``: the float32
    gradient hold first, and a
    checkpoint at CKPT_STEP, restored on the card into other weights
    (bitwise the saved state) and resumed to the end against the run that
    went straight through."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train import adamw_init, make_train_step
    cfg = get_config(arch)
    B = TRAIN_BATCH[arch]
    batches = synthetic_batches(cfg, B, TRAIN_STEPS + 1)
    held = batches.pop()
    out = {"arch": arch, "batch": B, "seq": TRAIN_SEQ, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "remat": True, "lr": TRAIN_LR,
           "steps": TRAIN_STEPS}
    if holds:
        out["grad_hold_f32"] = gradient_hold(cfg, batches[0])
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device="cuda").requires_grad_()
    opt = adamw_init(params)
    out["params"] = sum(p.numel() for p in params.parameters())
    at_init = [batch_loss(cfg, params, b) for b in batches]
    held_losses = [batch_loss(cfg, params, held)]
    step = make_train_step(cfg, lr=TRAIN_LR, remat=True)
    bsr, attn, ssd = reset_launches()
    losses, gnorms, step_ms, twin = [], [], [], None
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        held_losses.append(batch_loss(cfg, params, held, (bsr, attn, ssd)))
        if holds and i + 1 == CKPT_STEP:
            counts = (bsr.launches, attn.launches, ssd.launches)
            twin, out["checkpoint"] = checkpoint_hold(cfg, params, opt)
            bsr.launches, attn.launches, ssd.launches = counts
    out["launches"] = {"bsr_spmv": bsr.launches,
                       "decode_attn": attn.launches, "ssd": ssd.launches}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(losses=losses, grad_norms=gnorms, step_ms=step_ms,
               step_ms_median=statistics.median(step_ms[1:]),
               tokens_per_s=B * TRAIN_SEQ / statistics.median(step_ms[1:])
               * 1e3)
    spread = max(at_init) - min(at_init)
    drop = held_losses[0] - held_losses[-1]
    out.update(batch_losses_at_init=at_init, batch_spread_at_init=spread,
               held_out_losses=held_losses, held_out_drop=drop,
               ln_vocab=math.log(cfg.vocab_size))
    check(all(np.isfinite(losses + held_losses)),
          f"{arch}: training loss not finite")
    check(drop > spread, f"{arch}: the held-out loss fell {drop} over "
          f"{TRAIN_STEPS} steps, not above the batches' spread {spread}: "
          f"{held_losses}")
    if holds:
        tp, to = twin
        resumed = []
        for b in batches[CKPT_STEP:]:
            tp, to, m = step(tp, to, b)
            resumed.append(float(m["loss"]))
        loss_d = max(abs(x - y) / abs(y)
                     for x, y in zip(resumed, losses[CKPT_STEP:]))
        pa, pb = dict(params.named_parameters()), dict(tp.named_parameters())
        param_d = max(rel(pb[n].detach(), pa[n].detach().float())
                      for n in pa)
        out["checkpoint"].update(
            resumed_losses=resumed, loss_rel_max=loss_d,
            param_rel_l2_max=param_d,
            bitwise=states_equal((params, opt), (tp, to)))
        check(loss_d <= RESUME_REL and param_d <= RESUME_REL,
              f"{arch}: resumed run from the straight one: losses {loss_d},"
              f" parameters {param_d}")
        del tp, to
    del params, opt, twin
    torch.cuda.empty_cache()
    lines.append({"training": out})
    log(f"phase 9: {arch} losses {[round(x, 4) for x in losses]}, held "
        f"out {[round(x, 4) for x in held_losses]} (spread "
        f"{spread:.4f}), step "
        f"{out['step_ms_median']:.1f} ms, {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {out['peak_gb']:.1f} GB, launches {out['launches']}")
    return out


def checkpoint_hold(cfg, params, opt):
    """Save (params, opt) under ``build/``, restore it on the card into
    weights drawn from another seed, and check the restored state is
    bitwise the saved one.  Returns ((twin params, twin opt), reading)."""
    import shutil
    from repro_torch.models import init_params
    from repro_torch.train import CheckpointManager, adamw_init
    directory = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    mgr = CheckpointManager(str(directory), keep=1)
    t0 = time.perf_counter()
    mgr.save(CKPT_STEP, {"params": params, "opt": opt},
             extra={"data_seed": 0, "data_cursor": CKPT_STEP})
    save_s = time.perf_counter() - t0
    nbytes = (directory / f"step_{CKPT_STEP:010d}" / "arrays.npz").stat().st_size
    twin = init_params(cfg, seed=1, device="cuda").requires_grad_()
    t0 = time.perf_counter()
    restored, at, extra = mgr.restore({"params": twin,
                                       "opt": adamw_init(twin)},
                                      device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(directory, ignore_errors=True)
    state = (restored["params"], restored["opt"])
    same = states_equal((params, opt), state)
    check(same and at == CKPT_STEP and extra["data_cursor"] == CKPT_STEP,
          f"{cfg.name}: the restored checkpoint is not the saved state")
    return state, {"step": at, "gb": nbytes / 1e9, "save_s": save_s,
                   "restore_s": restore_s, "restored_bitwise": same}


def time_ssd_training(gen, layers: int, forward_launches: int) -> dict:
    """The ssd autograd.Function at mamba2-780m's training shape (8 × 2048,
    48 heads of 64, ds 128, bf16): the kernel's forward ms a launch
    (profiler) and the plain backward's ms a call (CUDA events, median of
    3; it recomputes the plain forward), and both a training step."""
    from repro_torch.kernels.ssd import ssd_chunked
    B, nh, G, dh, ds = TRAIN_BATCH["mamba2-780m"], 48, 1, 64, 128
    ins = [t.requires_grad_() for t in ssd_inputs(
        gen, B, TRAIN_SEQ, nh, G, dh, ds, torch.bfloat16)]
    fwd = timing(lambda: ssd_chunked(*ins, chunk=128), 10, ssd_chunked,
                 "ssd_scan")
    y = ssd_chunked(*ins, chunk=128)
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    bwd_ms = median_ms(lambda: torch.autograd.grad(y, ins, gy,
                                                   retain_graph=True), 3)
    per_step = forward_launches / TRAIN_STEPS
    return {"forward_ms": fwd["ms"], "plain_backward_ms": bwd_ms,
            "forward_launches_per_step": per_step,
            "backward_calls_per_step": layers,
            "forward_ms_per_step": fwd["ms"] * per_step,
            "plain_backward_ms_per_step": bwd_ms * layers}


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
                    help="seed of phase 4h's inserts and deletes and of "
                    "phase 4i's features and minibatches")
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
    stacked: dict = {}
    res, spmv_entry = graph_path(gen, lines, stacked)
    torch.cuda.empty_cache()
    apps = sparse_apps(res.graph, res.runtime, lines, stacked)
    spmv_entry["launches_sparse_apps"] = {
        app: a["launches"] for app, a in apps.items()}
    frontier_phase(res.graph, res.runtime, lines)
    graph = res.graph
    del res
    torch.cuda.empty_cache()
    spmv_16bit = low_precision_pagerank(gen, lines, stacked)
    triangle_phase(graph, lines)
    torch.cuda.empty_cache()

    # -- phases 4f-4h: the partition front end -----------------------------
    methods, (g500, cl500, assigns) = paper_comparison(lines)
    spmv_entry["launches_paper_comparison"] = {
        m: r["launches"] for m, r in methods.items()}
    out_dir, stream_rt, stream_launches = stream_route(lines)
    spmv_entry["launches_stream_route"] = stream_launches
    torch.cuda.empty_cache()
    spmv_entry["launches_dynamic_sssp"] = dynamic_phase(
        out_dir, stream_rt, args.seed, lines)
    del stream_rt
    torch.cuda.empty_cache()

    # -- phase 4i: partitioned GNN sampling --------------------------------
    sampling_phase(g500, cl500, assigns, args.seed, lines)
    torch.cuda.empty_cache()

    # -- phase 4j: the multi-device BSP path -------------------------------
    mesh_launches = mesh_phase(g500, cl500, assigns["windgp"], stacked,
                               lines)
    for entry in (spmv_entry, *spmv_16bit):
        per_rank = mesh_launches.get(entry["dtype"])
        if per_rank:
            entry["launches_mesh"] = sum(per_rank)
            entry["launches_mesh_per_rank"] = per_rank
    del g500, assigns

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

    # -- phases 7b-7d: MoE and hybrid serving, expert placement -----------
    routing: dict = {}
    granite = serve_model("granite-moe-3b-a800m", lines, routing=routing)
    check(granite["launches"] == {"decode_attn": 32 * NEW, "ssd": 0},
          f"granite-moe-3b-a800m launches {granite['launches']} != 32 x "
          f"{NEW} decode_attn")
    torch.cuda.empty_cache()
    jamba = serve_model("jamba-v0.1-52b", lines, num_layers=JAMBA_LAYERS)
    check(jamba["launches"] == {"decode_attn": NEW, "ssd": 7},
          f"jamba-v0.1-52b launches {jamba['launches']} != {NEW} "
          f"decode_attn, 7 ssd")
    check(jamba["forward_check_ssd_launches"] == 7,
          "jamba-v0.1-52b forward did not launch ssd 7 times")
    torch.cuda.empty_cache()
    placement_phase(routing, 40, lines)

    # -- phase 7e: the remaining archs at their published configs ---------
    from repro_torch.configs import get_config
    served = {}
    for arch in NEW_ARCHS:
        served[arch] = serve_model(arch, lines)
        cfg = get_config(arch)
        want = 0 if cfg.attn_type == "mla" else cfg.num_layers * NEW
        check(served[arch]["launches"] == {"decode_attn": want, "ssd": 0},
              f"{arch} launches {served[arch]['launches']} != {want} "
              f"decode_attn")
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

    # -- phase 9: training ------------------------------------------------
    t0 = time.perf_counter()
    mamba_train = train_model("mamba2-780m", lines, holds=True)
    check(mamba_train["launches"] == {
        "bsr_spmv": 0, "decode_attn": 0, "ssd": 2 * 48 * TRAIN_STEPS},
        f"mamba2-780m training launches {mamba_train['launches']} != "
        f"{2 * 48 * TRAIN_STEPS} ssd (forward and remat recompute)")
    ssd_train = time_ssd_training(gen, 48, mamba_train["launches"]["ssd"])
    lines.append({"ssd_training": ssd_train})
    qwen_train = train_model("qwen3-4b", lines)
    check(qwen_train["launches"] == {"bsr_spmv": 0, "decode_attn": 0,
                                     "ssd": 0},
          f"qwen3-4b training launched {qwen_train['launches']}")
    log(f"phase 9 in {time.perf_counter() - t0:.1f}s: ssd forward "
        f"{ssd_train['forward_ms']:.3f} ms, plain backward "
        f"{ssd_train['plain_backward_ms']:.3f} ms")

    for line in lines:
        print(json.dumps(line))
    print(json.dumps({"kernels": [spmv_entry, *spmv_16bit, {
        "name": "decode_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/kernel.py:59",
        "launches": qwen["launches"]["decode_attn"],
        "launches_by_arch": {r["arch"]: r["launches"]["decode_attn"]
                             for r in (qwen, granite, jamba,
                                       *served.values())},
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
        "launches_by_arch": {r["arch"]: r["launches"]["ssd"]
                             for r in (mamba, jamba)},
        "forward_launches_by_arch": {r["arch"]:
                                     r["forward_check_ssd_launches"]
                                     for r in (mamba, jamba)},
        "launches_training": mamba_train["launches"]["ssd"],
        "training_forward_ms": ssd_train["forward_ms"],
        "training_plain_backward_ms": ssd_train["plain_backward_ms"],
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
