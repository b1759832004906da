#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (every check is stated with its tolerance; any failed check makes
the script exit non-zero after it has printed what it measured):

1. build the hand-written CUDA kernels (``bsr_spmv``, ``bsr_spmv_rows``,
   ``decode_attn``, ``ssd``) from the sources in this checkout, one
   ``nvcc`` each, all at once;
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
   for 20 supersteps on the ``pallas`` backend (``bsr_spmv_rows`` over
   the row layout), on ``cuda``.
   On the same runtime, the ``scatter`` backend and the float64 numpy
   oracle must agree within 1e-5·max(pr), and the PageRank mass within
   1e-5 relative;
4. time ``bsr_spmv_rows`` on the graph path's row layout (profiler, no
   bytes floor: the 17 MB it reads can stay in L2; and with L2 flushed
   before each call) beside its plain version and ``torch.sparse.mm``, and ``bsr_spmv``, its plain version
   and a library yardstick on the dense 37 GB Block-ELL layout of the
   same runtime, which no app reads any more, and the superstep of both
   backends; then free the dense blocks.  On the same runtime: 4b. SSSP,
   BFS (from the hub vertex) and CC
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
   row kernel held on the run's row layout inside
   ``plus_times_bounds_rows``, and the dense 16-bit kernel held on its
   18.6 GB layout inside ``plus_times_bounds``, where two planted faults
   must fail the hold, and timed;
   4e. ``triangle_count`` against the oracle at ``rmat:15``
   (at ``graph500:16`` nearly every edge takes the host fallback);
   4f. the paper's comparison at ``graph500:16`` on the default cluster:
   each of hash, dbh, greedy, hdrf, ebv, ne, metis and windgp through the
   CLI entry with ``pallas`` PageRank, within 1e-5·max(pr) of ``scatter``,
   and SSSP from the hub bitwise equal to ``scatter``, with the host
   partition seconds, TC, RF, the row layout's entries, MB and build
   seconds,
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
   holding only its machine's row layout.  Each rank
   runs float32 PageRank on ``pallas`` stepwise and fused, SSSP, BFS (from
   the hub) and CC on ``pallas`` and ``scatter`` stepwise and fused, and
   bfloat16 PageRank on ``pallas``: SSSP, BFS and CC bitwise equal to
   4b's stacked runs, actives included, float32 PageRank within
   1e-5·max(pr) of phase 3's, bfloat16 within 4d's holds (1e-4·max(pr) of
   4d's stacked run, within 1e-2·max(pr) of float32), every rank
   launching ``bsr_spmv_rows`` once a superstep (under a mesh the fused
   chunk is not captured, so its predicated tail launches too), every
   rank returning the same and no rank's layout reaching the stacked
   layout's bytes.  Prints per rank its entries, layout MB, peak GB,
   kernel ms (10
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
   reject; at jamba's long_500k (one sequence over 524,288 positions) at
   its full length, one short and one past the split; ``ssd`` at
   mamba2-780m's widths (48 heads, ds 128) and
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
   7e. the remaining archs at their published configs (glm4-9b and
   qwen3-14b at 5 of 40 layers, musicgen-medium at 6 of 48, minicpm3-4b
   at 31 of 62, to keep the whole run within 800 s), served as in 6:
   glm4-9b, qwen3-14b,
   minicpm3-4b (MLA: the plain blockwise attention at every S, no
   kernel), musicgen-medium and
   paligemma-3b (embedding-input stubs: (8, 2048, d) prompts drawn from
   the seed, each token fed back as ``jax.nn.one_hot``'s row).
   ``decode_attn`` launches layers × 64 times (minicpm3-4b never).  Each
   is held decode-vs-``forward`` in bf16 and in the float32 replay, and
   read with wrong decode attentions that must exceed the limits: MLA
   with ``k_rope`` left out of the score; the wrong KV group (MHA: the
   next head), or with one KV head the wrong sequence's cache; the
   newest key left out (float32);
   7f. phi3.5-moe-42b-a6.6b at full width (84 GB of bf16 weights over 32
   layers exceed the card), at the deepest depth that
   ``launch.dryrun.max_layers`` says fits both its bf16 serving run and
   the float32 replay (14 on an H100 80GB), held as granite is;
8. time ``decode_attn`` at the serving shape, at S = 32768 and at B = 1,
   S = 524,288, and ``ssd`` at mamba2-780m's and jamba's prefill shapes,
   beside their plain versions, a library call where one exists, and
   their bounds.  These times are device time from torch.profiler
   (``ms``, the kernel's mean event, and by kernel with launches per
   call), each from a whole session: every kernel's events in it are
   ``reps`` times its launches a call (the wrapper's count, or a second
   session that kept the same), else it is taken again, and the events
   kept are printed beside each reading; no profiled reading may lie
   below its bytes bound; the grid and block of the timed launches are
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
   training batches' losses at the initial weights.  Prints step ms,
   tokens/s and peak GB, and the ``ssd`` kernel's forward ms and its
   plain backward's ms a step;
10. the launch tooling: ``launch.dryrun``'s fit check over every
   ``cells()`` entry on one card (``--all --mesh one``, as many lines as
   cells); ``--bsp``, every (app × backend) superstep once on 8 gloo
   ranks sharing the card, each rank's exchange all-reducing one
   (replicas + 1,) buffer, ``pallas`` launching ``bsr_spmv`` once a rank,
   the gathered results equal to a stacked superstep; and
   ``launch.perf.run_variant`` on one card's share of qwen3-4b ×
   decode_32k (8 × 32,768: 36 ``decode_attn`` launches a step),
   mamba2-780m × prefill_32k (2 × 32,768: 48 ``ssd``), jamba-v0.1-52b ×
   long_500k (1 × 524,288 at 8 of 32 layers: 1 ``decode_attn``) and
   mamba2-780m × train_4k (4 of the share's 16 × 4096: 96 ``ssd``),
   each printing its roofline terms, step ms, tokens/s, peak against
   dryrun's predicted bytes, mfu and memory share; a decode step may not
   take less than its weights and cache at 3.35 TB/s.
11. 11a. expert-parallel MoE (``models/moe_shardmap.py``): one MoE layer
   of phi3.5-moe-42b-a6.6b at its published width (E 16, K 2, d 4096,
   d_ff 6400, 2.52 GB of bf16 experts) over a (data, model) = (2, 4)
   group of 8 gloo ranks sharing the card, 4 experts a rank, on 8 × 2048
   bf16 tokens from the seed, each rank's tokens and experts shared from
   this process by CUDA IPC.  Held on every rank: at capacity factor 8 =
   E / K (dropless on both paths) the gathered outputs within 2e-2 of
   the one-device ``moe_ffn``'s in relative L2 and, on the tokens whose
   top-2 experts agree on both paths (float32 router products over other
   row counts can flip a near tie), within 2e-2 of max |y| (one bf16 unit
   is 2^-8; a run with each rank holding the next rank's experts must
   exceed it), in float32 (the first 1024 positions of each sequence)
   within 1e-5 of max |y| on those tokens; at
   the published factor 1.25 and at 1.0, which drops, within 2e-2 of a
   one-process replay of ``_dispatch_local``/``_combine_local`` over
   the same 8 shards, each rank dropping the replay's entries; the
   float32 gradients of ``sum(y²)`` (router summed over every rank,
   experts over ``data``) within rtol = atol = 5e-4 of ``moe_ffn``'s (the
   router's in units of its largest element: a float32 sum over 8,192
   tokens that the one-device layer itself misses its float64 value by
   more than 5e-4).
   Prints each rank's bf16 forward and forward + backward ms (CUDA
   events, median of 3), the exchange's ``all_to_all`` ms and bytes a
   call, the backward's all-reduce of the experts' gradients over
   ``data`` (each timed alone), peak GB, and the one-device ``moe_ffn``
   ms;
   11b. elastic restore: mamba2-780m's published-config parameters saved
   under ``build/`` and restored with ``shardings=`` onto a (2, 2) mesh
   of 4 gloo ranks on the card: every leaf gathered by ``gather_leaf``
   bitwise the one-device restore's, a ``forward`` on the gathered parameters
   bitwise the one-device ``forward`` with ``ssd`` launched once a layer;
   prints each rank's resident bytes against the model's and its restore
   seconds;
12. the examples: each ``examples/torch_*.py`` once on the card, all at
   once as subprocesses, at its default size (the edge-list example on
   an ``rmat(12)`` edge list with ``--pagerank --backend pallas``): exit
   code 0, the quickstart's and the partition-and-PageRank example's TC
   and RF equal to the port's ``core`` run here, PageRank's maxerr within
   1e-5, and ``bsr_spmv`` launched once a superstep from the edge-list
   example (``launches_examples`` in the kernel table line).

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
# phi3.5-moe-42b-a6.6b at 14 layers reads 1.19e-4 (its first decode step
# against forward already 1.15e-4: the prefill's and forward's GEMMs of
# 4096 and 4112 rows), against 0.255 (newest key left out) and 1.28
# (wrong KV group) for the faults: its limit lies between, at 1e-3, as the
# bf16 limits do (PERF.md)
F32_LOGITS_REL_L2_BY_ARCH = {"phi3.5-moe-42b-a6.6b": 1e-3}
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
                      "musicgen-medium": 0.05, "paligemma-3b": 0.05,
                      "phi3.5-moe-42b-a6.6b": 0.25}
# phase 7e: the archs served at their published configs
NEW_ARCHS = ("glm4-9b", "qwen3-14b", "minicpm3-4b", "musicgen-medium",
             "paligemma-3b")
# their depth, where cut: phases 7f and 10 brought the smoke to 736–856 s
# on an H100 (PERF.md), and phases 11–12 add ~100 s, so three attention
# archs, whose wrong readings at full depth (1.07, 1.27, 0.697) lie far
# above their 0.05 limit (1.09, 1.27, 0.903 at a quarter), run an
# eighth of their layers, and minicpm3-4b (95–106 s at full depth) half
# of its: its wrong reading there is 0.138 (0.106 at 62 layers), its sound
# one 0.0167
NEW_ARCH_LAYERS = {"glm4-9b": 5, "qwen3-14b": 5, "musicgen-medium": 6,
                   "minicpm3-4b": 31}
# jamba-v0.1-52b (phase 7c): its full width at one pattern period of depth
JAMBA_LAYERS = 8
# phi3.5-moe-42b-a6.6b (phase 7f): its full width at the depth that
# launch.dryrun.max_layers says fits the card, for the bf16 serving run and
# serve_model's float32 replay alike
PHI = "phi3.5-moe-42b-a6.6b"

# phase 10, the launch tooling: perf.run_variant on one card's share of
# these cells (arch, shape, cut); the train cell runs 4 of the pod share's
# 16 sequences of 4096 tokens to keep the phase short
PERF_CELLS = (("qwen3-4b", "decode_32k", {}),
              ("mamba2-780m", "prefill_32k", {}),
              ("jamba-v0.1-52b", "long_500k", {"num_layers": JAMBA_LAYERS}),
              ("mamba2-780m", "train_4k", {"batch": 4}))
PERF_STEPS = 5
# jamba's long_500k cache length, held in phase 5 and timed in phase 8
LONG_S = 524288

# WindGP expert placement (phase 7d): granite's MoE layers whose prefill
# routing is placed, and the three pods of examples/hetero_moe_placement.py
# (relative compute cost, experts a pod holds scaled by 40/16, link cost)
PLACED_LAYERS = (0, 8, 16, 24)
POD_COMPUTE = [0.5, 1.0, 1.0]
POD_MEMORY = [20, 15, 15]
POD_LINK = [1.0, 1.0, 1.5]

# phase 11a: one MoE layer of phi3.5-moe-42b-a6.6b at its published width
# over a (data, model) group of gloo ranks sharing the card.  E / K = 8 is
# the capacity factor at which neither path drops.  The router's float32
# products over a shard's rows and over all rows round apart, so a token
# whose 2nd and 3rd experts nearly tie may route to another expert on the
# two paths (1 of 16,384 tokens in PR 22's first run) and take another
# output: the outputs are held by their relative L2 distance over all
# tokens, and by max |d| over the tokens that route alike.  The bf16
# outputs of those may differ by the rounding of the expert products'
# batches (one bf16 unit is 2^-8 of max |y|), a wrong exchange by the
# outputs themselves.  At the published and the dropping factor the outputs
# equal a one-process replay of the same dispatch and combine bitwise.  The
# router's gradient is a float32 sum over every token reaching 760, which
# the one-device moe_ffn itself misses a float64 truth by 1.30e-3
# (tools/moe_grad_truth.py) and the EP's misses moe_ffn's by 1.45e-3: it is
# held elementwise at atol EP_ROUTER_GRAD_ATOL and rtol EP_GRAD_TOL, the
# experts' and x's at rtol = atol = EP_GRAD_TOL (the reference test's).
# The float32 holds take the first EP_F32_S positions of each sequence, so
# that eight ranks' float32 activations fit beside the one-device layer's
# on the card
EP_MESH = (2, 4)
EP_TOKENS = (8, 2048)
EP_F32_S = 1024
EP_SEED = 0
EP_CF_DROPLESS = 8.0
EP_CF_DROPS = 1.0
EP_BF16_REL = 2e-2
EP_GRAD_TOL = 5e-4
EP_ROUTER_GRAD_ATOL = 5e-3
EP_REPS = 3
EP_TIMEOUT_S = 300
# phase 11b: mamba2-780m's checkpoint restored onto a (data, model) group
ELASTIC_ARCH = "mamba2-780m"
ELASTIC_MESH = (2, 2)
ELASTIC_TOKENS = (2, 2048)
ELASTIC_TIMEOUT_S = 300
# phase 12: each example's subprocess
EXAMPLE_TIMEOUT_S = 300
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


#: what a profiler session runs before and after the profiled calls: spin
#: kernels of ``SPIN_CYCLES`` clock cycles each (~2 ms in all), then the
#: host's wait
SPIN_KERNELS, SPIN_CYCLES, SPIN_HOST_S = 64, 50_000, 0.02


def spin(scale: int = 1) -> None:
    """Pad a profiler window: ``scale`` times ``SPIN_KERNELS`` spin
    kernels, then the host waits ``scale`` times ``SPIN_HOST_S``."""
    for _ in range(SPIN_KERNELS * scale):
        torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()
    time.sleep(SPIN_HOST_S * scale)


def kernel_counts(prof) -> dict:
    """Events a profile kept, by device kernel name (the spin kernels left
    out)."""
    return {e.key: e.count for e in device_events(prof)}


def profile_calls(fn, reps: int, attempts: int = 5, counted=None):
    """torch.profiler over ``reps`` calls of ``fn()``, after one warm-up
    call, from a whole session; returns (profile, calls of ``fn`` made,
    events the session kept by kernel name).

    The launches of the first milliseconds after the profiler starts can
    go unrecorded, the same in every session of a process late in its run
    (on an H100, 7 of 50 SDPA calls; PERF.md), so the host waits
    ``SPIN_HOST_S`` behind ``SPIN_KERNELS`` spin kernels
    (``torch.cuda._sleep``) before the calls and again after them, twice
    as long in each session taken again; ``device_events`` leaves the spin
    kernels out.  A session can still lose records, so a reading counts
    its events: a session is whole when every kernel's count is ``reps``
    times its launches a call.  With
    ``counted`` = (wrapper, key) the kernel whose name holds ``key``
    launches as many times a call as the wrapper's ``launches`` counter
    rose; every other kernel's launches a call come from a whole session
    of the call: its count is a multiple of ``reps`` and a second session
    kept the same.  A session that is not whole is taken again, up to
    ``attempts`` sessions; if none is whole, a check fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls, seen, whole = 1, [], False
    for attempt in range(attempts):
        before = counted[0].launches if counted else 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            spin(2 ** attempt)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            spin(2 ** attempt)
        calls += reps
        counts = kernel_counts(prof)
        whole = bool(counts) and all(c % reps == 0 for c in counts.values())
        others = counts
        if counted:
            wrapper, key = counted
            mine = [c for k, c in counts.items() if key in k]
            whole = whole and mine == [wrapper.launches - before]
            others = {k: c for k, c in counts.items() if key not in k}
        if others:
            whole = whole and others in seen
        seen.append(others)
        if whole:
            break
    check(whole, f"no whole profiler session in {attempts} of {reps} calls: "
          f"events kept by kernel {seen}")
    return prof, calls, counts


def device_events(prof) -> list:
    """Device events by kernel (``key_averages``), the spin kernels left
    out."""
    return [e for e in prof.key_averages() if is_device_event(e)
            and "spin_kernel" not in e.key]


def device_ms(fn, reps: int) -> tuple[float, int]:
    """Device time (ms) per call of ``fn()``: the time of the kernels and
    copies it ran, as torch.profiler records them over ``reps`` calls in a
    whole session (``profile_calls``); and the events that session kept.
    CUDA events around a call would also count the host's launch
    overhead, which can exceed a short kernel's own time."""
    prof, _, counts = profile_calls(fn, reps)
    events = device_events(prof)
    return (sum(e.self_device_time_total for e in events) / reps / 1e3,
            sum(counts.values()))


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
    calls in a whole session (``profile_calls``): ``ms``, the kernel's
    device time a launch (the mean of its profiler events, whose name
    holds ``key``); ``profiler_ms``, all device time a call; ``recorded``,
    the kernel's events the session kept; ``kernels``, events a call and
    ms an event by name; ``launch``, the timed launches' grid and block
    from the trace."""
    before = wrapper.launches
    prof, calls, counts = profile_calls(fn, reps, counted=(wrapper, key))
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
    return {"ms": ms, "recorded": mine[0].count if mine else 0,
            "reps": reps,
            "profiler_ms": sum(e.self_device_time_total
                               for e in events) / reps / 1e3,
            "kernels": kernels, "launch": traced_launches(prof, key)}


def not_below(ms: float, bound_ms: float, what: str) -> None:
    """A device reading below its bytes bound cannot be right (lost
    records, a wrong divisor): fail a check."""
    check(ms >= bound_ms, f"{what} reads {ms} ms, below its bytes bound "
          f"{bound_ms} ms")


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
    """Every kernel wrapper's count set to 0; returns the ``pallas``
    backend's (``bsr_spmv_rows``), ``decode_attn``'s and ``ssd``'s."""
    from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_rows
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.ssd import ssd_chunked
    for fn in (bsr_spmv, bsr_spmv_rows, decode_attention, ssd_chunked):
        fn.launches = 0
    return bsr_spmv_rows, decode_attention, ssd_chunked


# ---------------------------------------------------------------------------
# phases 2-4: the graph path
# ---------------------------------------------------------------------------

def graph_path(gen, lines: list, stacked: dict):
    """Phases 2-4; returns the CLI run (graph, runtime), its layouts
    released, and the kernel table entries of ``bsr_spmv`` and
    ``bsr_spmv_rows``.  Keeps in ``stacked`` what phase 4j holds its ranks
    against: the assignment, PageRank and its actives, and the float32
    row layout's bytes."""
    from repro_torch.bsp import build_pagerank, pagerank, ref
    from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_ref
    from repro_torch.launch import partition as cli

    # -- phase 2: kernel vs plain version, per semiring --------------------
    reset_launches()
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
    rows_k = reset_launches()[0]
    t0 = time.perf_counter()
    res = cli.run(["--graph", GRAPH, "--method", "windgp", "--pagerank",
                   "--pagerank-iters", str(ITERS), "--backend", "pallas",
                   "--device", "cuda"])
    torch.cuda.synchronize()
    launches = rows_k.launches
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(launches == ITERS, f"the graph path launched bsr_spmv_rows "
          f"{launches} times in {ITERS} supersteps")
    check(bsr_spmv.launches == 0, "the graph path launched the dense "
          "bsr_spmv")
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

    # -- phase 4: timings on the graph path's layouts ----------------------
    rows_entry = rows_kernel_row(gen, rt, launches)
    stacked["rows_bytes"] = rt.local_rows(block_size=BM).nbytes
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
    not_below(times["ms"], bytes_ms, "bsr_spmv float32 (profiler)")
    log(f"phase 4: bsr_spmv {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library {library_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.3f} ms")

    blocks_bytes = 4 * bsr.blocks.numel()
    stacked.update(assign=res.assign, pagerank=(pr, res.actives))
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
        "launches": 0, "launches_note": "no app launches it: the pallas "
        "backend reads the row layout (bsr_spmv_rows)",
        "max_abs_err": max_abs_err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "profiler_ms": times["ms"], "profiler_recorded": times["recorded"],
        "profiler_reps": times["reps"], "profiler_kernels": times["kernels"],
        **launch, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "library": "torch.matmul (p*R*K,bm,bm)@(p*R*K,bm,1) + sum over K",
        "dtype": "float32"}, rows_entry


def rows_kernel_row(gen, rt, launches: int) -> dict:
    """Phase 4's row of ``bsr_spmv_rows`` on the graph path's float32 row
    layout: its profiler time a launch over whole sessions, as the
    benchmark's ``spmv_ms`` reads it (the layout stays in L2 between the
    calls, so no bytes floor is checked), and with a 128 MB write before
    each call, which evicts it from the 50 MB L2; beside the work's bytes
    bound
    (each local directed edge's column id and value, x and y over Vmax),
    the bytes the kernel reads, the plain version and ``torch.sparse.mm``
    over the same cells as a CSR matrix; the kernel held against both."""
    from repro_torch.kernels.bsr_spmv import bsr_spmv_rows
    from repro_torch.kernels.bsr_spmv import rows as k_rows
    rows = rt.local_rows(block_size=BM)
    x = torch.rand((rt.p, rows.padded), generator=gen, device="cuda")
    args = (rows.units, rows.cols, rows.vals, x)
    y = bsr_spmv_rows(*args)
    y_plain = k_rows.bsr_spmv_rows_ref(*args)
    close(y, y_plain, dict(rtol=1e-5, atol=0.0), "bsr_spmv_rows on the "
          "row layout")
    times = timing(lambda: bsr_spmv_rows(*args), 50, bsr_spmv_rows,
                   "bsr_spmv_rows_kernel")
    flush = torch.empty(2 ** 25, device="cuda")

    def cold():
        flush.fill_(1.0)
        return bsr_spmv_rows(*args)
    cold_ms = timing(cold, 50, bsr_spmv_rows, "bsr_spmv_rows_kernel")["ms"]
    del flush
    plain_ms = burst_ms(lambda: k_rows.bsr_spmv_rows_ref(*args), 3)
    pos, row = k_rows.unit_entries(rows.units, rows.padded)
    c = rows.cols[pos].long()
    keep = c >= 0
    n = rt.p * rows.padded
    col = row[keep] // rows.padded * rows.padded + c[keep]
    order = torch.argsort(row[keep] * n + col)
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(row[keep], minlength=n), 0)
    csr = torch.sparse_csr_tensor(crow, col[order],
                                  rows.vals[pos[keep]][order], size=(n, n))
    xc = x.reshape(-1, 1)
    close(torch.sparse.mm(csr, xc).view(rt.p, -1), y_plain,
          dict(rtol=1e-5, atol=1e-6), "bsr_spmv_rows library yardstick")
    library_ms = device_ms(lambda: torch.sparse.mm(csr, xc), 50)[0]
    edges = int(np.asarray(rt.edges_per_machine).sum())
    work = 2 * edges * 8 + rt.p * 2 * rt.vmax * 4
    read = sum(t.numel() * t.element_size() for t in
               (rows.units, rows.cols, rows.vals, x, y))
    bound_ms = work / HBM_BYTES_PER_S * 1e3
    stats = {k: sum(s[k] for s in rows.fill_stats)
             for k in rows.fill_stats[0]}
    log(f"phase 4: bsr_spmv_rows {times['ms']:.5f} ms (profiler; L2 flushed "
        f"{cold_ms:.5f}), plain "
        f"{plain_ms:.3f} ms, torch.sparse.mm {library_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({work / 1e6:.2f} MB of work, "
        f"{read / 1e6:.2f} MB read), {stats}")
    del csr, crow
    return {
        "name": "bsr_spmv_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/bsr_spmv/csrc/bsr_spmv_rows.cu",
        "replaces": None, "dtype": "float32",
        "launches": launches, "launches_per_superstep": launches / ITERS,
        "max_abs_err": max_err(y, y_plain), "ms": times["ms"],
        "ms_l2_flushed": cold_ms,
        "profiler_recorded": times["recorded"],
        "profiler_reps": times["reps"], "profiler_kernels": times["kernels"],
        "launch": times["launch"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "work_mb": work / 1e6,
        "read_mb": read / 1e6,
        "read_bound_ms": read / HBM_BYTES_PER_S * 1e3,
        "below_bytes_bound": times["ms"] < bound_ms,
        "library_ms": library_ms,
        "library": "torch.sparse.mm(CSR (p*n, p*n), x (p*n, 1))",
        "layout": stats, "layout_mb": rows.nbytes / 1e6}


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
    """``fn()`` with the ``pallas`` kernel's count (``bsr_spmv_rows``) set
    to 0 just before; returns (result, launches, wall seconds)."""
    rows_k = reset_launches()[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, rows_k.launches, time.perf_counter() - t0


#: the template argument of each storage type in the row kernel's name
KERNEL_TYPE = {"float32": ", float>", "bfloat16": ", __nv_bfloat16>",
               "float16": ", __half>"}


def fused_traced(fn, dtype: str, what: str):
    """A fused run ``fn()`` under torch.profiler (device activity, spin
    kernels padding the window), with ``bsr_spmv_rows``' count set to 0
    just before.  The wrapper counts its eager launches; a call under a CUDA
    graph's capture launches nothing, so the graph replays' launches are
    read from the run's trace, which records every launch.  Returns
    (result, the ``bsr_spmv_rows`` kernel names the trace shows, eager
    launches, wall seconds of ``fn()``)."""
    from torch.profiler import ProfilerActivity, profile

    rows_k = reset_launches()[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spin()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spin()
    kernels = [e.get("name", "") for e in trace_kernels(prof)]
    names = [n for n in kernels if "bsr_spmv_rows_kernel" in n]
    check(not any("bsr_spmv_kernel" in n for n in kernels),
          f"{what}: the trace shows the dense bsr_spmv")
    check(all(KERNEL_TYPE[dtype] in n for n in names),
          f"{what}: the trace shows other bsr_spmv_rows instances than "
          f"{dtype}'s: {sorted(set(names))}")
    return out, names, rows_k.launches, wall


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
    float32 row layout at a time.  Keeps each app's results and
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
              f"bsr_spmv_rows {step_launches} times in {SPARSE_ITERS} "
              f"supersteps")
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
        # pallas superstep reads the whole layout whatever the frontier)
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
    table rows of the dense kernel's two instances, and the row kernel's
    launches and holds by dtype.  Keeps the bfloat16 stepwise run, its
    steps, the float32 run of as many steps and the assignment in
    ``stacked`` for phase 4j."""
    from unittest import mock

    from repro_torch.bsp import backends, build_pagerank, make_fused_runner
    from repro_torch.bsp import pagerank
    from repro_torch.kernels.bsr_spmv import (bsr_spmv, bsr_spmv_ref,
                                              bsr_spmv_rows,
                                              bsr_spmv_rows_ref,
                                              plus_times_bounds)
    from repro_torch.kernels.bsr_spmv.rows import plus_times_bounds_rows
    from repro_torch.launch import partition as cli
    rows, out, rt, by_dtype = [], {}, None, {}
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
        with mock.patch.object(backends, "bsr_spmv_rows", bsr_spmv_rows_ref):
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
        # the row kernel on the run's layout, inside its bounds
        lay = rt.local_rows(block_size=BM, dtype=dtype)
        xr = torch.rand((rt.p, lay.padded), generator=gen,
                        device="cuda").to(dt)
        args = (lay.units, lay.cols, lay.vals, xr)
        yr, yr_plain = bsr_spmv_rows(*args), bsr_spmv_rows_ref(*args)
        lo, hi = plus_times_bounds_rows(*args, BM)
        check(within_bounds(yr, lo, hi) and within_bounds(yr_plain, lo, hi),
              f"bsr_spmv_rows {dtype}: outside plus_times_bounds_rows")
        by_dtype[dtype] = {
            "launches": fused["traced"], "launches_fused": fused,
            "launches_stepwise": step_launches,
            "max_abs_err": max_err(yr, yr_plain),
            "open_outputs": int((lo != hi).sum()),
            "ms": timing(lambda: bsr_spmv_rows(*args), 50, bsr_spmv_rows,
                         "bsr_spmv_rows_kernel")["ms"]}
        del lay, xr, args, yr, yr_plain, lo, hi
        # the dense kernel on its layout: held inside its bounds, where
        # planted faults must fail; profiler time a launch, beside its
        # plain version, a library call in the dtype and its bound
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
        not_below(times["ms"], bytes_ms, f"bsr_spmv {dtype} (profiler)")
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
            "dtype": dtype, "launches": 0,
            "max_abs_err": hold["max_abs_err"], "ms": kernel_ms,
            "kernel_ms": kernel_ms, "profiler_ms": times["ms"],
            "profiler_recorded": times["recorded"],
            "profiler_reps": times["reps"],
            "profiler_kernels": times["kernels"], **launch,
            "ms_min_plus_same_bytes": min_plus_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "library": f"torch.matmul in {dtype} (p*R*K,bm,bm)@(p*R*K,bm,1) "
                       f"+ sum over K"})
        log(f"phase 4d: {what} {steps} steps, vs float32 "
            f"{err / scale:.3g}·max(pr), vs plain run "
            f"{d_plain / scale:.3g}·max(pr); bsr_spmv_rows "
            f"{by_dtype[dtype]['ms']:.5f} ms; dense bsr_spmv {kernel_ms:.3f} ms "
            f"(bound {max(bytes_ms, ops_ms):.3f}, library {library_ms:.3f}), "
            f"peak {peak / 1e9:.1f} GB")
        del spec, bsr, runner, x, y, y_plain, xg, flat_blocks
        rt.clear_bsr_cache()
    torch.cuda.empty_cache()
    lines.append({"low_precision_pagerank": out,
                  "bsr_spmv_rows_16bit": by_dtype})
    return rows, by_dtype


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


def layout_bound_ms(rows) -> float:
    """The float32 row kernel's bytes bound on a row layout: its units,
    column ids and values, x and y once."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (rows.units, rows.cols, rows.vals)) \
        + 2 * 4 * rows.p * rows.padded
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
        check(launches == ITERS, f"{m}: pagerank launched bsr_spmv_rows "
              f"{launches} times in {ITERS} supersteps")
        rt = res.runtime
        d_scatter = pagerank_hold(rt, res.pagerank, m)
        rt.clear_bsr_cache()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay = rt.local_rows(block_size=BM, semiring="plus_times",
                            weights="weight")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        entries = sum(s["entries"] for s in lay.fill_stats)
        step_ms = {}
        for backend, opts in (("pallas", {"block_size": BM}),
                              ("scatter", {})):
            spec = build_pagerank(rt, backend=backend, **opts)
            state = [spec.state]

            def step():
                state[0], _ = spec.superstep(state[0], spec.static)
            step_ms[backend] = median_ms(step, 10)
        layout_mb = lay.nbytes / 1e6
        bound_ms = layout_bound_ms(lay)
        del spec, state, lay
        rt.clear_bsr_cache()
        torch.cuda.empty_cache()
        sssp_launches = sssp_hold(rt, hub(res.graph), m)
        peak = torch.cuda.max_memory_allocated()
        out[m] = {"host_partition_s": res.report["seconds"],
                  "TC": res.report["TC"], "RF": res.report["RF"],
                  "feasible": res.report["feasible"],
                  "vmax": rt.vmax, "emax": rt.emax,
                  "replicas": rt.num_replicas,
                  "entries": entries, "layout_mb": layout_mb,
                  "layout_build_s": build_s,
                  "pallas_superstep_ms": step_ms["pallas"],
                  "scatter_superstep_ms": step_ms["scatter"],
                  "kernel_bound_ms": bound_ms,
                  "cli_wall_s": wall, "max_memory_allocated_gb": peak / 1e9,
                  "pagerank_max_abs_vs_scatter": d_scatter,
                  "launches": {"pagerank": launches, "sssp": sssp_launches}}
        log(f"phase 4f: {m} partition {res.report['seconds']}s TC "
            f"{res.report['TC']} RF {res.report['RF']}, row layout {entries} "
            f"entries {layout_mb:.1f} MB built in {build_s:.2f}s, superstep "
            f"pallas "
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
    check(launches == ITERS, f"stream: pagerank launched bsr_spmv_rows "
          f"{launches} times in {ITERS} supersteps")
    check(res.report["spill"]["duplicate_rows"] == 0
          and sum(res.report["edges_per_machine"]) == g.num_edges,
          f"stream: {res.report['edges_per_machine']} edges placed of "
          f"{g.num_edges}")
    rt = res.runtime
    layout_mb = rt.local_rows(block_size=BM, semiring="plus_times",
                              weights="weight").nbytes / 1e6
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
           "spill": res.report["spill"],
           "layout_mb": layout_mb, "max_memory_allocated_gb": peak / 1e9,
           "pagerank_max_abs_vs_scatter": d_scatter, "launches": launches,
           "workers": {"workers": STREAM_WORKERS, "sync_blocks": 1,
                       "process_wall_s": workers_s,
                       "shards_equal": all(same)},
           "compact": compact}
    log(f"phase 4g: stream {STREAM_METHOD} two_pass in "
        f"{res.report['seconds']}s TC {res.report['TC']}, row layout "
        f"{layout_mb:.1f} MB, pallas vs scatter {d_scatter:.3g}; "
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
        check(rt._bsr_cache == {},
              "apply_delta's runtime keeps something on the card")
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
    run of ``runs`` with ``bsr_spmv_rows``' count set to 0 just before and
    read just after; then this machine's float32 PageRank row layout
    (entries, bytes), its kernel timed by CUDA events with the card to
    itself (the ranks take turns), the exchange's ``all_reduce`` of the
    replica buffer, and the superstep wall; and the rank's peak memory."""
    import torch.distributed as dist
    from repro_torch.bsp import (bfs, build_pagerank, connected_components,
                                 pagerank, run_bsp, sssp)
    from repro_torch.kernels.bsr_spmv import bsr_spmv_rows
    fns = {"pagerank": pagerank, "sssp": sssp, "bfs": bfs,
           "cc": connected_components}
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": mesh.rank, "runs": {}}
    for key, (app, kw) in runs.items():
        torch.cuda.synchronize()
        dist.barrier()
        bsr_spmv_rows.launches = 0
        t0 = time.perf_counter()
        res, acts = fns[app](rt, mesh=mesh, **kw)
        torch.cuda.synchronize()
        out["runs"][key] = {"res": res, "acts": acts,
                            "launches": bsr_spmv_rows.launches,
                            "wall_s": time.perf_counter() - t0}
    spec = build_pagerank(rt, backend="pallas", block_size=BM, mesh=mesh)
    layout = [spec.static[f"eb_rows_{k}"] for k in ("units", "cols", "vals")]
    dev = layout[0].device
    x = torch.rand(tuple(spec.static["eb_rows_gather"].shape), device=dev)
    for r in range(mesh.size):          # one rank at a time on the card
        torch.cuda.synchronize()
        dist.barrier()
        if r == mesh.rank:
            out["kernel_ms"] = burst_ms(
                lambda: bsr_spmv_rows(*layout, x, "plus_times", BM), 10)
    # the exchange's all_reduce of the replica buffer on the card, and
    # beside it the same bytes from host memory (gloo's transport alone)
    # and their copies to the host and back (no collective)
    # and the fused runner's gate, one element
    buf = torch.zeros(max(1, rt.num_replicas) + 1, device=dev)
    host = torch.zeros(buf.shape)
    gate = torch.zeros(1, device=dev)
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
    layout_bytes = sum(t.numel() * t.element_size() for t in layout)
    nbytes = layout_bytes + 2 * x.numel() * x.element_size()
    out.update(entries=int((layout[1] >= 0).sum()),
               layout_bytes=layout_bytes,
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
    rank launching ``bsr_spmv_rows`` once a superstep; every rank
    returning the same; no rank's row layout reaching the stacked float32
    row layout's bytes.  Returns the ranks' ``bsr_spmv_rows`` launches on
    the runs by message dtype (the kernel's instance):
    ``{dtype: [launches of rank r]}``."""
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
                  f"bsr_spmv_rows {got_l} times, expected {want_l} each")
    mine = [r["layout_bytes"] for r in ranks]
    check(max(mine) < stacked["rows_bytes"], f"phase 4j: a rank's row "
          f"layout of {max(mine)} bytes reaches the stacked one's "
          f"{stacked['rows_bytes']}")
    rt = PartitionRuntime.build(g, assign, p, device="cuda")   # host arrays
    modelled = simulate_superstep_times(rt, cl)[0]
    per_rank = [{"rank": r["rank"], "entries": r["entries"],
                 "layout_mb": r["layout_bytes"] / 1e6,
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
           "devices": "cuda:0, shared",
           "stacked_layout_mb": stacked["rows_bytes"] / 1e6,
           "layout_mb_sum": sum(r["layout_mb"] for r in per_rank),
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
        log(f"phase 4j: rank {r['rank']} {r['entries']} entries "
            f"{r['layout_mb']:.2f} MB, peak {r['peak_gb']:.2f} GB, kernel "
            f"{r['kernel_ms']:.3f} ms (bound {r['bound_ms']:.3f}), modelled "
            f"{r['modelled_superstep']:.4g}")
    log(f"phase 4j: {p} ranks in {wall:.1f}s, exchange all_reduce "
        f"{out['exchange_all_reduce_ms_median']:.3f} ms (from host memory "
        f"{out['exchange_host_buffer_ms_median']:.3f}, gate "
        f"{out['gate_all_reduce_ms_median']:.3f}), superstep wall "
        f"{out['superstep_wall_ms']:.2f} ms, row layouts "
        f"{out['layout_mb_sum']:.2f} MB (stacked "
        f"{out['stacked_layout_mb']:.2f})")
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
        # jamba's long_500k: one sequence over 524,288 positions, at its
        # full length, one short, and one past the planned split
        q, k, v = decode_inputs(gen, 1, 32, 8, 128, LONG_S, dtype)
        split = attn_plan(q, k)["split_len"]
        tol = TOL[dtype]["decode"]
        tag = f"decode_attn_{name}_long"
        for n in (LONG_S, LONG_S - 1, split + 1):
            lens = torch.tensor([n], dtype=torch.int32, device="cuda")
            want = decode_attention_ref(q, k, v, lens)
            errs[f"{tag}_{n}"] = close(decode_attention(q, k, v, lens), want,
                                       tol, f"{tag} length {n}")
        wrong = exceeds(decode_attention(q, k, v, lens - 1), want, tol)
        errs[f"{tag}_missing_newest_excess"] = wrong
        check(wrong > 1, f"{tag}: the hold passes the newest key left out "
              f"({wrong} of its limit)")
        del q, k, v
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


def profile_decode(cfg, params, cache, lens, steps: int = 3,
                   attempts: int = 5) -> dict:
    """Device time by kernel over ``steps`` decode steps (torch.profiler),
    and the device's busy share of that window.  The window is padded as
    ``profile_calls`` pads it, and taken again (up to ``attempts`` times)
    until the profiler kept as many ``decode_attn`` events as the wrapper
    launched in it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.models import decode_step
    from repro_torch.serve import next_inputs
    tok = next_inputs(cfg, torch.zeros(lens.shape[0], dtype=torch.long,
                                       device="cuda"))
    decode_step(cfg, params, cache, tok, lens)
    torch.cuda.synchronize()
    for attempt in range(attempts):
        before = decode_attention.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            spin(2 ** attempt)
            t0 = time.perf_counter()
            for i in range(steps):
                decode_step(cfg, params, cache, tok, lens + 1 + i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            spin(2 ** attempt)
        launched = decode_attention.launches - before
        events = device_events(prof)
        recorded = sum(e.count for e in events if "decode_attn" in e.key)
        if recorded == launched:
            break
    check(recorded == launched, f"{cfg.name} decode profile: the profiler "
          f"kept {recorded} of {launched} decode_attn launches")
    total = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    if total == 0:    # the profiler saw no device activity: not measured
        return {"steps": steps, "device_ms_per_step": None}
    return {"steps": steps, "wall_ms_per_step_profiled": wall_us / steps / 1e3,
            "decode_attn_recorded": recorded,
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
    f32_limit = F32_LOGITS_REL_L2_BY_ARCH.get(arch, F32_LOGITS_REL_L2)
    f32_check["limit"] = f32_limit
    check(f32_check["rel_l2"] <= f32_limit,
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
            check(wrong > f32_limit, f"{arch}: float32 reading of "
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
    nbytes = sum(t.numel() * t.element_size() for t in ins) \
        + ins[0].numel() * ins[0].element_size()
    not_below(fwd["ms"], nbytes / HBM_BYTES_PER_S * 1e3,
              "ssd at the training shape")
    y = ssd_chunked(*ins, chunk=128)
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    bwd_ms = median_ms(lambda: torch.autograd.grad(y, ins, gy,
                                                   retain_graph=True), 3)
    per_step = forward_launches / TRAIN_STEPS
    return {"forward_ms": fwd["ms"], "forward_recorded": fwd["recorded"],
            "forward_reps": fwd["reps"], "plain_backward_ms": bwd_ms,
            "forward_launches_per_step": per_step,
            "backward_calls_per_step": layers,
            "forward_ms_per_step": fwd["ms"] * per_step,
            "plain_backward_ms_per_step": bwd_ms * layers}


# ---------------------------------------------------------------------------
# phase 8: LM kernel timings
# ---------------------------------------------------------------------------

def time_decode_attn(gen, S: int, lengths: torch.Tensor) -> dict:
    """decode_attn at qwen3-4b's and jamba's serving width (32/8 heads,
    dh = 128, bf16) for ``len(lengths)`` sequences over a cache of ``S``
    positions, beside its plain version and SDPA; every reading from a
    whole profiler session and none below the bytes bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_ref)
    from repro_torch.kernels.decode_attn.kernel import occupancy
    B, H, KVH, dh = len(lengths), 32, 8, 128
    q, k, v = decode_inputs(gen, B, H, KVH, dh, S, torch.bfloat16)
    got = decode_attention(q, k, v, lengths)
    want = decode_attention_ref(q, k, v, lengths)
    err = close(got, want, TOL[torch.bfloat16]["decode"],
                f"decode_attn at S={S}")
    times = timing(lambda: decode_attention(q, k, v, lengths), 50,
                   decode_attention, "decode_attn")
    ms = times["ms"]
    plain_ms, plain_recorded = device_ms(
        lambda: decode_attention_ref(q, k, v, lengths), 5)
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
    library_ms, library_recorded = device_ms(library, 50)
    kv_bytes = 2 * int(lengths.sum()) * KVH * dh * k.element_size()
    bound_ms = (kv_bytes + 2 * q.numel() * q.element_size()) \
        / HBM_BYTES_PER_S * 1e3
    for what, t in (("decode_attn", ms), ("its plain version", plain_ms),
                    ("SDPA", library_ms)):
        not_below(t, bound_ms, f"{what} at B={B}, S={S}")
    # q·Kᵀ has operands of the cache's type; p·V a float32 p
    qk_flops = 2 * int(lengths.sum()) * H * dh
    qk_rate = BF16_TC_FLOPS if k.dtype == torch.bfloat16 else F32_FLOPS
    ops_ms = (qk_flops / qk_rate + qk_flops / F32_FLOPS) * 1e3
    return {"B": B, "S": S, "lengths": [int(n) for n in lengths.tolist()],
            "max_abs_err": err, "ms": ms, "timing": times,
            "recorded": times["recorded"], "reps": times["reps"],
            "launch": times["launch"],
            "ctas_per_sm": occupancy(q.device, q.dtype, dh, H // KVH),
            "plain_ms": plain_ms, "plain_recorded": plain_recorded,
            "plain_reps": 5, "library_ms": library_ms,
            "library_recorded": library_recorded, "library_reps": 50,
            "bytes_ms": bound_ms, "bound_ms": max(bound_ms, ops_ms),
            "bound_by": "bytes" if bound_ms >= ops_ms else "operations"}


def ssd_flops(B, T, nh, G, L, dh, ds) -> tuple[int, int]:
    """Operations (2 per multiply-add) the causal SSD scan needs: C·Bᵀ on
    each chunk's lower triangle, once per group; then, per head, the
    masked scores times X on the lower triangle, the carry-in C·h and the
    state update.  The exps and the mask's multiplies are not counted."""
    lens = [L] * (T // L) + ([T % L] if T % L else [])
    tri = sum(n * (n + 1) // 2 for n in lens)
    return 2 * B * G * tri * ds, 2 * B * nh * (tri * dh + 2 * T * ds * dh)


def time_ssd(gen, nh: int = 48, ds: int = 128) -> dict:
    """ssd at a prefill shape (B = 8, T = 2048, ``nh`` heads of dh = 64,
    state ``ds``, one group, chunk 128, bf16), with the final state as the
    prefill asks for it: mamba2-780m's (48 heads, ds 128) or
    jamba-v0.1-52b's (128 heads, ds 16, on the ``DSP = 32`` instance)."""
    from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_ref
    from repro_torch.kernels.ssd.kernel import SUB_CHUNK, occupancy
    B, T, G, dh, L = BATCH, PROMPT, 1, 64, 128
    x, b, c, a = ssd_inputs(gen, B, T, nh, G, dh, ds, torch.bfloat16)
    y, h = ssd_chunked(x, b, c, a, chunk=L, return_state=True)
    y_ref, h_ref = ssd_chunked_ref(x, b, c, a, chunk=L, return_state=True)
    err = close(y, y_ref, TOL[torch.bfloat16]["ssd"],
                f"ssd at nh={nh}, ds={ds}")
    close(h, h_ref, STATE_TOL, f"ssd state at nh={nh}, ds={ds}")
    times = timing(lambda: ssd_chunked(x, b, c, a, chunk=L,
                                       return_state=True), 10, ssd_chunked,
                   "ssd_scan")
    ms = times["ms"]
    plain_ms, plain_recorded = device_ms(
        lambda: ssd_chunked_ref(x, b, c, a, chunk=L, return_state=True), 3)
    nbytes = (2 * x.numel() * x.element_size()
              + (b.numel() + c.numel()) * b.element_size()
              + a.numel() * 4 + h.numel() * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    for what, t in (("ssd", ms), ("its plain version", plain_ms)):
        not_below(t, bytes_ms, f"{what} at nh={nh}, ds={ds}")
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
            "recorded": times["recorded"], "reps": times["reps"],
            "plain_ms": plain_ms, "plain_recorded": plain_recorded,
            "plain_reps": 3, "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD scan",
            "flops_bf16_operands": cb_flops, "flops_f32_operands": f32_flops,
            "bf16_passes_of_f32_operands": SSD_SPLIT_PASSES,
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_ms_reference_arithmetic": max(bytes_ms, ref_ops_ms)}


# ---------------------------------------------------------------------------
# phase 7f: phi3.5-moe-42b-a6.6b at the depth that fits
# ---------------------------------------------------------------------------

def phi_depth() -> dict:
    """phi3.5-moe-42b-a6.6b's depth: the deepest that ``dryrun.max_layers``
    says fits the card for each run ``serve_model`` makes (bf16 serving of
    8 × (2048 + 64), its dropless checks on 2 rows, the float32 replay of
    2 × (2048 + 8) at the dropless capacity), the least of the three."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import one_card
    cfg = get_config(PHI)
    drop = dropless(cfg)

    def prefill(rows, new):
        return dict(seq_len=PROMPT + new + 1, global_batch=rows,
                    kind="prefill")
    runs = {"serve_bf16": (cfg, prefill(BATCH, NEW)),
            "checks_bf16_dropless": (drop, prefill(CHECK_ROWS, NEW)),
            "replay_f32_dropless": (dataclasses.replace(drop,
                                                        dtype="float32"),
                                    prefill(CHECK_ROWS, REPLAY_NEW))}
    depth = {k: dryrun.max_layers(c, sh, sh["global_batch"])
             for k, (c, sh) in runs.items()}
    layers = min(depth.values())
    check(layers > 0, f"{PHI}: no depth fits the card: {depth}")
    predicted = {k: dryrun.fit(dataclasses.replace(c, num_layers=layers),
                               sh, one_card(), sh["global_batch"])
                 ["total_bytes"] for k, (c, sh) in runs.items()}
    return {"num_layers": layers, "max_layers_by_run": depth,
            "predicted_bytes_at_depth": predicted,
            "memory_bytes": dryrun.device_memory()}


# ---------------------------------------------------------------------------
# phase 10: the launch tooling on the card
# ---------------------------------------------------------------------------

def dryrun_cells(lines: list) -> dict:
    """``dryrun --all --mesh one`` over every ``cells()`` entry (host only;
    its lines go to stderr)."""
    from repro_torch.configs import cells
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        recs = dryrun.run_cells(cells(), ["one"])
    check(len(recs) == len(cells()), f"dryrun --mesh one printed "
          f"{len(recs)} cells of {len(cells())}")
    out = {"cells": len(recs), "fit": sum(r["fits"] for r in recs),
           "memory_bytes": recs[0]["memory_bytes"],
           "gib_per_device": {f"{r['arch']} × {r['shape']}":
                              round(r["total_bytes"] / 2**30, 3)
                              for r in recs},
           "does_not_fit": [f"{r['arch']} × {r['shape']}" for r in recs
                            if not r["fits"]],
           "seconds": time.perf_counter() - t0}
    lines.append({"dryrun_one_card": out})
    log(f"phase 10: dryrun --all --mesh one: {out['fit']} of {out['cells']} "
        f"cells fit in {out['seconds']:.2f}s")
    return out


def dryrun_bsp(lines: list) -> dict:
    """``dryrun --bsp`` on the card: every (app × backend) superstep once on
    8 gloo ranks sharing it.  Held: every rank all-reduces one (replicas +
    1,) float32 buffer a superstep, a ``pallas`` superstep launches
    ``bsr_spmv_rows`` once on each rank and the others never, and the
    gathered
    result equals one superstep of the stacked run on the card (PageRank
    within 1e-5·max(pr), as phase 4j holds it; the others bitwise).
    Returns the ``pallas`` rows' launches a rank."""
    from repro_torch.bsp import PartitionRuntime, build_app
    from repro_torch.core import scaled_paper_cluster, windgp
    from repro_torch.data import rmat
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        recs = dryrun.run_bsp_cells(device="cuda", timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    g = rmat(9, seed=2)
    cl = scaled_paper_cluster(2, 6, g.num_edges)
    rt = PartitionRuntime.create(g, assign=windgp(g, cl, t0=2).assign,
                                 cluster=cl, device="cuda")
    buf = 4 * (max(1, rt.num_replicas) + 1)
    launches, rows = {}, {}
    for rec in recs:
        tag = f"dryrun --bsp {rec['app']} × {rec['backend']}"
        ranks = rec["ranks"]
        want = 1 if rec["backend"] == "pallas" else 0
        got_l = [r["bsr_spmv_launches"] for r in ranks]
        check(len(ranks) == cl.p and got_l == [want] * cl.p,
              f"{tag}: bsr_spmv_rows launched {got_l} on {len(ranks)} "
              f"ranks")
        check(all(r["exchange_all_reduce_bytes"] == buf and
                  r["exchange_all_reduce_calls"] == 1 for r in ranks),
              f"{tag}: exchange all-reduced "
              f"{[r['exchange_all_reduce_bytes'] for r in ranks]} bytes, "
              f"not {buf} once")
        opts = {"block_size": 32} if rec["backend"] == "pallas" else {}
        spec = build_app(rt, rec["app"], backend=rec["backend"], **opts)
        state, _ = spec.superstep(spec.state, spec.static)
        want_r = np.asarray(spec.finalize(rt, state))
        got_r = np.asarray(rec["result"])
        if rec["app"] == "pagerank":
            d = float(np.abs(got_r - want_r).max())
            check(d <= 1e-5 * float(np.abs(want_r).max()),
                  f"{tag}: {d} from the stacked superstep")
        else:
            check(np.array_equal(got_r, want_r),
                  f"{tag}: differs from the stacked superstep")
        if rec["backend"] == "pallas":
            launches[rec["app"]] = got_l
        rows[f"{rec['app']}/{rec['backend']}"] = {
            "peak_bytes_max": max(r["peak_bytes"] for r in ranks),
            "rank_tensor_bytes_max": max(r["rank_tensor_bytes"]
                                         for r in ranks),
            "exchange_all_reduce_bytes": buf}
    out = {"p": cl.p, "cells": len(recs), "wall_s": wall,
           "bsr_spmv_launches_per_rank": launches, "by_cell": rows}
    lines.append({"dryrun_bsp": out})
    log(f"phase 10: dryrun --bsp {len(recs)} cells on {cl.p} ranks in "
        f"{wall:.1f}s")
    return launches


def perf_cells(lines: list) -> dict:
    """``perf.run_variant`` on each of ``PERF_CELLS`` at one card's share
    (each resets the peak-memory count and the kernels' launch counts
    itself).  Held: the cell fits, the kernels launch as the config says
    a step, the losses (train) are finite, mfu ≤ 1, and a decode step
    takes no less than its bytes (weights and cache) at 3.35 TB/s."""
    from repro_torch.configs import get_config
    from repro_torch.launch import perf
    out = {}
    for arch, shape, cut in PERF_CELLS:
        cfg = get_config(arch)
        if "num_layers" in cut:
            cfg = dataclasses.replace(cfg, num_layers=cut["num_layers"])
        t0 = time.perf_counter()
        rec = perf.run_variant(arch, shape, {}, batch=cut.get("batch"),
                               num_layers=cut.get("num_layers"),
                               steps=PERF_STEPS)
        rec["wall_s"] = time.perf_counter() - t0
        tag = f"perf {arch} × {shape}"
        check(rec["fits"], f"{tag}: does not fit: "
              f"{rec['predicted_bytes_by_part']}")
        if not rec["fits"]:
            continue
        attn = sum(cfg.layer_kind(i) == "attn" and cfg.attn_type != "mla"
                   for i in range(cfg.num_layers))
        ssm = cfg.num_layers - sum(cfg.layer_kind(i) == "attn"
                                   for i in range(cfg.num_layers))
        want = {"decode_attn": attn if rec["kind"] == "decode" else 0,
                "ssd": 0 if rec["kind"] == "decode" else
                ssm * (2 if rec["kind"] == "train" else 1)}
        check(rec["launches_per_step"] == want, f"{tag}: launches a step "
              f"{rec['launches_per_step']} != {want}")
        check(0 < rec["mfu"] <= 1, f"{tag}: mfu {rec['mfu']}")
        if rec["kind"] == "decode":
            not_below(rec["step_ms"], rec["t_memory_s"] * 1e3,
                      f"{tag} step")
        if "losses" in rec:
            check(bool(np.isfinite(rec["losses"]).all()),
                  f"{tag}: losses {rec['losses']}")
        rec["launches"] = {k: v * PERF_STEPS
                           for k, v in rec["launches_per_step"].items()}
        out[f"{arch}/{shape}"] = rec
        lines.append({"perf_cell": rec})
        log(f"phase 10: {tag} (batch {rec['batch']}, {rec['num_layers']} "
            f"layers): step {rec['step_ms']:.2f} ms, "
            f"{rec['tokens_per_s']:.0f} tokens/s, peak "
            f"{rec['peak_bytes'] / 1e9:.2f} GB (predicted "
            f"{rec['predicted_bytes'] / 1e9:.2f}), mfu {rec['mfu']:.4f}, "
            f"memory share {rec['memory_share']:.4f}, launches a step "
            f"{rec['launches_per_step']}, {rec['wall_s']:.1f}s")
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11a: expert-parallel MoE over a (data, model) group of gloo ranks
# ---------------------------------------------------------------------------

def ep_rel(got, want) -> float:
    """max |got - want| over max |want|, in float32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def ep_readings(got, want, agree) -> dict:
    """(B, S, d) outputs against ``want``: the relative L2 distance over
    every token, and max |d| over max |want| on the tokens of the (B, S)
    mask ``agree`` (those that route alike on both paths)."""
    d = got.float() - want.float()
    return {"rel_l2": float(d.norm() / want.float().norm()),
            "max_rel_routed_alike": float(d[agree].abs().max()
                                          / want.float().abs().max())}


def ep_routing_agrees(cfg, p, x):
    """(B, S) bool: the tokens of x (B, S, d) whose top-K experts on their
    ``EP_MESH`` shard, routed as ``moe_ffn_ep`` routes them, equal the
    one-device ``moe_ffn``'s."""
    from repro_torch.models import layers
    B, S, d = x.shape
    dp, tp = EP_MESH
    b, s, K = B // dp, S // tp, cfg.experts_per_token
    G = layers.moe_groups(cfg, B * S)
    _, ids = layers.moe_route(cfg, p, x.reshape(G, B * S // G, d))
    ids = ids.reshape(B, S, K)
    agree = torch.empty((B, S), dtype=torch.bool, device=x.device)
    for i in range(dp):
        for j in range(tp):
            rows = (slice(i * b, (i + 1) * b), slice(j * s, (j + 1) * s))
            logits = torch.einsum("nd,de->ne",
                                  x[rows].reshape(b * s, d).float(),
                                  p["router"])
            _, mine = torch.topk(logits, K, dim=-1, sorted=True)
            agree[rows] = (mine.reshape(b, s, K) == ids[rows]).all(-1)
    return agree


def ep_replay(cfg, p, x, cf: float):
    """A one-process replay of ``moe_ffn_ep`` over the ``EP_MESH`` shards
    of x (B, S, d): each shard's ``_dispatch_local``, the exchange as
    indexing, each destination's experts on the same (tp, E/tp, cap, d)
    buffers, each shard's ``_combine_local``.  Returns the global outputs
    and the entries each shard dropped, in rank order."""
    from repro_torch.models.layers import gelu, silu_stepwise
    from repro_torch.models.moe_shardmap import (_combine_local,
                                                 _dispatch_local, ep_capacity)
    dp, tp = EP_MESH
    B, S, d = x.shape
    b, s, e = B // dp, S // tp, cfg.num_experts // tp
    cap = ep_capacity(cfg, b * s, cf)
    act = silu_stepwise if cfg.mlp_type != "gelu" else gelu
    out = torch.empty_like(x)
    drops = []
    for i in range(dp):
        sends, books = [], []
        for j in range(tp):
            xs = x[i * b:(i + 1) * b, j * s:(j + 1) * s].reshape(b * s, d)
            send, book = _dispatch_local(cfg, p["router"], xs, tp, cap)
            sends.append(send)
            books.append(book)
            drops.append(int((~book[3]).sum()))
        outs = []
        for m in range(tp):
            recv = torch.stack([sends[j][m] for j in range(tp)])
            w = {k: p[k][m * e:(m + 1) * e] for k in ("w_gate", "w_up",
                                                      "w_down")}
            hidden = act(torch.einsum("secd,edf->secf", recv,
                                      w["w_gate"])).mul_(
                torch.einsum("secd,edf->secf", recv, w["w_up"]))
            outs.append(torch.einsum("secf,efd->secd", hidden, w["w_down"]))
        for j in range(tp):
            back = torch.stack([outs[m][j] for m in range(tp)])
            out[i * b:(i + 1) * b, j * s:(j + 1) * s] = _combine_local(
                b * s, d, back, books[j]).reshape(b, s, d)
    return out, drops


def ep_rank(cfg, p, x, refs: dict, reps: int) -> dict:
    """One rank of phase 11a (a ``spawn_ranks`` rank function; ``p``, ``x``
    and ``refs`` are the launcher's card tensors, shared by CUDA IPC).
    Returns its readings: (a) the gathered bf16 outputs at a dropless
    capacity against ``moe_ffn``'s, and with the experts of the next
    ``model`` rank in place of its own; (b) its outputs at the published and
    a dropping capacity factor against the one-process replay, and the
    entries it dropped; (c) the float32 outputs and gradients of
    ``sum(y²)`` against ``moe_ffn``'s; then the bf16 forward and forward +
    backward ms at the published factor, the exchange's ``all_to_all`` ms
    and bytes and the all-reduce of the experts' gradients, each alone,
    and its peak memory."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe_shardmap as EP
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(EP_MESH, ("data", "model")).device_mesh("cuda")
    tp, j = EP_MESH[1], mesh.get_local_rank("model")
    e = cfg.num_experts // tp
    n, d = x.shape[0] * x.shape[1] // (EP_MESH[0] * tp), x.shape[-1]
    local = EP.expert_shard(p, mesh)
    xs = EP.token_shard(x, mesh)
    out = {"rank": dist.get_rank(), "data": mesh.get_local_rank("data"),
           "model": j}
    with torch.no_grad():
        y = EP.moe_ffn_ep(cfg, local, xs, mesh, EP_CF_DROPLESS)
        out["bf16_vs_moe_ffn"] = ep_readings(EP.gather_tokens(y, mesh),
                                             refs["dropless"], refs["agree"])
        k = (j + 1) % tp
        other = dict(local, **{w: p[w][k * e:(k + 1) * e]
                               for w in ("w_gate", "w_up", "w_down")})
        y = EP.moe_ffn_ep(cfg, other, xs, mesh, EP_CF_DROPLESS)
        out["bf16_experts_exchanged"] = ep_readings(
            EP.gather_tokens(y, mesh), refs["dropless"], refs["agree"])
        for name, cf in (("published", cfg.capacity_factor),
                         ("drops", EP_CF_DROPS)):
            y = EP.gather_tokens(EP.moe_ffn_ep(cfg, local, xs, mesh, cf),
                                 mesh)
            out[f"{name}_vs_replay"] = ep_rel(y, refs[name])
            out[f"{name}_bitwise"] = bool(torch.equal(y, refs[name]))
            _, book = EP._dispatch_local(cfg, local["router"],
                                         xs.reshape(n, d), tp,
                                         EP.ep_capacity(cfg, n, cf))
            out[f"{name}_dropped"] = int((~book[3]).sum())
        del y, other
    p32 = {w: v.detach().requires_grad_()
           for w, v in EP.expert_shard(refs["p32"], mesh).items()}
    x32 = EP.token_shard(refs["x32"], mesh).detach().requires_grad_()
    y = EP.moe_ffn_ep(cfg, p32, x32, mesh, EP_CF_DROPLESS)
    out["f32_vs_moe_ffn"] = ep_readings(EP.gather_tokens(y.detach(), mesh),
                                        refs["y32"], refs["agree32"])
    (y ** 2).sum().backward()
    del y
    pairs = {"router": (p32["router"].grad, refs["g"]["router"]),
             "x": (x32.grad, EP.token_shard(refs["gx"], mesh))}
    for w in ("w_gate", "w_up", "w_down"):
        pairs[w] = (p32[w].grad, refs["g"][w][j * e:(j + 1) * e])
    out["grad_max_abs_err"] = {w: float((a - b).abs().max())
                               for w, (a, b) in pairs.items()}
    out["grad_max_abs"] = {w: float(b.abs().max())
                           for w, (a, b) in pairs.items()}
    out["grad_within"] = {w: bool(torch.allclose(a, b, rtol=EP_GRAD_TOL,
                                                 atol=EP_GRAD_TOL))
                          for w, (a, b) in pairs.items()}
    out["grad_within"]["router"] = bool(torch.allclose(
        *pairs["router"], rtol=EP_GRAD_TOL, atol=EP_ROUTER_GRAD_ATOL))
    del p32, x32, pairs
    torch.cuda.empty_cache()
    lb = {w: v.detach().requires_grad_() for w, v in local.items()}
    xb = xs.detach().requires_grad_()

    def forward_only():
        with torch.no_grad():
            EP.moe_ffn_ep(cfg, local, xs, mesh)

    def forward_backward():
        for t in (*lb.values(), xb):
            t.grad = None
        (EP.moe_ffn_ep(cfg, lb, xb, mesh).float() ** 2).sum().backward()

    out["forward_ms"] = median_ms(forward_only, reps)
    out["forward_backward_ms"] = median_ms(forward_backward, reps)
    buf = torch.empty((tp, e, EP.ep_capacity(cfg, n), d), dtype=x.dtype,
                      device=x.device)
    model = mesh.get_group("model")
    with torch.no_grad():
        out["all_to_all_ms"] = median_ms(lambda: EP._exchange(buf, model),
                                         reps)
    out["all_to_all_bytes"] = buf.numel() * buf.element_size()
    # the backward's sums of the experts' gradients over data, alone
    grads = [torch.zeros_like(local[w]) for w in ("w_gate", "w_up",
                                                   "w_down")]
    data = mesh.get_group("data")
    out["expert_grad_all_reduce_ms"] = median_ms(
        lambda: [dist.all_reduce(g, group=data) for g in grads], reps)
    out["expert_grad_bytes"] = sum(g.numel() * g.element_size()
                                   for g in grads)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def ep_phase(lines: list) -> dict:
    """Phase 11a: one MoE layer of phi3.5-moe-42b-a6.6b at its published
    width (E 16, K 2, d 4096, d_ff 6400, bf16 experts) split over a
    ``(data, model) = EP_MESH`` group of gloo ranks sharing the card, on
    ``EP_TOKENS`` bf16 tokens drawn from the seed.  Holds, on every rank:
    (a) at capacity factor E / K (dropless on both paths) the gathered
    ``moe_ffn_ep`` outputs within ``EP_BF16_REL`` of the one-device
    ``moe_ffn``'s in relative L2, and on the tokens that route alike within
    ``EP_BF16_REL`` of max |y|, a run with each rank holding the next model
    rank's experts beyond it; in float32 (on the first ``EP_F32_S``
    positions of each sequence) within the reference test's 1e-5 of max
    |y| on the tokens that route alike; (b) at the published factor and
    at ``EP_CF_DROPS`` (which drops) the outputs bitwise those of a
    one-process replay of the port's ``_dispatch_local``/``_combine_local``
    over the same shards, each rank dropping the replay's entries; (c) the
    float32 gradients of ``sum(y²)`` (router summed over every rank,
    experts over ``data``) within ``EP_GRAD_TOL`` of ``moe_ffn``'s (the
    router's within atol ``EP_ROUTER_GRAD_ATOL``).  Prints the tokens that
    route apart, each rank's bf16 forward and forward + backward ms, the
    exchange's ms and bytes, the experts' gradient all-reduce ms, and peak
    GB, beside the one-device ``moe_ffn`` ms."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.ranks import spawn_ranks
    t0 = time.perf_counter()
    cfg = get_config(PHI)
    cfg8 = dataclasses.replace(cfg, capacity_factor=EP_CF_DROPLESS)
    gen = torch.Generator(device="cuda").manual_seed(EP_SEED)
    p = layers.init_moe(cfg, gen)
    x = torch.randn((*EP_TOKENS, cfg.d_model), generator=gen,
                    device="cuda", dtype=p["w_gate"].dtype)
    refs, replay_drops = {}, {}
    with torch.no_grad():
        refs["dropless"] = layers.moe_ffn(cfg8, p, x)
        refs["agree"] = ep_routing_agrees(cfg, p, x)
        refs["agree32"] = ep_routing_agrees(cfg, p, x[:, :EP_F32_S].float())
        moe_ffn_ms = median_ms(lambda: layers.moe_ffn(cfg, p, x), EP_REPS)
        for name, cf in (("published", cfg.capacity_factor),
                         ("drops", EP_CF_DROPS)):
            refs[name], replay_drops[name] = ep_replay(cfg, p, x, cf)
    p32 = {k: v.float().requires_grad_() for k, v in p.items()}
    x32 = x[:, :EP_F32_S].float().requires_grad_()
    y32 = layers.moe_ffn(cfg8, p32, x32)
    (y32 ** 2).sum().backward()
    refs.update(y32=y32.detach(), x32=x32.detach(),
                p32={k: v.detach() for k, v in p32.items()},
                g={k: v.grad for k, v in p32.items()}, gx=x32.grad)
    del y32, p32, x32
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn_ranks(ep_rank, EP_MESH[0] * EP_MESH[1],
                        args=(cfg, p, x, refs, EP_REPS), device="cuda",
                        timeout=EP_TIMEOUT_S, name="phase 11a")
    ranks_s = time.perf_counter() - t0
    routed_apart = {"bfloat16": int((~refs["agree"]).sum()),
                    "float32": int((~refs["agree32"]).sum())}
    del refs, p, x
    torch.cuda.empty_cache()
    for r in ranks:
        what = f"phase 11a rank {r['rank']}"
        sound, wrong = r["bf16_vs_moe_ffn"], r["bf16_experts_exchanged"]
        check(max(sound.values()) <= EP_BF16_REL, f"{what}: bf16 {sound} "
              f"from moe_ffn")
        check(wrong["rel_l2"] > EP_BF16_REL, f"{what}: exchanged experts "
              f"read {wrong}, within the bf16 limit")
        check(r["f32_vs_moe_ffn"]["max_rel_routed_alike"] < 1e-5,
              f"{what}: float32 {r['f32_vs_moe_ffn']} from moe_ffn")
        for name in ("published", "drops"):
            check(r[f"{name}_bitwise"], f"{what}: {name} differs from the "
                  f"replay by {r[f'{name}_vs_replay']} of max |y|")
            check(r[f"{name}_dropped"] == replay_drops[name][r["rank"]],
                  f"{what}: {name} dropped {r[f'{name}_dropped']}, the "
                  f"replay {replay_drops[name][r['rank']]}")
        check(all(r["grad_within"].values()), f"{what}: float32 gradients "
              f"beyond {EP_GRAD_TOL} (router atol {EP_ROUTER_GRAD_ATOL}): "
              f"{r['grad_max_abs_err']} (largest {r['grad_max_abs']})")
    check(sum(replay_drops["drops"]) > 0, f"phase 11a: capacity factor "
          f"{EP_CF_DROPS} dropped nothing")
    fwd = statistics.median(r["forward_ms"] for r in ranks)
    a2a = statistics.median(r["all_to_all_ms"] for r in ranks)
    reduce_ms = statistics.median(r["expert_grad_all_reduce_ms"]
                                  for r in ranks)
    out = {"arch": PHI, "mesh": dict(zip(("data", "model"), EP_MESH)),
           "ranks": len(ranks), "backend": "gloo",
           "devices": "cuda:0, shared", "tokens": list(EP_TOKENS),
           "float32_tokens": [EP_TOKENS[0], EP_F32_S],
           "expert_gb": cfg.num_experts * 3 * cfg.d_model * cfg.d_ff * 2
           / 1e9,
           "capacity_factors": {"dropless": EP_CF_DROPLESS,
                                "published": cfg.capacity_factor,
                                "drops": EP_CF_DROPS},
           "replay_dropped": replay_drops, "routed_apart": routed_apart,
           "bf16_rel_limit": EP_BF16_REL, "grad_tol": EP_GRAD_TOL,
           "router_grad_atol": EP_ROUTER_GRAD_ATOL,
           "moe_ffn_ms": moe_ffn_ms, "forward_ms_median": fwd,
           "forward_backward_ms_median": statistics.median(
               r["forward_backward_ms"] for r in ranks),
           "all_to_all_ms_median": a2a,
           "expert_grad_all_reduce_ms_median": reduce_ms,
           # the collectives of one call, each timed alone
           "collectives_alone_ms": {"forward": 2 * a2a,
                                    "forward_backward": 4 * a2a
                                    + reduce_ms},
           "per_rank": ranks, "setup_s": setup_s, "ranks_s": ranks_s}
    lines.append({"expert_parallel": out})
    log(f"phase 11a: EP over {len(ranks)} ranks in {ranks_s:.1f}s (setup "
        f"{setup_s:.1f}s): bf16 vs moe_ffn {ranks[0]['bf16_vs_moe_ffn']} "
        f"(exchanged experts {ranks[0]['bf16_experts_exchanged']}), routed "
        f"apart {routed_apart}, float32 {ranks[0]['f32_vs_moe_ffn']}, "
        f"forward {fwd:.1f} "
        f"ms, forward+backward {out['forward_backward_ms_median']:.1f} ms, "
        f"all_to_all {a2a:.1f} ms, experts' gradient all_reduce "
        f"{reduce_ms:.1f} ms, moe_ffn {moe_ffn_ms:.1f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 11b: elastic restore onto a (data, model) group of gloo ranks
# ---------------------------------------------------------------------------

def elastic_rank(cfg, directory: str, one: dict, tokens, want) -> dict:
    """One rank of phase 11b: restore the checkpoint onto the
    ``ELASTIC_MESH`` of the card; its restore seconds and resident bytes,
    whether every gathered leaf equals the one-device restore (``one``,
    shared by CUDA IPC) bitwise after ``gather_leaf``, and on rank 0 the
    forward on the gathered
    parameters against the one-device forward ``want`` and its ``ssd``
    launches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import forward, meta_params
    from repro_torch.sharding import param_shardings
    from repro_torch.train import CheckpointManager, gather_leaf
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(ELASTIC_MESH, ("data", "model")).device_mesh("cuda")
    rank = dist.get_rank()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    got, step, _ = CheckpointManager(directory).restore(
        {"params": meta_params(cfg)},
        shardings={"params": param_shardings(cfg, mesh)})
    torch.cuda.synchronize()
    out = {"rank": rank, "step": step,
           "restore_s": time.perf_counter() - t0,
           "resident_bytes": torch.cuda.memory_allocated() - base,
           "split_leaves": sum(tuple(t.to_local().shape) != tuple(t.shape)
                               for t in got["params"].values())}
    full = {}
    equal = True
    for name, t in got["params"].items():
        g = gather_leaf(t)
        equal &= bool(torch.equal(g, one[name]))
        if rank == 0:
            full[name] = g
    out["gathered_bitwise"] = equal
    if rank == 0:
        params = meta_params(cfg).to_empty(device="cuda")
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(full[name])
        del full
        _, _, ssd = reset_launches()
        with torch.no_grad():
            logits = forward(cfg, params, tokens)
        out["forward_bitwise"] = bool(torch.equal(logits, want))
        out["forward_ssd_launches"] = ssd.launches
    return out


def elastic_phase(lines: list) -> dict:
    """Phase 11b: mamba2-780m's published-config parameters (the seed's,
    bf16) saved under ``build/`` and restored onto a ``(data, model) =
    ELASTIC_MESH`` group of gloo ranks sharing the card with
    ``shardings=``.  Holds: every leaf gathered (``gather_leaf``) bitwise
    the one-device restore's; a ``forward`` on the gathered parameters bitwise
    the one-device ``forward`` on the same tokens, launching ``ssd`` once a
    layer.  Prints each rank's resident bytes against the model's and the
    restore seconds."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.ranks import spawn_ranks
    from repro_torch.train import CheckpointManager
    cfg = get_config(ELASTIC_ARCH)
    directory = ROOT / "build" / "chip_smoke_elastic"
    shutil.rmtree(directory, ignore_errors=True)
    mgr = CheckpointManager(str(directory), keep=1)
    t0 = time.perf_counter()
    mgr.save(1, {"params": init_params(cfg, seed=0, device="cuda")})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one, _, _ = mgr.restore({"params": init_params(cfg, seed=1,
                                                   device="cuda")})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    one = one["params"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, ELASTIC_TOKENS, generator=gen,
                           device="cuda")
    with torch.no_grad():
        want = forward(cfg, one, tokens)
    leaves = {n: p.detach() for n, p in one.named_parameters()}
    model_bytes = sum(p.numel() * p.element_size() for p in leaves.values())
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(elastic_rank, math.prod(ELASTIC_MESH),
                            args=(cfg, str(directory), leaves, tokens, want),
                            device="cuda", timeout=ELASTIC_TIMEOUT_S,
                            name="phase 11b")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    ranks_s = time.perf_counter() - t0
    del one, leaves, want
    torch.cuda.empty_cache()
    for r in ranks:
        check(r["gathered_bitwise"] and r["step"] == 1, f"phase 11b rank "
              f"{r['rank']}: a gathered leaf differs from the one-device "
              f"restore")
        check(0 < r["resident_bytes"] < model_bytes, f"phase 11b rank "
              f"{r['rank']}: {r['resident_bytes']} bytes resident of the "
              f"model's {model_bytes}")
    check(ranks[0]["forward_bitwise"], "phase 11b: the forward on the "
          "gathered parameters differs from the one-device forward")
    check(ranks[0]["forward_ssd_launches"] == cfg.num_layers,
          f"phase 11b: the forward launched ssd "
          f"{ranks[0]['forward_ssd_launches']} times, not "
          f"{cfg.num_layers}")
    out = {"arch": ELASTIC_ARCH, "mesh": dict(zip(("data", "model"),
                                                  ELASTIC_MESH)),
           "ranks": len(ranks), "backend": "gloo",
           "devices": "cuda:0, shared", "model_bytes": model_bytes,
           "save_s": save_s, "one_device_restore_s": restore_s,
           "tokens": list(ELASTIC_TOKENS), "per_rank": ranks,
           "ranks_s": ranks_s}
    lines.append({"elastic_restore": out})
    log(f"phase 11b: {ELASTIC_ARCH} restored onto {len(ranks)} ranks, "
        f"resident {[round(r['resident_bytes'] / 1e9, 3) for r in ranks]} "
        f"GB of {model_bytes / 1e9:.3f}, restore "
        f"{[round(r['restore_s'], 2) for r in ranks]} s (one device "
        f"{restore_s:.2f} s), forward bitwise "
        f"{ranks[0]['forward_bitwise']}, ssd "
        f"{ranks[0]['forward_ssd_launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the examples on the card
# ---------------------------------------------------------------------------

#: run an example with the ``pallas`` kernel wrapper's launches
#: (``bsr_spmv_rows``) printed at exit
COUNT_LAUNCHES = r"""
import atexit, runpy, sys
from repro_torch.kernels.bsr_spmv import bsr_spmv_rows
atexit.register(lambda: print("bsr_spmv_rows launches",
                              bsr_spmv_rows.launches, flush=True))
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def example_partitions() -> dict:
    """The TC and RF lines ``torch_quickstart.py`` and
    ``torch_partition_and_pagerank.py`` print, computed here."""
    from repro_torch.core import evaluate, scaled_paper_cluster, windgp
    from repro_torch.core.partitioners import get as partitioner
    from repro_torch.data import rmat
    out = {}
    g = rmat(12, seed=7)
    cl = scaled_paper_cluster(3, 6, g.num_edges)
    res = windgp(g, cl, alpha=0.1, beta=0.1, t0=20, theta=0.02)
    s = evaluate(g, partitioner("ne")(g, cl), cl)
    out["quickstart"] = [f"WindGP : TC={res.stats.tc:.4e}  "
                         f"RF={res.stats.rf:.3f}",
                         f"NE     : TC={s.tc:.4e}  RF={s.rf:.3f}"]
    g = rmat(12, seed=3)
    cl = scaled_paper_cluster(3, 6, g.num_edges)
    tcs = []
    for method in ("hash", "ne", "windgp"):
        assign = (windgp(g, cl, alpha=0.1, beta=0.1, t0=20,
                         theta=0.02).assign if method == "windgp"
                  else partitioner(method)(g, cl))
        tcs.append(f"{method:7s} TC={evaluate(g, assign, cl).tc:.3e}")
    out["pagerank"] = tcs
    return out


def examples_phase(lines: list) -> int:
    """Phase 12: each ``examples/torch_*.py`` once on the card, all at once
    as subprocesses, at its default size (``torch_partition_edgelist.py``
    on an ``rmat(12, seed=3)`` edge list written under ``build/``, with
    ``--pagerank --backend pallas``).  Holds: every exit code 0; the TC
    and RF lines of the quickstart and the partition-and-PageRank example
    equal to the port's ``core`` run here on the same graphs and seeds;
    that example's ``maxerr`` within PageRank's 1e-5; the edge-list
    example launching ``bsr_spmv`` once a PageRank superstep.  Returns
    those launches."""
    import os
    import re
    import shutil
    from repro_torch.data import rmat, write_edge_list
    build = ROOT / "build" / "chip_smoke_examples"
    shutil.rmtree(build, ignore_errors=True)
    build.mkdir(parents=True)
    edges = build / "edges.txt"
    write_edge_list(rmat(12, seed=3), str(edges))
    ex = lambda name: str(ROOT / "examples" / name)
    py = sys.executable
    cmds = {
        "torch_quickstart": [py, ex("torch_quickstart.py")],
        "torch_partition_and_pagerank": [
            py, ex("torch_partition_and_pagerank.py")],
        "torch_hetero_moe_placement": [py,
                                       ex("torch_hetero_moe_placement.py")],
        "torch_train_lm": [py, ex("torch_train_lm.py")],
        "torch_partition_edgelist": [
            py, "-c", COUNT_LAUNCHES, ex("torch_partition_edgelist.py"),
            str(edges), "--pagerank", "--backend", "pallas", "--out-dir",
            str(build / "parts")]}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "TMPDIR": str(build)}
    t0 = time.perf_counter()

    def run(argv):
        proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                              timeout=EXAMPLE_TIMEOUT_S)
        return proc, time.perf_counter() - t0

    try:
        with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
            futures = {k: pool.submit(run, v) for k, v in cmds.items()}
            want = example_partitions()
            done = {k: f.result() for k, f in futures.items()}
    finally:
        shutil.rmtree(build, ignore_errors=True)
    walls = {k: s for k, (_, s) in done.items()}
    text = {k: proc.stdout for k, (proc, _) in done.items()}
    for k, (proc, _) in done.items():
        check(proc.returncode == 0, f"phase 12: {k} exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
    printed = re.findall(r"^(WindGP : TC=\S+  RF=\S+|NE     : TC=\S+  "
                         r"RF=\S+)", text["torch_quickstart"], re.M)
    check(printed == want["quickstart"], f"phase 12: torch_quickstart "
          f"printed {printed}, the port's core {want['quickstart']}")
    pr = text["torch_partition_and_pagerank"]
    printed = re.findall(r"^(\w+ +TC=\S+)", pr, re.M)
    check(printed == want["pagerank"], f"phase 12: "
          f"torch_partition_and_pagerank printed {printed}, the port's core "
          f"{want['pagerank']}")
    errs = [float(m) for m in re.findall(r"maxerr=(\S+)", pr)]
    check(len(errs) == 3 and max(errs) <= 1e-5,
          f"phase 12: PageRank maxerr {errs} beyond 1e-5")
    el = text["torch_partition_edgelist"]
    launches = [int(m) for m in re.findall(r"^bsr_spmv_rows launches (\d+)$",
                                           el, re.M)]
    steps = [int(m) for m in re.findall(r"^pagerank\[pallas/stepwise/"
                                        r"float32\]: (\d+)/", el, re.M)]
    check(len(launches) == 1 and len(steps) == 1 and steps[0] > 0
          and launches[0] == steps[0], f"phase 12: torch_partition_edgelist "
          f"launched bsr_spmv_rows {launches} times for {steps} "
          f"supersteps")
    check("checkpoints in " in text["torch_train_lm"]
          and re.search(r"^step +60  loss ", text["torch_train_lm"], re.M),
          "phase 12: torch_train_lm did not train 60 steps")
    out = {"walls_s": walls, "maxerr": errs,
           "tc_rf_equal_to_core": want,
           "bsr_spmv_rows_launches_partition_edgelist": launches[:1],
           "pagerank_supersteps": steps[:1],
           "train_lm_last_step": [l for l in text["torch_train_lm"]
                                  .splitlines() if l.startswith("step")][-1:]}
    lines.append({"examples": out})
    log(f"phase 12: examples {({k: round(v, 1) for k, v in walls.items()})}"
        f" s, maxerr {errs}, bsr_spmv_rows {launches} launches")
    return launches[0] if launches else 0


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
    from repro_torch.kernels.bsr_spmv import rows as k_rows
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
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        built = list(pool.map(lambda m: m.build(),
                              (k_spmv, k_rows, k_attn, k_ssd)))
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
    res, dense_entry, spmv_entry = graph_path(gen, lines, stacked)
    torch.cuda.empty_cache()
    apps = sparse_apps(res.graph, res.runtime, lines, stacked)
    spmv_entry["launches_sparse_apps"] = {
        app: a["launches"] for app, a in apps.items()}
    frontier_phase(res.graph, res.runtime, lines)
    graph = res.graph
    del res
    torch.cuda.empty_cache()
    spmv_16bit, rows_16bit = low_precision_pagerank(gen, lines, stacked)
    spmv_entry["by_16bit_dtype"] = rows_16bit
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
    for dtype, per_rank in mesh_launches.items():
        entry = spmv_entry if dtype == "float32" else rows_16bit[dtype]
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
        layers = NEW_ARCH_LAYERS.get(arch, get_config(arch).num_layers)
        served[arch] = serve_model(arch, lines, num_layers=layers)
        cfg = get_config(arch)
        want = 0 if cfg.attn_type == "mla" else layers * NEW
        check(served[arch]["launches"] == {"decode_attn": want, "ssd": 0},
              f"{arch} launches {served[arch]['launches']} != {want} "
              f"decode_attn")
        torch.cuda.empty_cache()

    # -- phase 7f: phi3.5-moe-42b-a6.6b at the depth that fits -------------
    depth = phi_depth()
    lines.append({"phi_depth": depth})
    phi = serve_model(PHI, lines, num_layers=depth["num_layers"])
    check(phi["launches"] == {"decode_attn": depth["num_layers"] * NEW,
                              "ssd": 0},
          f"{PHI} launches {phi['launches']} != {depth['num_layers']} x "
          f"{NEW} decode_attn")
    torch.cuda.empty_cache()

    # -- phase 8 ----------------------------------------------------------
    serve_lengths = torch.randint(PROMPT + 1, PROMPT + NEW + 1, (BATCH,),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
    attn_t = time_decode_attn(gen, PROMPT + NEW + 1, serve_lengths)
    attn_32k = time_decode_attn(
        gen, 32768, torch.full((BATCH,), 32768, dtype=torch.int32,
                               device="cuda"))
    attn_long = time_decode_attn(
        gen, LONG_S, torch.full((1,), LONG_S, dtype=torch.int32,
                                device="cuda"))
    ssd_t = time_ssd(gen)
    ssd_jamba = time_ssd(gen, nh=128, ds=16)
    share = 36 * attn_t["ms"] / qwen["decode_step_ms"]
    lines.append({"decode_attn_serving": attn_t, "decode_attn_32k": attn_32k,
                  "decode_attn_long_500k": attn_long, "ssd_serving": ssd_t,
                  "ssd_jamba": ssd_jamba,
                  "decode_attn_share_of_qwen_decode_step": share})
    log(f"phase 8: decode_attn {attn_t['ms']:.4f} ms (bound "
        f"{attn_t['bound_ms']:.4f}), at 32k {attn_32k['ms']:.4f} ms (bound "
        f"{attn_32k['bound_ms']:.4f}, SDPA {attn_32k['library_ms']:.4f}), "
        f"at B=1 S={LONG_S} {attn_long['ms']:.4f} ms (bound "
        f"{attn_long['bound_ms']:.4f}); ssd {ssd_t['ms']:.3f} ms (bound "
        f"{ssd_t['bound_ms']:.3f}), at jamba's shape {ssd_jamba['ms']:.3f} "
        f"ms (bound {ssd_jamba['bound_ms']:.3f})")

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
    torch.cuda.empty_cache()

    # -- phase 10: the launch tooling --------------------------------------
    t0 = time.perf_counter()
    dryrun_cells(lines)
    bsp_launches = dryrun_bsp(lines)
    spmv_entry["launches_dryrun_bsp_per_rank"] = bsp_launches
    perf = perf_cells(lines)
    log(f"phase 10 in {time.perf_counter() - t0:.1f}s")
    perf_launches = {k: r["launches"] for k, r in perf.items()}
    torch.cuda.empty_cache()

    # -- phases 11a-11b: expert parallelism and elastic restore ------------
    ep_phase(lines)
    elastic = elastic_phase(lines)

    # -- phase 12: the examples --------------------------------------------
    spmv_entry["launches_examples"] = {
        "torch_partition_edgelist": examples_phase(lines)}

    for line in lines:
        print(json.dumps(line))
    print(json.dumps({"kernels": [spmv_entry, dense_entry, *spmv_16bit, {
        "name": "decode_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/kernel.py:59",
        "launches": qwen["launches"]["decode_attn"],
        "launches_by_arch": {r["arch"]: r["launches"]["decode_attn"]
                             for r in (qwen, granite, jamba,
                                       *served.values(), phi)},
        "launches_perf_cells": {k: v["decode_attn"]
                                for k, v in perf_launches.items()},
        "recorded": attn_t["recorded"], "reps": attn_t["reps"],
        "plain_recorded": attn_t["plain_recorded"],
        "library_recorded": attn_t["library_recorded"],
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
        "plain_ms_32k": attn_32k["plain_ms"],
        "library_ms_32k": attn_32k["library_ms"],
        "recorded_32k": attn_32k["recorded"],
        "plain_recorded_32k": attn_32k["plain_recorded"],
        "library_recorded_32k": attn_32k["library_recorded"],
        "grid_32k": attn_32k["launch"].get("grid"),
        "ms_long_500k": attn_long["ms"],
        "bound_ms_long_500k": attn_long["bound_ms"],
        "plain_ms_long_500k": attn_long["plain_ms"],
        "library_ms_long_500k": attn_long["library_ms"],
        "recorded_long_500k": attn_long["recorded"],
        "grid_long_500k": attn_long["launch"].get("grid")}, {
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
        "launches_elastic_forward":
            elastic["per_rank"][0]["forward_ssd_launches"],
        "launches_perf_cells": {k: v["ssd"]
                                for k, v in perf_launches.items()},
        "recorded": ssd_t["recorded"], "reps": ssd_t["reps"],
        "plain_recorded": ssd_t["plain_recorded"],
        "training_forward_ms": ssd_train["forward_ms"],
        "training_forward_recorded": ssd_train["forward_recorded"],
        "ms_jamba": ssd_jamba["ms"], "recorded_jamba": ssd_jamba["recorded"],
        "plain_ms_jamba": ssd_jamba["plain_ms"],
        "bound_ms_jamba": ssd_jamba["bound_ms"],
        "bytes_ms_jamba": ssd_jamba["bytes_ms"],
        "ops_ms_jamba": ssd_jamba["ops_ms"],
        "bound_by_jamba": ssd_jamba["bound_by"],
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
