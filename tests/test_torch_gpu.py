"""Port tests that need a CUDA device: the hand-written kernels against
their plain versions, the device-built layout and PageRank against the
same code on the CPU, the reduced LM configs on the card against the
CPU, and the sampling service, feature store and prefetch pipeline on
the card against the CPU and the numpy oracle, bitwise, the ``ssd``
autograd.Function's gradients against autograd through its plain
version, and a reduced train step on the card against the CPU.  They
skip where
``torch.cuda.is_available()`` is False.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: (min, +) and (or, and) bitwise; (+, ×) rtol=1e-5 (float32
sums reassociate); in bfloat16/float16 (+, ×) kernel and plain version
inside ``plus_times_bounds``, the interval any float32 order of the slot
sums admits (one rounding per ELL slot and per fold); PageRank
atol=1e-6, rtol=1e-5.  The fused runner (CUDA graphs) is held bitwise
against the stepwise one for SSSP, BFS and CC.  decode_attn and ssd in
float32 as the JAX kernel tests hold them (2e-5 and 2e-4); in bfloat16
as ``chip_smoke.py`` holds them: both versions see the same bf16 inputs
and differ in float32 summation order only, which can move the rounded
output by one bf16 unit (2^-8 relative), so rtol=2^-7 with atol 1e-4
(decode) and 1e-3 (SSD, sums of up to 128 terms); the SSD state stays
float32 (2e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bsp import (PartitionRuntime, bfs, build_app,
                             connected_components, frontier_entries,
                             make_fused_runner, pagerank, run_apps, run_bsp,
                             spawn_machines, sssp)
from repro_torch.core import scaled_paper_cluster, windgp
from repro_torch.data import rmat
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.kernels import bsr_spmv as port_k
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_ref)
from repro_torch.kernels.decode_attn import kernel as attn_k
from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_ref, ssd_ref
from repro_torch.kernels.ssd import kernel as ssd_k
from repro_torch.models import forward, init_params
from repro_torch.models import layers as TL
from repro_torch.sampling import (FeatureStore, HaloCache, MachineCSC,
                                  PrefetchPipeline, SamplingService,
                                  fanout_hop, sample_fanout_np)
from repro_torch.serve import generate

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def random_layout(rng, semiring, p=3, R=16, K=5, C=16, bm=128):
    sr = port_k.get_semiring(semiring)
    cols = rng.integers(0, C, size=(p, R, K)).astype(np.int32)
    keep = rng.random((p, R, K, bm, bm)) < 0.3
    if semiring == "or_and":
        blocks = keep.astype(np.float32)
        x = (rng.random((p, C * bm)) < 0.5).astype(np.float32)
    else:
        blocks = np.where(keep, rng.random(keep.shape), sr.absent)
        blocks = blocks.astype(np.float32)
        x = rng.random((p, C * bm)).astype(np.float32)
        if semiring == "min_plus":
            x[rng.random(x.shape) < 0.2] = np.inf
    cols[:, ::2, -1] = 0
    blocks[:, ::2, -1] = sr.absent
    return cols, blocks, x


@pytest.mark.parametrize("bm", [128, 30])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
def test_kernel_matches_plain(cuda, semiring, bm):
    rng = np.random.default_rng(15)
    cols, blocks, x = (torch.from_numpy(a).to(cuda)
                       for a in random_layout(rng, semiring, bm=bm))
    before = port_k.bsr_spmv.launches
    got = port_k.bsr_spmv(cols, blocks, x, semiring)
    torch.cuda.synchronize()
    assert port_k.bsr_spmv.launches == before + 1
    want = port_k.bsr_spmv_ref(cols, blocks, x, semiring)
    if semiring == "plus_times":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got, want)
    # without the machine axis
    got0 = port_k.bsr_spmv(cols[1].contiguous(), blocks[1].contiguous(),
                           x[1].contiguous(), semiring)
    assert torch.equal(got0, got[1])


@pytest.mark.parametrize("bm", [128, 30])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_16bit_matches_plain(cuda, dtype, semiring, bm):
    rng = np.random.default_rng(16)
    cols, blocks, x = random_layout(rng, semiring, bm=bm)
    C = x.shape[-1] // bm
    cols[:, 1, 0] = C - 1                   # the block column at x's end
    if semiring == "min_plus":              # ±inf in x
        x[:, :bm] = -np.inf
        x[:, -1] = np.inf
    cols, blocks, x = (torch.from_numpy(a).to(cuda) for a in (cols, blocks, x))
    blocks, x = blocks.to(dtype), x.to(dtype)
    before = port_k.bsr_spmv.launches
    got = port_k.bsr_spmv(cols, blocks, x, semiring)
    torch.cuda.synchronize()
    assert port_k.bsr_spmv.launches == before + 1
    assert got.dtype == dtype
    want = port_k.bsr_spmv_ref(cols, blocks, x, semiring)
    if semiring == "plus_times":
        # inside the interval any float32 order of the slot sums admits
        lo, hi = port_k.plus_times_bounds(cols, blocks, x)
        for y in (got, want):
            assert bool(((lo <= y) & (y <= hi)).all())
    else:       # -inf + an absent +inf block is NaN in both versions
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)


def hold(got, want, cols, blocks, x, semiring):
    """The kernel's holds against its plain version: float32 (+,×) at
    rtol 1e-5, 16-bit (+,×) both inside ``plus_times_bounds``, the rest
    bitwise (NaN where both are NaN)."""
    if semiring != "plus_times":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    elif got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    else:
        lo, hi = port_k.plus_times_bounds(cols, blocks, x)
        for y in (got, want):
            assert bool(((lo <= y) & (y <= hi)).all())


def ring_layout(cuda, dtype, semiring, bm, K, seed=17, p=2, R=5, C=6):
    """A random layout with ELL padding slots, a slot on x's last block and,
    under (min,+), ±inf in x."""
    rng = np.random.default_rng(seed)
    cols, blocks, x = random_layout(rng, semiring, p=p, R=R, K=K, C=C, bm=bm)
    cols[:, 1, 0] = C - 1
    if semiring == "min_plus":
        x[:, :bm] = -np.inf
        x[:, -1] = np.inf
    cols, blocks, x = (torch.from_numpy(a).to(cuda) for a in (cols, blocks, x))
    return cols, blocks.to(dtype), x.to(dtype)


@pytest.mark.parametrize("K", [1, 3, 17])
@pytest.mark.parametrize("bm", [8, 30, 64, 128, 256])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_ring_shapes(cuda, dtype, semiring, bm, K):
    # K below, at and past the ring's stages; bulk copies where a block row
    # is a multiple of 16 bytes, the producer's own loads elsewhere (bm 30)
    cols, blocks, x = ring_layout(cuda, dtype, semiring, bm, K)
    plan = port_k.kernel.launch_plan(cols, blocks, x)
    assert plan.mode == ("bulk" if bm * x.element_size() % 16 == 0
                         else "loads")
    before = port_k.bsr_spmv.launches
    got = port_k.bsr_spmv(cols, blocks, x, semiring)
    torch.cuda.synchronize()
    assert port_k.bsr_spmv.launches == before + 1
    assert got.dtype == dtype
    hold(got, port_k.bsr_spmv_ref(cols, blocks, x, semiring), cols, blocks,
         x, semiring)


@pytest.mark.parametrize("rows,stages", [(48, 1), (48, 3), (128, 2),
                                         (16, 8), (1, 2)])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_plans_agree(cuda, dtype, semiring, rows, stages):
    # plans the sweep takes, beside the default: a last tile short of rows
    # (128 = 2·48 + 32), a ring of one stage, one row a tile; and a grid of
    # tiles that is no multiple of the CTAs the card holds at once
    cols, blocks, x = ring_layout(cuda, dtype, semiring, 128, 17, p=3, R=7)
    plan = port_k.kernel.plan_tiles(128, dtype,
                                    port_k.kernel.smem_limit(x.device), p=3,
                                    R=7, rows=rows, stages=stages)
    per_sm = port_k.kernel.occupancy(x.device, dtype, semiring, 128, plan)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert per_sm >= 1
    assert plan.grid == 21 * -(-128 // rows)
    if rows == 48:
        assert plan.grid % (sms * per_sm) != 0
    got = port_k.kernel.launch(cols, blocks, x, semiring, plan)
    want = port_k.bsr_spmv(cols, blocks, x, semiring)
    torch.cuda.synchronize()
    hold(got, port_k.bsr_spmv_ref(cols, blocks, x, semiring), cols, blocks,
         x, semiring)
    if semiring == "min_plus":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_loads_mode_on_unaligned_x(cuda, dtype, semiring):
    # x one value past a 16-byte boundary: the producer's own loads feed
    # the same vector consumers as the bulk copies do
    cols, blocks, x = ring_layout(cuda, dtype, semiring, 128, 5)
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:]
    shifted = shifted.view(x.shape).copy_(x)
    assert shifted.data_ptr() % 16 != 0
    assert port_k.kernel.launch_plan(cols, blocks, shifted).mode == "loads"
    got = port_k.bsr_spmv(cols, blocks, shifted, semiring)
    want = port_k.bsr_spmv(cols, blocks, x, semiring)
    torch.cuda.synchronize()
    hold(got, port_k.bsr_spmv_ref(cols, blocks, x, semiring), cols, blocks,
         x, semiring)
    if semiring != "plus_times":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_main_path_plan_occupancy(cuda, dtype):
    # the graph path's layout (p 9, R 251, bm 128): at least 2 CTAs an SM,
    # so at least 2 rings of ~64 KB an SM in flight
    plan = port_k.kernel.plan_tiles(128, dtype,
                                    port_k.kernel.smem_limit(cuda), p=9,
                                    R=251)
    for semiring in ("plus_times", "min_plus", "or_and"):
        assert port_k.kernel.occupancy(cuda, dtype, semiring, 128,
                                       plan) >= 2


@pytest.mark.parametrize("field,delta", [("x_offset", -16),
                                         ("stage_bytes", -128),
                                         ("smem", -16), ("threads", -32)])
def test_kernel_refuses_a_layout_short_of_a_stage(cuda, field, delta):
    # the plan alone lays out the ring; the kernel refuses, and launches
    # nothing for, a layout with no room for the slab, the x slice, the
    # barriers or the tile's rows
    cols, blocks, x = ring_layout(cuda, torch.float32, "plus_times", 128, 3)
    plan = port_k.kernel.launch_plan(cols, blocks, x)
    short = dataclasses.replace(plan, **{field: getattr(plan, field) + delta})
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port_k.kernel.launch(cols, blocks, x, "plus_times", short)
    hold(port_k.kernel.launch(cols, blocks, x, "plus_times", plan),
         port_k.bsr_spmv_ref(cols, blocks, x), cols, blocks, x, "plus_times")


@pytest.fixture
def runtimes(cuda):
    g = rmat(10, seed=42)
    cl = scaled_paper_cluster(2, 4, g.num_edges)
    assign = windgp(g, cl, t0=2).assign
    w = (np.random.default_rng(7).random(g.num_edges) + 0.1).astype(
        np.float32)
    return [PartitionRuntime.create(g, assign=assign, p=cl.p,
                                    edge_weights=w, device=d)
            for d in ("cpu", cuda)]


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
def test_device_built_layout_matches_cpu(runtimes, semiring):
    on_cpu, on_gpu = (rt.local_bsr(block_size=32, semiring=semiring)
                      for rt in runtimes)
    assert torch.equal(on_gpu.blocks.cpu(), on_cpu.blocks)
    assert torch.equal(on_gpu.cols.cpu(), on_cpu.cols)


def test_pagerank_pallas_matches_scatter(runtimes):
    _, rt = runtimes
    launches = port_k.bsr_spmv.launches
    pr, act = pagerank(rt, num_iters=10, backend="pallas", block_size=32)
    assert port_k.bsr_spmv.launches == launches + 10
    pr_s, _ = pagerank(rt, num_iters=10, backend="scatter")
    pr_cpu, _ = pagerank(runtimes[0], num_iters=10, backend="scatter")
    np.testing.assert_allclose(pr, pr_s, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(pr, pr_cpu, atol=1e-6, rtol=1e-5)
    assert act.shape == (10, rt.p)


SPARSE_APPS = {"sssp": (sssp, dict(source=0, num_iters=25)),
               "bfs": (bfs, dict(source=1, num_iters=25)),
               "cc": (connected_components, dict(num_iters=25))}


@pytest.mark.parametrize("backend,opts", [
    ("pallas", {"block_size": 32}),
    ("pallas", {"block_size": 32, "message_dtype": "bfloat16"}),
    ("scatter", {}), ("segment", {})])
@pytest.mark.parametrize("app", list(SPARSE_APPS))
def test_fused_graphs_match_stepwise(runtimes, app, backend, opts):
    on_cpu, rt = runtimes
    fn, kw = SPARSE_APPS[app]
    a, acts_a = fn(rt, backend=backend, **kw, **opts)
    b, acts_b = fn(rt, backend=backend, fused=True, chunk=4, **kw, **opts)
    np.testing.assert_array_equal(a, b)
    n = len(acts_b)
    assert 0 < n < kw["num_iters"]
    np.testing.assert_array_equal(acts_a[:n], acts_b)
    assert acts_a[n:].sum() == 0
    c, _ = fn(on_cpu, backend=backend, fused=True, chunk=4, **kw, **opts)
    np.testing.assert_array_equal(b, c)


def test_fused_runner_replays_captured_graphs(runtimes):
    _, rt = runtimes
    spec = build_app(rt, "sssp", backend="pallas", block_size=32)
    run = make_fused_runner(spec.superstep, spec.static, chunk=3)
    launches = port_k.bsr_spmv.launches
    out, acts = run(spec.state, 7)         # chunks of 3, 3 and 1
    torch.cuda.synchronize()
    assert set(run.graphs) <= {3, 1} and 3 in run.graphs
    assert sum(run.replays.values()) == -(-len(acts) // 3)
    # the warm-up step launches; a call under capture is no launch
    assert port_k.bsr_spmv.launches - launches == 1
    ref_out, ref_acts = run_bsp(spec.superstep, spec.state, spec.static,
                                len(acts))
    for k in out:
        assert torch.equal(out[k], ref_out[k]), k
    np.testing.assert_array_equal(acts, ref_acts)
    launches = port_k.bsr_spmv.launches
    again, acts2 = run(spec.state, 7)        # replays, no new capture
    assert torch.equal(again["dist"], out["dist"])
    np.testing.assert_array_equal(acts2, acts)
    assert port_k.bsr_spmv.launches == launches     # no warm-up step
    assert sum(run.replays.values()) == 2 * -(-len(acts) // 3)


def test_frontier_cap_on_cuda(runtimes):
    _, rt = runtimes
    for fused in (False, True):
        dense, acts = sssp(rt, source=0, num_iters=25, fused=fused)
        cap = int(rt.vmax)
        sparse, acts_f = sssp(rt, source=0, num_iters=25, fused=fused,
                              frontier_cap=cap)
        np.testing.assert_array_equal(dense, sparse)
        np.testing.assert_array_equal(acts, acts_f)
    assert (frontier_entries(rt, rt.vertex_valid) <= cap).all()


def mesh_rank(rt, mesh, calls):
    """A ``spawn_machines`` rank: ``calls`` on this rank's machine, and the
    ``bsr_spmv`` launches they made."""
    port_k.bsr_spmv.launches = 0
    return run_apps(rt, mesh, calls), port_k.bsr_spmv.launches


def test_two_gloo_ranks_on_one_card_match_stacked(cuda):
    """One machine a rank, two ranks sharing the card over gloo: SSSP
    bitwise and PageRank within 1e-5 of the stacked run on the card, each
    rank launching the kernel once a superstep on its own layout."""
    g = rmat(9, seed=2)
    cl = scaled_paper_cluster(1, 1, g.num_edges)
    assign = windgp(g, cl, t0=2).assign
    pallas = dict(backend="pallas", block_size=32)
    calls = [("sssp", dict(source=0, num_iters=20, **pallas)),
             ("sssp", dict(source=0, num_iters=20, fused=True, chunk=4,
                           **pallas)),
             ("pagerank", dict(num_iters=10, **pallas))]
    by_rank = spawn_machines(mesh_rank, cl.p, graph=g, assign=assign,
                             args=(calls,), device="cuda", timeout=300)
    rt = PartitionRuntime.create(g, assign=assign, p=cl.p, device=cuda)
    want = [sssp(rt, **calls[0][1]), sssp(rt, **calls[1][1]),
            pagerank(rt, **calls[2][1])]
    for runs, launches in by_rank:
        for (app, _), (got, acts), (exp, exp_acts) in zip(calls, runs,
                                                          want):
            if app == "pagerank":
                np.testing.assert_allclose(got, exp, atol=1e-5, rtol=1e-5)
            else:
                np.testing.assert_array_equal(got, exp)
            np.testing.assert_array_equal(acts, exp_acts)
        # stepwise: one a superstep; fused: every superstep of each chunk
        # run, the predicated ones too (no capture under a mesh)
        assert launches == 20 + 4 * -(-len(runs[1][1]) // 4) + 10


TOL = {torch.float32: {"decode": dict(rtol=2e-5, atol=2e-5),
                       "ssd": dict(rtol=2e-4, atol=2e-4)},
       torch.bfloat16: {"decode": dict(rtol=2 ** -7, atol=1e-4),
                        "ssd": dict(rtol=2 ** -7, atol=1e-3)}}
STATE_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,dh,S", [
    (3, 8, 2, 128, 300),      # GQA, S not a multiple of the split or tile
    (2, 4, 4, 32, 77),        # MHA, the reduced configs' head dim
    (2, 16, 1, 64, 600),      # MQA
    (3, 32, 2, 128, 300),     # glm4-9b: G = 16, the CUDA-core body in bf16
    (3, 40, 8, 128, 300),     # qwen3-14b: G = 5
    (3, 24, 24, 64, 300),     # musicgen-medium: G = 1
    (3, 8, 1, 256, 300),      # paligemma-3b: dh 256, G = 8
])
def test_decode_attn_matches_plain(cuda, dtype, B, H, KVH, dh, S):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, H, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, S, KVH, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, S, KVH, dh), generator=gen, device=cuda).to(dtype)
    lens = torch.tensor([S, 0, S // 3 + 1][:B], dtype=torch.int32,
                        device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert got.dtype == dtype
    want = decode_attention_ref(q, k, v, lens)
    tol = TOL[dtype]["decode"]
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # lengths == 0: the uniform mean of V over all S
    torch.testing.assert_close(
        got[1].float(), v[1].float().mean(0).repeat_interleave(
            H // KVH, dim=0), **tol)
    full = decode_attention(q, k, v)
    torch.testing.assert_close(full.float(),
                               decode_attention_ref(q, k, v).float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,nh,G,dh,ds,chunk,decay", [
    (2, 300, 4, 2, 64, 128, 128, 0.1),   # ragged T, groups, full-width tile
    (1, 100, 2, 1, 32, 16, 16, 0.1),     # the reduced config's shape
    (1, 256, 1, 1, 16, 8, 64, 5.0),      # strong decay
])
def test_ssd_matches_plain(cuda, dtype, B, T, nh, G, dh, ds, chunk, decay):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((B, T, nh, dh), generator=gen, device=cuda).to(dtype)
    b = (0.5 * torch.randn((B, T, G, ds), generator=gen,
                           device=cuda)).to(dtype)
    c = (0.5 * torch.randn((B, T, G, ds), generator=gen,
                           device=cuda)).to(dtype)
    a = -decay * torch.rand((B, T, nh), generator=gen, device=cuda)
    if decay > 1:
        a = torch.full_like(a, -decay)
    before = ssd_chunked.launches
    y, h = ssd_chunked(x, b, c, a, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ssd_chunked.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    y_ref, h_ref = ssd_chunked_ref(x, b, c, a, chunk=chunk,
                                   return_state=True)
    tol = TOL[dtype]["ssd"]
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    torch.testing.assert_close(h, h_ref, **STATE_TOL)
    # one head and one group against the sequential recurrence
    if G == nh == 1:
        flat = (x[:, :, 0], b[:, :, 0], c[:, :, 0], a[:, :, 0])
        torch.testing.assert_close(y[:, :, 0].float(),
                                   ssd_ref(*flat).float(), **tol)


def decode_edge_lengths(S, split_len, B):
    """Lengths on the edges of the kernel's splits and tiles, cycled over
    B rows: 0, 1, a tile, one past it, a split, one short of and one past
    it, all of S (each clipped to S)."""
    edges = [0, 1, attn_k.TILE, attn_k.TILE + 1, split_len - 1, split_len,
             split_len + 1, S]
    return [min(edges[i % len(edges)], S) for i in range(B)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,dh,S", [
    (8, 8, 8, 64, 1),         # Smax 1, G = 1
    (8, 32, 4, 128, 31),      # Smax below a tile, G = 8
    (8, 16, 2, 128, 33),      # one past a tile
    (64, 32, 8, 128, 100),    # B*KVH = 512 rows: exactly one split
    (8, 4, 1, 128, 5000),     # 8 rows: many splits
    (8, 32, 8, 128, 2113),    # the serving shape
    (8, 32, 8, 128, 16384),   # long splits (2752 positions)
    (4, 40, 8, 128, 500),     # G = 5: heads padded to 8 on the tensor cores
    (4, 32, 2, 64, 700),      # G = 16: bf16 on the CUDA-core kernel
    (8, 24, 8, 64, 2113),     # granite: G = 3 padded to 4, dh 64
])
def test_decode_attn_split_edges(cuda, dtype, B, H, KVH, dh, S):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((B, H, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, S, KVH, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, S, KVH, dh), generator=gen, device=cuda).to(dtype)
    launch = attn_k.plan(q, k)
    slots = launch["sms"] * min(launch["per_sm"], attn_k.CTAS_PER_SM)
    assert launch["ctas"] <= max(slots, B * KVH)
    if B * KVH >= slots:
        assert launch["nsplit"] == 1
    lens = torch.tensor(decode_edge_lengths(S, launch["split_len"], B),
                        dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, lens)
    again = decode_attention(q, k, v, lens)     # the tickets were reset
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(got, again)
    tol = TOL[dtype]["decode"]
    torch.testing.assert_close(got.float(),
                               decode_attention_ref(q, k, v, lens).float(),
                               **tol)
    # lengths == 0 (row 0): the uniform mean of V over all S
    torch.testing.assert_close(
        got[0].float(), v[0].float().mean(0).repeat_interleave(
            H // KVH, dim=0), **tol)
    for counters in attn_k._COUNTERS.values():
        assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_occupancy_at_serving_widths(cuda, dtype):
    # the CTAs an SM holds, as the runtime reports them for each launch:
    # decode_attn at qwen3-4b's widths holds the plan's CTAS_PER_SM, and
    # ssd's tensor-core instance at mamba2-780m's at least 2
    per_sm = attn_k.occupancy(cuda, dtype, 128, 4)
    assert 1 <= per_sm <= 32
    ssd_per_sm = ssd_k.occupancy(cuda, dtype, 64, 128, 128)
    assert ssd_per_sm >= 1
    if dtype == torch.bfloat16:
        assert per_sm >= attn_k.CTAS_PER_SM
        assert ssd_per_sm >= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,nh,G,dh,ds,chunk,decay", [
    (2, 1, 4, 1, 64, 128, 128, None),     # T = 1
    (2, 50, 4, 1, 64, 128, 128, None),    # T < chunk
    (1, 129, 4, 1, 64, 128, 128, None),   # T = chunk + 1
    (1, 300, 2, 1, 64, 128, 64, None),    # chunk 64
    (1, 600, 2, 1, 32, 64, 256, None),    # chunk 256
    (2, 200, 8, 2, 64, 128, 128, None),   # G = 2, nh = 8
    (1, 200, 4, 1, 64, 128, 128, 0.0),    # a = 0: no decay
    (1, 200, 4, 1, 64, 128, 128, 5.0),    # a = -5
    (2, 300, 128, 1, 64, 16, 128, None),  # jamba: nh 128, ds 16 (padded)
    (1, 1000, 128, 1, 64, 16, 128, 5.0),  # jamba's widths, a = -5
])
def test_ssd_chunk_edges(cuda, dtype, B, T, nh, G, dh, ds, chunk, decay):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((B, T, nh, dh), generator=gen, device=cuda).to(dtype)
    b = (0.5 * torch.randn((B, T, G, ds), generator=gen,
                           device=cuda)).to(dtype)
    c = (0.5 * torch.randn((B, T, G, ds), generator=gen,
                           device=cuda)).to(dtype)
    if decay is None:
        a = -torch.nn.functional.softplus(
            torch.randn((B, T, nh), generator=gen, device=cuda))
    else:
        a = torch.full((B, T, nh), -decay, device=cuda)
    before = ssd_chunked.launches
    y, h = ssd_chunked(x, b, c, a, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ssd_chunked.launches == before + 1
    y_ref, h_ref = ssd_chunked_ref(x, b, c, a, chunk=chunk,
                                   return_state=True)
    torch.testing.assert_close(y.float(), y_ref.float(), **TOL[dtype]["ssd"])
    torch.testing.assert_close(h, h_ref, **STATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_card_matches_cpu(cuda, arch):
    """Every arch at its reduced config: forward and greedy tokens on the
    card against the CPU.  MLA runs the plain blockwise attention at every
    S, so no kernel launches for it."""
    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(3)
    if cfg.input_mode == "tokens":
        prompts = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    else:
        prompts = torch.randn((2, 40, cfg.d_model), generator=gen)
    on_cpu = init_params(cfg, 0, "cpu")
    on_gpu = init_params(cfg, 0, "cpu").to(cuda)    # .to moves in place
    got = forward(cfg, on_gpu, prompts.to(cuda))
    torch.testing.assert_close(got.cpu(), forward(cfg, on_cpu, prompts),
                               rtol=1e-4, atol=1e-4)
    kern = (ssd_chunked if cfg.family in ("ssm", "hybrid")
            else None if cfg.attn_type == "mla" else decode_attention)
    before = (ssd_chunked.launches, decode_attention.launches)
    toks = generate(cfg, on_gpu, prompts.to(cuda), 4)
    if kern is None:
        assert (ssd_chunked.launches, decode_attention.launches) == before
    else:
        assert kern.launches > before[kern is decode_attention]
    assert torch.equal(toks.cpu(),
                       generate(cfg, on_cpu, prompts, 4, device="cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("B,T,nh,G,dh,ds", [(2, 300, 48, 1, 64, 128),
                                            (1, 200, 128, 1, 64, 16)])
def test_ssd_gradients_match_plain_autograd(cuda, dtype, return_state, B, T,
                                            nh, G, dh, ds):
    """The ``ssd`` autograd.Function at mamba2-780m's and jamba's widths:
    the forward is the kernel (one launch), the outputs carry a
    ``grad_fn``, and the gradients of x, b, c and a equal autograd
    through the plain version bitwise: the backward is that plain
    version's VJP, recomputed from the same inputs and output gradients."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((B, T, nh, dh), generator=gen, device=cuda).to(dtype)
    b = (0.5 * torch.randn((B, T, G, ds), generator=gen,
                           device=cuda)).to(dtype)
    c = (0.5 * torch.randn((B, T, G, ds), generator=gen,
                           device=cuda)).to(dtype)
    a = -torch.nn.functional.softplus(
        torch.randn((B, T, nh), generator=gen, device=cuda))
    wy = torch.randn((B, T, nh, dh), generator=gen, device=cuda)
    wh = torch.randn((B, nh, ds, dh), generator=gen, device=cuda)

    def grads(fn):
        ins = [v.clone().requires_grad_() for v in (x, b, c, a)]
        out = fn(*ins, chunk=128, return_state=return_state)
        y, h = out if return_state else (out, None)
        assert y.grad_fn is not None
        loss = (y.float() * wy).sum()
        if return_state:
            assert h.grad_fn is not None
            loss = loss + (h * wh).sum()
        loss.backward()
        return [v.grad for v in ins]

    before = ssd_chunked.launches
    got = grads(ssd_chunked)
    torch.cuda.synchronize()
    assert ssd_chunked.launches == before + 1
    want = grads(ssd_chunked_ref)
    for name, g, w in zip("xbca", got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen3-4b",
                                  "minicpm3-4b"])
def test_reduced_train_step_card_matches_cpu(cuda, arch):
    """One train step (remat, two microbatches) on the card against the
    same step on the CPU: loss and gradient norm within 1e-4, every
    parameter within 1e-4 relative L2 after the update."""
    from repro_torch.train import adamw_init, make_train_step
    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(4)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (4, 40),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (4, 40),
                                     generator=gen)}
    step = make_train_step(cfg, microbatches=2, remat=True)
    out = []
    for dev in ("cpu", cuda):
        params = init_params(cfg, 0, "cpu").requires_grad_().to(dev)
        before = ssd_chunked.launches
        params, _, m = step(params, adamw_init(params),
                            {k: v.to(dev) for k, v in batch.items()})
        if dev != "cpu" and cfg.family == "ssm":
            assert ssd_chunked.launches > before
        out.append((params.cpu(), float(m["loss"]), float(m["grad_norm"])))
    (p0, l0, n0), (p1, l1, n1) = out
    assert abs(l1 - l0) <= 1e-4 * abs(l0) and abs(n1 - n0) <= 1e-4 * n0
    for (name, a), (_, b) in zip(p0.named_parameters(),
                                 p1.named_parameters()):
        a, b = a.detach(), b.detach()
        assert float((a - b).norm() / a.norm()) <= 1e-4, name


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen3-4b"])
def test_reduced_bf16_gradients_card_match_cpu(cuda, arch):
    """bfloat16 gradients on the card (mamba2-780m through the ssd kernel's
    bfloat16 instance and its autograd.Function) against a float32 truth,
    the same weights in float32 on the CPU: the whole gradient's relative
    L2 from it at most twice the CPU's bfloat16 gradient's own, each
    leaf's at most 4 times plus 1e-3, and the loss within 2e-3 relative
    of the CPU's bfloat16 loss (the bounds of ``test_torch_train``'s
    bfloat16 step against the reference, widened once more for another
    summation order)."""
    import copy
    from repro_torch.train import loss_and_grads
    cfg = dataclasses.replace(get_reduced(arch), dtype="bfloat16")
    params = init_params(cfg, 0, "cpu").requires_grad_()
    truth_params = copy.deepcopy(params).float()
    gen = torch.Generator().manual_seed(8)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 40), generator=gen)
             for k in ("inputs", "labels")}
    _, truth = loss_and_grads(dataclasses.replace(cfg, dtype="float32"),
                              truth_params, batch, remat=False)
    cpu_loss, cpu = loss_and_grads(cfg, params, batch, remat=True)
    before = ssd_chunked.launches
    card_loss, card = loss_and_grads(
        cfg, params.to(cuda), {k: v.to(cuda) for k, v in batch.items()},
        remat=True)
    if cfg.family == "ssm":
        assert ssd_chunked.launches > before
    assert abs(float(card_loss) - float(cpu_loss)) \
        <= 2e-3 * abs(float(cpu_loss))

    def rel(got, want):
        return float((got.float() - want).norm() / want.norm())
    for name, want in truth.items():
        own = rel(cpu[name], want)
        assert rel(card[name].cpu(), want) <= 4 * own + 1e-3, (name, own)
    whole = lambda g: torch.cat([v.cpu().float().ravel() for v in g.values()])
    assert rel(whole(card), whole(truth)) <= 2 * rel(whole(cpu), whole(truth))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,N", [("granite-moe-3b-a800m", 8),
                                    ("granite-moe-3b-a800m", 600),
                                    ("jamba-v0.1-52b", 300)])
def test_moe_ffn_on_card_is_deterministic(cuda, arch, N, dtype):
    """moe_ffn on the card: the same output twice, bitwise (the combine
    adds each token's K terms in a fixed order, no atomics), no host sync
    (the sync debug mode raises on one), and the CPU's within float32
    summation order (bf16: two bf16 units of each row's largest value)."""
    cfg = dataclasses.replace(get_reduced(arch), capacity_factor=0.25,
                              experts_per_token=8 if "granite" in arch
                              else 2, dtype=str(dtype).split(".")[-1])
    gen = torch.Generator().manual_seed(5)
    p = TL.init_moe(cfg, gen)
    x = torch.randn((1, N, cfg.d_model), generator=gen).to(dtype)
    pc = {k: v.to(cuda) for k, v in p.items()}
    xc = x.to(cuda)
    TL.moe_ffn(cfg, pc, xc)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = TL.moe_ffn(cfg, pc, xc)
        again = TL.moe_ffn(cfg, pc, xc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, again)
    want = TL.moe_ffn(cfg, p, x).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    else:
        unit = 2.0 ** (torch.floor(torch.log2(
            want.abs().amax(-1, keepdim=True).clamp_min(1e-30))) - 7)
        assert bool(((got.cpu().float() - want).abs() <= 2 * unit).all())


def sampling_pair(devices, replace, fanouts=(10, 5)):
    """A sampling service, feature store and cache on each device, over
    one partition and one feature table."""
    g = rmat(10, seed=42)
    cl = scaled_paper_cluster(2, 4, g.num_edges)
    csc = MachineCSC.build(PartitionRuntime.create(
        g, assign=windgp(g, cl, t0=2).assign, p=cl.p, device="cpu"))
    feats = np.random.default_rng(1).standard_normal(
        (g.num_vertices, 16)).astype(np.float32)
    out = []
    for d in devices:
        svc = SamplingService(csc, fanouts=fanouts, replace=replace,
                              device=d)
        store = FeatureStore.build(svc, feats, device=d)
        out.append((svc, store, HaloCache.for_home(store, 0, capacity=256)))
    return out


def cache_state(c):
    return (c.hits, c.misses, c.evictions, c.bytes_fetched, c.lru_ids(),
            c.hub_ids.tolist())


@pytest.mark.parametrize("replace", [False, True])
def test_sampling_card_matches_cpu(cuda, replace):
    """The service's fused and loop paths and the feature store with its
    cache on the card, bitwise against the CPU on the same uniforms."""
    (svc, store, cache), (svc_d, store_d, cache_d) = sampling_pair(
        ("cpu", cuda), replace)
    gen = torch.Generator().manual_seed(0)
    for home in (0, 0, 3):
        seeds = svc.local_seeds(home, 64, gen)
        us = svc.draw_uniforms(len(seeds), gen)
        want = svc.sample_khop(seeds, us, home=home)
        for fused in (True, False):
            got = svc_d.sample_khop(seeds, [u.to(cuda) for u in us],
                                    home=home, fused=fused)
            assert all(torch.equal(a.cpu(), b)
                       for a, b in zip(got.hops, want.hops))
            assert got.hop_stats == want.hop_stats
        rows, st = store.gather(want.all_ids(), 0, cache)
        rows_d, st_d = store_d.gather(got.all_ids(), 0, cache_d)
        assert torch.equal(rows_d.cpu(), rows) and st_d == st
        assert cache_state(cache_d) == cache_state(cache)
        assert torch.equal(rows_d, store_d.gather_global(got.all_ids()))


@pytest.mark.parametrize("fanout", [10, "D+2"])
def test_fanout_hop_on_card_matches_oracle(cuda, fanout):
    """Both selections on the card against the numpy oracle, with the
    table's widest rows, equal keys inside a row, and a fanout above the
    table's width."""
    ((svc, _, _),) = sampling_pair((cuda,), False)
    D = svc.csc.max_degree
    fanout = D + 2 if fanout == "D+2" else fanout
    rows = svc._rowmap_d[svc._rowmap_d >= 0]
    gen = torch.Generator(device=cuda).manual_seed(4)
    u = torch.rand((len(rows), max(D, fanout)), generator=gen, device=cuda)
    u[:, 1::3] = u[:, 0::3][:, :u[:, 1::3].shape[1]]       # ties
    want = sample_fanout_np(svc._table.cpu().numpy(),
                            svc._deg.cpu().numpy(), rows.cpu().numpy(),
                            u.cpu().numpy(), fanout)
    for select in ("sort", "top_k"):
        got = fanout_hop(svc._table, svc._deg, rows, u, fanout, False,
                         select)
        assert np.array_equal(got.cpu().numpy(), want), select


def test_prefetch_pipeline_on_card_is_depth_independent(cuda):
    """Depth 0 and depth 2 on the card give the same batches, features
    and cache state: the two worker threads order their work on one
    stream."""
    ((svc, store, _),) = sampling_pair((cuda,), False)
    streams = []
    for depth in (0, 2):
        cache = HaloCache.for_home(store, 0, capacity=256)
        with PrefetchPipeline(svc, home=0, batch_size=64, num_batches=6,
                              seed=3, depth=depth, store=store,
                              cache=cache) as pl:
            streams.append(([(mb, f.cpu()) for mb, f in pl],
                            cache_state(cache)))
    (a, sa), (b, sb) = streams
    assert len(a) == len(b) == 6 and sa == sb
    for (ma, fa), (mb, fb) in zip(a, b):
        assert all(torch.equal(x, y) for x, y in zip(ma.hops, mb.hops))
        assert ma.hop_stats == mb.hop_stats and torch.equal(fa, fb)


# last in the file, so that a device left in a bad state by the failed
# capture cannot affect another test
def test_fused_capture_failure_raises(cuda):
    def superstep(state, static):
        x = state["x"] + 1
        if x.sum().item() > 1e9:       # a host sync inside the capture
            x = x * 0
        return {"x": x}, (x > 0).sum(dim=1)

    run = make_fused_runner(superstep, {}, chunk=2)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        run({"x": torch.zeros((3, 4), device=cuda)}, 4)
