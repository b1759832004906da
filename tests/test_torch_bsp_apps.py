"""The sparse BSP apps, triangle counting, the simulator and the 16-bit
layouts: the port against the JAX package on the CPU.

Both packages run on the same runtime (moved across by ``convert.py``),
``rmat(9)`` on ``scaled_paper_cluster(2, 4)`` with random edge weights,
the pallas route at block size 32 (the reference's Pallas kernel in
interpret mode).  SSSP, BFS and CC are exact semiring programs, so they
are held bitwise on every backend in every message dtype, results and
actives.  PageRank in bfloat16/float16 is held within 1e-5·max(pr) of
the reference on the same backend and dtype: a reassociated float32 sum
can flip a message's or a slot's rounding, and ten supersteps carry such
flips on (the largest gap seen here is 1.2e-6·max(pr), on segment).  The
limit lies below every 16-bit run's own gap from float32 at this size
(the smallest, float16 on scatter or segment, is 6.6e-5·max(pr)), so a
port that ignored the message dtype would fail it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bsp as J
from repro.core import scaled_paper_cluster, windgp
from repro.data import rmat

import repro_torch.bsp as T
from repro_torch.convert import runtime_from_numpy
from repro_torch.core import scaled_paper_cluster as port_cluster

APPS = {"sssp": dict(source=0, num_iters=12),
        "bfs": dict(source=1, num_iters=12),
        "cc": dict(num_iters=12)}
NAMES = {"sssp": "sssp", "bfs": "bfs", "cc": "connected_components"}
BACKENDS = [("scatter", {}), ("segment", {}),
            ("pallas", {"block_size": 32})]
DTYPES = ["float32", "bfloat16", "float16"]


@pytest.fixture(scope="module")
def runtimes():
    g = rmat(9, seed=42)
    cl = scaled_paper_cluster(2, 4, g.num_edges)
    w = (np.random.default_rng(9).random(g.num_edges) + 0.1).astype(
        np.float32)
    rt_ref = J.PartitionRuntime.create(g, assign=windgp(g, cl, t0=2).assign,
                                       p=cl.p, edge_weights=w)
    rt = runtime_from_numpy({f.name: getattr(rt_ref, f.name)
                             for f in dataclasses.fields(rt_ref)},
                            device="cpu")
    return g, cl, w, rt_ref, rt


def run_both(runtimes, app, **kw):
    *_, rt_ref, rt = runtimes
    want, act_ref = getattr(J, NAMES[app])(rt_ref, **APPS[app], **kw)
    got, act = getattr(T, NAMES[app])(rt, **APPS[app], **kw)
    return np.asarray(want), np.asarray(act_ref), got, act


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend,opts", BACKENDS,
                         ids=[b for b, _ in BACKENDS])
@pytest.mark.parametrize("app", list(APPS))
def test_sparse_app_matches_reference(runtimes, app, backend, opts, dtype):
    want, act_ref, got, act = run_both(runtimes, app, backend=backend,
                                       message_dtype=dtype, **opts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(act, act_ref)
    assert np.isfinite(got).any()


def test_sparse_apps_against_numpy_oracle(runtimes):
    g, _, w, _, rt = runtimes
    d, _ = T.sssp(rt, source=0, num_iters=40, backend="pallas",
                  block_size=32)
    # float32 path sums against the oracle's float64 ones
    np.testing.assert_allclose(d, T.ref.sssp(g, 0, w, num_iters=40),
                               rtol=1e-6)
    hops, _ = T.bfs(rt, source=1, num_iters=40, backend="segment")
    np.testing.assert_array_equal(hops, T.ref.bfs(g, 1, num_iters=40))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("backend,opts", BACKENDS,
                         ids=[b for b, _ in BACKENDS])
def test_low_precision_pagerank_matches_reference(runtimes, backend, opts,
                                                  dtype):
    *_, rt_ref, rt = runtimes
    want, act_ref = J.pagerank(rt_ref, num_iters=10, backend=backend,
                               message_dtype=dtype, **opts)
    got, act = T.pagerank(rt, num_iters=10, backend=backend,
                          message_dtype=dtype, **opts)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    np.testing.assert_array_equal(act, np.asarray(act_ref))
    f32, _ = T.pagerank(rt, num_iters=10, backend=backend, **opts)
    assert np.abs(got - f32).max() < 1e-2       # the reference's own bound


def test_triangle_count_matches_reference(runtimes):
    g, _, _, rt_ref, rt = runtimes
    want = J.triangle_count(rt_ref, g, max_degree=16)
    got = T.triangle_count(rt, g, max_degree=16, chunk=100)
    assert got == want == T.ref.triangle_count(g)
    # every edge on the hub fallback, and none
    assert T.triangle_count(rt, g, max_degree=1) == want
    assert T.triangle_count(rt, g, max_degree=int(g.degree().max())) == want


@pytest.mark.parametrize("comm_scale", ["static", "active"])
def test_simulator_matches_reference(runtimes, comm_scale):
    g, cl, _, rt_ref, rt = runtimes
    _, acts = T.sssp(rt, source=0, num_iters=12)
    pcl = port_cluster(2, 4, g.num_edges)
    for actives, steps in ((acts, 1), (None, 3)):
        want = J.simulate_superstep_times(rt_ref, cl, actives, steps,
                                          comm_scale)
        got = T.simulate_superstep_times(rt, pcl, actives, steps,
                                         comm_scale)
        np.testing.assert_array_equal(got, want)
        assert T.simulate_runtime(rt, pcl, actives, steps, comm_scale) \
            == J.simulate_runtime(rt_ref, cl, actives, steps, comm_scale)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("semiring,weights", [("plus_times", "weight"),
                                              ("min_plus", "zero"),
                                              ("or_and", "unit")])
def test_16bit_layout_is_the_float32_layout_rounded_once(runtimes, semiring,
                                                         weights, dtype):
    *_, rt_ref, rt = runtimes
    kw = dict(block_size=32, semiring=semiring, weights=weights)
    whole = rt.local_bsr(**kw).blocks.to(getattr(torch, dtype))
    chunked = rt.local_bsr(**kw, dtype=dtype)
    assert chunked.blocks.dtype == getattr(torch, dtype)
    assert torch.equal(chunked.blocks, whole)
    ref = rt_ref.local_bsr(**kw, dtype=dtype)
    np.testing.assert_array_equal(
        chunked.blocks.float().numpy(),
        np.asarray(jnp.asarray(ref.blocks).astype(jnp.float32)))
    assert rt.local_bsr(**kw, dtype=dtype) is chunked       # cached
    rt.clear_bsr_cache()
    assert rt.local_bsr(**kw, dtype=dtype) is not chunked


def test_app_registry_matches_reference(runtimes):
    rt = runtimes[-1]
    assert sorted(T.APP_BUILDERS) == sorted(J.APP_BUILDERS)
    assert T.MONOTONE_APPS == J.MONOTONE_APPS
    for app in T.APP_BUILDERS:
        spec = T.build_app(rt, app, backend="segment")
        assert spec.name == app
    with pytest.raises(ValueError, match="unknown BSP app"):
        T.build_app(rt, "louvain")

