"""BSP engine and PageRank: the port against the JAX package on the CPU.

Both packages run on the same runtime (moved across by ``convert.py``).
Exchange min/max and integer sums are bitwise; float32 sums reassociate
across machines (rtol=1e-6).  PageRank is held at atol=1e-6, rtol=1e-5,
per backend and against the float64 numpy oracle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bsp import pagerank as ref_pagerank
from repro.bsp import PartitionRuntime as RefRuntime
from repro.bsp import ref as ref_oracle
from repro.bsp.engine import MACHINES, exchange as ref_exchange
from repro.core import scaled_paper_cluster, windgp
from repro.data import rmat

from repro_torch.bsp import (RunOptions, exchange, get_backend, pagerank,
                             run_bsp)
from repro_torch.bsp import ref as port_oracle
from repro_torch.convert import runtime_from_numpy


@pytest.mark.parametrize("mode", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_exchange_matches_vmapped_reference(mode, dtype):
    rng = np.random.default_rng(21)
    p, vmax, r = 4, 40, 9
    rep_slot = np.full((p, vmax), -1, np.int32)
    for i in range(p):       # each replica slot at most once per machine
        where = rng.choice(vmax, size=r, replace=False)
        keep = rng.random(r) < 0.7
        rep_slot[i, where[keep]] = np.arange(r, dtype=np.int32)[keep]
    if dtype == np.float32:
        vals = rng.standard_normal((p, vmax)).astype(dtype)
    else:
        vals = rng.integers(-1000, 1000, (p, vmax)).astype(dtype)
    want = np.asarray(jax.vmap(
        lambda v, s: ref_exchange(v, s, r, mode), axis_name=MACHINES)(
            jnp.asarray(vals), jnp.asarray(rep_slot)))
    got = exchange(torch.from_numpy(vals), torch.from_numpy(rep_slot), r,
                   mode).numpy()
    assert got.dtype == want.dtype
    if mode == "sum" and dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


def test_exchange_rejects_unknown_mode():
    with pytest.raises(ValueError):
        exchange(torch.zeros(2, 3), torch.full((2, 3), -1), 1, "prod")


@pytest.fixture(scope="module")
def runtimes():
    g = rmat(9, seed=42)
    cl = scaled_paper_cluster(2, 4, g.num_edges)
    rt_ref = RefRuntime.create(g, assign=windgp(g, cl, t0=2).assign,
                               p=cl.p)
    rt = runtime_from_numpy({f.name: getattr(rt_ref, f.name)
                             for f in dataclasses.fields(rt_ref)},
                            device="cpu")
    return g, rt_ref, rt


@pytest.mark.parametrize("backend,opts", [("scatter", {}),
                                          ("pallas", {"block_size": 32})])
def test_pagerank_matches_reference(runtimes, backend, opts):
    g, rt_ref, rt = runtimes
    want, act_ref = ref_pagerank(rt_ref, num_iters=10, backend=backend,
                                 **opts)
    got, act = pagerank(rt, num_iters=10, backend=backend, **opts)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(act, np.asarray(act_ref))
    oracle = ref_oracle.pagerank(g, num_iters=10)
    np.testing.assert_allclose(got, oracle, atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(port_oracle.pagerank(g, num_iters=10),
                                  oracle)


def test_pagerank_warm_start_is_fixed_point(runtimes):
    g, _, rt = runtimes
    pr, _ = pagerank(rt, num_iters=60)
    again, _ = pagerank(rt, num_iters=1, init=pr, backend="pallas",
                        block_size=32)
    np.testing.assert_allclose(again, pr, atol=1e-6, rtol=1e-5)


def test_zero_steps_give_empty_actives(runtimes):
    _, _, rt = runtimes
    for backend in ("scatter", "pallas"):
        pr, act = pagerank(rt, num_iters=0, backend=backend)
        assert act.shape == (0, rt.p)
        np.testing.assert_allclose(pr[rt.local_vertex_gid[0, 0]],
                                   1.0 / rt.num_vertices)
    _, act = run_bsp(lambda s, sa: (s, s["x"].sum(dim=1)),
                     {"x": torch.zeros(5, 3)}, {}, 0)
    assert act.shape == (0, 5)


def test_run_options_errors(runtimes):
    _, _, rt = runtimes
    with pytest.raises(ValueError, match="backend"):
        RunOptions(backend="dense").validate()
    with pytest.raises(ValueError, match="message_dtype"):
        RunOptions(message_dtype="float64").validate()
    with pytest.raises(ValueError, match="message_dtype"):
        pagerank(rt, num_iters=1, message_dtype="int8")
    with pytest.raises(ValueError, match="both"):
        pagerank(rt, num_iters=1, options=RunOptions(), backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        get_backend("dense")
    with pytest.raises(ValueError, match="message_dtype"):
        get_backend("scatter", message_dtype="float64").prepare(
            rt, "plus_times", "weight")
    assert RunOptions(backend="pallas").validate().backend_opts() == {
        "message_dtype": "float32"}
