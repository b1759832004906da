"""The fused runner, frontier compaction and the shared run options: the
port against the JAX package and against its own stepwise runner, on the
CPU (where the fused runner runs its predicated chunks eagerly).

Both packages run on one runtime (``rmat(9)``, ``scaled_paper_cluster(2,
4)``, moved across by ``convert.py``).  SSSP, BFS and CC are bitwise on
every backend and message dtype, fused as stepwise; PageRank's fused run
is held to its stepwise one at atol=1e-6 (the reference's own bound), and
its ``tol`` gate must stop after the same number of supersteps as the
reference's, at a ``tol`` that lies between two supersteps' residuals.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.bsp as J
from repro.core import scaled_paper_cluster, windgp
from repro.data import rmat

import repro_torch.bsp as T
from repro_torch.bsp.apps import _options
from repro_torch.convert import runtime_from_numpy

APPS = {"pagerank": ("pagerank", dict(num_iters=15)),
        "sssp": ("sssp", dict(source=0, num_iters=25)),
        "bfs": ("bfs", dict(source=1, num_iters=25)),
        "cc": ("connected_components", dict(num_iters=25))}
BACKENDS = [("scatter", {}), ("segment", {}),
            ("pallas", {"block_size": 32})]


@pytest.fixture(scope="module")
def runtimes():
    g = rmat(9, seed=42)
    cl = scaled_paper_cluster(2, 4, g.num_edges)
    rt_ref = J.PartitionRuntime.create(g, assign=windgp(g, cl, t0=2).assign,
                                       p=cl.p)
    rt = runtime_from_numpy({f.name: getattr(rt_ref, f.name)
                             for f in dataclasses.fields(rt_ref)},
                            device="cpu")
    return rt_ref, rt


def run(pkg, rt, app, **kw):
    name, base = APPS[app]
    out, acts = getattr(pkg, name)(rt, **base, **kw)
    return np.asarray(out), np.asarray(acts)


@pytest.mark.parametrize("backend,opts", BACKENDS,
                         ids=[b for b, _ in BACKENDS])
@pytest.mark.parametrize("app", list(APPS))
def test_fused_matches_stepwise(runtimes, app, backend, opts):
    """Fused ≡ stepwise: results and the actives prefix, per app."""
    _, rt = runtimes
    a, acts_a = run(T, rt, app, backend=backend, **opts)
    b, acts_b = run(T, rt, app, backend=backend, fused=True, chunk=4,
                    **opts)
    if app == "pagerank":
        np.testing.assert_allclose(a, b, atol=1e-6)
    else:
        np.testing.assert_array_equal(a, b)
    n = len(acts_b)
    np.testing.assert_array_equal(acts_a[:n], acts_b)
    # anything the fused runner skipped, the oracle spent idling
    assert acts_a[n:].sum() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("backend,opts", BACKENDS,
                         ids=[b for b, _ in BACKENDS])
@pytest.mark.parametrize("app", ["sssp", "bfs", "cc"])
def test_fused_matches_reference_fused(runtimes, app, backend, opts, dtype):
    rt_ref, rt = runtimes
    kw = dict(backend=backend, fused=True, chunk=4, message_dtype=dtype,
              **opts)
    want, acts_ref = run(J, rt_ref, app, **kw)
    got, acts = run(T, rt, app, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(acts, acts_ref)


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
def test_chunk_size_is_cosmetic(runtimes, chunk):
    """Any chunking (incl. chunk > budget) gives the same trajectory."""
    _, rt = runtimes
    d0, acts0 = T.sssp(rt, source=0, num_iters=25)
    d1, acts1 = T.sssp(rt, source=0, num_iters=25, fused=True, chunk=chunk)
    np.testing.assert_array_equal(d0, d1)
    # a monotone app exits early mid-chunk regardless of the boundary
    assert 0 < len(acts1) < 25
    np.testing.assert_array_equal(acts0[:len(acts1)], acts1)


def test_fused_state_equals_reference_fused_state(runtimes):
    """Every state leaf, BFS's step counter too: the predicated tail of a
    chunk keeps the state as the reference's loop, which skips it."""
    rt_ref, rt = runtimes
    spec_ref = J.build_app(rt_ref, "bfs", source=1)
    want, _ = J.run_bsp_fused(spec_ref.superstep, spec_ref.state,
                              spec_ref.static, 25, chunk=8)
    spec = T.build_app(rt, "bfs", source=1)
    got, _ = T.run_bsp_fused(spec.superstep, spec.state, spec.static, 25,
                             chunk=8)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    stepwise, _ = T.run_bsp(spec.superstep, spec.state, spec.static, 25)
    assert (stepwise["step"] == 25).all()
    assert (got["step"] < 25).all()


def test_pagerank_tol_stops_where_the_reference_stops(runtimes):
    rt_ref, rt = runtimes
    spec = T.build_pagerank(rt)
    state, residuals = spec.state, []
    for _ in range(30):
        new, _ = spec.superstep(state, spec.static)
        residuals.append(float((new["pr"] - state["pr"]).abs().max()))
        state = new
    # a tol between two supersteps' residuals, far from either
    k = 12
    tol = float(np.sqrt(residuals[k] * residuals[k + 1]))
    assert residuals[k + 1] < tol < residuals[k]
    pr_t, acts_t = T.pagerank(rt, num_iters=50, tol=tol)
    pr_ref, acts_ref = J.pagerank(rt_ref, num_iters=50, tol=tol)
    assert len(acts_t) == len(acts_ref) == k + 2
    np.testing.assert_allclose(pr_t, np.asarray(pr_ref), atol=1e-6,
                               rtol=1e-5)
    pr_f, _ = T.pagerank(rt, num_iters=50)
    # drift from stopping early is bounded by ~tol·d/(1-d)
    assert np.abs(pr_t - pr_f).max() <= 10 * tol


def test_zero_steps_returns_0_by_p(runtimes):
    """num_steps=0: (0, p) actives and an untouched state."""
    _, rt = runtimes
    spec = T.build_pagerank(rt)
    for runner in (T.run_bsp, T.run_bsp_fused):
        out, acts = runner(spec.superstep, spec.state, spec.static, 0)
        assert acts.shape == (0, rt.p), runner.__name__
        for k in spec.state:
            assert torch.equal(out[k], spec.state[k])


def test_runner_factory_reuse(runtimes):
    """One runner serves many calls and step budgets."""
    _, rt = runtimes
    spec = T.build_pagerank(rt)
    runner = T.make_fused_runner(spec.superstep, spec.static, chunk=4)
    _, acts5 = runner(spec.state, 5)
    _, acts9 = runner(spec.state, 9)
    assert acts5.shape == (5, rt.p) and acts9.shape == (9, rt.p)
    np.testing.assert_array_equal(acts9[:5], acts5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("app", ["sssp", "bfs"])
def test_frontier_cap_bitwise_vs_dense(runtimes, app, fused):
    """A generous cap never drops a message: bitwise == dense."""
    _, rt = runtimes
    dense, acts = run(T, rt, app, backend="scatter", fused=fused)
    sparse, acts_s = run(T, rt, app, backend="scatter", fused=fused,
                         frontier_cap=int(rt.vmax))
    np.testing.assert_array_equal(dense, sparse)
    np.testing.assert_array_equal(acts, acts_s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [3, 40])
def test_frontier_cap_drops_as_the_reference_drops(runtimes, cap, dtype):
    """A tight cap drops live vertices beyond it: the same ones as the
    reference's ``nonzero(size=cap)``."""
    rt_ref, rt = runtimes
    kw = dict(backend="scatter", frontier_cap=cap, message_dtype=dtype)
    want, acts_ref = run(J, rt_ref, "sssp", **kw)
    got, acts = run(T, rt, "sssp", **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(acts, acts_ref)


def test_frontier_entries_matches_reference(runtimes):
    rt_ref, rt = runtimes
    rng = np.random.default_rng(5)
    for changed in (rt.vertex_valid, np.zeros_like(rt.vertex_valid),
                    rng.random(rt.vertex_valid.shape) < 0.3):
        np.testing.assert_array_equal(T.frontier_entries(rt, changed),
                                      J.frontier_entries(rt_ref, changed))
    assert T.frontier_entries(rt, rt.vertex_valid).sum() \
        == rt.vertex_valid.sum()


def test_float32_messages_are_the_default(runtimes):
    _, rt = runtimes
    for backend in ("scatter", "segment"):
        a, _ = T.pagerank(rt, num_iters=12, backend=backend)
        b, _ = T.pagerank(rt, num_iters=12, backend=backend,
                          message_dtype="float32")
        np.testing.assert_array_equal(a, b)


BAD_OPTIONS = {
    "backend": ("pagerank", dict(backend="dense")),
    "dtype": ("pagerank", dict(message_dtype="float64")),
    "chunk": ("pagerank", dict(chunk=0)),
    "tol-sssp": ("sssp", dict(tol=1e-6)),
    "tol-cc": ("cc", dict(tol=1e-6)),
    "cap-segment": ("pagerank", dict(frontier_cap=8, backend="segment")),
    "cap-pallas": ("sssp", dict(frontier_cap=8, backend="pallas")),
}


@pytest.mark.parametrize("case", list(BAD_OPTIONS))
def test_run_options_reject_as_the_reference_rejects(case):
    app, bad = BAD_OPTIONS[case]
    with pytest.raises(ValueError) as ref_err:
        J.RunOptions(**bad).validate(app)
    with pytest.raises(ValueError) as err:
        T.RunOptions(**bad).validate(app)
    # the same rejection: the messages open alike
    assert str(err.value).split()[:4] == str(ref_err.value).split()[:4]


def test_options_mixing_and_passthrough(runtimes):
    _, rt = runtimes
    for kw in (dict(backend="pallas"), dict(fused=True), dict(tol=1e-6),
               dict(chunk=4), dict(message_dtype="bfloat16"),
               dict(frontier_cap=4)):
        with pytest.raises(ValueError, match="both"):
            T.pagerank(rt, num_iters=1, options=T.RunOptions(), **kw)
    opts, extra = _options(None, "sssp", "scatter", True, None, 3,
                           {"frontier_cap": 7, "message_dtype": "float16"})
    assert opts == T.RunOptions(fused=True, chunk=3, frontier_cap=7,
                                message_dtype="float16")
    assert extra == {}
    assert opts.backend_opts() == {"message_dtype": "float16",
                                   "frontier_cap": 7}
    with pytest.raises(ValueError, match="frontier_cap"):
        T.sssp(rt, num_iters=2, frontier_cap=0)


@pytest.fixture(scope="module")
def graph500_runtimes():
    """The slice's graph on the CLI's default cluster (3 super + 6 normal
    machines, slack 1.8), as the chip run partitions it."""
    from repro.launch.partition import load_graph
    g = load_graph("graph500:16")
    cl = scaled_paper_cluster(3, 6, g.num_edges, slack=1.8)
    assign = windgp(g, cl, alpha=0.3, beta=0.3, t0=8, theta=0.01).assign
    rt_ref = J.PartitionRuntime.create(g, assign=assign, p=cl.p)
    rt = runtime_from_numpy({f.name: getattr(rt_ref, f.name)
                             for f in dataclasses.fields(rt_ref)},
                            device="cpu")
    return rt_ref, rt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tol_steps_match_reference_at_graph500_16(graph500_runtimes, dtype):
    """The ``tol`` gate stops after as many supersteps as the reference's
    at ``graph500:16`` (``scatter``: the pallas layout, 37 GB in float32,
    is for the card, where there is no JAX)."""
    rt_ref, rt = graph500_runtimes
    kw = dict(num_iters=40, tol=1e-7, message_dtype=dtype)
    want, acts_ref = J.pagerank(rt_ref, **kw)
    got, acts = T.pagerank(rt, **kw)
    assert len(acts) == len(acts_ref) < 40
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-5)
