"""The port's spans and counters (``repro_torch.obs``): their arithmetic,
their place in a profiler's trace, and where the program records them."""
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.bsp import PartitionRuntime, apps, pagerank
from repro_torch.bsp.partition_runtime import LocalBSR
from repro_torch.core import scaled_paper_cluster, windgp
from repro_torch.data import rmat


@pytest.fixture(scope="module")
def graph_and_cluster():
    g = rmat(9, seed=2)
    return g, scaled_paper_cluster(2, 6, g.num_edges)


@pytest.fixture(scope="module")
def runtime(graph_and_cluster):
    g, cl = graph_and_cluster
    return PartitionRuntime.create(g, assign=windgp(g, cl, t0=2).assign,
                                   p=cl.p, device="cpu")


def test_nested_spans_count_total_and_self():
    before = obs.snapshot()
    with obs.span("test.outer") as outer:
        for _ in range(3):
            with obs.span("test.inner"):
                time.sleep(0.002)
        time.sleep(0.004)
    d = obs.delta(obs.snapshot(), before)["spans"]
    assert d["test.outer"]["count"] == 1 and d["test.inner"]["count"] == 3
    inner = d["test.inner"]["total_s"]
    assert inner >= 0.006
    assert d["test.inner"]["self_s"] == pytest.approx(inner)
    assert d["test.outer"]["total_s"] == pytest.approx(outer.seconds)
    assert d["test.outer"]["self_s"] == pytest.approx(
        outer.seconds - inner, abs=1e-9)
    assert d["test.outer"]["self_s"] >= 0.004


def test_counters_and_delta():
    before = obs.snapshot()
    obs.count("test.things")
    obs.count("test.things", 41)
    mid = obs.snapshot()
    obs.count("test.bytes", 7)
    after = obs.snapshot()
    assert obs.delta(mid, before)["counters"] == {"test.things": 42}
    assert obs.delta(after, mid)["counters"] == {"test.bytes": 7}
    assert obs.delta(after, after) == {"spans": {}, "counters": {}}
    # a snapshot is a copy
    after["counters"]["test.bytes"] = 0
    assert obs.snapshot()["counters"]["test.bytes"] >= 7


def test_span_stack_is_per_thread():
    import threading
    before = obs.snapshot()

    def work():
        with obs.span("test.thread"):
            time.sleep(0.003)

    with obs.span("test.main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    d = obs.delta(obs.snapshot(), before)["spans"]
    # the other thread's span is no child of this thread's
    assert d["test.main"]["self_s"] == pytest.approx(d["test.main"]
                                                     ["total_s"])
    assert d["test.thread"]["count"] == 1


def test_spans_are_host_function_events_in_a_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("test.profiled"):
            with obs.span("test.profiled_inner"):
                torch.ones(8).sum()
    mine = [e for e in prof.events() if e.name.startswith(obs.PREFIX)]
    assert sorted(e.name for e in mine) == ["repro_torch.test.profiled",
                                            "repro_torch.test.profiled_inner"]
    for e in mine:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert e.is_user_annotation is False
    outer, inner = sorted(mine, key=lambda e: e.time_range.start)
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def test_no_profiler_no_event():
    before = obs.snapshot()
    with obs.span("test.unprofiled") as sp:
        pass
    assert sp._range is None
    assert obs.delta(obs.snapshot(), before)["spans"]["test.unprofiled"][
        "count"] == 1


@pytest.mark.parametrize("app,args", [
    ("pagerank", {}), ("sssp", {"source": 0}), ("bfs", {"source": 1}),
    ("connected_components", {})])
def test_query_spans_and_upload(runtime, app, args):
    """A query prepares once, so ``bsp.prepare`` counts queries; the first
    query on a runtime copies its static tree, a second copies nothing and
    counts one hit."""
    rt = dataclasses.replace(runtime)          # an empty cache
    before = obs.snapshot()
    _, act = getattr(apps, app)(rt, num_iters=7, backend="scatter", **args)
    d = obs.delta(obs.snapshot(), before)
    assert {k: v["count"] for k, v in d["spans"].items()} == {
        "bsp.prepare": 1, "bsp.superstep": len(act), "bsp.finalize": 1}
    tree = rt._bsr_cache[apps._TREE_KEY]
    assert d["counters"] == {"bsp.h2d_bytes": sum(
        t.numel() * t.element_size() for t in tree.values())}
    before = obs.snapshot()
    getattr(apps, app)(rt, num_iters=7, backend="scatter", **args)
    d = obs.delta(obs.snapshot(), before)
    assert d["spans"]["bsp.prepare"]["count"] == 1
    assert d["counters"] == {"bsp.tree_hits": 1}


def test_query_steps_do_not_overlap_in_a_profile(runtime):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pagerank(runtime, num_iters=3, backend="scatter")
    steps = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name in (
                       "repro_torch.bsp.prepare", "repro_torch.bsp.superstep",
                       "repro_torch.bsp.finalize"))
    assert [n.split(".")[-1] for *_, n in steps] == \
        ["prepare"] + ["superstep"] * 3 + ["finalize"]
    for (_, end, _), (start, _, _) in zip(steps, steps[1:]):
        assert end <= start


def test_windgp_phase_seconds_are_its_spans(graph_and_cluster):
    g, cl = graph_and_cluster
    before = obs.snapshot()
    res = windgp(g, cl, t0=2)
    spans = obs.delta(obs.snapshot(), before)["spans"]
    assert set(res.phase_seconds) == {"preprocess", "expand", "sls"}
    for phase, seconds in res.phase_seconds.items():
        assert spans[f"windgp.{phase}"]["count"] == 1
        assert spans[f"windgp.{phase}"]["total_s"] == pytest.approx(
            seconds, rel=1e-12, abs=1e-12)
    assert spans["windgp"]["total_s"] == pytest.approx(res.seconds,
                                                       rel=1e-12)
    assert res.seconds >= sum(res.phase_seconds.values())
    # tracing changes nothing of the result (tests/test_torch_host.py holds
    # the assignment bitwise against the JAX package's)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = windgp(g, cl, t0=2)
    np.testing.assert_array_equal(res.assign, traced.assign)


def test_windgp_train_balance_phase_is_a_span(graph_and_cluster):
    g, cl = graph_and_cluster
    mask = np.zeros(g.num_vertices, dtype=bool)
    mask[::3] = True
    before = obs.snapshot()
    res = windgp(g, cl, t0=2, train_mask=mask, train_balance=0.5)
    spans = obs.delta(obs.snapshot(), before)["spans"]
    assert spans["windgp.train_balance"]["total_s"] == pytest.approx(
        res.phase_seconds["train_balance"], rel=1e-12, abs=1e-12)


def test_layout_spans_once_per_build_none_on_a_hit(graph_and_cluster):
    g, cl = graph_and_cluster
    rt = PartitionRuntime.create(g, assign=np.arange(g.num_edges) % cl.p,
                                 p=cl.p, device="cpu")
    before = obs.snapshot()
    rt.local_bsr(block_size=32)
    d = obs.delta(obs.snapshot(), before)["spans"]
    assert d["layout.host"]["count"] == 1
    assert d["layout.device"]["count"] == 1
    mid = obs.snapshot()
    rt.local_bsr(block_size=32)                     # a cache hit
    assert obs.delta(obs.snapshot(), mid)["spans"] == {}
    LocalBSR.build(rt, block_size=16)
    d = obs.delta(obs.snapshot(), mid)["spans"]
    assert d["layout.host"]["count"] == 1 and d["layout.device"]["count"] == 1


def test_pack_is_a_span(graph_and_cluster):
    g, cl = graph_and_cluster
    before = obs.snapshot()
    PartitionRuntime.create(g, assign=np.arange(g.num_edges) % cl.p,
                            p=cl.p, device="cpu")
    PartitionRuntime.create(g, method="hash", cluster=cl, device="cpu")
    assert obs.delta(obs.snapshot(), before)["spans"]["pack"]["count"] == 2
