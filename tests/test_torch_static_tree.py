"""The apps' static tree stays resident on its runtime: built on the
runtime's first query, read by every later one, written by none.

Every app on every backend, stepwise and fused, gives bitwise the same
results and actives on a runtime's first and second query and on a fresh
copy of the runtime; the second query copies nothing (``bsp.h2d_bytes``)
and moves no counter.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.bsp import PartitionRuntime, apps, machine_slice
from repro_torch.bsp.partition_runtime import _TREE_FIELDS
from repro_torch.core import scaled_paper_cluster, windgp
from repro_torch.data import rmat

APPS = {"pagerank": (apps.pagerank, dict(num_iters=9)),
        "sssp": (apps.sssp, dict(source=0, num_iters=12)),
        "bfs": (apps.bfs, dict(source=1, num_iters=12)),
        "cc": (apps.connected_components, dict(num_iters=12))}
BACKENDS = {"scatter": {}, "segment": {}, "pallas": {"block_size": 32}}


@pytest.fixture(scope="module")
def runtime():
    g = rmat(9, seed=5)
    cl = scaled_paper_cluster(2, 4, g.num_edges)
    w = (np.random.default_rng(3).random(g.num_edges) + 0.1).astype(
        np.float32)
    return PartitionRuntime.create(g, assign=windgp(g, cl, t0=2).assign,
                                   p=cl.p, edge_weights=w, device="cpu")


def fresh(rt: PartitionRuntime) -> PartitionRuntime:
    """A copy of ``rt`` with an empty cache."""
    return dataclasses.replace(rt)


def query(rt, app, backend, fused=False):
    fn, kw = APPS[app]
    return fn(rt, backend=backend, fused=fused, **kw, **BACKENDS[backend])


def tree_bytes(rt) -> int:
    return sum(t.numel() * t.element_size()
               for t in rt.static_tree().values())


def counted(fn):
    """``fn()``'s result and the counters it moved."""
    before = obs.snapshot()
    out = fn()
    return out, obs.delta(obs.snapshot(), before)["counters"]


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("app", list(APPS))
def test_second_query_reuses_the_tree(runtime, app, backend, fused):
    rt = fresh(runtime)
    first, c1 = counted(lambda: query(rt, app, backend, fused))
    assert c1["bsp.h2d_bytes"] == tree_bytes(rt) > 0
    second, c2 = counted(lambda: query(rt, app, backend, fused))
    assert c2 == {}
    assert_same(second, first)
    assert_same(query(fresh(rt), app, backend, fused), first)


def test_resident_tree_is_never_written(runtime):
    rt = fresh(runtime)
    for app in APPS:
        for backend in BACKENDS:
            for fused in (False, True):
                query(rt, app, backend, fused)
    tree = rt.static_tree()
    assert set(tree) == set(_TREE_FIELDS)
    for name, (field, dt) in _TREE_FIELDS.items():
        assert tree[name].dtype == dt, name
        assert torch.equal(tree[name],
                           torch.as_tensor(getattr(rt, field)).to(dt)), name


def test_a_query_gets_its_own_dict_over_the_same_tensors(runtime):
    rt = fresh(runtime)
    a = rt.static_tree()
    a["extra"] = torch.zeros(1)
    b = rt.static_tree()
    assert "extra" not in b
    assert all(b[k] is a[k] for k in _TREE_FIELDS)
    # the tree owns its memory: it is no view of the runtime's arrays
    assert not np.shares_memory(b["vertex_valid"].numpy(), rt.vertex_valid)


def test_clear_bsr_cache_drops_the_tree(runtime):
    rt = fresh(runtime)
    query(rt, "sssp", "pallas")
    nbytes = tree_bytes(rt)
    rt.clear_bsr_cache()
    assert rt._bsr_cache == {}
    _, c = counted(lambda: query(rt, "sssp", "pallas"))
    assert c["bsp.h2d_bytes"] == nbytes


def test_a_changed_runtime_builds_its_own_tree(runtime):
    rt = fresh(runtime)
    dist, _ = query(rt, "sssp", "scatter")
    heavier = dataclasses.replace(rt, edge_weight=rt.edge_weight * 2)
    (dist2, _), c = counted(lambda: query(heavier, "sssp", "scatter"))
    assert c["bsp.h2d_bytes"] == tree_bytes(heavier)
    assert torch.equal(heavier.static_tree()["edge_weight"],
                       torch.from_numpy(heavier.edge_weight))
    finite = np.isfinite(dist)
    np.testing.assert_array_equal(dist2[finite], 2 * dist[finite])
    # a machine slice, the mesh path's runtime, starts empty too
    query(rt, "bfs", "scatter")
    assert machine_slice(rt, 0)._bsr_cache == {}
