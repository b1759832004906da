"""Port parity for dynamic repartitioning: a ``DynamicPartitioner`` seeded
from a streamed assignment, a few epochs of inserts and deletes, their
deltas and repair reports, the on-disk ``StreamAssignment.apply_delta``
and ``PartitionRuntime.apply_delta``, against the JAX package and against a
fresh ``from_stream`` repack, bitwise.
"""
import dataclasses

import numpy as np
import pytest

from repro.bsp import PartitionRuntime as RefRuntime
from repro.bsp import StreamAssignment as RefAssignment
from repro.core import DynamicPartitioner as RefDynamic
from repro.core import from_edge_list as ref_from_edge_list
from repro.core import scaled_paper_cluster as ref_cluster
from repro.core.baselines import streaming as ref_s
from repro.data import rmat

from repro_torch.bsp import PartitionRuntime, StreamAssignment
from repro_torch.convert import RUNTIME_ARRAYS
from repro_torch.core import DynamicPartitioner, from_edge_list
from repro_torch.core import scaled_paper_cluster
from repro_torch.core.baselines import streaming as port_s
from repro_torch.data import count_edge_list, write_edge_list

EPOCHS = 3
CHURN = 0.05        # inserts and deletes an epoch, each a share of live E

PACKAGES = {
    "ref": (ref_s, RefAssignment, RefRuntime, RefDynamic, ref_cluster,
            ref_from_edge_list),
    "port": (port_s, StreamAssignment, PartitionRuntime, DynamicPartitioner,
             scaled_paper_cluster, from_edge_list),
}


def seed_from_assignment(sa, from_edges):
    """The graph of a finalized assignment's live edges (canonical order)
    and each edge's machine."""
    edges = np.concatenate([sa.machine_edges(i) for i in range(sa.p)])
    ms = np.repeat(np.arange(sa.p), sa.edges_per)
    g = from_edges(edges, sa.num_vertices)
    order = np.argsort(edges[:, 0] * sa.num_vertices + edges[:, 1])
    np.testing.assert_array_equal(edges[order], g.edges)
    return g, ms[order]


def epochs(num_vertices, num_edges, seed=0):
    """``EPOCHS`` batches of (new pairs, indices into the live edges to
    delete), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(CHURN * num_edges)
    return [(rng.integers(0, num_vertices, size=(n, 2)), rng.random(n))
            for _ in range(EPOCHS)]


def run_package(tag, tmp_path, g0, path, draws, skew_limit):
    """Stream ``path`` to disk, seed the dynamic layer from it, and run
    ``draws``; per epoch, what the checks compare."""
    stream, klass, runtime, dynamic, cluster, from_edges = PACKAGES[tag]
    kw = {} if tag == "ref" else {"device": "cpu"}
    cl = cluster(2, 4, g0.num_edges, slack=2.0)
    sa = klass(tmp_path / tag, cl.p, count_edge_list(path)[0])
    state = stream.stream_partition(path, cluster=cl, method="hdrf",
                                    dedup="two_pass", block_size=256,
                                    sink=sa.sink)
    sa.finalize(state, {"method": "hdrf"})
    g, assign = seed_from_assignment(sa, from_edges)
    d = dynamic(g, cl, assign, method="hdrf", skew_limit=skew_limit)
    rt = runtime.from_stream(sa, **kw)
    out = []
    for new, pick in draws:
        snap = d.snapshot()
        d.insert(new)
        live = np.flatnonzero(d.state.assign >= 0)
        gone = np.unique((pick * len(live)).astype(np.int64))
        d.delete(d.g.edges[live[gone]])
        delta = d.delta_since(snap)
        meta = sa.apply_delta(delta, d.membership())
        rt = rt.apply_delta(sa, delta, **kw)
        full = runtime.from_stream(sa, **kw)
        out.append({"delta": delta, "assign": d.state.assign.copy(),
                    "repairs": list(d.repairs), "tc": d.tc,
                    "counters": dict(d.counters), "meta": meta,
                    "shards": [sa.machine_edges(i) for i in range(sa.p)],
                    "runtime": rt, "full": full})
    return out


def runtimes_equal(a, b):
    for f in ("p", "num_vertices", "num_replicas") + RUNTIME_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("skew_limit", [1.35, 1.02],
                         ids=["default", "tight"])
def test_epochs_equal_reference_and_repack(tmp_path, skew_limit):
    g0 = rmat(9, seed=3)
    path = str(tmp_path / "edges.txt")
    write_edge_list(g0, path)
    draws = epochs(g0.num_vertices + 8, g0.num_edges)
    ref = run_package("ref", tmp_path, g0, path, draws, skew_limit)
    port = run_package("port", tmp_path, g0, path, draws, skew_limit)
    for a, b in zip(ref, port):
        for f in dataclasses.fields(a["delta"]):
            np.testing.assert_array_equal(getattr(a["delta"], f.name),
                                          getattr(b["delta"], f.name),
                                          err_msg=f.name)
        assert b["delta"].num_changes > 0
        np.testing.assert_array_equal(a["assign"], b["assign"])
        assert [dataclasses.asdict(r) for r in a["repairs"]] == \
            [dataclasses.asdict(r) for r in b["repairs"]]
        assert (a["tc"], a["counters"], a["meta"]) == \
            (b["tc"], b["counters"], b["meta"])
        for x, y in zip(a["shards"], b["shards"]):
            np.testing.assert_array_equal(x, y)
        runtimes_equal(a["runtime"], b["runtime"])
        runtimes_equal(b["full"], b["runtime"])
        assert b["runtime"]._bsr_cache == {}
    if skew_limit < 1.1:
        assert port[-1]["repairs"], "the tight leash never repaired"


def test_apply_delta_takes_unit_weights_only(tmp_path):
    g0 = rmat(8, seed=1)
    cl = scaled_paper_cluster(2, 2, g0.num_edges, slack=2.0)
    path = str(tmp_path / "edges.txt")
    write_edge_list(g0, path)
    sa = StreamAssignment(tmp_path / "a", cl.p, count_edge_list(path)[0])
    sa.finalize(port_s.stream_partition(path, cluster=cl, sink=sa.sink))
    g, assign = seed_from_assignment(sa, from_edge_list)
    d = DynamicPartitioner(g, cl, assign)
    rt = PartitionRuntime.from_stream(
        sa, edge_weights=lambda e, i: np.full(len(e), 2.0), device="cpu")
    snap = d.snapshot()
    d.insert(np.array([[0, sa.num_vertices + 1]]))
    delta = d.delta_since(snap)
    sa.apply_delta(delta, d.membership())
    with pytest.raises(ValueError, match="unit edge weights"):
        rt.apply_delta(sa, delta, device="cpu")
