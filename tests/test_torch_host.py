"""Port parity on the host path: generators, WindGP, runtime packing, and
the device-built Block-ELL layout, against the JAX package on the CPU;
the row layout against the port's Block-ELL layout.

Everything here is bitwise: the host code is a numpy copy, and the
device-built blocks accumulate each cell exactly as the reference's
``np_accum_at`` does.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.data as ref_data
from repro.bsp import PartitionRuntime as RefRuntime

import repro_torch.core as port_core
import repro_torch.data as port_data
from repro_torch.bsp import PartitionRuntime
from repro_torch.convert import RUNTIME_ARRAYS, runtime_from_numpy
from repro_torch.kernels.bsr_spmv import get_semiring
from repro_torch.kernels.bsr_spmv.rows import unit_entries


@pytest.mark.parametrize("gen,args", [
    ("rmat", (9,)), ("rmat", (10,)), ("graph500", (8,)),
    ("road_mesh", (30,)), ("erdos_renyi", (300, 6.0)),
])
def test_generators_bitwise(gen, args):
    for seed in (0, 42):
        a = getattr(ref_data, gen)(*args, seed=seed)
        b = getattr(port_data, gen)(*args, seed=seed)
        assert a.num_vertices == b.num_vertices
        assert a.edges.dtype == b.edges.dtype
        np.testing.assert_array_equal(a.edges, b.edges)


@pytest.mark.parametrize("spec,engine", [
    ("rmat:10", "batched"), ("mesh:30", "batched"), ("rmat:8", "heap"),
])
def test_windgp_assign_bitwise(spec, engine):
    kind, n = spec.split(":")
    gen = "road_mesh" if kind == "mesh" else "rmat"
    g_ref = getattr(ref_data, gen)(int(n), seed=42)
    g = getattr(port_data, gen)(int(n), seed=42)
    cl_ref = ref_core.scaled_paper_cluster(3, 6, g_ref.num_edges, slack=1.8)
    cl = port_core.scaled_paper_cluster(3, 6, g.num_edges, slack=1.8)
    a = ref_core.windgp(g_ref, cl_ref, engine=engine)
    b = port_core.windgp(g, cl, engine=engine)
    np.testing.assert_array_equal(a.assign, b.assign)
    assert a.stats.tc == b.stats.tc and a.stats.rf == b.stats.rf


def test_registry_equals_the_reference_registry():
    from repro.core import partitioners as ref_registry
    from repro_torch.core import partitioners
    for exclude in ((), {"oracle"}):
        assert partitioners.names(exclude=exclude) == \
            ref_registry.names(exclude=exclude)
    assert {"hash", "dbh", "greedy", "hdrf", "ebv", "ne", "metis",
            "windgp"} <= set(partitioners.names(exclude={"oracle"}))


@pytest.fixture(scope="module")
def runtimes():
    g_ref = ref_data.rmat(9, seed=42)
    g = port_data.rmat(9, seed=42)
    cl = ref_core.scaled_paper_cluster(2, 4, g.num_edges)
    assign = ref_core.windgp(g_ref, cl, t0=2).assign
    w = (np.random.default_rng(7).random(g.num_edges) + 0.1).astype(
        np.float32)
    rt_ref = RefRuntime.create(g_ref, assign=assign, p=cl.p, edge_weights=w)
    rt = PartitionRuntime.create(g, assign=assign, p=cl.p, edge_weights=w,
                                 device="cpu")
    return rt_ref, rt


def test_runtime_fields_equal(runtimes):
    rt_ref, rt = runtimes
    for f in ("p", "num_vertices", "num_replicas") + RUNTIME_ARRAYS:
        a, b = getattr(rt_ref, f), getattr(rt, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_runtime_create_routes():
    g = port_data.rmat(8, seed=42)
    cl = port_core.scaled_paper_cluster(2, 4, g.num_edges)
    rt = PartitionRuntime.create(g, method="windgp", cluster=cl, t0=2,
                                 device="cpu")
    assign = port_core.windgp(g, cl, t0=2).assign
    rt2 = PartitionRuntime.create(g, assign=assign, cluster=cl, device="cpu")
    np.testing.assert_array_equal(rt.local_edges, rt2.local_edges)
    with pytest.raises(ValueError):
        PartitionRuntime.create(g, method="windgp", device="cpu")
    with pytest.raises(ValueError):
        PartitionRuntime.create(g, assign=assign, device="cpu")
    with pytest.raises(ValueError):
        PartitionRuntime.create(g, assign=assign, p=cl.p, t0=2, device="cpu")


def test_global_scatter_roundtrip(runtimes):
    rt_ref, rt = runtimes
    vals = np.random.default_rng(3).random(rt.num_vertices).astype(
        np.float32)
    loc = rt.scatter_global(vals, fill=-1.0)
    np.testing.assert_array_equal(loc, rt_ref.scatter_global(vals, fill=-1.0))
    back = rt.gather_global(loc, fill=5.0)
    np.testing.assert_array_equal(back, rt_ref.gather_global(loc, fill=5.0))


def test_convert_roundtrip(runtimes):
    rt_ref, rt = runtimes
    moved = runtime_from_numpy(
        {f.name: getattr(rt_ref, f.name)
         for f in dataclasses.fields(rt_ref)}, device="cpu")
    for f in RUNTIME_ARRAYS:
        np.testing.assert_array_equal(getattr(moved, f), getattr(rt, f))
    assert moved.device == torch.device("cpu")


@pytest.mark.parametrize("bm", [16, 32])
@pytest.mark.parametrize("weights", ["weight", "unit", "zero"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
def test_local_bsr_equal(runtimes, semiring, weights, bm):
    rt_ref, rt = runtimes
    a = rt_ref.local_bsr(block_size=bm, semiring=semiring, weights=weights)
    b = rt.local_bsr(block_size=bm, semiring=semiring, weights=weights)
    np.testing.assert_array_equal(a.cols, b.cols.numpy())
    np.testing.assert_array_equal(a.gather, b.gather.numpy())
    np.testing.assert_array_equal(a.rank, b.rank.numpy())
    assert a.blocks.shape == tuple(b.blocks.shape)
    np.testing.assert_array_equal(a.blocks, b.blocks.numpy())
    # fill stats come from the edge lists; they equal the reference's count
    # of non-absent cells whenever no stored weight equals `absent`
    if not (weights == "zero" and semiring != "min_plus"):
        assert a.fill_stats == b.fill_stats
        assert a.aggregate_fill() == b.aggregate_fill()


def dense_of_blocks(bsr) -> torch.Tensor:
    """The (p, R·bm, R·bm) float32 matrix of a :class:`LocalBSR`: each ELL
    slot's block ⊕-folded at its block column (a padding slot's absent
    block folds to nothing)."""
    sr = get_semiring(bsr.semiring)
    p, R, K = bsr.cols.shape
    bm = bsr.block_size
    n = R * bm
    m, r, k, i, j = torch.meshgrid(*(torch.arange(d) for d in
                                     (p, R, K, bm, bm)), indexing="ij")
    col = bsr.cols.long()[m, r, k] * bm + j
    flat = ((m * n + r * bm + i) * n + col).reshape(-1)
    out = torch.full((p * n * n,), sr.absent, dtype=torch.float32)
    sr.scatter_accum(out, flat, bsr.blocks.float().reshape(-1))
    return out.view(p, n, n)


def dense_of_rows(rows) -> torch.Tensor:
    """The (p, n, n) float32 matrix of a :class:`LocalRows`: its stored
    cells, ``absent`` elsewhere."""
    sr = get_semiring(rows.semiring)
    n = rows.padded
    pos, row = unit_entries(rows.units, n)
    c = rows.cols[pos].long()
    keep = c >= 0
    out = torch.full((rows.p * n * n,), sr.absent, dtype=torch.float32)
    out[row[keep] * n + c[keep]] = rows.vals[pos[keep]].float()
    return out.view(rows.p, n, n)


@pytest.mark.parametrize("bm", [16, 32])
@pytest.mark.parametrize("weights", ["weight", "unit", "zero"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
def test_local_rows_expand_to_local_bsr(runtimes, semiring, weights, bm):
    """The row layout holds the dense layout's cells, bitwise, at the same
    positions (the same ``gather`` and ``rank``)."""
    _, rt = runtimes
    kw = dict(block_size=bm, semiring=semiring, weights=weights)
    dense, rows = rt.local_bsr(**kw), rt.local_rows(**kw)
    assert torch.equal(rows.gather, dense.gather)
    assert torch.equal(rows.rank, dense.rank)
    assert rows.padded == dense.padded
    assert torch.equal(dense_of_rows(rows), dense_of_blocks(dense))
    assert sum(s["entries"] for s in rows.fill_stats) \
        == dense.aggregate_fill()["nnz"]
