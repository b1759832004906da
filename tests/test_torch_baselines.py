"""Port parity for the paper's baselines, the registry that holds them, and
the paper's §4 extensions, against the JAX package on the CPU.

Everything here is host numpy copied from the reference, so every check is
bitwise.
"""
import numpy as np
import pytest

import repro.core as ref_core
import repro.core.baselines as ref_baselines
import repro.core.extensions as ref_ext
import repro.core.partitioners as ref_registry
import repro.data as ref_data

import repro_torch.core as port_core
import repro_torch.core.baselines as port_baselines
import repro_torch.core.extensions as port_ext
import repro_torch.core.partitioners as port_registry
import repro_torch.data as port_data

GRAPHS = {"rmat:9": ("rmat", (9,)), "mesh:16": ("road_mesh", (16,)),
          "graph500:8": ("graph500", (8,))}

#: every registered method, the per-edge oracle loops included
METHODS = ref_registry.names()


def graphs(spec):
    gen, args = GRAPHS[spec]
    g_ref = getattr(ref_data, gen)(*args, seed=42)
    g = getattr(port_data, gen)(*args, seed=42)
    cl_ref = ref_core.scaled_paper_cluster(2, 4, g_ref.num_edges, slack=2.0)
    cl = port_core.scaled_paper_cluster(2, 4, g.num_edges, slack=2.0)
    return g_ref, cl_ref, g, cl


def knobs(name):
    """Small WindGP knobs, so that the WindGP variants stay quick."""
    return {"t0": 2} if name.startswith("windgp") else {}


def test_registry_equals_reference():
    assert port_registry.names() == ref_registry.names()
    assert port_registry.names(exclude={"oracle"}) == \
        ref_registry.names(exclude={"oracle"})
    for name in ref_registry.names():
        a, b = ref_registry.get(name), port_registry.get(name)
        assert a.capabilities == b.capabilities, name


def test_partitioners_snapshot_equals_reference():
    assert sorted(port_baselines.PARTITIONERS) == \
        sorted(ref_baselines.PARTITIONERS)


@pytest.mark.parametrize("spec", ["rmat:9", "mesh:16"])
@pytest.mark.parametrize("name", METHODS)
def test_assignment_bitwise(spec, name):
    g_ref, cl_ref, g, cl = graphs(spec)
    a = ref_registry.get(name)(g_ref, cl_ref, **knobs(name))
    b = port_registry.get(name)(g, cl, **knobs(name))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["greedy", "hdrf", "ebv"])
def test_block_size_1_is_the_oracle_loop(name):
    g_ref, cl_ref, g, cl = graphs("graph500:8")
    blocked = port_registry.get(name)(g, cl, block_size=1)
    oracle = port_registry.get(f"{name}_oracle")(g, cl)
    np.testing.assert_array_equal(blocked, oracle)
    np.testing.assert_array_equal(
        blocked, ref_registry.get(name)(g_ref, cl_ref, block_size=1))


@pytest.mark.parametrize("block_size", [7, 64])
def test_block_stream_assign_bitwise(block_size):
    from repro.core.baselines import streaming as ref_s
    from repro_torch.core.baselines import streaming as port_s
    g_ref, cl_ref, g, cl = graphs("rmat:9")
    a = ref_s.block_stream_assign(g_ref, cl_ref, ref_s.HDRFScorer(),
                                  block_size=block_size)
    b = port_s.block_stream_assign(g, cl, port_s.HDRFScorer(),
                                   block_size=block_size)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", ["rmat:9", "mesh:16"])
def test_extensions_bitwise(spec):
    g_ref, cl_ref, g, cl = graphs(spec)
    assign = ref_registry.get("hdrf")(g_ref, cl_ref)
    ms_ref, s_ref = ref_ext.evaluate_mapreduce(g_ref, assign, cl_ref)
    ms, s = port_ext.evaluate_mapreduce(g, assign, cl)
    assert ms == ms_ref and s.tc == s_ref.tc
    np.testing.assert_array_equal(s.t_total, s_ref.t_total)
    place_ref = ref_ext.vertex_partition_from_edge_partition(g_ref, assign,
                                                             cl_ref)
    place = port_ext.vertex_partition_from_edge_partition(g, assign, cl)
    np.testing.assert_array_equal(place, place_ref)
    assert port_ext.edge_cut(g, place) == ref_ext.edge_cut(g_ref, place_ref)
    assert port_ext.vertex_balance(place, cl.p) == \
        ref_ext.vertex_balance(place_ref, cl_ref.p)
