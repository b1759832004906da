"""The multi-device BSP path: the port's machines as 8 gloo ranks on the
CPU against the JAX package's 8-device ``shard_map`` run, and against the
port's own stacked (``mesh=None``) run.

Setup as the reference's mesh tests (``tests/test_bsp_backends.py``):
``rmat(9, seed=2)`` on ``scaled_paper_cluster(2, 6)``, so p = 8, WindGP
with ``t0=2``.  The reference runs once in a subprocess with 8 host
devices (its ``pallas`` backend in interpret mode) and saves every result
with the graph and the assignment; the port runs the same calls once on 8
ranks through ``spawn_machines``, each rank packing its runtime from that
graph and assignment.

Tolerances:
* SSSP, BFS and CC: bitwise, actives included, on every backend, stepwise
  and fused, in float32 and in bfloat16 messages (min/max combine exactly
  in any order, so the 16-bit runs are bitwise too);
* PageRank in float32: rtol = atol = 1e-5, the reference's own bound
  between its mesh and vmap runs (the SUM exchange may add in another
  order); its ``tol`` gate must stop after as many supersteps;
* PageRank in bfloat16: not bitwise (a reassociated float32 sum can flip
  a message's rounding), so within the 1e-2 relative tolerance
  ``tests/test_bsp_fused.py`` holds 16-bit messages to, relative to
  max(pr).

This module imports no JAX (the reference runs in its subprocess), so the
ranks that unpickle its functions do not load JAX either.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.bsp as T
from repro_torch.bsp.distributed import Machines, machine_slice
from repro_torch.core.graph import Graph
from repro_torch.kernels.bsr_spmv import bsr_spmv

ROOT = pathlib.Path(__file__).resolve().parents[1]
P = 8
#: the seconds a spawn of the ranks may take before the launcher kills them
SPAWN_TIMEOUT_S = 300
APPS = {"pagerank": dict(num_iters=10), "sssp": dict(source=0, num_iters=20),
        "bfs": dict(source=1, num_iters=20), "cc": dict(num_iters=20)}
BACKENDS = {"scatter": {}, "segment": {}, "pallas": {"block_size": 32}}
MODES = {"stepwise": {}, "fused": dict(fused=True, chunk=4)}


def _calls() -> dict:
    """key -> (app, kwargs): every call both packages run under a mesh."""
    calls = {}
    for be, opts in BACKENDS.items():
        for app, base in APPS.items():
            for mode, kw in MODES.items():
                calls[f"{app}-{be}-{mode}"] = (
                    app, dict(**base, backend=be, **opts, **kw))
    calls["pagerank-tol"] = ("pagerank", dict(num_iters=50, tol=1e-6))
    for be in ("pallas", "scatter"):
        for app, base in APPS.items():
            calls[f"{app}-{be}-bfloat16"] = (
                app, dict(**base, backend=be, **BACKENDS[be],
                          message_dtype="bfloat16"))
    return calls


CALLS = _calls()

REFERENCE_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
from repro.bsp import (PartitionRuntime, pagerank, sssp, bfs,
                       connected_components)
from repro.core import scaled_paper_cluster, windgp
from repro.data import rmat

g = rmat(9, seed=2)
cl = scaled_paper_cluster(2, 6, g.num_edges)
assign = windgp(g, cl, t0=2).assign
rt = PartitionRuntime.build(g, assign, cl.p)
mesh = jax.make_mesh((8,), ("machines",))
fns = {"pagerank": pagerank, "sssp": sssp, "bfs": bfs,
       "cc": connected_components}
out = {"indptr": g.indptr, "indices": g.indices, "edge_ids": g.edge_ids,
       "edges": g.edges, "assign": np.asarray(assign), "p": cl.p}
for key, (app, kw) in json.loads(sys.argv[2]).items():
    res, acts = fns[app](rt, mesh=mesh, **kw)
    out[key + "/res"], out[key + "/acts"] = np.asarray(res), np.asarray(acts)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's mesh runs, the graph and the assignment."""
    path = tmp_path_factory.mktemp("mesh") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(path),
         json.dumps(CALLS)], env=env, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def graph_of(ref) -> Graph:
    return Graph(indptr=ref["indptr"], indices=ref["indices"],
                 edge_ids=ref["edge_ids"], edges=ref["edges"])


@pytest.fixture(scope="module")
def port_mesh(reference):
    """The port's runs on 8 gloo ranks: key -> [(result, actives)] by
    rank."""
    assert int(reference["p"]) == P
    keys = list(CALLS)
    by_rank = T.spawn_machines(
        T.run_apps, P, graph=graph_of(reference), assign=reference["assign"],
        args=([CALLS[k] for k in keys],), device="cpu",
        timeout=SPAWN_TIMEOUT_S)
    return {k: [runs[i] for runs in by_rank] for i, k in enumerate(keys)}


@pytest.fixture(scope="module")
def runtime(reference):
    """The port's stacked runtime of the same graph and assignment."""
    return T.PartitionRuntime.build(graph_of(reference), reference["assign"],
                                    P, device="cpu")


FNS = {"pagerank": T.pagerank, "sssp": T.sssp, "bfs": T.bfs,
       "cc": T.connected_components}


def hold(app: str, got, want):
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


FLOAT32 = [k for k in CALLS if not k.endswith("bfloat16")]


@pytest.mark.parametrize("key", FLOAT32)
def test_mesh_matches_reference_mesh(reference, port_mesh, key):
    app = CALLS[key][0]
    got, acts = port_mesh[key][0]
    hold(app, got, reference[key + "/res"])
    np.testing.assert_array_equal(acts, reference[key + "/acts"])
    assert acts.shape[1] == P


@pytest.mark.parametrize("key", FLOAT32)
def test_mesh_matches_stacked(runtime, port_mesh, key):
    """One machine a rank computes what the stacked machines compute."""
    app, kw = CALLS[key]
    want, want_acts = FNS[app](runtime, **kw)
    got, acts = port_mesh[key][0]
    hold(app, got, want)
    np.testing.assert_array_equal(acts, want_acts)


def test_tol_gate_stops_where_the_reference_stops(reference, port_mesh,
                                                  runtime):
    _, acts = port_mesh["pagerank-tol"][0]
    assert len(acts) == len(reference["pagerank-tol/acts"]) < 50
    _, stacked = T.pagerank(runtime, **CALLS["pagerank-tol"][1])
    assert len(acts) == len(stacked)


@pytest.mark.parametrize("key", [k for k in CALLS if k.endswith("bfloat16")])
def test_bfloat16_messages_match_reference_mesh(reference, port_mesh, key):
    app = CALLS[key][0]
    got, acts = port_mesh[key][0]
    want = reference[key + "/res"]
    np.testing.assert_array_equal(acts, reference[key + "/acts"])
    if app == "pagerank":           # not bitwise: 1e-2 relative to max(pr)
        assert np.abs(got - want).max() <= 1e-2 * want.max()
    else:                           # min/max: bitwise
        np.testing.assert_array_equal(got, want)


def test_every_rank_returns_the_same(port_mesh):
    for key, runs in port_mesh.items():
        for got, acts in runs[1:]:
            np.testing.assert_array_equal(got, runs[0][0], err_msg=key)
            np.testing.assert_array_equal(acts, runs[0][1], err_msg=key)


# ---------------------------------------------------------------------------
# machine_slice: one machine's runtime and layout
# ---------------------------------------------------------------------------

def test_machine_slice_keeps_global_fields(runtime):
    for r in range(P):
        s = machine_slice(runtime, r)
        assert s.p == 1
        assert (s.num_vertices, s.num_replicas, s.vmax, s.emax) == (
            runtime.num_vertices, runtime.num_replicas, runtime.vmax,
            runtime.emax)
        np.testing.assert_array_equal(s.local_vertex_gid[0],
                                      runtime.local_vertex_gid[r])
        np.testing.assert_array_equal(s.rep_slot[0], runtime.rep_slot[r])
    with pytest.raises(ValueError, match="out of range"):
        machine_slice(runtime, P)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
def test_machine_layout_has_its_own_width(runtime, semiring):
    """A machine's layout: R the cluster's, K its own (≤ the stacked K),
    and the same product as its row of the stacked layout, bitwise: the
    stacked layout's extra slots hold ``absent`` blocks, which fold to
    nothing."""
    kw = dict(block_size=32, semiring=semiring, weights="weight")
    stacked = runtime.local_bsr(**kw)
    _, R, K = stacked.cols.shape
    gen = torch.Generator().manual_seed(0)
    widths = []
    for r in range(P):
        one = machine_slice(runtime, r).local_bsr(**kw)
        assert one.cols.shape[:2] == (1, R) and one.cols.shape[2] <= K
        widths.append(one.cols.shape[2])
        assert one.fill_stats[0] == stacked.fill_stats[r]
        np.testing.assert_array_equal(one.gather[0], stacked.gather[r])
        x = torch.rand((1, R * 32), generator=gen)
        if semiring == "or_and":
            x = (x < 0.5).float()
        y = bsr_spmv(one.cols, one.blocks, x, semiring)
        want = bsr_spmv(stacked.cols[r:r + 1],
                                   stacked.blocks[r:r + 1], x, semiring)
        assert torch.equal(y, want)
    assert max(widths) == K and min(widths) < K


def on_the_world_group(rt, mesh):
    """A rank function that passes the bare default ``ProcessGroup``."""
    return T.bfs(rt, source=1, num_iters=20, mesh=dist.group.WORLD,
                 fused=True, chunk=4)


def test_a_bare_process_group_is_a_mesh():
    g, assign = tiny()
    rt = T.PartitionRuntime.build(g, assign, 2, device="cpu")
    want, want_acts = T.bfs(rt, source=1, num_iters=20, fused=True, chunk=4)
    for got, acts in T.spawn_machines(on_the_world_group, 2, graph=g,
                                      assign=assign, device="cpu",
                                      timeout=SPAWN_TIMEOUT_S):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(acts, want_acts)


def test_mesh_of_the_wrong_size_raises(runtime):
    with pytest.raises(ValueError, match="one machine a rank"):
        T.sssp(runtime, mesh=Machines(None, 0, P - 1, torch.device("cpu")))


# ---------------------------------------------------------------------------
# spawn_machines: a rank that fails or hangs
# ---------------------------------------------------------------------------

def fail_on_rank_one(rt, mesh):
    if mesh.rank == 1:
        raise ValueError("rank one gives up")
    dist.barrier()                  # rank 0 waits for a rank that is gone


def hang(rt, mesh):
    time.sleep(600)


def tiny():
    from repro_torch.data import rmat
    g = rmat(5, seed=1)
    return g, np.arange(g.num_edges) % 2


def test_spawn_raises_on_a_failed_rank():
    g, assign = tiny()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       "(.|\n)*rank one gives up"):
        T.spawn_machines(fail_on_rank_one, 2, graph=g, assign=assign,
                         device="cpu", timeout=SPAWN_TIMEOUT_S)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT_S / 2


def test_spawn_raises_on_a_hung_rank():
    g, assign = tiny()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2"):
        T.spawn_machines(hang, 2, graph=g, assign=assign, device="cpu",
                         timeout=10)
