"""The launch tooling of the port against the JAX package, on the CPU.

``sharding/specs.py`` bitwise against the reference's split rules for all
ten archs' published configs on three meshes (the reference takes its
leaf shapes from ``jax.eval_shape`` and reads only ``mesh.shape``, so a
stand-in object with that dict serves); ``dryrun.fit``'s bytes against the
reference's leaves split by its specs; the roofline formulas and
``parse_overrides`` against the reference's; ``perf.run_variant`` on the
CPU at reduced configs and shrunk shapes; ``dryrun --bsp`` on 8 gloo ranks.
"""
import dataclasses
import functools
import importlib
import math
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.sharding import specs as R

from repro_torch.bsp import PartitionRuntime, build_app
from repro_torch.configs import ARCHS, SHAPES, cells, get_config, get_reduced
from repro_torch.core import scaled_paper_cluster, windgp
from repro_torch.data import rmat
from repro_torch.launch import dryrun, perf, roofline
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     one_card)
from repro_torch.models import forward
from repro_torch.sharding import specs as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


def reference_module(name: str):
    """Import a reference module that sets ``XLA_FLAGS`` when imported
    (``repro.launch.dryrun``, ``repro.launch.perf``), leaving the variable
    as it was for the JAX backend of this process."""
    kept = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if kept is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = kept


def padded(spec, rank: int) -> tuple:
    return tuple(spec) + (None,) * (rank - len(tuple(spec)))


def flat(tree, shapes) -> dict:
    """``{"a/b/c": spec padded to its leaf's rank}`` of a reference spec
    tree over its shape tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    ranks = [len(s.shape) for s in jax.tree.leaves(shapes)]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            padded(spec, r) for (path, spec), r in zip(leaves, ranks)}


@functools.lru_cache(maxsize=None)
def reference_shapes(arch: str):
    return jax.eval_shape(functools.partial(jax_init_params,
                                            jax_config(arch)),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def test_registry_matches_reference():
    assert ARCHS == JAX_ARCHS


@pytest.mark.parametrize("mesh_shape,axes", MESHES,
                         ids=["pod16x16", "pod2x16x16", "mesh2x2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, mesh_shape, axes):
    mesh = make_mesh(mesh_shape, axes)
    stand_in = types.SimpleNamespace(shape=mesh.shape)
    cfg, jcfg = get_config(arch), jax_config(arch)
    pshapes = reference_shapes(arch)
    shapes = S.param_shapes(cfg)
    want_shapes = {"/".join(str(getattr(k, "key", k)) for k in path):
                   (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in
                   jax.tree_util.tree_flatten_with_path(pshapes)[0]}
    assert {k: (tuple(s), str(dt).split(".")[-1])
            for k, (s, dt) in shapes.items()} == want_shapes
    assert list(shapes) == list(want_shapes)          # the leaf order
    for fsdp in (False, True):
        want = R.param_specs(jcfg, pshapes, stand_in, fsdp=fsdp)
        got = S.param_specs(cfg, mesh, fsdp=fsdp)
        assert got == flat(want, pshapes)
        assert S.opt_state_specs(got, shapes, mesh) == flat(
            R.opt_state_specs(want, pshapes, stand_in), pshapes)
    for B in (1, 2, 8, 16, 32, 128, 256):
        assert S.logical_batch_spec(mesh, B) == tuple(
            R.logical_batch_spec(stand_in, B))
        for kind in ("train", "prefill", "decode"):
            want = R.input_specs_for(jcfg, stand_in, B, kind)
            got = S.input_specs_for(cfg, mesh, B, kind)
            assert list(got) == list(want)
            for k, spec in want.items():
                assert got[k] == padded(spec, len(got[k])), (k, kind)
        for max_len in (4096, 32768, 524288, 1000):
            want = R.cache_specs(jcfg, stand_in, B, max_len)
            cshapes = jax.eval_shape(
                lambda: jax_init_cache(jcfg, B, 16, dtype=jnp.bfloat16))
            got = S.cache_specs(cfg, mesh, B, max_len)
            assert got == {pos: {leaf: padded(
                spec, len(cshapes[pos][leaf].shape))
                for leaf, spec in leaves.items()}
                for pos, leaves in want.items()}
    assert S.data_axes(mesh) == R.data_axes(stand_in)


def reference_split(stand_in, spec) -> int:
    return math.prod(R._axis_size(stand_in, a) for a in spec
                     if a is not None)


def reference_bytes(tree, specs, stand_in, dtype=None) -> int:
    """Sum over the reference's leaves of leaf bytes over the product of
    the axes in its spec (``dtype`` in place of each leaf's where given)."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        item = jnp.dtype(dtype or leaf.dtype).itemsize
        nbytes = math.prod(leaf.shape) * item
        split = reference_split(stand_in, spec)
        assert nbytes % split == 0
        total += nbytes // split
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_fit_bytes_match_reference_leaves(arch):
    """Parameters, float32 gradients, the AdamW moments, the cache and the
    inputs per device: the reference's leaves (``jax.eval_shape``) over the
    product of the axes in the reference's spec, FSDP by the reference's
    rule.  Activations are the port's estimate and have no reference."""
    ref_dryrun = reference_module("repro.launch.dryrun")
    cfg, jcfg = get_config(arch), jax_config(arch)
    pshapes = reference_shapes(arch)
    n = sum(math.prod(x.shape) for x in jax.tree.leaves(pshapes))
    meshes = [make_production_mesh(), make_production_mesh(multi_pod=True),
              make_mesh((2, 2, 2), ("pod", "data", "model")), one_card()]
    for mesh in meshes:
        stand_in = types.SimpleNamespace(shape=mesh.shape)
        pspecs = R.param_specs(jcfg, pshapes, stand_in, fsdp=n > 12e9)
        for shape in SHAPES:
            if shape == "long_500k" and (arch, shape) not in cells():
                continue
            sh = SHAPES[shape]
            B, Sq, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
            got = dryrun.fit(cfg, shape, mesh)
            assert got["fsdp"] == (n > 12e9)
            want = {"params": reference_bytes(pshapes, pspecs, stand_in)}
            if kind == "train":
                want["grads"] = reference_bytes(pshapes, pspecs, stand_in,
                                                jnp.float32)
                mom = R.opt_state_specs(pspecs, pshapes, stand_in)
                want["moments"] = 2 * reference_bytes(
                    pshapes, mom, stand_in, jnp.float32) + 4
            else:
                cache = jax.eval_shape(lambda: jax_init_cache(
                    jcfg, B, Sq, dtype=jnp.bfloat16))
                want["cache"] = reference_bytes(
                    cache, R.cache_specs(jcfg, stand_in, B, Sq), stand_in)
            ins = ref_dryrun.input_specs(jcfg, shape)
            ispecs = R.input_specs_for(jcfg, stand_in, B, kind)
            want["inputs"] = sum(reference_bytes(ins[k], ispecs[k], stand_in)
                                 for k in ins)
            assert {k: v for k, v in got["bytes"].items()
                    if k != "activations"} == want, (shape, mesh)
            assert got["bytes"]["activations"] > 0
            assert got["total_bytes"] == sum(got["bytes"].values())


def test_one_card_share_and_max_layers():
    """One card's batch is a data shard's share; ``max_layers`` is the
    deepest multiple of the pattern period that fits."""
    assert [dryrun.one_card_batch(s) for s in SHAPES] == [16, 2, 8, 1]
    assert [dryrun.one_card_batch(s, multi_pod=True)
            for s in SHAPES] == [8, 1, 4, 1]
    cfg = get_config("jamba-v0.1-52b")
    L = dryrun.max_layers(cfg, "long_500k", 1, memory=80e9)
    assert L % cfg.pattern_period == 0 and 0 < L < cfg.num_layers

    def fits(n):
        return dryrun.fit(dataclasses.replace(cfg, num_layers=n),
                          "long_500k", one_card(), 1,
                          memory=80e9)["fits"]
    assert fits(L) and not fits(L + cfg.pattern_period)
    assert dryrun.max_layers(cfg, "long_500k", 1, memory=1e9) == 0
    small = get_config("mamba2-780m")
    assert dryrun.max_layers(small, "decode_32k", 8) == small.num_layers


def test_dryrun_cli_one_card(tmp_path, capsys):
    """``--all --mesh one`` prints one line a ``cells()`` entry and exits 1
    where a cell does not fit 80 GB; ``--skip-done`` skips recorded
    cells."""
    out = tmp_path / "d.jsonl"
    rc = dryrun.main(["--all", "--mesh", "one", "--out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("OK", "FAIL"))]
    assert len(lines) == len(cells()) == len(out.read_text().splitlines())
    assert rc == (1 if any(ln.startswith("FAIL") for ln in lines) else 0)
    assert any(ln.startswith("OK   qwen3-4b × decode_32k") for ln in lines)
    dryrun.main(["--all", "--mesh", "one", "--out", str(out),
                 "--skip-done"])
    assert len(out.read_text().splitlines()) == len(cells())


def test_roofline_matches_reference():
    sys.path.insert(0, ROOT)
    try:
        ref = importlib.import_module("benchmarks.roofline")
    finally:
        sys.path.remove(ROOT)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989.4e12, 3.35e12)
    for arch, shape in cells():
        cfg, jcfg = get_config(arch), jax_config(arch)
        sh = SHAPES[shape]
        for args in ((2, 7, None), (3, 5, 33)):
            assert roofline.flops_fwd(cfg, *args) == ref.flops_fwd(jcfg,
                                                                   *args)
        for comp in (True, False):
            assert roofline.flops_step(cfg, shape, comp) == \
                ref.flops_step(jcfg, shape, comp)
        assert roofline.model_flops(cfg, shape) == ref.model_flops(jcfg,
                                                                   shape)
        for devices, mp, dp in ((256, 16, None), (512, 16, 32), (1, 1, 1)):
            assert roofline.bytes_step(cfg, shape, devices, mp, dp) == \
                ref.bytes_step(jcfg, shape, devices, mp, dp)
        assert roofline._cache_bytes(cfg, 3, sh["seq_len"], 16) == \
            ref._cache_bytes(jcfg, 3, sh["seq_len"], 16)
        # the batch= form is the formula at that batch
        B = sh["global_batch"]
        assert roofline.flops_step(cfg, shape, batch=B) == \
            ref.flops_step(jcfg, shape)
        assert roofline.bytes_step(cfg, shape, 1, 1, 1, batch=B) == \
            ref.bytes_step(jcfg, shape, 1, 1, 1)


PAIRS = [["fsdp=on"], ["fsdp=off"], ["remat=true", "act_shard=seq"],
         ["num_layers=2", "capacity_factor=1.5", "moe_groups=0"],
         ["block_q=256", "x=1e-3", "name=abc", "y=-4", "z=2.5e2"],
         ["a=b=c"], []]


@pytest.mark.parametrize("pairs", PAIRS)
def test_parse_overrides_matches_reference(pairs):
    ref = reference_module("repro.launch.perf")
    got, want = perf.parse_overrides(pairs), ref.parse_overrides(pairs)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v)
                                               for v in want.values()]


# ---------------------------------------------------------------------------
# perf.run_variant on the CPU
# ---------------------------------------------------------------------------

SMALL_SHAPES = {
    "train_4k": dict(seq_len=32, global_batch=64, kind="train"),
    "prefill_32k": dict(seq_len=48, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=40, global_batch=32, kind="decode"),
}


@pytest.fixture
def small(monkeypatch):
    """Reduced configs and shapes shrunk to CPU scale, as
    ``tests/test_dryrun_small.py`` shrinks the reference's."""
    monkeypatch.setattr(perf, "get_config", get_reduced)
    for k, v in SMALL_SHAPES.items():
        monkeypatch.setitem(SHAPES, k, v)


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-v0.1-52b",
                                  "minicpm3-4b", "musicgen-medium"])
@pytest.mark.parametrize("shape", list(SMALL_SHAPES))
def test_run_variant_on_cpu(small, arch, shape):
    """One cell a kind at a data shard's share (64/16 = 4, 32/16 = 2):
    its record, and the prefill's and first decode step's logits against
    the port's ``forward`` over the same tokens at 1e-4 (the tolerance at
    which the port's ``decode_step`` is held against the reference's)."""
    out = {}
    rec = perf.run_variant(arch, shape, {"fsdp": True}, steps=2,
                           device="cpu", cache_fill="prefill", outputs=out)
    cfg = get_reduced(arch)
    kind = SMALL_SHAPES[shape]["kind"]
    assert rec["fits"] and rec["batch"] == SMALL_SHAPES[shape][
        "global_batch"] // 16 and rec["reduced"] == {}
    assert rec["fsdp"]["asked"] is True and rec["peak_bytes"] is None
    assert len(rec["step_ms_all"]) == 2 and rec["step_ms"] > 0
    assert rec["launches_per_step"] == {"decode_attn": 0, "ssd": 0}
    assert rec["mfu"] > 0 and rec["memory_share"] > 0
    assert rec["dominant"] in ("compute", "memory")
    assert rec["model_flops"] == roofline.model_flops(cfg, shape,
                                                      batch=rec["batch"])
    if kind == "train":
        assert len(rec["losses"]) == 3 and np.isfinite(rec["losses"]).all()
        return
    if kind == "prefill":
        want = forward(cfg, out["params"], out["prompt"])
    else:
        full = torch.cat([out["prompt"], out["inputs"]], dim=1)
        want = forward(cfg, out["params"], full)[:, -1:]
    got = out["logits"][0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_run_variant_cuts_and_refusal(small):
    """A cut is the caller's and is listed; a cell that does not fit runs
    nothing and the CLI exits 1."""
    rec = perf.run_variant("qwen3-4b", "decode_32k", {"num_layers": 1},
                           batch=1, steps=1, device="cpu")
    assert rec["reduced"] == {"batch": [2, 1], "num_layers": [2, 1]}
    assert rec["num_layers"] == 1 and "step_ms" in rec
    assert perf.run_variant("qwen3-4b", "train_4k", {}, multi_pod=True,
                            steps=1, device="cpu")["batch"] == 2
    big = dict(SMALL_SHAPES["decode_32k"], seq_len=1 << 26)
    SHAPES["decode_32k"] = big
    rec = perf.run_variant("qwen3-4b", "decode_32k", {}, device="cpu")
    assert not rec["fits"] and "step_ms" not in rec
    assert rec["predicted_bytes"] > rec["memory_bytes"]
    assert perf.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                      "--device", "cpu"]) == 1


# ---------------------------------------------------------------------------
# dryrun --bsp on 8 gloo ranks
# ---------------------------------------------------------------------------

def test_bsp_cells_on_eight_gloo_ranks():
    """Every (app × backend) superstep once on 8 gloo ranks: each rank
    all-reduces one (replicas + 1,) buffer in its exchange, launches no
    kernel on the CPU, and the gathered result equals one superstep of the
    stacked run (PageRank within 1e-6 of its largest value, the others
    bitwise)."""
    recs = dryrun.run_bsp_cells(device="cpu", timeout=300)
    g = rmat(9, seed=2)
    cl = scaled_paper_cluster(2, 6, g.num_edges)
    rt = PartitionRuntime.create(g, assign=windgp(g, cl, t0=2).assign,
                                 cluster=cl, device="cpu")
    assert len(recs) == 4 * 3
    for rec in recs:
        assert rec["p"] == 8 and [r["rank"] for r in rec["ranks"]] == \
            list(range(8))
        want_bytes = 4 * (max(1, rt.num_replicas) + 1)
        for r in rec["ranks"]:
            assert r["exchange_all_reduce_calls"] == 1
            assert r["exchange_all_reduce_bytes"] == want_bytes
            assert r["bsr_spmv_launches"] == 0 and r["peak_bytes"] is None
            assert r["rank_tensor_bytes"] > 0
        opts = {"block_size": 32} if rec["backend"] == "pallas" else {}
        spec = build_app(rt, rec["app"], backend=rec["backend"], **opts)
        state, _ = spec.superstep(spec.state, spec.static)
        want = np.asarray(spec.finalize(rt, state))
        got = np.asarray(rec["result"])
        if rec["app"] == "pagerank":
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        else:
            np.testing.assert_array_equal(got, want)
