"""Elastic restore of the port (``CheckpointManager.restore(...,
shardings=)``) against the reference's, on the CPU.

The reference runs its own ``tests/test_elastic.py`` script in a
subprocess on 8 host devices, with ``jax.make_mesh`` given ``axis_types=
(AxisType.Auto,) * 2``: the script fails as written on jax 0.9 only
because ``jax.make_mesh`` there makes Explicit axes, on which the
forward's gather cannot take its out-sharding.  It saves glm4-9b's reduced
parameters under the ``(4, 2)`` specs, restores them onto a ``(2, 2)`` mesh
over 4 devices and prints ``ELASTIC_OK``; this test also keeps its
parameters, each restored leaf's shard shapes a device and both forwards.

The port saves the same parameters (carried across) and restores them on
4 gloo ranks with ``shardings=param_shardings(cfg, mesh)``.  Holds: each
leaf a ``DTensor`` whose ``gather_leaf`` is bitwise the saved leaf and
equal to its ``full_tensor()`` (which the port does not call on the card:
on a gloo mesh of CUDA tensors it crashes its process there); each
rank's local shard of the reference's shape on the device at the same
mesh position (a stacked ``blocks/...`` leaf without its leading
``n_super`` axis, which its spec never splits); the forward on the
gathered parameters within the reference test's ``rtol=2e-5,
atol=1e-5`` of the reference's restored forward; ``restore`` without
``shardings=`` bitwise as before.

This module imports no JAX, so the ranks that unpickle its functions do
not load it either.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import forward, init_params, meta_params, \
    reference_path
from repro_torch.ranks import spawn_ranks
from repro_torch.sharding import param_shardings
from repro_torch.train import CheckpointManager, gather_leaf

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "glm4-9b"
MESH = (2, 2)
SPAWN_TIMEOUT_S = 300

#: appended to the reference's script: what this test compares
DUMP = r"""
import json as _json
_pos = {d.id: i for i, d in enumerate(mesh_b.devices.flat)}
_save = {"inp": np.asarray(inp), "base": base, "out": out}
_shapes = {}
for _path, _leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    _k = "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in _path)
    _save["param/" + _k] = np.asarray(_leaf)
for _path, _leaf in jax.tree_util.tree_flatten_with_path(
        restored["params"])[0]:
    _k = "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in _path)
    _shards = sorted(_leaf.addressable_shards,
                     key=lambda s: _pos[s.device.id])
    _shapes[_k] = [list(s.data.shape) for s in _shards]
np.savez(os.path.join("%(dir)s", "reference.npz"), **_save)
with open(os.path.join("%(dir)s", "shards.json"), "w") as _f:
    _json.dump(_shapes, _f)
print("DUMP_OK")
"""


def reference_script(directory: str) -> str:
    """The reference's ``tests/test_elastic.py`` script, its two meshes made
    with Auto axes, and :data:`DUMP` after it."""
    spec = importlib.util.spec_from_file_location(
        "reference_test_elastic", ROOT / "tests" / "test_elastic.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    script = module.SCRIPT
    mesh_axes = '("data", "model")'
    assert script.count(mesh_axes) == 2, "the reference script changed"
    script = script.replace(
        mesh_axes, mesh_axes + ", axis_types=(AxisType.Auto,) * 2")
    script = script.replace(
        "import jax, jax.numpy as jnp, numpy as np",
        "import jax, jax.numpy as jnp, numpy as np\n"
        "from jax.sharding import AxisType")
    return (script + DUMP) % {"dir": directory}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    proc = subprocess.run(
        [sys.executable, "-c", reference_script(str(out / "ckpt"))],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "ELASTIC_OK" in proc.stdout and "DUMP_OK" in proc.stdout, \
        proc.stderr[-3000:]
    with np.load(out / "ckpt" / "reference.npz") as z:
        ref = dict(z)
    ref["shards"] = json.loads((out / "ckpt" / "shards.json").read_text())
    return ref


def nested(flat: dict, prefix: str) -> dict:
    """``{"a/b/c": v}`` under ``prefix`` as ``{"a": {"b": {"c": v}}}``."""
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *parts, last = key[len(prefix):].split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def saved(reference, tmp_path_factory):
    """The port's checkpoint of the reference's parameters, and them."""
    cfg = get_reduced(ARCH)
    params = params_from_numpy(cfg, nested(reference, "param/"), "cpu")
    directory = tmp_path_factory.mktemp("port_ckpt")
    CheckpointManager(str(directory), keep=2).save(1, {"params": params})
    return str(directory), params


def load_into(cfg, tensors: dict):
    """A CPU ``Decoder`` holding ``tensors`` (by parameter name)."""
    params = init_params(cfg, 0, "cpu")
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(tensors[name])
    return params


def placement_dims(placements) -> list:
    """Each mesh dim's split: the tensor dim it shards, or None."""
    from torch.distributed.tensor import Shard
    return [p.dim if isinstance(p, Shard) else None for p in placements]


def elastic_rank(arch: str, directory: str, inp) -> dict:
    """A ``spawn_ranks`` rank: restore onto the ``(2, 2)`` mesh; each leaf's
    placements, local shape and gathered tensor (rank 0 keeps the
    tensors), and rank 0's forward on the gathered parameters.  Then a
    plain tensor leaf split over both mesh dims on one tensor dim, in the
    mesh's order and in the other."""
    from torch.distributed.tensor import DTensor
    cfg = get_reduced(arch)
    mesh = make_mesh(MESH, ("data", "model")).device_mesh("cpu")
    mgr = CheckpointManager(directory)
    restored, step, _ = mgr.restore(
        {"params": meta_params(cfg)},
        shardings={"params": param_shardings(cfg, mesh)})
    rank = torch.distributed.get_rank()
    out = {"step": step, "local": {}, "placements": {}, "full": {}}
    for name, t in restored["params"].items():
        assert isinstance(t, DTensor), name
        out["local"][name] = tuple(t.to_local().shape)
        out["placements"][name] = placement_dims(t.placements)
        full = gather_leaf(t)
        out.setdefault("full_tensor_equal", []).append(
            bool(torch.equal(full, t.full_tensor())))
        if rank == 0:
            out["full"][name] = full
    if rank == 0:
        params = load_into(cfg, out["full"])
        out["forward"] = forward(cfg, params, torch.from_numpy(inp)).numpy()
    # a tensor leaf over both mesh dims on its dim 0
    w = torch.arange(48.).reshape(8, 6)
    tmp = os.path.join(directory, f"leaf{rank}")
    CheckpointManager(tmp).save(3, {"w": w})
    got, _, _ = CheckpointManager(tmp).restore(
        {"w": w}, shardings={"w": (mesh, (("data", "model"), None))})
    out["leaf"] = (got["w"].to_local(), placement_dims(got["w"].placements),
                   bool(torch.equal(gather_leaf(got["w"]), w)))
    try:
        CheckpointManager(tmp).restore(
            {"w": w}, shardings={"w": (mesh, (("model", "data"), None))})
        out["reversed_axes"] = None
    except ValueError as e:
        out["reversed_axes"] = str(e)
    return out


@pytest.fixture(scope="module")
def port(reference, saved):
    return spawn_ranks(elastic_rank, MESH[0] * MESH[1],
                       args=(ARCH, saved[0], reference["inp"]),
                       device="cpu", timeout=SPAWN_TIMEOUT_S)


def test_reference_script_passes_with_auto_axes(reference):
    assert reference["out"].shape == reference["base"].shape


def test_gather_leaf_is_full_tensor(port):
    assert all(all(r["full_tensor_equal"]) for r in port)


def test_gathered_leaves_bitwise_equal_saved(port, saved):
    _, params = saved
    names = [n for n, _ in params.named_parameters()]
    assert sorted(port[0]["full"]) == sorted(names)
    for name, p in params.named_parameters():
        got = port[0]["full"][name]
        assert got.dtype == p.dtype and torch.equal(got, p), name
    assert all(r["step"] == 1 for r in port)


def test_local_shards_have_reference_shapes(port, reference):
    cfg = get_reduced(ARCH)
    seen = set()
    for r, res in enumerate(port):
        for name, shape in res["local"].items():
            path, _ = reference_path(cfg, name)
            want = reference["shards"][path][r]
            if path.startswith("blocks/"):
                want = want[1:]
            assert list(shape) == want, (r, name)
            seen.add(path)
    assert seen == set(reference["shards"])


def test_some_leaves_are_split(port):
    """The (2, 2) specs split glm4-9b's projections over ``model``: a
    restore that replicated everything would pass the shape test only on
    the replicated leaves."""
    split = [n for n, pl in port[0]["placements"].items()
             if any(d is not None for d in pl)]
    assert split and len(split) < len(port[0]["placements"])


def test_forward_on_gathered_params_matches_reference(port, reference):
    np.testing.assert_allclose(port[0]["forward"], reference["out"],
                               rtol=2e-5, atol=1e-5)


def test_axes_of_one_dim_shard_in_mesh_order(port):
    """A dim split over ``("data", "model")`` is ``Shard(0)`` on both mesh
    dims, rank r holding rows ``2r, 2r + 1``; ``("model", "data")``, which
    the reference takes, raises (``DTensor`` splits in mesh-dim order)."""
    w = torch.arange(48.).reshape(8, 6)
    for r, res in enumerate(port):
        local, placements, whole = res["leaf"]
        assert torch.equal(local, w[2 * r:2 * r + 2])
        assert placements == [0, 0]
        assert whole
        assert res["reversed_axes"] is not None


def test_restore_without_shardings_is_unchanged(saved):
    directory, params = saved
    cfg = get_reduced(ARCH)
    fresh = init_params(cfg, 7, "cpu")
    restored, step, extra = CheckpointManager(directory).restore(
        {"params": fresh})
    assert restored["params"] is fresh and step == 1 and extra == {}
    for (n, a), (_, b) in zip(params.named_parameters(),
                              fresh.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
