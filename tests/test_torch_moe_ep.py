"""Expert-parallel MoE of the port (``models/moe_shardmap.py``) against the
reference's ``moe_ffn_ep``, on the CPU.

The reference runs once in a subprocess on 8 host devices, mesh ``(data,
model) = (2, 4)``, its output and ``jax.grad`` of ``sum(y²)`` from one
jitted ``value_and_grad`` under ``jax.set_mesh``: its own
test (``tests/test_moe_shardmap.py``) fails on jax 0.9 only because
``jax.make_mesh`` there makes Explicit axes and the gradient is taken
outside a mesh context; the function itself is sound.  The port runs once
on 8 gloo ranks of this host (``spawn_ranks``), the same parameters and
tokens carried across as numpy.  Cases: phi3.5-moe's reduced config (E 4,
K 2, d 128) at B, S = 4, 16 with capacity factor 8 (dropless) and 1.25,
and at B, S = 4, 256 with 0.5 (cap 64: entries drop).

Tolerances are the reference test's: outputs within 1e-5 of max |y|,
gradients (router, experts, x) at rtol = atol = 5e-4.  ``_dispatch_local``
(slots, tokens, keep-mask, buffers) and ``_combine_local`` are bitwise
against the reference's on given routings; the gate weights within 1e-6
(a float32 softmax each side).

This module imports JAX only inside the tests that call it in process, so
the ranks that unpickle its rank function do not load JAX.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.convert import _tensor
from repro_torch.models import moe_shardmap as TM
from repro_torch.ranks import spawn_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "phi3.5-moe-42b-a6.6b"
MESH = (2, 4)
#: name -> (B, S, capacity factor)
CASES = {"dropless": (4, 16, 8.0), "published": (4, 16, 1.25),
         "drops": (4, 256, 0.5)}
LEAVES = ("router", "w_gate", "w_up", "w_down")
SPAWN_TIMEOUT_S = 300

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_reduced
from repro.models import layers as L
from repro.models.moe_shardmap import moe_ffn_ep

out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
cfg = get_reduced("%(arch)s")
ffn = L.init_moe(cfg, jax.random.PRNGKey(0))
mesh = jax.make_mesh(%(mesh)s, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
save = {k: np.asarray(v) for k, v in ffn.items()}
for name, (B, S, cf) in cases.items():
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    def loss(f, xx):
        y = moe_ffn_ep(cfg, f, xx, mesh, cf)
        return jnp.sum(y ** 2), y
    with jax.set_mesh(mesh):
        (_, y), (g, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(ffn, jnp.asarray(x))
    save[name + "/x"] = x
    save[name + "/y"] = np.asarray(y)
    save[name + "/grad/x"] = np.asarray(gx)
    for k, v in g.items():
        save[name + "/grad/" + k] = np.asarray(v)
np.savez(os.path.join(out_dir, "ep.npz"), **save)
print("REFERENCE_EP_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's EP outputs and gradients, one subprocess."""
    out = tmp_path_factory.mktemp("ep")
    script = REFERENCE % {"arch": ARCH, "mesh": MESH}
    proc = subprocess.run(
        [sys.executable, "-c", script, str(out), json.dumps(CASES)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "REFERENCE_EP_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(out / "ep.npz") as z:
        return dict(z)


def ep_rank(arch: str, params: dict, cases: dict) -> dict:
    """A ``spawn_ranks`` rank: for each case, this rank's outputs and
    gradients of ``sum(y²)``, its mesh coordinates and the entries its
    dispatch dropped; then the ``ValueError`` of each indivisible shape."""
    from repro_torch.launch.mesh import make_mesh
    cfg = get_reduced(arch)
    mesh = make_mesh(MESH, ("data", "model")).device_mesh("cpu")
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    out = {"data": mesh.get_local_rank("data"),
           "model": mesh.get_local_rank("model")}
    for name, (x, cf) in cases.items():
        p = {k: v.detach().clone().requires_grad_()
             for k, v in TM.expert_shard(full, mesh).items()}
        xs = TM.token_shard(torch.from_numpy(x), mesh).clone() \
            .requires_grad_()
        y = TM.moe_ffn_ep(cfg, p, xs, mesh, cf)
        (y ** 2).sum().backward()
        n = xs.shape[0] * xs.shape[1]
        cap = TM.ep_capacity(cfg, n, cf)
        _, (_, _, _, keep) = TM._dispatch_local(
            cfg, p["router"].detach(), xs.detach().reshape(n, -1),
            MESH[1], cap)
        out[name] = {"y": TM.gather_tokens(y.detach(), mesh).numpy(),
                     "grad": {k: v.grad.numpy() for k, v in p.items()},
                     "grad_x": xs.grad.numpy(), "cap": cap,
                     "dropped": int((~keep).sum())}
    x = torch.from_numpy(cases["dropless"][0])
    errors = {}
    for what, call in (
            ("experts", lambda: TM.moe_ffn_ep(
                dataclasses.replace(cfg, num_experts=6), TM.expert_shard(
                    full, mesh), TM.token_shard(x, mesh), mesh)),
            ("expert_shard", lambda: TM.expert_shard(
                {k: v[:3] if k != "router" else v
                 for k, v in full.items()}, mesh)),
            ("batch", lambda: TM.token_shard(x[:3], mesh)),
            ("sequence", lambda: TM.token_shard(x[:, :6], mesh))):
        try:
            call()
            errors[what] = None
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def port(reference):
    params = {k: reference[k] for k in LEAVES}
    cases = {name: (reference[name + "/x"], cf)
             for name, (_, _, cf) in CASES.items()}
    return spawn_ranks(ep_rank, MESH[0] * MESH[1],
                       args=(ARCH, params, cases), device="cpu",
                       timeout=SPAWN_TIMEOUT_S)


def assembled(port, name: str) -> dict:
    """The port's global gradients from the ranks' pieces: the router from
    rank 0, each expert block from the ranks of data row 0, x's blocks
    from every rank."""
    B, S, _ = CASES[name]
    dp, tp = MESH
    grads = {"router": port[0][name]["grad"]["router"]}
    for k in LEAVES[1:]:
        grads[k] = np.concatenate([port[j][name]["grad"][k]
                                   for j in range(tp)])
    rows = [np.concatenate([port[i * tp + j][name]["grad_x"]
                            for j in range(tp)], axis=1) for i in range(dp)]
    grads["x"] = np.concatenate(rows, axis=0)
    return grads


@pytest.mark.parametrize("name", list(CASES))
def test_ep_output_matches_reference(reference, port, name):
    want = reference[name + "/y"]
    for r in port:
        got = r[name]["y"]
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err / float(np.abs(want).max()) < 1e-5, (r["data"],
                                                          r["model"], err)


@pytest.mark.parametrize("name", list(CASES))
def test_ep_gradients_match_reference(reference, port, name):
    got = assembled(port, name)
    for k, v in got.items():
        np.testing.assert_allclose(v, reference[f"{name}/grad/{k}"],
                                   rtol=5e-4, atol=5e-4, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_ep_gradient_sums_agree_across_replicas(port, name):
    """The router's gradient is summed over every rank, the experts' over
    ``data``: every rank holds the same router gradient, and the two data
    rows the same expert gradients."""
    dp, tp = MESH
    for r in port:
        assert np.array_equal(r[name]["grad"]["router"],
                              port[0][name]["grad"]["router"])
    for j in range(tp):
        for k in LEAVES[1:]:
            assert np.array_equal(port[j][name]["grad"][k],
                                  port[tp + j][name]["grad"][k]), (j, k)


def jax_modules():
    """The reference's moe_shardmap, jax.numpy and ml_dtypes, imported
    here only."""
    import jax.numpy as jnp
    import ml_dtypes
    from repro.models import moe_shardmap as JM
    return JM, jnp, ml_dtypes


def test_drop_case_drops_as_the_reference(port, reference):
    """At B, S = 4, 256 and capacity factor 0.5 each rank's 128 tokens get
    cap 64 an expert, and entries drop: as many, shard by shard, as the
    reference's ``_dispatch_local`` drops."""
    JM, jnp, _ = jax_modules()
    cfg = get_reduced(ARCH)
    B, S, cf = CASES["drops"]
    dp, tp = MESH
    b, s = B // dp, S // tp
    x = reference["drops/x"]
    total = 0
    for r in port:
        i, j = r["data"], r["model"]
        xs = x[i * b:(i + 1) * b, j * s:(j + 1) * s].reshape(b * s, -1)
        _, (_, _, _, keep) = JM._dispatch_local(
            cfg, jnp.asarray(reference["router"]), jnp.asarray(xs), tp, 64)
        assert r["drops"]["cap"] == 64
        assert r["drops"]["dropped"] == int((~np.asarray(keep)).sum())
        total += r["drops"]["dropped"]
    assert total > 0
    assert all(r[name]["dropped"] == 0 for r in port
               for name in ("dropless", "published"))


def test_indivisible_shapes_raise(port):
    for r in port:
        for what, msg in r["errors"].items():
            assert msg is not None, f"{what} did not raise ValueError"


# ---------------------------------------------------------------------------
# _dispatch_local / _combine_local on given routings, in one process
# ---------------------------------------------------------------------------

#: (n tokens, E, K, tp, cap, dtype)
ROUTINGS = [(128, 4, 2, 4, 64, "float32"), (128, 4, 2, 4, 20, "float32"),
            (37, 16, 2, 4, 5, "float32"), (64, 40, 8, 4, 9, "float32"),
            (50, 8, 2, 2, 64, "bfloat16")]


def routing(n, E, K, tp, cap, dtype, seed=0):
    _, _, ml_dtypes = jax_modules()
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(get_reduced(ARCH), num_experts=E,
                              experts_per_token=K)
    d = cfg.d_model
    router = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    xf = rng.standard_normal((n, d)).astype(dt)
    return cfg, router, xf


def t(a):
    return _tensor(np.asarray(a), torch.device("cpu"))


@pytest.mark.parametrize("case", ROUTINGS, ids=str)
def test_dispatch_local_bitwise(case):
    JM, jnp, _ = jax_modules()
    n, E, K, tp, cap, dtype = case
    cfg, router, xf = routing(*case)
    want_buf, want = JM._dispatch_local(cfg, jnp.asarray(router),
                                        jnp.asarray(xf), tp, cap)
    got_buf, got = TM._dispatch_local(cfg, t(router), t(xf), tp, cap)
    for k, a, b in zip(("slot", "stok", "keep"), (want[0], want[1], want[3]),
                       (got[0], got[1], got[3])):
        assert np.array_equal(np.asarray(a), b.numpy()), k
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-6)
    assert got_buf.shape == want_buf.shape
    assert np.array_equal(np.asarray(want_buf).astype(np.float32),
                          got_buf.float().numpy())


@pytest.mark.parametrize("case", ROUTINGS, ids=str)
def test_combine_local_bitwise(case):
    """The port's combine on the reference's own bookkeeping and returned
    buffers gives the reference's serial scatter-add bit for bit."""
    JM, jnp, _ = jax_modules()
    n, E, K, tp, cap, dtype = case
    cfg, router, xf = routing(*case)
    _, book = JM._dispatch_local(cfg, jnp.asarray(router), jnp.asarray(xf),
                                 tp, cap)
    d = xf.shape[1]
    back = np.random.default_rng(2).standard_normal(
        (tp, E // tp, cap, d)).astype(xf.dtype)
    want = np.asarray(JM._combine_local(n, d, jnp.asarray(back), book))
    got = TM._combine_local(n, d, t(back), tuple(t(a) for a in book))
    assert np.array_equal(want.astype(np.float32), got.float().numpy())
