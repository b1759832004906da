"""Training slice of the port against the JAX package, on the CPU.

The host modules (``data/lm_data.py``, ``train/hetero_batch.py``), the int8
compression and the checkpoint layout are held bitwise.  AdamW within 1e-6
on a small tree.  One ``make_train_step`` on reduced configs, weights
carried across by ``params_from_numpy``: the loss within 1e-5 relative,
the gradient norm within 1e-4 relative, each gradient leaf within 1e-4
relative L2.  The updated parameters are compared where the gradient that
AdamW reads is not vanishingly small (see ``test_train_step_matches_jax``).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data.lm_data import LMDataState as JaxDataState
from repro.data.lm_data import SyntheticLM as JaxSyntheticLM
from repro.models import init_params as jax_init_params
from repro.train import CheckpointManager as JaxCheckpointManager
from repro.train import adamw_init as jax_adamw_init
from repro.train import adamw_update as jax_adamw_update
from repro.train import compress_grads as jax_compress_grads
from repro.train import heterogeneous_batch_split as jax_split
from repro.train import make_loss_fn as jax_make_loss_fn
from repro.train import make_train_step as jax_make_train_step
from repro.train import quantize_int8 as jax_quantize_int8

from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.data.lm_data import LMDataState, SyntheticLM
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ssd_chunked_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, reference_path)
from repro_torch.serve import generate
from repro_torch.train import (CheckpointManager, adamw_init, adamw_update,
                               compress_grads, dequantize_int8,
                               heterogeneous_batch_split, loss_and_grads,
                               make_train_step, named_parameters,
                               quantize_int8)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def flat_tree(tree, prefix=""):
    """{"/"-joined path: leaf} of a nested dict, keys sorted (jax's order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_tree(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def stacked(cfg, named: dict) -> dict:
    """The port's per-layer tensors as the reference's leaves: each
    reference path's tensors stacked on ``n_super`` (numpy, float32)."""
    groups: dict = {}
    for name, v in named.items():
        path, i = reference_path(cfg, name)
        groups.setdefault(path, []).append((i, v))
    out = {}
    for path, items in groups.items():
        vals = [v.detach().float().numpy() for _, v in sorted(items)]
        out[path] = np.stack(vals) if path.startswith("blocks/") else vals[0]
    return out


def batch_for(cfg, rng, B, S):
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


# ---------------------------------------------------------------------------
# host modules, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed,cursor", [(512, 0, 0), (50, 3, 7),
                                               (1000, 11, 123)])
def test_lm_data_bitwise(vocab, seed, cursor):
    ref, port = JaxSyntheticLM(vocab, seed=seed), SyntheticLM(vocab, seed=seed)
    np.testing.assert_array_equal(ref.succ, port.succ)
    np.testing.assert_array_equal(ref.marginal, port.marginal)
    rs, ps = JaxDataState(seed, cursor), LMDataState(seed, cursor)
    for B, S in ((4, 16), (3, 33), (1, 1)):
        rb, rs = ref.batch(rs, B, S)
        pb, ps = port.batch(ps, B, S)
        assert (ps.seed, ps.cursor) == (rs.seed, rs.cursor)
        for k in ("inputs", "labels"):
            assert pb[k].dtype == rb[k].dtype
            np.testing.assert_array_equal(pb[k], rb[k])


def test_compression_bitwise():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    # values at half-quanta: round half to even on both sides
    scale = np.float32(np.abs(x).max()) / np.float32(127.0)
    x[:8] = (np.arange(8, dtype=np.float32) + np.float32(0.5)) * scale
    qj, sj = jax_quantize_int8(x)
    qt, st = quantize_int8(t(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.item() == float(sj)
    np.testing.assert_array_equal(dequantize_int8(qt, st).numpy(),
                                  np.asarray(qj, np.float32) * np.asarray(sj))
    tree = {"big": rng.standard_normal((40, 40)).astype(np.float32),
            "exact": rng.standard_normal(1024).astype(np.float32),
            "inner": {"b": rng.standard_normal((2, 600)).astype(np.float32)}}
    want = jax_compress_grads(jax.tree.map(jnp.asarray, tree))
    got = compress_grads(jax.tree.map(t, tree))
    for k, v in flat_tree(want).items():
        np.testing.assert_array_equal(flat_tree(got)[k].numpy(),
                                      np.asarray(v))
    np.testing.assert_array_equal(got["exact"].numpy(), tree["exact"])
    # a bf16 gradient keeps its dtype
    bf = torch.randn(2048, dtype=torch.bfloat16)
    assert compress_grads(bf).dtype == torch.bfloat16


@pytest.mark.parametrize("B,cost,mem", [
    (256, [1.0, 1.0, 0.5], None), (256, [1.0, 0.25], [256, 64]),
    (1000, [0.55, 1.0, 1.0, 0.8], [400, 300, 300, 300]), (7, [1.0, 3.0], None)])
def test_heterogeneous_batch_split_bitwise(B, cost, mem):
    want = jax_split(B, cost, pod_mem_samples=mem)
    got = heterogeneous_batch_split(B, cost, pod_mem_samples=mem)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_heterogeneous_batch_split_infeasible_raises():
    with pytest.raises(ValueError):
        heterogeneous_batch_split(256, [1.0, 1.0], pod_mem_samples=[16, 16])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def small_state(rng):
    import ml_dtypes
    bf = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    return {"params": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                       "b": bf, "inner": {"z": np.arange(5, dtype=np.int32)}},
            "opt": {"step": np.array(7, np.int32),
                    "m": {"w": np.zeros((4, 6), np.float32)}}}


def to_port(tree):
    """numpy (ml_dtypes bf16 included) -> tensors, bf16 by bit pattern."""
    def leaf(a):
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, tree)


def test_checkpoint_layout_bitwise(tmp_path):
    state = small_state(np.random.default_rng(1))
    extra = {"data_seed": 3, "data_cursor": 9}
    ref, port = tmp_path / "ref", tmp_path / "port"
    JaxCheckpointManager(str(ref), keep=2).save(
        12, jax.tree.map(jnp.asarray, state), extra=extra)
    CheckpointManager(str(port), keep=2).save(12, to_port(state), extra=extra)
    assert sorted(os.listdir(ref)) == sorted(os.listdir(port)) \
        == ["step_0000000012"]
    for d in ("step_0000000012",):
        assert sorted(os.listdir(ref / d)) == sorted(os.listdir(port / d)) \
            == ["arrays.npz", "manifest.json"]
        assert json.loads((ref / d / "manifest.json").read_text()) == \
            json.loads((port / d / "manifest.json").read_text())
        with np.load(ref / d / "arrays.npz") as a, \
                np.load(port / d / "arrays.npz") as b:
            assert list(a.keys()) == list(b.keys())
            for k in a.keys():
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), k
    # the port reads the reference's checkpoint, bf16 leaves included
    tmpl = to_port(state)
    got, step, got_extra = CheckpointManager(str(ref)).restore(tmpl)
    assert step == 12 and got_extra == extra
    for (k, a), (_, b) in zip(flat_tree(tmpl).items(),
                              flat_tree(got).items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_checkpoint_restores_module_and_keeps_last_k(tmp_path):
    cfg = get_reduced("glm4-9b")
    params = init_params(cfg, 0, "cpu").requires_grad_()
    opt = adamw_init(params)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"params": params, "opt": opt}, extra={"s": s})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    fresh = init_params(cfg, 1, "cpu").requires_grad_()
    restored, step, extra = mgr.restore({"params": fresh,
                                         "opt": adamw_init(fresh)}, step=2)
    assert step == 2 and extra == {"s": 2} and restored["params"] is fresh
    for (n, a), (_, b) in zip(params.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n
        assert b.requires_grad
    keys = json.loads((tmp_path / "step_0000000002" / "manifest.json")
                      .read_text())["keys"]
    assert "params/layers.0.mixer.wq" in keys and "opt/step" in keys
    assert not [e for e in os.listdir(tmp_path) if e.startswith(".tmp")]


def test_checkpoint_bf16_roundtrip(tmp_path):
    cfg = dataclasses.replace(get_reduced("qwen3-4b"), dtype="bfloat16")
    params = init_params(cfg, 0, "cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params})
    with np.load(tmp_path / "step_0000000001" / "arrays.npz") as a:
        assert a["params/embed"].dtype == np.dtype("V2")
    fresh = init_params(cfg, 5, "cpu")
    mgr.restore({"params": fresh})
    for (n, a), (_, b) in zip(params.named_parameters(),
                              fresh.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_clip,weight_decay", [(1.0, 0.01), (0.0, 0.0),
                                                    (100.0, 0.1)])
def test_adamw_matches_jax(grad_clip, weight_decay):
    import ml_dtypes
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 7), "b": (11,), "c/d": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    params["e"] = rng.standard_normal((6, 3)).astype(ml_dtypes.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: v for k, v in to_port(params).items()}
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 0.3).astype(v.dtype)
                 for k, v in params.items()}
        jp, jo, jn = jax_adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jo, jp, lr=1e-2,
            weight_decay=weight_decay, grad_clip=grad_clip)
        tp, to, tn = adamw_update(to_port(grads), to, tp, lr=1e-2,
                                  weight_decay=weight_decay,
                                  grad_clip=grad_clip)
        assert int(to["step"]) == int(jo["step"]) == step + 1
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in params:
            for got, want in ((tp[k], jp[k]), (to["m"][k], jo["m"][k]),
                              (to["v"][k], jo["v"][k])):
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------

STEP_CASES = [  # (arch, microbatches, remat, compress)
    ("qwen3-4b", 1, False, None), ("qwen3-4b", 2, True, "int8"),
    ("mamba2-780m", 1, True, None), ("mamba2-780m", 2, False, "int8"),
    ("granite-moe-3b-a800m", 1, False, "int8"),
    ("granite-moe-3b-a800m", 2, True, None),
    ("musicgen-medium", 1, True, None), ("musicgen-medium", 2, False, "int8")]


def jax_grads(cfg, params, batch, k, remat):
    """The reference train step's (loss, grads): ``value_and_grad`` of its
    loss, accumulated over k microbatches as its ``scan`` does."""
    vg = jax.value_and_grad(jax_make_loss_fn(cfg, remat=remat))
    if k == 1:
        return vg(params, batch["inputs"], batch["labels"])
    B = batch["inputs"].shape[0]
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    loss = 0.0
    for i in range(k):
        sl = slice(i * B // k, (i + 1) * B // k)
        l, g = vg(params, batch["inputs"][sl], batch["labels"][sl])
        acc = jax.tree.map(jnp.add, acc, jax.tree.map(lambda x: x / k, g))
        loss = loss + l / k
    return loss, acc


@pytest.mark.parametrize("arch,k,remat,compress", STEP_CASES)
def test_train_step_matches_jax(arch, k, remat, compress):
    """One step of each package from the same weights and batch.

    The gradient norm is held within 1e-4 on the gradients themselves,
    and as the step's metric too where nothing compresses them; with int8
    the metric is the norm after quantization, held within the norm of the
    two sides' quantized difference (a value within rounding noise of a
    half-quantum rounds to neighbouring levels; at most 1e-3 of them may).

    The updated parameters: AdamW's first step moves each element by
    ``lr·g/(|g| + eps)`` (≈ ``lr·sign(g)``) plus the decay, so an element
    whose gradient is near zero can move either way on rounding noise.
    They are compared (1e-6) where the gradient AdamW reads, the
    reference's after compression, is at least 1e-2 of its leaf's largest;
    elsewhere they agree within the step's size, 2·lr."""
    cfg = jax_reduced(arch)
    lr, wd = 3e-4, 0.01
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    ported = params_from_numpy(get_reduced(arch),
                               jax.tree.map(np.asarray, params),
                               "cpu").requires_grad_()
    batch = batch_for(cfg, np.random.default_rng(3), 4, 24)
    jbatch = {kk: jnp.asarray(v) for kk, v in batch.items()}

    want_loss, want_g = jax_grads(cfg, params, jbatch, k, remat)
    loss, grads = loss_and_grads(cfg, ported, jax.tree.map(t, batch),
                                 microbatches=k, remat=remat)
    assert list(grads) == list(named_parameters(cfg, ported))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_g = flat_tree(want_g)
    got_g = stacked(cfg, grads)
    assert sorted(got_g) == list(want_g)
    for path, g in want_g.items():
        assert rel_l2(got_g[path], g) <= 1e-4, path

    step = jax.jit(jax_make_train_step(cfg, lr=lr, weight_decay=wd,
                                       microbatches=k, remat=remat,
                                       compress=compress))
    new_p, new_o, metrics = step(params, jax_adamw_init(params), jbatch)
    tstep = make_train_step(cfg, lr=lr, weight_decay=wd, microbatches=k,
                            remat=remat, compress=compress)
    opt = adamw_init(ported)
    got_p, got_o, got_m = tstep(ported, opt, jax.tree.map(t, batch))
    assert got_p is ported and int(got_o["step"]) == 1
    np.testing.assert_allclose(float(got_m["loss"]),
                               float(metrics["loss"]), rtol=1e-5)
    norm = lambda tree: np.sqrt(sum(np.sum(np.square(np.asarray(
        v, np.float64))) for v in tree.values()))
    np.testing.assert_allclose(norm(got_g), norm(want_g), rtol=1e-4)
    used = want_g
    if compress:
        # int8 rounds both sides' gradients to q·scale: they differ where
        # a value lies within the rounding noise of a half-quantum, by one
        # quantum (elsewhere they differ by the scale's rounding), so the
        # metric's norm moves by at most that difference
        used = flat_tree(jax_compress_grads(want_g))
        port_q = stacked(cfg, compress_grads(
            grads, leaf_of=lambda n: reference_path(cfg, n)[0]))
        moved = sum(np.sum(np.square(port_q[k].astype(np.float64)
                                     - np.asarray(v, np.float64)))
                    for k, v in used.items())
        flips = sum(int(np.sum(np.abs(port_q[k] - np.asarray(v))
                               > np.abs(np.asarray(v)).max() / 254))
                    for k, v in used.items())
        assert flips <= 1e-3 * sum(v.size for v in used.values())
        assert abs(float(got_m["grad_norm"]) - float(metrics["grad_norm"])) \
            <= np.sqrt(moved) + 1e-4 * float(metrics["grad_norm"])
    else:
        np.testing.assert_allclose(float(got_m["grad_norm"]),
                                   float(metrics["grad_norm"]), rtol=1e-4)
    got_new = stacked(cfg, dict(ported.named_parameters()))
    for path, p in flat_tree(new_p).items():
        g, got, want = np.abs(np.asarray(used[path])), got_new[path], \
            np.asarray(p, np.float32)
        sure = g >= 1e-2 * g.max()
        assert sure.any(), path
        np.testing.assert_allclose(got[sure], want[sure], rtol=1e-6,
                                   atol=1e-6, err_msg=path)
        assert np.abs(got - want).max() <= 2 * lr * (1 + wd), path


BF16_CASES = [  # (arch, microbatches, remat)
    ("qwen3-4b", 1, False), ("mamba2-780m", 2, True),
    ("granite-moe-3b-a800m", 1, True), ("musicgen-medium", 2, False)]


def bf16_ulp(x):
    """The spacing of bfloat16 values at |x| (float32 array)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


@pytest.mark.parametrize("arch,k,remat", BF16_CASES)
def test_train_step_matches_jax_in_bf16(arch, k, remat):
    """One bfloat16 step of each package from the same weights and batch.

    bfloat16 rounds in other places on the two sides, so the gradients are
    held against a float32 truth (the reference's float32 gradients of the
    same weights): the whole gradient's relative L2 from it at most 1.5
    times the reference's own bfloat16 gradient's, and each leaf's at most
    3 times plus 1e-3 (on four batches of these configs the ratio read
    0.63-1.23 whole and 0.66-2.15 for a leaf, both sides' errors 3-16 %
    a leaf; a leaf with no gradient reads 1).  The loss within 1e-3
    relative of the reference's bfloat16 loss, the gradient norm within
    2e-2 of the truth's.  AdamW's first step moves an element by
    ``lr·sign(g)`` rounded to the leaf's dtype, so where the reference's
    gradient is at least 1e-2 of its leaf's largest and the two agree in
    sign, the updated bfloat16 parameters are equal (at most 1e-3 of them
    a neighbour) and the float32 ones (the SSM's ``a_log``, ``dt_bias``,
    ``d_skip``, the router) within 1e-3·lr, since ``eps/|g|`` is left in
    their step; elsewhere the two are within 2·lr plus one bfloat16
    spacing."""
    cfg = dataclasses.replace(jax_reduced(arch), dtype="bfloat16")
    pcfg = dataclasses.replace(get_reduced(arch), dtype="bfloat16")
    lr, wd = 1e-3, 0.01
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    truth_params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    ported = params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                               "cpu").requires_grad_()
    before = stacked(pcfg, dict(ported.named_parameters()))
    batch = batch_for(cfg, np.random.default_rng(7), 4, 24)
    jbatch = {kk: jnp.asarray(v) for kk, v in batch.items()}

    _, truth = jax_grads(jax_reduced(arch), truth_params, jbatch, k, remat)
    want_loss, want_g = jax_grads(cfg, params, jbatch, k, remat)
    loss, grads = loss_and_grads(pcfg, ported, jax.tree.map(t, batch),
                                 microbatches=k, remat=remat)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-3)
    truth, want_g = flat_tree(truth), flat_tree(want_g)
    got_g = stacked(pcfg, grads)
    for path, g in truth.items():
        g = np.asarray(g)
        own = rel_l2(np.asarray(want_g[path], np.float32), g)
        assert rel_l2(got_g[path], g) <= 3 * own + 1e-3, (path, own)
    whole = lambda d: np.concatenate([np.asarray(d[p], np.float32).ravel()
                                      for p in truth])
    assert rel_l2(whole(got_g), whole(truth)) \
        <= 1.5 * rel_l2(whole(want_g), whole(truth))

    tstep = make_train_step(pcfg, lr=lr, weight_decay=wd, microbatches=k,
                            remat=remat)
    got_p, _, got_m = tstep(ported, adamw_init(ported),
                            jax.tree.map(t, batch))
    new_p, _, metrics = jax.jit(jax_make_train_step(
        cfg, lr=lr, weight_decay=wd, microbatches=k, remat=remat))(
        params, jax_adamw_init(params), jbatch)
    norm = np.sqrt(sum(np.sum(np.square(np.asarray(v, np.float64)))
                       for v in truth.values()))
    np.testing.assert_allclose(float(got_m["grad_norm"]), norm, rtol=2e-2)
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=2e-2)
    got_new = stacked(pcfg, dict(got_p.named_parameters()))
    moved = 0
    for path, p in flat_tree(new_p).items():
        want = np.asarray(p, np.float32)
        got, g = got_new[path], np.asarray(want_g[path], np.float32)
        sure = (np.abs(g) >= 1e-2 * np.abs(g).max()) \
            & (np.sign(g) == np.sign(got_g[path]))
        assert sure.any(), path
        if p.dtype == jnp.bfloat16:
            off = got[sure] != want[sure]
            assert off.mean() <= 1e-3, (path, off.mean())
            assert (np.abs(got - want)[sure]
                    <= bf16_ulp(want[sure])).all(), path
        else:       # a float32 leaf keeps eps/|g| of the step: 1e-3·lr
            assert (np.abs(got - want)[sure] <= 1e-3 * lr).all(), path
        assert (np.abs(got - want) <= 2 * lr * (1 + wd)
                + bf16_ulp(want)).all(), path
        moved += int(np.sum(got != before[path]))
    assert moved > 0


def test_remat_and_microbatches_are_the_port_s_own_identities():
    """remat changes nothing but the saved set (bitwise on the CPU), and
    two microbatches give one batch's loss and gradients within float32
    noise."""
    cfg = get_reduced("jamba-v0.1-52b")
    params = init_params(cfg, 0, "cpu").requires_grad_()
    batch = jax.tree.map(t, batch_for(cfg, np.random.default_rng(4), 4, 16))
    l0, g0 = loss_and_grads(cfg, params, batch, remat=False)
    l1, g1 = loss_and_grads(cfg, params, batch, remat=True)
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    l2, g2 = loss_and_grads(cfg, params, batch, microbatches=2, remat=True)
    np.testing.assert_allclose(float(l2), float(l0), rtol=1e-5)
    for n in g0:
        assert rel_l2(g2[n], g0[n]) <= 1e-4, n
        assert g0[n].abs().sum() > 0, n      # every parameter gets a gradient


def test_train_step_needs_trainable_params():
    cfg = get_reduced("qwen3-4b")
    params = init_params(cfg, 0, "cpu")
    batch = jax.tree.map(t, batch_for(cfg, np.random.default_rng(5), 2, 8))
    with pytest.raises(ValueError, match="trainable"):
        make_train_step(cfg)(params, adamw_init(params), batch)
    with pytest.raises(ValueError, match="compress"):
        make_train_step(cfg, compress="fp8")


def test_serving_stays_gradient_free():
    cfg = get_reduced("mamba2-780m")
    params = init_params(cfg, 0, "cpu").requires_grad_()
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    assert forward(cfg, params, toks).grad_fn is not None
    cache = init_cache(cfg, 2, 12, device="cpu")
    logits, _ = decode_step(cfg, params, cache, toks,
                            torch.zeros(2, dtype=torch.int32))
    assert logits.grad_fn is None
    assert generate(cfg, params, toks, 2, device="cpu").shape == (2, 2)


def test_kill_and_resume_training(tmp_path):
    """Train 4 steps; 'crash'; resume from step 2; the states match a
    continuous 4-step run bitwise (the reference's test, on the port)."""
    cfg = get_reduced("qwen3-4b")
    step = make_train_step(cfg, lr=1e-3, remat=False)
    rng = np.random.default_rng(6)
    batches = [jax.tree.map(t, batch_for(cfg, rng, 4, 16)) for _ in range(4)]
    mgr = CheckpointManager(str(tmp_path), keep=3)
    p = init_params(cfg, 0, "cpu").requires_grad_()
    o = adamw_init(p)
    for i, b in enumerate(batches):
        p, o, _ = step(p, o, b)
        if i == 1:
            mgr.save(i + 1, {"params": p, "opt": o})
    p2 = init_params(cfg, 0, "cpu").requires_grad_()
    restored, at, _ = mgr.restore({"params": p2, "opt": adamw_init(p2)})
    p2, o2 = restored["params"], restored["opt"]
    for b in batches[at:]:
        p2, o2, _ = step(p2, o2, b)
    for (n, a), (_, b) in zip(p.named_parameters(), p2.named_parameters()):
        assert torch.equal(a, b), n
    for n in o["m"]:
        assert torch.equal(o["m"][n], o2["m"][n])
        assert torch.equal(o["v"][n], o2["v"][n])
    assert int(o2["step"]) == 4


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def final_arrays(directory, step):
    with np.load(os.path.join(directory, f"step_{step:010d}",
                              "arrays.npz")) as a:
        return {k: a[k] for k in a.keys()}


def test_train_cli_runs_resumes_and_refuses(tmp_path, capsys):
    base = ["--arch", "qwen3-4b", "--reduced", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--device", "cpu"]
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    assert train_cli.main(base + ["--steps", "4", "--checkpoint-dir",
                                  straight]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert train_cli.main(base + ["--steps", "2", "--checkpoint-dir",
                                  resumed, "--checkpoint-every", "2"]) == 0
    assert train_cli.main(base + ["--steps", "4", "--checkpoint-dir",
                                  resumed, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    manifest = json.loads(open(os.path.join(
        resumed, "step_0000000004", "manifest.json")).read())
    assert manifest["extra"] == {"data_seed": 0, "data_cursor": 4}
    a, b = final_arrays(straight, 4), final_arrays(resumed, 4)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the remat, microbatch and int8 routes run
    assert train_cli.main(base + ["--steps", "1", "--remat",
                                  "--microbatches", "2", "--compress",
                                  "int8"]) == 0
    with pytest.raises(SystemExit, match="embedding-stub"):
        train_cli.main(["--arch", "paligemma-3b", "--reduced", "--steps",
                        "1", "--device", "cpu"])


def test_train_cli_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# the ssd autograd.Function's plumbing (the kernel is stood in for)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_function_backward_is_the_plain_vjp(monkeypatch, return_state):
    """``SSDFunction`` with its launch replaced by the plain version (the
    CUDA kernel cannot run here): the gradients of x, b, c and a equal
    autograd through the plain version bitwise, and every output that
    needs a gradient has a ``grad_fn``."""
    monkeypatch.setattr(
        ssd_kernel, "_launch",
        lambda x, b, c, a, chunk, rs: ssd_chunked_ref(
            x, b, c, a, chunk=chunk, return_state=rs))
    gen = torch.Generator().manual_seed(7)
    B, T, nh, G, dh, ds = 2, 45, 4, 2, 8, 6
    x = torch.randn((B, T, nh, dh), generator=gen)
    b = torch.randn((B, T, G, ds), generator=gen) * 0.5
    c = torch.randn((B, T, G, ds), generator=gen) * 0.5
    a = -torch.nn.functional.softplus(torch.randn((B, T, nh), generator=gen))
    wy = torch.randn((B, T, nh, dh), generator=gen)
    wh = torch.randn((B, nh, ds, dh), generator=gen)

    def grads(fn, needs):
        ins = [v.clone().requires_grad_(n) for v, n in zip((x, b, c, a),
                                                           needs)]
        out = fn(*ins)
        y, h = out if return_state else (out, None)
        assert y.grad_fn is not None
        loss = (y * wy).sum() + ((h * wh).sum() if return_state else 0)
        if return_state:
            assert h.grad_fn is not None
        loss.backward()
        return [v.grad for v in ins]

    for needs in ((True, True, True, True), (True, False, True, False)):
        want = grads(lambda *v: ssd_chunked_ref(
            *v, chunk=16, return_state=return_state), needs)
        got = grads(lambda *v: (lambda y, h: (y, h) if return_state else y)(
            *ssd_kernel.SSDFunction.apply(*v, 16, return_state)), needs)
        for g, w, n in zip(got, want, needs):
            assert (g is None) == (not n)
            if n:
                assert torch.equal(g, w)
