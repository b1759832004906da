"""In-group q-head padding (``pad_group_to``) of the port against the JAX
package, on the CPU: the mask layout, a padded forward equal to the
reference's and to the unpadded one, and zero gradients on the pad slots
through the port's train step.  The reduced qwen3-14b config has 5 q heads
over 1 KV head (G = 5), padded to 6, as ``tests/test_head_padding.py``
holds the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.layers import head_pad_mask as jax_head_pad_mask

from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import forward, init_params
from repro_torch.models.layers import head_pad_mask
from repro_torch.train import loss_and_grads

KEY = jax.random.PRNGKey(0)
ARCH, PAD = "qwen3-14b", 6


def padded(cfg):
    return dataclasses.replace(cfg, pad_group_to=PAD)


def scatter_params(cfg_pad, params):
    """The reference's unpadded attention weights in the padded slot
    layout (``tests/test_head_padding.py::_scatter_params``)."""
    Hp, H, KVH = (cfg_pad.num_heads_padded, cfg_pad.num_heads,
                  cfg_pad.num_kv_heads)
    g, P = H // KVH, Hp // KVH
    real = (np.arange(KVH)[:, None] * P + np.arange(g)[None, :]).reshape(-1)

    def fix(path, leaf):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name == "wq" and leaf.ndim == 4:        # (n_super, d, H, hd)
            out = jnp.zeros(leaf.shape[:2] + (Hp, leaf.shape[3]), leaf.dtype)
            return out.at[:, :, real, :].set(leaf)
        if name == "wo" and leaf.ndim == 4:        # (n_super, H, hd, d)
            out = jnp.zeros((leaf.shape[0], Hp) + leaf.shape[2:], leaf.dtype)
            return out.at[:, real, :, :].set(leaf)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, params)


def test_mask_layout_matches_jax():
    cfg = padded(get_reduced(ARCH))
    got = head_pad_mask(cfg)
    want = np.asarray(jax_head_pad_mask(padded(jax_reduced(ARCH))))
    assert got.dtype == torch.float32 and tuple(got.shape) == (PAD,)
    assert got.tolist() == want.tolist() == [1, 1, 1, 1, 1, 0]
    assert head_pad_mask(get_reduced(ARCH)) is None
    # the port's own init zeroes the pad slots of wq and wo
    mixer = init_params(cfg, 0, "cpu").layers[0].mixer
    assert float(mixer["wq"][:, got == 0].abs().max()) == 0.0
    assert float(mixer["wo"][got == 0].abs().max()) == 0.0


def test_padded_forward_matches_jax_and_unpadded():
    """The reference's weights scattered into the padded layout: the port's
    padded forward equals the reference's padded forward and the port's
    unpadded one, at the reference's own tolerance (2e-5)."""
    jcfg = jax_reduced(ARCH)
    params = jax_init_params(jcfg, KEY)
    params_pad = scatter_params(padded(jcfg), params)
    inp = np.array(jax.random.randint(KEY, (2, 16), 0, jcfg.vocab_size))
    want = np.asarray(jax_forward(padded(jcfg), params_pad,
                                  jnp.asarray(inp)))
    cfg = get_reduced(ARCH)
    tinp = torch.from_numpy(inp).long()
    base = forward(cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), "cpu"), tinp)
    got = forward(padded(cfg), params_from_numpy(
        padded(cfg), jax.tree.map(np.asarray, params_pad), "cpu"), tinp)
    assert got.shape == base.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_pad_slots_receive_zero_grads():
    """The port's train step (``loss_and_grads``, remat on and off) gives
    the pad slots of every layer's wq and wo exactly zero gradient, and the
    real slots a nonzero one."""
    cfg = padded(get_reduced(ARCH))
    mask = head_pad_mask(cfg)
    pad = mask == 0
    rng = np.random.default_rng(0)
    batch = {"inputs": torch.from_numpy(
                 rng.integers(0, cfg.vocab_size, (2, 8))),
             "labels": torch.from_numpy(
                 rng.integers(0, cfg.vocab_size, (2, 8)))}
    for remat in (False, True):
        params = init_params(cfg, 0, "cpu").requires_grad_()
        _, grads = loss_and_grads(cfg, params, batch, remat=remat)
        names = [n for n in grads if n.endswith((".wq", ".wo"))]
        assert len(names) == 2 * cfg.num_layers
        for n in names:
            g = grads[n]
            slots = g[:, pad] if n.endswith(".wq") else g[pad]
            real = g[:, ~pad] if n.endswith(".wq") else g[~pad]
            assert float(slots.abs().max()) == 0.0, n
            assert float(real.abs().max()) > 0.0, n
