"""MoE slice of the port against the JAX package, on the CPU: ``moe_ffn``
(top-k routing, stable sort, capacity, groups, the combine's order),
WindGP expert placement, parameter counts, and jamba's layer pattern.

Inputs are made with numpy from a seed and go through the JAX function and
its port.  Tolerances: float32 ``moe_ffn`` within 1e-5 (the router and
expert products are sums taken in another order than XLA's; everything
else, the top-k ids and so the capacity drops, is equal); bfloat16
``moe_ffn`` within one bf16 unit and bitwise in all but a few elements in
10,000 (both sum each product in float32 and round once, and
``silu_stepwise`` rounds where ``jax.nn.silu`` does); ``moe_combine``
bitwise against the reference's serial scatter-add; the placement module
bitwise; parameter counts exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import layers as JL
from repro.models.model import active_param_count as jax_active_count
from repro.models.model import param_count as jax_param_count
from repro.sharding import windgp_placement as JP

from repro_torch.configs import ARCHS, get_reduced
from repro_torch.convert import _tensor
from repro_torch.models import (active_param_count, forward, init_params,
                                param_count)
from repro_torch.models import layers as TL
from repro_torch.sharding import windgp_placement as TP

MOE_ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b",
             "jamba-v0.1-52b")
CPU = torch.device("cpu")


def t(a):
    """A JAX or numpy array (bfloat16 too) as a CPU tensor."""
    return _tensor(np.asarray(a), CPU)


def both(cfg, B, S, seed=0, key=1):
    """moe_ffn of the reference and of the port on one input, and the
    port's routing: (want, got, ids) as numpy, ids (G, n, K)."""
    p = JL.init_moe(cfg, jax.random.PRNGKey(key))
    dt = ml_dtypes.bfloat16 if cfg.dtype == "bfloat16" else np.float32
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(dt)
    want = np.asarray(JL.moe_ffn(cfg, p, x)).astype(np.float32)
    pt = jax.tree.map(t, p)
    got = TL.moe_ffn(cfg, pt, t(x)).float().numpy()
    G = TL.moe_groups(cfg, B * S)
    _, ids = TL.moe_route(cfg, pt, t(x).reshape(G, B * S // G, -1))
    return want, got, ids.numpy(), p, x


def jax_ids(cfg, p, x, G):
    """The reference's routing, as its moe_ffn computes it."""
    xf = jnp.asarray(x).reshape(G, -1, cfg.d_model)
    logits = jnp.einsum("gnd,de->gne", xf.astype(jnp.float32), p["router"])
    return np.asarray(jax.lax.top_k(logits, cfg.experts_per_token)[1])


def drops(cfg, ids) -> int:
    """Entries the capacity drops, from the routing (G, n, K)."""
    G, n, _ = ids.shape
    cap = TL.moe_capacity(cfg, n)
    return int(sum(np.maximum(np.bincount(ids[g].reshape(-1),
                                          minlength=cfg.num_experts) - cap,
                              0).sum() for g in range(G)))


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S", [(1, 1), (8, 1), (2, 37)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, B, S):
    cfg = jax_reduced(arch)
    want, got, ids, p, x = both(cfg, B, S)
    close(got, want)
    assert np.array_equal(ids, jax_ids(cfg, p, x, 1))
    assert drops(cfg, ids) == 0       # B·S <= 128: the capacity clamp


@pytest.mark.parametrize("E", [8, 40])
def test_moe_ffn_top8_matches_jax(E):
    """granite's K = 8: eight contributions a token, whose order of
    addition the combine must keep."""
    cfg = dataclasses.replace(jax_reduced("granite-moe-3b-a800m"),
                              num_experts=E, experts_per_token=8)
    for B, S in ((1, 1), (2, 37)):
        want, got, ids, p, x = both(cfg, B, S)
        close(got, want)
        assert np.array_equal(ids, jax_ids(cfg, p, x, 1))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_capacity_drops_match_jax(arch):
    """capacity_factor 0.25 at 600 tokens (above the 128-token clamp):
    experts overflow, and the stable sort decides which entries stay.
    A different dropped set would move the outputs of its tokens by a
    whole expert's contribution, far outside the tolerance."""
    cfg = dataclasses.replace(jax_reduced(arch), capacity_factor=0.25)
    want, got, ids, p, x = both(cfg, 4, 150)
    assert drops(cfg, ids) > 0
    close(got, want)
    assert np.array_equal(ids, jax_ids(cfg, p, x, 1))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_groups_match_jax(arch, capacity_factor):
    """moe_groups = 2: each group sorted and capped on its own."""
    cfg = dataclasses.replace(jax_reduced(arch), moe_groups=2,
                              capacity_factor=capacity_factor)
    for B, S in ((2, 37), (8, 150)):
        want, got, ids, p, x = both(cfg, B, S)
        assert ids.shape[0] == 2
        close(got, want)
        assert np.array_equal(ids, jax_ids(cfg, p, x, 2))
        if capacity_factor < 1 and B * S > 2 * 128:
            assert drops(cfg, ids) > 0
    # groups of fewer than K tokens fall back to one group, as there
    assert TL.moe_groups(cfg, 2) == 1 and TL.moe_groups(cfg, 3) == 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_bf16_matches_jax(arch):
    """Within one bf16 unit of the reference's value, and nearly all
    bitwise: an expert product's float32 sum, taken in another order,
    can round to the neighbouring bf16 value."""
    cfg = dataclasses.replace(jax_reduced(arch), dtype="bfloat16")
    for B, S in ((1, 1), (2, 37)):
        want, got, *_ = both(cfg, B, S)
        unit = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                       - 7)
        assert (np.abs(got - want) <= unit).all()
        assert (got != want).mean() < 1e-3


def test_silu_stepwise_matches_jax_in_bf16():
    x = (np.random.default_rng(5).standard_normal(1 << 16) * 4).astype(
        ml_dtypes.bfloat16)
    want = np.asarray(jax.nn.silu(jnp.asarray(x))).astype(np.float32)
    np.testing.assert_array_equal(TL.silu_stepwise(t(x)).float().numpy(),
                                  want)


def test_silu_stepwise_recording_gives_the_same_bits():
    """Where autograd records, ``silu_stepwise`` runs out of place; its
    bits are the in-place (serving) version's, and its gradient is
    ``F.silu``'s within float32 rounding."""
    x = t((np.random.default_rng(6).standard_normal(1 << 14) * 4).astype(
        ml_dtypes.bfloat16))
    xg = x.clone().requires_grad_()
    got = TL.silu_stepwise(xg)
    assert got.grad_fn is not None
    assert torch.equal(got.detach(), TL.silu_stepwise(x))
    x32 = x.float().requires_grad_()
    TL.silu_stepwise(x32).sum().backward()
    want = x.float().requires_grad_()
    torch.nn.functional.silu(want).sum().backward()
    torch.testing.assert_close(x32.grad, want.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,n,K,E", [(1, 37, 8, 40), (2, 50, 2, 4),
                                     (1, 9, 8, 8)])
def test_moe_combine_is_the_reference_scatter_add(dtype, G, n, K, E):
    """The combine against ``zeros.at[gtok].add(table[gslot] * w)`` on
    values of 13 decades, where the order of the adds shows: bitwise, and
    the opposite order is not."""
    rng = np.random.default_rng(6)
    R, d = E * n + 1, 16
    experts = np.stack([np.stack([rng.permutation(E)[:K] for _ in range(n)])
                        for _ in range(G)]).reshape(G, n * K)
    order = np.argsort(experts, axis=-1, kind="stable")
    table = (rng.standard_normal((G * R, d))
             * 10.0 ** rng.integers(-6, 7, (G * R, d))).astype(np.float32)
    slot = rng.integers(0, R, (G, n * K)) + np.arange(G)[:, None] * R
    w = rng.random((G, n * K)).astype(np.float32)
    gtok = (np.arange(G)[:, None] * n + order // K).reshape(-1)
    jdt = jnp.dtype(dtype)
    tab, ww = jnp.asarray(table).astype(jdt), jnp.asarray(w).astype(jdt)
    want = jnp.zeros((G * n, d), jdt).at[gtok].add(
        tab[slot.reshape(-1)] * ww.reshape(-1)[:, None])
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(table).to(tdt), torch.from_numpy(slot),
            torch.from_numpy(w).to(tdt))
    got = TL.moe_combine(*args, torch.from_numpy(order), K)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if K > 2:     # (0 + a) + b is (0 + b) + a: two terms have no order
        # the same terms added in the opposite order round otherwise
        rev = [torch.from_numpy(np.ascontiguousarray(a[:, ::-1]))
               for a in (slot, w, order)]
        other = TL.moe_combine(args[0], rev[0], rev[1].to(tdt), rev[2], K)
        assert not np.array_equal(other.float().numpy(), want)


# ---------------------------------------------------------------------------
# the model: pattern and parameter counts
# ---------------------------------------------------------------------------

def test_jamba_pattern():
    cfg = get_reduced("jamba-v0.1-52b")
    assert cfg.pattern_period == 8
    params = init_params(cfg, 0, "cpu")
    assert [b.kind for b in params.layers] == \
        ["attn" if i % 8 == 4 else "ssm" for i in range(8)]
    assert [b.moe for b in params.layers] == [i % 2 == 1 for i in range(8)]
    assert set(params.layers[1].ffn) == {"router", "w_gate", "w_up",
                                         "w_down"}
    assert params.layers[1].ffn["router"].dtype == torch.float32
    assert params.layers[1].ffn["w_gate"].shape == (4, 128, 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    cfg = jax_config(arch)
    assert param_count(cfg) == jax_param_count(cfg)
    assert active_param_count(cfg) == jax_active_count(cfg)
    small = get_reduced(arch)
    assert param_count(small) == sum(
        p.numel() for p in init_params(small, 0, "cpu").parameters())


# ---------------------------------------------------------------------------
# WindGP expert placement
# ---------------------------------------------------------------------------

def train_routing(E=16, toks=400, hot=4, seed=0):
    """tests/test_train.py's skewed routing."""
    rng = np.random.default_rng(seed)
    a = rng.choice(hot, size=(toks // 2, 1))
    b = rng.choice(hot, size=(toks // 2, 1))
    cold = rng.choice(np.arange(hot, E), size=(toks - toks // 2, 2))
    return np.concatenate([np.concatenate([a, b], 1), cold], 0)


def example_routing(E=16, toks=2000):
    """examples/hetero_moe_placement.py's routing."""
    rng = np.random.default_rng(0)
    hot = rng.choice(4, size=(toks // 2, 2))
    cold = rng.choice(np.arange(4, E), size=(toks - toks // 2, 2))
    return np.concatenate([hot, cold])


def granite_routing():
    """Layer 0's routing of the reduced granite model on 300 random
    tokens, recorded through ``moe_route``."""
    cfg = get_reduced("granite-moe-3b-a800m")
    params = init_params(cfg, 0, "cpu")
    seen = []
    kept = TL.moe_route

    def record(cfg, p, xf):
        out = kept(cfg, p, xf)
        seen.append(out[1].reshape(-1, cfg.experts_per_token).numpy())
        return out
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (3, 100)))
    TL.moe_route = record
    try:
        forward(cfg, params, toks)
    finally:
        TL.moe_route = kept
    assert len(seen) == cfg.num_layers
    return seen[0]


ROUTINGS = {
    "train": (train_routing, 16, [1.0, 1.0, 2.0], [8, 8, 8], [1.0] * 3),
    "example": (example_routing, 16, [0.5, 1.0, 1.0], [8, 6, 6],
                [1.0, 1.0, 1.5]),
    "granite": (granite_routing, 8, [0.5, 1.0, 1.0], [4, 3, 3],
                [1.0, 1.0, 1.5]),
}


@pytest.mark.parametrize("name", list(ROUTINGS))
def test_windgp_placement_equals_reference(name):
    make, E, compute, mem, link = ROUTINGS[name]
    routing = make()
    for a, b in zip(TP.coactivation_graph(routing),
                    JP.coactivation_graph(routing)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    place = TP.place_experts(E, routing, compute, mem, link)
    want = JP.place_experts(E, routing, compute, mem, link)
    assert place.dtype == want.dtype and np.array_equal(place, want)
    assert np.array_equal(TP.place_experts(E, routing, compute, mem, link),
                          place)
    assert (np.bincount(place, minlength=len(mem)) <= np.array(mem) + 1).all()
    rr = np.arange(E) % len(mem)
    for pl in (place, rr):
        assert TP.placement_cost(pl, routing, compute, link) == \
            JP.placement_cost(pl, routing, compute, link)


def test_placement_of_no_coactivation_is_round_robin_by_load():
    routing = np.array([[0], [0], [1], [2]])
    got = TP.place_experts(4, routing, [1.0, 1.0], [2, 2], [1.0, 1.0])
    assert np.array_equal(got, JP.place_experts(4, routing, [1.0, 1.0],
                                                [2, 2], [1.0, 1.0]))
