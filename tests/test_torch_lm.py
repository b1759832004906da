"""LM serving path of the port against the JAX package, on the CPU: every
arch of the reference's registry (MLA and the embedding-input stubs
included) at its reduced config.

Inputs are made with numpy from a seed and go through the JAX function and
its port.  The Pallas kernels run as ``tests/test_kernels.py`` runs them
(``interpret=True``).  Tolerances: the kernels' plain versions as the JAX
kernel tests hold them (decode 2e-5, SSD 2e-4); the layers within 1e-5
(float32, sums in another order); whole models within 1e-4 (float32 over
a few layers); greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.kernels.decode_attn import decode_attention as jax_decode
from repro.kernels.ssd import ssd_chunked as jax_ssd_chunked
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.serve import generate as jax_generate

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_ref)
from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_ref, ssd_ref
from repro_torch.models import (active_param_count, decode_step, forward,
                                init_cache, init_params, param_count)
from repro_torch.models import layers as TL
from repro_torch.serve import generate, next_inputs


def t(a):
    """A JAX or numpy array as a CPU tensor."""
    return torch.from_numpy(np.array(a))


def tree_t(tree):
    return jax.tree.map(t, tree)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def model_inputs(cfg, rng, B, S):
    """(B, S) token ids, or (B, S, d) float32 embeddings for a stub arch."""
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# kernels' plain versions and wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KVH,dh,S,bs", [
    (8, 2, 64, 256, 64),      # GQA
    (4, 4, 32, 128, 64),      # MHA
    (16, 1, 32, 128, 128),    # MQA
])
def test_decode_attention_ref_matches_jax(H, KVH, dh, S, bs):
    rng = np.random.default_rng(0)
    B = 3
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    lens = np.array([S, S // 2 + 3, 0], np.int32)
    got = decode_attention_ref(t(q), t(k), t(v), t(lens))
    close(got, jax_decode(q, k, v, lens, block_s=bs, interpret=True), 2e-5)
    assert torch.equal(decode_attention(t(q), t(k), t(v), t(lens)), got)
    # lengths == 0 is the uniform mean of V (the reference's quirk)
    close(got[2], np.repeat(v[2].mean(0), H // KVH, axis=0), 2e-5)
    # the model's decode call: flash_attention at S == 1, lengths >= 1
    fa = JL.flash_attention(q[:2, None], k[:2], v[:2], causal=False,
                            kv_lengths=lens[:2], block_k=bs)[:, 0]
    close(got[:2], fa, 2e-5)


@pytest.mark.parametrize("T,chunk,decay", [(128, 32, 0.1), (100, 32, 0.1),
                                           (96, 64, 5.0)])
def test_ssd_refs_match_jax(T, chunk, decay):
    rng = np.random.default_rng(1)
    BH, dh, ds = 3, 16, 8
    x = rng.standard_normal((BH, T, dh)).astype(np.float32)
    b = (rng.standard_normal((BH, T, ds)) * .5).astype(np.float32)
    c = (rng.standard_normal((BH, T, ds)) * .5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((BH, T))) * decay).astype(np.float32)
    if decay > 1:
        a[:] = -decay
    want = jax_ssd_chunked(x, b, c, a, chunk=chunk, interpret=True)
    # the flat layout as one head and one group per sequence
    heads = [t(v)[:, :, None] for v in (x, b, c, a)]
    y, h = ssd_chunked_ref(*heads, chunk=chunk, return_state=True)
    assert y.shape == (BH, T, 1, dh) and h.shape == (BH, 1, ds, dh)
    close(y[:, :, 0], want, 2e-4)
    close(ssd_ref(t(x), t(b), t(c), t(a)), want, 2e-4)
    assert np.isfinite(y.numpy()).all()
    # head-major layout against ssd_jax (y and final state): one sequence,
    # BH heads sharing one b/c group
    x4, b4, c4, a4 = (x.transpose(1, 0, 2)[None], b[:1].transpose(1, 0, 2)[None],
                      c[:1].transpose(1, 0, 2)[None], a.T[None])
    y_j, h_j = JL.ssd_jax(x4, b4, c4, a4, chunk, return_state=True)
    y4, h4 = ssd_chunked_ref(t(x4), t(b4), t(c4), t(a4), chunk=chunk,
                             return_state=True)
    assert y4.shape == (1, T, BH, dh) and h4.shape == (1, BH, ds, dh)
    close(y4, y_j, 2e-4)
    close(h4, h_j, 2e-4)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(ssd_chunked(*heads, chunk=chunk), y)
    yw, hw = ssd_chunked(t(x4), t(b4), t(c4), t(a4), chunk=chunk,
                         return_state=True)
    assert torch.equal(yw, y4) and torch.equal(hw, h4)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    close(TL.rms_norm(t(x), t(scale), 1e-6), JL.rms_norm(x, scale, 1e-6),
          1e-5)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    for frac in (1.0, 0.5, 0.25):
        close(TL.rope(t(x), t(pos), 1e4, frac), JL.rope(x, pos, 1e4, frac),
              1e-5)


@pytest.mark.parametrize("causal,q_offset,lengths,Dv", [
    (True, 0, None, 16), (True, 5, None, 8), (False, 0, (40, 9), 16),
    (True, 0, (40, 23), 24)])
def test_flash_attention_matches_jax(causal, q_offset, lengths, Dv):
    rng = np.random.default_rng(3)
    B, Sq, Skv, H, KVH, D = 2, 37 if q_offset == 0 else 20, 45, 4, 2, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KVH, Dv)).astype(np.float32)
    kv = None if lengths is None else np.array(lengths, np.int32)
    kw = dict(causal=causal, q_offset=q_offset, block_q=16, block_k=8)
    got = TL.flash_attention(t(q), t(k), t(v),
                             kv_lengths=None if kv is None else t(kv), **kw)
    close(got, JL.flash_attention(q, k, v, kv_lengths=kv, **kw), 1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(mlp_type):
    cfg = dataclasses.replace(jax_reduced("qwen3-4b"), mlp_type=mlp_type)
    p = JL.init_mlp(cfg, jax.random.PRNGKey(4))
    x = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model))
    x = x.astype(np.float32)
    close(TL.mlp(cfg, tree_t(p), t(x)), JL.mlp(cfg, p, x), 1e-5)


def test_ssm_mixer_matches_jax_in_all_modes():
    cfg = jax_reduced("mamba2-780m")
    p = JL.init_ssm(cfg, jax.random.PRNGKey(5))
    p = dict(p, a_log=jnp.full_like(p["a_log"], 0.3),
             dt_bias=jnp.full_like(p["dt_bias"], -0.5))
    pt = tree_t(p)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    y_j, _ = JL.ssm_mixer(cfg, p, x)
    y_t, _ = TL.ssm_mixer(cfg, pt, t(x))
    close(y_t, y_j, 1e-5)
    y_j, s_j = JL.ssm_mixer(cfg, p, x, state="prefill")
    y_t, s_t = TL.ssm_mixer(cfg, pt, t(x), state="prefill")
    close(y_t, y_j, 1e-5)
    for k in ("conv", "ssm"):
        close(s_t[k], s_j[k], 1e-5)
    x1 = x[:, :1]
    y_j, n_j = JL.ssm_mixer(cfg, p, x1, state=s_j)
    y_t, n_t = TL.ssm_mixer(cfg, pt, t(x1), state=s_t)
    close(y_t, y_j, 1e-5)
    for k in ("conv", "ssm"):
        close(n_t[k], n_j[k], 1e-5)


@pytest.mark.parametrize("case", ["prefill", "decode", "q_lora", "wq"])
def test_mla_attention_matches_jax(case):
    """MLA's absorbed form against the reference in float32: prefill
    without a cache; decode with ragged ``cache_len`` into a cache; the
    ``q_lora_rank`` branch (prefill into a cache) and the ``wq`` branch."""
    cfg = jax_reduced("minicpm3-4b")
    if case == "wq":
        cfg = dataclasses.replace(cfg, q_lora_rank=0)
    p = JL.init_mla(cfg, jax.random.PRNGKey(9))
    assert ("w_uq" in p) == (case != "wq") and ("wq" in p) == (case == "wq")
    pt = tree_t(p)
    rng = np.random.default_rng(9)
    B, Smax = 3, 24
    if case in ("prefill", "wq"):
        x = rng.standard_normal((B, 17, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(17), (B, 17)).astype(np.int32)
        y_j, _ = JL.mla_attention(cfg, p, x, pos)
        y_t, c_t = TL.mla_attention(cfg, pt, t(x), t(pos))
        assert c_t is None
        close(y_t, y_j, 1e-5)
        return
    # a cache holding ragged prefixes, then one step (decode) or a prefill
    # from an empty cache (q_lora)
    S = 1 if case == "decode" else 11
    lens = np.array([5, 0, 13], np.int32) if case == "decode" \
        else np.zeros(B, np.int32)
    cache = {"latent": rng.standard_normal(
                 (B, Smax, cfg.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal(
                 (B, Smax, cfg.qk_rope_dim)).astype(np.float32)}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = (lens[:, None] + np.arange(S)[None, :]).astype(np.int32)
    y_j, c_j = JL.mla_attention(cfg, p, x, pos, cache=cache, cache_len=lens)
    c_t = {k: t(v) for k, v in cache.items()}
    y_t, c_t = TL.mla_attention(cfg, pt, t(x), t(pos), cache=c_t,
                                cache_len=t(lens))
    close(y_t, y_j, 1e-5)
    for k in ("latent", "k_rope"):
        close(c_t[k], c_j[k], 1e-5)


def test_embedding_feedback_past_d_model_matches_jax():
    """An embedding-input arch feeds the greedy token back as
    ``jax.nn.one_hot(tok, d_model)``: all zeros for tok >= d_model.  The
    unembedding's first d_model columns are zeroed, so every argmax lands
    at or above d_model."""
    cfg = jax_reduced("musicgen-medium")
    assert cfg.vocab_size > cfg.d_model
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    params = dict(params, unembed=params["unembed"].at[:, :cfg.d_model]
                  .set(0.0))
    ported = params_from_numpy(get_reduced("musicgen-medium"),
                               jax.tree.map(np.asarray, params), "cpu")
    prompts = model_inputs(cfg, np.random.default_rng(10), 2, 6)
    want = np.asarray(jax_generate(cfg, params, prompts, 4))
    assert (want >= cfg.d_model).all()
    got = generate(cfg, ported, t(prompts), 4, device="cpu")
    assert torch.equal(got, t(want).long())
    fed = next_inputs(cfg, torch.tensor([3, cfg.d_model, cfg.vocab_size - 1]))
    assert fed.shape == (3, 1, cfg.d_model) and fed.dtype == torch.float32
    assert torch.equal(fed, t(jax.nn.one_hot(
        np.array([3, cfg.d_model, cfg.vocab_size - 1]), cfg.d_model))[:, None])


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    cfg = jax_reduced(arch)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    ported = params_from_numpy(get_reduced(arch),
                               jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, ported


def test_forward_and_decode_match_jax(models):
    cfg, params, ported = models
    rng = np.random.default_rng(6)
    B, P, steps = 2, 21, 3
    toks = model_inputs(cfg, rng, B, P + steps)
    close(forward(cfg, ported, t(toks)), jax_forward(cfg, params, toks),
          1e-4)
    max_len = P + steps + 2
    cache_j = jax_init_cache(cfg, B, max_len)
    cache_t = init_cache(cfg, B, max_len, device="cpu")
    lens = np.zeros(B, np.int32)
    for s in range(steps + 1):
        x = toks[:, :P] if s == 0 else toks[:, P + s - 1:P + s]
        lj, cache_j = jax_decode_step(cfg, params, cache_j, x, lens)
        lt, cache_t = decode_step(cfg, ported, cache_t, t(x), t(lens))
        close(lt, lj, 1e-4)
        for (path, leaf) in jax.tree_util.tree_leaves_with_path(cache_j):
            keys = [p.key for p in path]
            close(cache_t[keys[0]][keys[1]], leaf, 1e-4)
        lens = lens + x.shape[1]


def test_generate_matches_jax(models):
    cfg, params, ported = models
    prompts = model_inputs(cfg, np.random.default_rng(7), 2, 9)
    want = jax_generate(cfg, params, prompts, 5)
    got = generate(cfg, ported, t(prompts), 5, device="cpu")
    assert torch.equal(got, t(want).long())


def test_temperature_sampling_follows_the_generator():
    cfg = get_reduced("qwen3-4b")
    params = init_params(cfg, 0, "cpu")
    prompts = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (4, 8)))

    def draw(seed):
        return generate(cfg, params, prompts, 8, temperature=2.0,
                        generator=torch.Generator().manual_seed(seed),
                        device="cpu")
    a, b = draw(1), draw(2)
    assert torch.equal(a, draw(1))
    assert not torch.equal(a, b)
    tokens, logits = generate(cfg, params, prompts, 3, device="cpu",
                              return_logits=True)
    assert torch.equal(tokens, logits.argmax(-1))


# ---------------------------------------------------------------------------
# copied modules and entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    from repro.configs import get_config as jax_config
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == \
        dataclasses.asdict(jax_reduced(arch))


def test_unknown_arch_raises():
    for get in (get_config, get_reduced):
        with pytest.raises(KeyError, match="unknown arch"):
            get("llama-9000")


def test_every_reference_arch_resolves():
    from repro import configs as ref
    from repro.models import active_param_count as jax_active
    from repro.models import param_count as jax_count
    from repro_torch import configs
    assert ARCHS == ref.ARCHS
    assert configs.SHAPES == ref.SHAPES
    assert configs.LONG_CONTEXT_ARCHS == ref.LONG_CONTEXT_ARCHS
    assert configs.cells() == ref.cells()
    for arch in ARCHS:
        for cfg in (get_config(arch), get_reduced(arch)):
            assert param_count(cfg) == jax_count(cfg), cfg.name
            assert active_param_count(cfg) == jax_active(cfg), cfg.name
        params = init_params(get_reduced(arch), 0, "cpu")
        assert sum(p.numel() for p in params.parameters()) == \
            param_count(get_reduced(arch))


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("mamba2-780m")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 1, 8)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        generate(cfg, params, torch.zeros((1, 4), dtype=torch.long), 2)
    assert init_cache(cfg, 1, 8, device="cpu")["pos0"]["ssm"].dtype \
        == torch.float32
