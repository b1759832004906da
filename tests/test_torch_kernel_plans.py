"""Host-side plans of the port's LM kernels, on the CPU.

``decode_attn``: the split sizing (``kernel.plan_splits``) over Smax
1…65,536 and B·KVH 1…512, and the kernel's split-and-merge algorithm in
plain torch (``ref.decode_attention_splits``) against the dense plain
version and the JAX kernel (interpret mode), at rtol = atol = 2e-5 as the
JAX kernel tests hold decode attention.  ``ssd``: the bfloat16 instance's
32-step sub-chunks against the reference's chunks (the chunked form is one
function for every chunk length), at 2e-4.
"""
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import decode_attention as jax_decode
from repro.kernels.ssd import ssd_chunked as jax_ssd_chunked

from repro_torch.kernels.decode_attn import kernel as attn_k
from repro_torch.kernels.decode_attn.ref import (decode_attention_ref,
                                                 decode_attention_splits)
from repro_torch.kernels.ssd import kernel as ssd_k
from repro_torch.kernels.ssd import ssd_chunked_ref

H100_SMS = 132
SMAXES = [1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 300, 1000, 2113,
          4096, 5000, 32767, 32768, 65535, 65536]
ROWS = [1, 2, 3, 7, 8, 16, 31, 63, 64, 65, 127, 128, 131, 132, 133, 255,
        256, 395, 396, 397, 511, 512]
#: (SMs, CTAs an SM holds): an H100 with the tensor-core kernel's 6 and
#: fewer or more than the plan aims at, a smaller card, one SM
CARDS = [(H100_SMS, 6), (H100_SMS, 3), (H100_SMS, 2), (H100_SMS, 1),
         (H100_SMS, 16), (78, 4), (1, 1)]


@pytest.mark.parametrize("smax", SMAXES)
def test_plan_splits_cover_smax_in_tiles_within_one_wave(smax):
    tiles = -(-smax // attn_k.TILE)
    for sms, per_sm in CARDS:
        slots = sms * min(per_sm, attn_k.CTAS_PER_SM)
        for rows in ROWS:
            split_len, nsplit = attn_k.plan_splits(smax, rows, sms, per_sm)
            assert split_len >= attn_k.TILE
            assert split_len % attn_k.TILE == 0
            # the splits cover Smax, and none lies wholly past it
            assert nsplit * split_len >= smax
            assert (nsplit - 1) * split_len < smax
            # about one wave of resident CTAs, inside the grid's limits
            assert nsplit <= max(1, slots // rows)
            assert rows * nsplit <= max(slots, rows)
            assert nsplit <= attn_k.MAX_GRID_X
            want = max(1, slots // rows)
            if tiles >= want:
                assert 2 * nsplit > want


def test_plan_splits_serving_shape():
    # qwen3-4b decode: B = 8, KVH = 8 (64 rows), Smax 2113, on an H100
    # whose SMs hold 6 of the tensor-core kernel's CTAs: 3 an SM
    assert attn_k.plan_splits(2113, 64, H100_SMS, 6) == (384, 6)
    assert attn_k.plan_splits(32768, 64, H100_SMS, 6) == (5472, 6)
    # a card that holds 2 an SM plans 2 at every Smax
    assert attn_k.plan_splits(2113, 64, H100_SMS, 2) == (544, 4)
    # rows beyond the slots: one split each, one CTA per (b, kvh)
    assert attn_k.plan_splits(2113, 512, H100_SMS, 6) == (2144, 1)
    for bad in ((0, 64, H100_SMS, 6), (2113, 0, H100_SMS, 6),
                (2113, 64, 0, 6), (2113, 64, H100_SMS, 0)):
        with pytest.raises(ValueError):
            attn_k.plan_splits(*bad)


@pytest.mark.parametrize("split_len", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("H,KVH,dh,S", [
    (8, 2, 64, 256),      # GQA
    (4, 4, 32, 128),      # MHA
    (16, 1, 32, 256),     # MQA
])
def test_split_merge_matches_dense_and_jax(split_len, H, KVH, dh, S):
    rng = np.random.default_rng(5)
    lens = np.array([S, 0, split_len, split_len + 1, 1, 33], np.int32)
    B = len(lens)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    t = torch.from_numpy
    got = decode_attention_splits(t(q), t(k), t(v), t(lens),
                                  split_len=split_len)
    np.testing.assert_allclose(
        got, decode_attention_ref(t(q), t(k), t(v), t(lens)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(jax_decode(q, k, v, lens, block_s=64,
                                   interpret=True)), rtol=2e-5, atol=2e-5)
    # lengths == 0: the uniform mean of V over all S
    np.testing.assert_allclose(got[1], np.repeat(v[1].mean(0), H // KVH,
                                                 axis=0), rtol=2e-5,
                               atol=2e-5)
    # without lengths: every position, every split full
    np.testing.assert_allclose(
        decode_attention_splits(t(q), t(k), t(v), split_len=split_len),
        decode_attention_ref(t(q), t(k), t(v)), rtol=2e-5, atol=2e-5)


def test_split_merge_empty_splits():
    # one position in a cache of 8 splits: 7 empty splits merge to nothing
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 256, 2, 32))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 256, 2, 32))
                         .astype(np.float32))
    lens = torch.tensor([1, 2], dtype=torch.int32)
    got = decode_attention_splits(q, k, v, lens, split_len=32)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[0], v[0, 0].repeat_interleave(2, dim=0),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, decode_attention_ref(q, k, v, lens),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T,decay", [(128, 0.1), (100, 0.1), (96, 5.0),
                                     (1, 0.1)])
def test_ssd_sub_chunks_match_reference_chunks(T, decay):
    rng = np.random.default_rng(7)
    BH, dh, ds = 3, 16, 8
    x = rng.standard_normal((BH, T, dh)).astype(np.float32)
    b = (rng.standard_normal((BH, T, ds)) * .5).astype(np.float32)
    c = (rng.standard_normal((BH, T, ds)) * .5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((BH, T))) * decay).astype(np.float32)
    if decay > 1:
        a[:] = -decay
    want = np.asarray(jax_ssd_chunked(x, b, c, a, chunk=min(64, T),
                                      interpret=True))
    heads = [torch.from_numpy(v)[:, :, None] for v in (x, b, c, a)]
    y, h = ssd_chunked_ref(*heads, chunk=ssd_k.SUB_CHUNK, return_state=True)
    np.testing.assert_allclose(y[:, :, 0], want, rtol=2e-4, atol=2e-4)
    _, h_long = ssd_chunked_ref(*heads, chunk=128, return_state=True)
    np.testing.assert_allclose(h, h_long, rtol=2e-4, atol=2e-4)
