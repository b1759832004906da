"""Host-side plans of the port's kernels, on the CPU.

``bsr_spmv``: the tile plan (``kernel.plan_tiles``) over block sizes and
storage types: its ring fits a block's shared memory, bulk copies only
where a block row is a 16-byte multiple and the pointers are aligned,
and the graph path's plan at bm = 128.
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

from repro_torch.kernels.bsr_spmv import kernel as spmv_k
from repro_torch.kernels.decode_attn import kernel as attn_k
from repro_torch.kernels.decode_attn.ref import (decode_attention_ref,
                                                 decode_attention_splits)
from repro_torch.kernels.ssd import kernel as ssd_k
from repro_torch.kernels.ssd import ssd_chunked_ref

H100_SMS = 132
#: the shared memory a block may opt into on an H100 (227 KB)
H100_SMEM_OPTIN = 232_448
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


SPMV_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
SPMV_BMS = [1, 7, 8, 16, 30, 32, 64, 100, 128, 200, 256, 512, 1000, 1536]


@pytest.mark.parametrize("dtype", SPMV_DTYPES)
@pytest.mark.parametrize("bm", SPMV_BMS)
def test_tile_plan_fits_shared_memory(bm, dtype):
    row_bytes = bm * dtype.itemsize
    for p, R in ((1, 1), (3, 7), (9, 251)):
        for limit in (H100_SMEM_OPTIN, 99 * 1024, 48 * 1024):
            plan = spmv_k.plan_tiles(bm, dtype, limit, p=p, R=R)
            assert plan.smem <= limit
            # stages, then a full and an empty 8-byte barrier a stage
            assert plan.smem == plan.stages * (plan.stage_bytes + 16)
            assert plan.stage_bytes % 128 == 0
            assert plan.x_offset % 16 == 0
            assert plan.x_offset >= plan.rows * row_bytes
            assert plan.stage_bytes >= plan.x_offset + row_bytes
            assert spmv_k.MIN_STAGES <= plan.stages <= spmv_k.MAX_STAGES
            assert 1 <= plan.rows <= bm
            assert plan.grid == p * R * -(-bm // plan.rows)
            assert plan.lanes in spmv_k.LANES
            assert plan.rows * plan.lanes <= spmv_k.MAX_CONSUMERS
            assert plan.threads % 32 == 0
            assert plan.threads == -(-plan.rows * plan.lanes // 32) * 32 + 32
            # the lanes of a row split its 16-byte vectors evenly
            if plan.lanes > 1:
                assert row_bytes % (16 * plan.lanes) == 0


@pytest.mark.parametrize("dtype", SPMV_DTYPES)
@pytest.mark.parametrize("bm", SPMV_BMS)
def test_tile_plan_bulk_only_on_16_byte_rows(bm, dtype):
    aligned = spmv_k.plan_tiles(bm, dtype, H100_SMEM_OPTIN)
    rows_of_16 = bm * dtype.itemsize % 16 == 0
    assert aligned.mode == ("bulk" if rows_of_16 else "loads")
    # a slab (rows of a block) and an x slice: both 16-byte multiples and
    # at 16-byte multiples of an aligned base
    if aligned.mode == "bulk":
        assert aligned.rows * bm * dtype.itemsize % 16 == 0
    # pointers off 16 bytes take the producer's loads, in the same ring
    unaligned = spmv_k.plan_tiles(bm, dtype, H100_SMEM_OPTIN, aligned=False)
    assert unaligned.mode == "loads"
    assert (unaligned.rows, unaligned.stages, unaligned.smem) == \
        (aligned.rows, aligned.stages, aligned.smem)


def test_tile_plan_main_path():
    # the graph path at graph500:16: p 9, R 251, bm 128, on an H100
    f32 = spmv_k.plan_tiles(128, torch.float32, H100_SMEM_OPTIN, p=9, R=251)
    assert (f32.rows, f32.lanes, f32.stages, f32.mode) == (32, 4, 4, "bulk")
    assert (f32.x_offset, f32.stage_bytes, f32.smem, f32.threads,
            f32.grid) == (16384, 16896, 67648, 160, 9036)
    for dtype in (torch.bfloat16, torch.float16):
        b16 = spmv_k.plan_tiles(128, dtype, H100_SMEM_OPTIN, p=9, R=251)
        assert (b16.rows, b16.lanes, b16.stages, b16.mode) == \
            (64, 2, 4, "bulk")
        assert (b16.x_offset, b16.stage_bytes, b16.smem, b16.threads,
                b16.grid) == (16384, 16640, 66624, 160, 4518)
    # a ring of ~64 KB: three fit an SM's 228 KB
    assert 3 * (f32.smem + 1024) <= 233472


def test_tile_plan_fills_small_layouts_and_takes_overrides():
    # a small layout takes the main path's tile (no rule of its own): the
    # grid is p·R·bm/rows whatever it leaves idle
    small = spmv_k.plan_tiles(128, torch.float32, H100_SMEM_OPTIN, p=2, R=5)
    assert (small.rows, small.lanes, small.stages, small.grid) == \
        (32, 4, 4, 40)
    assert spmv_k.plan_tiles(128, torch.bfloat16, H100_SMEM_OPTIN, p=2,
                             R=5).rows == 64
    over = spmv_k.plan_tiles(128, torch.bfloat16, H100_SMEM_OPTIN, p=3, R=7,
                             rows=48, stages=1)
    assert (over.rows, over.stages, over.lanes, over.grid) == (48, 1, 2, 63)
    for bad in (dict(rows=0), dict(rows=129), dict(stages=0),
                dict(stages=spmv_k.MAX_STAGES + 1)):
        with pytest.raises(ValueError):
            spmv_k.plan_tiles(128, torch.float32, H100_SMEM_OPTIN, **bad)
    with pytest.raises(ValueError):
        spmv_k.plan_tiles(128, torch.float32, H100_SMEM_OPTIN, rows=128,
                          stages=4)
    with pytest.raises(ValueError):
        spmv_k.plan_tiles(spmv_k.MAX_BLOCK_SIZE + 1, torch.float32,
                          H100_SMEM_OPTIN)
    with pytest.raises(TypeError):
        spmv_k.plan_tiles(128, torch.float64, H100_SMEM_OPTIN)
