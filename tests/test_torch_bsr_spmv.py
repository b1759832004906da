"""Block-ELL semiring SpMV: the port's plain version and kernel wrapper
against the reference's Pallas kernel (interpret mode) and its plain
version, per semiring, with and without the machine axis.

Tolerances: (min, +) and (or, and) are exact in any order, so they are
bitwise; (+, ×) reassociates float32 sums: rtol=1e-5, atol=1e-7.  The
16-bit instances round once per ELL slot (the slot's float32 row sum) and
once per fold into ``y``, so (+, ×) is held within
``ref.plus_times_bounds``: the interval that any float32 order of the slot
sums admits, bitwise wherever no slot sum lies near a rounding boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bsr_spmv as ref_k

from repro_torch.convert import local_bsr_from_numpy
from repro_torch.kernels import bsr_spmv as port_k

SEMIRINGS = ("plus_times", "min_plus", "or_and")


def random_layout(rng, semiring, p=None, R=6, K=4, C=5, bm=16):
    """cols/blocks/x in the kernel's layout: padding slots (column 0,
    absent blocks), +inf entries for (min,+), 0/1 values for (or,and)."""
    lead = () if p is None else (p,)
    sr = port_k.get_semiring(semiring)
    cols = rng.integers(0, C, size=lead + (R, K)).astype(np.int32)
    if semiring == "or_and":
        blocks = (rng.random(lead + (R, K, bm, bm)) < 0.3).astype(np.float32)
        x = (rng.random(lead + (C * bm,)) < 0.5).astype(np.float32)
    else:
        blocks = rng.standard_normal(lead + (R, K, bm, bm)).astype(np.float32)
        x = rng.standard_normal(lead + (C * bm,)).astype(np.float32)
        if semiring == "min_plus":
            blocks[rng.random(blocks.shape) < 0.4] = np.inf
            x[rng.random(x.shape) < 0.2] = np.inf
    # ELL padding: the last slot of every other row points at column 0
    # and holds an absent block
    cols[..., ::2, -1] = 0
    blocks[..., ::2, -1, :, :] = sr.absent
    return cols, blocks, x


def assert_semiring_close(got, want, semiring):
    if semiring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


def assert_within_bounds(got, cols, blocks, x, dtype):
    """``got`` (float32 numpy) inside ``plus_times_bounds`` of the 16-bit
    inputs ``blocks``/``x`` (float32 numpy holding 16-bit values)."""
    lo, hi = port_k.plus_times_bounds(torch.from_numpy(cols),
                                      torch.from_numpy(blocks).to(dtype),
                                      torch.from_numpy(x).to(dtype))
    assert ((lo.float().numpy() <= got) & (got <= hi.float().numpy())).all()


def port_spmv(cols, blocks, x, semiring):
    return port_k.bsr_spmv(torch.from_numpy(cols), torch.from_numpy(blocks),
                           torch.from_numpy(x), semiring).numpy()


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_plain_matches_pallas_interpret(semiring):
    rng = np.random.default_rng(11)
    cols, blocks, x = random_layout(rng, semiring)
    want = np.asarray(ref_k.spmv_pallas(
        jnp.asarray(cols), jnp.asarray(blocks), jnp.asarray(x),
        block_size=16, interpret=True, semiring=semiring))
    got = port_k.bsr_spmv_ref(torch.from_numpy(cols),
                              torch.from_numpy(blocks),
                              torch.from_numpy(x), semiring).numpy()
    assert_semiring_close(got, want, semiring)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(port_spmv(cols, blocks, x, semiring), got)


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_machine_axis_matches_vmapped_pallas(semiring):
    rng = np.random.default_rng(12)
    cols, blocks, x = random_layout(rng, semiring, p=3)
    run = jax.vmap(lambda c, b, v: ref_k.spmv_pallas(
        c, b, v, block_size=16, interpret=True, semiring=semiring))
    want = np.asarray(run(jnp.asarray(cols), jnp.asarray(blocks),
                          jnp.asarray(x)))
    got = port_spmv(cols, blocks, x, semiring)
    assert got.shape == (3, 6 * 16)
    assert_semiring_close(got, want, semiring)
    for i in range(3):
        assert_semiring_close(port_spmv(cols[i], blocks[i], x[i], semiring),
                              got[i], semiring)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_plain_16bit_matches_pallas_interpret(dtype, semiring):
    """The reference kernel's own bf16/f16 instance against the plain
    version in the same dtype, with and without the machine axis."""
    rng = np.random.default_rng(17)
    tdt = getattr(torch, dtype)
    cols, blocks, x = random_layout(rng, semiring, p=2)
    # the 16-bit values, exact in float32, feed both packages
    blocks = torch.from_numpy(blocks).to(tdt).float().numpy()
    x = torch.from_numpy(x).to(tdt).float().numpy()
    run = jax.vmap(lambda c, b, v: ref_k.spmv_pallas(
        c, b, v, block_size=16, interpret=True, semiring=semiring))
    want = np.asarray(run(jnp.asarray(cols),
                          jnp.asarray(blocks).astype(dtype),
                          jnp.asarray(x).astype(dtype))).astype(np.float32)
    got = port_k.bsr_spmv(torch.from_numpy(cols),
                          torch.from_numpy(blocks).to(tdt),
                          torch.from_numpy(x).to(tdt), semiring)
    assert got.dtype == tdt
    got = got.float().numpy()
    if semiring == "plus_times":
        assert_within_bounds(want, cols, blocks, x, tdt)
        assert_within_bounds(got, cols, blocks, x, tdt)
    else:
        np.testing.assert_array_equal(got, want)
    for i in range(2):
        one = port_k.bsr_spmv_ref(
            torch.from_numpy(cols[i]), torch.from_numpy(blocks[i]).to(tdt),
            torch.from_numpy(x[i]).to(tdt), semiring).float().numpy()
        np.testing.assert_array_equal(one, got[i])


@pytest.mark.parametrize("fault", ["slot_skipped", "two_units_high"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_bounds_reject_planted_faults(dtype, fault):
    """The (+, ×) hold rejects a plain version that skips the first ELL
    slot, and one whose result is two units in the last place high."""
    rng = np.random.default_rng(18)
    tdt = getattr(torch, dtype)
    cols, blocks, x = random_layout(rng, "plus_times", p=2)
    blocks = torch.from_numpy(blocks).to(tdt).float().numpy()
    x = torch.from_numpy(x).to(tdt).float().numpy()
    args = (torch.from_numpy(cols), torch.from_numpy(blocks).to(tdt),
            torch.from_numpy(x).to(tdt))
    assert_within_bounds(port_k.bsr_spmv_ref(*args).float().numpy(),
                         cols, blocks, x, tdt)
    if fault == "slot_skipped":
        bad = port_k.bsr_spmv_ref(args[0][..., 1:], args[1][:, :, 1:],
                                  args[2])
    else:
        bad = port_k.bsr_spmv_ref(*args) * (1 + 2 * torch.finfo(tdt).eps)
    with pytest.raises(AssertionError):
        assert_within_bounds(bad.float().numpy(), cols, blocks, x, tdt)


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_plain_matches_reference_bsr(semiring):
    """Through both packages' host builders and dense oracles."""
    rng = np.random.default_rng(13)
    n, bm = 90, 16
    edges = rng.integers(0, n, size=(300, 2))
    vals = (rng.random(300) + 0.5).astype(np.float32)
    m_ref = ref_k.bsr_from_edges(edges, n, vals, block_size=bm,
                                 semiring=semiring)
    m = port_k.bsr_from_edges(edges, n, vals, block_size=bm,
                              semiring=semiring)
    np.testing.assert_array_equal(m.cols, m_ref.cols)
    np.testing.assert_array_equal(m.blocks, m_ref.blocks)
    x = (rng.random(n) < 0.5).astype(np.float32) if semiring == "or_and" \
        else rng.random(n).astype(np.float32)
    xp = np.zeros(m.padded, np.float32)
    xp[:n] = x
    got = port_spmv(m.cols, m.blocks, xp, semiring)[:n]
    want = np.asarray(ref_k.bsr_spmv_ref(m_ref, jnp.asarray(x)))
    assert_semiring_close(got, want, semiring)
    dense = port_k.dense_from_bsr(m)
    np.testing.assert_array_equal(dense, ref_k.dense_from_bsr(m_ref))
    np.testing.assert_allclose(
        got, port_k.dense_semiring_mv(dense.astype(np.float64), x, semiring),
        rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(14)
    cols, blocks, x = (torch.from_numpy(a)
                       for a in random_layout(rng, "plus_times", p=2))
    with pytest.raises(TypeError):
        port_k.bsr_spmv(cols.long(), blocks, x)
    with pytest.raises(TypeError):
        port_k.bsr_spmv(cols, blocks.double(), x)
    with pytest.raises(TypeError):
        port_k.bsr_spmv(cols, blocks, x.half())
    with pytest.raises(ValueError):
        port_k.bsr_spmv(cols, blocks[:, :, :, :8, :8], x)      # bm mismatch
    with pytest.raises(ValueError):
        port_k.bsr_spmv(cols, blocks, x[:, :-3])               # not bm-padded
    with pytest.raises(ValueError):
        port_k.bsr_spmv(cols, blocks, x[:1])                   # machine axis
    with pytest.raises(ValueError):
        port_k.bsr_spmv(cols[0], blocks, x)                    # rank mismatch
    with pytest.raises(ValueError):
        port_k.bsr_spmv(cols, blocks.transpose(-1, -2), x)     # contiguity
    with pytest.raises(ValueError):
        port_k.bsr_spmv(cols, blocks, x, "max_times")          # semiring


@pytest.fixture(scope="module")
def ref_runtime():
    from repro.bsp import PartitionRuntime
    from repro.core import scaled_paper_cluster, windgp
    from repro.data import rmat
    g = rmat(8, seed=5)
    cl = scaled_paper_cluster(2, 4, g.num_edges)
    return PartitionRuntime.build(g, windgp(g, cl, t0=2).assign, cl.p)


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_reference_layout_through_port_wrapper(ref_runtime, semiring):
    """A reference LocalBSR, moved by convert.py, through the wrapper."""
    bsr = ref_runtime.local_bsr(block_size=16, semiring=semiring,
                                weights="unit")
    moved = local_bsr_from_numpy(bsr.cols, bsr.blocks, bsr.gather,
                                 bsr.rank, block_size=16, semiring=semiring,
                                 fill_stats=bsr.fill_stats, device="cpu")
    assert moved.fill_stats == bsr.fill_stats
    rng = np.random.default_rng(16)
    x = (rng.random((bsr.p, bsr.padded)) < 0.5).astype(np.float32)
    if semiring == "min_plus":
        x = np.where(x > 0, rng.random(x.shape), np.inf).astype(np.float32)
    run = jax.vmap(lambda c, b, v: ref_k.spmv_pallas(
        c, b, v, block_size=16, interpret=True, semiring=semiring))
    want = np.asarray(run(jnp.asarray(bsr.cols), jnp.asarray(bsr.blocks),
                          jnp.asarray(x)))
    got = port_k.bsr_spmv(moved.cols, moved.blocks, torch.from_numpy(x),
                          semiring).numpy()
    assert_semiring_close(got, want, semiring)
