"""Port tests that need a CUDA device: the hand-written kernel against its
plain version, and the device-built layout and PageRank against the same
code on the CPU.  They skip where ``torch.cuda.is_available()`` is False.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: (min, +) and (or, and) bitwise; (+, ×) rtol=1e-5 (float32
sums reassociate); PageRank atol=1e-6, rtol=1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.bsp import PartitionRuntime, pagerank
from repro_torch.core import scaled_paper_cluster, windgp
from repro_torch.data import rmat
from repro_torch.kernels import bsr_spmv as port_k

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def random_layout(rng, semiring, p=3, R=16, K=5, C=16, bm=128):
    sr = port_k.get_semiring(semiring)
    cols = rng.integers(0, C, size=(p, R, K)).astype(np.int32)
    keep = rng.random((p, R, K, bm, bm)) < 0.3
    if semiring == "or_and":
        blocks = keep.astype(np.float32)
        x = (rng.random((p, C * bm)) < 0.5).astype(np.float32)
    else:
        blocks = np.where(keep, rng.random(keep.shape), sr.absent)
        blocks = blocks.astype(np.float32)
        x = rng.random((p, C * bm)).astype(np.float32)
        if semiring == "min_plus":
            x[rng.random(x.shape) < 0.2] = np.inf
    cols[:, ::2, -1] = 0
    blocks[:, ::2, -1] = sr.absent
    return cols, blocks, x


@pytest.mark.parametrize("bm", [128, 30])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
def test_kernel_matches_plain(cuda, semiring, bm):
    rng = np.random.default_rng(15)
    cols, blocks, x = (torch.from_numpy(a).to(cuda)
                       for a in random_layout(rng, semiring, bm=bm))
    before = port_k.bsr_spmv.launches
    got = port_k.bsr_spmv(cols, blocks, x, semiring)
    torch.cuda.synchronize()
    assert port_k.bsr_spmv.launches == before + 1
    want = port_k.bsr_spmv_ref(cols, blocks, x, semiring)
    if semiring == "plus_times":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got, want)
    # without the machine axis
    got0 = port_k.bsr_spmv(cols[1].contiguous(), blocks[1].contiguous(),
                           x[1].contiguous(), semiring)
    assert torch.equal(got0, got[1])


@pytest.fixture
def runtimes(cuda):
    g = rmat(10, seed=42)
    cl = scaled_paper_cluster(2, 4, g.num_edges)
    assign = windgp(g, cl, t0=2).assign
    w = (np.random.default_rng(7).random(g.num_edges) + 0.1).astype(
        np.float32)
    return [PartitionRuntime.create(g, assign=assign, p=cl.p,
                                    edge_weights=w, device=d)
            for d in ("cpu", cuda)]


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
def test_device_built_layout_matches_cpu(runtimes, semiring):
    on_cpu, on_gpu = (rt.local_bsr(block_size=32, semiring=semiring)
                      for rt in runtimes)
    assert torch.equal(on_gpu.blocks.cpu(), on_cpu.blocks)
    assert torch.equal(on_gpu.cols.cpu(), on_cpu.cols)


def test_pagerank_pallas_matches_scatter(runtimes):
    _, rt = runtimes
    launches = port_k.bsr_spmv.launches
    pr, act = pagerank(rt, num_iters=10, backend="pallas", block_size=32)
    assert port_k.bsr_spmv.launches == launches + 10
    pr_s, _ = pagerank(rt, num_iters=10, backend="scatter")
    pr_cpu, _ = pagerank(runtimes[0], num_iters=10, backend="scatter")
    np.testing.assert_allclose(pr, pr_s, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(pr, pr_cpu, atol=1e-6, rtol=1e-5)
    assert act.shape == (10, rt.p)
