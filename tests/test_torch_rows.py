"""The row layout (``LocalRows``) and the plain version of its kernel
(``bsr_spmv_rows_ref``) on the CPU.

The layout is held against an independent list of each machine's cells
(both directions of every local edge at its ranked (row, col), ⊕-merged),
its work units against the rows they must cover (each row of each machine
exactly once), and the plain version against the dense Block-ELL layout's
plain version (``bsr_spmv_ref``): bitwise under (min, +) and (or, and),
rtol 1e-5 in float32 (+, ×) (float32 sums reassociate), and in 16-bit
(+, ×) inside ``plus_times_bounds``, the interval any float32 order of a
column group's sum admits.  A star whose centre holds more than 10,000
entries makes CTA rows, warp rows and slices; a machine with no edges only
empty rows.  No JAX here: the parity with the reference's layout is
``tests/test_torch_host.py``'s.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.bsp import PartitionRuntime, pagerank
from repro_torch.core import from_edge_list, scaled_paper_cluster, windgp
from repro_torch.data import rmat
from repro_torch.kernels.bsr_spmv import (bsr_spmv_ref, bsr_spmv_rows,
                                          bsr_spmv_rows_ref, get_semiring,
                                          plus_times_bounds)
from repro_torch.kernels.bsr_spmv import rows as R

SEMIRINGS = ["plus_times", "min_plus", "or_and"]
DTYPES = ["float32", "bfloat16", "float16"]


@pytest.fixture(scope="module")
def rmat_rt():
    """``rmat(9)`` on WindGP's 6 machines, and a seventh with no edge."""
    g = rmat(9, seed=42)
    cl = scaled_paper_cluster(2, 4, g.num_edges)
    w = (np.random.default_rng(9).random(g.num_edges) + 0.1).astype(
        np.float32)
    return PartitionRuntime.create(g, assign=windgp(g, cl, t0=2).assign,
                                   p=cl.p + 1, edge_weights=w, device="cpu")


def star_graph(leaves: int = 10_500, extra: int = 30_000, seed: int = 3):
    """A star with ``leaves`` leaves around vertex 0, and ``extra`` random
    edges among the leaves."""
    rng = np.random.default_rng(seed)
    star = np.stack([np.zeros(leaves, dtype=np.int64),
                     np.arange(1, leaves + 1)], axis=1)
    # a power-law-ish spread of degrees among the leaves
    u = (rng.pareto(1.2, extra) * 10).astype(np.int64) % leaves + 1
    v = rng.integers(1, leaves + 1, extra)
    return from_edge_list(np.concatenate([star, np.stack([u, v], 1)]),
                          num_vertices=leaves + 1)


@pytest.fixture(scope="module")
def star_rt():
    g = star_graph()
    # the star's edges and half the rest on machine 0, the others on 1
    centre = (g.edges == 0).any(axis=1)
    assign = np.where(centre | (np.arange(g.num_edges) % 2 == 0), 0, 1)
    w = (np.random.default_rng(5).random(g.num_edges) + 0.1).astype(
        np.float32)
    return PartitionRuntime.create(g, assign=assign, p=2, edge_weights=w,
                                   device="cpu")


def cells_of(rt, i: int, rank: np.ndarray, semiring: str, weights: str):
    """Machine i's cells as a dict {(row, col): float32 value}: both
    directions of each local edge, at ranked positions, ⊕-merged."""
    sr = get_semiring(semiring)
    w = {"weight": rt.edge_weight[i], "unit": np.ones(rt.emax, np.float32),
         "zero": np.zeros(rt.emax, np.float32)}[weights]
    out = {}
    for (a, b), x, ok in zip(rt.local_edges[i], w, rt.edge_valid[i]):
        if not ok:
            continue
        for key in ((rank[a], rank[b]), (rank[b], rank[a])):
            prev = out.get(key, np.float32(sr.absent))
            out[key] = np.float32({"plus_times": lambda: prev + x,
                                   "min_plus": lambda: min(prev, x),
                                   "or_and": lambda: max(prev, x)}
                                  [sr.name]())
    return out


def layout_cells(rows, i: int) -> dict:
    pos, row = R.unit_entries(rows.units, rows.padded)
    c = rows.cols[pos]
    keep = (c >= 0) & (row // rows.padded == i)
    r = (row[keep] % rows.padded).tolist()
    return dict(zip(zip(r, c[keep].tolist()),
                    rows.vals[pos[keep]].float().numpy()))


def coverage(rows) -> torch.Tensor:
    """How often the units cover each of the p·n rows."""
    u = rows.units.long()
    word = u[:, 3] & 0xFFFFFFFF
    kind, length = word >> R.LEN_BITS, word & ((1 << R.LEN_BITS) - 1)
    first = torch.ones(len(u), dtype=torch.bool)
    first[1:] = (u[1:] != u[:-1]).any(dim=1)
    n = rows.padded
    hits = torch.zeros(rows.p * n, dtype=torch.int64)
    for (k, start, ln, f) in zip(kind.tolist(), u[:, 2].tolist(),
                                 length.tolist(), first.tolist()):
        if k in (R.ROW, R.CTA):
            hits[start] += int(f)
        else:
            count = R.SLICE_ROWS if k == R.SLICE else ln
            end = min(start + count, (start // n + 1) * n)
            hits[start:end] += 1
    return hits


def test_star_layout_has_every_kind_of_unit(star_rt):
    rows = star_rt.local_rows(block_size=128)
    st = rows.fill_stats
    assert st[0]["cta_rows"] >= 1 and st[0]["warp_rows"] >= 1
    assert st[0]["slices"] >= 1
    assert st[0]["entries"] > 2 * 10_000
    # the centre: rank 0 of machine 0, a CTA row of more than 10,000
    u = rows.units.long()
    kind = (u[:, 3] & 0xFFFFFFFF) >> R.LEN_BITS
    assert int(kind[0]) == R.CTA and int(u[0, 2]) == 0
    assert int(u[0, 3] & ((1 << R.LEN_BITS) - 1)) > 10_000
    assert (u[:R.CTA_WARPS] == u[0]).all()
    # padding stays within a sixth of the entries
    assert sum(s["padded_cells"] for s in st) <= sum(
        s["entries"] for s in st) / 6


@pytest.mark.parametrize("which", ["rmat", "star"])
def test_units_cover_every_row_once(rmat_rt, star_rt, which):
    rt = rmat_rt if which == "rmat" else star_rt
    for bm in (16, 128):
        rows = rt.local_rows(block_size=bm, semiring="min_plus")
        assert rows.padded == -(-rt.vmax // bm) * bm
        assert bool((coverage(rows) == 1).all())
        # the CTA rows first, each as many times as a CTA has warps
        kind = (rows.units[:, 3].long() & 0xFFFFFFFF) >> R.LEN_BITS
        ctas = int((kind == R.CTA).sum())
        assert ctas % R.CTA_WARPS == 0 and bool((kind[:ctas] == R.CTA).all())


@pytest.mark.parametrize("weights", ["weight", "unit", "zero"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_layout_cells_are_the_merged_edges(star_rt, semiring, weights):
    rows = star_rt.local_rows(block_size=128, semiring=semiring,
                              weights=weights)
    for i in range(star_rt.p):
        rank = rows.rank[i].numpy()
        want = cells_of(star_rt, i, rank, semiring, weights)
        got = layout_cells(rows, i)
        assert got.keys() == want.keys()
        assert all(got[k] == want[k] for k in want)
    # rows ascend by column within every unit
    pos, row = R.unit_entries(rows.units, rows.padded)
    c = rows.cols[pos]
    keep = c >= 0
    key = row[keep] * rows.padded + c[keep]
    order = torch.argsort(pos[keep])
    by_row = torch.argsort(row[keep][order], stable=True)
    assert bool((key[order][by_row].diff() > 0).all())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_values_are_the_float32_values_rounded_once(rmat_rt, dtype):
    kw = dict(block_size=32, semiring="plus_times", weights="weight")
    f32 = rmat_rt.local_rows(**kw)
    low = rmat_rt.local_rows(**kw, dtype=dtype)
    assert low.vals.dtype == getattr(torch, dtype)
    assert torch.equal(low.vals, f32.vals.to(low.vals.dtype))
    assert torch.equal(low.units, f32.units)
    assert torch.equal(low.cols, f32.cols)


def inputs(gen, semiring: str, shape, dtype: str) -> torch.Tensor:
    x = torch.rand(shape, generator=gen)
    if semiring == "or_and":
        x = (x < 0.5).float()
    elif semiring == "min_plus":
        x[torch.rand(shape, generator=gen) < 0.2] = float("inf")
    return x.to(getattr(torch, dtype))


def test_machine_without_edges_has_only_empty_rows(rmat_rt):
    rows = rmat_rt.local_rows(block_size=32)
    last = rows.fill_stats[-1]
    assert last["entries"] == 0 and last["rows"] == 0
    assert last["fill_rows"] == rows.padded


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_plain_version_matches_the_dense_plain_version(rmat_rt, semiring,
                                                       dtype):
    kw = dict(block_size=32, semiring=semiring, weights="weight",
              dtype=dtype)
    rows, dense = rmat_rt.local_rows(**kw), rmat_rt.local_bsr(**kw)
    x = inputs(torch.Generator().manual_seed(1), semiring,
               (rmat_rt.p, rows.padded), dtype)
    got = bsr_spmv_rows(rows.units, rows.cols, rows.vals, x, semiring, 32)
    assert got.dtype == x.dtype and got.shape == x.shape
    want = bsr_spmv_ref(dense.cols, dense.blocks, x, semiring)
    if semiring != "plus_times":
        assert torch.equal(got, want)
    elif dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    else:
        for lo, hi in (plus_times_bounds(dense.cols, dense.blocks, x),
                       R.plus_times_bounds_rows(rows.units, rows.cols,
                                                rows.vals, x, 32)):
            assert bool(((lo <= got) & (got <= hi)).all())
            assert bool(((lo <= want) & (want <= hi)).all())
    # the machine without edges gives the ⊕ identity
    assert bool((got[-1].float() == get_semiring(semiring).zero).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_plain_version_on_the_star(star_rt, semiring, dtype):
    """The star's dense layout would take gigabytes: its product is held
    against the cells' own ⊕ of products."""
    kw = dict(block_size=128, semiring=semiring, dtype=dtype)
    rows = star_rt.local_rows(**kw)
    sr = get_semiring(semiring)
    x = inputs(torch.Generator().manual_seed(2), semiring,
               (star_rt.p, rows.padded), dtype)
    got = bsr_spmv_rows(rows.units, rows.cols, rows.vals, x, semiring, 128)
    if semiring == "plus_times" and dtype != "float32":
        lo, hi = R.plus_times_bounds_rows(rows.units, rows.cols, rows.vals,
                                          x, 128)
        assert bool(((lo <= got) & (got <= hi)).all())
        assert int((lo != hi).sum()) < got.numel() // 10
        return
    want = torch.full((star_rt.p, rows.padded), sr.zero)
    for i in range(star_rt.p):
        cells = cells_of(star_rt, i, rows.rank[i].numpy(), semiring,
                         "weight")
        r, c = (torch.tensor(k) for k in zip(*cells))
        v = torch.tensor(list(cells.values())).to(x.dtype).float()
        prod = sr.times(v, x[i].float()[c])
        if semiring == "plus_times":
            want[i].index_add_(0, r, prod)
        else:
            want[i].scatter_reduce_(0, r, prod, sr.reduce)
    if semiring == "plus_times":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got, want.to(x.dtype))


def one_row(cols, vals, dtype=torch.bfloat16):
    """A layout of one row (a warp's unit) and x of ones."""
    word = np.array([[0, 0, 0, (R.ROW << R.LEN_BITS) | len(cols)]],
                    dtype=np.uint32)
    return (torch.from_numpy(word.view(np.int32)),
            torch.tensor(cols, dtype=torch.int32),
            torch.tensor(vals, dtype=dtype),
            torch.ones((1, 4), dtype=dtype))


@pytest.mark.parametrize("cols,vals,bm,want", [
    # a group's float32 sum rounds once: 2^-8 + 2^-8 then 1 + 2^-7 ...
    ([0, 2, 3], [1.0, 2 ** -8, 2 ** -8], 2, 1 + 2 ** -7),
    ([0, 2, 3], [1.0, 2 ** -8, 2 ** -8], 4, 1 + 2 ** -7),
    # ... where a fold of each entry ties to even at 1 twice
    ([0, 2, 3], [1.0, 2 ** -8, 2 ** -8], 1, 1.0),
    # groups fold in ascending order: 2^-8, 2^-7, then 1 + 2^-7
    ([0, 1, 2], [2 ** -8, 2 ** -8, 1.0], 1, 1 + 2 ** -7),
    ([0, 1, 2], [1.0, 2 ** -8, 2 ** -8], 1, 1.0)])
def test_plain_version_folds_16bit_groups_in_order(cols, vals, bm, want):
    units, c, v, x = one_row(cols, vals)
    y = bsr_spmv_rows_ref(units, c, v, x, "plus_times", block_size=bm)
    assert float(y[0, 0]) == want
    # float32 folds nothing: one float32 sum
    units, c, v, x = one_row(cols, vals, torch.float32)
    y = bsr_spmv_rows_ref(units, c, v, x, "plus_times", block_size=bm)
    assert float(y[0, 0]) == 1 + 2 ** -7


def test_layout_is_built_once_and_counted(rmat_rt):
    kw = dict(block_size=16, semiring="or_and", weights="unit")
    rmat_rt.clear_bsr_cache()
    before = obs.snapshot()
    rows = rmat_rt.local_rows(**kw)
    assert rmat_rt.local_rows(**kw) is rows
    d = obs.delta(obs.snapshot(), before)
    assert d["spans"]["layout.host"]["count"] == 1
    assert d["spans"]["layout.device"]["count"] == 1
    assert d["counters"]["layout.bytes"] == rows.nbytes
    rmat_rt.clear_bsr_cache()
    assert rmat_rt.local_rows(**kw) is not rows


def test_pallas_backend_builds_only_the_row_layout(rmat_rt):
    rmat_rt.clear_bsr_cache()
    before = bsr_spmv_rows.launches
    pr, _ = pagerank(rmat_rt, num_iters=5, backend="pallas", block_size=32)
    pr_s, _ = pagerank(rmat_rt, num_iters=5, backend="scatter")
    np.testing.assert_allclose(pr, pr_s, atol=1e-6, rtol=1e-5)
    # the row layout and the apps' static tree; no dense layout
    assert sorted(k[0] for k in rmat_rt._bsr_cache) == ["rows", "tree"]
    assert bsr_spmv_rows.launches == before        # plain calls count none
