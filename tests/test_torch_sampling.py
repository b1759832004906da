"""Port parity for partitioned GNN sampling: ``MachineCSC``, the fanout
hop and the k-hop service, against the JAX package on the CPU, bitwise.

The port draws its random bits from ``torch.Generator``; the reference
from ``jax.random`` (threefry).  So every comparison here carries the
reference's own draws across as arrays: a hop's uniforms are
``jax.random.uniform(sub, shape)`` on the hop keys the reference splits
(``SamplingService._hop_keys``), and a seed draw is
``jax.random.permutation(key, pool)``.  Each test names the reference
function it holds against.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.sampling as ref
from repro.bsp import PartitionRuntime as RefRuntime
from repro.bsp import StreamAssignment as RefAssignment
from repro.core import from_edge_list as ref_from_edge_list
from repro.core import partitioners as ref_registry
from repro.core import scaled_paper_cluster as ref_cluster
from repro.core.partition_state import \
    edge_incidence_counts as ref_incidence
from repro.data import rmat

import repro_torch.sampling as port
from repro_torch.bsp import PartitionRuntime, StreamAssignment
from repro_torch.core import from_edge_list, scaled_paper_cluster
from repro_torch.core.partition_state import edge_incidence_counts

CSC_FIELDS = ("owner", "row", "owned_gid", "deg", "indptr", "nbr",
              "owned_per")


@pytest.fixture(scope="module")
def small():
    """The reference sampling tests' graph, on the default cluster's
    shape, with an HDRF assignment from the reference registry."""
    g = rmat(8, edge_factor=8, seed=3)
    cl = scaled_paper_cluster(3, 6, g.num_edges)
    assign = ref_registry.get("hdrf")(g, ref_cluster(3, 6, g.num_edges))
    return g, cl, assign


@pytest.fixture(scope="module")
def services(small):
    g, cl, assign = small
    rsvc = ref.SamplingService(RefRuntime.create(g, assign=assign, p=cl.p))
    psvc = port.SamplingService(
        PartitionRuntime.create(g, assign=assign, p=cl.p, device="cpu"),
        device="cpu")
    return rsvc, psvc


def stats_tuple(mb):
    return [dataclasses.astuple(s) for s in mb.hop_stats]


def ref_draws(rsvc, key, n):
    """The uniforms the reference draws inside ``sample(seeds, key)``,
    one array a hop, in the shapes the port's service expects."""
    widths = [f if rsvc.replace else max(rsvc.csc.max_degree, f)
              for f in rsvc.fanouts]
    rows, out = n, []
    for sub, fanout, width in zip(rsvc._hop_keys(key), rsvc.fanouts,
                                  widths):
        out.append(np.array(jax.random.uniform(sub, (rows, width))))
        rows *= fanout
    return out


def ref_seeds(rsvc, psvc, home, n, key, train_mask=None):
    """The reference's ``local_seeds`` and the port's on the reference's
    permutation of the same pool."""
    want = rsvc.local_seeds(home, n, key, train_mask)
    pool = psvc._seed_pool(home, train_mask)
    got = (psvc.local_seeds_from_perm(
        home, n, np.array(jax.random.permutation(key, len(pool))),
        train_mask) if len(pool) else psvc.local_seeds_from_perm(
            home, n, np.empty(0, np.int64), train_mask))
    return want, got


def assert_csc_equal(a, b):
    assert (a.p, a.num_vertices) == (b.p, b.num_vertices)
    for f in CSC_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(a.flat_rowmap(), b.flat_rowmap())


class TestMachineCSC:
    """``MachineCSC.build`` / ``from_stream`` against the reference's."""

    @pytest.mark.parametrize("route", ["assign", "method", "windgp"])
    def test_fields_bitwise(self, small, route):
        g, cl, assign = small
        rcl = ref_cluster(3, 6, g.num_edges)
        if route == "assign":
            a = RefRuntime.create(g, assign=assign, cluster=rcl)
            b = PartitionRuntime.create(g, assign=assign, cluster=cl,
                                        device="cpu")
        else:
            method = "hdrf" if route == "method" else "windgp"
            a = RefRuntime.create(g, method=method, cluster=rcl)
            b = PartitionRuntime.create(g, method=method, cluster=cl,
                                        device="cpu")
        assert_csc_equal(ref.MachineCSC.build(a), port.MachineCSC.build(b))

    def test_stream_route_bitwise(self, small, tmp_path):
        g, cl, assign = small
        out = {}
        for name, sa_cls, incidence, csc_cls, kw in (
                ("ref", RefAssignment, ref_incidence, ref.MachineCSC, {}),
                ("port", StreamAssignment, edge_incidence_counts,
                 port.MachineCSC, {"device": "cpu"})):
            sa = sa_cls(tmp_path / name, cl.p, g.num_vertices)
            sa.sink(g.edges, assign)
            sa.finalize(incidence(g, assign, cl.p) > 0, {"method": "hdrf"})
            out[name] = csc_cls.from_stream(tmp_path / name, **kw)
        assert_csc_equal(out["ref"], out["port"])
        assert_csc_equal(out["port"], port.MachineCSC.build(
            PartitionRuntime.create(g, assign=assign, p=cl.p,
                                    device="cpu")))

    def test_isolated_vertex_owner_is_minus_one(self):
        edges = np.array([[0, 1], [1, 2]])
        a = ref.MachineCSC.build(RefRuntime.create(
            ref_from_edge_list(edges, num_vertices=5),
            assign=np.zeros(2, np.int32), p=1))
        b = port.MachineCSC.build(PartitionRuntime.create(
            from_edge_list(edges, num_vertices=5),
            assign=np.zeros(2, np.int32), p=1, device="cpu"))
        assert_csc_equal(a, b)
        assert (b.owner[3:] == -1).all() and (b.owner[:3] == 0).all()


def hop_rows(psvc, rng):
    """Every vertex's flat row (-1 for isolated ones), the zero-degree
    pad rows of every machine's table, explicit -1 rows, shuffled."""
    csc = psvc.csc
    pad = [i * csc.omax + r for i in range(csc.p)
           for r in range(int(csc.owned_per[i]), csc.omax)]
    rows = np.concatenate([csc.flat_rowmap(), np.asarray(pad, np.int32),
                           np.full(5, -1, np.int32)]).astype(np.int32)
    return rows[rng.permutation(len(rows))]


class TestFanoutHop:
    """``fanout_hop`` against ``repro.sampling.sample_fanout`` (both of
    its lowerings) and against ``sample_fanout_np``."""

    @pytest.mark.parametrize("fanout", [6, "D+3"])
    @pytest.mark.parametrize("select", ["sort", "top_k"])
    @pytest.mark.parametrize("replace", [False, True])
    def test_bitwise_vs_reference(self, services, replace, select, fanout):
        rsvc, psvc = services
        D = psvc.csc.max_degree
        fanout = D + 3 if fanout == "D+3" else fanout
        rows = hop_rows(psvc, np.random.default_rng(1))
        key = jax.random.PRNGKey(7)
        width = port.hop_width(D, fanout, replace)
        u = np.array(jax.random.uniform(key, (len(rows), width)))
        got = port.fanout_hop(psvc._table, psvc._deg, torch.from_numpy(rows),
                              torch.from_numpy(u), fanout, replace,
                              select).numpy()
        assert got.dtype == np.int32 and got.shape == (len(rows), fanout)
        for ref_select in ("top_k", "sort"):
            want = np.asarray(ref.sample_fanout(
                rsvc._table, rsvc._deg, rows, key, fanout, replace=replace,
                select=ref_select))
            assert np.array_equal(got, want), ref_select
        assert np.array_equal(got, port.sample_fanout_np(
            psvc._table.numpy(), psvc._deg.numpy(), rows, u, fanout,
            replace=replace))
        # the case list really holds what it claims
        d = np.where(rows >= 0, psvc.csc.deg.reshape(-1)[rows], 0)
        assert (rows < 0).any() and ((rows >= 0) & (d == 0)).any()
        assert ((d > 0) & (d < fanout)).any()

    @pytest.mark.parametrize("replace", [False, True])
    def test_sample_fanout_draws_from_generator(self, services, replace):
        _, psvc = services
        rows = psvc.csc.flat_rowmap()
        gen = torch.Generator().manual_seed(3)
        got = port.sample_fanout(psvc._table, psvc._deg, rows, 5,
                                 generator=gen, replace=replace)
        width = port.hop_width(psvc.csc.max_degree, 5, replace)
        u = torch.rand((len(rows), width),
                       generator=torch.Generator().manual_seed(3))
        assert torch.equal(got, port.fanout_hop(
            psvc._table, psvc._deg, torch.from_numpy(rows), u, 5, replace))
        assert np.array_equal(got.numpy(), port.sample_fanout_np(
            psvc._table.numpy(), psvc._deg.numpy(), rows, u.numpy(), 5,
            replace=replace))

    def test_samples_are_true_neighbors_no_dups(self, small, services):
        g, _, _ = small
        _, psvc = services
        nbrs = {v: set() for v in range(g.num_vertices)}
        for a, b in g.edges.tolist():
            nbrs[a].add(b)
            nbrs[b].add(a)
        rows = psvc.csc.flat_rowmap()
        got = port.sample_fanout(psvc._table, psvc._deg, rows, 6,
                                 generator=torch.Generator().manual_seed(0))
        for v, row in enumerate(got.numpy()):
            picked = row[row >= 0].tolist()
            assert set(picked) <= nbrs[v]
            assert len(picked) == len(set(picked)) == min(len(nbrs[v]), 6)

    def test_bad_arguments_raise(self, services):
        _, psvc = services
        rows = torch.zeros(4, dtype=torch.int32)
        u = torch.zeros((4, psvc.csc.max_degree))
        with pytest.raises(ValueError, match="select"):
            port.fanout_hop(psvc._table, psvc._deg, rows, u, 3, False,
                            "argsort")
        with pytest.raises(ValueError, match="float32"):
            port.fanout_hop(psvc._table, psvc._deg, rows, u[:, :3], 3,
                            False)


class TestService:
    """``SamplingService.sample_khop`` / ``local_seeds_from_perm``
    against ``repro.sampling.SamplingService.sample`` /
    ``local_seeds``."""

    @pytest.mark.parametrize("fused", [True, False])
    @pytest.mark.parametrize("replace", [False, True])
    def test_sample_bitwise_vs_reference(self, services, replace, fused):
        rsvc0, psvc0 = services
        rsvc = ref.SamplingService(rsvc0.csc, fanouts=(6, 4, 3),
                                   replace=replace)
        psvc = port.SamplingService(psvc0.csc, fanouts=(6, 4, 3),
                                    replace=replace, device="cpu")
        key = jax.random.PRNGKey(9)
        for home in range(psvc.p):
            want_seeds, seeds = ref_seeds(rsvc, psvc, home, 24,
                                          jax.random.fold_in(key, home))
            assert np.array_equal(want_seeds, seeds)
            k_hop = jax.random.fold_in(key, 100 + home)
            want = rsvc.sample(want_seeds, k_hop, home=home, fused=fused)
            got = psvc.sample_khop(seeds, ref_draws(rsvc, k_hop, len(seeds)),
                                   home=home, fused=fused)
            assert np.array_equal(got.seeds.numpy(), want.seeds)
            for h, (a, b) in enumerate(zip(got.hops, want.hops)):
                assert a.dtype == torch.int32
                assert np.array_equal(a.numpy(), b), h
            assert stats_tuple(got) == stats_tuple(want)
            assert got.home == home
        assert any(s.fetched_unique > 0 for s in got.hop_stats)

    @pytest.mark.parametrize("replace", [False, True])
    def test_fused_bitwise_equals_loop(self, services, replace):
        _, psvc0 = services
        psvc = port.SamplingService(psvc0.csc, fanouts=(6, 4, 3),
                                    replace=replace, device="cpu")
        gen = torch.Generator().manual_seed(5)
        seeds = psvc.local_seeds(0, 24, gen)
        us = psvc.draw_uniforms(len(seeds), gen)
        a = psvc.sample_khop(seeds, us, home=0, fused=True)
        b = psvc.sample_khop(seeds, us, home=0, fused=False)
        assert all(torch.equal(x, y) for x, y in zip(a.hops, b.hops))
        assert a.hop_stats == b.hop_stats

    def test_without_home_vs_reference(self, services):
        rsvc, psvc = services
        key = jax.random.PRNGKey(3)
        want_seeds, seeds = ref_seeds(rsvc, psvc, 1, 16, key)
        k_hop = jax.random.fold_in(key, 2)
        want = rsvc.sample(want_seeds, k_hop)
        for fused in (True, False):
            got = psvc.sample_khop(seeds, ref_draws(rsvc, k_hop, len(seeds)),
                                   fused=fused)
            assert all(np.array_equal(a.numpy(), b)
                       for a, b in zip(got.hops, want.hops))
            assert stats_tuple(got) == stats_tuple(want)
            assert all(s.halo == 0 and s.fetched_unique == 0
                       for s in got.hop_stats)

    @pytest.mark.parametrize("masked", [False, True])
    def test_local_seeds_vs_reference(self, small, services, masked):
        g, cl, _ = small
        rsvc, psvc = services
        mask = (np.random.default_rng(4).random(g.num_vertices) < 0.5
                if masked else None)
        for home in range(cl.p):
            for n in (1, 8, 10_000):
                want, got = ref_seeds(rsvc, psvc, home, n,
                                      jax.random.PRNGKey(home), mask)
                assert got.dtype == np.int32 and np.array_equal(got, want)

    def test_sample_draws_in_hop_order(self, services):
        _, psvc = services
        seeds = psvc.local_seeds(2, 12, torch.Generator().manual_seed(1))
        a = psvc.sample(seeds, torch.Generator().manual_seed(8), home=2)
        us = psvc.draw_uniforms(len(seeds), torch.Generator().manual_seed(8))
        b = psvc.sample_khop(seeds, us, home=2)
        assert all(torch.equal(x, y) for x, y in zip(a.hops, b.hops))
        assert [u.shape for u in us] == [
            (12, psvc.csc.max_degree), (120, psvc.csc.max_degree)]

    def test_local_seeds_draw_a_permutation(self, services):
        _, psvc = services
        pool = psvc._seed_pool(0, None)
        a = psvc.local_seeds(0, len(pool), torch.Generator().manual_seed(2))
        b = psvc.local_seeds(0, len(pool), torch.Generator().manual_seed(2))
        assert np.array_equal(a, b)
        assert np.array_equal(np.sort(a), np.sort(pool))

    def test_bitwise_across_create_routes(self, small, tmp_path):
        g, cl, assign = small
        sa = StreamAssignment(tmp_path / "assign", cl.p, g.num_vertices)
        sa.sink(g.edges, assign)
        sa.finalize(edge_incidence_counts(g, assign, cl.p) > 0,
                    {"method": "hdrf"})
        batches = []
        for source_kw in (dict(source=g, assign=assign, cluster=cl),
                          dict(source=g, assign=assign, p=cl.p),
                          dict(source=sa)):
            svc = port.SamplingService.create(fanouts=(5, 3), device="cpu",
                                              **source_kw)
            seeds = svc.local_seeds(0, 16, torch.Generator().manual_seed(2))
            batches.append(svc.sample(seeds, torch.Generator().manual_seed(3),
                                      home=0))
        for mb in batches[1:]:
            assert torch.equal(mb.seeds, batches[0].seeds)
            assert all(torch.equal(a, b)
                       for a, b in zip(mb.hops, batches[0].hops))
            assert mb.hop_stats == batches[0].hop_stats

    def test_all_ids_layout(self, services):
        _, psvc = services
        seeds = psvc.local_seeds(0, 8, torch.Generator().manual_seed(5))
        mb = psvc.sample(seeds, torch.Generator().manual_seed(1), home=0)
        ids = mb.all_ids()
        assert ids.dtype == torch.int32
        assert len(ids) == len(seeds) + sum(h.numel() for h in mb.hops)
        assert np.array_equal(ids[:len(seeds)].numpy(), seeds)

    def test_bad_uniforms_raise(self, services):
        _, psvc = services
        us = psvc.draw_uniforms(4, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="hop_uniforms"):
            psvc.sample_khop(np.arange(3), us)
        with pytest.raises(ValueError, match="hop_uniforms"):
            psvc.sample_khop(np.arange(4), us[:1])

    def test_cuda_default_raises_without_gpu(self, services):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is valid")
        _, psvc = services
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.SamplingService(psvc.csc)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.HaloCache(4)


class TestEdgeCases:
    """The reference's edge cases (``tests/test_sampling.py``), each
    against the reference's own result where it has one."""

    def test_empty_frontier(self, services):
        rsvc, psvc = services
        want = rsvc.sample(np.empty(0, np.int32), jax.random.PRNGKey(0),
                           home=0)
        us = [np.zeros(s, np.float32) for s in psvc.hop_shapes(0)]
        for fused in (True, False):
            got = psvc.sample_khop(np.empty(0, np.int32), us, home=0,
                                   fused=fused)
            assert all(h.numel() == 0 for h in got.hops)
            assert stats_tuple(got) == stats_tuple(want) == [(0, 0, 0)] * 2

    def test_isolated_seed_samples_all_pad(self):
        edges = np.array([[0, 1]])
        rsvc = ref.SamplingService(RefRuntime.create(
            ref_from_edge_list(edges, num_vertices=4),
            assign=np.zeros(1, np.int32), p=1), fanouts=(3, 2))
        psvc = port.SamplingService(PartitionRuntime.create(
            from_edge_list(edges, num_vertices=4),
            assign=np.zeros(1, np.int32), p=1, device="cpu"),
            fanouts=(3, 2), device="cpu")
        seeds = np.array([2, 3], np.int32)
        key = jax.random.PRNGKey(0)
        want = rsvc.sample(seeds, key, home=0)
        for fused in (True, False):
            got = psvc.sample_khop(seeds, ref_draws(rsvc, key, 2), home=0,
                                   fused=fused)
            assert all((h == -1).all() for h in got.hops)
            assert got.num_sampled() == 0
            assert stats_tuple(got) == stats_tuple(want)

    def test_out_of_range_seed_raises(self, small, services):
        g, _, _ = small
        _, psvc = services
        with pytest.raises(ValueError, match="seed ids"):
            psvc.sample(np.array([g.num_vertices], np.int32),
                        torch.Generator())

    def test_seed_below_minus_one_raises(self, services):
        _, psvc = services
        with pytest.raises(ValueError, match="pad lane"):
            psvc.sample(np.array([0, -2], np.int32), torch.Generator())
        with pytest.raises(ValueError, match="pad lane"):
            psvc.sample_khop(torch.tensor([0, -2], dtype=torch.int32), [])

    def test_pad_lane_seed_vs_reference(self, services):
        rsvc, psvc = services
        seeds = np.array([-1, int(psvc.csc.owned_gid[0, 0]), -1], np.int32)
        key = jax.random.PRNGKey(6)
        want = rsvc.sample(seeds, key, home=0)
        got = psvc.sample_khop(seeds, ref_draws(rsvc, key, 3), home=0)
        assert all(np.array_equal(a.numpy(), b)
                   for a, b in zip(got.hops, want.hops))
        assert (got.hops[0][:rsvc.fanouts[0]] == -1).all()

    def test_local_seeds_undersized_pool_returns_whole_pool(self, small,
                                                            services):
        g, _, _ = small
        rsvc, psvc = services
        pool = int(psvc.csc.owned_per[0])
        want, got = ref_seeds(rsvc, psvc, 0, pool + 100,
                              jax.random.PRNGKey(4))
        assert len(got) == pool and np.array_equal(got, want)
        drawn = psvc.local_seeds(0, pool + 100,
                                 torch.Generator().manual_seed(4))
        assert np.array_equal(np.sort(drawn),
                              np.sort(psvc.csc.owned_gid[0][:pool]))
        mask = np.zeros(g.num_vertices, bool)
        mask[psvc.csc.owned_gid[0][:3]] = True
        want, got = ref_seeds(rsvc, psvc, 0, 50, jax.random.PRNGKey(4),
                              mask)
        assert len(got) == 3 and np.array_equal(got, want)
        empty = np.zeros(g.num_vertices, bool)
        assert len(psvc.local_seeds(0, 5, torch.Generator(), empty)) == 0

    def test_bad_perm_raises(self, services):
        _, psvc = services
        with pytest.raises(ValueError, match="perm"):
            psvc.local_seeds_from_perm(0, 4, np.arange(3))

    @pytest.mark.parametrize("fanouts", [(5, 0), (), (-1,)])
    def test_bad_fanouts_raise(self, services, fanouts):
        _, psvc = services
        with pytest.raises(ValueError, match="fanouts"):
            port.SamplingService(psvc.csc, fanouts=fanouts, device="cpu")
