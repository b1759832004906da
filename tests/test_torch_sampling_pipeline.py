"""Port parity for the feature store, the halo cache and the prefetch
pipeline, against the JAX package on the CPU, bitwise.

``FeatureStore``/``HaloCache`` take no random bits, so a stream of
``gather`` calls over the reference's own minibatches must give the
reference's rows, ``FetchStats``, cache counters, hub ids and LRU order
exactly.  ``PrefetchPipeline`` derives batch ``i``'s generators from
``(seed, i)`` (the reference folds ``i`` into a ``jax.random`` key), so
it is held against the port's own service at every depth, as the
reference's tests hold the reference's.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import repro.sampling as ref
from repro.bsp import PartitionRuntime as RefRuntime
from repro.core import partitioners as ref_registry
from repro.core import scaled_paper_cluster as ref_cluster
from repro.data import rmat

import repro_torch.sampling as port
from repro_torch.bsp import PartitionRuntime

F = 8


@pytest.fixture(scope="module")
def svcs():
    g = rmat(8, edge_factor=8, seed=3)
    cl = ref_cluster(3, 6, g.num_edges)
    assign = ref_registry.get("hdrf")(g, cl)
    rsvc = ref.SamplingService(RefRuntime.create(g, assign=assign, p=cl.p))
    psvc = port.SamplingService(
        PartitionRuntime.create(g, assign=assign, p=cl.p, device="cpu"),
        device="cpu")
    return rsvc, psvc


@pytest.fixture(scope="module")
def stores(svcs):
    rsvc, psvc = svcs
    feats = np.random.default_rng(0).standard_normal(
        (psvc.csc.num_vertices, F)).astype(np.float32)
    return (ref.FeatureStore.build(rsvc, feats),
            port.FeatureStore.build(psvc, feats, device="cpu"), feats)


def ref_batches(rsvc, home, n, count, seed=7):
    """The reference's minibatches, as its own tests draw them."""
    key = jax.random.PRNGKey(seed)
    for b in range(count):
        k_seed, k_hop = jax.random.split(jax.random.fold_in(key, b))
        seeds = rsvc.local_seeds(home, n, k_seed)
        yield rsvc.sample(seeds, k_hop, home=home)


def cache_state(c):
    return (c.hits, c.misses, c.evictions, c.bytes_fetched, c.lru_ids(),
            c.hub_ids.tolist(), len(c), c.lru_capacity)


class TestFeatureStore:
    """``FeatureStore`` against ``repro.sampling.FeatureStore``."""

    def test_shards_bitwise(self, svcs, stores):
        rfs, pfs, feats = stores
        assert len(pfs.shards) == len(rfs.shards) == svcs[1].p
        for a, b in zip(pfs.shards, rfs.shards):
            assert a.dtype == torch.float32
            assert np.array_equal(a.numpy(), b)
        assert (pfs.feat_dim, pfs.row_bytes) == (rfs.feat_dim, rfs.row_bytes)
        assert np.array_equal(pfs.global_degree(), rfs.global_degree())

    def test_gather_global_bitwise(self, svcs, stores):
        rfs, pfs, _ = stores
        ids = np.array([-1, 0, 5, 5, 17, 255, -1, 3], np.int64)
        want = rfs.gather_global(ids)
        got = pfs.gather_global(torch.from_numpy(ids))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(pfs.gather_global(ids[:0]).numpy(),
                              rfs.gather_global(ids[:0]))

    def test_gather_out_of_range_raises(self, svcs, stores):
        _, pfs, _ = stores
        with pytest.raises(IndexError, match="below"):
            pfs.gather_global(np.array([svcs[1].csc.num_vertices]))

    @pytest.mark.parametrize("capacity,hub_frac", [
        (None, 0.0), (0, 0.5), (16, 0.0), (64, 0.5), (48, 1.0), (400, 0.25)])
    def test_gather_stream_bitwise(self, svcs, stores, capacity, hub_frac):
        """Rows, FetchStats and the whole cache state after every gather
        of a stream over evolving cache state."""
        rsvc, _ = svcs
        rfs, pfs, _ = stores
        home = 1
        rc = pc = None
        if capacity is not None:
            rc = ref.HaloCache.for_home(rfs, home, capacity, hub_frac)
            pc = port.HaloCache.for_home(pfs, home, capacity, hub_frac)
            assert cache_state(pc) == cache_state(rc)
        for mb in ref_batches(rsvc, home, 32, 5):
            ids = mb.all_ids()
            want, wst = rfs.gather(ids, home, rc)
            got, gst = pfs.gather(torch.from_numpy(ids), home, pc)
            assert np.array_equal(got.numpy(), want)
            assert dataclasses.astuple(gst) == dataclasses.astuple(wst)
            assert np.array_equal(got.numpy(),
                                  pfs.gather_global(ids).numpy())
            if pc is not None:
                assert cache_state(pc) == cache_state(rc)
                assert pc.hit_rate == rc.hit_rate
            assert gst.misses <= sum(s.fetched_unique for s in mb.hop_stats)

    def test_build_validates_shape(self, svcs):
        with pytest.raises(ValueError, match="num_vertices"):
            port.FeatureStore.build(svcs[1], np.zeros((3, 2), np.float32),
                                    device="cpu")

    def test_shards_disagree_raise(self, svcs):
        csc = svcs[1].csc
        shards = [np.zeros((1, 2), np.float32)] * (csc.p - 1) \
            + [np.zeros((1, 3), np.float32)]
        with pytest.raises(ValueError, match="feature shape"):
            port.FeatureStore(csc, shards, device="cpu")
        with pytest.raises(ValueError, match="shards"):
            port.FeatureStore(csc, shards[:1], device="cpu")


def both_caches(**kw):
    return ref.HaloCache(**kw), port.HaloCache(device="cpu", **kw)


class TestHaloCache:
    """``HaloCache`` against ``repro.sampling.HaloCache`` on the same
    operation sequence."""

    def test_lru_eviction_order(self):
        rows = {v: np.full(2, v, np.float32) for v in range(5)}
        caches = both_caches(capacity=3)
        seen = []
        for c in caches:
            for v in (0, 1, 2):
                c.insert(v, rows[v])
            trace = [c.lru_ids()]
            c.lookup(0)                       # refresh 0 -> 1 is now LRU
            trace.append(c.lru_ids())
            c.insert(3, rows[3])              # evicts 1
            trace.append((c.lru_ids(), 1 in c, c.evictions))
            c.insert(4, rows[4])              # evicts 2
            trace.append((c.lru_ids(), c.evictions))
            trace.append([np.asarray(c.lookup(v)).tolist() for v in (0, 3, 4)])
            seen.append(trace)
        assert seen[0] == seen[1]
        assert seen[1][2] == ([2, 0, 3], False, 1)

    def test_hub_tier_never_evicted(self):
        hub_rows = np.arange(4, dtype=np.float32).reshape(2, 2)
        states = []
        for c in both_caches(capacity=4, hub_ids=[10, 11],
                             hub_rows=hub_rows):
            assert c.lru_capacity == 2
            for v in range(20, 40):           # churn far past capacity
                c.insert(v, np.full(2, v, np.float32))
            assert 10 in c and 11 in c
            assert np.array_equal(np.asarray(c.lookup(10)), hub_rows[0])
            states.append((c.lru_ids(), c.evictions, len(c),
                           np.asarray(c.lookup(39)).tolist()))
        assert states[0] == states[1]

    def test_hub_hit_does_not_touch_lru_order(self):
        orders = []
        for c in both_caches(capacity=3, hub_ids=[99],
                             hub_rows=np.zeros((1, 2), np.float32)):
            c.insert(1, np.zeros(2, np.float32))
            c.insert(2, np.zeros(2, np.float32))
            c.insert(99, np.ones(2, np.float32))   # hubs ignore re-inserts
            c.lookup(99)
            orders.append((c.lru_ids(), np.asarray(c.lookup(99)).tolist()))
        assert orders[0] == orders[1] == ([1, 2], [0.0, 0.0])

    def test_repeated_hub_id_keeps_its_last_row(self):
        kw = dict(capacity=4, hub_ids=[7, 8, 7],
                  hub_rows=np.arange(6, dtype=np.float32).reshape(3, 2))
        a, b = both_caches(**kw)
        assert b.hub_ids.tolist() == a.hub_ids.tolist() == [7, 8]
        assert b.lru_capacity == a.lru_capacity == 2
        assert np.array_equal(b.lookup(7).numpy(), a.lookup(7))

    def test_reinsert_keeps_one_slot(self):
        states = []
        for c in both_caches(capacity=2):
            c.insert(1, np.zeros(2, np.float32))
            c.insert(2, np.zeros(2, np.float32))
            c.insert(1, np.ones(2, np.float32))
            c.insert(3, np.full(2, 3, np.float32))   # evicts 2
            states.append((c.lru_ids(), c.evictions,
                           np.asarray(c.lookup(1)).tolist()))
        assert states[0] == states[1] == ([1, 3], 1, [1.0, 1.0])

    def test_validation(self):
        with pytest.raises(ValueError, match="capacity"):
            port.HaloCache(capacity=-1, device="cpu")
        with pytest.raises(ValueError, match="exceed"):
            port.HaloCache(capacity=1, hub_ids=[1, 2],
                           hub_rows=np.zeros((2, 2)), device="cpu")
        with pytest.raises(ValueError, match="hub_rows"):
            port.HaloCache(capacity=4, hub_ids=[1, 2], device="cpu")

    @pytest.mark.parametrize("home", [0, 4])
    def test_for_home_hub_ids_bitwise(self, stores, home):
        rfs, pfs, _ = stores
        for capacity, frac in ((8, 1.0), (10, 0.5), (5, 0.0), (10_000, 1.0)):
            a = ref.HaloCache.for_home(rfs, home, capacity, frac)
            b = port.HaloCache.for_home(pfs, home, capacity, frac)
            assert b.hub_ids.tolist() == a.hub_ids.tolist()
            for v in b.hub_ids[:4]:
                assert np.array_equal(b.lookup(v).numpy(), a.lookup(v))
        with pytest.raises(ValueError, match="hub_frac"):
            port.HaloCache.for_home(pfs, home, 4, 1.5)


def stream(psvc, pfs, depth, num_batches=5, budget=48, with_store=True):
    cache = port.HaloCache.for_home(pfs, 0, capacity=budget) \
        if with_store else None
    with port.PrefetchPipeline(psvc, home=0, batch_size=16,
                               num_batches=num_batches, seed=13,
                               depth=depth,
                               store=pfs if with_store else None,
                               cache=cache) as pl:
        out = list(pl)
    return out, cache_state(cache) if with_store else None


def assert_minibatch_equal(a, b):
    assert torch.equal(a.seeds, b.seeds)
    assert len(a.hops) == len(b.hops)
    assert all(torch.equal(x, y) for x, y in zip(a.hops, b.hops))
    assert a.hop_stats == b.hop_stats and a.home == b.home


class TestPrefetchPipeline:
    @pytest.mark.parametrize("depth", [1, 4])
    def test_bitwise_deterministic_at_every_depth(self, svcs, stores,
                                                  depth):
        psvc = svcs[1]
        pfs = stores[1]
        (sync, st0), (deep, std) = (stream(psvc, pfs, 0),
                                    stream(psvc, pfs, depth))
        assert len(sync) == len(deep) == 5
        for (ma, fa), (mb, fb) in zip(sync, deep):
            assert_minibatch_equal(ma, mb)
            assert torch.equal(fa, fb)
        assert st0 == std     # same cache hit/miss/evict sequence
        assert st0[0] > 0

    def test_batch_i_is_the_service_sample(self, svcs, stores):
        """Batch ``i`` equals the service's own sample from
        ``batch_generators(seed, i)``, and its features the store's
        uncached gather."""
        psvc = svcs[1]
        pfs = stores[1]
        out, _ = stream(psvc, pfs, 2, num_batches=3)
        for i, (mb, feats) in enumerate(out):
            g_seed, g_hop = port.batch_generators(13, i, "cpu")
            seeds = psvc.local_seeds(0, 16, g_seed)
            assert_minibatch_equal(mb, psvc.sample(seeds, g_hop, home=0))
            assert torch.equal(feats, pfs.gather_global(mb.all_ids()))

    def test_no_store_yields_none_features(self, svcs, stores):
        out, _ = stream(svcs[1], stores[1], 2, with_store=False)
        assert len(out) == 5 and all(f is None for _, f in out)

    @pytest.mark.parametrize("stage", ["_resolve_features", "_sample_batch"])
    def test_worker_exception_propagates(self, svcs, stores, stage):
        class Boom(RuntimeError):
            pass

        pl = port.PrefetchPipeline(svcs[1], home=0, batch_size=16,
                                   num_batches=6, seed=1, depth=2,
                                   store=stores[1])

        def explode(*args):
            raise Boom(f"{stage} died")

        setattr(pl, stage, explode)
        with pytest.raises(Boom, match="died"):
            list(pl)
        assert not any(t.is_alive() for t in pl._threads or [])

    def test_mid_iteration_shutdown(self, svcs, stores):
        pl = port.PrefetchPipeline(svcs[1], home=0, batch_size=16,
                                   num_batches=50, seed=2, depth=2,
                                   store=stores[1])
        next(pl)
        next(pl)
        threads = list(pl._threads)
        pl.close()
        assert threads and not any(t.is_alive() for t in threads)
        assert not any(t.name.startswith("prefetch-")
                       for t in threading.enumerate())
        with pytest.raises(StopIteration):
            next(pl)

    def test_validation(self, svcs, stores):
        psvc = svcs[1]
        with pytest.raises(ValueError, match="depth"):
            port.PrefetchPipeline(psvc, home=0, batch_size=4,
                                  num_batches=1, seed=0, depth=-1)
        with pytest.raises(ValueError, match="num_batches"):
            port.PrefetchPipeline(psvc, home=0, batch_size=4,
                                  num_batches=-1, seed=0)
        with pytest.raises(ValueError, match="without store"):
            port.PrefetchPipeline(psvc, home=0, batch_size=4,
                                  num_batches=1, seed=0,
                                  cache=port.HaloCache(4, device="cpu"))
