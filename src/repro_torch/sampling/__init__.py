"""Partitioned GNN minibatch sampling over the BSP runtime's shards.

Full-graph BSP sweeps touch every edge every superstep; GNN training hits
the same partition with k-hop *neighbor sampling* — many small frontier
expansions against machine-local adjacency, where every frontier vertex
owned by another machine is a cross-machine ("halo") fetch.  This package
makes partition quality directly observable on that workload:

* :mod:`~repro_torch.sampling.machine_csc` — per-machine CSC adjacency
  packed one shard at a time from the runtime/stream state (host numpy,
  with the degree-sorted local relabeling idiom of
  :class:`~repro_torch.bsp.partition_runtime.LocalBSR`).
* :mod:`~repro_torch.sampling.sampler` — fixed-fanout sampling on device
  tensors over given uniforms (with-replacement fast path,
  without-replacement exact path), pinned bitwise against a NumPy oracle
  on the same uniforms.
* :mod:`~repro_torch.sampling.service` — k-hop minibatch sampling with
  ``torch.Generator`` draws and per-hop batched halo-fetch accounting;
  the fused path issues every hop with no host sync between them (the
  per-hop loop survives as the bitwise-pinned reference).
* :mod:`~repro_torch.sampling.features` — owner-sharded device feature
  store plus a hub-tier + LRU :class:`HaloCache` so remote feature rows
  are fetched once, not per batch.
* :mod:`~repro_torch.sampling.pipeline` — bounded-depth async prefetch
  producing ``(MiniBatch, features)`` with batch ``i+1``'s sampling
  overlapping batch ``i``'s feature fetch, bitwise deterministic at
  every depth.

The layer consumes runtimes only through ``PartitionRuntime.create``.
Every entry point takes ``device=`` (default ``"cuda"``, which raises
without a GPU).  Random bits come from ``torch.Generator`` and differ
from the JAX package's ``jax.random`` (threefry); the functions that take
the uniforms or the seed permutation as arguments (:func:`fanout_hop`,
:meth:`SamplingService.sample_khop`,
:meth:`SamplingService.local_seeds_from_perm`) are where the two are held
bitwise.
"""
from .features import FeatureStore, FetchStats, HaloCache
from .machine_csc import MachineCSC
from .pipeline import PrefetchPipeline, batch_generators
from .sampler import fanout_hop, hop_width, sample_fanout, sample_fanout_np
from .service import HopStats, MiniBatch, SamplingService

__all__ = ["MachineCSC", "sample_fanout", "sample_fanout_np",
           "HopStats", "MiniBatch", "SamplingService",
           "FeatureStore", "FetchStats", "HaloCache",
           "PrefetchPipeline",
           "fanout_hop", "hop_width", "batch_generators"]
