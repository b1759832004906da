"""Per-machine feature shards + halo cache for minibatch training.

A minibatch's sampled ids are useless to a trainer without the feature
rows behind them.  This module adds the feature tensor path on top of
the owner map :class:`~repro_torch.sampling.machine_csc.MachineCSC`
already defines:

* :class:`FeatureStore` holds, on the device, each machine's *owned*
  vertices' feature rows (``shards[i][r]`` is the feature row of
  ``owned_gid[i, r]`` — the same owner-local row ids the sampler's flat
  tables use).  The shards are views into one ``(owned, F)`` tensor.  A
  machine resolves its own vertices' rows locally; every remote vertex in
  a batch costs one cross-machine fetch, deduplicated batch-wide.
* :class:`HaloCache` sits in front of the remote fetch: a **static hub
  tier** (the globally highest-degree remote vertices, preloaded, never
  evicted) plus an **LRU tail** for the long tail of recent remote rows.
  Its rows live in a preallocated ``(capacity, F)`` device slab; the
  bookkeeping (hub map, LRU order, counters) stays on the host, so its
  hit, miss, eviction and byte counts and its ``lru_ids()`` follow the
  same id stream exactly as the JAX package's numpy cache does.

``FeatureStore.gather`` is the per-batch resolve: local rows from the
home shard, cache hits from the slab, and the remaining misses via one
deduplicated batched fetch whose rows are admitted to the LRU tail.
Cached and uncached resolution are bitwise identical (cache rows came
from the same shards); the per-gather :class:`FetchStats` record
hit/miss/bytes, and the per-hop ``fetched_unique`` stat the service
records is exactly the zero-cache miss upper bound.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict

import numpy as np
import torch

from ..bsp.partition_runtime import PartitionRuntime
from ..device import resolve_device
from .machine_csc import MachineCSC


@dataclasses.dataclass
class FetchStats:
    """Accounting for one :meth:`FeatureStore.gather` call.

    ``hits``/``misses`` count *deduplicated* remote vertices (so
    ``misses`` ≤ the batch's summed per-hop ``fetched_unique`` bound);
    ``local`` counts valid lanes resolved from the home shard and
    ``bytes_fetched`` is the cross-machine traffic this batch actually
    paid after the cache.
    """

    local: int = 0
    hits: int = 0
    misses: int = 0
    bytes_fetched: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.hits + self.misses)


class HaloCache:
    """Remote-feature cache: degree-ranked static hubs + an LRU tail.

    ``capacity`` is the **total** row budget; ``hub_ids`` (with their
    preloaded ``hub_rows``) occupy ``len(hub_ids)`` of it permanently
    and are never evicted, the remainder is the LRU tail.  Use
    :meth:`for_home` to build one with the hub tier auto-selected as the
    highest-global-degree vertices not owned by ``home``.

    Rows live in one ``(capacity, F)`` slab on ``device``, allocated
    with the hub rows (or with the first inserted row when there are
    none); the host maps each cached id to its slot.
    """

    def __init__(self, capacity: int, hub_ids=(), hub_rows=None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        capacity = int(capacity)
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        hub_ids = np.asarray(hub_ids, dtype=np.int64).reshape(-1)
        if len(hub_ids) > capacity:
            raise ValueError(f"{len(hub_ids)} hub ids exceed the total "
                             f"capacity {capacity}")
        if len(hub_ids) and (hub_rows is None
                             or len(hub_rows) != len(hub_ids)):
            raise ValueError("hub_rows must provide one preloaded row "
                             "per hub id")
        self.capacity = capacity
        # a repeated hub id keeps its first slot and its last row
        last = {int(v): j for j, v in enumerate(hub_ids)}
        self._hub = {v: slot for slot, v in enumerate(last)}
        self._slab = None
        if hub_rows is not None:
            rows = torch.as_tensor(hub_rows, device=self.device)
            self._alloc(rows)
            if self._hub:
                src = torch.tensor(list(last.values()), device=self.device)
                self._slab[:len(self._hub)] = rows[src]
        self._lru: OrderedDict[int, int] = OrderedDict()   # id -> slot
        self._free = list(range(capacity - 1, len(self._hub) - 1, -1))
        self.lru_capacity = capacity - len(self._hub)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_fetched = 0

    def _alloc(self, rows: torch.Tensor) -> None:
        self._slab = torch.zeros((self.capacity,) + tuple(rows.shape[1:]),
                                 dtype=rows.dtype, device=self.device)

    @classmethod
    def for_home(cls, store: "FeatureStore", home: int, capacity: int,
                 hub_frac: float = 0.5) -> "HaloCache":
        """Cache for machine ``home`` on the store's device: the
        ``ceil(capacity*hub_frac)`` highest-global-degree vertices owned
        elsewhere become the preloaded hub tier (degree ties break to the
        lower vertex id), the rest of the budget is the LRU tail."""
        if not 0.0 <= hub_frac <= 1.0:
            raise ValueError(f"hub_frac must be in [0, 1], got {hub_frac}")
        gdeg = store.global_degree()
        remote = np.flatnonzero((store.csc.owner >= 0)
                                & (store.csc.owner != home))
        hub_n = min(int(math.ceil(int(capacity) * hub_frac)), len(remote))
        order = np.argsort(-gdeg[remote], kind="stable")[:hub_n]
        hub_ids = remote[order]
        return cls(capacity, hub_ids=hub_ids,
                   hub_rows=store.gather_global(hub_ids),
                   device=store.device)

    @property
    def hub_ids(self) -> np.ndarray:
        return np.fromiter(self._hub.keys(), dtype=np.int64,
                           count=len(self._hub))

    def lru_ids(self) -> list:
        """LRU-tail ids, least-recent first (the eviction order)."""
        return list(self._lru.keys())

    def __contains__(self, vid) -> bool:
        return int(vid) in self._hub or int(vid) in self._lru

    def __len__(self) -> int:
        return len(self._hub) + len(self._lru)

    def _slot(self, vid: int) -> int:
        """Slot of ``vid`` (refreshing its LRU recency) or -1.  Hub hits
        never touch the LRU order — the tier is static."""
        slot = self._hub.get(vid)
        if slot is not None:
            return slot
        slot = self._lru.get(vid)
        if slot is None:
            return -1
        self._lru.move_to_end(vid)
        return slot

    def _place(self, vid: int) -> int:
        """Admit ``vid`` to the LRU tail and return its slot (-1 when it
        is a hub or the tail has no room), evicting the least-recent id
        when the tail is full."""
        if vid in self._hub or self.lru_capacity == 0:
            return -1
        slot = self._lru.get(vid)
        if slot is None:
            if len(self._lru) >= self.lru_capacity:
                _, slot = self._lru.popitem(last=False)
                self.evictions += 1
            else:
                slot = self._free.pop()
        self._lru[vid] = slot
        self._lru.move_to_end(vid)
        return slot

    def lookup(self, vid: int):
        """A copy of the row for ``vid`` (refreshing its LRU recency) or
        ``None``."""
        slot = self._slot(int(vid))
        return None if slot < 0 else self._slab[slot].clone()

    def insert(self, vid: int, row) -> None:
        """Admit a fetched row to the LRU tail (hubs are preloaded and
        ignore re-inserts), evicting the least-recent past capacity."""
        self._admit(np.array([vid], dtype=np.int64),
                    torch.as_tensor(row, device=self.device)[None])

    def _admit(self, vids, rows: torch.Tensor) -> None:
        """:meth:`insert` each of ``vids`` in order, with its row of
        ``rows``, writing the slab once.  A slot reused within the batch
        keeps the last row written to it, as the inserts in turn would."""
        last = {}
        for k, v in enumerate(np.asarray(vids, dtype=np.int64).tolist()):
            slot = self._place(v)
            if slot >= 0:
                last[slot] = k
        if not last:
            return
        if self._slab is None:
            self._alloc(rows)
        slots = torch.tensor(list(last), device=self.device)
        src = torch.tensor(list(last.values()), device=self.device)
        self._slab[slots] = rows[src]

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.hits + self.misses)


class FeatureStore:
    """Owner-sharded vertex features over a partition's owner map, on
    ``device``."""

    def __init__(self, csc: MachineCSC, shards, *, device="cuda"):
        self.device = resolve_device(device)
        if len(shards) != csc.p:
            raise ValueError(f"expected {csc.p} shards, got {len(shards)}")
        self.csc = csc
        shards = [torch.as_tensor(s) for s in shards]
        dims = {tuple(s.shape[1:]) for s in shards}
        if len(dims) != 1:
            raise ValueError(f"shards disagree on feature shape: {dims}")
        sizes = [int(s.shape[0]) for s in shards]
        self._flat = torch.empty((sum(sizes),) + dims.pop(),
                                 dtype=shards[0].dtype, device=self.device)
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.shards = []
        for i, s in enumerate(shards):      # one shard to the device at a time
            view = self._flat[int(offsets[i]):int(offsets[i + 1])]
            view.copy_(s)
            self.shards.append(view)
        self._offset = torch.from_numpy(offsets[:-1]).to(self.device)
        self._owner = torch.from_numpy(csc.owner).to(self.device)
        self._row = torch.from_numpy(csc.row.astype(np.int64)).to(self.device)

    @classmethod
    def build(cls, source, features, *, device="cuda",
              **create_kw) -> "FeatureStore":
        """Shard ``features`` (``(V, F)``, any dtype) by vertex owner.

        ``source`` is anything that pins an owner map: a
        :class:`~repro_torch.sampling.service.SamplingService`, a
        :class:`MachineCSC`, a ``PartitionRuntime``, or any
        ``PartitionRuntime.create`` source (``**create_kw`` forwarded).
        """
        from .service import SamplingService
        if isinstance(source, SamplingService):
            csc = source.csc
        elif isinstance(source, MachineCSC):
            csc = source
        elif isinstance(source, PartitionRuntime):
            csc = MachineCSC.build(source)
        else:
            csc = MachineCSC.build(
                PartitionRuntime.create(source, device=device, **create_kw))
        features = np.asarray(features)
        if features.ndim < 2 or features.shape[0] != csc.num_vertices:
            raise ValueError(
                f"features must be (num_vertices={csc.num_vertices}, F), "
                f"got {features.shape}")
        shards = [features[csc.owned_gid[i, :int(csc.owned_per[i])]]
                  for i in range(csc.p)]
        return cls(csc, shards, device=device)

    @property
    def feat_dim(self) -> int:
        return int(np.prod(self._flat.shape[1:], dtype=np.int64))

    @property
    def row_bytes(self) -> int:
        return self.feat_dim * self._flat.element_size()

    def global_degree(self) -> np.ndarray:
        """(V,) global degree, scattered back from the owner shards."""
        csc = self.csc
        gdeg = np.zeros(csc.num_vertices, dtype=np.int64)
        for i in range(csc.p):
            n = int(csc.owned_per[i])
            gdeg[csc.owned_gid[i, :n]] = csc.deg[i, :n]
        return gdeg

    def _ids(self, ids) -> torch.Tensor:
        """``ids`` as a flat int64 tensor on the device, each < V."""
        ids = torch.as_tensor(ids, device=self.device).reshape(-1).long()
        if len(ids) and int(ids.max()) >= self.csc.num_vertices:
            raise IndexError(f"vertex ids must lie below "
                             f"{self.csc.num_vertices}")
        return ids

    def _rows(self, ids: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """Feature rows of ``ids`` where ``keep``, zeros elsewhere."""
        out = torch.zeros((len(ids),) + tuple(self._flat.shape[1:]),
                          dtype=self._flat.dtype, device=self.device)
        if len(self._flat):
            safe = ids.clamp(min=0)
            flat_row = (self._offset[self._owner[safe].clamp(min=0)]
                        + self._row[safe])
            pos = torch.nonzero(keep).squeeze(1)
            out[pos] = self._flat[flat_row[pos]]
        return out

    def gather_global(self, ids) -> torch.Tensor:
        """Feature rows for ``ids`` with full shard knowledge — the
        uncached reference resolve (and the primitive a cross-machine
        fetch of remote rows bottoms out in).  ``-1`` lanes and isolated
        vertices get zeros."""
        ids = self._ids(ids)
        keep = (ids >= 0) & (self._owner[ids.clamp(min=0)] >= 0)
        return self._rows(ids, keep)

    def gather(self, ids, home: int, cache: HaloCache | None = None):
        """Resolve ``ids`` for machine ``home``: local rows from its own
        shard, remote rows through ``cache`` (hub + LRU) with the
        residual misses fetched in one deduplicated batch and admitted
        to the cache.  Returns ``(rows, FetchStats)``; bitwise equal to
        :meth:`gather_global` for any cache state.
        """
        ids = self._ids(ids)
        own = torch.where(ids >= 0, self._owner[ids.clamp(min=0)], -1)
        local = own == home
        out = self._rows(ids, local)
        stats = FetchStats(local=int(local.sum()))
        remote = torch.nonzero((own != home) & (own >= 0)).squeeze(1)
        if not len(remote):
            return out, stats
        uniq, inv = torch.unique(ids[remote], sorted=True,
                                 return_inverse=True)
        if cache is None:
            table = self.gather_global(uniq)
            stats.misses = len(uniq)
        else:
            uniq_h = uniq.cpu().numpy()
            slots = np.array([cache._slot(v) for v in uniq_h.tolist()],
                             dtype=np.int64)
            hit = slots >= 0
            miss = np.flatnonzero(~hit)
            stats.hits = int(hit.sum())
            table = torch.empty((len(uniq),) + tuple(self._flat.shape[1:]),
                                dtype=self._flat.dtype, device=self.device)
            if stats.hits:
                table[torch.from_numpy(np.flatnonzero(hit)).to(
                    self.device)] = cache._slab[
                        torch.from_numpy(slots[hit]).to(self.device)]
            if len(miss):
                # the hits are read above, on this stream, before the
                # admitted rows may overwrite an evicted hit's slot
                miss_d = torch.from_numpy(miss).to(self.device)
                fetched = self.gather_global(uniq[miss_d])
                table[miss_d] = fetched
                cache._admit(uniq_h[miss], fetched)
                stats.misses = len(miss)
            cache.hits += stats.hits
            cache.misses += stats.misses
        stats.bytes_fetched = stats.misses * self.row_bytes
        if cache is not None:
            cache.bytes_fetched += stats.bytes_fetched
        out[remote] = table[inv]
        return out, stats
