"""K-hop minibatch sampling service with per-hop halo-fetch accounting.

One :class:`SamplingService` wraps a partition (via
``PartitionRuntime.create`` — the only constructor surface this layer
uses) as an owner-partitioned :class:`~repro_torch.sampling.machine_csc.
MachineCSC` plus device-resident flat tables, and answers minibatch
requests: seeds → ``fanouts[0]`` neighbors each → ``fanouts[1]``
neighbors of those → ….  Hop ``h`` consumes one uniform block of shape
``hop_shapes(len(seeds))[h]``, drawn in hop order from one
``torch.Generator``, so the whole minibatch is a pure function of
``(partition, seeds, generator state)`` — bitwise reproducible across
runs and across equal-content runtimes, however they were built.

:meth:`SamplingService.sample_khop` takes the uniforms as tensors and is
the only home of the k-hop math; :meth:`~SamplingService.sample` draws
them and calls it.  The JAX package's bits (threefry) differ from any
torch generator's, so the parity tests carry its draws across into
``sample_khop`` (and its seed permutation into
:meth:`~SamplingService.local_seeds_from_perm`).

Two execution paths produce the same bits:

* the **fused path** (default): every hop is issued back to back on the
  device with no host sync between hops, ``"top_k"`` selection, and the
  owner/halo accounting — including the deduplicated remote-row count —
  on the device (sort with remote lanes keyed below a ``V`` sentinel +
  adjacent difference); the counts come back in one ``(k, 3)`` transfer;
* the **hop-at-a-time path** (``fused=False``): the reference loop — one
  host round-trip per hop, stable-sort selection, host ``np.unique``
  accounting — which the tests and ``chip_smoke.py`` hold the fused
  path against, bitwise.

Halo accounting: after each hop, the new frontier's vertices that are
*not* owned by the sampling machine would be resolved by one batched
cross-machine fetch of their owner rows (deduplicated per hop).  The
per-hop ``halo_frac`` is the fraction of valid frontier entries that are
remote: exactly the traffic a better partition (lower RF, stronger
locality) shrinks.  ``fetched_unique`` is also the cache-miss upper
bound for the feature layer (:mod:`~repro_torch.sampling.features`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bsp.partition_runtime import PartitionRuntime
from ..device import resolve_device
from .machine_csc import MachineCSC
from .sampler import fanout_hop, hop_width


@dataclasses.dataclass(frozen=True)
class HopStats:
    """Fetch accounting for one hop's *output* frontier."""

    frontier: int        # valid sampled entries entering the next hop
    halo: int            # of those, entries owned by a remote machine
    fetched_unique: int  # deduplicated remote rows one batch fetch pulls

    @property
    def halo_frac(self) -> float:
        return self.halo / max(1, self.frontier)


@dataclasses.dataclass(frozen=True)
class MiniBatch:
    """One sampled k-hop neighborhood batch, on the service's device.

    ``seeds`` is ``(B,)`` int32; ``hops[h]`` holds hop ``h``'s sampled
    global ids, flattened to ``(B * prod(fanouts[:h+1]),)`` int32 with
    ``-1`` for pad lanes (isolated/undersized neighborhoods propagate
    ``-1`` forward, keeping every hop's shape fixed).
    """

    seeds: torch.Tensor
    hops: tuple
    hop_stats: tuple
    home: int | None

    def halo_fracs(self) -> tuple:
        return tuple(s.halo_frac for s in self.hop_stats)

    def num_sampled(self) -> int:
        return int(sum(s.frontier for s in self.hop_stats))

    def all_ids(self) -> torch.Tensor:
        """Seeds + every hop, flattened in order (``-1`` pads kept) —
        the id set whose features a trainer needs for this batch."""
        return torch.cat([self.seeds] + [h.reshape(-1) for h in self.hops])


def _hop_counts(out: torch.Tensor, owner: torch.Tensor,
                home: int | None) -> torch.Tensor:
    """``(frontier, halo, fetched_unique)`` of one hop, on the device."""
    if out.shape[0] == 0:
        return torch.zeros(3, dtype=torch.int64, device=out.device)
    ok = out >= 0
    zero = torch.zeros((), dtype=torch.int64, device=out.device)
    if home is None:
        return torch.stack([ok.sum(), zero, zero])
    V = owner.shape[0]
    remote = ok & (owner[out.clamp(0, V - 1).long()] != home)
    keyed = torch.sort(torch.where(remote, out, V)).values
    fresh = torch.cat([torch.ones(1, dtype=torch.bool, device=out.device),
                       keyed[1:] != keyed[:-1]])
    return torch.stack([ok.sum(), remote.sum(), ((keyed < V) & fresh).sum()])


class SamplingService:
    """Fixed-fanout k-hop neighbor sampling over a partitioned graph."""

    def __init__(self, rt: PartitionRuntime | MachineCSC, fanouts=(10, 5),
                 *, replace: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.csc = rt if isinstance(rt, MachineCSC) else MachineCSC.build(rt)
        self.fanouts = tuple(int(f) for f in fanouts)
        if not self.fanouts or any(f < 1 for f in self.fanouts):
            raise ValueError(f"fanouts must be positive ints, got "
                             f"{self.fanouts}")
        self.replace = bool(replace)
        csc = self.csc
        # machine-stacked flat tables: row of vertex v = owner*Omax+row[v]
        self._table = torch.from_numpy(
            csc.nbr.reshape(csc.p * csc.omax, csc.max_degree)).to(self.device)
        self._deg = torch.from_numpy(csc.deg.reshape(-1)).to(self.device)
        self._rowmap = csc.flat_rowmap()                  # np (V,)
        self._owner = csc.owner
        self._rowmap_d = torch.from_numpy(self._rowmap).to(self.device)
        self._owner_d = torch.from_numpy(csc.owner).to(self.device)

    @classmethod
    def create(cls, source=None, *, fanouts=(10, 5), replace: bool = False,
               device="cuda", **create_kw) -> "SamplingService":
        """Build straight from any ``PartitionRuntime.create`` source:
        ``create(source=g, method="windgp", cluster=cl)``,
        ``create(source=g, assign=a, p=p)``, or
        ``create(source=stream_assignment_or_path)``."""
        rt = PartitionRuntime.create(source, device=device, **create_kw)
        return cls(rt, fanouts=fanouts, replace=replace, device=device)

    @property
    def p(self) -> int:
        return self.csc.p

    def hop_shapes(self, n: int) -> tuple:
        """``(rows, columns)`` of each hop's uniform block for ``n``
        seeds, in hop order."""
        shapes, rows = [], int(n)
        for fanout in self.fanouts:
            shapes.append((rows, hop_width(self.csc.max_degree, fanout,
                                           self.replace)))
            rows *= fanout
        return tuple(shapes)

    def draw_uniforms(self, n: int, generator: torch.Generator) -> list:
        """Every hop's uniforms for ``n`` seeds, drawn in hop order from
        ``generator`` on the service's device."""
        return [torch.rand(shape, generator=generator, device=self.device)
                for shape in self.hop_shapes(n)]

    def _seed_pool(self, home: int, train_mask) -> np.ndarray:
        pool = self.csc.owned_gid[home][:int(self.csc.owned_per[home])]
        if train_mask is not None:
            tm = np.asarray(train_mask, dtype=bool)
            pool = pool[tm[pool]]
        return pool

    def local_seeds(self, home: int, n: int, generator: torch.Generator,
                    train_mask: np.ndarray | None = None) -> np.ndarray:
        """``n`` seed vertices owned by machine ``home`` — a uniform
        draw (``torch.randperm`` from ``generator``) from its owned
        (optionally train-masked) vertex set, through
        :meth:`local_seeds_from_perm`.  Seeds are where minibatches start
        in DistDGL-style training: each trainer draws from its own
        machine's shard."""
        pool = self._seed_pool(home, train_mask)
        if len(pool) == 0:
            return np.empty(0, dtype=np.int32)
        perm = torch.randperm(len(pool), generator=generator,
                              device=self.device)
        return self.local_seeds_from_perm(home, n, perm, train_mask)

    def local_seeds_from_perm(self, home: int, n: int, perm,
                              train_mask: np.ndarray | None = None
                              ) -> np.ndarray:
        """The first ``n`` of machine ``home``'s (masked) owned vertices
        in the order of ``perm``, a permutation of the pool's positions.

        When the pool holds fewer than ``n`` vertices the whole pool is
        returned in ``perm`` order — the result length is
        ``min(n, pool size)``, never padded; callers wanting fixed batch
        shapes must check ``len(seeds)``.
        """
        pool = self._seed_pool(home, train_mask)
        if len(pool) == 0:
            return np.empty(0, dtype=np.int32)
        perm = (perm.cpu().numpy() if isinstance(perm, torch.Tensor)
                else np.asarray(perm))
        if perm.shape != (len(pool),):
            raise ValueError(f"perm must permute the {len(pool)} pool "
                             f"positions, got shape {perm.shape}")
        return pool[perm[:int(n)]].astype(np.int32)

    def _check_seeds(self, seeds) -> np.ndarray:
        if isinstance(seeds, torch.Tensor):
            seeds = seeds.cpu().numpy()
        frontier = np.array(seeds, dtype=np.int32).reshape(-1)
        if len(frontier):
            if frontier.max() >= self.csc.num_vertices:
                raise ValueError(
                    f"seed ids must lie in [0, {self.csc.num_vertices})")
            if frontier.min() < -1:
                raise ValueError(
                    f"seed ids must be >= -1 (-1 is the explicit pad "
                    f"lane); got {int(frontier.min())}")
        return frontier

    def sample(self, seeds, generator: torch.Generator,
               home: int | None = None, *, fused: bool = True) -> MiniBatch:
        """Sample the k-hop neighborhood of ``seeds`` (global vertex ids;
        ``-1`` marks an explicit pad lane, anything below is rejected),
        drawing every hop's uniforms from ``generator``
        (:meth:`draw_uniforms`), then :meth:`sample_khop`."""
        frontier = self._check_seeds(seeds)
        return self.sample_khop(
            frontier, self.draw_uniforms(len(frontier), generator), home,
            fused=fused)

    def sample_khop(self, seeds, hop_uniforms, home: int | None = None, *,
                    fused: bool = True) -> MiniBatch:
        """The k-hop sample of ``seeds`` over the given uniforms
        (``hop_uniforms[h]`` float32 of shape ``hop_shapes(len(seeds))[h]``,
        tensors or arrays).

        ``home`` is the machine running the batch: per hop, sampled
        vertices owned elsewhere count as halo fetches (``hop_stats``).
        The same ``(seeds, hop_uniforms)`` always yields the bitwise-same
        minibatch on either path (``fused=True`` syncs once; ``False`` is
        the per-hop reference loop).
        """
        frontier = self._check_seeds(seeds)
        shapes = self.hop_shapes(len(frontier))
        us = [torch.as_tensor(u, device=self.device) for u in hop_uniforms]
        if [tuple(u.shape) for u in us] != list(shapes) or any(
                u.dtype != torch.float32 for u in us):
            raise ValueError(
                f"hop_uniforms must be float32 of shapes {list(shapes)}, "
                f"got {[(tuple(u.shape), u.dtype) for u in us]}")
        if fused:
            return self._sample_fused(frontier, us, home)
        return self._sample_loop(frontier, us, home)

    def _sample_fused(self, frontier, us, home) -> MiniBatch:
        seeds = torch.from_numpy(frontier).to(self.device)
        V = self.csc.num_vertices
        hops, counts, cur = [], [], seeds
        for fanout, u in zip(self.fanouts, us):
            rows = torch.where(cur >= 0,
                               self._rowmap_d[cur.clamp(0, V - 1).long()], -1)
            cur = fanout_hop(self._table, self._deg, rows, u, fanout,
                             self.replace, select="top_k").reshape(-1)
            counts.append(_hop_counts(cur, self._owner_d, home))
            hops.append(cur)
        stats = torch.stack(counts).cpu().numpy()   # one (k, 3) transfer
        return MiniBatch(
            seeds=seeds, hops=tuple(hops),
            hop_stats=tuple(HopStats(frontier=int(f), halo=int(h),
                                     fetched_unique=int(q))
                            for f, h, q in stats),
            home=home)

    def _sample_loop(self, frontier, us, home) -> MiniBatch:
        seeds = torch.from_numpy(frontier).to(self.device)
        V = self.csc.num_vertices
        hops, stats = [], []
        for fanout, u in zip(self.fanouts, us):
            valid = frontier >= 0
            rows = np.where(valid,
                            self._rowmap[np.clip(frontier, 0, V - 1)], -1)
            out_d = fanout_hop(self._table, self._deg,
                               torch.from_numpy(rows).to(self.device), u,
                               fanout, self.replace,
                               select="sort").reshape(-1)
            out = out_d.cpu().numpy()
            ok = out >= 0
            if home is None:
                halo = np.zeros(0, dtype=np.int32)
                n_halo = 0
            else:
                remote = ok & (self._owner[np.clip(out, 0, V - 1)] != home)
                halo = out[remote]
                n_halo = int(remote.sum())
            stats.append(HopStats(frontier=int(ok.sum()), halo=n_halo,
                                  fetched_unique=len(np.unique(halo))))
            hops.append(out_d)
            frontier = out
        return MiniBatch(seeds=seeds, hops=tuple(hops),
                         hop_stats=tuple(stats), home=home)
