"""Per-machine CSC adjacency for neighbor sampling.

An edge partition gives every machine an edge shard; sampling instead
needs, per machine, the **full global adjacency of the vertices it
serves** — sampling a vertex's neighbors from one machine's partial edge
set would bias the draw toward co-located edges.  Following the
DistDGL/graphbolt layout, each vertex gets one *primary owner*: the
machine with the most incident edges on it (ties break to the lowest
machine id, so ownership is deterministic and derivable from any
equal-content runtime).  Each machine's CSC then holds its owned
vertices' complete neighbor lists, built by distributing every shard's
edges to both endpoints' owners — one shard at a time, so peak transient
state during packing is O(V) cursors plus one shard.

Rows are *degree-sorted* (descending global degree, stable — the same
local relabeling :class:`~repro_torch.bsp.partition_runtime.LocalBSR`
applies to its Block-ELL matrices): hub rows cluster at the top of each
machine's table, which keeps the padded ``(rows, max_degree)`` neighbor
table's live entries in the leading columns of the leading rows.

Halo semantics fall out of ownership: a frontier vertex whose owner is
not the sampling machine must have its row fetched cross-machine — the
halo-fetch fraction the service reports per hop, and the quantity a
better partition (lower RF, stronger locality) directly shrinks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..bsp.partition_runtime import PartitionRuntime, rank_of
from ..core.partition_state import cumcount


@dataclasses.dataclass(frozen=True)
class MachineCSC:
    """Owner-partitioned global adjacency, stacked over machines.

    ``indptr[i]`` / the padded ``nbr[i]`` describe machine ``i``'s CSC:
    row ``r`` holds the full neighbor list of ``owned_gid[i, r]``.  All
    machines share ``(Omax, D)`` padded shapes, so the sampler's device
    tables stack them into one ``(p*Omax, D)`` tensor.
    """

    p: int
    num_vertices: int
    owner: np.ndarray       # (V,) int32 primary machine per vertex (-1: isolated)
    row: np.ndarray         # (V,) int32 owner-local row id (-1: isolated)
    owned_gid: np.ndarray   # (p, Omax) int32 global id per row (-1 pad)
    deg: np.ndarray         # (p, Omax) int32 full global degree per row
    indptr: np.ndarray      # (p, Omax+1) int64 CSC column pointers
    nbr: np.ndarray         # (p, Omax, D) int32 neighbor gids (-1 pad)
    owned_per: np.ndarray   # (p,) int64 owned-vertex count

    @property
    def omax(self) -> int:
        return self.owned_gid.shape[1]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[2]

    def flat_rowmap(self) -> np.ndarray:
        """(V,) int32 map: vertex -> row in the machine-stacked flat table
        (``owner * Omax + row``; -1 for isolated vertices) — the index
        space :func:`~repro_torch.sampling.sampler.fanout_hop` consumes
        when the per-machine tables are reshaped to ``(p*Omax, D)``."""
        flat = self.owner.astype(np.int64) * self.omax + self.row
        return np.where(self.owner >= 0, flat, -1).astype(np.int32)

    @classmethod
    def build(cls, rt: PartitionRuntime) -> "MachineCSC":
        """Pack from a runtime's per-machine shards, one shard at a time."""
        p, V = rt.p, rt.num_vertices

        # Pass 1 — primary owner per vertex: the machine with the highest
        # local incidence count (strict > keeps the lowest machine id on
        # ties).  Running best arrays keep residency at O(V).
        best = np.zeros(V, dtype=np.int64)
        owner = np.full(V, -1, dtype=np.int32)
        gdeg = np.zeros(V, dtype=np.int64)
        for i in range(p):
            m = rt.vertex_valid[i]
            gids = rt.local_vertex_gid[i, m]
            gdeg[gids] = rt.global_degree[i, m]
            e = rt.local_edges[i][rt.edge_valid[i]]
            cnt_local = np.zeros(rt.vmax, dtype=np.int64)
            if len(e):
                np.add.at(cnt_local, e[:, 0], 1)
                np.add.at(cnt_local, e[:, 1], 1)
            cnt_g = np.zeros(V, dtype=np.int64)
            cnt_g[gids] = cnt_local[m]
            win = cnt_g > best
            owner[win] = i
            best[win] = cnt_g[win]

        # Degree-sorted local relabeling per owner (the LocalBSR idiom:
        # stable argsort on descending degree, rank_of for the inverse).
        owned_lists = [np.flatnonzero(owner == i) for i in range(p)]
        omax = max(1, max((len(o) for o in owned_lists), default=1))
        row = np.full(V, -1, dtype=np.int32)
        owned_gid = np.full((p, omax), -1, dtype=np.int32)
        deg = np.zeros((p, omax), dtype=np.int32)
        owned_per = np.zeros(p, dtype=np.int64)
        for i, o in enumerate(owned_lists):
            order = np.argsort(-gdeg[o], kind="stable").astype(np.int32)
            row[o] = rank_of(order, len(o))
            owned_gid[i, :len(o)] = o[order]
            deg[i, :len(o)] = gdeg[o[order]]
            owned_per[i] = len(o)
        D = max(1, int(gdeg.max(initial=0)))

        # Pass 2 — distribute each shard's edges to both endpoints' owner
        # rows.  Per-vertex fill cursors + within-batch occurrence ranks
        # (``cumcount``) make the scatter exact under duplicate endpoints.
        nbr = np.full((p, omax, D), -1, dtype=np.int32)
        cursor = np.zeros(V, dtype=np.int64)
        for i in range(p):
            e = rt.local_edges[i][rt.edge_valid[i]]
            if not len(e):
                continue
            ge = rt.local_vertex_gid[i][e].astype(np.int64)   # (k, 2) gids
            x = np.concatenate([ge[:, 0], ge[:, 1]])
            y = np.concatenate([ge[:, 1], ge[:, 0]]).astype(np.int32)
            slots = cursor[x] + cumcount(x)
            nbr[owner[x], row[x], slots] = y
            np.add.at(cursor, x, 1)
        if not np.array_equal(cursor, gdeg):
            short = np.flatnonzero(cursor != gdeg)[:8]
            raise ValueError(f"machine CSC fill disagrees with global "
                             f"degrees at vertices {short} — runtime "
                             f"shards do not cover the graph exactly once")

        indptr = np.zeros((p, omax + 1), dtype=np.int64)
        indptr[:, 1:] = np.cumsum(deg, axis=1)
        return cls(p=p, num_vertices=V, owner=owner, row=row,
                   owned_gid=owned_gid, deg=deg, indptr=indptr, nbr=nbr,
                   owned_per=owned_per)

    @classmethod
    def from_stream(cls, assignment, device="cuda") -> "MachineCSC":
        """Pack from an on-disk :class:`~repro_torch.bsp.
        stream_assignment.StreamAssignment` (or its path) — the runtime
        itself is packed one shard at a time, then re-distributed here.
        ``device`` is the runtime's (``PartitionRuntime.create``)."""
        return cls.build(PartitionRuntime.create(assignment, device=device))
