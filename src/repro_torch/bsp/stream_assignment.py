"""Compact on-disk product of a streaming partition: the BSP hand-off.

``stream_partition`` finalizes placements through a sink callback; before
this module the sink's output dead-ended in ad-hoc per-machine text files —
no runtime could consume them without re-reading (and re-deduplicating) the
raw edge list.  :class:`StreamAssignment` is the DistDGL-style durable
artifact in between: per-machine binary edge shards plus the vertex
membership/degree state, built *incrementally* as the stream runs, that
``PartitionRuntime.from_stream`` packs into the fixed-shape BSP arrays one
machine at a time — the raw list is never read again and the full edge set
never materializes in one array.

Layout under ``dir/``::

    shard<i>.edges    raw int64 (k_i, 2) endpoint pairs, appended in
                      admission order (placement order, not arrival order)
    state.npz         packed (p, V) membership bits, (V,) global degrees,
                      (p,) per-machine edge counts
    meta.json         counts, replication factor, method provenance —
                      written atomically (tmp + rename), last, and only
                      after every shard verifies against its byte length

The write protocol makes partial products detectable: a directory with no
``meta.json`` is unfinished by construction.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import numpy as np

from ..core.graph import edge_keys
from ..core.partition_state import cumcount

#: bytes per on-disk edge row (two little-endian int64 endpoints)
_ROW_BYTES = 16

_FORMAT_VERSION = 1

#: compact a shard once tombstones cancel this fraction of its rows
_COMPACT_FRAC = 0.5

#: the keys ``_publish`` owns; anything else in ``meta`` is caller
#: provenance (method, dedup, ...) that maintenance passes carry over
_META_KEYS = frozenset({
    "format_version", "p", "num_vertices", "num_edges",
    "edges_per_machine", "verts_per_machine", "replication_factor",
    "shards", "shard_rows", "tomb_rows"})


def _drop_tombstoned(rows: np.ndarray, tomb: np.ndarray) -> np.ndarray:
    """Drop, for each tombstone (u, v), the earliest matching row.

    Tombstones always refer to rows appended *before* them (a delta can
    only remove edges that were live at its snapshot), so cancelling the
    first ``count`` occurrences of each pair in row order is exact: a
    pair re-added after its removal sits later in the file and survives.
    """
    rkey = edge_keys(rows[:, 0], rows[:, 1])
    tk, tcount = np.unique(edge_keys(tomb[:, 0], tomb[:, 1]),
                           return_counts=True)
    occ = cumcount(rkey)
    pos = np.searchsorted(tk, rkey)
    hit = pos < len(tk)
    hit[hit] = tk[pos[hit]] == rkey[hit]
    drop = np.zeros(len(rkey), dtype=bool)
    drop[hit] = occ[hit] < tcount[pos[hit]]
    return rows[~drop]


@dataclasses.dataclass
class StreamAssignment:
    """Per-machine edge shards + membership, streamed to disk incrementally.

    Writer life-cycle: construct with ``p``/``num_vertices``, hand
    :meth:`sink` to ``stream_partition``, then :meth:`finalize` with the
    end-of-stream ``StreamMembership``.  Reader life-cycle:
    :meth:`StreamAssignment.open` on a finalized directory, then
    :meth:`machine_edges`/:meth:`membership` (or hand the whole object to
    ``PartitionRuntime.from_stream``).
    """

    dir: pathlib.Path
    p: int
    num_vertices: int
    edges_per: np.ndarray            # (p,) int64 edges appended per shard
    degree: np.ndarray               # (V,) int64 degree in the deduped graph
    meta: dict | None = None         # populated on finalize/open

    def __init__(self, out_dir, p: int, num_vertices: int):
        self.dir = pathlib.Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.p = int(p)
        self.num_vertices = int(num_vertices)
        self.edges_per = np.zeros(self.p, dtype=np.int64)
        self.degree = np.zeros(self.num_vertices, dtype=np.int64)
        self.meta = None
        self._member: np.ndarray | None = None
        # gross on-disk accounting: live rows = shard_rows - tomb_rows
        self.shard_rows = np.zeros(self.p, dtype=np.int64)
        self.tomb_rows = np.zeros(self.p, dtype=np.int64)
        self._files = [open(self._shard_path(i), "wb")
                       for i in range(self.p)]

    def _shard_path(self, i: int) -> pathlib.Path:
        return self.dir / f"shard{i}.edges"

    def _tomb_path(self, i: int) -> pathlib.Path:
        return self.dir / f"shard{i}.tomb"

    # -- incremental build (the stream sink) --------------------------------
    def sink(self, edges: np.ndarray, ms: np.ndarray) -> None:
        """Append one finalized placement wave: ``edges[j] -> ms[j]``.

        Matches ``stream_partition``'s sink contract; each edge arrives
        exactly once, so the running degree counts equal the deduplicated
        graph's degrees at stream end.
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        ms = np.asarray(ms, dtype=np.int64)
        np.add.at(self.degree, edges.ravel(), 1)
        order = np.argsort(ms, kind="stable")
        rows, srt = edges[order], ms[order]
        bounds = np.searchsorted(srt, np.arange(self.p + 1))
        for i in range(self.p):
            lo, hi = bounds[i], bounds[i + 1]
            if hi > lo:
                rows[lo:hi].tofile(self._files[i])
        self.edges_per += np.bincount(ms, minlength=self.p)

    def close(self) -> None:
        """Close the shard handles without publishing (abort path).

        Idempotent; safe after :meth:`finalize` (which closes them
        itself).  The directory is left as an unfinished product — no
        ``meta.json``, so readers reject it — instead of leaking ``p``
        open file descriptors when the stream raises mid-run.
        """
        for f in self._files:
            if not f.closed:
                f.close()

    def __enter__(self) -> "StreamAssignment":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def finalize(self, membership, extra_meta: dict | None = None) -> dict:
        """Flush + verify every shard, persist state, then write meta.

        ``membership`` is the end-of-stream ``StreamMembership`` (or a
        raw ``(p, V)`` bool matrix).  Verification is byte-accurate: each
        shard's on-disk length must equal ``edges_per[i]`` rows, and the
        membership totals must agree with what the sink saw — only then is
        ``meta.json`` written (tmp + ``os.replace``), so a crash mid-write
        can never leave a directory that parses as complete.
        """
        for f in self._files:
            if not f.closed:
                f.flush()
                os.fsync(f.fileno())
                f.close()
        for i in range(self.p):
            want = int(self.edges_per[i]) * _ROW_BYTES
            got = self._shard_path(i).stat().st_size
            if got != want:
                raise IOError(
                    f"shard {i} short-flushed: {got} bytes on disk, "
                    f"expected {want} ({int(self.edges_per[i])} edges)")
        member = (membership if isinstance(membership, np.ndarray)
                  else membership.cnt > 0)
        member = np.asarray(member, dtype=bool)
        if member.shape != (self.p, self.num_vertices):
            raise ValueError(f"membership shape {member.shape} != "
                             f"{(self.p, self.num_vertices)}")
        sunk = np.flatnonzero(self.degree > 0)
        held = np.flatnonzero(member.any(axis=0))
        if not np.array_equal(sunk, held):
            raise ValueError("membership disagrees with the sunk edges: "
                             "a vertex is held iff an incident edge placed")
        self._member = member
        self.shard_rows = self.edges_per.copy()
        self.tomb_rows = np.zeros(self.p, dtype=np.int64)
        return self._publish(extra_meta)

    def _publish(self, extra_meta: dict | None = None) -> dict:
        """Persist state.npz and write meta.json last — the commit point
        shared by :meth:`finalize` and :meth:`apply_delta`."""
        member = self._member
        np.savez_compressed(
            self.dir / "state.npz",
            member_bits=np.packbits(member, axis=1),
            degree=self.degree, edges_per=self.edges_per)
        replicas = member.sum(axis=0)
        covered = replicas > 0
        rf = float(replicas[covered].sum() / max(1, covered.sum()))
        meta = {
            "format_version": _FORMAT_VERSION,
            "p": self.p, "num_vertices": self.num_vertices,
            "num_edges": int(self.edges_per.sum()),
            "edges_per_machine": self.edges_per.tolist(),
            "verts_per_machine": member.sum(axis=1).astype(int).tolist(),
            "replication_factor": round(rf, 6),
            "shards": [self._shard_path(i).name for i in range(self.p)],
            "shard_rows": self.shard_rows.tolist(),
            "tomb_rows": self.tomb_rows.tolist(),
        }
        meta.update(extra_meta or {})
        write_json_atomic(self.dir / "meta.json", meta)
        self.meta = meta
        return meta

    # -- incremental update (the dynamic-epoch hand-off) ---------------------
    def apply_delta(self, delta, membership,
                    extra_meta: dict | None = None) -> dict:
        """Apply an epoch's :class:`~repro_torch.core.dynamic.AssignmentDelta`
        in place: append + tombstone segments, re-verified at publish.

        Removed edges become tombstone rows in ``shard<i>.tomb`` (value-
        based: :func:`_drop_tombstoned` cancels the earliest matching
        row); added edges append to ``shard<i>.edges``.  A shard whose
        tombstones exceed ``_COMPACT_FRAC`` of its rows is rewritten
        compact.  ``membership`` is the post-epoch ``(p, V)`` matrix (or
        an object with ``.cnt``, e.g. the live ``PartitionState``).

        Crash-safe by the same meta-last protocol as :meth:`finalize`:
        ``meta.json`` is *removed* first, so a crash mid-delta leaves a
        detectably-unfinished directory, and only rewritten after every
        touched file is fsynced and every shard's byte length re-verifies
        against the updated row accounting.
        """
        if self.meta is None:
            raise RuntimeError("apply_delta needs a finalized (or opened) "
                               "StreamAssignment")
        member = (membership if isinstance(membership, np.ndarray)
                  else membership.cnt > 0)
        member = np.asarray(member, dtype=bool)
        nv = int(delta.num_vertices)
        if nv < self.num_vertices:
            raise ValueError(f"delta shrinks the vertex space "
                             f"({nv} < {self.num_vertices})")
        if member.shape != (self.p, nv):
            raise ValueError(f"membership shape {member.shape} != "
                             f"{(self.p, nv)}")
        # unpublish: from here until the meta rewrite the directory is an
        # unfinished product and every reader rejects it
        os.remove(self.dir / "meta.json")
        self.meta = None
        if nv > self.num_vertices:
            self.degree = np.concatenate(
                [self.degree,
                 np.zeros(nv - self.num_vertices, dtype=np.int64)])
            self.num_vertices = nv
        np.add.at(self.degree, delta.added.ravel(), 1)
        np.subtract.at(self.degree, delta.removed.ravel(), 1)
        if (self.degree < 0).any():
            raise ValueError("delta removes edges the shards never held")
        self._append_grouped(delta.removed, delta.removed_ms,
                             self._tomb_path, self.tomb_rows)
        self._append_grouped(delta.added, delta.added_ms,
                             self._shard_path, self.shard_rows)
        self.edges_per += (np.bincount(delta.added_ms, minlength=self.p)
                           - np.bincount(delta.removed_ms,
                                         minlength=self.p))
        if (self.edges_per < 0).any():
            raise ValueError("delta drives a shard's edge count negative")
        for i in np.flatnonzero(delta.machines_touched(self.p)):
            if self.tomb_rows[i] > _COMPACT_FRAC * max(1, self.shard_rows[i]):
                self._compact_shard(int(i))
        for i in range(self.p):
            for path, rows in ((self._shard_path(i), self.shard_rows[i]),
                               (self._tomb_path(i), self.tomb_rows[i])):
                got = path.stat().st_size if path.exists() else 0
                if got != int(rows) * _ROW_BYTES:
                    raise IOError(f"{path.name}: {got} bytes on disk, "
                                  f"expected {int(rows)} rows")
            if int(self.shard_rows[i]) - int(self.tomb_rows[i]) != \
                    int(self.edges_per[i]):
                raise IOError(f"shard {i}: row accounting out of balance")
        sunk = np.flatnonzero(self.degree > 0)
        held = np.flatnonzero(member.any(axis=0))
        if not np.array_equal(sunk, held):
            raise ValueError("membership disagrees with the updated "
                             "degrees: a vertex is held iff an incident "
                             "edge is placed")
        self._member = member
        return self._publish(extra_meta)

    def _append_grouped(self, edges: np.ndarray, ms: np.ndarray,
                        path_of, rows_acct: np.ndarray) -> None:
        """Append per-machine row groups to shard or tomb files, fsynced."""
        if not len(edges):
            return
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        ms = np.asarray(ms, dtype=np.int64)
        order = np.argsort(ms, kind="stable")
        rows, srt = edges[order], ms[order]
        bounds = np.searchsorted(srt, np.arange(self.p + 1))
        for i in range(self.p):
            lo, hi = bounds[i], bounds[i + 1]
            if hi > lo:
                with open(path_of(i), "ab") as f:
                    rows[lo:hi].tofile(f)
                    f.flush()
                    os.fsync(f.fileno())
                rows_acct[i] += hi - lo
        # the appends created/extended names in the directory: sync it so
        # the files survive a crash that the later meta rewrite survives
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _compact_shard(self, i: int) -> None:
        """Rewrite shard i with tombstones folded in (tmp + replace)."""
        rows = np.fromfile(self._shard_path(i),
                           dtype=np.int64).reshape(-1, 2)
        tomb_path = self._tomb_path(i)
        if tomb_path.exists() and tomb_path.stat().st_size:
            tomb = np.fromfile(tomb_path, dtype=np.int64).reshape(-1, 2)
            rows = _drop_tombstoned(rows, tomb)
        tmp = self._shard_path(i).with_suffix(".edges.tmp")
        with open(tmp, "wb") as f:
            rows.tofile(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._shard_path(i))
        if tomb_path.exists():
            os.remove(tomb_path)
        self.shard_rows[i] = len(rows)
        self.tomb_rows[i] = 0

    def compact(self, max_tomb_frac: float = 0.0) -> dict:
        """Fold tombstones into their shards as a standalone maintenance
        pass (``launch/partition.py --compact``).

        :meth:`apply_delta` compacts a shard only when its tombstones
        pass ``_COMPACT_FRAC`` *during* a delta, so a long-lived
        directory accumulates tombstone debt between epochs — every
        reader pays the :func:`_drop_tombstoned` scan on every
        ``machine_edges`` call.  This rewrites each shard whose tombstone
        fraction exceeds ``max_tomb_frac`` (default 0.0: fold everything)
        through the same tmp + ``os.replace`` path, under the same
        meta-last crash protocol: ``meta.json`` is removed first, every
        rewritten shard byte-verifies against the row accounting, and
        only then is the meta republished — provenance keys
        (method/dedup/...) carried over.  Live content is untouched:
        ``machine_edges`` returns identical rows before and after.  A
        no-op (nothing over the threshold) leaves the directory
        unpublished for zero time and returns the current meta.
        """
        if self.meta is None:
            raise RuntimeError("compact needs a finalized (or opened) "
                               "StreamAssignment")
        frac = float(max_tomb_frac)
        todo = [i for i in range(self.p)
                if self.tomb_rows[i] > 0
                and self.tomb_rows[i] > frac * max(1, self.shard_rows[i])]
        if not todo:
            return self.meta
        extra = {k: v for k, v in self.meta.items() if k not in _META_KEYS}
        os.remove(self.dir / "meta.json")
        self.meta = None
        for i in todo:
            self._compact_shard(i)
        for i in range(self.p):
            for path, rows in ((self._shard_path(i), self.shard_rows[i]),
                               (self._tomb_path(i), self.tomb_rows[i])):
                got = path.stat().st_size if path.exists() else 0
                if got != int(rows) * _ROW_BYTES:
                    raise IOError(f"{path.name}: {got} bytes on disk, "
                                  f"expected {int(rows)} rows")
            if int(self.shard_rows[i]) - int(self.tomb_rows[i]) != \
                    int(self.edges_per[i]):
                raise IOError(f"shard {i}: row accounting out of balance")
        return self._publish(extra)

    # -- reader surface ------------------------------------------------------
    @classmethod
    def open(cls, out_dir) -> "StreamAssignment":
        """Open a finalized assignment directory (meta.json required)."""
        d = pathlib.Path(out_dir)
        meta_path = d / "meta.json"
        if not meta_path.exists():
            raise FileNotFoundError(
                f"{d} has no meta.json — unfinished StreamAssignment "
                f"(finalize() never completed)")
        try:
            meta = json.loads(meta_path.read_text())
        except json.JSONDecodeError as exc:
            raise ValueError(
                f"{meta_path} is corrupt (truncated or torn write): "
                f"{exc}") from exc
        if meta["format_version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported StreamAssignment format "
                             f"{meta['format_version']}")
        sa = cls.__new__(cls)
        sa.dir = d
        sa.p = int(meta["p"])
        sa.num_vertices = int(meta["num_vertices"])
        sa.meta = meta
        sa._files = []
        sa.shard_rows = np.asarray(
            meta.get("shard_rows", meta["edges_per_machine"]),
            dtype=np.int64)
        sa.tomb_rows = np.asarray(
            meta.get("tomb_rows", [0] * sa.p), dtype=np.int64)
        with np.load(d / "state.npz") as z:
            sa.degree = z["degree"]
            sa.edges_per = z["edges_per"]
            bits = z["member_bits"]
        sa._member = np.unpackbits(
            bits, axis=1, count=sa.num_vertices).astype(bool)
        np.testing.assert_array_equal(
            sa.edges_per, np.asarray(meta["edges_per_machine"]))
        return sa

    def membership(self) -> np.ndarray:
        """(p, V) bool — vertex v held by machine i (v ∈ V_i)."""
        if self._member is None:
            raise RuntimeError("membership unavailable before finalize()")
        return self._member

    def machine_edges(self, i: int) -> np.ndarray:
        """(k_i, 2) int64 endpoints of machine i's *live* shard rows (one
        machine's worth of memory, read on demand).

        Unreadable before :meth:`finalize` — same contract as
        :meth:`membership`, so an unfinished directory is uniformly
        rejected rather than quietly serving a partially-written shard.
        After :meth:`apply_delta`, tombstoned rows are dropped here: each
        tombstone cancels the *earliest* surviving occurrence of its
        (u, v) pair, so a pair re-added after its removal (a later
        append) is untouched.
        """
        if self.meta is None:
            raise RuntimeError(
                "machine_edges unavailable before finalize() — this "
                "directory is an unfinished StreamAssignment")
        rows = np.fromfile(self._shard_path(i),
                           dtype=np.int64).reshape(-1, 2)
        tomb_path = self._tomb_path(i)
        if tomb_path.exists() and tomb_path.stat().st_size:
            tomb = np.fromfile(tomb_path, dtype=np.int64).reshape(-1, 2)
            rows = _drop_tombstoned(rows, tomb)
        if len(rows) != int(self.edges_per[i]):
            raise IOError(
                f"shard {i}: {len(rows)} live rows after tombstones, "
                f"meta says {int(self.edges_per[i])}")
        return rows

    def replication_factor(self) -> float:
        member = self.membership()
        r = member.sum(axis=0)
        covered = r > 0
        return float(r[covered].sum() / max(1, covered.sum()))


def write_json_atomic(path, payload: dict) -> None:
    """Write JSON via tmp + ``os.replace`` so readers never see a torn file.

    Both fsyncs matter for the durability half of the claim: the tmp file
    is synced before the rename (otherwise ``os.replace`` can publish a
    name whose *contents* are still unflushed — a crash then surfaces an
    empty or partial file under the final name), and the directory is
    synced after (otherwise the rename itself may not survive).
    """
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps(payload, indent=2))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
