"""SNAP-style edge-list IO (whitespace-separated ``u v`` per line, # comments).

``iter_edge_blocks`` is the chunked reader behind the block-stream
partitioning path (``core/baselines/streaming.stream_partition``): it
yields ``(B, 2)`` int64 blocks without ever materializing the whole edge
list, transparently handles gzip (``.gz`` suffix), tolerates empty and
comment-only files, and applies ``from_edge_list``'s canonicalization
blockwise — ``u < v`` swap, self-loop drop, within-block dedup.

Cross-block duplicates need global state; two layers provide it:

* ``read_edge_list`` routes every block into ``from_edge_list``'s exact
  in-memory global dedup (the whole edge set materializes);
* :class:`TwoPassDedup` is the out-of-core equivalent — pass one hashes
  canonicalized edges into bounded spill buckets on disk, pass two streams
  each bucket back exactly deduplicated and k-way-merges the buckets on
  their stamped arrival index, so iterating it yields the globally-unique
  edge stream *in first-occurrence order* while peak edge residency stays
  bounded by the bucket size (``SpillStats`` carries the accounting).  The
  external-memory discipline follows HEP-style hybrid partitioners: spill
  cheap, dedup per bounded bucket, merge streams.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import pathlib
import shutil
import tempfile
from typing import Iterator

import numpy as np

from ..core.graph import Graph, from_edge_list

#: Default lines-per-block for the chunked reader.
DEFAULT_BLOCK_LINES = 65536


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _parse_lines(lines: list[str], comments: str) -> np.ndarray:
    """Parse one buffered chunk of lines into an (n, 2) int64 array.

    Comment/blank tolerance is pre-filtered cheaply; the numeric parse runs
    through ``np.loadtxt`` (C tokenizer) — this is the hot path of the
    out-of-core reader, so no per-edge Python loop.
    """
    kept = [ln for ln in lines
            if ln.strip() and not ln.lstrip().startswith(comments)]
    if not kept:
        return np.empty((0, 2), dtype=np.int64)
    try:
        edges = np.loadtxt(kept, dtype=np.int64, comments=comments,
                           usecols=(0, 1), ndmin=2)
    except (ValueError, IndexError) as e:
        raise ValueError(f"malformed edge-list block: {e}") from None
    return edges.reshape(-1, 2)


def canonicalize_block(edges: np.ndarray, dedup: bool = True) -> np.ndarray:
    """``from_edge_list``'s edge canonicalization, applied to one block.

    Swaps to ``u < v``, drops self loops, and (``dedup``) keeps the first
    occurrence of each within-block duplicate, preserving arrival order.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    u, v = u[keep], v[keep]
    if dedup and len(u):
        key = np.stack([u, v], axis=1)
        _, first = np.unique(key, axis=0, return_index=True)
        first.sort()                       # keep arrival order
        u, v = u[first], v[first]
    return np.stack([u, v], axis=1)


def iter_edge_blocks(path: str, block_size: int = DEFAULT_BLOCK_LINES, *,
                     comments: str = "#",
                     canonicalize: bool = True) -> Iterator[np.ndarray]:
    """Yield ``(<=block_size, 2)`` int64 edge blocks from a (gzipped) file.

    Empty and comment-only files simply yield nothing (``np.loadtxt``
    raises on them).  With ``canonicalize`` each block is normalized like
    ``from_edge_list`` normalizes the whole array (u<v, no self loops,
    within-block dedup), so downstream per-block consumers see the same
    edge representation the in-memory path does.
    """
    block_size = max(1, int(block_size))
    with _open_text(path) as f:
        while True:
            lines = []
            for ln in f:
                lines.append(ln)
                if len(lines) >= block_size:
                    break
            if not lines:
                return
            edges = _parse_lines(lines, comments)
            if canonicalize:
                edges = canonicalize_block(edges)
            if len(edges):
                yield edges


def byte_ranges(path: str, n: int) -> list[tuple[int, int]]:
    """Split a plain-text file into ``n`` contiguous byte ranges.

    Combined with :func:`iter_edge_blocks_range`'s line-alignment rule
    (a reader owns exactly the lines whose *first byte* falls inside its
    range), the ranges partition the file's lines disjointly and
    exhaustively — the range-reader side of the sharded ingest pipeline
    (``core/parallel.py``).  Gzip files cannot be byte-ranged (no random
    access into the compressed stream); callers fall back to one range.
    """
    size = os.path.getsize(path)
    n = max(1, int(n))
    cuts = [size * i // n for i in range(n + 1)]
    return [(cuts[i], cuts[i + 1]) for i in range(n)]


def iter_edge_blocks_range(path: str, start: int, end: int,
                           block_size: int = DEFAULT_BLOCK_LINES, *,
                           comments: str = "#",
                           canonicalize: bool = True) -> Iterator[np.ndarray]:
    """``iter_edge_blocks`` restricted to the lines starting in [start, end).

    Hadoop-split alignment: the reader seeks to ``start - 1``, and skips
    one partial line only when the byte there is not a newline (that line
    *started* in the previous range, whose reader owns it); it then reads
    whole lines while their first byte lies before ``end`` — the final
    owned line may extend past the boundary.  Every line is therefore
    consumed by exactly one of the readers over :func:`byte_ranges`'s
    cover, in file order within each range.
    """
    if str(path).endswith(".gz"):
        raise ValueError("byte-range reads need a plain-text file; gzip "
                         "streams have no line-addressable byte offsets")
    block_size = max(1, int(block_size))
    with open(path, "rb") as f:
        if start > 0:
            f.seek(start - 1)
            if f.read(1) != b"\n":
                f.readline()
        pos = f.tell()
        lines: list[str] = []
        while pos < end:
            ln = f.readline()
            if not ln:
                break
            pos += len(ln)
            lines.append(ln.decode())
            if len(lines) >= block_size:
                edges = _parse_lines(lines, comments)
                lines = []
                if canonicalize:
                    edges = canonicalize_block(edges)
                if len(edges):
                    yield edges
        if lines:
            edges = _parse_lines(lines, comments)
            if canonicalize:
                edges = canonicalize_block(edges)
            if len(edges):
                yield edges


def count_edge_list(path: str, block_size: int = DEFAULT_BLOCK_LINES, *,
                    comments: str = "#") -> tuple[int, int]:
    """(num_vertices, num_edges) of a file, in one chunked pass.

    ``num_vertices`` is ``max id + 1``; ``num_edges`` counts the
    canonicalized per-block edges (the same stream ``iter_edge_blocks``
    will later yield).  The counting pass the stream partitioner needs for
    its memory caps (and EBV's normalization).
    """
    n_v = 0
    n_e = 0
    for blk in iter_edge_blocks(path, block_size, comments=comments):
        n_v = max(n_v, int(blk.max()) + 1)
        n_e += len(blk)
    return n_v, n_e


def read_edge_list(path: str, num_vertices: int | None = None) -> Graph:
    """Read a whole edge list into a :class:`Graph` (exact global dedup)."""
    blocks = list(iter_edge_blocks(path, canonicalize=False))
    if blocks:
        edges = np.concatenate(blocks, axis=0)
    else:
        edges = np.empty((0, 2), dtype=np.int64)
    if num_vertices is None and len(edges) == 0:
        num_vertices = 0
    return from_edge_list(edges, num_vertices=num_vertices)


def write_edge_list(g: Graph, path: str) -> None:
    np.savetxt(path, g.edges, fmt="%d",
               header=f"V={g.num_vertices} E={g.num_edges}")


# ---------------------------------------------------------------------------
# two-pass out-of-core exact dedup (spill buckets + ordered merge)
# ---------------------------------------------------------------------------

#: Bound on spill-bucket fan-out (open file handles during the merge).
MAX_BUCKETS = 4096

#: Rows (int64 triples) read per bucket per refill during the merge.
DEFAULT_MERGE_ROWS = 8192


def _bucket_of(u: np.ndarray, v: np.ndarray, nb: int) -> np.ndarray:
    """Deterministic spill bucket per canonical edge (Fibonacci mixing)."""
    h = (u.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         ^ v.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F))
    return (h % np.uint64(nb)).astype(np.int64)


@dataclasses.dataclass
class SpillStats:
    """Accounting of one :class:`TwoPassDedup` run.

    ``peak_resident_rows`` is the largest number of edge rows simultaneously
    held in memory across every phase (spill blocks, bucket dedup loads,
    merge buffers + emit batch) — the quantity the out-of-core guarantee
    bounds: it scales with ``bucket_rows``/``merge_rows``/``block_size``,
    never with the edge-set size.
    """

    num_buckets: int = 0
    bucket_rows: int = 0          # configured per-bucket row target
    merge_rows: int = 0           # per-bucket refill size during the merge
    spilled_rows: int = 0         # pass-1 canonicalized rows (pre-dedup)
    unique_edges: int = 0         # post-dedup edge count
    max_bucket_rows: int = 0      # largest raw bucket loaded in pass 2
    peak_resident_rows: int = 0
    #: processes that ran the spill/dedup passes (sharded ingest sums the
    #: per-worker residency peaks into ``peak_resident_rows``, so the bound
    #: stays an upper bound on *simultaneous* resident rows)
    workers: int = 1

    @property
    def duplicate_rows(self) -> int:
        return self.spilled_rows - self.unique_edges

    def _saw(self, rows: int) -> None:
        self.peak_resident_rows = max(self.peak_resident_rows, int(rows))


class TwoPassDedup:
    """Exact global dedup of an edge-list file without holding the edge set.

    Pass one streams ``iter_edge_blocks`` (canonicalized, per-block dedup),
    stamps each surviving row with its global arrival index, and appends
    ``(idx, u, v)`` int64 triples to ``ceil(rows / bucket_rows)`` hash
    buckets on disk — every duplicate of an edge lands in the same bucket.
    Pass two (:meth:`prepare` finishes it) loads one bucket at a time —
    peak residency is the largest bucket, not the edge set — keeps the
    earliest arrival of each edge, and writes the bucket back sorted by
    arrival index.  Iterating the object k-way-merges the sorted buckets in
    bounded ``merge_rows`` chunks, yielding ``(<=block_size, 2)`` blocks of
    globally-unique edges in first-occurrence order — the same stream order
    an in-memory partitioner would see after ``from_edge_list`` dedup, so
    streamed and in-memory decisions are comparable edge for edge.

    Use as a context manager (or call :meth:`close`) to drop the spill
    directory; iteration is repeatable until then.
    """

    def __init__(self, path: str, spill_dir: str | None = None, *,
                 block_size: int = DEFAULT_BLOCK_LINES,
                 bucket_rows: int = 1 << 16,
                 merge_rows: int = DEFAULT_MERGE_ROWS,
                 comments: str = "#"):
        self.path = str(path)
        self.block_size = max(1, int(block_size))
        self.comments = comments
        self._owns_dir = spill_dir is None
        self.spill_dir = pathlib.Path(
            tempfile.mkdtemp(prefix="windgp-spill-") if spill_dir is None
            else spill_dir)
        self.spill_dir.mkdir(parents=True, exist_ok=True)
        self.stats = SpillStats(bucket_rows=max(1, int(bucket_rows)),
                                merge_rows=max(1, int(merge_rows)))
        self.num_vertices = 0
        self.num_edges = 0
        self._prepared = False

    def _estimate_rows(self) -> int:
        """Cheap row-count bound for the bucket fan-out, from the byte size.

        Only bucket *sizing* depends on this — correctness never does
        (every duplicate pair hashes to the same bucket at any fan-out);
        a misestimate just moves actual bucket sizes off the
        ``bucket_rows`` target, and ``SpillStats`` reports the real ones.
        ``u v\\n`` lines run ≥ 8 bytes on average for graphs past toy ids;
        gzip text typically compresses ~3×.
        """
        import os
        size = os.path.getsize(self.path)
        if str(self.path).endswith(".gz"):
            size *= 3
        return max(1, size // 8)

    # -- pass 1 + per-bucket dedup ------------------------------------------
    def prepare(self) -> tuple[int, int]:
        """Run the spill and dedup passes; returns exact ``(|V|, |E|)``.

        Idempotent — the first call does the work, later calls return the
        cached counts (the merge iterator calls it defensively).
        """
        if self._prepared:
            return self.num_vertices, self.num_edges
        st = self.stats
        nb = int(min(MAX_BUCKETS,
                     max(1, -(-self._estimate_rows() // st.bucket_rows))))
        st.num_buckets = nb
        # pass 1: stamp arrival indices, split each block by bucket hash,
        # append (idx, u, v) triples — sequential appends, no seeks; the
        # vertex bound (which keys the bucket dedup) folds into this scan,
        # so the text file is parsed exactly once (pass 2 reads binary
        # buckets only)
        raw = [self.spill_dir / f"bucket{b}.raw" for b in range(nb)]
        files = [open(p, "wb") for p in raw]
        n_v = 0
        try:
            base = 0
            for blk in iter_edge_blocks(self.path, self.block_size,
                                        comments=self.comments):
                st._saw(len(blk))
                n_v = max(n_v, int(blk.max()) + 1)
                u, v = blk[:, 0], blk[:, 1]
                idx = np.arange(base, base + len(blk), dtype=np.int64)
                base += len(blk)
                h = _bucket_of(u, v, nb)
                order = np.argsort(h, kind="stable")
                rows = np.stack([idx, u, v], axis=1)[order]
                hs = h[order]
                bounds = np.searchsorted(hs, np.arange(nb + 1))
                for b in range(nb):
                    lo, hi = bounds[b], bounds[b + 1]
                    if hi > lo:
                        rows[lo:hi].tofile(files[b])
            st.spilled_rows = base
            self.num_vertices = n_v
        finally:
            for f in files:
                f.close()
        # pass 2a: exact dedup per bounded bucket, written back sorted by
        # arrival index (keep-first == min index: file order is arrival
        # order, np.unique's return_index picks the first occurrence)
        unique = 0
        for b in range(nb):
            arr = np.fromfile(raw[b], dtype=np.int64).reshape(-1, 3)
            raw[b].unlink()
            st.max_bucket_rows = max(st.max_bucket_rows, len(arr))
            st._saw(len(arr))
            if len(arr):
                key = arr[:, 1] * np.int64(max(1, n_v)) + arr[:, 2]
                _, first = np.unique(key, return_index=True)
                first.sort()
                arr = arr[first]
                arr.tofile(self.spill_dir / f"bucket{b}.dedup")
            unique += len(arr)
        st.unique_edges = unique
        self.num_edges = unique
        self._prepared = True
        return self.num_vertices, self.num_edges

    # -- pass 2b: ordered streaming merge -----------------------------------
    def __iter__(self) -> Iterator[np.ndarray]:
        """Yield ``(<=block_size, 2)`` globally-unique blocks in
        first-occurrence order, holding only ``num_buckets × merge_rows``
        rows of merge buffer plus one emit batch."""
        self.prepare()
        st = self.stats
        nb = st.num_buckets
        paths = [self.spill_dir / f"bucket{b}.dedup" for b in range(nb)]
        readers = [open(p, "rb") if p.exists() else None for p in paths]
        empty = np.empty((0, 3), dtype=np.int64)
        bufs = [empty] * nb
        done = [r is None for r in readers]
        try:
            while True:
                for b in range(nb):
                    if not len(bufs[b]) and not done[b]:
                        raw = readers[b].read(3 * 8 * st.merge_rows)
                        if raw:
                            bufs[b] = np.frombuffer(
                                raw, dtype=np.int64).reshape(-1, 3)
                        if len(raw) < 3 * 8 * st.merge_rows:
                            done[b] = True
                # rows beyond a live reader's buffer all carry larger
                # arrival indices (buckets are idx-sorted), so the safe
                # emit frontier is the smallest last-buffered index
                tails = [bufs[b][-1, 0] for b in range(nb)
                         if not done[b] and len(bufs[b])]
                frontier = min(tails) if tails else None
                parts = []
                for b in range(nb):
                    buf = bufs[b]
                    if not len(buf):
                        continue
                    cut = (len(buf) if frontier is None else
                           int(np.searchsorted(buf[:, 0], frontier,
                                               side="right")))
                    if cut:
                        parts.append(buf[:cut])
                        bufs[b] = buf[cut:]
                if not parts:
                    if all(done[b] and not len(bufs[b]) for b in range(nb)):
                        return
                    continue
                batch = np.concatenate(parts, axis=0)
                batch = batch[np.argsort(batch[:, 0], kind="stable")]
                st._saw(len(batch) + sum(len(x) for x in bufs))
                for lo in range(0, len(batch), self.block_size):
                    yield batch[lo:lo + self.block_size, 1:]
        finally:
            for r in readers:
                if r is not None:
                    r.close()

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Remove the spill directory (only if this object created it)."""
        if self._owns_dir and self.spill_dir.exists():
            shutil.rmtree(self.spill_dir, ignore_errors=True)

    def __enter__(self) -> "TwoPassDedup":
        self.prepare()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def two_pass_dedup(path: str, spill_dir: str | None = None,
                   **kw) -> TwoPassDedup:
    """Prepared :class:`TwoPassDedup` over ``path`` (see the class docs)."""
    tp = TwoPassDedup(path, spill_dir, **kw)
    tp.prepare()
    return tp
