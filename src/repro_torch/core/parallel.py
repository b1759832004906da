"""W-worker parallel partitioning: sharded dedup + synced wave scoring.

Everything downstream of the partitioner is vectorized and device-
parallel; this module parallelizes the partitioner itself — the counting/
dedup/streaming passes that are the wall-clock bottleneck at scale — in
the shape DGL's distpartitioning tools use, while keeping every process
boundary message-passing-clean (plain arrays over queues) so multi-host
later is a transport swap, not a redesign.  Three stages:

**Sharded ingest/dedup** (:class:`ShardedTwoPassDedup`).  Pass one
range-partitions the raw edge list into ``W`` byte ranges
(``data/io.byte_ranges`` + the Hadoop-style line-alignment rule), each
read by one worker that stamps *composite* arrival indices
``(range_id << 44) | local_idx`` and spills ``(idx, u, v)`` triples into
the same hash buckets as the sequential :class:`~repro_torch.data.TwoPassDedup`
(per-``(bucket, range)`` part files, so writers never contend).  Because
the composite index is an order-preserving map of global file position,
pass two — buckets dedup'd keep-first in parallel, each worker owning a
disjoint bucket range — and the inherited ordered merge yield a stream
*identical block for block* to the sequential dedup: every duplicate pair
hashes to one bucket regardless of which range read it, and the kept row
is the pair's true first file occurrence under any chunking.  Per-worker
``SpillStats`` peaks sum into the global residency bound.

**Parallel wave scoring** (:func:`parallel_stream_partition`).  The edge
stream is re-chunked into engine blocks ("units") exactly as
``stream_partition`` does; every ``sync_blocks`` (K) consecutive units
form an *epoch*.  Units of an epoch are scored concurrently by W
long-lived workers, each running the unmodified ``_BlockEngine`` over its
own replica of the global ``StreamMembership`` frozen at the epoch start
(HDRF's partial-degree stream facts are stamped centrally, in arrival
order, and shipped with the unit).  At the epoch barrier each worker
reverts its local mutations (exact integer inverse), the coordinator
merges all admissions in unit order through the recount path
(``StreamMembership.apply_admissions``) and broadcasts them with the
per-machine |E|/|V| totals, so every replica is bitwise equal again.
Unadmitted stragglers carry into the next epoch's first unit, and a final
flush unit drains them at stream end.

The schedule depends only on K — never on W — so results are
*worker-count invariant* at any ``sync_blocks``, and at ``sync_blocks=1``
every unit sees fully fresh state, which makes the pipeline bit-identical
to sequential ``stream_partition`` (same membership, totals, and sink
byte stream; a fresh engine per unit is equivalent to the persistent
engine because waves are a pure function of (state, pending, aux)).
Larger K trades a bounded membership staleness window (quality-gated in
CI at the default) for W-way scoring overlap.

**Merge**.  Placements replay through the caller's sink on the
coordinator, in unit order — one ``StreamAssignment`` product, one
finalize, so ``PartitionRuntime.from_stream`` and the BSP layer are
untouched.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pathlib
import queue as _queue

import numpy as np

from ..data import io as _io
from .capacity import _mem_cap
from .partition_state import StreamMembership

#: engine blocks ("units") scored between epoch barriers — the K knob.
#: 1 = bit-identical to sequential; larger K amortizes the barrier over
#: more concurrent scoring at a bounded membership-staleness cost
#: (TC/RF gated within 2% of W=1 in benchmarks/parallel_scale.py).
DEFAULT_SYNC_BLOCKS = 4

#: composite arrival index: ``(range_id << _RANGE_SHIFT) | local_idx`` —
#: reader-major, so ascending composite order is ascending file position
#: (2^44 rows per range, 2^19 ranges before int64 runs out)
_RANGE_SHIFT = 44

#: seconds the coordinator waits on a worker result before declaring the
#: pool wedged (a worker crash would otherwise hang the barrier forever)
_RESULT_TIMEOUT = 600.0


def _mp_ctx():
    """Fork start method when available (cheap worker spin-up; the
    workers only ever touch numpy state built after the fork)."""
    methods = mp.get_all_start_methods()
    return mp.get_context("fork" if "fork" in methods else None)


# ---------------------------------------------------------------------------
# stage 1: sharded two-pass dedup
# ---------------------------------------------------------------------------

def _spill_range(task):
    """Pass 1 over one byte range: spill composite-stamped triples.

    Writes per-``(bucket, range)`` part files ``bucket<b>.r<rid>`` so
    concurrent readers never share a file handle.  Returns
    ``(rid, n_v, rows_spilled, peak_resident_rows)``.
    """
    (path, start, end, rid, nb, spill_dir, block_size, comments,
     whole) = task
    sd = pathlib.Path(spill_dir)
    files = [open(sd / f"bucket{b}.r{rid}", "wb") for b in range(nb)]
    n_v = 0
    base = 0
    peak = 0
    blocks = (_io.iter_edge_blocks(path, block_size, comments=comments)
              if whole else
              _io.iter_edge_blocks_range(path, start, end, block_size,
                                         comments=comments))
    try:
        for blk in blocks:
            peak = max(peak, len(blk))
            n_v = max(n_v, int(blk.max()) + 1)
            u, v = blk[:, 0], blk[:, 1]
            idx = ((np.int64(rid) << np.int64(_RANGE_SHIFT))
                   + np.arange(base, base + len(blk), dtype=np.int64))
            base += len(blk)
            h = _io._bucket_of(u, v, nb)
            order = np.argsort(h, kind="stable")
            rows = np.stack([idx, u, v], axis=1)[order]
            hs = h[order]
            bounds = np.searchsorted(hs, np.arange(nb + 1))
            for b in range(nb):
                lo, hi = bounds[b], bounds[b + 1]
                if hi > lo:
                    rows[lo:hi].tofile(files[b])
    finally:
        for f in files:
            f.close()
    return rid, n_v, base, peak


def _dedup_buckets(task):
    """Pass 2 over one worker's bucket range: exact keep-first dedup.

    Part files concatenate in range order — ascending composite index, so
    ``np.unique``'s first-occurrence pick is the pair's earliest global
    arrival, exactly as in the sequential pass.  Returns
    ``(unique_rows, max_bucket_rows, peak_resident_rows)``.
    """
    (spill_dir, buckets, n_ranges, n_v) = task
    sd = pathlib.Path(spill_dir)
    unique = 0
    max_rows = 0
    peak = 0
    for b in buckets:
        parts = []
        for rid in range(n_ranges):
            part = sd / f"bucket{b}.r{rid}"
            if part.exists():
                arr = np.fromfile(part, dtype=np.int64).reshape(-1, 3)
                part.unlink()
                if len(arr):
                    parts.append(arr)
        arr = (np.concatenate(parts) if parts
               else np.empty((0, 3), dtype=np.int64))
        max_rows = max(max_rows, len(arr))
        peak = max(peak, len(arr))
        if len(arr):
            key = arr[:, 1] * np.int64(max(1, n_v)) + arr[:, 2]
            _, first = np.unique(key, return_index=True)
            first.sort()
            arr = arr[first]
            arr.tofile(sd / f"bucket{b}.dedup")
        unique += len(arr)
    return unique, max_rows, peak


class ShardedTwoPassDedup(_io.TwoPassDedup):
    """`TwoPassDedup` with both passes range-sharded across ``workers``.

    Drop-in: :meth:`prepare` returns the same exact ``(|V|, |E|)``, and
    iterating yields the *identical* globally-deduplicated block stream
    (the composite arrival index is order-isomorphic to the sequential
    one, so the inherited k-way merge emits the same batches).  With
    ``workers=1`` — or a ``.gz`` input, which admits no byte-range reads —
    pass one runs sequentially; pass two still shards across workers.
    ``stats.peak_resident_rows`` sums the per-worker peaks per phase: an
    upper bound on *simultaneous* resident rows that scales with
    ``workers × bucket_rows``, never with the edge-set size.
    """

    def __init__(self, path, spill_dir: str | None = None, *,
                 workers: int = 1, **kw):
        super().__init__(path, spill_dir, **kw)
        self.workers = max(1, int(workers))
        self.stats.workers = self.workers

    def prepare(self) -> tuple[int, int]:
        if self._prepared or self.workers == 1:
            return super().prepare()
        st = self.stats
        nb = int(min(_io.MAX_BUCKETS,
                     max(1, -(-self._estimate_rows() // st.bucket_rows))))
        st.num_buckets = nb
        whole = str(self.path).endswith(".gz")
        ranges = ([(0, 0)] if whole
                  else _io.byte_ranges(self.path, self.workers))
        tasks = [(self.path, s, e, rid, nb, str(self.spill_dir),
                  self.block_size, self.comments, whole)
                 for rid, (s, e) in enumerate(ranges)]
        res1 = self._map(_spill_range, tasks)
        self.num_vertices = int(max((r[1] for r in res1), default=0))
        st.spilled_rows = int(sum(r[2] for r in res1))
        st._saw(sum(r[3] for r in res1))
        groups = [list(range(w, nb, self.workers))
                  for w in range(self.workers)]
        tasks2 = [(str(self.spill_dir), grp, len(ranges),
                   self.num_vertices) for grp in groups if grp]
        res2 = self._map(_dedup_buckets, tasks2)
        st.unique_edges = int(sum(r[0] for r in res2))
        st.max_bucket_rows = int(max((r[1] for r in res2), default=0))
        st._saw(sum(r[2] for r in res2))
        self.num_edges = st.unique_edges
        self._prepared = True
        return self.num_vertices, self.num_edges

    def _map(self, fn, tasks):
        if len(tasks) <= 1:
            return [fn(t) for t in tasks]
        with _mp_ctx().Pool(min(self.workers, len(tasks))) as pool:
            return pool.map(fn, tasks)


# ---------------------------------------------------------------------------
# stage 2: parallel wave scoring against synced membership snapshots
# ---------------------------------------------------------------------------

class _UnitLog:
    """``StreamMembership`` proxy that records one unit's admissions.

    The engine mutates the worker's state replica *through* this wrapper
    (reads pass straight down, so mid-unit waves see their own
    placements), while every admission is logged in admission order.  At
    unit end the worker exports the log for the epoch barrier and calls
    :meth:`revert` — the exact integer inverse — so the replica returns
    to the epoch-start snapshot before the next unit is scored.
    """

    def __init__(self, sm: StreamMembership):
        self._sm = sm
        self._verts0 = sm.verts_per.copy()
        self._us: list[np.ndarray] = []
        self._vs: list[np.ndarray] = []
        self._ms: list[np.ndarray] = []

    @property
    def cnt(self):
        return self._sm.cnt

    @property
    def edges_per(self):
        return self._sm.edges_per

    @property
    def verts_per(self):
        return self._sm.verts_per

    @property
    def p(self):
        return self._sm.p

    def endpoint_presence(self, u, v):
        return self._sm.endpoint_presence(u, v)

    def admit_block(self, u, v, es, ms, verts_delta=None):
        self._sm.admit_block(u, v, es, ms, verts_delta=verts_delta)
        self._us.append(np.asarray(u, dtype=np.int64))
        self._vs.append(np.asarray(v, dtype=np.int64))
        self._ms.append(np.asarray(ms, dtype=np.int64))

    def admit_single(self, u, v, e, i, verts_delta):
        self._sm.admit_single(u, v, e, i, verts_delta)
        self._us.append(np.array([u], dtype=np.int64))
        self._vs.append(np.array([v], dtype=np.int64))
        self._ms.append(np.array([i], dtype=np.int64))

    def admissions(self):
        """Concatenated ``(u, v, ms)`` in admission order."""
        if not self._us:
            e = np.empty(0, dtype=np.int64)
            return e, e.copy(), e.copy()
        return (np.concatenate(self._us), np.concatenate(self._vs),
                np.concatenate(self._ms))

    def verts_delta(self) -> np.ndarray:
        """Per-machine |V_i| delta this unit actually produced."""
        return self._sm.verts_per - self._verts0

    def revert(self) -> None:
        u, v, ms = self.admissions()
        if len(u):
            self._sm.revert_admissions(u, v, ms, self.verts_delta())


def _score_worker(task_q, result_q, cfg):
    """Long-lived scoring worker: fresh engine per unit, revert, sync.

    Messages in (plain tuples of arrays — the multi-host transport
    boundary): ``("unit", uid, u, v, aux, flush)``,
    ``("sync", u, v, ms, (edges_per, verts_per))``, ``("stop",)``.
    Results out: ``(uid, adm_u, adm_v, adm_ms, (left_u, left_v,
    left_aux))``.
    """
    (method, scorer_kw, p, num_vertices, num_edges, caps, eng_kw) = cfg
    from .baselines import streaming as _s
    scorer = _s.SCORERS[method](**scorer_kw)
    if hasattr(scorer, "reset"):
        # stream facts (HDRF partial degrees) arrive precomputed with each
        # unit; the local scorer state exists only for stateless block_aux
        scorer.reset(num_vertices)
    state = StreamMembership.empty(num_vertices, p)
    nV = max(1, num_vertices)
    while True:
        msg = task_q.get()
        if msg[0] == "stop":
            return
        if msg[0] == "sync":
            _, su, sv, sms, totals = msg
            if len(su):
                state.apply_admissions(su, sv, sms)
            if not (np.array_equal(state.edges_per, totals[0])
                    and np.array_equal(state.verts_per, totals[1])):
                raise AssertionError(
                    "epoch barrier desync: worker replica totals diverge "
                    "from the coordinator's")
            continue
        _, uid, uu, vv, aux, flush = msg
        log = _UnitLog(state)
        eng = _s._BlockEngine(log, scorer, caps, num_edges, nV,
                              sink=None, **eng_kw)
        eng.push(uu, vv, aux=aux)
        if flush:
            eng.flush()
        left = (eng.u, eng.v, eng.aux)
        adm = log.admissions()
        log.revert()
        result_q.put((uid, *adm, left))


def _iter_unit_blocks(blocks, B: int):
    """Re-chunk a block source to exact ``B``-row units.

    Mirrors ``stream_partition``'s re-chunk loop: unit boundaries — and
    therefore the schedule, which depends only on them and K — must not
    depend on how the source happened to chunk the stream.
    """
    pend: list = []
    npend = 0
    for edges in blocks:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if not len(edges):
            continue
        pend.append(edges)
        npend += len(edges)
        if npend < B:
            continue
        buf = np.concatenate(pend) if len(pend) > 1 else pend[0]
        lo = 0
        while lo + B <= len(buf):
            yield buf[lo:lo + B]
            lo += B
        pend = [buf[lo:]] if lo < len(buf) else []
        npend = len(buf) - lo
    if npend:
        yield np.concatenate(pend) if len(pend) > 1 else pend[0]


def _cat_aux(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return np.concatenate([a, b])


def parallel_stream_partition(source, num_vertices: int | None = None,
                              num_edges: int | None = None,
                              cluster=None, method: str = "hdrf", *,
                              workers: int = 2,
                              sync_blocks: int | None = None,
                              dedup: str = "block",
                              spill_dir: str | None = None,
                              bucket_rows: int = 1 << 16,
                              block_size: int | None = None,
                              max_waves: int | None = None,
                              replica_frac: float | None = None,
                              creator_scalar: bool | None = None,
                              sink=None, **scorer_kw) -> StreamMembership:
    """``stream_partition`` semantics across ``workers`` processes.

    Same contract and knobs as
    :func:`repro_torch.core.baselines.streaming.stream_partition` plus
    ``workers`` / ``sync_blocks`` (see the module docstring for the epoch
    scheme).  ``workers=1`` delegates to the sequential path unchanged —
    the bit-reproducible fallback.  With a path source and
    ``dedup="two_pass"`` the spill/dedup passes shard across the same
    worker count (:class:`ShardedTwoPassDedup`).  The sink runs on the
    coordinator only, in unit order — one shard product regardless of W.
    """
    from .baselines import streaming as _s
    workers = max(1, int(workers))
    if workers == 1:
        return _s.stream_partition(
            source, num_vertices, num_edges, cluster, method, dedup=dedup,
            spill_dir=spill_dir, bucket_rows=bucket_rows,
            block_size=block_size, max_waves=max_waves,
            replica_frac=replica_frac, creator_scalar=creator_scalar,
            sink=sink, **scorer_kw)
    if (isinstance(source, (str, os.PathLike)) and dedup == "two_pass"):
        tp = ShardedTwoPassDedup(source, spill_dir,
                                 bucket_rows=bucket_rows, workers=workers)
        nv, ne = tp.prepare()
        blocks, num_vertices, num_edges = tp, nv, ne
        spill, owned = tp, True
    else:
        blocks, num_vertices, num_edges, spill, owned = \
            _s._resolve_stream_source(
                source, num_vertices, num_edges, dedup=dedup,
                spill_dir=spill_dir, bucket_rows=bucket_rows,
                io_block=block_size)
    scorer = _s.SCORERS[method](**scorer_kw)
    if hasattr(scorer, "reset"):
        scorer.reset(num_vertices)
    dflt = _s.ENGINE_DEFAULTS[method]
    if block_size is None:
        block_size = dflt["block_size"] or _s.auto_block_size(num_edges)
    B = max(1, int(block_size))
    eng_kw = dict(
        block_size=B,
        max_waves=dflt["max_waves"] if max_waves is None else max_waves,
        replica_frac=(dflt["replica_frac"] if replica_frac is None
                      else replica_frac),
        creator_scalar=(dflt["creator_scalar"] if creator_scalar is None
                        else creator_scalar))
    caps = np.floor(_mem_cap(cluster, num_vertices,
                             num_edges)).astype(np.int64)
    K = (DEFAULT_SYNC_BLOCKS if sync_blocks is None
         else max(1, int(sync_blocks)))
    state = StreamMembership.empty(num_vertices, cluster.p)

    ctx = _mp_ctx()
    cfg = (method, scorer_kw, cluster.p, num_vertices, num_edges, caps,
           eng_kw)
    task_qs = [ctx.Queue() for _ in range(workers)]
    result_q = ctx.Queue()
    procs = [ctx.Process(target=_score_worker, args=(tq, result_q, cfg),
                         daemon=True) for tq in task_qs]
    for pr in procs:
        pr.start()
    uid = 0

    def run_epoch(units, flush):
        nonlocal uid
        ids = []
        for j, (uu, vv, aux) in enumerate(units):
            task_qs[j % workers].put(("unit", uid, uu, vv, aux, flush))
            ids.append(uid)
            uid += 1
        got = {}
        for _ in ids:
            try:
                r = result_q.get(timeout=_RESULT_TIMEOUT)
            except _queue.Empty:
                dead = [i for i, pr in enumerate(procs)
                        if not pr.is_alive()]
                raise RuntimeError(
                    f"parallel scoring stalled waiting for unit results "
                    f"(dead workers: {dead or 'none'})") from None
            got[r[0]] = r[1:]
        return [got[i] for i in ids]

    def merge_epoch(results):
        """Master-state merge + sink replay, in unit order."""
        parts_u, parts_v, parts_m = [], [], []
        for au, av, ams, _left in results:
            if len(au):
                if sink is not None:
                    sink(np.stack([au, av], axis=1), ams)
                parts_u.append(au)
                parts_v.append(av)
                parts_m.append(ams)
        if parts_u:
            cu = np.concatenate(parts_u)
            cv = np.concatenate(parts_v)
            cm = np.concatenate(parts_m)
            state.apply_admissions(cu, cv, cm)
        else:
            cu = np.empty(0, dtype=np.int64)
            cv, cm = cu.copy(), cu.copy()
        return cu, cv, cm

    try:
        units_src = _iter_unit_blocks(blocks, B)
        carry_u = np.empty(0, dtype=np.int64)
        carry_v = np.empty(0, dtype=np.int64)
        carry_aux = None
        while True:
            units = []
            for _ in range(K):
                blk = next(units_src, None)
                if blk is None:
                    break
                uu, vv = blk[:, 0].copy(), blk[:, 1].copy()
                units.append((uu, vv, scorer.block_aux(uu, vv)))
            if not units:
                break
            if len(carry_u):
                u0, v0, a0 = units[0]
                units[0] = (np.concatenate([carry_u, u0]),
                            np.concatenate([carry_v, v0]),
                            _cat_aux(carry_aux, a0))
                carry_u = carry_u[:0]
                carry_v = carry_v[:0]
                carry_aux = None
            results = run_epoch(units, flush=False)
            cu, cv, cm = merge_epoch(results)
            totals = state.totals()
            for tq in task_qs:
                tq.put(("sync", cu, cv, cm, totals))
            lefts = [r[3] for r in results]
            carry_u = np.concatenate([carry_u] + [l[0] for l in lefts])
            carry_v = np.concatenate([carry_v] + [l[1] for l in lefts])
            for l in lefts:
                carry_aux = _cat_aux(carry_aux, l[2])
        if len(carry_u):
            # final flush unit: drain the carried stragglers to empty on
            # one worker (already synced to the master state)
            results = run_epoch([(carry_u, carry_v, carry_aux)],
                                flush=True)
            merge_epoch(results)
            left = results[0][3]
            if len(left[0]):
                raise AssertionError(
                    f"flush left {len(left[0])} unplaced edges")
    finally:
        for tq in task_qs:
            try:
                tq.put(("stop",))
            except Exception:
                pass
        for pr in procs:
            pr.join(timeout=30)
            if pr.is_alive():
                pr.terminate()
        if owned:
            spill.close()
    if spill is not None:
        state.spill_stats = spill.stats
    return state
