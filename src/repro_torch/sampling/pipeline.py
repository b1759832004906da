"""Async prefetch pipeline: overlap sampling with feature resolution.

Training wants ``(MiniBatch, features)`` pairs at a steady cadence; the
two stages that produce one — the fused k-hop device sample and the
feature resolve (shard gathers on the device + halo-cache bookkeeping on
the host) — use the host and the device differently, so
:class:`PrefetchPipeline` overlaps them graphbolt-datapipe-style: a
bounded **sample** stage (seed draw → fused k-hop sample) feeds a
bounded **feature** stage (cache lookup → deduplicated halo fetch)
through depth-``depth`` queues, so batch ``i+1``'s sampling runs while
batch ``i``'s features are still being fetched.

Determinism is structural, not accidental:

* batch ``i``'s generators derive only from ``(seed, i)``
  (:func:`batch_generators`: one for the seed draw, one for the hop
  uniforms), so no stage ordering can change the sampled ids;
* the feature stage processes batches strictly in index order (one
  worker, FIFO queues), so the halo cache sees the same
  lookup/insert/evict sequence at every depth.

Hence ``depth=0`` (fully synchronous, no threads) and any ``depth >= 1``
yield **bitwise identical** batches, features, and cache stats — the
depth knob trades memory for overlap, never results.  On a CUDA device
both workers issue their work on the stream that was current when the
pipeline was built, so the feature stage's gathers are ordered after the
sample stage's writes by the stream itself, with no event between them,
and the consumer's stream sees both.  Worker exceptions propagate to the
consumer on its next ``__next__`` (wrapped queues, no silent death), and
:meth:`close` shuts both workers down cleanly mid-iteration (also invoked
by ``with`` exit and on exhaustion).
"""
from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch


def batch_generators(seed: int, i: int, device) -> tuple:
    """The ``(seed draw, hop uniforms)`` generators of batch ``i`` of a
    pipeline seeded with ``seed``, on ``device`` — a function of
    ``(seed, i)`` alone."""
    states = np.random.SeedSequence([int(seed), int(i)]).generate_state(
        2, dtype=np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in states)


class _Err:
    """A worker exception crossing a stage queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


class PrefetchPipeline:
    """Bounded-depth double-buffered ``(MiniBatch, features)`` producer.

    Iterate it (``for mb, feats in pipeline``) or call ``next()``;
    ``feats`` is ``None`` when no ``store`` is given, otherwise the
    ``(len(mb.all_ids()), F)`` rows resolved through ``store``/``cache``
    for the batch's seeds + every hop, in that order.
    """

    def __init__(self, service, *, home: int, batch_size: int,
                 num_batches: int, seed: int, depth: int = 2, store=None,
                 cache=None, train_mask=None, fused: bool = True):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        if num_batches < 0:
            raise ValueError(f"num_batches must be >= 0, "
                             f"got {num_batches}")
        if cache is not None and store is None:
            raise ValueError("cache= without store= — the cache fronts "
                             "the feature store's remote fetches")
        self.service = service
        self.home = int(home)
        self.batch_size = int(batch_size)
        self.num_batches = int(num_batches)
        self.seed = int(seed)
        self.depth = int(depth)
        self.store = store
        self.cache = cache
        self.train_mask = train_mask
        self.fused = bool(fused)
        self._stream = (torch.cuda.current_stream(service.device)
                        if service.device.type == "cuda" else None)
        self._emitted = 0
        self._closed = False
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._q_sample = None
        self._q_out = None

    # -- the two stages (shared verbatim by sync and threaded modes) ------

    def _sample_batch(self, i: int):
        """Stage 1 — generators from ``(seed, i)`` only, then one fused
        k-hop sample; independent of pipeline depth by construction."""
        g_seed, g_hop = batch_generators(self.seed, i, self.service.device)
        seeds = self.service.local_seeds(self.home, self.batch_size,
                                         g_seed, self.train_mask)
        return self.service.sample(seeds, g_hop, home=self.home,
                                   fused=self.fused)

    def _resolve_features(self, mb):
        """Stage 2 — the batch's feature rows via shard + halo cache."""
        if self.store is None:
            return mb, None
        feats, _ = self.store.gather(mb.all_ids(), self.home, self.cache)
        return mb, feats

    # -- threaded plumbing -------------------------------------------------

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _put(self, q, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _sample_worker(self):
        try:
            with self._on_stream():
                for i in range(self.num_batches):
                    if self._stop.is_set():
                        return
                    if not self._put(self._q_sample, self._sample_batch(i)):
                        return
        except BaseException as exc:  # noqa: BLE001 — forwarded, not eaten
            self._put(self._q_sample, _Err(exc))
            return
        self._put(self._q_sample, _DONE)

    def _feature_worker(self):
        with self._on_stream():
            while not self._stop.is_set():
                try:
                    item = self._q_sample.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is _DONE or isinstance(item, _Err):
                    self._put(self._q_out, item)
                    return
                try:
                    out = self._resolve_features(item)
                except BaseException as exc:  # noqa: BLE001
                    self._put(self._q_out, _Err(exc))
                    return
                if not self._put(self._q_out, out):
                    return

    def _ensure_started(self):
        if self._threads or self.depth == 0:
            return
        self._q_sample = queue.Queue(maxsize=self.depth)
        self._q_out = queue.Queue(maxsize=self.depth)
        self._threads = [
            threading.Thread(target=self._sample_worker,
                             name="prefetch-sample", daemon=True),
            threading.Thread(target=self._feature_worker,
                             name="prefetch-features", daemon=True),
        ]
        for t in self._threads:
            t.start()

    # -- consumer surface --------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed or self._emitted >= self.num_batches:
            self.close()
            raise StopIteration
        if self.depth == 0:
            with self._on_stream():
                out = self._resolve_features(
                    self._sample_batch(self._emitted))
            self._emitted += 1
            return out
        self._ensure_started()
        while True:
            try:
                item = self._q_out.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
                if not any(t.is_alive() for t in self._threads):
                    raise RuntimeError(
                        "prefetch workers exited without a sentinel — "
                        "pipeline state is corrupt") from None
        if isinstance(item, _Err):
            self.close()
            raise item.exc
        if item is _DONE:
            self.close()
            raise StopIteration
        self._emitted += 1
        return item

    def close(self):
        """Stop both workers and drop queued batches.  Safe to call
        mid-iteration, repeatedly, or from ``with`` exit; returns after
        the workers have exited."""
        self._closed = True
        self._stop.set()
        for q in (self._q_sample, self._q_out):
            if q is None:
                continue
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=10.0)
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
