"""Spans and counters of the program's own steps.

``span(name)`` times one step on the host's ``perf_counter_ns`` and keeps,
for each name, how often it ran (``count``), its seconds (``total_s``) and
its seconds less those of the spans opened inside it on the same thread
(``self_s``).  While a ``torch.profiler`` session records, a span also
opens a FUNCTION-scope record range named ``repro_torch.<name>``: it lands
among the profiler's host events, on the clock of the device events, and
gives no device-side annotation.  (``torch.profiler.record_function``
makes a user annotation, which the profiler also lays over the device's
timeline, where it would read as device work.)

``count(name, n)`` adds to an integer counter.  ``snapshot()`` copies the
spans' and counters' totals, and ``delta(after, before)`` is what happened
between two snapshots.  A span neither synchronises with the device nor
allocates on it, so it may sit inside a CUDA-graph capture, where it
records the host's time as anywhere else.

A BSP query (``bsp/apps.py``) counts its static tree: ``bsp.h2d_bytes``
the bytes it copies to the device where it builds the tree (a runtime's
first query), ``bsp.tree_hits`` one where it finds the tree resident, so
``bsp.prepare``'s count less ``bsp.tree_hits`` is the number of builds.

    with obs.span("bsp.prepare"):
        ...
    obs.count("bsp.h2d_bytes", nbytes)
    before = obs.snapshot(); ...; obs.delta(obs.snapshot(), before)
"""
from __future__ import annotations

import threading
import time

import torch

#: the profiler's name of a span is this prefix and the span's name
PREFIX = "repro_torch."

_lock = threading.Lock()
_spans: dict = {}            # name -> [count, total ns, self ns]
_counters: dict = {}         # name -> int
_open = threading.local()    # .stack: this thread's open spans


class span:
    """A context manager that times one step under ``name``; after it
    closes, ``seconds`` is this step's time."""

    __slots__ = ("name", "ns", "_t0", "_inner", "_range")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0

    @property
    def seconds(self) -> float:
        return self.ns / 1e9

    def __enter__(self) -> "span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        stack.append(self)
        self._inner = 0
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _open.stack
        stack.pop()
        if stack:
            stack[-1]._inner += ns
        self.ns = ns
        with _lock:
            rec = _spans.get(self.name)
            if rec is None:
                rec = _spans[self.name] = [0, 0, 0]
            rec[0] += 1
            rec[1] += ns
            rec[2] += ns - self._inner
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def snapshot() -> dict:
    """A copy of every span's totals and every counter:
    ``{"spans": {name: {"count", "total_s", "self_s"}},
    "counters": {name: n}}``."""
    with _lock:
        spans = {name: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9}
                 for name, (c, t, s) in _spans.items()}
        return {"spans": spans, "counters": dict(_counters)}


def delta(after: dict, before: dict) -> dict:
    """What happened between two snapshots: the spans that closed and the
    counters that moved in between, in ``snapshot()``'s form."""
    none = {"count": 0, "total_s": 0.0, "self_s": 0.0}
    spans = {}
    for name, a in after["spans"].items():
        b = before["spans"].get(name, none)
        if a["count"] > b["count"]:
            spans[name] = {k: a[k] - b[k] for k in none}
    counters = {name: n - before["counters"].get(name, 0)
                for name, n in after["counters"].items()
                if n != before["counters"].get(name, 0)}
    return {"spans": spans, "counters": counters}
