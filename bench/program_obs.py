"""The program's own spans and counters (``repro_torch.obs``), as the
metric readers of a traced run find them once the run has ended.

``repro_torch.obs`` keeps totals for the whole process, and ``run.py``
runs one cell a process: so WindGP, the pack and the layout of an app
cell's set-up are each the one span of their name, and the per-query
totals are those of the run's queries (the warm-up, the window's and the
profiled sessions'), which all run the same query on the same partition.
A program without ``repro_torch.obs`` gives nothing to read.
"""
from __future__ import annotations


def totals(r) -> dict | None:
    """``repro_torch.obs.snapshot()`` after the traced run that gave the
    readings ``r``; None where the run was not traced or the program has
    no ``repro_torch.obs``."""
    if r.trace is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.snapshot()


def once_s(r, name: str) -> float | None:
    """Seconds of the span ``name`` where the process ran it once (a step
    of set-up); None otherwise."""
    t = totals(r)
    span = None if t is None else t["spans"].get(name)
    return span["total_s"] if span and span["count"] == 1 else None


def per_query(r, value) -> float | None:
    """``value(totals)`` over the run's queries, each of which prepares
    once (the count of ``bsp.prepare`` spans); None where no query ran or
    ``value`` finds nothing (it returns None)."""
    t = totals(r)
    if t is None or not r.queries or "bsp.prepare" not in t["spans"]:
        return None
    v = value(t)
    return None if v is None else v / t["spans"]["bsp.prepare"]["count"]
