"""Unified partitioner registry: one surface over every partitioning method.

Historically each consumer (the launch CLI, the benchmark tables, the BSP
runtime packer, the examples) kept its own ad-hoc ``PARTITIONERS`` dict and
special-cased WindGP.  This module is the single home: every method —
streaming baselines, NE, the METIS-like multilevel scheme, and the WindGP
driver variants — registers a :class:`Partitioner` record carrying its
name, kind, capability tags, and accepted knobs, and consumers resolve
methods through :func:`get`/:func:`names` instead of hand-rolled dicts.

Capability tags in use:

* ``heterogeneous`` — optimizes the paper's heterogeneous TC objective
  (all methods get the memory-cap adaptation regardless).
* ``blocked``  — streams edges through the block engine; accepts
  ``block_size`` and can run graph-free over an edge-block iterator.
* ``streamable`` — carries a graph-free ``stream`` entry point
  (``stream(source, |V|, |E|, cluster, **knobs)``) that partitions an
  edge-list path or block iterator out of core; its ``dedup`` knob picks
  single-pass per-block dedup (``"block"``) or the exact two-pass
  spill-to-disk dedup (``"two_pass"``).
* ``parallel`` — the ``stream`` entry accepts ``workers``/``sync_blocks``
  and can run the W-process pipeline (``core/parallel.py``): sharded
  two-pass dedup plus parallel wave scoring against membership snapshots
  synced every ``sync_blocks`` engine blocks.  ``workers=1`` is the
  sequential path bit for bit; results at any worker count depend only
  on ``sync_blocks``.
* ``oracle``   — per-edge reference loop kept for equivalence tests;
  excluded from the default benchmark surface.
* ``driver``   — full multi-phase driver (WindGP), returns via
  ``windgp(...)`` internally and exposes its knobs.

Implementations self-register at import; :func:`_ensure_builtin` makes any
entry point (CLI, benchmarks, tests) see the full set without import-order
footguns.  The legacy ``core.baselines.PARTITIONERS`` dict is now a
snapshot of this registry (oracles excluded).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np

_REGISTRY: dict[str, "Partitioner"] = {}


@dataclasses.dataclass(frozen=True)
class Partitioner:
    """One registered partitioning method.

    ``fn(g, cluster, **knobs) -> (E,) int assignment``; calling the record
    itself validates knob names first, so CLI/benchmark typos fail loudly
    instead of landing in ``**kwargs`` silence.
    """

    name: str
    fn: Callable[..., np.ndarray]
    kind: str                       # streaming | expansion | multilevel | driver
    description: str = ""
    capabilities: frozenset = frozenset()
    knobs: tuple = ()               # accepted keyword-knob names
    stream_fn: Callable | None = None   # graph-free out-of-core entry
    stream_knobs: tuple = ()            # keyword-knob names it accepts

    def _knob_error(self, unknown: set, valid: tuple,
                    entry: str = "") -> TypeError:
        """Unknown-knob error naming the partitioner and its valid knobs."""
        what = (f"valid knobs for {self.name!r}{entry}: {sorted(valid)}"
                if valid else f"{self.name!r}{entry} accepts no knobs")
        return TypeError(
            f"partitioner {self.name!r}{entry} got unknown knob(s) "
            f"{sorted(unknown)}; {what}")

    def __call__(self, g, cluster, **kw) -> np.ndarray:
        unknown = set(kw) - set(self.knobs)
        if unknown:
            raise self._knob_error(unknown, self.knobs)
        return self.fn(g, cluster, **kw)

    def stream(self, source, num_vertices=None, num_edges=None,
               cluster=None, **kw):
        """Graph-free out-of-core run (``streamable`` capability only).

        ``source`` is an edge-list path, a block iterator, or a prepared
        ``TwoPassDedup``; returns the end-of-stream ``StreamMembership``.
        """
        if self.stream_fn is None:
            raise TypeError(
                f"partitioner {self.name!r} cannot stream "
                f"(capabilities: {sorted(self.capabilities)})")
        unknown = set(kw) - set(self.stream_knobs)
        if unknown:
            raise self._knob_error(unknown, self.stream_knobs, " stream")
        return self.stream_fn(source, num_vertices, num_edges, cluster, **kw)

    def supports(self, capability: str) -> bool:
        return capability in self.capabilities


def register(p: Partitioner) -> Partitioner:
    """Add (or replace, e.g. in tests) a registry entry."""
    _REGISTRY[p.name] = p
    return p


def _ensure_builtin() -> None:
    # Deferred so the registry module itself stays import-cycle-free: the
    # implementations import ``register`` from here at their module bottom.
    from . import windgp      # noqa: F401  (registers driver variants)
    from . import baselines   # noqa: F401  (registers streaming/ne/metis)


def get(name: str) -> Partitioner:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown partitioner {name!r}; registered: {names()}") from None


def names(*, require: Iterable[str] = (),
          exclude: Iterable[str] = ()) -> list[str]:
    """Sorted registered names, filtered by capability tags."""
    _ensure_builtin()
    req, exc = set(require), set(exclude)
    return sorted(n for n, p in _REGISTRY.items()
                  if req <= p.capabilities and not (exc & p.capabilities))


def partitioner_dict(*, exclude: Iterable[str] = ()) -> dict[str, Partitioner]:
    """Snapshot ``{name: partitioner}`` — the legacy-dict compatibility view."""
    return {n: get(n) for n in names(exclude=exclude)}


def run(name: str, g, cluster, **knobs) -> np.ndarray:
    """Resolve and run in one call."""
    return get(name)(g, cluster, **knobs)
