"""Dynamic-graph incremental repartitioning (the live-traffic layer).

WindGP computes a partition once; this module keeps it healthy while the
graph evolves.  A :class:`DynamicPartitioner` wraps the shared incremental
accounting (``PartitionState`` over a :class:`~repro_torch.core.graph.
GrowableGraph`) and accepts an edge insert/delete stream against live
state:

* **inserts** are scored by the existing block-stream wave engine
  (``core/baselines/streaming.py``) against the live ``(p, V)``
  membership — the same scorer that would have placed them in a cold
  stream, so a quiet timeline converges to the static streaming
  partition;
* **deletes** route through ``PartitionState.remove_edges`` (exact
  Eq. 3/4 rollback); deleted edges keep their canonical id, so a later
  re-insert of the same pair reuses it and every downstream id-keyed
  structure stays valid;
* a **drift monitor** in the SDP tradition (arXiv 2110.15669) watches
  two health signals after every batch — balance skew
  ``max(T_i)/mean(T_i)`` and the replication factor — and when either
  crosses its threshold triggers a *bounded* repair: SLS destroy–repair
  waves (``sls.repair_edges``, arXiv 2012.09451) scoped to the edges of
  **overloaded machines incident to the touched frontier** (the vertices
  mutated since the last repair), never the whole graph.

Epoch deltas close the loop to the BSP side: :meth:`DynamicPartitioner.
snapshot` captures the assignment, :meth:`delta_since` diffs live state
against a snapshot into an :class:`AssignmentDelta` — add/remove
coalesced per edge, exactly what ``StreamAssignment.apply_delta``
(append + tombstone shard segments) and ``PartitionRuntime.apply_delta``
(in-place repack of the touched machines) consume.

Timeline replay, latency percentiles, and TC-vs-scratch drift live in
``benchmarks/dynamic_replay.py`` (tier-2 CI job ``dynamic``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .capacity import _mem_cap
from .graph import GrowableGraph
from .machines import Cluster
from .partition_state import PartitionState
from .baselines.streaming import ENGINE_DEFAULTS, SCORERS, _BlockEngine
from .sls import repair_edges


def _canonical(uv: np.ndarray) -> np.ndarray:
    """(k, 2) int64 canonical (u < v) pairs: loops dropped, batch-deduped
    keeping first occurrence, arrival order preserved."""
    uv = np.asarray(uv, dtype=np.int64).reshape(-1, 2)
    if (uv < 0).any():
        raise ValueError("negative vertex ids")
    u = np.minimum(uv[:, 0], uv[:, 1])
    v = np.maximum(uv[:, 0], uv[:, 1])
    keep = u != v
    u, v = u[keep], v[keep]
    key = (u << np.int64(32)) | v
    _, first = np.unique(key, return_index=True)
    first.sort()
    return np.stack([u[first], v[first]], axis=1)


@dataclasses.dataclass(frozen=True)
class AssignmentDelta:
    """Coalesced assignment diff between two epochs.

    ``added``/``added_ms``: edges live now but not at the snapshot (or
    live on a different machine), with their current machine.
    ``removed``/``removed_ms``: edges live at the snapshot but not now
    (or moved away), with the machine they left.  A moved edge appears in
    both — remove from the old shard, append to the new one.  An edge
    inserted *and* deleted within the epoch appears in neither: the diff
    is against assignments, not the operation log, so deltas
    auto-coalesce.
    """

    num_vertices: int
    added: np.ndarray        # (a, 2) int64 canonical endpoints
    added_ms: np.ndarray     # (a,)   int64 destination machines
    removed: np.ndarray      # (r, 2) int64 canonical endpoints
    removed_ms: np.ndarray   # (r,)   int64 source machines

    @property
    def num_changes(self) -> int:
        return len(self.added) + len(self.removed)

    def machines_touched(self, p: int) -> np.ndarray:
        """(p,) bool — machines whose edge set changed this epoch."""
        touched = np.zeros(p, dtype=bool)
        touched[self.added_ms] = True
        touched[self.removed_ms] = True
        return touched


@dataclasses.dataclass(frozen=True)
class RepairReport:
    """One bounded repair wave: what triggered it and what it did."""

    trigger: str             # "skew" | "rf" | "forced"
    edges_moved: int
    tc_before: float
    tc_after: float


class DynamicPartitioner:
    """Live partition maintenance over an edge insert/delete stream.

    Parameters:
      g, cluster:   the starting graph (wrapped in a ``GrowableGraph``)
                    and machine profile.
      assign:       (E,) starting assignment; ``None`` partitions the
                    seed graph from scratch with ``method``.
      method:       block-stream scorer for arriving edges (``greedy`` |
                    ``hdrf`` | ``ebv``) — engine knobs come from the
                    per-method ``ENGINE_DEFAULTS``.
      skew_limit:   repair when ``max(T_i)/mean(T_i)`` exceeds this.
      rf_limit:     repair when RF exceeds this; ``None`` (the default)
                    keeps an *adaptive leash*: ``rf_leash ×`` a running
                    RF baseline re-anchored to the measured RF after
                    every repair epoch, so long churn timelines keep
                    tripping on relative drift instead of outgrowing a
                    threshold frozen at construction.  A float pins the
                    limit absolutely (and assigning ``dp.rf_limit = x``
                    later does the same).
      rf_leash:     the adaptive leash's relative slack (default 1.15 —
                    repair when RF drifts 15% above the last-repair
                    baseline); ignored when ``rf_limit`` is pinned.
      repair_gamma: a machine is *overloaded* when its T is within the
                    top ``(1-gamma)`` fraction of the T spread
                    (``sls.destroy_repair``'s threshold).
      repair_theta: destroy at most this fraction of each overloaded
                    machine's frontier-incident edges per repair.
      repair_cap:   hard ceiling on edges destroyed per repair (the
                    *bounded* in bounded repair); ``None`` = 4096.
      auto_repair:  run the drift monitor after every batch (default);
                    ``False`` leaves :meth:`maybe_repair` to the caller —
                    the replay benchmark uses this to time assignment and
                    repair separately.
    """

    def __init__(self, g, cluster: Cluster,
                 assign: np.ndarray | None = None, *,
                 method: str = "hdrf", seed: int = 0,
                 skew_limit: float = 1.35, rf_limit: float | None = None,
                 rf_leash: float = 1.15,
                 repair_gamma: float = 0.75, repair_theta: float = 0.25,
                 repair_cap: int | None = None, auto_repair: bool = True,
                 **scorer_kw):
        if method not in SCORERS:
            raise ValueError(f"method must be one of {sorted(SCORERS)}, "
                             f"got {method!r}")
        self.g = GrowableGraph.from_graph(g)
        self.cluster = cluster
        if assign is None:
            from . import partitioners as registry
            assign = registry.get(method)(self.g, cluster,
                                          seed=seed, **scorer_kw)
        assign = np.asarray(assign, dtype=np.int32)
        if len(assign) != self.g.num_edges:
            raise ValueError(f"assign has {len(assign)} entries for "
                             f"{self.g.num_edges} edges")
        self.state = PartitionState.build(self.g, assign, cluster)
        self.method = method
        self.scorer = SCORERS[method](**scorer_kw)
        if hasattr(self.scorer, "reset"):
            self.scorer.reset(self.g.num_vertices)
            # seed-partition history: arriving edges should see the seed
            # stream's partial degrees, not a blank slate
            if hasattr(self.scorer, "_pdeg"):
                np.add.at(self.scorer._pdeg, self.g.edges.ravel(), 1)
        self.skew_limit = float(skew_limit)
        self.rf_leash = float(rf_leash)
        self._rf_anchor = max(1.0, self._rf())
        self._rf_override = None if rf_limit is None else float(rf_limit)
        self.repair_gamma = float(repair_gamma)
        self.repair_theta = float(repair_theta)
        self.repair_cap = 4096 if repair_cap is None else int(repair_cap)
        self.auto_repair = bool(auto_repair)
        self._touched = np.zeros(self.g.num_vertices, dtype=bool)
        self.repairs: list[RepairReport] = []
        self.counters = {"inserted": 0, "deleted": 0, "reinserted": 0,
                         "repair_moves": 0}

    # -- health views --------------------------------------------------------
    def _rf(self) -> float:
        r = self.state.replicas
        covered = r > 0
        return float(r[covered].sum() / max(1, covered.sum()))

    @property
    def tc(self) -> float:
        return self.state.tc

    @property
    def skew(self) -> float:
        t = self.state.t_total
        mean = t.mean()
        return float(t.max() / mean) if mean > 0 else 1.0

    @property
    def rf(self) -> float:
        return self._rf()

    @property
    def rf_limit(self) -> float:
        """The live RF repair threshold: the pinned override when one was
        given, else ``rf_leash ×`` the running baseline (the RF measured
        at construction, re-anchored after every repair epoch)."""
        if self._rf_override is not None:
            return self._rf_override
        return self.rf_leash * self._rf_anchor

    @rf_limit.setter
    def rf_limit(self, value: float | None) -> None:
        """Pin the threshold absolutely (``None`` returns to adaptive)."""
        self._rf_override = None if value is None else float(value)

    @property
    def num_live_edges(self) -> int:
        return int((self.state.assign >= 0).sum())

    def membership(self) -> np.ndarray:
        """(p, V) bool — the live vertex-membership matrix."""
        return self.state.cnt > 0

    # -- internal plumbing ---------------------------------------------------
    def _grow_frontier(self) -> None:
        nv = self.g.num_vertices
        if nv > len(self._touched):
            self._touched = np.concatenate(
                [self._touched, np.zeros(nv - len(self._touched),
                                         dtype=bool)])

    def _caps(self) -> np.ndarray:
        """Per-machine edge caps from *live* totals (not the retired-id
        universe — deleted edges must free capacity)."""
        live_v = int((self.state.replicas > 0).sum())
        live_e = max(1, self.num_live_edges)
        return np.floor(_mem_cap(self.cluster, max(1, live_v),
                                 live_e)).astype(np.int64)

    # -- the stream API ------------------------------------------------------
    def insert(self, uv: np.ndarray) -> int:
        """Insert a batch of (u, v) pairs; returns how many were placed.

        Pairs are canonicalized (loops dropped, batch-deduped); pairs
        already live are skipped (idempotent).  Previously-deleted pairs
        reuse their canonical id; genuinely-new pairs (and vertices) grow
        the universe via ``PartitionState.append_edges``.  The whole batch
        is placed by one fresh wave engine against live membership, then
        the drift monitor runs.
        """
        uv = _canonical(uv)
        if not len(uv):
            return 0
        eids = self.g.eids_of(uv[:, 0], uv[:, 1])
        known = eids >= 0
        live = np.zeros(len(uv), dtype=bool)
        live[known] = self.state.assign[eids[known]] >= 0
        fresh = ~known
        if fresh.any():
            eids = eids.copy()
            eids[fresh] = self.state.append_edges(uv[fresh])
        place = ~live
        if not place.any():
            return 0
        es = eids[place]
        u = uv[place, 0]
        v = uv[place, 1]
        self._grow_frontier()
        if hasattr(self.scorer, "grow"):
            self.scorer.grow(self.g.num_vertices)
        live_e = self.num_live_edges + len(es)
        dflt = ENGINE_DEFAULTS[self.method]
        eng = _BlockEngine(
            self.state, self.scorer, self._caps(), live_e,
            max(1, self.g.num_vertices), block_size=max(1, len(es)),
            max_waves=dflt["max_waves"],
            replica_frac=dflt["replica_frac"],
            creator_scalar=dflt["creator_scalar"])
        eng.push(u, v, es)
        eng.flush()
        if self.state._costs_stale:
            self.state.refresh_costs()
        self._touched[u] = True
        self._touched[v] = True
        self.counters["inserted"] += int(len(es))
        self.counters["reinserted"] += int((known & place).sum())
        if self.auto_repair:
            self.maybe_repair()
        return int(len(es))

    def delete(self, uv: np.ndarray, *, strict: bool = True) -> int:
        """Delete a batch of (u, v) pairs; returns how many were removed.

        Routes through ``PartitionState.remove_edges`` — the exact Eq. 3/4
        rollback.  Unknown or already-deleted pairs raise ``ValueError``
        under ``strict`` (the default: a deletion stream referencing edges
        we never held is corrupt), else they are skipped.
        """
        uv = _canonical(uv)
        if not len(uv):
            return 0
        eids = self.g.eids_of(uv[:, 0], uv[:, 1])
        live = np.zeros(len(uv), dtype=bool)
        live[eids >= 0] = self.state.assign[eids[eids >= 0]] >= 0
        if strict and not live.all():
            bad = uv[~live][:8]
            raise ValueError(f"delete: pairs not currently live: "
                             f"{bad.tolist()}")
        es = eids[live]
        if not len(es):
            return 0
        self.state.remove_edges(es)
        self._grow_frontier()
        self._touched[uv[live, 0]] = True
        self._touched[uv[live, 1]] = True
        self.counters["deleted"] += int(len(es))
        if self.auto_repair:
            self.maybe_repair()
        return int(len(es))

    # -- drift monitor + bounded repair --------------------------------------
    def drift(self) -> str | None:
        """The threshold currently violated (``"skew"`` | ``"rf"``), or
        None when the partition is healthy."""
        if self.skew > self.skew_limit:
            return "skew"
        if self._rf() > self.rf_limit:
            return "rf"
        return None

    def maybe_repair(self) -> RepairReport | None:
        trigger = self.drift()
        if trigger is None:
            return None
        return self.repair(trigger=trigger)

    def repair(self, trigger: str = "forced") -> RepairReport:
        """One bounded destroy–repair pass scoped to the touched frontier.

        Destroy set: edges on *overloaded* machines (T within the top
        ``1-gamma`` of the spread, ``sls.destroy_repair``'s rule) whose
        endpoint lies in the touched frontier — at most ``theta`` of each
        machine's candidates, at most ``repair_cap`` total.  Repair:
        ``sls.repair_edges`` vectorized waves over live state.  The
        frontier resets afterwards, so repair cost is charged to the
        mutations that accumulated it — this is what keeps amortized
        repair cost O(batch) instead of O(E).
        """
        tc_before = self.state.tc
        t = self.state.t_total
        thd = t.min() + self.repair_gamma * (t.max() - t.min())
        over = np.flatnonzero((t >= thd - 1e-12)
                              & (self.state.edges_per > 0))
        assign = self.state.assign
        edges = self.g.edges
        frontier = (self._touched[edges[:, 0]]
                    | self._touched[edges[:, 1]])
        moved = 0
        take_parts = []
        for i in over:
            cand = np.flatnonzero((assign == i) & frontier)
            if not len(cand):
                continue
            k = max(1, int(np.ceil(self.repair_theta * len(cand))))
            # prefer edges whose endpoints are replicated elsewhere —
            # moving them can shrink replica sets instead of growing them
            r = (self.state.replicas[edges[cand, 0]]
                 + self.state.replicas[edges[cand, 1]])
            take_parts.append(cand[np.argsort(-r, kind="stable")[:k]])
        if take_parts:
            sel = np.concatenate(take_parts)[:self.repair_cap]
            self.state.remove_edges(sel)
            repair_edges(self.state, sel,
                         [[] for _ in range(self.cluster.p)])
            moved = int(len(sel))
        self._touched[:] = False
        # re-anchor the adaptive RF leash to the post-repair baseline:
        # the next trigger fires on *new* drift, not on whatever floor
        # this repair could not recover below (a leash frozen at
        # construction either never trips on a long timeline or trips
        # every batch once the floor rises past it)
        self._rf_anchor = max(1.0, self._rf())
        report = RepairReport(trigger=trigger, edges_moved=moved,
                              tc_before=tc_before,
                              tc_after=self.state.tc)
        self.repairs.append(report)
        self.counters["repair_moves"] += moved
        return report

    # -- epoch deltas (the BSP hand-off) -------------------------------------
    def snapshot(self) -> dict:
        """Capture the current assignment for a later :meth:`delta_since`."""
        return {"assign": self.state.assign.copy(),
                "num_vertices": self.g.num_vertices}

    def delta_since(self, snap: dict) -> AssignmentDelta:
        """Diff live state against a snapshot into an `AssignmentDelta`.

        Ids only ever *grow* (deletion retires, never removes), so the
        snapshot assignment is a prefix of the live id space; appended ids
        diff against -1.
        """
        old = snap["assign"]
        new = self.state.assign
        if len(old) > len(new):
            raise ValueError("snapshot has more edge ids than live state")
        old_p = np.full(len(new), -1, dtype=old.dtype)
        old_p[:len(old)] = old
        changed = np.flatnonzero(old_p != new)
        edges = self.g.edges
        rem = changed[old_p[changed] >= 0]
        add = changed[new[changed] >= 0]
        return AssignmentDelta(
            num_vertices=self.g.num_vertices,
            added=edges[add].astype(np.int64),
            added_ms=new[add].astype(np.int64),
            removed=edges[rem].astype(np.int64),
            removed_ms=old_p[rem].astype(np.int64))
