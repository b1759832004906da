"""WindGP driver: preprocessing → best-first expansion → subgraph-local search.

The three phases correspond to the paper's Figure 4.  Ablation levels:

* ``windgp-``  : naive NE-style expansion with homogeneous |E|/p capacities
                 (the paper's WindGP− baseline)
* ``windgp*``  : + heterogeneous capacities (Alg. 1), NE-style expansion
* ``windgp+``  : + best-first search (α, β)             [no post-processing]
* ``windgp``   : + subgraph-local search                [the full method]

Expansion engines (the ``engine=`` switch, threaded through both the
expansion phase and SLS's re-partition operator):

* ``engine="batched"`` (default): the frontier-scan engine — quantized
  Eq. 5 scores kept fresh per vertex, whole best-window frontier slices
  admitted per step with vectorized AllocEdges, degree-split hub/tail
  frontier (≥5× faster partitioning at matching TC; see
  ``core/expand.py``).  Extra knobs (``scale``, ``batch_frac``,
  ``batch_window``, ``strict_ties``, ``hub_split``, ``hub_degree``) pass
  through ``**engine_kw``.
* ``engine="heap"``: the scalar lazy-min-heap reference oracle — exactly
  the paper's Algorithms 2-3; keep for equivalence checks and debugging.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import obs
from . import capacity as cap
from . import expand as exp
from . import sls as sls_mod
from .graph import Graph
from .machines import Cluster, PartitionStats, evaluate


@dataclasses.dataclass(frozen=True)
class WindGPResult:
    """The assignment, its statistics and capacities, and the seconds of
    the ``windgp`` span and of each phase's span (``windgp.<phase>``)."""

    assign: np.ndarray
    stats: PartitionStats
    deltas: np.ndarray
    seconds: float
    phase_seconds: dict


def _repair_unassigned(g: Graph, assign: np.ndarray, cluster: Cluster,
                       orders: list[list[int]]) -> np.ndarray:
    """Safety net: greedily place any edge the expansion could not fit.

    Runs the shared vectorized BalancedGreedyRepair waves over the whole
    leftover set at once (``sls.repair_edges``).
    """
    left = np.flatnonzero(assign < 0)
    if len(left) == 0:
        return assign
    obj = sls_mod.PartitionState.build(g, assign, cluster)
    sls_mod.repair_edges(obj, left, orders)
    return obj.assign


def _train_rebalance(g: Graph, assign: np.ndarray, cluster: Cluster,
                     orders: list[list[int]], train_mask: np.ndarray,
                     mu: float, rounds: int = 3,
                     slack: float = 1.05) -> np.ndarray:
    """Spread the labeled/train vertex set across machines (GNN epochs
    stress machines by hosted train vertices, not edges — cf. graphstorm's
    ``--balance_train``).

    Evicts the partition-local edges of the cheapest-to-move train
    vertices on machines holding more than ``slack ×`` the mean train
    count, then re-places them through the shared BalancedGreedyRepair
    waves over a *train-weighted* :class:`PartitionState` (Eq. 3 charges
    ``c_node·(1+mu)`` per hosted train vertex), so the repair itself
    steers the replacements toward train-light machines.  Bounded and
    monotone-ish: each round only touches overloaded machines; stops
    early when none remain.
    """
    tm = np.asarray(train_mask, dtype=bool)
    state = sls_mod.PartitionState.build(g, assign, cluster,
                                         train_mask=tm, train_balance=mu)
    train_ids = np.flatnonzero(tm)
    if len(train_ids) == 0:
        return state.assign
    for _ in range(max(1, int(rounds))):
        counts = state.train_counts(tm).astype(np.float64)
        target = counts.mean() * slack
        over = np.flatnonzero(counts > target + 1.0)
        if len(over) == 0:
            break
        evict = []
        for i in over:
            held = train_ids[state.cnt[i, train_ids] > 0]
            # cheapest-to-move first: fewest machine-i incident edges
            held = held[np.argsort(state.cnt[i, held], kind="stable")]
            n_drop = int(min(len(held), np.ceil(counts[i] - target)))
            for v in held[:n_drop]:
                eids = g.incident_edge_ids(int(v))
                evict.append(eids[state.assign[eids] == i])
        if not evict:
            break
        es = np.unique(np.concatenate(evict))
        if len(es) == 0:
            break
        state.remove_edges(es)
        sls_mod.repair_edges(state, es, orders)
    return state.assign


def windgp(
    g: Graph,
    cluster: Cluster,
    *,
    alpha: float = 0.3,
    beta: float = 0.3,
    gamma: float = 0.9,
    theta: float = 0.01,
    t0: int = 8,
    n0: int = 5,
    k: int = 3,
    level: str = "windgp",
    seed: int = 0,
    engine: str = "batched",
    repair: str = "vectorized",
    train_mask: np.ndarray | None = None,
    train_balance: float = 0.0,
    train_rounds: int = 3,
    **engine_kw,
) -> WindGPResult:
    """Run WindGP (or one of its ablations) and evaluate the TC metric.

    ``repair`` selects SLS's destroy-repair sweep: the vectorized wave
    implementation (default) or the per-edge ``"scalar"`` oracle.
    ``train_mask`` + ``train_balance`` > 0 append the training-aware
    rebalance pass (:func:`_train_rebalance`): machines then balance
    hosted labeled vertices as well as Eq. 3/4 cost — the knob GNN
    minibatch sampling needs so every machine draws comparable seed
    batches.
    """
    assert level in ("windgp-", "windgp*", "windgp+", "windgp")
    assert engine in exp.ENGINES, engine
    phases = {}
    with obs.span("windgp") as whole:
        # Phase 1: capacities.
        with obs.span("windgp.preprocess") as sp:
            if level == "windgp-":
                # Homogeneous target |E|/p, clamped by memory (naive
                # baseline).
                p = cluster.p
                mem_cap = np.floor(cluster.memory()
                                   / (cluster.m_edge + cluster.m_node
                                      * g.num_vertices / max(1, g.num_edges)))
                deltas = np.minimum(np.full(p, g.num_edges // p + 1), mem_cap)
                deltas = deltas.astype(np.int64)
                # ensure sum >= |E| by topping up machines with memory room
                short = g.num_edges - int(deltas.sum())
                j = 0
                while short > 0 and j < p:
                    room = int(mem_cap[j] - deltas[j])
                    take = min(room, short)
                    deltas[j] += take
                    short -= take
                    j += 1
            else:
                deltas = cap.capacities(cluster, g.num_vertices, g.num_edges)
        phases["preprocess"] = sp.seconds

        # Phase 2: expansion.
        with obs.span("windgp.expand") as sp:
            if level in ("windgp-", "windgp*"):
                a, b = 0.0, 0.0    # pure NE-style: only |N(v)\S| drives it
            else:
                a, b = alpha, beta
            assign, orders = exp.run_expansion(
                g, deltas, a, b, memories=cluster.memory(),
                m_node=cluster.m_node, m_edge=cluster.m_edge,
                engine=engine, **engine_kw)
            assign = _repair_unassigned(g, assign, cluster, orders)
        phases["expand"] = sp.seconds

        # Phase 3: subgraph-local search.
        with obs.span("windgp.sls") as sp:
            if level == "windgp":
                assign, _ = sls_mod.sls(
                    g, assign, cluster, orders, deltas, t0=t0, n0=n0,
                    gamma=gamma, theta=theta, k=k, alpha=alpha, beta=beta,
                    seed=seed, engine=engine, repair=repair, **engine_kw)
        phases["sls"] = sp.seconds

        # Phase 4 (optional): training-aware rebalance.
        if train_mask is not None and train_balance:
            with obs.span("windgp.train_balance") as sp:
                assign = _train_rebalance(g, assign, cluster, orders,
                                          train_mask, float(train_balance),
                                          rounds=int(train_rounds))
            phases["train_balance"] = sp.seconds

        stats = evaluate(g, assign, cluster)
    return WindGPResult(
        assign=assign, stats=stats, deltas=np.asarray(deltas),
        seconds=whole.seconds, phase_seconds=phases)


# ---------------------------------------------------------------------------
# registry entries: the driver and its two expansion engines
# ---------------------------------------------------------------------------

from .partitioners import Partitioner, register  # noqa: E402

_DRIVER_KNOBS = ("alpha", "beta", "gamma", "theta", "t0", "n0", "k",
                 "level", "seed", "repair", "scale", "batch_frac",
                 "batch_window", "strict_ties", "hub_split", "hub_degree",
                 "train_mask", "train_balance", "train_rounds")


def _windgp_assign(engine=None):
    def run(g, cluster, **kw):
        if engine is not None:
            kw["engine"] = engine
        return windgp(g, cluster, **kw).assign
    run.__name__ = f"windgp_{engine}" if engine else "windgp"
    return run


register(Partitioner(
    "windgp", _windgp_assign(), "driver",
    "full WindGP driver (default batched engine)",
    frozenset({"driver", "heterogeneous"}), _DRIVER_KNOBS + ("engine",)))
register(Partitioner(
    "windgp_heap", _windgp_assign("heap"), "driver",
    "WindGP with the scalar heap expansion oracle",
    frozenset({"driver", "heterogeneous"}), _DRIVER_KNOBS))
register(Partitioner(
    "windgp_batched", _windgp_assign("batched"), "driver",
    "WindGP with the batched frontier-scan engine",
    frozenset({"driver", "heterogeneous"}), _DRIVER_KNOBS))
