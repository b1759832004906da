"""NE — Neighborhood Expansion [Zhang et al. 2017], heterogeneous-memory
adapted exactly as the paper does: homogeneous capacity α'|E|/p per machine,
clamped by memory; expansion minimizes |N(v)\\S| (our best-first machinery
with α = β = 0 degenerates to NE's criterion)."""
from __future__ import annotations

import numpy as np

from .. import expand as exp_mod
from ..capacity import _mem_cap
from ..graph import Graph
from ..machines import Cluster
from ..partition_state import PartitionState
from ..sls import repair_edges


def ne(g: Graph, cluster: Cluster, seed: int = 0,
       balance: float = 1.0) -> np.ndarray:
    p = cluster.p
    caps = np.floor(_mem_cap(cluster, g.num_vertices, g.num_edges)).astype(np.int64)
    target = int(np.ceil(balance * g.num_edges / p))
    deltas = np.minimum(np.full(p, target, dtype=np.int64), caps)
    short = g.num_edges - int(deltas.sum())
    j = 0
    while short > 0 and j < p:    # top up where memory allows
        take = min(int(caps[j] - deltas[j]), short)
        deltas[j] += take
        short -= take
        j += 1
    assign, _ = exp_mod.run_expansion(
        g, deltas, 0.0, 0.0, memories=cluster.memory(),
        m_node=cluster.m_node, m_edge=cluster.m_edge, order="natural")
    # place stragglers (memory-guard leftovers) through the shared
    # incremental layer: one vectorized greedy-repair wave set, memory-aware
    left = np.flatnonzero(assign < 0)
    if len(left):
        obj = PartitionState.build(g, assign, cluster)
        repair_edges(obj, left, [[] for _ in range(p)])
        assign = obj.assign
    return assign


from ..partitioners import Partitioner, register  # noqa: E402

register(Partitioner(
    "ne", ne, "expansion",
    "Neighborhood Expansion [Zhang et al. 2017], memory-adapted",
    frozenset(), ("seed", "balance")))
