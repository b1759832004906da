"""Heterogeneous per-pod batch capacities — WindGP Algorithm 1, reused.

The paper's capacity phase answers: given machines with compute cost C_i
and memory M_i, how many work units should each hold so the slowest
machine's makespan is minimized?  For LM training across pods of mixed
TPU generations the work unit is one *sample*: C_i = measured (or modeled)
per-sample step time, M_i = HBM budget in per-sample activation units.

This is the paper's technique applied verbatim to the training substrate
(see DESIGN.md §4) — it is the straggler-mitigation story for dense archs
where no expert/graph structure exists.
"""
from __future__ import annotations

import numpy as np

from ..core.capacity import capacities
from ..core.machines import Cluster, Machine


def heterogeneous_batch_split(global_batch: int, pod_step_cost,
                              pod_mem_samples=None) -> np.ndarray:
    """Split ``global_batch`` samples across pods.

    pod_step_cost[i]: relative per-sample step time of pod i (e.g. 1.0 for
    v5e, 0.55 for v5p).  pod_mem_samples[i]: max samples pod i fits.
    Returns integer per-pod batch sizes summing to global_batch.
    """
    pod_step_cost = np.asarray(pod_step_cost, dtype=np.float64)
    p = len(pod_step_cost)
    if pod_mem_samples is None:
        pod_mem_samples = np.full(p, global_batch)
    machines = tuple(
        Machine(memory=float(m) * 1.0, c_node=0.0, c_edge=float(c), c_com=1.0)
        for c, m in zip(pod_step_cost, pod_mem_samples))
    # M^edge=1, M^node=0: memory is measured directly in samples.
    cluster = Cluster(machines=machines, m_node=0.0, m_edge=1.0)
    return capacities(cluster, num_vertices=0, num_edges=global_batch)
