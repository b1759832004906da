"""Heterogeneous-cluster BSP time simulator (paper Table 1 / Section 5.4).

Predicts the distributed running time of a graph algorithm on machines with
quadruples (M_i, C_i^node, C_i^edge, C_i^com), from the partition layout and
the *actual* per-superstep activity of the algorithm:

    t_i(step) = C_i^node·act_i(step) + C_i^edge·E_i·edge_frac(step)
              + Σ_{replicated v on i} (C_i^com + C_j^com)
    step time = max_i t_i(step)            (BSP barrier: long-tail effect)
    runtime   = Σ_steps step_time

For dense algorithms (PageRank) every vertex/edge is active each superstep
and the prediction reduces exactly to the TC metric × #supersteps — the
paper's equivalence claim; for sparse algorithms (SSSP/BFS) activity comes
from the engine's measured per-(step, machine) active counts.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph
from ..core.machines import Cluster
from .partition_runtime import PartitionRuntime


def _per_machine_comm(rt: PartitionRuntime, cluster: Cluster) -> np.ndarray:
    """Σ over replicated v on machine i of Σ_{j≠i holding v} (C_i + C_j)."""
    p = rt.p
    c_com = cluster.c_com()
    holders = np.zeros((p, rt.num_vertices), dtype=bool)
    for i in range(p):
        m = rt.vertex_valid[i]
        holders[i, rt.local_vertex_gid[i, m]] = True
    replicas = holders.sum(axis=0)
    com_sum = holders.T.astype(np.float64) @ c_com
    out = np.zeros(p)
    for i in range(p):
        vs = holders[i] & (replicas > 1)
        out[i] = ((replicas[vs] - 1) * c_com[i] + (com_sum[vs] - c_com[i])).sum()
    return out


def simulate_superstep_times(rt: PartitionRuntime, cluster: Cluster,
                             actives: np.ndarray | None = None,
                             num_steps: int = 1,
                             comm_scale: str = "static") -> np.ndarray:
    """(steps, p) per-machine superstep times.

    actives: (steps, p) active-vertex counts (None => dense: all active).
    comm_scale: 'static' charges the full replica sync each superstep (BSP
    engines sync every boundary each barrier); 'active' scales communication
    by the machine's active fraction (push-based engines).
    """
    p = cluster.p
    e_i = rt.edges_per_machine.astype(np.float64)
    v_i = rt.verts_per_machine.astype(np.float64)
    comm = _per_machine_comm(rt, cluster)
    if actives is None:
        actives = np.tile(v_i, (num_steps, 1))
    actives = np.asarray(actives, dtype=np.float64)
    frac = np.divide(actives, np.maximum(v_i, 1.0))
    t_cal = (cluster.c_node() * actives
             + cluster.c_edge() * e_i * frac)
    t_com = comm * (frac if comm_scale == "active" else 1.0)
    return t_cal + t_com


def simulate_runtime(rt: PartitionRuntime, cluster: Cluster,
                     actives: np.ndarray | None = None,
                     num_steps: int = 1, comm_scale: str = "static") -> float:
    """BSP makespan: Σ_steps max_i t_i(step)."""
    t = simulate_superstep_times(rt, cluster, actives, num_steps, comm_scale)
    return float(t.max(axis=1).sum())
