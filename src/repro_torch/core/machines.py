"""Heterogeneous machine model, resource quantification, and the TC metric.

Implements Definition 4 of the paper: each machine is a quadruple
(M_i, C_i^node, C_i^edge, C_i^com); the partition quality metric is

    TC = max_i (T_i^cal + T_i^com)
    T_i^cal = C_i^node |V_i| + C_i^edge |E_i|
    T_i^com = sum_{v in V_i} sum_{j != i, v in V_j} (C_i^com + C_j^com)

plus the replication factor RF for homogeneous comparisons.
"""
from __future__ import annotations

import dataclasses
import math
from functools import reduce

import numpy as np


@dataclasses.dataclass(frozen=True)
class Machine:
    """One machine's quantified resources (paper Section 2.1)."""

    memory: float        # M_i, in M^node units
    c_node: float        # C_i^node
    c_edge: float        # C_i^edge
    c_com: float         # C_i^com

    def as_tuple(self):
        return (self.memory, self.c_node, self.c_edge, self.c_com)


@dataclasses.dataclass(frozen=True)
class Cluster:
    machines: tuple
    m_node: float = 1.0   # M^node
    m_edge: float = 2.0   # M^edge

    @property
    def p(self) -> int:
        return len(self.machines)

    def memory(self) -> np.ndarray:
        return np.array([m.memory for m in self.machines], dtype=np.float64)

    def c_node(self) -> np.ndarray:
        return np.array([m.c_node for m in self.machines], dtype=np.float64)

    def c_edge(self) -> np.ndarray:
        return np.array([m.c_edge for m in self.machines], dtype=np.float64)

    def c_com(self) -> np.ndarray:
        return np.array([m.c_com for m in self.machines], dtype=np.float64)


def paper_cluster(n_super: int, n_normal: int, *, large: bool = False) -> Cluster:
    """The paper's default machine template (Section 5.1).

    Large graphs: super=(1e8,10,15,15), normal=(3e7,5,10,10).
    Others:       super=(1e7,10,15,15), normal=(3e6,5,10,10).
    """
    sm = 1e8 if large else 1e7
    nm = 3e7 if large else 3e6
    machines = tuple([Machine(sm, 10, 15, 15)] * n_super
                     + [Machine(nm, 5, 10, 10)] * n_normal)
    return Cluster(machines=machines)


def scaled_paper_cluster(n_super: int, n_normal: int, num_edges: int,
                         slack: float = 3.0) -> Cluster:
    """Paper machine template with memory scaled to the given graph size.

    The paper's absolute memory numbers target 30M–1.2B-edge graphs; for
    laptop-scale graphs we keep the same super:normal memory ratio (10:3)
    and cost quadruples, scaling total memory to ``slack``× the minimum
    needed, so the memory constraint stays binding the same way.
    """
    total_units = (2.0 + 1.0) * num_edges * slack  # M^edge*E + M^node*~V
    # super:normal memory ratio 10:3.
    denom = 10 * n_super + 3 * n_normal
    sm = 10 * total_units / denom
    nm = 3 * total_units / denom
    machines = tuple([Machine(sm, 10, 15, 15)] * n_super
                     + [Machine(nm, 5, 10, 10)] * n_normal)
    return Cluster(machines=machines)


def quantify_machines(mem_gb, fp_time, fp_time_edge, co_time) -> Cluster:
    """Paper Section 2.1 'Quantification of Machine Resource'.

    mem_gb[i]:     memory in GB.
    fp_time[i]:    averaged float-mul benchmark time  -> C_i^node.
    fp_time_edge[i]: two-op benchmark time            -> C_i^edge.
    co_time[i]:    averaged 4KB send/recv time        -> C_i^com.
    """
    mem_gb = list(mem_gb)
    g_mem = reduce(math.gcd, [int(m) for m in mem_gb])
    g_fp = min(fp_time)
    machines = []
    for m, fn, fe, co in zip(mem_gb, fp_time, fp_time_edge, co_time):
        machines.append(Machine(
            memory=1e9 * m / (4 * g_mem),
            c_node=fn / g_fp,
            c_edge=fe / g_fp,
            c_com=co / (1024 * g_fp),
        ))
    return Cluster(machines=tuple(machines))


# ---------------------------------------------------------------------------
# Metrics over an edge partition.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionStats:
    tc: float
    t_cal: np.ndarray          # (p,)
    t_com: np.ndarray          # (p,)
    edges_per_part: np.ndarray  # (p,)
    verts_per_part: np.ndarray  # (p,)
    rf: float
    alpha_balance: float       # max |E_i| / (|E|/p)
    feasible: bool             # memory constraint satisfied everywhere

    @property
    def t_total(self) -> np.ndarray:
        return self.t_cal + self.t_com


def vertex_partition_sets(graph, assign: np.ndarray, p: int):
    """Boolean (p, V) membership: vertex v in V_i iff it has an edge in E_i."""
    from .partition_state import edge_incidence_counts
    return edge_incidence_counts(graph, assign, p) > 0


def evaluate_membership(member: np.ndarray, edges_per: np.ndarray,
                        cluster: Cluster,
                        num_edges: int | None = None) -> PartitionStats:
    """TC/RF and per-machine costs from a ``(p, V)`` membership matrix plus
    per-machine edge counts — no ``Graph`` required.

    The metric layer shared by :func:`evaluate` (in-memory assignments) and
    the out-of-core stream path (``StreamMembership``/``StreamAssignment``
    carry exactly these two quantities); Eq. 3/4 only read memberships and
    counts, so both paths report through identical arithmetic.
    """
    p = cluster.p
    member = np.asarray(member, dtype=bool)
    edges_per = np.asarray(edges_per, dtype=np.float64)
    verts_per = member.sum(axis=1).astype(np.float64)

    c_node, c_edge, c_com = cluster.c_node(), cluster.c_edge(), cluster.c_com()
    t_cal = c_node * verts_per + c_edge * edges_per

    # T_i^com: for every replicated vertex v in V_i and every other machine j
    # holding v, cost (C_i^com + C_j^com) — one masked matmul, shared with
    # the incremental layer.
    from .partition_state import t_com_from_membership
    replicas = member.sum(axis=0)                     # (V,) |S(v)|
    com_sum = member.T.astype(np.float64) @ c_com      # (V,) Σ c_com over S(v)
    t_com = t_com_from_membership(member, replicas, com_sum, c_com)

    rf = replicas[replicas > 0].sum() / max(1, (replicas > 0).sum())
    mem_need = cluster.m_node * verts_per + cluster.m_edge * edges_per
    feasible = bool(np.all(mem_need <= cluster.memory() + 1e-9))
    tc = float((t_cal + t_com).max())
    nE = max(1, int(edges_per.sum()) if num_edges is None else num_edges)
    return PartitionStats(
        tc=tc, t_cal=t_cal, t_com=t_com, edges_per_part=edges_per,
        verts_per_part=verts_per, rf=float(rf),
        alpha_balance=float(edges_per.max() / (nE / p)), feasible=feasible)


def evaluate(graph, assign: np.ndarray, cluster: Cluster) -> PartitionStats:
    """Compute TC/RF and per-machine costs for an edge assignment.

    assign: (E,) int array mapping canonical edge id -> machine in [0, p).
    """
    p = cluster.p
    assert assign.min(initial=0) >= 0 and assign.max(initial=0) < p
    member = vertex_partition_sets(graph, assign, p)
    edges_per = np.bincount(assign, minlength=p).astype(np.float64)
    return evaluate_membership(member, edges_per, cluster,
                               num_edges=graph.num_edges)


def replication_factor(graph, assign: np.ndarray, p: int) -> float:
    member = vertex_partition_sets(graph, assign, p)
    replicas = member.sum(axis=0)
    covered = replicas > 0
    return float(replicas[covered].sum() / max(1, covered.sum()))
