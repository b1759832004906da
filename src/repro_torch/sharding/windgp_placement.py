"""WindGP-based placement of MoE experts on heterogeneous pods.

The paper's §4 vertex-centric extension, applied to expert parallelism:

* vertices  = experts, weighted by expected token load (router statistics);
* edges     = expert co-activation (tokens routed to both experts under
  top-k must exchange activations if the experts sit on different pods);
* machines  = pods with (HBM, per-token compute cost, inter-pod link cost)
  quadruples.

WindGP edge-partitions the co-activation graph (3-phase: capacity →
best-first → SLS), then each expert lands on the machine holding the
largest share of its incident co-activation edges (the paper's
max-partial-degree rule), respecting memory.  Minimizing TC here minimizes
the BSP-style makespan of one MoE layer: max_pod(expert compute + cross-pod
token exchange) — the same long-tail the paper targets.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import from_edge_list
from ..core.machines import Cluster, Machine
from ..core.windgp import windgp


def coactivation_graph(routing_counts: np.ndarray):
    """routing_counts: (tokens, k) expert ids per token → weighted edges.

    Returns (edges (M,2), weights (M,), loads (E,)): co-routed expert pairs
    and per-expert token loads.
    """
    toks, k = routing_counts.shape
    pairs = {}
    loads = np.bincount(routing_counts.reshape(-1),
                        minlength=int(routing_counts.max()) + 1)
    for t in range(toks):
        es = np.unique(routing_counts[t])
        for i in range(len(es)):
            for j in range(i + 1, len(es)):
                key = (int(es[i]), int(es[j]))
                pairs[key] = pairs.get(key, 0) + 1
    if not pairs:
        return np.zeros((0, 2), np.int64), np.zeros(0), loads
    edges = np.array(list(pairs), dtype=np.int64)
    weights = np.array(list(pairs.values()), dtype=np.float64)
    return edges, weights, loads


def place_experts(num_experts: int, routing_sample: np.ndarray,
                  pod_compute_cost, pod_memory_experts, pod_link_cost,
                  seed: int = 0) -> np.ndarray:
    """Returns (E,) pod index per expert.

    pod_compute_cost[i]: relative per-token FFN cost on pod i.
    pod_memory_experts[i]: how many experts fit in pod i's HBM.
    pod_link_cost[i]: relative cost of a token crossing into/out of pod i.
    """
    edges, weights, loads = coactivation_graph(routing_sample)
    p = len(pod_compute_cost)
    if len(edges) == 0:   # degenerate: round-robin by load
        order = np.argsort(-loads)
        out = np.zeros(num_experts, dtype=np.int64)
        out[order] = np.arange(len(order)) % p
        return out
    g = from_edge_list(edges, num_vertices=num_experts)
    # Edge-partition memory: proportional to pod HBM, scaled so the graph
    # always fits (the hard expert-count constraint is enforced in the
    # vertex-assignment pass below).
    mem_w = np.asarray(pod_memory_experts, dtype=np.float64)
    total_units = 2.5 * (0.5 * g.num_edges + g.num_vertices)
    mem_units = total_units * mem_w / mem_w.sum()
    machines = tuple(
        Machine(memory=float(m), c_node=float(c), c_edge=float(c),
                c_com=float(l))
        for c, m, l in zip(pod_compute_cost, mem_units, pod_link_cost))
    cluster = Cluster(machines=machines, m_node=1.0, m_edge=0.5)
    res = windgp(g, cluster, t0=10, seed=seed)
    # §4 vertex-centric rule, made load/speed-aware (the paper's
    # BalancedGreedyRepair applied at vertex level): experts are placed in
    # descending token-load order on the machine minimizing the resulting
    # weighted makespan, with the WindGP edge partition's partial degree as
    # the affinity tie-break (keeps co-activated experts co-located).
    place = np.full(num_experts, -1, dtype=np.int64)
    deg_by_machine = np.zeros((p, num_experts), dtype=np.int64)
    for eid, m in enumerate(res.assign):
        u, v = g.edges[eid]
        deg_by_machine[m, u] += 1
        deg_by_machine[m, v] += 1
    room = np.asarray(pod_memory_experts, dtype=np.float64)
    compute = np.asarray(pod_compute_cost, dtype=np.float64)
    order = np.argsort(-loads[:num_experts])          # heavy experts first
    used_tokens = np.zeros(p)
    used_slots = np.zeros(p)
    max_aff = deg_by_machine.sum(axis=0).max() or 1
    for e in order:
        load_e = float(loads[e]) if e < len(loads) else 0.0
        t_new = (used_tokens + load_e) * compute
        aff = deg_by_machine[:, e] / max_aff
        score = t_new * (1.0 - 0.25 * aff)            # affinity discount
        feasible = used_slots + 1 <= room
        cand = np.where(feasible, score, np.inf)
        m = int(np.argmin(cand)) if feasible.any() else \
            int(np.argmin(used_slots / room))
        place[e] = m
        used_tokens[m] += load_e
        used_slots[m] += 1
    return place


def placement_cost(place: np.ndarray, routing_sample: np.ndarray,
                   pod_compute_cost, pod_link_cost) -> float:
    """BSP makespan of one MoE layer under a placement (lower = better)."""
    p = len(pod_compute_cost)
    loads = np.zeros(p)
    comm = np.zeros(p)
    for t in range(routing_sample.shape[0]):
        pods = place[routing_sample[t]]
        for m in pods:
            loads[m] += pod_compute_cost[m]
        uniq = np.unique(pods)
        if len(uniq) > 1:
            for m in uniq:
                comm[m] += pod_link_cost[m] * (len(uniq) - 1)
    return float((loads + comm).max())
