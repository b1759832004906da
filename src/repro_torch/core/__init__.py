"""WindGP core (host numpy): heterogeneous-machine edge partitioning."""
from .graph import Graph, GrowableGraph, from_edge_list
from .machines import (Cluster, Machine, PartitionStats, evaluate,
                       evaluate_membership, paper_cluster, quantify_machines,
                       replication_factor, scaled_paper_cluster)
from .capacity import capacities, exact_capacity_relaxed, effective_cost
from .windgp import WindGPResult, windgp
from .dynamic import AssignmentDelta, DynamicPartitioner, RepairReport

__all__ = [
    "Graph", "GrowableGraph", "from_edge_list",
    "Cluster", "Machine", "PartitionStats",
    "evaluate", "evaluate_membership", "paper_cluster",
    "scaled_paper_cluster", "quantify_machines",
    "replication_factor", "capacities", "exact_capacity_relaxed",
    "effective_cost", "WindGPResult", "windgp",
    "AssignmentDelta", "DynamicPartitioner", "RepairReport",
]
