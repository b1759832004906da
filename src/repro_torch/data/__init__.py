"""Graph generators and IO (R-MAT / Graph500 / road mesh / Erdős–Rényi,
SNAP-style edge lists)."""
from .generators import erdos_renyi, graph500, rmat, road_mesh
from .io import (SpillStats, TwoPassDedup, canonicalize_block,
                 count_edge_list, iter_edge_blocks, read_edge_list,
                 two_pass_dedup, write_edge_list)

__all__ = ["rmat", "road_mesh", "erdos_renyi", "graph500",
           "read_edge_list", "write_edge_list", "iter_edge_blocks",
           "count_edge_list", "canonicalize_block", "TwoPassDedup",
           "SpillStats", "two_pass_dedup"]
