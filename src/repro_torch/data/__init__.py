"""Synthetic graph generators (R-MAT / Graph500 / road mesh / Erdős–Rényi)."""
from .generators import erdos_renyi, graph500, rmat, road_mesh

__all__ = ["rmat", "road_mesh", "erdos_renyi", "graph500"]
