"""Placement of MoE experts on heterogeneous pods with WindGP (host numpy).

A copy of the reference's ``sharding/windgp_placement.py`` over the port's
own ``core``, held bitwise against it; the reference's partition specs
(``sharding/specs.py``) are JAX-only tooling and not ported.
"""
from . import windgp_placement
from .windgp_placement import (coactivation_graph, place_experts,
                               placement_cost)

__all__ = ["windgp_placement", "coactivation_graph", "place_experts",
           "placement_cost"]
