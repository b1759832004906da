"""Split rules and expert placement of the port.

``specs`` copies the reference's name-based split rules
(``sharding/specs.py``) over the port's parameter names; the fit check
(``launch/dryrun.py``) divides each leaf's bytes by its split.
``windgp_placement`` places MoE experts on heterogeneous pods with WindGP
(host numpy), a copy of the reference's held bitwise against it.
"""
from . import specs, windgp_placement
from .specs import (cache_specs, data_axes, input_specs_for,
                    logical_batch_spec, opt_state_specs, param_shapes,
                    param_shardings, param_specs, split_of)
from .windgp_placement import (coactivation_graph, place_experts,
                               placement_cost)

__all__ = ["specs", "windgp_placement", "param_shapes", "param_specs",
           "param_shardings",
           "opt_state_specs", "input_specs_for", "cache_specs", "data_axes",
           "logical_batch_spec", "split_of", "coactivation_graph",
           "place_experts", "placement_cost"]
