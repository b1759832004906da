"""Baseline edge partitioners the paper compares against (Section 5).

Each is adapted — exactly as the paper does for fairness — to heterogeneous
machines by adding per-machine memory-capacity constraints; otherwise they
optimize their original homogeneous objectives.

Every method lives in the unified registry (``core/partitioners.py``);
``PARTITIONERS`` survives as a snapshot of it (per-edge ``*_oracle``
reference loops excluded — they are test references, not benchmark
entries), so legacy ``PARTITIONERS[name](g, cluster)`` call sites keep
working unchanged.
"""
from .streaming import (dbh, ebv, ebv_oracle, hdrf, hdrf_oracle,
                        powergraph_greedy, powergraph_greedy_oracle,
                        random_hash, stream_partition)
from .ne import ne
from .metis_like import metis_like

from ..partitioners import get, partitioner_dict

# windgp's driver entries register on import of repro_torch.core.windgp, which
# ``partitioner_dict`` triggers via the registry's _ensure_builtin.
PARTITIONERS = partitioner_dict(exclude={"oracle"})

windgp_heap = PARTITIONERS["windgp_heap"]
windgp_batched = PARTITIONERS["windgp_batched"]

__all__ = ["dbh", "ebv", "hdrf", "powergraph_greedy", "random_hash", "ne",
           "metis_like", "windgp_heap", "windgp_batched", "PARTITIONERS",
           "ebv_oracle", "hdrf_oracle", "powergraph_greedy_oracle",
           "stream_partition", "get", "partitioner_dict"]
