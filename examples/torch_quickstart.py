"""Quickstart on the PyTorch port: partition a graph for a heterogeneous
cluster with WindGP (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The partition is host numpy, bitwise the reference's; ``--device``
(default ``cuda``) is checked as every entry point of the port checks it.
"""
import argparse

from repro_torch.core import evaluate, scaled_paper_cluster, windgp
from repro_torch.core.partitioners import get as partitioner
from repro_torch.data import rmat
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; 'cpu' to run on the CPU)")
resolve_device(ap.parse_args().device)

# 1. a power-law graph (R-MAT, Graph500 parameters)
g = rmat(12, seed=7)
print(f"graph: {g}")

# 2. a heterogeneous cluster: 3 'super' + 6 'normal' machines, the paper's
#    quadruples (memory, c_node, c_edge, c_com), memory scaled to the graph
cluster = scaled_paper_cluster(3, 6, g.num_edges)
for i, m in enumerate(cluster.machines[:4]):
    print(f"machine {i}: mem={m.memory:.2e} c_node={m.c_node} "
          f"c_edge={m.c_edge} c_com={m.c_com}")

# 3. WindGP: capacity preprocessing -> best-first expansion -> SLS
res = windgp(g, cluster, alpha=0.1, beta=0.1, t0=20, theta=0.02)
print(f"\nWindGP : TC={res.stats.tc:.4e}  RF={res.stats.rf:.3f}  "
      f"feasible={res.stats.feasible}  ({res.seconds:.2f}s)")

# 4. compare against the strongest homogeneous baseline (NE)
a = partitioner("ne")(g, cluster)
s = evaluate(g, a, cluster)
print(f"NE     : TC={s.tc:.4e}  RF={s.rf:.3f}")
print(f"speedup: {s.tc / res.stats.tc:.2f}x on the TC metric")

# 5. per-machine cost breakdown (the long-tail WindGP flattens)
t = res.stats.t_total
print(f"\nper-machine total cost: min={t.min():.3e} max={t.max():.3e} "
      f"(imbalance {t.max()/t.mean():.2f}x)")
