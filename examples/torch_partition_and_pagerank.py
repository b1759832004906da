"""End-to-end driver on the PyTorch port (the counterpart of
``examples/partition_and_pagerank.py``): partition a graph with WindGP and
run distributed PageRank + SSSP on the BSP engine, comparing the
heterogeneous-cluster makespan against baseline partitioners.

    PYTHONPATH=src python examples/torch_partition_and_pagerank.py [--device cpu]

The partitions are host numpy, bitwise the reference's; the supersteps run
on ``--device`` (default ``cuda``) through the ``scatter`` backend, as the
reference example's do.
"""
import argparse
import time

import numpy as np

from repro_torch.bsp import (PartitionRuntime, pagerank, ref,
                             simulate_runtime, sssp)
from repro_torch.core import evaluate, scaled_paper_cluster, windgp
from repro_torch.core.partitioners import get as partitioner
from repro_torch.data import rmat

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; 'cpu' to run on the CPU)")
args = ap.parse_args()

g = rmat(12, seed=3)
cluster = scaled_paper_cluster(3, 6, g.num_edges)
print(f"graph {g}; cluster p={cluster.p}")

results = {}
for method in ("hash", "ne", "windgp"):
    if method == "windgp":
        assign = windgp(g, cluster, alpha=0.1, beta=0.1,
                        t0=20, theta=0.02).assign
    else:
        assign = partitioner(method)(g, cluster)
    stats = evaluate(g, assign, cluster)
    rt = PartitionRuntime.create(g, assign=assign, cluster=cluster,
                                 device=args.device)

    t0 = time.perf_counter()
    pr, _ = pagerank(rt, num_iters=30)
    wall = time.perf_counter() - t0
    sim = simulate_runtime(rt, cluster, num_steps=30)

    _, act = sssp(rt, source=0, num_iters=20)
    sim_sssp = simulate_runtime(rt, cluster, actives=act,
                                comm_scale="active")
    err = np.abs(pr - ref.pagerank(g, num_iters=30)).max()
    results[method] = (stats.tc, sim, sim_sssp)
    print(f"{method:7s} TC={stats.tc:.3e}  PR-makespan={sim:.3e}  "
          f"SSSP-makespan={sim_sssp:.3e}  wall={wall:.1f}s  maxerr={err:.1e}")

print("\nheterogeneous-cluster speedup of WindGP over NE:")
for i, name in enumerate(("TC", "PageRank", "SSSP")):
    print(f"  {name}: {results['ne'][i] / results['windgp'][i]:.2f}x")
