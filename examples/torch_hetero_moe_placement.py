"""WindGP as an LM-framework feature, on the PyTorch port (the counterpart
of ``examples/hetero_moe_placement.py``): place MoE experts on
heterogeneous pods (the paper's §4 vertex-centric extension over the
expert co-activation graph), and split the global batch with Algorithm 1.

    PYTHONPATH=src python examples/torch_hetero_moe_placement.py [--device cpu]

The pods below are the reference example's modelled quadruples (compute
cost, memory in experts, link cost): inputs of a cost model, not
measurements.  Placement and split are host numpy, bitwise the
reference's; ``--device`` (default ``cuda``) is checked as every entry
point of the port checks it.
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.sharding.windgp_placement import (place_experts,
                                                   placement_cost)
from repro_torch.train import heterogeneous_batch_split

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; 'cpu' to run on the CPU)")
resolve_device(ap.parse_args().device)

# --- expert placement ------------------------------------------------------
E, toks = 16, 2000
rng = np.random.default_rng(0)
# skewed router: a hot clique of 4 experts co-activates heavily
hot = rng.choice(4, size=(toks // 2, 2))
cold = rng.choice(np.arange(4, E), size=(toks - toks // 2, 2))
routing = np.concatenate([hot, cold])

pods = {"v5p": dict(compute=0.5, mem=8, link=1.0),
        "v5e-a": dict(compute=1.0, mem=6, link=1.0),
        "v5e-b": dict(compute=1.0, mem=6, link=1.5)}
names = list(pods)
compute = [pods[n]["compute"] for n in names]
link = [pods[n]["link"] for n in names]
place = place_experts(E, routing, compute, [pods[n]["mem"] for n in names],
                      link)
print("expert -> pod:", {e: names[p] for e, p in enumerate(place)})
rr = np.arange(E) % len(names)
print(f"makespan windgp={placement_cost(place, routing, compute, link):.0f} "
      f"round-robin={placement_cost(rr, routing, compute, link):.0f}")

# --- heterogeneous batch split (Algorithm 1 verbatim) ----------------------
split = heterogeneous_batch_split(
    global_batch=1024,
    pod_step_cost=[1.0, 1.0, 0.55],     # two v5e pods + one v5p pod
    pod_mem_samples=[448, 448, 640])
print(f"\nglobal batch 1024 -> per-pod {split.tolist()} "
      f"(fast pod takes {split[2]/1024:.0%})")
