"""Graph-partitioning CLI of the port: partition, pack, run PageRank.

  PYTHONPATH=src python -m repro_torch.launch.partition \\
      --graph graph500:16 --method windgp --pagerank --backend pallas

The main path of the system: load (generate) a graph, run WindGP on the
host, pack the partition into the fixed-shape ``PartitionRuntime``, and,
with ``--pagerank``, run distributed PageRank as BSP supersteps on
``--device`` (default ``cuda``) through an edge-kernel backend: ``scatter``
(the gather-scatter oracle) or ``pallas`` (the Block-ELL hand kernel).
It prints the same JSON report and ``pagerank[...]``/``top-5`` lines as
the reference CLI.  Edge-list files, ``--stream``, ``--compact``,
``--workers``, ``--fused``, ``--tol`` and low-precision messages are not
part of this package yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from ..core import evaluate, scaled_paper_cluster, windgp
from ..core import partitioners as registry
from ..data import graph500, rmat, road_mesh
from ..device import resolve_device

#: static mirror of ``repro_torch.bsp.backends.BACKENDS``, so that the
#: argument parser does not import the BSP layer
EDGE_BACKENDS = ("scatter", "pallas")


def load_graph(spec: str):
    kind, _, arg = spec.partition(":")
    gens = {"rmat": rmat, "graph500": graph500, "mesh": road_mesh}
    if kind not in gens or not arg:
        raise ValueError(f"--graph takes rmat:<scale> | graph500:<scale> | "
                         f"mesh:<side>, got {spec!r}")
    return gens[kind](int(arg), seed=42)


@dataclasses.dataclass
class Run:
    """What one CLI run produced (for callers that drive ``run`` directly)."""

    graph: object
    cluster: object
    assign: np.ndarray
    report: dict
    runtime: object = None          # PartitionRuntime, with --pagerank
    pagerank: np.ndarray | None = None
    actives: np.ndarray | None = None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Graph-partitioning CLI (see module docstring).")
    ap.add_argument("--graph", required=True,
                    help="rmat:<scale> | graph500:<scale> | mesh:<side>")
    ap.add_argument("--super", type=int, default=3)
    ap.add_argument("--normal", type=int, default=6)
    ap.add_argument("--slack", type=float, default=1.8)
    ap.add_argument("--method", default="windgp",
                    choices=registry.names(exclude={"oracle"}))
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--beta", type=float, default=0.3)
    ap.add_argument("--t0", type=int, default=8)
    ap.add_argument("--theta", type=float, default=0.01)
    ap.add_argument("--pagerank", action="store_true",
                    help="after partitioning, pack the BSP runtime and "
                         "run distributed PageRank on the partition")
    ap.add_argument("--pagerank-iters", type=int, default=20)
    ap.add_argument("--backend", default="scatter", choices=EDGE_BACKENDS,
                    help="edge-kernel backend for --pagerank: scatter "
                         "(gather-scatter oracle), pallas (Block-ELL hand "
                         "kernel)")
    ap.add_argument("--out", default=None, help=".npz output path")
    ap.add_argument("--device", default="cuda",
                    help="torch device for --pagerank (default cuda; "
                         "raises if CUDA is absent)")
    return ap.parse_args(argv)


def run(argv=None) -> Run:
    """Parse ``argv``, partition, and (with ``--pagerank``) rank."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    g = load_graph(args.graph)
    cl = scaled_paper_cluster(args.super, args.normal, g.num_edges,
                              slack=args.slack)
    print(f"graph: V={g.num_vertices} E={g.num_edges} "
          f"maxdeg={int(g.degree().max())}; cluster p={cl.p}", flush=True)
    t0 = time.perf_counter()
    if args.method == "windgp":
        res = windgp(g, cl, alpha=args.alpha, beta=args.beta,
                     t0=args.t0, theta=args.theta)
        assign, stats = res.assign, res.stats
    else:
        assign = registry.get(args.method)(g, cl)
        stats = evaluate(g, assign, cl)
    dt = time.perf_counter() - t0
    report = {
        "method": args.method, "seconds": round(dt, 2),
        "TC": stats.tc, "RF": round(stats.rf, 4),
        "feasible": stats.feasible,
        "edges_per_machine": stats.edges_per_part.astype(int).tolist(),
        "t_total_per_machine": np.round(stats.t_total, 1).tolist(),
    }
    print(json.dumps(report, indent=2))
    if args.out:
        np.savez(args.out, assign=assign,
                 machines=np.array([m.as_tuple() for m in cl.machines]))
        print(f"wrote {args.out}")
    out = Run(graph=g, cluster=cl, assign=assign, report=report)
    if args.pagerank:
        from ..bsp import PartitionRuntime
        out.runtime = PartitionRuntime.create(g, assign=assign, cluster=cl,
                                              device=device)
        out.pagerank, out.actives = _run_pagerank(out.runtime, args)
    return out


def _run_pagerank(rt, args):
    """Distributed PageRank on the fresh partition via --backend."""
    from ..bsp import RunOptions, pagerank
    opts = RunOptions(backend=args.backend)
    t0 = time.perf_counter()
    pr, actives = pagerank(rt, num_iters=args.pagerank_iters, options=opts)
    dt = time.perf_counter() - t0
    top = np.argsort(pr)[::-1][:5]
    print(f"pagerank[{args.backend}/stepwise/{opts.message_dtype}]: "
          f"{len(actives)}/{args.pagerank_iters} supersteps on "
          f"p={rt.p} machines (R={rt.num_replicas} replicas) in {dt:.2f}s; "
          f"mass={pr.sum():.6f}")
    print("top-5:", {int(v): round(float(pr[v]), 6) for v in top})
    return pr, actives


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
