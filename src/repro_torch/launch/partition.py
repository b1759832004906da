"""Graph-partitioning CLI of the port: partition, pack, run PageRank.

  PYTHONPATH=src python -m repro_torch.launch.partition \\
      --graph graph500:16 --method windgp --pagerank --backend pallas
  PYTHONPATH=src python -m repro_torch.launch.partition --graph edges.txt.gz \\
      --method hdrf --stream --dedup two_pass --out-dir parts/ --pagerank

The main path of the system: load a graph (a generator spec or an edge-list
file, ``.gz`` ok), partition it on the host with any registered method
(WindGP or a baseline; ``--block-size`` reaches the block-stream scorers),
pack the partition into the fixed-shape ``PartitionRuntime``, and, with
``--pagerank``, run distributed PageRank as BSP supersteps on ``--device``
(default ``cuda``) through an edge-kernel backend: ``scatter`` (the
gather-scatter oracle), ``segment`` (sorted-CSR reduction) or ``pallas``
(the Block-ELL hand kernel), stepwise or on the fused runner (``--fused``,
``--tol``), with float32, bfloat16 or float16 messages
(``--message-dtype``).

``--stream`` partitions an edge-list file graph-free with a
``streamable`` method; ``--dedup two_pass`` adds the exact spill-to-disk
dedup, ``--out-dir`` persists the on-disk ``StreamAssignment`` that
``PartitionRuntime.from_stream`` packs (``--pagerank`` needs it), and
``--workers W`` runs the multi-process pipeline, synced every
``--sync-blocks`` engine blocks (1 = the sequential result bit for bit).
``--compact DIR`` folds the tombstones of a finalized assignment into its
shards and exits.  Every route prints the reference CLI's report lines.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from ..bsp import (BACKENDS, MESSAGE_DTYPES, PartitionRuntime, RunOptions,
                   pagerank)
from ..core import evaluate, evaluate_membership, scaled_paper_cluster, \
    windgp
from ..core import partitioners as registry
from ..data import graph500, read_edge_list, rmat, road_mesh
from ..device import resolve_device

#: generator specs of ``--graph``; anything else is an edge-list path
GENERATORS = {"rmat": rmat, "graph500": graph500, "mesh": road_mesh}


def load_graph(spec: str):
    kind, _, arg = spec.partition(":")
    if kind in GENERATORS:
        return GENERATORS[kind](int(arg), seed=42)
    return read_edge_list(spec)


@dataclasses.dataclass
class Run:
    """What one CLI run produced (for callers that drive ``run`` directly)."""

    report: dict
    graph: object = None            # None on --stream and --compact
    cluster: object = None
    assign: np.ndarray | None = None
    state: object = None            # the streamed state, with --stream
    assignment: object = None       # StreamAssignment, with --out-dir
    runtime: object = None          # PartitionRuntime, with --pagerank
    pagerank: np.ndarray | None = None
    actives: np.ndarray | None = None


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Graph-partitioning CLI (see module docstring).")
    ap.add_argument("--graph",
                    help="rmat:<scale> | graph500:<scale> | mesh:<side> | "
                         "path to an edge list (.gz ok)")
    ap.add_argument("--super", type=int, default=3)
    ap.add_argument("--normal", type=int, default=6)
    ap.add_argument("--slack", type=float, default=1.8)
    ap.add_argument("--method", default="windgp",
                    choices=registry.names(exclude={"oracle"}))
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--beta", type=float, default=0.3)
    ap.add_argument("--t0", type=int, default=8)
    ap.add_argument("--theta", type=float, default=0.01)
    ap.add_argument("--block-size", type=int, default=None,
                    help="stream-block size for 'blocked' methods")
    ap.add_argument("--stream", action="store_true",
                    help="out-of-core: partition an edge-list file "
                         "graph-free ('streamable' methods only)")
    ap.add_argument("--dedup", default="block",
                    choices=("block", "two_pass"),
                    help="--stream dedup discipline: per-block only, or "
                         "exact two-pass spill-to-disk")
    ap.add_argument("--out-dir", default=None,
                    help="--stream: persist the StreamAssignment "
                         "(per-machine shards + membership) here")
    ap.add_argument("--workers", type=int, default=1,
                    help="--stream: run the W-process pipeline (sharded "
                         "two-pass dedup + parallel wave scoring); 1 = "
                         "the sequential path bit for bit")
    ap.add_argument("--sync-blocks", type=int, default=None,
                    help="--workers > 1: engine blocks between membership "
                         "sync barriers (1 = bit-identical to sequential)")
    ap.add_argument("--compact", default=None, metavar="DIR",
                    help="standalone maintenance: fold tombstone debt "
                         "into the shards of a finalized StreamAssignment "
                         "directory, then exit (no partitioning run)")
    ap.add_argument("--compact-tomb-frac", type=float, default=0.0,
                    help="--compact: only rewrite shards whose tombstone "
                         "fraction exceeds this (0.0 = fold everything)")
    ap.add_argument("--pagerank", action="store_true",
                    help="after partitioning, pack the BSP runtime and "
                         "run distributed PageRank on the partition")
    ap.add_argument("--pagerank-iters", type=int, default=20)
    ap.add_argument("--backend", default="scatter", choices=BACKENDS,
                    help="edge-kernel backend for --pagerank: scatter "
                         "(gather-scatter oracle), segment (sorted-CSR "
                         "reduction), pallas (Block-ELL hand kernel)")
    ap.add_argument("--fused", action="store_true",
                    help="--pagerank: run the iteration on the fused "
                         "runner (chunks of supersteps, a CUDA graph each "
                         "on cuda) instead of one host sync per superstep")
    ap.add_argument("--tol", type=float, default=None,
                    help="--pagerank: stop once the on-device residual "
                         "max|pr_{t+1}-pr_t| <= TOL (implies --fused)")
    ap.add_argument("--message-dtype", default="float32",
                    choices=MESSAGE_DTYPES,
                    help="--pagerank: edge-message precision; bfloat16 "
                         "is the low-precision message path (messages "
                         "cast down, accumulation stays float32 on "
                         "scatter/segment)")
    ap.add_argument("--out", default=None, help=".npz output path")
    ap.add_argument("--device", default="cuda",
                    help="torch device for --pagerank (default cuda; "
                         "raises if CUDA is absent)")
    return ap


def run(argv=None) -> Run:
    """Parse ``argv``, partition, and (with ``--pagerank``) rank."""
    ap = parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.compact:
        return _run_compact(args)
    if not args.graph:
        ap.error("--graph is required (except with --compact)")
    if args.stream:
        return _run_stream(ap, args, device)
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
        part = registry.get(args.method)
        kw = {}
        if args.block_size is not None:
            if not part.supports("blocked"):
                ap.error(f"--block-size: method {part.name!r} is not a "
                         f"block-stream method (capabilities: "
                         f"{sorted(part.capabilities)})")
            kw["block_size"] = args.block_size
        assign = part(g, cl, **kw)
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
    out = Run(report=report, graph=g, cluster=cl, assign=assign)
    if args.pagerank:
        out.runtime = PartitionRuntime.create(g, assign=assign, cluster=cl,
                                              device=device)
        out.pagerank, out.actives = _run_pagerank(out.runtime, args)
    return out


def _run_pagerank(rt, args):
    """Distributed PageRank on the fresh partition via --backend."""
    opts = RunOptions(backend=args.backend, fused=args.fused, tol=args.tol,
                      message_dtype=args.message_dtype)
    t0 = time.perf_counter()
    pr, actives = pagerank(rt, num_iters=args.pagerank_iters, options=opts)
    dt = time.perf_counter() - t0
    top = np.argsort(pr)[::-1][:5]
    mode = "fused" if (args.fused or args.tol is not None) else "stepwise"
    print(f"pagerank[{args.backend}/{mode}/{args.message_dtype}]: "
          f"{len(actives)}/{args.pagerank_iters} supersteps on "
          f"p={rt.p} machines (R={rt.num_replicas} replicas) in {dt:.2f}s; "
          f"mass={pr.sum():.6f}")
    print("top-5:", {int(v): round(float(pr[v]), 6) for v in top})
    return pr, actives


def _run_compact(args) -> Run:
    """Standalone tombstone-folding pass over a finalized assignment."""
    from ..bsp import StreamAssignment
    sa = StreamAssignment.open(args.compact)
    before = int(sa.tomb_rows.sum())
    t0 = time.perf_counter()
    meta = sa.compact(args.compact_tomb_frac)
    dt = time.perf_counter() - t0
    report = {
        "compacted": args.compact, "seconds": round(dt, 3),
        "tomb_rows_folded": before - int(sa.tomb_rows.sum()),
        "tomb_rows_left": int(sa.tomb_rows.sum()),
        "shard_rows": meta["shard_rows"],
        "num_edges": meta["num_edges"],
    }
    print(json.dumps(report, indent=2))
    return Run(report=report, assignment=sa)


def _run_stream(ap, args, device) -> Run:
    """Out-of-core path: graph-free streaming over an edge-list file."""
    import pathlib

    from ..data import count_edge_list
    part = registry.get(args.method)
    if not part.supports("streamable"):
        ap.error(f"--stream: method {part.name!r} is not streamable "
                 f"(capabilities: {sorted(part.capabilities)}); "
                 f"streamable: {registry.names(require={'streamable'})}")
    if args.graph.split(":")[0] in GENERATORS:
        ap.error("--stream partitions edge-list files; generator specs "
                 "would materialize the graph first")
    if args.pagerank and not args.out_dir:
        ap.error("--stream --pagerank needs --out-dir: the BSP runtime "
                 "packs from the persisted StreamAssignment shards")

    if args.dedup == "two_pass":
        if args.workers > 1:
            # shard the spill/dedup passes across the same worker count
            # the scoring stage will use
            from ..core.parallel import ShardedTwoPassDedup
            source = ShardedTwoPassDedup(args.graph, workers=args.workers)
            source.prepare()
        else:
            from ..data import two_pass_dedup
            source = two_pass_dedup(args.graph)
        num_v, num_e = source.num_vertices, source.num_edges
    else:
        # count at the same reader granularity the stream will use:
        # per-block dedup makes the edge count a function of the window
        from ..data.io import DEFAULT_BLOCK_LINES
        source = args.graph
        num_v, num_e = count_edge_list(
            args.graph, args.block_size or DEFAULT_BLOCK_LINES)
    cl = scaled_paper_cluster(args.super, args.normal, num_e,
                              slack=args.slack)
    print(f"stream: V={num_v} E={num_e} dedup={args.dedup} p={cl.p}",
          flush=True)

    sa = None
    kw = {"dedup": args.dedup}
    if args.block_size is not None:
        kw["block_size"] = args.block_size
    if args.workers > 1:
        kw["workers"] = args.workers
        kw["sync_blocks"] = args.sync_blocks
    if args.out_dir:
        from ..bsp import StreamAssignment
        sa = StreamAssignment(pathlib.Path(args.out_dir), cl.p, num_v)
        kw["sink"] = sa.sink
    t0 = time.perf_counter()
    try:
        state = part.stream(source, num_v, num_e, cl, **kw)
    except BaseException:
        if sa is not None:
            sa.close()      # abort: drop shard handles, publish nothing
        raise
    finally:
        if hasattr(source, "close"):
            source.close()
    dt = time.perf_counter() - t0

    stats = evaluate_membership(state.cnt > 0, state.edges_per, cl)
    report = {
        "method": args.method, "mode": f"stream/{args.dedup}",
        "seconds": round(dt, 2),
        "TC": stats.tc, "RF": round(stats.rf, 4),
        "feasible": stats.feasible,
        "edges_per_machine": stats.edges_per_part.astype(int).tolist(),
        "t_total_per_machine": np.round(stats.t_total, 1).tolist(),
    }
    if state.spill_stats is not None:
        report["spill"] = {
            "buckets": state.spill_stats.num_buckets,
            "duplicate_rows": state.spill_stats.duplicate_rows,
            "peak_resident_rows": state.spill_stats.peak_resident_rows,
        }
    print(json.dumps(report, indent=2))
    out = Run(report=report, cluster=cl, state=state, assignment=sa)
    if sa is not None:
        meta = sa.finalize(state, {"method": args.method,
                                   "dedup": args.dedup})
        print(f"wrote StreamAssignment to {args.out_dir} "
              f"(E={meta['num_edges']}, rf={meta['replication_factor']})")
        if args.pagerank:
            out.runtime = PartitionRuntime.create(sa, device=device)
            out.pagerank, out.actives = _run_pagerank(out.runtime, args)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
