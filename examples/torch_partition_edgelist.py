"""Partition a SNAP edge list into per-machine shards on the PyTorch port
-- then run on them (the counterpart of ``examples/partition_edgelist.py``,
with its arguments, output layout and printed lines).

    PYTHONPATH=src python examples/torch_partition_edgelist.py edges.txt \
        --part-method hdrf --num-parts 8 --block-size 4096 --out-dir parts/

Block-stream methods (greedy/hdrf/ebv) run fully chunked: a counting pass
for |V|/|E|, then one streaming pass that writes each machine's edge file
as placements finalize.  Every other registered method falls back to an
in-memory graph build.  Output: ``<out-dir>/part<i>.edges``,
``<out-dir>/assignment/`` (the binary ``StreamAssignment``) and
``<out-dir>/meta.json`` (counts and the replication factor, written last
by an atomic rename).  The partition is host numpy, bitwise the
reference's.

``--two-pass`` is the exact spill-to-disk dedup, ``--workers W`` the
W-process pipeline, and ``--pagerank`` packs the shards into the BSP
runtime on ``--device`` (default ``cuda``) and runs PageRank through
``--backend``: ``scatter``, ``segment`` or ``pallas``, the hand-written
``bsr_spmv_rows`` kernel on the card (its plain version on the CPU), with
``--fused``, ``--tol`` and ``--message-dtype`` as in the reference.  The
reference example's docstring walks through these workflows and the
dynamic and sampling layers, whose port counterparts are
``repro_torch.core.DynamicPartitioner`` and ``repro_torch.sampling``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

from repro_torch.bsp import (BACKENDS, MESSAGE_DTYPES, PartitionRuntime,
                             StreamAssignment, write_json_atomic)
from repro_torch.core import (evaluate, evaluate_membership,
                              scaled_paper_cluster)
from repro_torch.core import partitioners as registry
from repro_torch.data import TwoPassDedup, count_edge_list, read_edge_list
from repro_torch.device import resolve_device
from repro_torch.launch.partition import _run_pagerank


def _partition_streaming(args, part, out: pathlib.Path):
    """Graph-free path: count → (optional two-pass dedup) → stream.

    Returns (num_v, num_e, stats, StreamAssignment, spill_stats).
    """
    source: object
    if args.two_pass:
        print(f"spilling+deduplicating {args.edge_list} "
              f"(workers={args.workers}) ...", flush=True)
        if args.workers > 1:
            from repro_torch.core.parallel import ShardedTwoPassDedup
            source = ShardedTwoPassDedup(
                args.edge_list, block_size=args.block_size,
                bucket_rows=args.bucket_rows, workers=args.workers)
        else:
            source = TwoPassDedup(args.edge_list,
                                  block_size=args.block_size,
                                  bucket_rows=args.bucket_rows)
        num_v, num_e = source.prepare()
    else:
        print(f"counting {args.edge_list} ...", flush=True)
        # same block size as the partitioning pass, so both passes see the
        # identical canonicalized stream (dedup is per-block)
        num_v, num_e = count_edge_list(args.edge_list, args.block_size)
        source = args.edge_list
    n_super = args.n_super or max(1, args.num_parts // 3)
    cl = scaled_paper_cluster(n_super, args.num_parts - n_super, num_e,
                              slack=args.slack)
    print(f"V={num_v} E={num_e} p={cl.p} method={part.name} "
          f"(kind={part.kind}, caps={sorted(part.capabilities)})")

    sa = StreamAssignment(out / "assignment", cl.p, num_v)
    files = [open(out / f"part{i}.edges", "w") for i in range(cl.p)]
    try:
        def sink(edges, ms):
            sa.sink(edges, ms)
            for i in np.unique(ms):
                np.savetxt(files[int(i)], edges[ms == i], fmt="%d")

        kw = {}
        if args.workers > 1:
            kw = {"workers": args.workers, "sync_blocks": args.sync_blocks}
        state = part.stream(
            source, num_v, num_e, cl,
            dedup="two_pass" if args.two_pass else "block",
            block_size=args.block_size, sink=sink, **kw)
    except BaseException:
        sa.close()          # abort: drop shard handles, publish nothing
        raise
    finally:
        for f in files:
            f.close()
        if args.two_pass:
            source.close()
    stats = evaluate_membership(state.cnt > 0, state.edges_per, cl)
    sa.finalize(state, {"method": part.name,
                        "dedup": "two_pass" if args.two_pass else "block"})
    return num_v, num_e, stats, sa, state.spill_stats


def _partition_in_memory(args, part, out: pathlib.Path):
    """Fallback for non-streamable methods: materialize the graph."""
    g = read_edge_list(args.edge_list)
    num_v, num_e = g.num_vertices, g.num_edges
    n_super = args.n_super or max(1, args.num_parts // 3)
    cl = scaled_paper_cluster(n_super, args.num_parts - n_super, num_e,
                              slack=args.slack)
    print(f"V={num_v} E={num_e} p={cl.p} method={part.name} "
          f"(kind={part.kind}, caps={sorted(part.capabilities)})")
    assign = part(g, cl)
    stats = evaluate(g, assign, cl)
    sa = StreamAssignment(out / "assignment", cl.p, num_v)
    files = [open(out / f"part{i}.edges", "w") for i in range(cl.p)]
    try:
        sa.sink(g.edges.astype(np.int64), assign.astype(np.int64))
        for i in range(cl.p):
            np.savetxt(files[i], g.edges[assign == i], fmt="%d")
    except BaseException:
        sa.close()
        raise
    finally:
        for f in files:
            f.close()
    from repro_torch.core.machines import vertex_partition_sets
    sa.finalize(vertex_partition_sets(g, assign, cl.p),
                {"method": part.name, "dedup": "in_memory"})
    return num_v, num_e, stats, sa, None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("edge_list", help="whitespace u-v edge list (.gz ok)")
    ap.add_argument("--part-method", default="hdrf",
                    choices=registry.names(exclude={"oracle"}))
    ap.add_argument("--num-parts", type=int, default=8)
    ap.add_argument("--super", type=int, default=0, dest="n_super",
                    help="how many of the parts are 'super' machines "
                         "(0 = one in three, the paper's default mix)")
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--slack", type=float, default=1.8)
    ap.add_argument("--two-pass", action="store_true",
                    help="exact out-of-core dedup via spill buckets "
                         "(streaming methods; default is per-block dedup)")
    ap.add_argument("--bucket-rows", type=int, default=1 << 16,
                    help="--two-pass spill-bucket row target (bounds peak "
                         "edge residency)")
    ap.add_argument("--workers", type=int, default=1,
                    help="W-process pipeline: sharded dedup + parallel "
                         "wave scoring (see 'Multi-worker workflow'); "
                         "1 = sequential bit for bit")
    ap.add_argument("--sync-blocks", type=int, default=None,
                    help="--workers > 1: engine blocks between membership "
                         "sync barriers (1 = bit-identical to sequential)")
    ap.add_argument("--pagerank", action="store_true",
                    help="after partitioning, pack the BSP runtime from "
                         "the shards and run distributed PageRank")
    ap.add_argument("--pagerank-iters", type=int, default=30)
    ap.add_argument("--backend", default="scatter",
                    choices=BACKENDS,
                    help="edge-kernel backend for --pagerank (see "
                         "module docstring)")
    ap.add_argument("--fused", action="store_true",
                    help="--pagerank: whole iteration as one on-device "
                         "dispatch (see module docstring)")
    ap.add_argument("--tol", type=float, default=None,
                    help="--pagerank: on-device convergence tolerance "
                         "(implies --fused)")
    ap.add_argument("--message-dtype", default="float32",
                    choices=MESSAGE_DTYPES,
                    help="--pagerank: edge-message precision (bfloat16 "
                         "= low-precision message path)")
    ap.add_argument("--out-dir", default="parts")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --pagerank (default cuda; 'cpu' "
                         "to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    part = registry.get(args.part_method)
    if args.two_pass and not part.supports("streamable"):
        ap.error(f"--two-pass: {part.name!r} is not streamable "
                 f"(in-memory methods dedup exactly already)")
    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    if part.supports("streamable"):
        num_v, num_e, stats, sa, spill = _partition_streaming(args, part, out)
    else:
        num_v, num_e, stats, sa, spill = _partition_in_memory(args, part, out)
    dt = time.perf_counter() - t0

    counts = sa.edges_per
    meta = {
        "method": part.name, "num_parts": sa.p, "num_vertices": num_v,
        "num_edges": int(counts.sum()), "block_size": args.block_size,
        "dedup": sa.meta["dedup"],
        "seconds": round(dt, 3),
        "TC": stats.tc,
        "replication_factor": round(float(stats.rf), 4),
        "edges_per_part": counts.tolist(),
        "files": [f"part{i}.edges" for i in range(sa.p)],
        "assignment_dir": "assignment",
    }
    if spill is not None:
        meta["spill"] = {
            "num_buckets": spill.num_buckets,
            "bucket_rows": spill.bucket_rows,
            "spilled_rows": spill.spilled_rows,
            "duplicate_rows": spill.duplicate_rows,
            "max_bucket_rows": spill.max_bucket_rows,
            "peak_resident_rows": spill.peak_resident_rows,
        }
    # every edge exactly once: the written total must equal the
    # *independently counted* stream size (exact dedup count in two-pass
    # mode, the same-window per-block count otherwise)
    assert int(counts.sum()) == num_e, \
        f"wrote {int(counts.sum())} edges, counted {num_e}"
    # shards were verified in sa.finalize(); only now publish the manifest,
    # atomically — readers either see no meta.json or a complete one
    write_json_atomic(out / "meta.json", meta)
    print(json.dumps(meta, indent=2))

    if args.pagerank:
        # same report as the launch CLI (shared helper): pack the runtime
        # from the on-disk shards, run supersteps through --backend
        _run_pagerank(PartitionRuntime.create(sa, device=device), args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
