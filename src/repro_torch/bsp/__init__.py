"""BSP distributed graph engine (torch): the runtime the partitions feed.

Each *machine* is one slice of a leading machine axis; cross-machine vertex
synchronization is a fixed-shape reduction over the replicated-vertex
table, whose size shrinks with partition quality.
"""
from .partition_runtime import LocalBSR, LocalRows, PartitionRuntime
from .stream_assignment import StreamAssignment, write_json_atomic
from .backends import (BACKENDS, MESSAGE_DTYPES, EdgeBackend, get_backend,
                       frontier_entries)
from .engine import exchange, make_fused_runner, make_step, run_bsp, \
    run_bsp_fused
from .distributed import (Machines, gather_machines, machine_group,
                          machine_slice, run_apps, spawn_machines)
from .apps import (APP_BUILDERS, MONOTONE_APPS, AppSpec, RunOptions,
                   bfs, build_app, build_pagerank, connected_components,
                   pagerank, sssp, triangle_count)
from . import ref
from .simulate import simulate_runtime, simulate_superstep_times

__all__ = ["PartitionRuntime", "LocalBSR", "LocalRows", "StreamAssignment",
           "write_json_atomic",
           "BACKENDS", "MESSAGE_DTYPES", "EdgeBackend", "get_backend",
           "frontier_entries", "exchange", "make_fused_runner", "make_step",
           "run_bsp", "run_bsp_fused",
           "Machines", "machine_group", "machine_slice", "gather_machines",
           "run_apps", "spawn_machines",
           "pagerank", "sssp", "bfs", "triangle_count",
           "connected_components", "build_app", "build_pagerank", "AppSpec",
           "APP_BUILDERS", "RunOptions", "MONOTONE_APPS",
           "ref", "simulate_superstep_times", "simulate_runtime"]
