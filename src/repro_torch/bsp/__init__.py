"""BSP distributed graph engine (torch): the runtime the partitions feed.

Each *machine* is one slice of a leading machine axis; cross-machine vertex
synchronization is a fixed-shape reduction over the replicated-vertex
table, whose size shrinks with partition quality.
"""
from .partition_runtime import LocalBSR, PartitionRuntime
from .backends import BACKENDS, MESSAGE_DTYPES, EdgeBackend, get_backend
from .engine import exchange, make_step, run_bsp
from .apps import AppSpec, RunOptions, build_pagerank, pagerank
from . import ref

__all__ = ["PartitionRuntime", "LocalBSR",
           "BACKENDS", "MESSAGE_DTYPES", "EdgeBackend", "get_backend",
           "exchange", "make_step", "run_bsp",
           "AppSpec", "RunOptions", "build_pagerank", "pagerank", "ref"]
