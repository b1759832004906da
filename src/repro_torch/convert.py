"""Carry state across from the reference package: for this system, the
partition, not weights.

The functions take plain numpy arrays (a reference object's fields, e.g.
``{f.name: getattr(rt, f.name) for f in dataclasses.fields(rt)}``) so that
this package never imports the reference; the tests use them to feed both
packages identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .bsp.partition_runtime import LocalBSR, PartitionRuntime
from .device import resolve_device

#: the array fields of a PartitionRuntime, as the reference names them
RUNTIME_ARRAYS = ("local_vertex_gid", "vertex_valid", "local_edges",
                  "edge_valid", "edge_weight", "global_degree",
                  "weighted_degree", "rep_slot", "verts_per_machine",
                  "edges_per_machine")


def runtime_from_numpy(arrays: dict, device="cuda") -> PartitionRuntime:
    """A :class:`PartitionRuntime` from the reference runtime's fields.

    ``arrays`` holds ``p``, ``num_vertices``, ``num_replicas`` and the
    numpy arrays of :data:`RUNTIME_ARRAYS`; any other key (a cache, the
    reference's own extras) is ignored.  ``device`` is where the apps run.
    """
    missing = [k for k in ("p", "num_vertices", "num_replicas")
               + RUNTIME_ARRAYS if k not in arrays]
    if missing:
        raise ValueError(f"runtime_from_numpy: missing fields {missing}")
    return PartitionRuntime(
        p=int(arrays["p"]), num_vertices=int(arrays["num_vertices"]),
        num_replicas=int(arrays["num_replicas"]),
        **{k: np.asarray(arrays[k]) for k in RUNTIME_ARRAYS},
        device=resolve_device(device))


def local_bsr_from_numpy(cols: np.ndarray, blocks: np.ndarray,
                         gather: np.ndarray, rank: np.ndarray, *,
                         block_size: int, semiring: str,
                         fill_stats: tuple = (), device="cuda") -> LocalBSR:
    """A :class:`LocalBSR` from a reference ``LocalBSR``'s arrays
    (``cols (p,R,K)``, ``blocks (p,R,K,bm,bm)``, ``gather (p,R*bm)``,
    ``rank (p,Vmax)``), placed on ``device``."""
    dev = resolve_device(device)
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a)).to(device=dev,
                                                            dtype=dt)
    return LocalBSR(cols=as_t(cols, torch.int32),
                    blocks=as_t(blocks, torch.float32).contiguous(),
                    gather=as_t(gather, torch.int64),
                    rank=as_t(rank, torch.int64),
                    block_size=int(block_size), semiring=str(semiring),
                    fill_stats=tuple(fill_stats))
