"""Carry state across from the reference package: the partition of the
graph path, and the parameters of the LM path.

The functions take plain numpy arrays (a reference object's fields, e.g.
``{f.name: getattr(rt, f.name) for f in dataclasses.fields(rt)}``, or a
parameter pytree passed through ``np.asarray``) so that this package never
imports the reference; the tests use them to feed both packages identical
inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .bsp.partition_runtime import LocalBSR, PartitionRuntime
from .device import resolve_device
from .models.config import ModelConfig
from .models.model import Decoder

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


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 leaves (``ml_dtypes``) travel as
    their 16-bit patterns, so this module needs no ``ml_dtypes``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> Decoder:
    """The port's :class:`Decoder` from the reference's ``init_params``
    pytree as numpy arrays: ``blocks/pos{p}/...`` leaves stacked on
    ``n_super``, and ``final_norm``, ``embed``, ``unembed`` as present.
    Layer ``i`` is super-block ``i // period`` at position ``i % period``."""
    dev = resolve_device(device)
    period = cfg.pattern_period

    def layer(node, s):
        if isinstance(node, dict):
            return {k: layer(v, s) for k, v in node.items()}
        return _tensor(np.asarray(node)[s], dev)

    blocks = [layer(tree["blocks"][f"pos{i % period}"], i // period)
              for i in range(cfg.num_layers)]
    top = {k: _tensor(tree[k], dev) for k in ("final_norm", "embed",
                                              "unembed") if k in tree}
    return Decoder(cfg, blocks, top)
