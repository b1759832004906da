"""Distributed graph algorithms on the BSP engine.

Every superstep's edge work is one semiring SpMV against each machine's
local adjacency, expressed through a pluggable edge-kernel backend
(``bsp/backends.py``); PageRank combines under (+, ×) with edge weights.
The replica exchange is fused into the backend combine's epilogue
(``EdgeBackend.prepare_exchanged``), so a superstep body makes one
``combine`` call that already returns post-exchange values.

This package has PageRank; SSSP, BFS, connected components and triangle
counting are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .backends import BACKENDS, MESSAGE_DTYPES, get_backend
from .engine import run_bsp
from .partition_runtime import PartitionRuntime


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """The engine/backend knobs the BSP apps share, validated once.

    * ``backend`` — edge-kernel backend (``bsp/backends.py``).
    * ``message_dtype`` — message precision (see ``MESSAGE_DTYPES``).
    """

    backend: str = "scatter"
    message_dtype: str = "float32"

    def validate(self) -> "RunOptions":
        """Raise ``ValueError`` on bad knobs; returns self."""
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown edge-kernel backend "
                             f"{self.backend!r} "
                             f"(choices: {sorted(BACKENDS)})")
        if self.message_dtype not in MESSAGE_DTYPES:
            raise ValueError(f"unknown message_dtype "
                             f"{self.message_dtype!r} (choices: "
                             f"{list(MESSAGE_DTYPES)})")
        return self

    def backend_opts(self) -> dict:
        """The knobs that flow to ``get_backend`` for this run."""
        return {"message_dtype": self.message_dtype}


def _options(options: RunOptions | None, backend, backend_opts: dict):
    """Resolve ``options=`` vs the per-kwarg spelling.

    Returns ``(RunOptions, extra_backend_opts)``; the extras are
    backend-specific knobs outside the shared surface (the pallas
    ``block_size``), which pass through either way.
    """
    extra = dict(backend_opts)
    if options is not None:
        mixed = ["backend"] if backend != "scatter" else []
        mixed += ["message_dtype"] if "message_dtype" in extra else []
        if mixed:
            raise ValueError(
                f"got both options=RunOptions(...) and the individual "
                f"kwarg(s) {mixed} — pass the shared knobs one way or "
                f"the other")
    else:
        options = RunOptions(
            backend=backend,
            message_dtype=extra.pop("message_dtype", "float32"))
    return options.validate(), extra


def _static_tree(rt: PartitionRuntime) -> dict:
    dev = rt.device
    as_t = lambda a, dt: torch.as_tensor(a).to(device=dev, dtype=dt)
    return {
        "edges": as_t(rt.local_edges, torch.int64),
        "edge_valid": as_t(rt.edge_valid, torch.bool),
        "edge_weight": as_t(rt.edge_weight, torch.float32),
        "vertex_valid": as_t(rt.vertex_valid, torch.bool),
        "global_degree": as_t(rt.global_degree, torch.int32),
        "weighted_degree": as_t(rt.weighted_degree, torch.float32),
        "rep_slot": as_t(rt.rep_slot, torch.int64),
    }


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """One app instance, ready for ``run_bsp``.

    ``superstep(state, static) -> (state, (p,) active)`` over
    machine-stacked tensors; ``static`` already carries the backend's
    prepared tensors.
    """

    name: str
    superstep: Callable
    state: dict
    static: dict
    finalize: Callable        # (rt, out_state) -> global result array


def _resolve(rt, backend, semiring: str, weights: str, exchange_mode: str,
             **opts):
    """Backend + static tree + exchange-fused combine for one app."""
    r_pad = max(1, rt.num_replicas)
    eb = get_backend(backend, **opts)
    extras, combine = eb.prepare_exchanged(rt, semiring, weights,
                                           exchange_mode, r_pad)
    return eb, {**_static_tree(rt), **extras}, combine


def build_pagerank(rt: PartitionRuntime, damping: float = 0.85, *,
                   backend="scatter", init: np.ndarray | None = None,
                   **backend_opts) -> AppSpec:
    """``init`` warm-starts from a previous run's (V,) global PageRank;
    vertices new to this runtime fall back to the uniform mass.  Power
    iteration converges from any non-degenerate start."""
    n = rt.num_vertices
    _, static, combine = _resolve(rt, backend, "plus_times", "weight",
                                  "sum", **backend_opts)

    def superstep(state, sa):
        pr, vv = state["pr"], sa["vertex_valid"]
        # weighted PageRank: messages normalize by the weighted degree
        msg = torch.where(vv, pr / sa["weighted_degree"], 0.0)
        total = combine(sa, msg)              # post-exchange ("sum")
        new_pr = torch.where(vv, (1.0 - damping) / n + damping * total, 0.0)
        return {"pr": new_pr}, vv.sum(dim=1)

    vv = static["vertex_valid"]
    if init is None:
        pr0 = torch.where(vv, 1.0 / n, 0.0).to(torch.float32)
    else:
        pr0 = torch.as_tensor(
            rt.scatter_global(np.asarray(init, dtype=np.float32),
                              fill=1.0 / n)).to(vv.device)
        pr0 = torch.where(vv, pr0, 0.0)
    # isolated vertices (no incident edge, hence in no partition) hold the
    # teleport mass only
    fin = lambda rt, out: rt.gather_global(out["pr"].cpu().numpy(),
                                           fill=(1.0 - damping) / n)
    return AppSpec("pagerank", superstep, {"pr": pr0}, static, fin)


def pagerank(rt: PartitionRuntime, num_iters: int = 20,
             damping: float = 0.85, *, options: RunOptions | None = None,
             backend="scatter", init: np.ndarray | None = None,
             **backend_opts):
    """Returns ((V,) global PageRank, (steps, p) actives) after
    ``num_iters`` supersteps on ``rt.device``.

    ``options=RunOptions(...)`` carries the shared knobs in one validated
    object; ``backend=``/``message_dtype=`` is the per-kwarg spelling.
    """
    opts, extra = _options(options, backend, backend_opts)
    spec = build_pagerank(rt, damping, backend=opts.backend, init=init,
                          **opts.backend_opts(), **extra)
    out, actives = run_bsp(spec.superstep, spec.state, spec.static,
                           num_iters)
    return spec.finalize(rt, out), actives
