"""Distributed graph algorithms on the BSP engine.

The paper evaluates dense (PageRank, TriangleCount) and sparse (SSSP, BFS)
algorithms over its edge partitions; these are the same four, plus
connected components, written as machine-stacked superstep bodies.

Every superstep's edge work is one semiring SpMV against each machine's
local adjacency, expressed through a pluggable edge-kernel backend
(``bsp/backends.py``): PageRank combines under (+, ×) with edge weights,
SSSP under (min, +), BFS expands its frontier under (or, and), and
connected components propagates labels under (min, +) with zero weights.
The replica exchange is fused into the backend combine's epilogue
(``EdgeBackend.prepare_exchanged``), so a superstep body makes one
``combine`` call that already returns post-exchange values.

The monotone apps (SSSP/CC) carry a changed-vertex mask in their state:
only vertices whose value improved last superstep send messages; everyone
else feeds the semiring's no-message value (+inf under (min, +)), whose ⊕
contribution is the identity.  BFS's frontier (``dist == step``) already
is that mask.  It is what the ``scatter`` backend's ``frontier_cap``
compaction keys on.

Every app wrapper runs on either engine runner: the stepwise oracle
(``run_bsp``, default) or the fused runner (``fused=True`` / ``tol=`` →
``run_bsp_fused``).  ``options=RunOptions(...)`` carries the shared knobs
in one validated object; the individual kwargs are the other spelling.

``mesh=`` (a :class:`~.distributed.Machines` group or a ``ProcessGroup``
of ``rt.p`` ranks) runs one machine a rank, as the reference's ``mesh=``
runs one a device: each rank builds its app on its machine's slice of
``rt`` (``distributed.machine_slice``), the exchange all-reduces across
the ranks, and the final states are all-gathered, so every rank returns
the same ``(V,)`` result and ``(steps, p)`` actives.

A query records the spans (``repro_torch.obs``) ``bsp.prepare`` (the
backend and the static tree), one ``bsp.superstep`` a stepwise superstep
(``engine.run_bsp``) and ``bsp.finalize`` (the global result).  The static
tree (``_static_tree``) is copied to the device on a runtime's first query
and stays there for the runtime's later ones: a build counts the bytes it
copies under ``bsp.h2d_bytes``, a reuse counts one ``bsp.tree_hits``, so
the builds are ``bsp.prepare``'s count less ``bsp.tree_hits``.  A mesh
query's machine slice is a new runtime, so it builds every query.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import obs
from .backends import BACKENDS, MESSAGE_DTYPES, get_backend
from .distributed import gather_machines, local_runtime
from .engine import run_bsp, run_bsp_fused
from .partition_runtime import PartitionRuntime

#: apps whose state is monotone under the semiring: they already exit on
#: an empty changed-set, so PageRank's ``tol`` residual gate does not
#: apply to them (RunOptions.validate rejects the combination)
MONOTONE_APPS = ("bfs", "cc", "sssp")


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """The engine/backend knobs every BSP app shares, validated once.

    * ``backend`` — edge-kernel backend (``bsp/backends.py``).
    * ``fused`` — run the iteration on the fused runner.
    * ``tol`` — PageRank residual early exit (implies ``fused``); the
      monotone apps (:data:`MONOTONE_APPS`) reject it.
    * ``chunk`` — fused-runner chunk (supersteps per convergence check).
    * ``message_dtype`` — message precision (see ``MESSAGE_DTYPES``).
    * ``frontier_cap`` — scatter-only frontier compaction width.
    """

    backend: str = "scatter"
    fused: bool = False
    tol: float | None = None
    chunk: int = 8
    message_dtype: str = "float32"
    frontier_cap: int | None = None

    def validate(self, app: str | None = None) -> "RunOptions":
        """Raise ``ValueError`` on bad knobs / combinations; returns self."""
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown edge-kernel backend "
                             f"{self.backend!r} "
                             f"(choices: {sorted(BACKENDS)})")
        if self.message_dtype not in MESSAGE_DTYPES:
            raise ValueError(f"unknown message_dtype "
                             f"{self.message_dtype!r} (choices: "
                             f"{list(MESSAGE_DTYPES)})")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.tol is not None and app in MONOTONE_APPS:
            raise ValueError(
                f"tol= is the PageRank residual gate; {app!r} is monotone "
                f"and already exits on an empty changed-set — valid "
                f"choices: tol=None here, or tol with app='pagerank' "
                f"(use fused=True for the fused runner)")
        if self.frontier_cap is not None and self.backend != "scatter":
            raise ValueError(
                f"frontier_cap is a 'scatter'-backend knob (frontier "
                f"compaction); backend {self.backend!r} does not take it "
                f"— valid choices: backend='scatter', or frontier_cap="
                f"None")
        return self

    def backend_opts(self) -> dict:
        """The knobs that flow to ``get_backend`` for this run."""
        opts = {"message_dtype": self.message_dtype}
        if self.frontier_cap is not None:
            opts["frontier_cap"] = self.frontier_cap
        return opts


def _options(options: RunOptions | None, app: str, backend, fused, tol,
             chunk, backend_opts: dict):
    """Resolve ``options=`` vs the per-kwarg spelling.

    Returns ``(RunOptions, extra_backend_opts)``; the extras are
    backend-specific knobs outside the shared surface (the pallas
    ``block_size``), which pass through either way.
    """
    extra = dict(backend_opts)
    if options is not None:
        mixed = [name for name, val, default in
                 (("backend", backend, "scatter"), ("fused", fused, False),
                  ("tol", tol, None), ("chunk", chunk, 8))
                 if val != default]
        mixed += sorted(k for k in ("message_dtype", "frontier_cap")
                        if k in extra)
        if mixed:
            raise ValueError(
                f"got both options=RunOptions(...) and the individual "
                f"kwarg(s) {mixed} — pass the shared knobs one way or "
                f"the other")
    else:
        options = RunOptions(
            backend=backend, fused=fused, tol=tol, chunk=chunk,
            message_dtype=extra.pop("message_dtype", "float32"),
            frontier_cap=extra.pop("frontier_cap", None))
    options.validate(app)
    return options, extra


#: the static tree: each tensor's runtime array and dtype
_TREE_FIELDS = {"edges": ("local_edges", torch.int64),
                "edge_valid": ("edge_valid", torch.bool),
                "edge_weight": ("edge_weight", torch.float32),
                "vertex_valid": ("vertex_valid", torch.bool),
                "global_degree": ("global_degree", torch.int32),
                "weighted_degree": ("weighted_degree", torch.float32),
                "rep_slot": ("rep_slot", torch.int64)}

#: the static tree's key in the runtime's layout cache (whose other keys
#: are the layouts' tuples)
_TREE_KEY = ("tree",)


def _static_tree(rt: PartitionRuntime) -> dict:
    """The runtime's arrays as tensors on its device, in a new dict.

    The tensors are copied once, on the runtime's first query, and kept
    in its layout cache beside ``local_rows`` (``rt.clear_bsr_cache()``
    drops them); every later query reads the same tensors, which nothing
    writes into.  A build counts its bytes under ``bsp.h2d_bytes``, a
    reuse one ``bsp.tree_hits``."""
    tree = rt._bsr_cache.get(_TREE_KEY)
    if tree is None:
        tree = rt._bsr_cache[_TREE_KEY] = {
            name: torch.tensor(getattr(rt, field), dtype=dt,
                               device=rt.device)
            for name, (field, dt) in _TREE_FIELDS.items()}
        obs.count("bsp.h2d_bytes",
                  sum(t.numel() * t.element_size() for t in tree.values()))
    else:
        obs.count("bsp.tree_hits")
    return dict(tree)


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """One app instance, ready for ``run_bsp``.

    ``superstep(state, static) -> (state, (p,) active)`` over
    machine-stacked tensors; ``static`` already carries the backend's
    prepared tensors.  Built with ``mesh``, the tensors are this rank's
    machine's ``(1, ...)`` and ``mesh`` is its machine group.
    """

    name: str
    superstep: Callable
    state: dict
    static: dict
    finalize: Callable        # (rt, out_state) -> global result array
    mesh: object = None


def _resolve(rt, backend, semiring: str, weights: str, exchange_mode: str,
             mesh=None, **opts):
    """Backend + static tree + exchange-fused combine for one app (the
    ``bsp.prepare`` span)."""
    with obs.span("bsp.prepare"):
        r_pad = max(1, rt.num_replicas)
        eb = get_backend(backend, **opts)
        extras, combine = eb.prepare_exchanged(rt, semiring, weights,
                                               exchange_mode, r_pad,
                                               mesh=mesh)
        return eb, {**_static_tree(rt), **extras}, combine


def _run(spec: "AppSpec", num_steps: int, opts: RunOptions):
    """Dispatch an :class:`AppSpec` to the stepwise or fused runner."""
    if opts.fused or opts.tol is not None:
        return run_bsp_fused(spec.superstep, spec.state, spec.static,
                             num_steps, mesh=spec.mesh, chunk=opts.chunk,
                             tol=opts.tol)
    return run_bsp(spec.superstep, spec.state, spec.static, num_steps,
                   mesh=spec.mesh)


def _result(spec: "AppSpec", rt: PartitionRuntime, out: dict):
    """The app's global result from its final state; under a mesh, from
    every rank's state, gathered (the ``bsp.finalize`` span)."""
    with obs.span("bsp.finalize"):
        if spec.mesh is not None:
            out = gather_machines(out, spec.mesh)
        return spec.finalize(rt, out)


def build_pagerank(rt: PartitionRuntime, damping: float = 0.85, *,
                   backend="scatter", init: np.ndarray | None = None,
                   mesh=None, **backend_opts) -> AppSpec:
    """``init`` warm-starts from a previous run's (V,) global PageRank;
    vertices new to this runtime fall back to the uniform mass.  Power
    iteration converges from any non-degenerate start."""
    rt, mesh = local_runtime(rt, mesh)
    n = rt.num_vertices
    _, static, combine = _resolve(rt, backend, "plus_times", "weight",
                                  "sum", mesh, **backend_opts)

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
    return AppSpec("pagerank", superstep, {"pr": pr0}, static, fin, mesh)


def pagerank(rt: PartitionRuntime, num_iters: int = 20,
             damping: float = 0.85, *, mesh=None,
             options: RunOptions | None = None, backend="scatter",
             init: np.ndarray | None = None, fused=False, tol=None, chunk=8,
             **backend_opts):
    """Returns ((V,) global PageRank, (steps, p) actives) after
    ``num_iters`` supersteps on ``rt.device`` (under ``mesh``, this rank's
    machine on the group's device).

    ``fused=True`` runs the iteration on the fused runner; ``tol``
    additionally stops once ``‖pr_{t+1} − pr_t‖∞ ≤ tol`` (and implies
    fused).
    """
    opts, extra = _options(options, "pagerank", backend, fused, tol, chunk,
                           backend_opts)
    spec = build_pagerank(rt, damping, backend=opts.backend, init=init,
                          mesh=mesh, **opts.backend_opts(), **extra)
    out, actives = _run(spec, num_iters, opts)
    return _result(spec, rt, out), actives


def _sources(rt: PartitionRuntime, source: int) -> np.ndarray:
    """(p, Vmax) float32 distances: 0 at every copy of ``source``, else
    +inf."""
    dist0 = np.full((rt.p, rt.vmax), np.inf, dtype=np.float32)
    dist0[np.nonzero(rt.local_vertex_gid == source)] = 0.0
    return dist0


def _fin_dist(key: str):
    return lambda rt, out: rt.gather_global(out[key].cpu().numpy(),
                                            fill=np.inf)


# ---------------------------------------------------------------------------
# SSSP (sparse: active set shrinks per superstep; (min, +))
# ---------------------------------------------------------------------------

def build_relax(rt: PartitionRuntime, source: int, weighted: bool, *,
                backend="scatter", name: str = "sssp", mesh=None,
                **backend_opts) -> AppSpec:
    rt, mesh = local_runtime(rt, mesh)
    _, static, combine = _resolve(rt, backend, "min_plus",
                                  "weight" if weighted else "unit", "min",
                                  mesh, **backend_opts)

    def superstep(state, sa):
        dist, changed = state["dist"], state["changed"]
        # only vertices that improved last superstep send; +inf is the
        # (min, +) no-message value, so the masked entries fold to the
        # ⊕ identity — exact, because an unchanged vertex's distance was
        # already folded into its neighbors when it last changed
        msg = torch.where(changed, dist, float("inf"))
        cand = combine(sa, msg)               # post-exchange ("min")
        new_dist = torch.minimum(dist, cand)
        new_dist = torch.where(sa["vertex_valid"], new_dist, float("inf"))
        new_changed = new_dist < dist         # vertices updated this step
        return ({"dist": new_dist, "changed": new_changed},
                new_changed.sum(dim=1))

    dist0 = _sources(rt, source)
    dev = static["vertex_valid"].device
    state = {"dist": torch.from_numpy(dist0).to(dev),
             "changed": torch.from_numpy(np.isfinite(dist0)).to(dev)}
    return AppSpec(name, superstep, state, static, _fin_dist("dist"),
                   mesh)


def sssp(rt: PartitionRuntime, source: int = 0, num_iters: int = 30, *,
         mesh=None, options: RunOptions | None = None, backend="scatter",
         fused=False, tol=None, chunk=8, **backend_opts):
    """Returns ((V,) distances from ``source`` by edge weight, (steps, p)
    actives)."""
    opts, extra = _options(options, "sssp", backend, fused, tol, chunk,
                           backend_opts)
    spec = build_relax(rt, source, weighted=True, backend=opts.backend,
                       mesh=mesh, **opts.backend_opts(), **extra)
    out, actives = _run(spec, num_iters, opts)
    return _result(spec, rt, out), actives


# ---------------------------------------------------------------------------
# BFS (sparse: frontier grows/shrinks; (or, and))
# ---------------------------------------------------------------------------

def build_bfs(rt: PartitionRuntime, source: int, *, backend="scatter",
              mesh=None, **backend_opts) -> AppSpec:
    """Layer-synchronous BFS: the frontier (vertices discovered last
    superstep) expands through one (or, and) product per step.  Distances
    equal the (min, +) relaxation with unit weights."""
    rt, mesh = local_runtime(rt, mesh)
    _, static, combine = _resolve(rt, backend, "or_and", "unit", "max",
                                  mesh, **backend_opts)

    def superstep(state, sa):
        dist, step = state["dist"], state["step"]
        vv = sa["vertex_valid"]
        frontier = (vv & (dist == step[:, None])).to(torch.float32)
        reached = combine(sa, frontier)       # post-exchange ("max")
        newly = vv & (reached > 0) & torch.isinf(dist)
        new_dist = torch.where(newly, step[:, None] + 1.0, dist)
        return {"dist": new_dist, "step": step + 1.0}, newly.sum(dim=1)

    dev = static["vertex_valid"].device
    state = {"dist": torch.from_numpy(_sources(rt, source)).to(dev),
             "step": torch.zeros(rt.p, dtype=torch.float32, device=dev)}
    return AppSpec("bfs", superstep, state, static, _fin_dist("dist"),
                   mesh)


def bfs(rt: PartitionRuntime, source: int = 0, num_iters: int = 30, *,
        mesh=None, options: RunOptions | None = None, backend="scatter",
        fused=False, tol=None, chunk=8, **backend_opts):
    """Returns ((V,) hop distances from ``source``, (steps, p) actives)."""
    opts, extra = _options(options, "bfs", backend, fused, tol, chunk,
                           backend_opts)
    spec = build_bfs(rt, source, backend=opts.backend, mesh=mesh,
                     **opts.backend_opts(), **extra)
    out, actives = _run(spec, num_iters, opts)
    return _result(spec, rt, out), actives


# ---------------------------------------------------------------------------
# Weakly-connected components (label propagation: (min, +), zero weights)
# ---------------------------------------------------------------------------

def build_components(rt: PartitionRuntime, *, backend="scatter",
                     mesh=None, **backend_opts) -> AppSpec:
    rt, mesh = local_runtime(rt, mesh)
    _, static, combine = _resolve(rt, backend, "min_plus", "zero", "min",
                                  mesh, **backend_opts)

    def superstep(state, sa):
        lab, changed = state["lab"], state["changed"]
        msg = torch.where(changed, lab, float("inf"))  # as in SSSP
        cand = combine(sa, msg)               # post-exchange min label
        new = torch.minimum(lab, cand)
        new = torch.where(sa["vertex_valid"], new, float("inf"))
        new_changed = new < lab
        return {"lab": new, "changed": new_changed}, new_changed.sum(dim=1)

    vv = static["vertex_valid"]
    gid = torch.from_numpy(rt.local_vertex_gid).to(vv.device)
    # every valid vertex broadcasts its own label once, on superstep 1
    state = {"lab": torch.where(vv, gid.to(torch.float32), float("inf")),
             "changed": vv.clone()}
    return AppSpec("cc", superstep, state, static, _fin_dist("lab"), mesh)


def connected_components(rt: PartitionRuntime, num_iters: int = 30, *,
                         mesh=None, options: RunOptions | None = None,
                         backend="scatter", fused=False, tol=None, chunk=8,
                         **backend_opts):
    """Min-label propagation; returns ((V,) component id per vertex,
    (steps, p) actives)."""
    opts, extra = _options(options, "cc", backend, fused, tol, chunk,
                           backend_opts)
    spec = build_components(rt, backend=opts.backend, mesh=mesh,
                            **opts.backend_opts(), **extra)
    out, actives = _run(spec, num_iters, opts)
    return _result(spec, rt, out), actives


#: app name -> AppSpec builder
APP_BUILDERS = {
    "pagerank": build_pagerank,
    "sssp": lambda rt, **kw: build_relax(rt, kw.pop("source", 0), True,
                                         **kw),
    "bfs": lambda rt, **kw: build_bfs(rt, kw.pop("source", 0), **kw),
    "cc": build_components,
}


def build_app(rt: PartitionRuntime, app: str, *, backend="scatter",
              **kw) -> AppSpec:
    """Build any registered app's :class:`AppSpec` by name."""
    try:
        builder = APP_BUILDERS[app]
    except KeyError:
        raise ValueError(f"unknown BSP app {app!r} "
                         f"(choices: {sorted(APP_BUILDERS)})") from None
    return builder(rt, backend=backend, **kw)


# ---------------------------------------------------------------------------
# Triangle counting (dense): edge-parallel |N(u) ∩ N(v)| with the global
# adjacency replicated to every machine; each machine scans only its own
# edges.  Exact — every triangle is seen by exactly 3 edges, hence the /3.
# ---------------------------------------------------------------------------

def triangle_count(rt: PartitionRuntime, g, *, max_degree: int = 64,
                   chunk: int = 4096) -> int:
    """Exact triangle count over the partitioned edge sets, on
    ``rt.device``.

    Adjacency intersections run against a degree-bounded global neighbor
    table (ELL layout, an equality contraction of ``(chunk, cap, cap)``
    per chunk of edges); edges whose endpoint exceeds the bound take the
    reference's numpy sorted-intersection fallback on the host (hubs are
    few; each edge is still counted exactly once).
    """
    deg = g.degree()
    cap = int(max_degree)
    V = g.num_vertices
    ell = np.full((V, cap), -1, dtype=np.int32)
    over = np.flatnonzero(deg > cap)
    for v in np.flatnonzero((deg > 0) & (deg <= cap)):
        nb = g.neighbors(v)
        ell[v, :len(nb)] = np.sort(nb)
    dev = rt.device
    ell_t = torch.from_numpy(ell).to(dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    host = 0
    for i in range(rt.p):
        m = rt.edge_valid[i]
        gids = rt.local_vertex_gid[i][rt.local_edges[i]]
        both_ok = m & ~np.isin(gids[:, 0], over) & ~np.isin(gids[:, 1], over)
        eg = torch.from_numpy(gids[both_ok].astype(np.int64)).to(dev)
        for s in range(0, len(eg), chunk):
            a = ell_t[eg[s:s + chunk, 0]]            # (chunk, cap)
            b = ell_t[eg[s:s + chunk, 1]]
            hit = (a[:, :, None] == b[:, None, :]) & (a[:, :, None] >= 0)
            count += hit.sum()
        # numpy fallback for hub endpoints
        for e in np.flatnonzero(m & ~both_ok):
            u, v = gids[e]
            host += len(np.intersect1d(g.neighbors(u), g.neighbors(v),
                                       assume_unique=True))
    return (int(count) + host) // 3
