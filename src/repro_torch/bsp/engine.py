"""BSP superstep engine over a leading machine axis.

Every state and static tensor is machine-stacked ``(p, ...)``; a superstep
runs all machines at once (the reference maps one superstep body over the
machines with ``vmap``).  The replica exchange is the only cross-machine
communication: each machine scatters its replicated-vertex values into a
``(r_pad+1,)`` row of a ``(p, r_pad+1)`` buffer, the rows reduce over the
machine dim (the reference's ``psum``/``pmin``/``pmax``), and every machine
gathers the combined value back.

Superstep contract: ``superstep(state, static) -> (state, (p,) active)``.

Under ``mesh=`` (a :class:`~.distributed.Machines` group, the reference's
``shard_map`` over a ``machines`` mesh axis) rank r runs machine r alone:
its state and static tensors are ``(1, ...)``, the exchange all-reduces
the replica buffer across the ranks, and the runners return ``(steps, p)``
actives on every rank.

Two runners iterate that contract, as in the reference:

* :func:`run_bsp`: one superstep at a time, with a host sync on the
  active counts after each.  The oracle.
* :func:`run_bsp_fused` / :func:`make_fused_runner`: chunks of supersteps
  with on-device convergence, the host reading a ``done`` flag only at
  chunk boundaries.  On CUDA each chunk is one captured CUDA graph,
  replayed (the counterpart of the reference's jitted ``lax.scan``).
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def _extreme(dtype: torch.dtype, sign: int):
    """Dtype-safe stand-in for ±∞: the most extreme representable value.

    Floats keep the true infinities; integer dtypes get ``iinfo`` max/min
    (an infinity cast to int32 would wrap).
    """
    if dtype.is_floating_point:
        return float("inf") if sign > 0 else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if sign > 0 else info.min


def exchange(partial: torch.Tensor, rep_slot: torch.Tensor, r_pad: int,
             mode: str = "sum", *, mesh=None) -> torch.Tensor:
    """Synchronize replicated-vertex values across machines.

    partial: (p, Vmax) each machine's local value per local vertex;
    rep_slot: (p, Vmax) replica-table slot, -1 for single-machine vertices.
    Returns (p, Vmax) with replicated entries replaced by the cross-machine
    combination (sum / min / max); non-replicated entries pass through.
    Under ``mesh`` p is 1 and the ``(r_pad+1,)`` buffer is all-reduced
    across the ranks in its own dtype (the reference's ``psum``/``pmin``/
    ``pmax``).
    """
    if mode == "sum":
        ident = 0
    elif mode == "min":
        ident = _extreme(partial.dtype, +1)
    elif mode == "max":
        ident = _extreme(partial.dtype, -1)
    else:
        raise ValueError(mode)
    rep = rep_slot >= 0
    slot = torch.where(rep, rep_slot, r_pad).long()     # pad -> dump slot
    vals = torch.where(rep, partial, ident)
    buf = torch.full((partial.shape[0], r_pad + 1), ident,
                     dtype=partial.dtype, device=partial.device)
    if mode == "sum":
        tot = buf.scatter_add_(1, slot, vals).sum(dim=0, dtype=partial.dtype)
    else:
        red = "amin" if mode == "min" else "amax"
        buf.scatter_reduce_(1, slot, vals, red, include_self=True)
        tot = buf.amin(dim=0) if mode == "min" else buf.amax(dim=0)
    if mesh is not None:
        mesh.all_reduce(tot, mode)
    return torch.where(rep, tot[slot], partial)


def make_step(superstep: Callable, static):
    """One BSP superstep with the static tree bound: state -> (state, act)."""
    return lambda state: superstep(state, static)


def _num_machines(state) -> int:
    """p from a state dict: every leaf is machine-stacked on dim 0."""
    return next(iter(state.values())).shape[0]


def run_bsp(superstep: Callable, state, static, num_steps: int, *,
            mesh=None):
    """Iterate the superstep; returns (final_state, (steps, p) actives).

    One host sync per superstep, on the ``(p,)`` active counts.  Under
    ``mesh`` the state stays this rank's ``(1, ...)``; each rank syncs on
    its own ``(1,)`` count, and the ranks' counts are gathered once, at
    the end, into every rank's ``(steps, p)``.
    """
    step = make_step(superstep, static)
    actives = []
    for _ in range(num_steps):
        state, act = step(state)
        actives.append(act.cpu())
    if not actives:
        # zero steps still contract to a (0, p) actives array
        p = _num_machines(state) if mesh is None else mesh.size
        return state, np.zeros((0, p))
    actives = torch.stack(actives)
    if mesh is not None:
        actives = mesh.all_gather(actives, dim=1)
    return state, actives.numpy()


def _state_residual(old: dict, new: dict) -> torch.Tensor:
    """Global ``‖new − old‖∞`` over every state leaf (cast to float32), a
    0-d device tensor.

    The convergence measure for contraction-map apps (PageRank):
    counter/mask leaves would keep it ≥ 1, which is why the monotone apps
    gate on the active count instead.
    """
    return functools.reduce(torch.maximum, [
        (new[k].float() - old[k].float()).abs().max() for k in old])


class FusedRunner:
    """A reusable fused runner: ``run(state, num_steps)`` (see
    :func:`make_fused_runner`).

    ``graphs`` holds the CUDA graph captured for each chunk length and
    ``replays`` counts its replays.  A kernel wrapper called inside a
    capture launches nothing and counts nothing; each replay launches the
    graph's kernel nodes, which a profiler's trace records.
    """

    def __init__(self, superstep: Callable, static, *, mesh=None,
                 chunk: int = 8, tol: float | None = None):
        self.superstep, self.static = superstep, static
        self.mesh = mesh
        self.chunk = max(1, int(chunk))
        self.tol = tol
        self.graphs: dict = {}       # chunk length -> (graph, t, buf)
        self.replays: dict = {}      # chunk length -> replays
        self._io = None              # static state/done buffers (CUDA)

    def _done_of(self, old, new, act) -> torch.Tensor:
        """The convergence gate; under a mesh every rank reduces its local
        residual (MAX) or active count (SUM) first, so all agree."""
        gate = _state_residual(old, new) if self.tol is not None \
            else act.sum()
        if self.mesh is not None:
            gate = self.mesh.all_reduce(gate.reshape(1),
                                        "max" if self.tol is not None
                                        else "sum")[0]
        return gate <= self.tol if self.tol is not None else gate == 0

    def _chunk(self, state: dict, done: torch.Tensor, length: int):
        """``length`` supersteps, each predicated on ``done``: a step after
        convergence runs but keeps the state, counts no step and records
        zero actives.  Returns ``(state, done, steps run, (length, p)
        actives)``; nothing here syncs with the host."""
        t = torch.zeros((), dtype=torch.int64, device=done.device)
        rows = []
        for _ in range(length):
            new, act = self.superstep(state, self.static)
            live = ~done
            rows.append(torch.where(live, act, torch.zeros_like(act)))
            t = t + live.long()
            done = done | (live & self._done_of(state, new, act))
            state = {k: torch.where(live, new[k], v)
                     for k, v in state.items()}
        return state, done, t, torch.stack(rows)

    def _replay(self, length: int):
        """Replay (capturing first, once) the CUDA graph of a chunk of
        ``length`` supersteps over the static buffers."""
        if length not in self.graphs:
            io = self._io
            dev = io["done"].device
            if not self.graphs:
                # warm up on a side stream, on copies: lazy initialisation
                # (library handles, the kernels' builds) stays out of the
                # capture
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self._chunk({k: v.clone()
                                 for k, v in io["state"].items()},
                                io["done"].clone(), 1)
                torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    state, done, t, buf = self._chunk(io["state"],
                                                      io["done"], length)
                    for k, v in state.items():
                        io["state"][k].copy_(v)
                    io["done"].copy_(done)
            except RuntimeError as e:
                raise RuntimeError(
                    f"fused runner: capturing {length} supersteps as a "
                    f"CUDA graph failed; a superstep must not sync with "
                    f"the host: {e}") from e
            self.graphs[length] = (graph, t, buf)
        graph, t, buf = self.graphs[length]
        graph.replay()
        self.replays[length] = self.replays.get(length, 0) + 1
        return t.clone(), buf.clone()

    def __call__(self, state: dict, num_steps: int):
        p = _num_machines(state) if self.mesh is None else self.mesh.size
        if num_steps <= 0:
            return state, np.zeros((0, p))
        num_chunks = -(-num_steps // self.chunk)
        lengths = [self.chunk] * (num_chunks - 1) \
            + [num_steps - self.chunk * (num_chunks - 1)]
        dev = next(iter(state.values())).device
        # a CUDA graph cannot capture gloo's collectives
        on_cuda = dev.type == "cuda" and self.mesh is None
        done = torch.zeros((), dtype=torch.bool, device=dev)
        if on_cuda:
            self._bind(state)
            done = self._io["done"]
        ts, bufs = [], []
        for length in lengths:
            if on_cuda:
                t, buf = self._replay(length)
            else:
                state, done, t, buf = self._chunk(state, done, length)
            ts.append(t)
            bufs.append(buf)
            if bool(done):          # the one host sync of a chunk
                break
        if on_cuda:
            state = {k: v.clone() for k, v in self._io["state"].items()}
        steps = int(torch.stack(ts).sum())
        acts = torch.cat(bufs).cpu()
        if self.mesh is not None:
            acts = self.mesh.all_gather(acts, dim=1)
        return state, acts.numpy()[:steps]

    def _bind(self, state: dict) -> None:
        """Copy ``state`` into the static buffers the graphs read and
        write (allocated, and the graphs dropped, when the state's layout
        changes) and clear ``done``."""
        io = self._io
        same = io is not None and io["state"].keys() == state.keys() and all(
            io["state"][k].shape == v.shape and io["state"][k].dtype
            == v.dtype and io["state"][k].device == v.device
            for k, v in state.items())
        if not same:
            dev = next(iter(state.values())).device
            self._io = io = {
                "state": {k: torch.empty_like(v) for k, v in state.items()},
                "done": torch.zeros((), dtype=torch.bool, device=dev)}
            self.graphs.clear()
        for k, v in state.items():
            io["state"][k].copy_(v)
        io["done"].fill_(False)


def make_fused_runner(superstep: Callable, static, *, mesh=None,
                      chunk: int = 8, tol: float | None = None
                      ) -> FusedRunner:
    """Build a reusable fused runner: ``run(state, num_steps)``.

    The run takes ``ceil(num_steps / chunk)`` chunks of supersteps, each
    ending on its limit or on convergence:

    * ``tol is None``: converged when the global active count hits 0
      (the monotone apps: BFS/SSSP/CC activity is exactly the changed
      set, and 0 is absorbing);
    * ``tol`` set: converged when ``‖state_{t+1} − state_t‖∞ ≤ tol`` over
      every state leaf in float32 (PageRank power iteration).

    Each step of a chunk is predicated on the device ``done`` flag: it
    writes ``state = where(done, state, new_state)``, counts a step only
    while not done, and then sets ``done`` as the reference's ``done_of``
    does, so every state leaf equals the reference's fused result.  A
    chunk's converged tail still launches its supersteps (the reference's
    ``while_loop`` skips them).  The host reads ``done`` only between
    chunks and runs no further chunk once it is set.  Actives go into a
    ``(chunk, p)`` device buffer per chunk, trimmed to the steps run;
    zero steps give ``(0, p)``.

    On CUDA each chunk is one CUDA graph, captured once per chunk length
    (after a one-step warm-up on a side stream) and replayed; a capture
    that fails raises, and nothing falls back to eager execution.  On the
    CPU the same predicated loop runs eagerly.

    Under ``mesh`` the gate reduces across the ranks (the residual by MAX,
    the active count by SUM), so every rank agrees on ``done``, and every
    rank runs every superstep of a chunk, with its collectives, predicated
    or not.  The chunk runs without capture on any device, since a CUDA
    graph cannot capture gloo's collectives; the host reads ``done`` once
    a chunk, as without a mesh.
    """
    return FusedRunner(superstep, static, mesh=mesh, chunk=chunk, tol=tol)


def run_bsp_fused(superstep: Callable, state, static, num_steps: int,
                  *, mesh=None, chunk: int = 8, tol: float | None = None):
    """One fused BSP run (see :func:`make_fused_runner`).

    Returns ``(final_state, (steps_run, p) actives)``.  With ``tol=None``
    the final state of a min/max-semiring app equals :func:`run_bsp`'s
    after ``num_steps`` supersteps (converged supersteps are state
    fixpoints, BFS's step counter aside) and the actives are the stepwise
    prefix (the stepwise tail is all zeros).
    """
    return make_fused_runner(superstep, static, mesh=mesh, chunk=chunk,
                             tol=tol)(state, num_steps)
