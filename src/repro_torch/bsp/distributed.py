"""The multi-device BSP path: one machine a ``torch.distributed`` rank.

The reference runs its machines as the ``machines`` axis of a device mesh
(``jax.make_mesh((p,), ("machines",))``, then ``shard_map``).  Here rank r
of a p-rank process group runs machine r:

* :class:`Machines` is the 1-D machine group, the counterpart of that
  mesh: the group, this rank, p and the device the rank's tensors live on.
  Every app, ``run_bsp`` and the fused runner take it as ``mesh=`` (a bare
  ``ProcessGroup`` is wrapped by :func:`machine_group`).
* :func:`machine_slice` cuts a :class:`PartitionRuntime` to one machine:
  every per-machine array becomes ``[rank:rank+1]``, so a rank's supersteps
  run on ``(1, ...)`` tensors with the stacked path's bodies unchanged, and
  its Block-ELL layout has its machine's own ELL width.
* The replica ``exchange`` all-reduces its ``(r_pad+1,)`` buffer (SUM, MIN
  or MAX, in the buffer's dtype); :func:`gather_machines` all-gathers the
  ranks' ``(1, ...)`` states into ``(p, ...)`` on every rank.
* :func:`spawn_machines` starts p ranks on one host (``spawn``, a
  ``file://`` rendezvous in a temporary directory) and hands them the graph
  and the edge assignment as an ``.npz``, so no rank partitions again.

Gloo takes CPU and CUDA tensors alike, so p ranks can share one GPU (or
the CPU); each rank holds only its machine's tensors there.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core.graph import Graph
from ..device import resolve_device
from .partition_runtime import PartitionRuntime

#: the per-machine fields of a PartitionRuntime (leading machine axis)
PER_MACHINE = ("local_vertex_gid", "vertex_valid", "local_edges",
               "edge_valid", "edge_weight", "global_degree",
               "weighted_degree", "rep_slot", "verts_per_machine",
               "edges_per_machine")

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Machines:
    """A 1-D machine group: rank ``rank`` of ``size`` runs machine
    ``rank``, its tensors on ``device``.  ``group`` is the
    ``torch.distributed`` process group (``None``: the default group)."""

    group: object
    rank: int
    size: int
    device: torch.device

    def all_reduce(self, t: torch.Tensor, mode: str) -> torch.Tensor:
        """``t`` combined across the ranks (``"sum"``, ``"min"`` or
        ``"max"``), in place; returns ``t``."""
        dist.all_reduce(t, op=_OPS[mode], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t``, concatenated along ``dim`` in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)


def machine_group(group=None, device="cuda") -> Machines:
    """The :class:`Machines` of this rank in ``group`` (a ``ProcessGroup``;
    ``None`` is the default group), its tensors on ``device``; a
    :class:`Machines` passes through."""
    if isinstance(group, Machines):
        return group
    return Machines(group=group, rank=dist.get_rank(group),
                    size=dist.get_world_size(group),
                    device=resolve_device(device))


def machine_slice(rt: PartitionRuntime, rank: int) -> PartitionRuntime:
    """``rt`` cut to machine ``rank``: each per-machine array becomes
    ``[rank:rank+1]`` and ``p`` 1, while ``num_vertices``,
    ``num_replicas``, Vmax and Emax stay the cluster's.  The slice has an
    empty layout cache, so :meth:`PartitionRuntime.local_bsr` builds this
    machine's layout alone, with its own ELL width K."""
    if not 0 <= rank < rt.p:
        raise ValueError(f"machine {rank} out of range for p = {rt.p}")
    return dataclasses.replace(
        rt, p=1, **{f: getattr(rt, f)[rank:rank + 1] for f in PER_MACHINE})


def local_runtime(rt: PartitionRuntime, mesh):
    """``(runtime, machines)`` a superstep of this rank runs on: ``(rt,
    None)`` without a mesh; else this rank's :func:`machine_slice` on the
    group's device.  A group whose size is not ``rt.p`` raises."""
    if mesh is None:
        return rt, None
    mesh = machine_group(mesh, rt.device)
    if mesh.size != rt.p:
        raise ValueError(f"a machine group of {mesh.size} ranks cannot run "
                         f"a runtime of {rt.p} machines: one machine a rank")
    return dataclasses.replace(machine_slice(rt, mesh.rank),
                               device=mesh.device), mesh


def gather_machines(tree: dict, mesh: Machines) -> dict:
    """Each rank's ``(1, ...)`` tensors of ``tree`` all-gathered into
    ``(p, ...)`` on every rank."""
    return {k: mesh.all_gather(v) for k, v in tree.items()}


def run_apps(rt: PartitionRuntime, mesh: Machines, calls) -> list:
    """Run each ``(app, kwargs)`` of ``calls`` on this rank's machine, as a
    :func:`spawn_machines` rank function: ``app`` is ``"pagerank"``,
    ``"sssp"``, ``"bfs"`` or ``"cc"``.  Returns ``[(result, actives)]``,
    the same on every rank."""
    from . import apps
    fns = {"pagerank": apps.pagerank, "sssp": apps.sssp, "bfs": apps.bfs,
           "cc": apps.connected_components}
    return [fns[app](rt, mesh=mesh, **kw) for app, kw in calls]


def _rank_main(rank: int, p: int, workdir: str, fn: Callable, args: tuple,
               backend: str, device: str) -> None:
    """One rank of :func:`spawn_machines`: join the group, pack the
    runtime from the hand-off, run ``fn`` and write its result, or the
    time and traceback of its failure."""
    torch.set_num_threads(1)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if backend == "gloo":
        # every rank lives on this host: loopback needs no name lookup
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{workdir}/rdzv",
                            world_size=p, rank=rank)
    try:
        with np.load(os.path.join(workdir, "machines.npz")) as z:
            g = Graph(indptr=z["indptr"], indices=z["indices"],
                      edge_ids=z["edge_ids"], edges=z["edges"])
            rt = PartitionRuntime.build(g, z["assign"], p, device=dev)
        out = fn(rt, machine_group(None, dev), *args)
        with open(os.path.join(workdir, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(workdir: str, p: int, e: Exception) -> str:
    """What made a spawn fail: the traceback of the rank that failed first
    (a peer's collective then fails too), else the exit of the rank the
    launcher saw."""
    failed = []
    for r in range(p):
        path = os.path.join(workdir, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                when, text = f.read().split("\n", 1)
            failed.append((float(when), r, text))
    if not failed:
        return f"spawn_machines: rank {e.error_index} of {p} failed: {e}"
    failed.sort()
    _, first, text = failed[0]
    then = [r for _, r, _ in failed[1:]]
    return (f"spawn_machines: rank {first} of {p} failed"
            + (f" (then ranks {then})" if then else "") + f":\n{text}")


def spawn_machines(fn: Callable, p: int, *, graph: Graph, assign, args=(),
                   backend: str = "gloo", device="cuda",
                   timeout: float = 600.0) -> list:
    """Run ``fn(rt, machines, *args)`` on p ranks of this host, rank r
    machine r; returns the p results in rank order.

    Each rank is a fresh process (the ``spawn`` start method: a process
    forked under a CUDA context cannot use CUDA) that joins a ``backend``
    group through a ``file://`` rendezvous, loads ``graph`` and ``assign``
    from an ``.npz`` written here, packs the full
    :class:`PartitionRuntime` on the host with its tensors on ``device``,
    and calls ``fn``, which must be picklable (a module-level function) and
    return a picklable result.  ``fn`` passes the runtime and ``machines``
    to the apps (``mesh=machines``), which cut the runtime to the rank's
    machine.  Every rank runs on ``device``; one that finds no CUDA there
    raises.  A rank that raises makes the launcher stop the others and
    raise its traceback; ranks still running after ``timeout`` seconds are
    killed and raise ``TimeoutError``.
    """
    import torch.multiprocessing as mp
    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="machines-") as workdir:
        np.savez(os.path.join(workdir, "machines.npz"),
                 indptr=graph.indptr, indices=graph.indices,
                 edge_ids=graph.edge_ids, edges=graph.edges,
                 assign=np.asarray(assign))
        ctx = mp.start_processes(
            _rank_main, args=(p, workdir, fn, tuple(args), backend,
                              str(device)),
            nprocs=p, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > deadline:
                    alive = [r for r, proc in enumerate(ctx.processes)
                             if proc.is_alive()]
                    raise TimeoutError(f"spawn_machines: ranks {alive} of "
                                       f"{p} still running after "
                                       f"{timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(_first_failure(workdir, p, e)) from None
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        out = []
        for r in range(p):
            with open(os.path.join(workdir, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
