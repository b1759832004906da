"""Start p ranks of a ``torch.distributed`` group on this host.

:func:`spawn_ranks` is the launcher behind every multi-rank path of the
port: the BSP machines (``bsp.spawn_machines``), expert-parallel MoE
(``models.moe_shardmap``) and elastic restore
(``train.CheckpointManager.restore(..., shardings=)``).  Each rank is a
fresh process (the ``spawn`` start method: a process forked under a CUDA
context cannot use CUDA) that joins the group through a ``file://``
rendezvous in a temporary directory.  With gloo, the ranks may share one
GPU (or the CPU): gloo takes CPU and CUDA tensors alike, where NCCL
refuses two ranks on one device.

:func:`all_gather_dims` joins a tensor split over several process groups
(the mesh dims of ``gather_tokens`` and ``train.gather_leaf``).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from .device import resolve_device


def all_gather_dims(t: torch.Tensor, splits) -> torch.Tensor:
    """The whole tensor of this rank's block ``t``, on every rank: for
    each ``(group, dim)`` of ``splits``, innermost mesh dim first, the
    blocks of ``group``'s ranks all-gathered and joined on tensor dim
    ``dim`` in group-rank order.  A tensor dim split over several mesh dims
    is thus laid out major mesh dim outer, as JAX lays out a tuple of axes.
    Every rank of every group must call it.  Not differentiable."""
    for group, dim in splits:
        t = t.contiguous()
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        t = torch.cat(parts, dim=dim)
    return t


def _rank_main(rank: int, p: int, workdir: str, fn: Callable, args: tuple,
               backend: str, device: str) -> None:
    """One rank of :func:`spawn_ranks`: join the group, run ``fn`` and
    write its result, or the time and traceback of its failure."""
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
        out = fn(*args)
        with open(os.path.join(workdir, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(workdir: str, p: int, e: Exception, name: str) -> str:
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
        return f"{name}: rank {e.error_index} of {p} failed: {e}"
    failed.sort()
    _, first, text = failed[0]
    then = [r for _, r, _ in failed[1:]]
    return (f"{name}: rank {first} of {p} failed"
            + (f" (then ranks {then})" if then else "") + f":\n{text}")


def spawn_ranks(fn: Callable, p: int, *, args=(), backend: str = "gloo",
                device="cuda", timeout: float = 600.0,
                name: str = "spawn_ranks") -> list:
    """Run ``fn(*args)`` on p ranks of this host; returns the p results in
    rank order.

    Each rank joins a ``backend`` group of p ranks (rank r of the default
    group), sets ``device`` as its current CUDA device where it names an
    index, and calls ``fn``, which must be picklable (a module-level
    function) and return a picklable result.  Every rank runs on
    ``device``; one that finds no CUDA there raises.  A rank that raises
    makes the launcher stop the others and raise its traceback; ranks
    still running after ``timeout`` seconds are killed and raise
    ``TimeoutError``.  ``name`` heads the messages of both.
    """
    import torch.multiprocessing as mp
    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="ranks-") as workdir:
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
                    raise TimeoutError(f"{name}: ranks {alive} of {p} still "
                                       f"running after {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(_first_failure(workdir, p, e, name)) from None
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
