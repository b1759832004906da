"""Checkpoint manager: atomic, keep-last-k, bitwise-resumable.

Ported from ``src/repro/train/checkpoint.py``, with its on-disk layout:
``<dir>/step_<n:010d>/arrays.npz`` + ``manifest.json`` (``step``, the
caller's ``extra``, the sorted ``keys``), written to a temporary directory
and renamed (atomic on POSIX), so a killed writer never leaves a half
checkpoint visible; only the last ``keep`` steps stay.

The state is a nested dict whose leaves are tensors or modules.  A key is
the ``/``-joined path of dict keys; a module contributes one component a
parameter, its ``named_parameters`` name (``params/layers.0.mixer.wq``).
A bfloat16 leaf is stored as its 16-bit patterns (numpy dtype ``V2``, the
bytes the reference's ``ml_dtypes`` array writes), so this module needs
no ``ml_dtypes``.

Elastic restore, ``restore(..., shardings=)``, puts each leaf onto a
mesh, which may differ from the one that saved it (the reference's
node-failure / resize path).  ``shardings`` mirrors ``template``: a
tensor leaf's entry is ``(device_mesh, spec)``, and a module's a dict
``{parameter name: (device_mesh, spec)}``
(``sharding.specs.param_shardings`` gives one for a ``Decoder``, the
reference's stacked ``blocks/...`` rules mapped onto the port's per-layer
tensors); a leaf without an entry is restored as without ``shardings``.
A spec is a tuple with one entry a dimension, as
``sharding.specs.param_specs`` gives it: ``None``, a mesh dim's name, or a
tuple of names, major first.  The leaf comes back as a ``DTensor`` on
that mesh, ``Shard(dim)`` on every mesh dim named for ``dim`` and
``Replicate()`` on the others, built by ``DTensor.from_local`` from this
rank's slice of the stored array, so no rank puts another rank's bytes on
its device; a module's entry comes back as a dict of its parameters'
``DTensor`` objects, the module left as it was.  :func:`gather_leaf`
gathers such a leaf whole on every rank.  Deliberate differences from the
reference: a ``DTensor`` stands for its ``NamedSharding``, and the mesh's
ranks are those of a ``torch.distributed`` group (gloo, so several may
share one card), not one device each; a tuple of mesh dims on one tensor
dim must list them in the mesh's order, the order in which ``DTensor``
applies them (the reference takes any order); and a leaf is gathered with
:func:`gather_leaf`, not ``DTensor.full_tensor()``, which on a gloo mesh
of CUDA tensors ends its process with SIGSEGV (torch 2.11 on the H100's
machine: its functional all-gather; ``torch.distributed.all_gather``
works there).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix=()):
    """(path, tensor) pairs of a nested state, dict keys in sorted order
    (as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + (name,), p
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(a)).to(like.dtype)
    return t.to(device)


def _sharded(arr: np.ndarray, like: torch.Tensor, mesh, spec, key: str):
    """The ``DTensor`` of the stored ``arr`` on ``mesh`` under ``spec``,
    from this rank's slice of it (the module docstring)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    spec = tuple(spec) + (None,) * (arr.ndim - len(spec))
    if len(spec) != arr.ndim:
        raise ValueError(f"checkpoint {key}: spec {spec} for {arr.ndim} dims")
    placements = [Replicate()] * mesh.ndim
    index = []
    for dim, axes in enumerate(spec):
        axes = () if axes is None else (axes,) if isinstance(axes, str) \
            else tuple(axes)
        if any(a not in names for a in axes):
            raise ValueError(f"checkpoint {key}: spec {spec} names axes "
                             f"missing from the mesh's {names}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims) or any(placements[m] != Replicate()
                                       for m in dims):
            raise ValueError(f"checkpoint {key}: spec {spec} is not in the "
                             f"mesh's axis order {names}, or splits two "
                             f"dims over one mesh dim")
        at, pieces = 0, 1
        for m in dims:
            placements[m] = Shard(dim)
            at = at * mesh.size(m) + mesh.get_local_rank(m)
            pieces *= mesh.size(m)
        if arr.shape[dim] % pieces:
            raise ValueError(f"checkpoint {key}: dim {dim} of {arr.shape} "
                             f"does not split into {pieces}")
        n = arr.shape[dim] // pieces
        index.append(slice(at * n, (at + 1) * n))
    local = _to_tensor(np.ascontiguousarray(arr[tuple(index)]), like,
                       torch.device(mesh.device_type))
    return DTensor.from_local(local, mesh, placements, run_check=False)


def gather_leaf(t) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` restored with ``shardings=``, on
    every rank of its mesh (a plain tensor passes through): this rank's
    shard all-gathered over each mesh dim that splits it, the innermost
    first, with ``torch.distributed.all_gather``.  Every rank of the mesh
    must call it."""
    from torch.distributed.tensor import DTensor, Shard
    from ..ranks import all_gather_dims
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    return all_gather_dims(t.to_local(), [
        (mesh.get_group(m), t.placements[m].dim)
        for m in reversed(range(mesh.ndim))
        if isinstance(t.placements[m], Shard)])


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write ----------------------------------------------------------
    def save(self, step: int, state: dict, extra: dict | None = None):
        """state: nested dict of tensors and modules; extra:
        json-serializable metadata."""
        arrays = {"/".join(path): _to_numpy(t) for path, t in _leaves(state)}
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            manifest = {"step": int(step), "extra": extra or {},
                        "keys": sorted(arrays)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.directory, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic publish
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- read -----------------------------------------------------------
    def all_steps(self):
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_"))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: dict, step: int | None = None, device=None,
                shardings=None):
        """``(state, step, extra)`` of checkpoint ``step`` (the latest by
        default).  ``state`` mirrors ``template``: each tensor leaf a new
        tensor of the template's shape and dtype on ``device`` (the
        template leaf's device by default); a module is restored into, its
        parameters overwritten in place, and returned.  With
        ``shardings``, the leaves it names come back as ``DTensor`` objects
        (the module docstring); every rank of their meshes must call."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            def load(path, like, sharding=None):
                key = "/".join(path)
                arr = data[key]
                if arr.shape != tuple(like.shape):
                    raise ValueError(f"checkpoint {key}: shape {arr.shape}, "
                                     f"template {tuple(like.shape)}")
                if sharding is not None:
                    return _sharded(arr, like, *sharding, key)
                return _to_tensor(arr, like, device or like.device)

            def build(tree, prefix=(), sh=None):
                if isinstance(tree, nn.Module):
                    if sh is not None:
                        return {path[-1]: load(path, p, sh.get(path[-1]))
                                for path, p in _leaves(tree, prefix)}
                    with torch.no_grad():
                        for path, p in _leaves(tree, prefix):
                            p.copy_(load(path, p))
                    return tree
                if isinstance(tree, dict):
                    return {k: build(v, prefix + (str(k),),
                                     None if sh is None else sh.get(k))
                            for k, v in tree.items()}
                return load(prefix, tree, sh)
            state = build(template, sh=shardings)
        return state, manifest["step"], manifest["extra"]
