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

Left out: the reference's ``restore(..., shardings=)``, which puts leaves
onto another mesh for elastic restore (its own test fails in this
repository); here ``restore`` places every leaf on one device.
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

    def restore(self, template: dict, step: int | None = None, device=None):
        """``(state, step, extra)`` of checkpoint ``step`` (the latest by
        default).  ``state`` mirrors ``template``: each tensor leaf a new
        tensor of the template's shape and dtype on ``device`` (the
        template leaf's device by default); a module is restored into, its
        parameters overwritten in place, and returned."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            def load(path, like):
                key = "/".join(path)
                arr = data[key]
                if arr.shape != tuple(like.shape):
                    raise ValueError(f"checkpoint {key}: shape {arr.shape}, "
                                     f"template {tuple(like.shape)}")
                return _to_tensor(arr, like, device or like.device)

            def build(tree, prefix=()):
                if isinstance(tree, nn.Module):
                    with torch.no_grad():
                        for path, p in _leaves(tree, prefix):
                            p.copy_(load(path, p))
                    return tree
                if isinstance(tree, dict):
                    return {k: build(v, prefix + (str(k),))
                            for k, v in tree.items()}
                return load(prefix, tree)
            state = build(template)
        return state, manifest["step"], manifest["extra"]
