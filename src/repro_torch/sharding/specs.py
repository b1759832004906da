"""Name-based split rules: parameters, optimizer state, inputs, caches.

A copy of the reference's ``sharding/specs.py`` over the port's parameter
names.  Mesh axes: ``("pod", "data", "model")`` multi-pod or ``("data",
"model")`` single-pod.  Tensor parallelism lives on ``model``; batch DP on
``("pod", "data")``; ZeRO-split optimizer moments additionally use
``data``; FSDP (parameters split over ``data``) is opt-in.

Every rule is divisibility-guarded: if the preferred dimension does not
divide the mesh axis (40 heads on model = 16), the next preference is
tried, ending at replication.

A spec is a tuple with one entry per dimension of its leaf: an axis name,
a tuple of axis names, or ``None`` (``tuple(PartitionSpec)`` of the
reference, padded with ``None`` to the leaf's rank).  Parameter and moment
specs are keyed by the reference's leaf path (``models.reference_path``):
a ``blocks/...`` leaf is the reference's stack of the port's per-layer
tensors on a leading ``n_super`` axis.  A mesh is anything with a
``shape`` dict of axis sizes (``launch.mesh.MeshShape``).
"""
from __future__ import annotations

import math

from ..models import meta_params, reference_path


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def split_of(mesh, spec) -> int:
    """How many pieces ``spec`` cuts its leaf into on ``mesh``."""
    return math.prod(_axis_size(mesh, a) for a in spec if a is not None)


def data_axes(mesh) -> tuple:
    """The data-parallel axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def logical_batch_spec(mesh, batch: int) -> tuple:
    """Split the batch over as many DP axes as divide it (long-context
    B = 1 falls back to replication).  One axis is given by its name, as
    ``PartitionSpec`` normalises a 1-tuple."""
    axes = []
    remaining = batch
    for a in data_axes(mesh):
        if remaining % mesh.shape[a] == 0:
            axes.append(a)
            remaining //= mesh.shape[a]
    if not axes:
        return (None,)
    return (axes[0] if len(axes) == 1 else tuple(axes),)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

# name -> ordered dim preferences for the 'model' axis, indexing the
# UNSTACKED layout: the port's per-layer tensor (the reference shifts them
# past its stacked n_super dim).  Heads first, then the contracting
# d_model; never head_dim.
_RULES = {
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0),   # (d_model, heads, head_dim)
    "wo": (0, 2),                               # (heads, head_dim, d_model)
    "w_gate": (-1, 0), "w_up": (-1, 0),         # (d_model, d_ff)
    "w_down": (0, -1),                          # (d_ff, d_model)
    "router": (-1,),
    "in_proj": (1, 0), "out_proj": (0, 1), "conv_w": (), "conv_b": (),
    "w_dkv": (1,), "w_uk": (1, 0), "w_uv": (1, 0), "w_kr": (),
    "w_dq": (1,), "w_uq": (1, 0),
    "embed": (0, 1), "unembed": (1, 0),
}
_MOE_RULES = {  # TP within an expert: split f, tokens never cross devices
    "w_gate": (-1, 1), "w_up": (-1, 1), "w_down": (1, -1), "router": (-1,),
}
#: leaves that are never split
_REPLICATED = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "kv_norm",
               "out_norm", "a_log", "dt_bias", "d_skip", "conv_b", "conv_w")


def _spec_for(name: str, shape, mesh, *, moe: bool, fsdp: bool) -> tuple:
    """The spec of one unstacked leaf of ``shape``."""
    ndim = len(shape)
    rules = _MOE_RULES if (moe and name in _MOE_RULES) else _RULES
    spec: list = [None] * ndim
    m = mesh.shape.get("model", 1)
    for pref in rules.get(name, ()):
        d = pref + ndim if pref < 0 else pref
        if 0 <= d < ndim and shape[d] % m == 0 and m > 1:
            spec[d] = "model"
            break
    if fsdp:
        # split the largest still-unsplit dim over 'data' (parameter FSDP)
        dp = mesh.shape.get("data", 1)
        if dp > 1:
            cands = [(shape[d], d) for d in range(ndim)
                     if spec[d] is None and shape[d] % dp == 0]
            if cands:
                spec[max(cands)[1]] = "data"
    return tuple(spec)


def param_shapes(cfg) -> dict:
    """``{path: (shape, dtype)}`` of the reference's parameter leaves, in
    its leaf order, from the port's parameters on the ``meta`` device
    (nothing is allocated): a ``blocks/...`` leaf stacks its ``n_super``
    per-layer tensors."""
    groups: dict = {}
    for name, p in meta_params(cfg).named_parameters():
        path, _ = reference_path(cfg, name)
        n, shape, dtype = groups.get(path, (0, tuple(p.shape), p.dtype))
        groups[path] = (n + 1, shape, dtype)
    return {path: ((n, *shape) if path.startswith("blocks/") else shape,
                   dtype)
            for path, (n, shape, dtype) in sorted(groups.items())}


def param_specs(cfg, mesh, *, fsdp: bool = False, shapes=None) -> dict:
    """``{path: spec}`` of every parameter leaf (``param_shapes``' keys).
    The rule is applied to the port's per-layer shape; a stacked leaf's
    ``n_super`` dim is never split."""
    shapes = param_shapes(cfg) if shapes is None else shapes
    out = {}
    for path, (shape, _) in shapes.items():
        names = path.split("/")
        name = names[-1]
        stacked = names[0] == "blocks"
        unstacked = shape[1:] if stacked else shape
        if name in _REPLICATED:
            spec = (None,) * len(unstacked)
        else:
            moe = "ffn" in names and (name == "router" or (
                len(unstacked) == 3 and name in ("w_gate", "w_up",
                                                 "w_down")))
            spec = _spec_for(name, unstacked, mesh, moe=moe, fsdp=fsdp)
        out[path] = ((None,) + spec) if stacked else spec
    return out


def param_shardings(cfg, device_mesh) -> dict:
    """``{parameter name: (device_mesh, spec)}`` for every parameter of
    the port's ``Decoder`` (``named_parameters`` names): the rules of
    :func:`param_specs` on a mesh of ``device_mesh``'s dim names and sizes,
    a stacked leaf's spec without its ``n_super`` dim.  The ``shardings=``
    entry of ``CheckpointManager.restore`` for a ``Decoder``."""
    from ..launch.mesh import make_mesh
    specs = param_specs(cfg, make_mesh(device_mesh.shape,
                                       device_mesh.mesh_dim_names))
    out = {}
    for name, _ in meta_params(cfg).named_parameters():
        path, _ = reference_path(cfg, name)
        spec = specs[path]
        out[name] = (device_mesh,
                     spec[1:] if path.startswith("blocks/") else spec)
    return out


def opt_state_specs(pspecs: dict, shapes: dict, mesh) -> dict:
    """ZeRO: each moment gets its parameter's spec plus ``data`` on the
    largest free dim of the (stacked) leaf, its ``n_super`` dim included."""
    dp = mesh.shape.get("data", 1)

    def widen(spec: tuple, shape) -> tuple:
        if dp <= 1 or "data" in spec:     # FSDP parameters: already split
            return spec
        parts = list(spec)
        cands = [(shape[d], d) for d in range(len(shape))
                 if parts[d] is None and shape[d] % dp == 0 and shape[d] > 1]
        if cands:
            parts[max(cands)[1]] = "data"
        return tuple(parts)

    return {path: widen(spec, shapes[path][0])
            for path, spec in pspecs.items()}


# ---------------------------------------------------------------------------
# inputs & caches
# ---------------------------------------------------------------------------

def input_specs_for(cfg, mesh, batch: int, kind: str) -> dict:
    """Specs of the train/serve step inputs (tokens or embeddings,
    labels, cache lengths)."""
    b = logical_batch_spec(mesh, batch)[0]
    x = (b, None) if cfg.input_mode == "tokens" else (b, None, None)
    if kind == "train":
        return {"inputs": x, "labels": (b, None)}
    if kind == "prefill":
        return {"inputs": x}
    return {"inputs": x, "cache_len": (b,)}


def cache_specs(cfg, mesh, batch: int, max_len: int) -> dict:
    """Specs of the ``init_cache`` tree.  The batch splits over DP axes
    where it divides; KV heads split over ``model`` where they divide,
    otherwise the cache's sequence axis does."""
    b = logical_batch_spec(mesh, batch)[0]
    m = mesh.shape.get("model", 1)
    kv_shard = "model" if (cfg.num_kv_heads % m == 0 and m > 1) else None
    seq = "model" if (kv_shard is None and max_len % m == 0 and m > 1) \
        else None
    out = {}
    for pos in range(cfg.pattern_period):
        if cfg.layer_kind(pos) == "attn":
            if cfg.attn_type == "mla":
                out[f"pos{pos}"] = {"latent": (None, b, seq, None),
                                    "k_rope": (None, b, seq, None)}
            else:
                out[f"pos{pos}"] = {"k": (None, b, seq, kv_shard, None),
                                    "v": (None, b, seq, kv_shard, None)}
        else:
            h_shard = "model" if (cfg.ssm_heads % m == 0 and m > 1) else None
            out[f"pos{pos}"] = {"conv": (None, b, None, None),
                                "ssm": (None, b, h_shard, None, None)}
    return out
