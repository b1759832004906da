"""Fit check of every (arch × shape × mesh) cell, the counterpart of the
reference's ``launch/dryrun.py``.

The reference lowers and compiles each cell on a 512-device host mesh to
prove its sharding and read its per-device peak.  The port has no compiler
to prove a sharding on; its question is whether a cell fits a device.  For
each cell it takes the leaf shapes from the ``meta`` device (nothing is
allocated), divides each leaf's bytes by its split under the reference's
rules (``sharding/specs.py``), and adds up, per device:

* parameters (FSDP over ``data`` above 12e9 of them, as the reference);
* train: float32 gradients split as the parameters, and the two float32
  AdamW moments (plus the step counter) split by the ZeRO rule;
* serve: the cache of ``init_cache``;
* the inputs;
* activations, an estimate (``activation_bytes`` states its formula).

The total is held against the device's memory: the card's
``total_memory`` where CUDA is present, else the H100's 80 GB.  ``--mesh
one`` is a single card (``data`` = ``model`` = 1) at one data shard's
share of the batch, ``global_batch`` over the pod mesh's data axes as
``logical_batch_spec`` splits it.

``--bsp`` runs every (BSP app × edge-kernel backend) superstep once over
8 machines, one ``torch.distributed`` gloo rank each
(``bsp/distributed.py::spawn_machines``), at the reference's graph and
cluster, and records per rank its bytes and the bytes the exchange
all-reduces in the superstep (the reference parses them from the
compiled HLO).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh one
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --bsp --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import torch

from ..bsp.distributed import Machines
from ..configs import ARCHS, SHAPES, cells, get_config
from ..models import init_cache
from ..sharding import (cache_specs, input_specs_for, logical_batch_spec,
                        opt_state_specs, param_shapes, param_specs, split_of)
from .mesh import MESH_NAMES, MESHES, make_production_mesh, one_card

#: the H100's memory, where no card can be asked (NVIDIA H100 80GB HBM3)
H100_BYTES = 80e9
#: above this many parameters a cell splits them over ``data`` (FSDP)
FSDP_PARAMS = 12e9


def device_memory() -> float:
    """Bytes of the device a cell must fit: the card's ``total_memory``
    where CUDA is present, else the H100's 80 GB."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return H100_BYTES


def shape_of(shape) -> dict:
    """A ``SHAPES`` entry by name, or a dict with its keys (``seq_len``,
    ``global_batch``, ``kind``) as it is."""
    return SHAPES[shape] if isinstance(shape, str) else dict(shape)


# ---------------------------------------------------------------------------
# input stand-ins (shapes and dtypes, nothing allocated)
# ---------------------------------------------------------------------------

def input_specs(cfg, shape, batch: int | None = None) -> dict:
    """``{name: (shape, dtype)}`` of every model input of this cell, as the
    reference's ``input_specs`` gives them (``batch`` in place of the
    global batch where given)."""
    sh = shape_of(shape)
    B = sh["global_batch"] if batch is None else batch
    S, kind = sh["seq_len"], sh["kind"]
    s_in = S if kind != "decode" else 1
    if cfg.input_mode == "tokens":
        x = ((B, s_in), torch.int32)
    else:
        x = ((B, s_in, cfg.d_model), torch.bfloat16)
    if kind == "train":
        return {"inputs": x, "labels": ((B, S), torch.int32)}
    if kind == "prefill":
        return {"inputs": x}
    return {"inputs": x, "cache_len": ((B,), torch.int32)}


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _split_bytes(shape, dtype, mesh, spec) -> int:
    """A leaf's bytes on one device under ``spec`` (the rules split only
    dimensions that divide)."""
    return _nbytes(shape, dtype) // split_of(mesh, spec)


# ---------------------------------------------------------------------------
# activations (an estimate)
# ---------------------------------------------------------------------------

def _sublayer_width(cfg, pos: int) -> float:
    """Elements a token holds in the widest intermediate of sub-layer
    ``pos``: its mixer's or its FFN's, whichever is wider (they run one
    after the other)."""
    d, hd = cfg.d_model, cfg.head_dim_
    if cfg.layer_kind(pos) == "ssm":
        gs = 2 * cfg.ssm_groups * cfg.ssm_state
        # in_proj's output, the convolved channels, the scan's output
        mixer = (2 * cfg.d_inner + gs + cfg.ssm_heads) \
            + (cfg.d_inner + gs) + cfg.d_inner
    elif cfg.attn_type == "mla":
        H, r, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
        # q, the absorbed query, the latent output, and the values
        mixer = H * (cfg.qk_nope_dim + dr) + H * (r + dr) + H * r \
            + H * cfg.v_head_dim
    else:
        # q, k, v and the attention's output
        mixer = (2 * cfg.num_heads_padded + 2 * cfg.num_kv_heads) * hd
    if cfg.d_ff == 0:
        ffn = 0
    elif cfg.layer_is_moe(pos):
        # the dispatched slots (E·cap ≈ factor·K·T): input, gate, up, hidden
        ffn = cfg.capacity_factor * cfg.experts_per_token \
            * (d + 3 * cfg.d_ff)
    else:
        ffn = 3 * cfg.d_ff                   # gate, up, their product
    return max(mixer, ffn)


def activation_bytes(cfg, kind: str, batch: int, seq_len: int,
                     model: int = 1) -> float:
    """Activation bytes of one step of ``batch`` sequences on one device,
    an estimate.

    With T the tokens of the step (B·S, or B for a decode step), d the
    model width, w the widest per-token intermediate of a sub-layer
    (``_sublayer_width``), V the vocabulary and a the model's dtype bytes,
    w and V divided by the ``model`` axis (tensor parallelism splits heads,
    ``d_ff`` and the vocabulary; the residual stream stays whole):

    * serve (no autograd graph; one sub-layer live at a time):
      ``T·(4·d + w)·a + T·V·a`` (the residual stream and its temporaries,
      the widest intermediate, the logits);
    * train (remat: each super-block saves its input, one super-block at a
      time recomputes with its graph): ``n_super·T·d·a + period·T·(6·d +
      2·w)·a + T·V·(a + 8)`` (the float32 logits and their gradient).
    """
    a = getattr(torch, cfg.dtype).itemsize
    d, V = cfg.d_model, cfg.vocab_size / model
    T = batch * (1 if kind == "decode" else seq_len)
    period = cfg.pattern_period
    w = max(_sublayer_width(cfg, p) for p in range(period)) / model
    if kind != "train":
        return T * (4 * d + w) * a + T * V * a
    n_super = cfg.num_layers // period
    return n_super * T * d * a + period * T * (6 * d + 2 * w) * a \
        + T * V * (a + 8)


# ---------------------------------------------------------------------------
# the fit check
# ---------------------------------------------------------------------------

def fit(cfg, shape, mesh, batch: int | None = None, *,
        memory: float | None = None) -> dict:
    """Bytes per device of one cell on ``mesh``, by part, against the
    device's memory (``memory``; default ``device_memory()``).

    ``shape`` is a ``SHAPES`` name or a dict of its keys; ``batch`` (default
    the shape's global batch) is split over the mesh's data axes as
    ``logical_batch_spec`` splits it.  Parameters split over ``data`` too
    (FSDP) above 12e9 of them, the reference's rule."""
    sh = shape_of(shape)
    B = sh["global_batch"] if batch is None else batch
    S, kind = sh["seq_len"], sh["kind"]
    shapes = param_shapes(cfg)
    n_params = sum(math.prod(s) for s, _ in shapes.values())
    fsdp = n_params > FSDP_PARAMS
    pspecs = param_specs(cfg, mesh, fsdp=fsdp, shapes=shapes)
    parts = {"params": sum(_split_bytes(s, dt, mesh, pspecs[k])
                           for k, (s, dt) in shapes.items())}
    if kind == "train":
        parts["grads"] = sum(_split_bytes(s, torch.float32, mesh, pspecs[k])
                             for k, (s, _) in shapes.items())
        mspecs = opt_state_specs(pspecs, shapes, mesh)
        parts["moments"] = 2 * sum(
            _split_bytes(s, torch.float32, mesh, mspecs[k])
            for k, (s, _) in shapes.items()) + torch.int32.itemsize
    else:
        cache = init_cache(cfg, B, S, device="meta")
        cspecs = cache_specs(cfg, mesh, B, S)
        parts["cache"] = sum(
            _split_bytes(t.shape, t.dtype, mesh, cspecs[pos][leaf])
            for pos, leaves in cache.items() for leaf, t in leaves.items())
    ispecs = input_specs_for(cfg, mesh, B, kind)
    parts["inputs"] = sum(_split_bytes(s, dt, mesh, ispecs[k])
                          for k, (s, dt) in input_specs(cfg, sh, B).items())
    b_dev = B // split_of(mesh, logical_batch_spec(mesh, B))
    parts["activations"] = int(activation_bytes(
        cfg, kind, b_dev, S, mesh.shape.get("model", 1)))
    total = sum(parts.values())
    memory = device_memory() if memory is None else memory
    return {"arch": cfg.name, "kind": kind, "seq_len": S, "batch": B,
            "batch_per_device": b_dev, "num_layers": cfg.num_layers,
            "mesh": dict(mesh.shape), "fsdp": fsdp, "params": n_params,
            "bytes": parts, "total_bytes": total, "memory_bytes": memory,
            "fits": total <= memory}


def one_card_batch(shape, multi_pod: bool = False) -> int:
    """One data shard's share of a shape's global batch on the production
    mesh (``pod16x16``, or ``pod2x16x16`` with ``multi_pod``)."""
    B = shape_of(shape)["global_batch"]
    pod = make_production_mesh(multi_pod=multi_pod)
    return B // split_of(pod, logical_batch_spec(pod, B))


def max_layers(cfg, shape, batch: int, *, memory: float | None = None,
               mesh=None) -> int:
    """The deepest multiple of ``pattern_period`` (at most ``num_layers``)
    at which ``batch`` sequences of ``shape`` fit one device of ``mesh``
    (default one card); 0 if not even one period fits."""
    mesh = one_card() if mesh is None else mesh
    period = cfg.pattern_period

    def fits(n_super: int) -> bool:
        c = dataclasses.replace(cfg, num_layers=n_super * period)
        return fit(c, shape, mesh, batch, memory=memory)["fits"]
    lo, hi = 0, cfg.num_layers // period       # fits(lo) holds or lo == 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo * period


# ---------------------------------------------------------------------------
# the model cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape: str, mesh_name: str) -> dict:
    """The fit record of one (arch × shape) cell on ``mesh_name`` (``pod``,
    ``multipod`` or ``one``)."""
    cfg = get_config(arch)
    mesh = MESHES[mesh_name]()
    batch = one_card_batch(shape) if mesh_name == "one" else None
    rec = fit(cfg, shape, mesh, batch)
    rec.update(arch=arch, shape=shape, mesh=MESH_NAMES[mesh_name],
               devices=mesh.devices)
    return rec


def _done(out: str, keys) -> set:
    done = set()
    if out and os.path.exists(out):
        with open(out) as f:
            for line in f:
                r = json.loads(line)
                if "error" not in r and all(k in r for k in keys):
                    done.add(tuple(r[k] for k in keys))
    return done


def run_cells(todo, mesh_names, out: str | None = None,
              skip_done: bool = False) -> list:
    """The fit record of each (arch, shape) of ``todo`` on each mesh,
    printed as ``OK``/``FAIL`` with GiB per device and appended to ``out``
    (jsonl) where given; cells already in ``out`` are skipped with
    ``skip_done``."""
    done = _done(out, ("arch", "shape", "mesh")) if skip_done else set()
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    recs = []
    for arch, shape in todo:
        for m in mesh_names:
            if (arch, shape, MESH_NAMES[m]) in done:
                continue
            rec = run_cell(arch, shape, m)
            parts = ", ".join(f"{k} {v / 2**30:.2f}"
                              for k, v in rec["bytes"].items())
            print(f"{'OK  ' if rec['fits'] else 'FAIL'} {arch} × {shape} × "
                  f"{rec['mesh']} (batch {rec['batch_per_device']}/device): "
                  f"{rec['total_bytes'] / 2**30:.2f} GiB/device of "
                  f"{rec['memory_bytes'] / 2**30:.2f} ({parts})", flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# --bsp: every (app × backend) superstep over 8 gloo ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CountingMachines(Machines):
    """A :class:`Machines` group that counts its collectives: ``counts``
    maps ``"all_reduce"``/``"all_gather"`` to (calls, bytes)."""

    counts: dict = dataclasses.field(default_factory=dict)

    def _add(self, what: str, t: torch.Tensor) -> None:
        calls, nbytes = self.counts.get(what, (0, 0))
        self.counts[what] = (calls + 1, nbytes + t.numel() * t.element_size())

    def all_reduce(self, t, mode):
        self._add("all_reduce", t)
        return super().all_reduce(t, mode)

    def all_gather(self, t, dim=0):
        self._add("all_gather", t)
        return super().all_gather(t, dim)


def _tensor_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values()
               if isinstance(v, torch.Tensor))


def bsp_rank(rt, mesh, todo) -> list:
    """One rank of ``--bsp`` (a ``spawn_machines`` rank function): for each
    (app, backend) of ``todo``, build the app on this rank's machine, run
    one superstep, and record the bytes its exchange all-reduced, the
    rank's tensors and peak memory, the ``pallas`` kernel's launches
    (``bsr_spmv_rows``), and the global result after the superstep
    (gathered)."""
    from ..bsp import build_app, gather_machines
    from ..kernels.bsr_spmv import bsr_spmv_rows
    counting = CountingMachines(mesh.group, mesh.rank, mesh.size, mesh.device)
    on_cuda = mesh.device.type == "cuda"
    out = []
    for app, backend in todo:
        if on_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        opts = {"block_size": 32} if backend == "pallas" else {}
        spec = build_app(rt, app, backend=backend, mesh=counting, **opts)
        counting.counts.clear()
        bsr_spmv_rows.launches = 0
        state, _ = spec.superstep(spec.state, spec.static)
        if on_cuda:
            torch.cuda.synchronize()
        launches = bsr_spmv_rows.launches
        calls, nbytes = counting.counts.get("all_reduce", (0, 0))
        result = spec.finalize(rt, gather_machines(state, counting))
        out.append({
            "app": app, "backend": backend, "rank": mesh.rank,
            "exchange_all_reduce_bytes": nbytes,
            "exchange_all_reduce_calls": calls,
            "rank_tensor_bytes": _tensor_bytes(spec.static)
            + _tensor_bytes(spec.state),
            "peak_bytes": torch.cuda.max_memory_allocated() if on_cuda
            else None,
            "bsr_spmv_launches": launches, "result": result})
    return out


def run_bsp_cells(out: str | None = None, skip_done: bool = False,
                  device="cuda", timeout: float = 600.0) -> list:
    """The ``--bsp`` mode: every (app × backend) superstep once on 8 gloo
    ranks at ``rmat(9, seed=2)`` and ``scaled_paper_cluster(2, 6, E)``
    (p = 8), one machine a rank, all on ``device``.  Returns one record a
    cell (its per-rank readings under ``ranks``), printed and appended to
    ``out`` where given; a rank that fails makes the run raise."""
    from ..bsp import spawn_machines
    from ..bsp.apps import APP_BUILDERS
    from ..bsp.backends import BACKENDS
    from ..core import scaled_paper_cluster, windgp
    from ..data import rmat

    g = rmat(9, seed=2)
    cl = scaled_paper_cluster(2, 6, g.num_edges)      # p = 8 machines
    done = _done(out, ("app", "backend")) if skip_done else set()
    todo = [(a, b) for a in APP_BUILDERS for b in BACKENDS
            if (a, b) not in done]
    if not todo:
        return []
    ranks = spawn_machines(bsp_rank, cl.p, graph=g,
                           assign=windgp(g, cl, t0=2).assign, args=(todo,),
                           device=device, timeout=timeout)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    recs = []
    for i, (app, backend) in enumerate(todo):
        per_rank = [r[i] for r in ranks]
        rec = {"app": app, "backend": backend, "mesh": f"machines{cl.p}",
               "p": cl.p, "device": str(device),
               "ranks": [{k: v for k, v in r.items() if k != "result"}
                         for r in per_rank],
               "result": per_rank[0]["result"]}
        peak = [r["peak_bytes"] for r in per_rank]
        coll = max(r["exchange_all_reduce_bytes"] for r in per_rank)
        peak_s = (f"peak {max(peak) / 2**20:.1f} MiB/rank" if peak[0]
                  is not None else "peak not measured on the CPU")
        print(f"OK   bsp {app} × {backend}: {peak_s}, tensors "
              f"{max(r['rank_tensor_bytes'] for r in per_rank) / 2**20:.2f}"
              f" MiB/rank, exchange {coll / 2**10:.1f} KiB/step, "
              f"bsr_spmv {[r['bsr_spmv_launches'] for r in per_rank]}",
              flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps({k: v for k, v in rec.items()
                                    if k != "result"}) + "\n")
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--bsp", action="store_true",
                    help="run the BSP (app × edge-kernel backend) supersteps "
                    "over 8 gloo ranks instead of the model cells")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both", "one"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--device", default="cuda",
                    help="device of the --bsp ranks (default cuda; 'cpu' "
                    "to run on the CPU)")
    args = ap.parse_args(argv)

    if args.bsp:
        run_bsp_cells(args.out, skip_done=args.skip_done, device=args.device)
        return 0
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, or --arch and --shape")
    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = {"both": ["pod", "multipod"]}.get(args.mesh, [args.mesh])
    recs = run_cells(todo, meshes, args.out, skip_done=args.skip_done)
    return 0 if all(r["fits"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
