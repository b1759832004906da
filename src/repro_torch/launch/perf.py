"""One (arch × shape) cell on one card, the counterpart of the reference's
``launch/perf.py``.

The reference compiles a cell with ``--set`` config overrides and prints
its roofline terms.  Here the cell is one card's share of the shape:
``global_batch`` over the production mesh's data axes (16-way, or 32-way
with ``--multipod``), or ``--batch``.  ``run_variant`` first asks
``dryrun.fit`` whether that share fits the card; where it does not, it
reports the bytes by part and stops (the CLI exits 1).  It never cuts the
batch or the depth on its own: a cut (``--batch``, ``--set num_layers=``)
is the caller's, and the record lists it under ``reduced``.  It then runs
the cell on the device:

* train: ``make_train_step`` with remat and AdamW over ``SyntheticLM``
  batches;
* prefill: ``decode_step`` from an empty cache over the S prompt tokens;
* decode: ``decode_step`` of one token at ``cache_len`` = S − 1 over a
  cache of length S (its contents drawn from a seeded generator, or with
  ``cache_fill="prefill"`` written by a prefill of S − 1 prompt tokens).

and prints one JSON record: the reference's roofline keys
(``t_compute_s``, ``t_memory_s``, ``dominant``, ``model_flops``,
``analytic_flops``, ``useful_ratio``) on the card's constants
(``launch/roofline.py``), and the measured ones: ``step_ms`` (median of
``steps`` steps after a warm-up; CUDA events on the card), ``tokens_per_s``,
``peak_bytes`` beside dryrun's ``predicted_bytes``, ``mfu`` (model FLOPs
over the step time and the card's peak), ``memory_share`` (the analytic
bytes over the step time and the HBM rate) and the launches of
``decode_attn`` and ``ssd`` a step.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-14b \\
      --shape decode_32k --set num_layers=8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import torch

from ..configs import ARCHS, SHAPES, get_config
from ..data.lm_data import LMDataState, SyntheticLM
from ..device import resolve_device
from ..kernels.decode_attn import decode_attention
from ..kernels.ssd import ssd_chunked
from ..models import decode_step, init_cache, init_params
from ..train import adamw_init, make_train_step
from . import dryrun, roofline
from .mesh import MESH_NAMES, one_card


def parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v in ("true", "on"):
            v = True
        elif v in ("false", "off"):
            v = False
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


def _timer(dev: torch.device):
    """``time(fn) -> ms`` of one call: CUDA events on the card, the host's
    clock on the CPU."""
    if dev.type == "cuda":
        def cuda(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        return cuda

    def host(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    return host


def _inputs(cfg, B: int, S: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Random prompt tokens, or embeddings for an embedding-input arch."""
    if cfg.input_mode == "tokens":
        return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=dev)
    return torch.randn((B, S, cfg.d_model), generator=gen,
                       device=dev).to(getattr(torch, cfg.dtype))


def _train_step(cfg, params, B: int, S: int, gen, dev):
    """A ``step()`` running one training step on the next ``SyntheticLM``
    batch (embedding-input archs: random embeddings, the stream's
    labels); returns ``(step, losses)``."""
    params.requires_grad_()
    opt = adamw_init(params)
    fn = make_train_step(cfg, remat=True)
    data, state = SyntheticLM(cfg.vocab_size, seed=0), [LMDataState(0, 0)]
    losses = []

    def step():
        batch, state[0] = data.batch(state[0], B, S)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if cfg.input_mode != "tokens":
            batch["inputs"] = _inputs(cfg, B, S, gen, dev)
        _, _, metrics = fn(params, opt, batch)
        losses.append(metrics["loss"])
    return step, losses


def _serve_step(cfg, params, kind: str, B: int, S: int, gen, dev,
                cache_fill: str, outputs: dict | None):
    """A ``step()`` running one prefill (S tokens from an empty cache) or
    one decode step (one token at ``cache_len`` = S − 1 over a cache of
    length S)."""
    cache = init_cache(cfg, B, S, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    if kind == "prefill":
        prompt = _inputs(cfg, B, S, gen, dev)
        args = (prompt, zeros)
    else:
        prompt = _inputs(cfg, B, S - 1, gen, dev)
        if cache_fill == "prefill":
            decode_step(cfg, params, cache, prompt, zeros)
        elif cache_fill == "random":
            for leaves in cache.values():
                for t in leaves.values():
                    t.normal_(generator=gen)
        else:
            raise ValueError(f"cache_fill must be 'random' or 'prefill', "
                             f"got {cache_fill!r}")
        args = (_inputs(cfg, B, 1, gen, dev),
                torch.full((B,), S - 1, dtype=torch.int32, device=dev))
    first = []

    def step():
        # a repeated decode step rewrites position S - 1 of the attention
        # cache but advances the SSM state: only the first step's logits
        # are those of the prompt (the time does not depend on the state)
        logits, _ = decode_step(cfg, params, cache, *args)
        if not first:
            first.append(logits)
    if outputs is not None:
        outputs.update(prompt=prompt, inputs=args[0], logits=first)
    return step


def run_variant(arch: str, shape: str, overrides: dict,
                multi_pod: bool = False, batch: int | None = None,
                num_layers: int | None = None, steps: int = 5,
                device="cuda", *, cache_fill: str = "random",
                outputs: dict | None = None) -> dict:
    """Fit, then run one (arch × shape) cell on ``device``; returns its
    record.  ``overrides`` are config fields (``dataclasses.replace``) plus
    ``fsdp`` (accepted and reported; on one card, whose ``data`` axis is
    1, it changes nothing).  ``batch`` and ``num_layers`` are the caller's
    cuts.  A cell that does not fit returns its record with ``fits``
    False and runs nothing.  ``cache_fill`` fills a decode cell's cache
    with random values (``"random"``) or by a prefill (``"prefill"``,
    which the CPU tests use to hold the logits against ``forward``; at
    32k and beyond the plain prefill attention takes minutes on the
    card).  ``outputs`` (a dict, where given) receives
    the parameters and the step's inputs, and a list holding the first
    step's logits."""
    overrides = dict(overrides)
    fsdp = overrides.pop("fsdp", None)
    published = get_config(arch)
    cfg = dataclasses.replace(published, **overrides)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    sh = SHAPES[shape]
    S, kind = sh["seq_len"], sh["kind"]
    share = dryrun.one_card_batch(shape, multi_pod)
    B = share if batch is None else batch
    reduced = {}
    if B != share:
        reduced["batch"] = [share, B]
    if cfg.num_layers != published.num_layers:
        reduced["num_layers"] = [published.num_layers, cfg.num_layers]
    dev = resolve_device(device)
    fit = dryrun.fit(cfg, shape, one_card(), B)
    rec = {"arch": arch, "shape": shape, "kind": kind, "seq_len": S,
           "mesh": MESH_NAMES["multipod" if multi_pod else "pod"],
           "devices": 1, "batch": B, "num_layers": cfg.num_layers,
           "reduced": reduced, "overrides": overrides,
           "fsdp": {"asked": fsdp, "note": "one card: data axis 1, no "
                    "parameter is split"},
           "device": str(dev), "fits": fit["fits"],
           "predicted_bytes": fit["total_bytes"],
           "predicted_bytes_by_part": fit["bytes"],
           "memory_bytes": fit["memory_bytes"],
           **roofline.one_card_terms(cfg, shape, B)}
    if not fit["fits"]:
        return rec

    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, 0, dev)
    if outputs is not None:
        outputs["params"] = params
    losses = None
    if kind == "train":
        step, losses = _train_step(cfg, params, B, S, gen, dev)
    else:
        step = _serve_step(cfg, params, kind, B, S, gen, dev, cache_fill,
                           outputs)
    timer = _timer(dev)
    timer(step)                                   # warm-up
    decode_attention.launches = ssd_chunked.launches = 0
    times = [timer(step) for _ in range(steps)]
    launches = {"decode_attn": decode_attention.launches / steps,
                "ssd": ssd_chunked.launches / steps}
    step_s = statistics.median(times) / 1e3
    tokens = B * (1 if kind == "decode" else S)
    rec.update(step_ms=step_s * 1e3, step_ms_all=times, steps=steps,
               tokens_per_s=tokens / step_s,
               peak_bytes=torch.cuda.max_memory_allocated() if on_cuda
               else None,
               mfu=rec["model_flops"] / step_s / roofline.PEAK_FLOPS,
               memory_share=rec["analytic_bytes"] / step_s
               / roofline.HBM_BW,
               launches_per_step=launches)
    if losses is not None:
        rec["losses"] = [float(x) for x in losses]
    if on_cuda:
        rec["device_name"] = torch.cuda.get_device_name(dev)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (plus fsdp=on/off)")
    ap.add_argument("--multipod", action="store_true",
                    help="the 32-way data share of pod2x16x16 in place of "
                    "pod16x16's 16-way one")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences in place of the data share (a cut)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run on the "
                    "CPU)")
    args = ap.parse_args(argv)
    rec = run_variant(args.arch, args.shape, parse_overrides(args.set),
                      args.multipod, batch=args.batch, steps=args.steps,
                      device=args.device)
    print(json.dumps(rec, indent=2, default=str))
    return 0 if rec["fits"] else 1


if __name__ == "__main__":
    sys.exit(main())
