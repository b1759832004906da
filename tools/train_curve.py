#!/usr/bin/env python3
"""Loss curve of a published-size LM under the port's train step.

    python3 tools/train_curve.py [--arch mamba2-780m] [--steps 20]
                                 [--batch 8] [--lr 1e-3] [--dtype float32]

Trains ``--arch`` at its published config (in its dtype, bf16, unless
``--dtype`` says otherwise; remat; AdamW with the train CLI's defaults)
on ``SyntheticLM`` batches (seed 0) of ``--batch`` × 2048 tokens, on the
GPU through the port's kernels, and prints after each
step the step's training loss, the loss on one held-out batch (the
stream's batch after the last trained one) and the gradient norm.  Before
the first step it reads the variance σ² of the initial logits on the
held-out batch: for near-Gaussian logits over V words the initial loss is
about ln V + σ²/2, the excess that the first steps must remove before the
loss can go below ln V.  Prints the card and one JSON object.  Nothing of
the port calls this script: it shows how far the first steps take the
loss (``chip_smoke.py`` phase 9 trains 5).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm_data import LMDataState, SyntheticLM  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.train import (adamw_init, make_loss_fn,  # noqa: E402
                               make_train_step)

SEQ = 2048


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default=None,
                    help="the weights' dtype (default: the config's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_curve: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    data, state = SyntheticLM(cfg.vocab_size, seed=0), LMDataState(0, 0)
    batches = []
    for _ in range(args.steps + 1):
        b, state = data.batch(state, args.batch, SEQ)
        batches.append({k: torch.from_numpy(v).to("cuda")
                        for k, v in b.items()})
    held = batches.pop()
    params = init_params(cfg, seed=0, device="cuda").requires_grad_()
    opt = adamw_init(params)
    loss_fn = make_loss_fn(cfg, remat=False)

    def held_loss() -> float:
        with torch.no_grad():
            return float(loss_fn(params, held["inputs"], held["labels"]))

    with torch.no_grad():
        var = float(forward(cfg, params, held["inputs"]).float().var())
    step = make_train_step(cfg, lr=args.lr, remat=True)
    curve = [{"step": 0, "held_out": held_loss()}]
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        curve.append({"step": i + 1, "train": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "held_out": held_loss(),
                      "s": time.perf_counter() - t0})
        print(json.dumps(curve[-1]), file=sys.stderr, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    ln_v = math.log(cfg.vocab_size)
    print(json.dumps({"arch": args.arch, "batch": args.batch, "seq": SEQ,
                      "lr": args.lr, "dtype": cfg.dtype,
                      "ln_vocab": ln_v, "initial_logit_var": var,
                      "expected_initial_loss": ln_v + var / 2,
                      "curve": curve}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
