"""Training CLI of the port (``src/repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 50 --batch 8 --seq 128 --checkpoint-dir ckpt \\
      --device cpu

Trains ``--arch`` (``--reduced``: the smoke-scale config) on the synthetic
Zipf–Markov corpus (``data.lm_data``) with AdamW, on ``--device`` (default
``cuda``; it raises without a GPU unless ``--device cpu`` is given).  With
``--checkpoint-dir`` it saves params, optimizer state and the data cursor
every ``--checkpoint-every`` steps and at the end; ``--resume`` continues
from the latest checkpoint, data cursor included.  An embedding-stub arch
is refused, as the reference refuses it.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, get_config, get_reduced
from ..data.lm_data import LMDataState, SyntheticLM
from ..device import resolve_device
from ..models import init_params
from ..train import CheckpointManager, adamw_init, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", choices=["int8"], default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run on the "
                    "CPU)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} is an embedding-stub arch; train the "
                         "backbone via a token arch or extend the stub.")
    device = resolve_device(args.device)
    params = init_params(cfg, args.seed, device).requires_grad_()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device}")
    opt = adamw_init(params)
    data = SyntheticLM(cfg.vocab_size, seed=args.seed)
    dstate = LMDataState(seed=args.seed, cursor=0)
    start_step = 0

    mgr = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    if mgr and args.resume and mgr.latest_step() is not None:
        restored, start_step, extra = mgr.restore({"params": params,
                                                   "opt": opt})
        params, opt = restored["params"], restored["opt"]
        dstate = LMDataState(seed=extra["data_seed"],
                             cursor=extra["data_cursor"])
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, lr=args.lr, microbatches=args.microbatches,
                              remat=args.remat, compress=args.compress)

    def save(step):
        mgr.save(step, {"params": params, "opt": opt},
                 extra={"data_seed": dstate.seed,
                        "data_cursor": dstate.cursor})

    t0 = time.perf_counter()
    tokens_done = 0
    for step in range(start_step, args.steps):
        batch, dstate = data.batch(dstate, args.batch, args.seq)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt, metrics = step_fn(params, opt, batch)
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            dt = time.perf_counter() - t0
            print(f"step {step+1:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{tokens_done/dt:.0f} tok/s", flush=True)
        if mgr and (step + 1) % args.checkpoint_every == 0:
            save(step + 1)
    if mgr:
        save(args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
