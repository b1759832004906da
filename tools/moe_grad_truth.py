#!/usr/bin/env python3
"""How far float32 gradients of one MoE layer lie from a float64 truth.

    python3 tools/moe_grad_truth.py [--tokens 1024]

Draws the layer and tokens of ``chip_smoke.py`` phase 11a
(phi3.5-moe-42b-a6.6b at its published width, seed 0, 8 × 2048 tokens, the
first ``--tokens`` positions of each sequence in float32), runs the port's
one-device ``moe_ffn`` at capacity factor 8 (dropless) in float32 and in
float64, and prints, for the gradient of ``sum(y²)`` with respect to the
router, each expert weight and x: its largest element, max |float32 -
float64|, and the elements outside ``rtol = atol = 5e-4`` (the reference
test's tolerance).  The float64 run routes in float64 (the layer's router
products are float32 otherwise).  It needs a card with about 60 GB free.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def routed_in(dtype):
    """``moe_route`` with its router products in ``dtype``."""
    def route(cfg, p, xf):
        logits = torch.einsum("gnd,de->gne", xf.to(dtype), p["router"])
        gates, idx = torch.topk(logits, cfg.experts_per_token, dim=-1,
                                sorted=True)
        return torch.softmax(gates, dim=-1), idx
    return route


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tokens", type=int, default=1024,
                    help="positions of each of the 8 sequences")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_grad_truth: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    cfg8 = dataclasses.replace(cfg, capacity_factor=8.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = layers.init_moe(cfg, gen)
    x = torch.randn((8, 2048, cfg.d_model), generator=gen, device="cuda",
                    dtype=p["w_gate"].dtype)[:, :args.tokens]
    grads = {}
    plain = layers.moe_route
    for dtype in (torch.float64, torch.float32):
        layers.moe_route = routed_in(dtype) if dtype == torch.float64 \
            else plain
        pp = {k: v.to(dtype).requires_grad_() for k, v in p.items()}
        xx = x.to(dtype).requires_grad_()
        (layers.moe_ffn(cfg8, pp, xx) ** 2).sum().backward()
        grads[dtype] = {**{k: v.grad.double().cpu() for k, v in pp.items()},
                        "x": xx.grad.double().cpu()}
        del pp, xx
        torch.cuda.empty_cache()
    layers.moe_route = plain
    truth, f32 = grads[torch.float64], grads[torch.float32]
    out = {k: {"max_abs": float(truth[k].abs().max()),
               "float32_max_abs_err": float((f32[k] - truth[k]).abs().max()),
               "outside_5e-4": int(((f32[k] - truth[k]).abs()
                                    > 5e-4 + 5e-4 * truth[k].abs()).sum())}
           for k in truth}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"tokens": [8, args.tokens], "grad": out,
                      "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
