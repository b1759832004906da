"""Train a (reduced) assigned-architecture LM on the PyTorch port with the
full substrate: synthetic data pipeline, AdamW, checkpoint/resume (the
counterpart of ``examples/train_lm.py``, the same arguments handed to the
port's train CLI, ``repro_torch.launch.train``).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 60] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run on the "
                    "CPU)")
    args = ap.parse_args()
    ckpt = tempfile.mkdtemp(prefix="lm_ckpt_")
    rc = train_main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps), "--batch", "8", "--seq", "128",
        "--lr", "3e-3", "--checkpoint-dir", ckpt,
        "--checkpoint-every", "25", "--log-every", "10",
        "--device", args.device,
    ])
    print(f"checkpoints in {ckpt}")
    raise SystemExit(rc)
