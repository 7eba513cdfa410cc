"""Train a width-reduced GPT (the paper's model family) for a few hundred
steps with checkpoint/restart fault tolerance, in the PyTorch port: the
paper's end-to-end scenario at laptop scale, as ``examples/train_gpt.py``
runs it in the JAX package (the same arguments: gpt_paper, data 2, seq
64, 4 micro-batches in units of 2, lr 3e-3, a checkpoint every 50 steps).

The two data ranks are two processes on the CPU over gloo. Checkpoints
go to ``build/train_gpt_torch_ckpt`` in this checkout unless
``--ckpt-dir`` says otherwise; a run resumes from the latest one there.

    PYTHONPATH=src python examples/train_gpt_torch.py [--steps 200]
"""

import argparse
import pathlib

from repro_torch.launch import train

CKPT = pathlib.Path(__file__).resolve().parents[1] / "build" / \
    "train_gpt_torch_ckpt"

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=str(CKPT))
    args = ap.parse_args()
    train.main([
        "--arch", "gpt_paper", "--steps", str(args.steps), "--device", "cpu",
        "--backend", "gloo", "--data", "2", "--seq", "64",
        "--microbatches", "4", "--unit", "2", "--lr", "3e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
    ])
