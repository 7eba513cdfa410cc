"""Training entry point of the port: synthetic stream -> ZeroPP tick
engine -> AdamW, on one card.

Prints one line a step (loss, grad norm, step ms, tokens/s) and
``TRAIN_OK`` at the end. There is no checkpointing or fault-tolerance
controller yet (the checkpoint slice, ROADMAP.md queue 1).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt_paper \
      --full --device cuda

``--full`` trains the architecture at its published width (llama3.2-1b:
16 layers, d_model 2048, vocab 128256, 4 sequences of 2048 a step;
gpt_paper: gpt-1.5B, 22 layers, d_model 2304, vocab 50304, 8 sequences
of 1024 a step; bf16, random weights from seed 0); without it the
reduced smoke config. The default device is the card.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.api import session
from repro_torch.api.registry import get_arch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default with --full: the "
                         "config module's TRAIN_SEQ, else 2048; else 32)")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--unit", type=int, default=2)
    ap.add_argument("--schedule", default="zeropp")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full", action="store_true",
                    help="the published width instead of the reduced config")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    seq = args.seq or (getattr(mod, "TRAIN_SEQ", 2048) if args.full
                       else 32)
    # sequences a step: the config module's TRAIN_BATCH at full width,
    # else one a micro-batch
    batch = getattr(mod, "TRAIN_BATCH", None) if args.full else None
    sess = session(
        args.arch, mode="train", reduced=not args.full, device=args.device,
        seq_len=seq, global_batch=batch,
        overrides=dict(schedule=args.schedule,
                       microbatches=args.microbatches, unit=args.unit),
        optim=dict(lr=args.lr, warmup=20, total=10_000))
    d = sess.describe()
    sc = sess.shape_cfg
    print(f"{d['arch']} on {d['device']}: {d['n_params']} params, schedule "
          f"{d['schedule']['name']} (vpp {d['schedule']['vpp']}, "
          f"{d['schedule']['microbatches']} micro-batches, unit "
          f"{d['schedule']['unit']}, {d['schedule']['ticks']} ticks), "
          f"batch {sc.global_batch} x {sc.seq_len}", flush=True)
    gen = torch.Generator(device=sess.device).manual_seed(0)
    params = sess.init_params(gen)
    opt = sess.init_opt_state(params)
    stream = sess.stream()
    tokens = sc.global_batch * sc.seq_len
    losses = []
    for step in range(args.steps):
        batch = stream.batch(step)
        t0 = time.perf_counter()
        grads, metrics = sess.train_step(params, batch)
        params, opt, om = sess.opt_step(params, grads, opt)
        loss = float(metrics["loss_sum"])
        if sess.device.type == "cuda":
            torch.cuda.synchronize(sess.device)
        dt = time.perf_counter() - t0
        del grads
        losses.append(loss)
        print(f"step {step:4d} loss {loss:.4f} gnorm "
              f"{float(om['grad_norm']):.3f} step {dt * 1e3:.1f} ms "
              f"{tokens / dt:.1f} tok/s", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    print(f"TRAIN_OK steps={len(losses)} first_loss={losses[0]:.4f} "
          f"last_loss={losses[-1]:.4f} kernels="
          f"{sess.describe()['kernels']['counters']}", flush=True)


if __name__ == "__main__":
    main()
