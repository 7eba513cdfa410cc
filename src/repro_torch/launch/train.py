"""Training entry point of the port: synthetic stream -> ZeroPP tick
engine -> AdamW, on one card or on a data x (groups x pp) mesh of ranks.

Prints one line a step (loss, grad norm, step ms, tokens/s) and
``TRAIN_OK`` at the end. There is no checkpointing or fault-tolerance
controller yet (the checkpoint slice, ROADMAP.md queue 1).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt_paper \\
      --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --backend gloo --data 2 --pp 2 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --full --data 2 \\
      --pp 2 --seq 1024 --backend gloo --steps 3

``--full`` trains the architecture at its published width (llama3.2-1b:
16 layers, d_model 2048, vocab 128256, 4 sequences of 2048 a step;
gpt_paper: gpt-1.5B, 22 layers, d_model 2304, vocab 50304, 8 sequences
of 1024 a step; bf16, random weights from seed 0); without it the
reduced smoke config. The default device is the card.

``--data D --pp P [--groups G]`` trains on D * G * P ranks: this process
spawns one process a rank (``torch.multiprocessing``, spawn start
method), each joins ``torch.distributed`` over ``--backend`` on a free
localhost port, draws the same full tree from the seed and keeps its
part, and trains on its data shard of the same global batch (one
sequence a micro-batch of every pipeline group of every data rank, unless
the config module sets ``TRAIN_BATCH``). Rank 0 prints the lines; any
failing rank makes this process exit non-zero. The backend is always the
caller's: ``nccl`` needs a card a rank, ``gloo`` stages collectives
through host memory and runs any number of ranks on one card (each rank
on card ``rank % device count``). ``--report FILE`` writes rank 0's JSON
summary (steps, and each rank's kernel launches and peak memory).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import sys
import time

import torch

from repro_torch.api import session
from repro_torch.api.registry import get_arch
from repro_torch.core.comm import BACKENDS, check_backend


def _args(argv=None):
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
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--pp", type=int, default=None,
                    help="pipeline stages a group (default: the config's)")
    ap.add_argument("--groups", type=int, default=1,
                    help="pipeline groups")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="torch.distributed backend (needed for >1 rank)")
    ap.add_argument("--report", default=None,
                    help="write rank 0's JSON summary here")
    return ap.parse_args(argv)


def _world(args) -> int:
    return args.data * args.groups * (args.pp or 1)


def train(args, rank: int = 0) -> None:
    """Build the session and run the steps in this process (one rank of
    the mesh when ``torch.distributed`` is initialised)."""
    mod = get_arch(args.arch)
    seq = args.seq or (getattr(mod, "TRAIN_SEQ", 2048) if args.full
                       else 32)
    # sequences a step: the config module's TRAIN_BATCH at full width,
    # else one a micro-batch
    batch = getattr(mod, "TRAIN_BATCH", None) if args.full else None
    ov = dict(schedule=args.schedule, microbatches=args.microbatches,
              unit=args.unit)
    if args.pp is not None:
        ov["pp"] = args.pp
    if args.groups != 1:
        ov["groups"] = args.groups
    sess = session(
        args.arch, mode="train", reduced=not args.full, device=args.device,
        seq_len=seq, global_batch=batch, data=args.data, overrides=ov,
        optim=dict(lr=args.lr, warmup=1, total=10_000))
    out = print if rank == 0 else (lambda *a, **k: None)
    d = sess.describe()
    sc = sess.shape_cfg
    mesh = sess.mesh
    where = (f"{d['device']}" if mesh is None else
             f"{mesh.world} ranks (data {mesh.data} x groups {mesh.groups} "
             f"x pp {mesh.pp}), backend {mesh.backend}, rank 0 on "
             f"{d['device']}")
    out(f"{d['arch']} on {where}: {d['n_params']} params, schedule "
        f"{d['schedule']['name']} (vpp {d['schedule']['vpp']}, "
        f"{d['schedule']['microbatches']} micro-batches, unit "
        f"{d['schedule']['unit']}, {d['schedule']['ticks']} ticks), "
        f"batch {sc.global_batch} x {sc.seq_len}", flush=True)
    cuda = sess.device.type == "cuda"
    gen = torch.Generator(device=sess.device).manual_seed(0)
    params = sess.init_params(gen)
    opt = sess.init_opt_state(params)
    stream = sess.stream()
    tokens = sc.global_batch * sc.seq_len
    if cuda:
        torch.cuda.reset_peak_memory_stats(sess.device)
    steps, min_free = [], None
    for step in range(args.steps):
        batch = stream.batch(step)
        t0 = time.perf_counter()
        grads, metrics = sess.train_step(params, batch)
        params, opt, om = sess.opt_step(params, grads, opt)
        loss = float(metrics["loss_sum"])
        if cuda:
            torch.cuda.synchronize(sess.device)
        dt = time.perf_counter() - t0
        del grads
        if cuda:
            free = torch.cuda.mem_get_info(sess.device)[0]
            min_free = free if min_free is None else min(min_free, free)
        row = dict(step=step + 1, loss=loss,
                   grad_norm=float(om["grad_norm"]), ms=dt * 1e3,
                   tok_per_s=tokens / dt,
                   emb_dropped=int(metrics["emb_dropped"]))
        steps.append(row)
        out(f"step {step:4d} loss {loss:.6f} gnorm "
            f"{row['grad_norm']:.6f} step {row['ms']:.1f} ms "
            f"{row['tok_per_s']:.1f} tok/s", flush=True)
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    mine = dict(rank=rank, device=str(sess.device),
                launches={**fa.LAUNCHES, **fx.LAUNCHES},
                counters=sess.describe()["kernels"]["counters"],
                max_memory_gb=(torch.cuda.max_memory_allocated(sess.device)
                               / 2**30 if cuda else None),
                min_free_gb=(min_free / 2**30 if cuda else None))
    ranks = [mine]
    if mesh is not None:
        ranks = [None] * mesh.world
        torch.distributed.all_gather_object(ranks, mine)
    summary = dict(arch=d["arch"], n_params=d["n_params"],
                   schedule=d["schedule"], mesh=d.get("mesh"),
                   backend=None if mesh is None else mesh.backend,
                   global_batch=sc.global_batch, seq=sc.seq_len,
                   steps=steps, ranks=ranks)
    out(f"TRAIN_OK steps={len(losses)} first_loss={losses[0]:.4f} "
        f"last_loss={losses[-1]:.4f} kernels={mine['counters']}",
        flush=True)
    if rank == 0 and args.report:
        with open(args.report, "w") as f:
            json.dump(summary, f, indent=1)


def _rank_main(rank: int, args, port: int) -> None:
    world = _world(args)
    if args.device == "cpu":
        torch.set_num_threads(1)     # the ranks share the host's cores
    else:
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.distributed.init_process_group(
        args.backend, init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank)
    try:
        train(args, rank)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    args = _args(argv)
    world = _world(args)
    if world == 1:
        train(args)
        return
    if args.backend is None:
        raise SystemExit(f"{world} ranks need --backend gloo or --backend "
                         "nccl")
    try:
        check_backend(args.backend, world, args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    import torch.multiprocessing as mp
    try:
        mp.spawn(_rank_main, args=(args, _free_port()), nprocs=world,
                 join=True)
    except mp.ProcessRaisedException as e:
        print(f"a rank failed:\n{e}", file=sys.stderr, flush=True)
        raise SystemExit(1) from None
    except mp.ProcessExitedException as e:
        print(f"a rank exited: {e}", file=sys.stderr, flush=True)
        raise SystemExit(1) from None


if __name__ == "__main__":
    main()
