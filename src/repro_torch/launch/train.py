"""Training entry point of the port: synthetic stream -> ZeroPP tick
engine -> AdamW, on one card or on a pods x data x (groups x pp) mesh of
ranks.

Prints one line a step (loss, grad norm, step ms, tokens/s) and
``TRAIN_OK`` at the end.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt_paper \\
      --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch jamba-v0.1-52b --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch jamba-v0.1-52b --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen2-moe-a2.7b --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen2-moe-a2.7b --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch phi-3-vision-4.2b --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch xlstm-1.3b --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch xlstm-1.3b --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-large-v3 --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-large-v3 --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --backend gloo --data 2 --pp 2 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --full --data 2 \\
      --pp 2 --seq 1024 --backend gloo --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --backend gloo --pods 2 --data 2
  PYTHONPATH=src python -m repro_torch.launch.train --full --pods 2 \\
      --data 2 --layers 8 --seq 1024 --grad-compress int8 --backend gloo
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 6 --ckpt-dir build/ckpt --ckpt-every 2 --inject-failure-at 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gpt_paper --schedule auto
  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch gpt_paper --pp 2 --vpp 1 --microbatches 8 --unit 4 \\
      --backend gloo --schedule auto_profiled --profile-top-k 2

``--schedule`` takes a registered schedule (zeropp, the §4 autogen and
autogen_gated, ...), ``auto`` (the §4 plan selection: every candidate
simulated under ``--preset``, the least simulated makespan winning,
under ``--mem-budget`` bytes of simulated peak memory when given) or
``auto_profiled`` (then the ``--profile-top-k`` best are timed on the
mesh, within ``--profile-budget-s``); the first line names the selected
schedule and how it was found (a search, or a hit of the plan cache,
``~/.cache/repro_torch/plans.json`` or ``$REPRO_TORCH_PLAN_CACHE``, which
``off`` disables). On a mesh every rank selects alike; rank 0 prints.

``--full`` trains the architecture at its published width (llama3.2-1b:
16 layers, d_model 2048, vocab 128256, 4 sequences of 2048 a step;
gpt_paper: gpt-1.5B, 22 layers, d_model 2304, vocab 50304, 8 sequences
of 1024 a step; jamba-v0.1-52b: its widths cut to 2 layers and 8
experts, vpp 1, 4 sequences of 4096 a step; qwen2-moe-a2.7b: its widths,
all 60 experts and the shared FFN, cut to 3 layers, vpp 1, 4 sequences of
4096 a step; phi-3-vision-4.2b: its widths cut to 16 layers, 4 sequences
of 4096 float patch embeddings a step (the vision stub: the table takes
no gradient); whisper-large-v3 uncut, 32 encoder and 32 decoder layers,
8 sequences of 448 tokens a step, each with 1500 float frames of the
audio stub (the encoder's forward walk, the decoder's table, the
encoder's backward walk); bf16, random weights from seed 0); without it
the reduced
smoke config. The default device is the card.

``--data D --pp P [--groups G] [--pods Q]`` trains on Q * D * G * P
ranks (pods replicate the parameters and all-reduce the gradients):
this process spawns one process a rank (``torch.multiprocessing``, spawn start
method), each joins ``torch.distributed`` over ``--backend`` on a free
localhost port, draws the same full tree from the seed and keeps its
part, and trains on its data shard of the same global batch (one
sequence a micro-batch of every pipeline group of every data rank of
every pod, unless the config module sets ``TRAIN_BATCH``). Rank 0 prints
the lines; any
failing rank makes this process exit non-zero. The backend is always the
caller's: ``nccl`` needs a card a rank, ``gloo`` stages collectives
through host memory and runs any number of ranks on one card (each rank
on card ``rank % device count``). ``--grad-compress int8`` reduces the
stage gradients in int8 with error feedback; ``--layers L`` cuts the
model to L layers at its widths. ``--report FILE`` writes rank 0's JSON summary
(steps, and each rank's kernel launches, peak memory and a sha256 of
its parameters after the last step).

``--ckpt-dir DIR`` trains under the fault-tolerance controller
(``repro_torch.runtime.fault_tolerance``): it resumes from DIR's latest
verified checkpoint (a checkpoint at or past ``--steps`` leaves nothing
to train), saves every ``--ckpt-every`` steps and at the end in the
reference's format (asynchronously; on a mesh, collectively),
``--inject-failure-at N`` raises a failure before step N on every rank
once, and the controller restores the last checkpoint and resumes, up to
``--max-failures``. Restarts stay on the same mesh (the reference
halves its data axis on each; that elastic re-mesh waits for ROADMAP.md
queue 1 item 8). ``TRAIN_OK`` then also prints ``failures=``,
``resume_steps=`` and ``straggler_flags=``, and the report holds the
controller's summary and each save's and restore's bytes and seconds
(``ckpt_events``). Without ``--ckpt-dir`` nothing is saved.
"""

from __future__ import annotations

import argparse
import hashlib
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
    ap.add_argument("--schedule", default="zeropp",
                    help="a registered schedule, 'auto' (the §4 simulated "
                         "plan selection) or 'auto_profiled' (also time "
                         "the top-K finalists)")
    ap.add_argument("--preset", default="a800",
                    help="cost preset of the selection (a800)")
    ap.add_argument("--mem-budget", type=float, default=None,
                    help="auto: simulated peak-memory cap in bytes")
    ap.add_argument("--profile-top-k", type=int, default=3,
                    help="auto_profiled: simulated survivors to time")
    ap.add_argument("--profile-budget-s", type=float, default=None,
                    help="auto_profiled: seconds cap on timing (the "
                         "simulated-best is always timed)")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full", action="store_true",
                    help="the published width instead of the reduced config")
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--pp", type=int, default=None,
                    help="pipeline stages a group (default: the config's)")
    ap.add_argument("--vpp", type=int, default=None,
                    help="stage blocks a rank (default: the config's)")
    ap.add_argument("--groups", type=int, default=1,
                    help="pipeline groups")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods (replicas of the data x model mesh)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--grad-compress", default=None, choices=("none", "int8"),
                    help="stage-gradient reduces (default: the config's)")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="torch.distributed backend (needed for >1 rank)")
    ap.add_argument("--report", default=None,
                    help="write rank 0's JSON summary here")
    ap.add_argument("--ckpt-dir", default=None,
                    help="train under the fault-tolerance controller, "
                         "checkpointing here (and resuming from its "
                         "latest verified step)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failure-at", type=int, default=None,
                    help="raise a failure before this step (every rank), "
                         "once: the controller restores and resumes")
    ap.add_argument("--max-failures", type=int, default=3)
    return ap.parse_args(argv)


def _world(args) -> int:
    return args.pods * args.data * args.groups * (args.pp or 1)


def params_sha256(params) -> str:
    """sha256 of a parameter tree's bytes, leaves in sorted-key order."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            h.update(t.detach().reshape(-1).view(torch.uint8).cpu()
                     .numpy().tobytes())
    walk(params)
    return h.hexdigest()


def _session(args, mod):
    seq = args.seq or (getattr(mod, "TRAIN_SEQ", 2048) if args.full
                       else 32)
    # sequences a step: the config module's TRAIN_BATCH at full width,
    # else one a micro-batch
    batch = getattr(mod, "TRAIN_BATCH", None) if args.full else None
    ov = dict(schedule=args.schedule, microbatches=args.microbatches,
              unit=args.unit)
    for knob in ("pp", "vpp"):
        if getattr(args, knob) is not None:
            ov[knob] = getattr(args, knob)
    if args.groups != 1:
        ov["groups"] = args.groups
    if args.grad_compress is not None:
        ov["grad_compress"] = args.grad_compress
    kw = dict(cost_preset=args.preset)
    if args.mem_budget is not None:
        kw["mem_budget"] = args.mem_budget
    if args.schedule == "auto_profiled":
        kw.update(profile_top_k=args.profile_top_k,
                  profile_budget_s=args.profile_budget_s)
    return session(
        args.arch, mode="train", reduced=not args.full, device=args.device,
        seq_len=seq, global_batch=batch, data=args.data, pods=args.pods,
        layers=args.layers, overrides=ov,
        optim=dict(lr=args.lr, warmup=1, total=10_000), **kw)


def _selection_lines(sess, asked: str) -> list[str]:
    """What an auto session selected, how, and each candidate's simulated
    makespan (seconds of the preset's cost model) and measured step."""
    sched = sess.describe()["schedule"]
    auto = sched["auto"]
    prov = auto["provenance"]
    lines = [
        f"schedule={asked} selected {auto['selected']!r} "
        f"({prov['selection']}; this session: {prov['this_session']}; "
        f"simulated makespan {sched['makespan']:.4e} s under "
        f"{sched['preset']}, stash depth {sched['stash_depth']})",
        "simulated ranking: " + ", ".join(
            f"{n}={m:.4e}" for n, m in sess.plan_selection.ranking())]
    failed = {n: c for n, c in auto["candidates"].items()
              if isinstance(c, str)}
    if failed:
        lines.append(f"not candidates: {failed}")
    if auto.get("measured"):
        lines.append("measured us/step: " + ", ".join(
            f"{n}={us:.1f}"
            for n, us in sess.plan_selection.measured_ranking()))
    return lines


def train(args, rank: int = 0) -> None:
    """Build the session and run the steps in this process (one rank of
    the mesh when ``torch.distributed`` is initialised); with
    ``--ckpt-dir``, under the fault-tolerance controller."""
    mod = get_arch(args.arch)
    sess = _session(args, mod)
    out = print if rank == 0 else (lambda *a, **k: None)
    d = sess.describe()
    sc = sess.shape_cfg
    mesh = sess.mesh
    pods = f"pods {mesh.pods} x " if mesh is not None and mesh.pods > 1 \
        else ""
    where = (f"{d['device']}" if mesh is None else
             f"{mesh.world} ranks ({pods}data {mesh.data} x groups "
             f"{mesh.groups} x pp {mesh.pp}), backend {mesh.backend}, "
             f"rank 0 on {d['device']}")
    out(f"{d['arch']} on {where}: {d['n_params']} params, schedule "
        f"{d['schedule']['name']} (vpp {d['schedule']['vpp']}, "
        f"{d['schedule']['microbatches']} micro-batches, unit "
        f"{d['schedule']['unit']}, {d['schedule']['ticks']} ticks, "
        f"prefetch {d['schedule']['prefetch']}, coalesce "
        f"{d['schedule']['coalesce']}, grad_compress "
        f"{d['schedule']['grad_compress']}), batch {sc.global_batch} x "
        f"{sc.seq_len}", flush=True)
    if sess.plan_selection is not None:
        for line in _selection_lines(sess, args.schedule):
            out(line, flush=True)
    cuda = sess.device.type == "cuda"
    tokens = sc.global_batch * sc.seq_len
    if cuda:
        torch.cuda.reset_peak_memory_stats(sess.device)
    steps, free = [], []

    def run_step(s, params, opt, batch, step):
        t0 = time.perf_counter()
        grads, metrics = s.train_step(params, batch)
        params, opt, om = s.opt_step(params, grads, opt)
        loss = float(metrics["loss_sum"])
        if cuda:
            torch.cuda.synchronize(s.device)
        dt = time.perf_counter() - t0
        del grads
        if cuda:
            free.append(torch.cuda.mem_get_info(s.device)[0])
        row = dict(step=step + 1, loss=loss,
                   grad_norm=float(om["grad_norm"]), ms=dt * 1e3,
                   tok_per_s=tokens / dt,
                   emb_dropped=int(metrics["emb_dropped"]))
        steps.append(row)
        out(f"step {step:4d} loss {loss:.6f} gnorm "
            f"{row['grad_norm']:.6f} step {row['ms']:.1f} ms "
            f"{row['tok_per_s']:.1f} tok/s", flush=True)
        return params, opt

    ctl = None
    if args.ckpt_dir is None:
        gen = torch.Generator(device=sess.device).manual_seed(0)
        params = sess.init_params(gen)
        opt = sess.init_opt_state(params)
        stream = sess.stream()
        for step in range(args.steps):
            params, opt = run_step(sess, params, opt, stream.batch(step),
                                   step)
    else:
        ctl = sess.checkpointing(args.ckpt_dir, every=args.ckpt_every,
                                 max_failures=args.max_failures)
        box = {"sess": sess}
        del sess

        def build(restored, manifest):
            # a restart builds a fresh session on the same mesh
            s = box["sess"] if not ctl.failures else _session(args, mod)
            box["sess"] = s
            ctl.attach(s)
            if restored is None:
                gen = torch.Generator(device=s.device).manual_seed(0)
                params = s.init_params(gen)
                state = {"params": params,
                         "opt": s.init_opt_state(params)}
            else:
                state = s.adopt_state(restored)
                out(f"restart {ctl.failures}/{ctl.cfg.max_failures} "
                    f"resumed at step {manifest['extra']['step']} from "
                    f"{args.ckpt_dir}", flush=True)
            stream = s.stream()

            def run_one(st, step):
                p, o = run_step(s, st["params"], st["opt"],
                                stream.batch(step), step)
                return {"params": p, "opt": o}, {"loss": steps[-1]["loss"]}

            return state, run_one, lambda st: st

        state, _ = ctl.run(build, args.steps,
                           inject_failure_at=args.inject_failure_at)
        sess, params = box["sess"], state["params"]
        del state
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    # the session that trained last (after a restart, the rebuilt one)
    final = sess.describe()
    mine = dict(rank=rank, device=str(sess.device),
                launches={**fa.LAUNCHES, **fx.LAUNCHES},
                counters=final["kernels"]["counters"],
                max_memory_gb=(torch.cuda.max_memory_allocated(sess.device)
                               / 2**30 if cuda else None),
                min_free_gb=(min(free) / 2**30 if free else None),
                coords=(None if mesh is None else dict(
                    pod=mesh.pod_rank, data=mesh.d_rank, group=mesh.g_rank,
                    stage=mesh.p_rank)),
                params_sha256=params_sha256(params))
    ranks = [mine]
    if mesh is not None:
        ranks = [None] * mesh.world
        torch.distributed.all_gather_object(ranks, mine)
    summary = dict(arch=d["arch"], n_params=d["n_params"],
                   schedule=final["schedule"], mesh=d.get("mesh"),
                   backend=None if mesh is None else mesh.backend,
                   global_batch=sc.global_batch, seq=sc.seq_len,
                   steps=steps, ranks=ranks)
    tail = ""
    if ctl is not None:
        ft = summary["fault_tolerance"] = ctl.summary()
        summary["ckpt_events"] = ctl.mgr.events
        tail = (f" failures={ft['failures']} "
                f"resume_steps={ft['resume_steps']} "
                f"straggler_flags={ft['straggler_flags']}")
    first = f"{losses[0]:.4f}" if losses else "none"
    last = f"{losses[-1]:.4f}" if losses else "none"
    out(f"TRAIN_OK steps={len(losses)} first_loss={first} "
        f"last_loss={last} schedule={sess.rc.schedule} "
        f"kernels={mine['counters']}{tail}", flush=True)
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
