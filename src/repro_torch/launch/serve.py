"""Serving driver of the port: the continuous-batching engine over a
``repro_torch`` Session, on the GPU by default.

Requests stream through a fixed pool of KV-cache slots (``--slots``);
finished requests release their slot mid-decode and the FIFO queue
refills it. The workload comes from ``--requests FILE`` (JSON / JSON
lines, as ``repro.launch.serve`` reads them) or is synthesized with
staggered lengths from ``--n-requests/--prompt/--gen``. Weights are
random, drawn from a seeded generator.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --slots 4 --n-requests 8 --prompt 12 --gen 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt_paper \\
      --full --device cuda --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
      --full --device cuda --slots 8 --page-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --full --device cuda --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen2-moe-a2.7b --full --device cuda --slots 8 --page-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi-3-vision-4.2b --full --device cuda --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --device cpu --slots 4 --n-requests 8 --prompt 12 --gen 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --full --device cuda --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --backend gloo --data 2 --pp 2 --slots 4 --prefill-chunk 4
  PYTHONPATH=src python -m repro_torch.launch.serve --full --data 2 \\
      --pp 2 --vpp 2 --microbatches 2 --slots 8 --backend gloo \\
      --layouts contiguous,paged,contiguous+resident --page-size 16

``--data D --pp P [--groups G] [--pods Q] --backend B`` serves on Q * D
* G * P ranks: this process spawns one process a rank (as
``launch/train.py`` does), each joins ``torch.distributed`` over ``B``
on a free localhost port, builds the same serve session, draws the same
full tree from the seed and keeps its part, and runs its own engine on
the same requests; the engines tick in lockstep (the session checks
every step against the other ranks'), driven with ``run_until_idle``.
Rank 0 prints the streams and ``SERVE_OK``; any failing rank makes this
process exit non-zero. ``nccl`` needs a card a rank; ``gloo`` runs any
number of ranks on one card. ``--pp P`` is the stages of a pipeline
group; with ``--data``, ``--groups`` and ``--pods`` at 1 they are not
ranks: one rank serves with the params stacked in P stages (as a
checkpoint of a P-stage trainer holds them), as a serve session does,
and ``--backend`` is refused. ``--vpp`` and ``--microbatches`` set
the stage blocks a rank and the micro-batches of the serve table.
``--layouts contiguous,paged`` serves the same requests in each layout
in turn on the same ranks and params (paged at ``--page-size``). A
layout written ``contiguous+resident`` or ``paged+resident`` serves with
``serve_resident`` set: each rank holds its stage rows whole and no tick
gathers a stage block over the data axis (the report's ``gathers`` read
0).
``--report FILE`` adds a prefill and a decode step with their logits
before each layout's run (``first_logits``: every slot row, so every
data shard's) and writes rank 0's JSON summary: per layout the streams,
step times, tokens/s, and each rank's kernel launches, peak memory and
FSDP gather seconds; the two steps' logits [2, slots, vocab] go to
``FILE.<layout>.logits.npy``.

``--ckpt DIR`` boots the params from a train checkpoint (the latest step
in DIR, written by ``launch/train.py --ckpt-dir`` or by the reference)
instead of drawing them; its pipeline stacking must match this
session's, so a checkpoint of the one-rank trainer (pp 1) serves with
``--pp 1``.

``--full`` serves the published width on one card, in bf16
(llama3.2-1b: 16 layers, d_model 2048; gpt_paper: the paper's
gpt-1.5B, 22 layers, d_model 2304, 24 heads of 96, LayerNorm and the
GELU MLP; yi-9b, minitron-4b and phi4-mini-3.8b at full depth;
jamba-v0.1-52b: d_model 4096 at depth 8, one period of its layer
pattern, as ``one_card_config()`` cuts it; qwen2-moe-a2.7b at full depth,
60 experts and the shared FFN, 28.6 GB; phi-3-vision-4.2b at full depth,
serving token-id prompts as the reference's engine does: a float patch
prefill goes through ``Session.serve_step_batched``); without it the
reduced smoke config runs. Jamba's Mamba layers keep
per-slot state, so ``--page-size`` and ``--prefill-chunk`` are refused
for it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.api import Session, SessionError, SessionSpec, get_arch
from repro_torch.core.comm import BACKENDS, check_backend
from repro_torch.serving.engine import check_layout

RESIDENT = "+resident"   # a --layouts suffix: serve_resident=True

_LATER = {
    "--replicas": "data-parallel replicas behind a router arrive with the "
                  "elasticity slice",
    "--moe-mode": "MoE layers are routed in the gathered mode only; ep "
                  "and auto arrive with the expert-parallel MoE slice",
    "--moe-stats": "expert-load statistics arrive with the "
                   "expert-parallel MoE slice",
}


def load_requests(path: str, vocab: int, seed: int = 0):
    """Parse a --requests workload file into (tokens, max_gen, stop)."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        entries = json.loads(text)
    else:
        entries = [json.loads(line) for line in text.splitlines() if line]
    rng = np.random.RandomState(seed)
    out = []
    for i, e in enumerate(entries):
        if "tokens" in e:
            toks = np.asarray(e["tokens"], np.int32)
            if toks.size and (toks.min() < 0 or toks.max() >= vocab):
                raise SystemExit(
                    f"--requests entry {i}: token ids must be in "
                    f"[0, {vocab}) for this config, got range "
                    f"[{toks.min()}, {toks.max()}]")
        elif "prompt_len" in e:
            toks = rng.randint(0, vocab, size=int(e["prompt_len"])
                               ).astype(np.int32)
        else:
            raise SystemExit(
                f"--requests entry {i} needs 'tokens' or 'prompt_len': {e}")
        out.append((toks, int(e.get("max_gen", 8)),
                    tuple(e.get("stop", ()))))
    if not out:
        raise SystemExit(f"--requests file {path!r} holds no requests")
    return out


def synth_requests(n: int, prompt: int, gen: int, vocab: int,
                   seed: int = 0):
    """Staggered synthetic workload: lengths skewed around the means."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = max(2, int(prompt * (0.5 + i / max(n - 1, 1))))
        g = max(2, int(gen * (0.25 + 1.5 * (i % 4) / 3)))
        toks = rng.randint(0, vocab, size=p).astype(np.int32)
        out.append((toks, g, ()))
    return out


def _args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true",
                    help="published width on one card (default: the "
                         "reduced smoke config)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-cache slots (in-flight requests)")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=16,
                    help="mean synthetic prompt length")
    ap.add_argument("--gen", type=int, default=8,
                    help="mean synthetic generation budget")
    ap.add_argument("--requests", default=None,
                    help="workload file (JSON array or JSON-lines)")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="KV cache length (default: fits the workload)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split prompts into chunks of this width")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged KV cache: tokens per page (default: "
                         "contiguous per-slot rows)")
    ap.add_argument("--max-pages", type=int, default=None,
                    help="paged KV cache: total page count")
    ap.add_argument("--layouts", default=None,
                    help="comma-separated cache layouts to serve in turn: "
                         "contiguous, paged (default: paged with "
                         "--page-size, else contiguous); '+resident' after "
                         "one (contiguous+resident) serves it with "
                         "serve_resident: stage rows whole on each rank, "
                         "no FSDP gathers")
    ap.add_argument("--prefix-sharing", default="on", choices=("on", "off"))
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=("fp32", "bf16", "int8"),
                    help="KV-cache storage dtype (default: the compute "
                         "dtype); int8 needs --page-size")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="per-request sampling seed base: request i "
                         "draws from seed+i")
    ap.add_argument("--ckpt", default=None,
                    help="boot the params from this train checkpoint "
                         "directory (its latest step; the geometry must "
                         "match the trainer's: see --pp)")
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--pp", type=int, default=None,
                    help="pipeline stages a group (default: the config's; "
                         "ranks only when --data, --groups or --pods is "
                         "above 1, else stacked on one rank)")
    ap.add_argument("--vpp", type=int, default=None,
                    help="stage blocks a rank (default: the config's)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="micro-batches of the serve table (default: the "
                         "config's)")
    ap.add_argument("--groups", type=int, default=1,
                    help="pipeline groups")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods (replicas of the data x model mesh)")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="torch.distributed backend (needed for >1 rank)")
    ap.add_argument("--report", default=None,
                    help="write rank 0's JSON summary here")
    for flag in _LATER:
        ap.add_argument(flag, default=None, nargs="?", const=True)
    args = ap.parse_args(argv)
    for flag, why in _LATER.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise SystemExit(f"{flag} is not in repro_torch yet: {why}")
    layouts = (args.layouts.split(",") if args.layouts else
               ["paged" if args.page_size else "contiguous"])
    bad = sorted(lay for lay in layouts if lay.removesuffix(RESIDENT)
                 not in ("contiguous", "paged"))
    if bad:
        raise SystemExit(f"--layouts: unknown layout(s) {bad}; pick "
                         f"contiguous and/or paged, each with or without "
                         f"{RESIDENT}")
    if any(lay.startswith("paged") for lay in layouts) and \
            not args.page_size:
        raise SystemExit("--layouts paged needs --page-size")
    args.layouts = layouts
    return args


def _world(args) -> int:
    """Ranks the flags ask for, as a serve session counts them: pods x
    data x groups x pp when pods, data or groups is above 1; else one
    rank, walking the ``--pp`` stages the params are stacked in."""
    axes = args.pods * args.data * args.groups
    return axes * (args.pp or 1) if axes > 1 else 1


def _workload(args, mod):
    vocab = (mod.config() if args.full else mod.reduced()[0]).vocab
    work = (load_requests(args.requests, vocab) if args.requests else
            synth_requests(args.n_requests, args.prompt, args.gen, vocab))
    if not work:
        raise SystemExit("no requests to serve (--n-requests 0?)")
    need = max(len(t) + g for t, g, _ in work) + 1
    max_seq = args.max_seq or need
    if max_seq < need:
        raise SystemExit(f"--max-seq {max_seq} too small for the "
                         f"workload (needs >= {need})")
    if args.page_size:
        max_seq = -(-max_seq // args.page_size) * args.page_size
    return work, max_seq


def _spec(args, max_seq: int, layout: str) -> SessionSpec:
    ov = {k: getattr(args, k) for k in ("pp", "vpp", "microbatches")
          if getattr(args, k) is not None}
    if args.groups != 1:
        ov["groups"] = args.groups
    if layout.endswith(RESIDENT):
        ov["serve_resident"] = True
    paged = layout.startswith("paged")
    return SessionSpec(
        arch=args.arch, mode="serve", reduced=not args.full,
        device=args.device, max_slots=args.slots, max_seq=max_seq,
        prefill_chunk=args.prefill_chunk,
        page_size=args.page_size if paged else None,
        max_pages=args.max_pages if paged else None,
        prefix_sharing=args.prefix_sharing,
        kv_cache_dtype=args.kv_cache_dtype, data=args.data,
        pods=args.pods, overrides=ov)


def first_logits(sess, params, prompts) -> np.ndarray:
    """float32 [2, slots, vocab]: every slot row's logits in one prefill
    step on fresh caches and in the decode step after it. Slot i takes
    the first w tokens of prompt i (w the shortest prompt's length) at
    position 0, then token w of it (its first, where it has w tokens) at
    position w; paged, slot i holds the pages of the i-th row of its
    shard (shard-local ids)."""
    n = sess.max_slots
    ps = [np.asarray(prompts[i % len(prompts)], np.int32) for i in range(n)]
    w = min(p.size for p in ps)
    batch = {"tokens": np.stack([p[:w] for p in ps]),
             "pos": np.zeros(n, np.int32), "slot_mask": np.ones(n, bool)}
    if sess.paged:
        shards = sess.pods_size * sess.data_size if sess.mesh else 1
        row = np.arange(n) % (n // shards)
        batch["page_tables"] = (row[:, None] * sess.pages_per_slot
                                + np.arange(sess.pages_per_slot)
                                ).astype(np.int32)
    caches = sess.init_caches()
    _, pre, caches = sess.serve_step_batched(params, caches, batch,
                                             want_logits=True)
    batch = dict(batch, tokens=np.array([[p[w % p.size]] for p in ps],
                                        np.int32),
                 pos=np.full(n, w, np.int32))
    _, dec, caches = sess.serve_step_batched(params, caches, batch,
                                             want_logits=True)
    del caches
    return np.stack([np.asarray(pre, np.float32),
                     np.asarray(dec, np.float32)])


def _launches() -> dict:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import selective_scan as ss
    return {**pa.LAUNCHES, **ss.LAUNCHES}


def _reset_counts(sess) -> None:
    from repro_torch.core import executor
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import selective_scan as ss
    pa.reset_launches()
    ss.reset_launches()
    executor.reset_coll_time()
    if sess.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(sess.device)


def _serve_layout(args, sess, params, work, rank: int) -> tuple[dict, dict]:
    """One layout's engine run; returns (rank 0's summary, this rank's
    counts)."""
    from repro_torch.core import executor
    from repro_torch.kernels import ops

    out = print if rank == 0 else (lambda *a, **k: None)
    cuda = sess.device.type == "cuda"
    times = {"prefill": [], "decode": []}
    step = sess.serve_step_batched

    def timed(params_, caches, batch, want_logits=False):
        if cuda:
            torch.cuda.synchronize(sess.device)
        t0 = time.perf_counter()
        res = step(params_, caches, batch, want_logits=want_logits)
        if cuda:
            torch.cuda.synchronize(sess.device)
        kind = "decode" if np.shape(batch["tokens"])[1] == 1 else "prefill"
        times[kind].append((time.perf_counter() - t0) * 1e3)
        return res

    sess.serve_step_batched = timed
    eng = sess.serve_engine(params)
    _reset_counts(sess)
    base = ops.kernel_counters()
    t0 = time.time()
    kw = [dict(max_gen=g, stop=stop, temperature=args.temperature,
               top_p=args.top_p,
               seed=(None if args.seed is None else args.seed + i))
          for i, (_, g, stop) in enumerate(work)]
    if sess.mesh is None:
        with eng:
            handles = [eng.submit(toks, **k)
                       for (toks, _, _), k in zip(work, kw)]
            results = [h.result(timeout=600) for h in handles]
    else:
        # lockstep: every rank submits the same requests, then ticks
        handles = [eng.submit(toks, **k) for (toks, _, _), k in zip(work, kw)]
        eng.run_until_idle()
        results = [h.result(timeout=1) for h in handles]
    if cuda:
        torch.cuda.synchronize(sess.device)
    dt = time.time() - t0
    sess.serve_step_batched = step
    for i, ((toks, g, _), res) in enumerate(zip(work, results)):
        out(f"  req{i}: prompt {len(toks):3d} -> {len(res)} tokens "
            f"{res[:8]}{'...' if len(res) > 8 else ''}")
    st = eng.stats
    total = st.generated_tokens
    mean = {k: sum(v) / max(len(v), 1) for k, v in times.items()}
    out(f"{len(work)} requests, {total} tokens in {dt:.3f}s "
        f"({total / max(dt, 1e-9):.1f} tok/s, "
        f"{st.prefill_steps} prefill steps of {mean['prefill']:.1f} ms + "
        f"{st.decode_steps} decode steps of {mean['decode']:.1f} ms, "
        f"slot occupancy {st.occupancy:.2f})")
    if sess.paged:
        out(f"paged: peak pages {st.peak_pages_in_use}/{sess.n_pages} "
            f"prefix_hits={st.prefix_hits} "
            f"prefix_hit_tokens={st.prefix_hit_tokens} "
            f"evictions={st.evictions}")
    counters = {k: v - base.get(k, 0) for k, v in ops.kernel_counters().items()
                if v - base.get(k, 0)}
    mine = dict(launches=_launches(), counters=counters,
                max_memory_gb=(torch.cuda.max_memory_allocated(sess.device)
                               / 2**30 if cuda else None),
                gathers=executor.COLL_TIME["gathers"],
                gather_issue_s=executor.COLL_TIME["issue_s"],
                gather_wait_s=executor.COLL_TIME["wait_s"])
    out(f"kernels: {counters}; FSDP gathers {mine['gathers']}: "
        f"{mine['gather_issue_s']:.3f} s issuing, "
        f"{mine['gather_wait_s']:.3f} s waiting")
    summary = dict(wall_s=dt, generated_tokens=total,
                   tok_per_s=total / max(dt, 1e-9),
                   prefill_steps=st.prefill_steps,
                   decode_steps=st.decode_steps,
                   prefill_step_ms=times["prefill"],
                   decode_step_ms=times["decode"],
                   prefix_hits=st.prefix_hits, streams=results)
    del eng
    return summary, mine


def serve(args, rank: int = 0) -> None:
    """Serve the workload in this process: one rank, or one rank of the
    mesh when ``torch.distributed`` is initialised."""
    mod = get_arch(args.arch)
    work, max_seq = _workload(args, mod)
    out = print if rank == 0 else (lambda *a, **k: None)
    # this rank's part of the params and whether it is the resident cut
    # (stage rows whole) or the gathered one (stage rows cut over the
    # data axis): a layout of the other kind drops it before making its
    # own, so a layout's peak memory holds its own cut only
    params, resident_cut, layouts, counts = None, None, {}, {}
    for layout in args.layouts:
        sess = Session(_spec(args, max_seq, layout))
        mesh = sess.mesh
        where = (f"{sess.device}" if mesh is None else
                 f"{mesh.world} ranks (pods {mesh.pods} x data {mesh.data} "
                 f"x groups {mesh.groups} x pp {mesh.pp}), backend "
                 f"{mesh.backend}, rank 0 on {sess.device}")
        ps = sess.page_size
        out(f"serving {sess.cfg.name} on {where} "
            f"({sess.describe()['n_params']} params, "
            f"{sess.rc.compute_dtype}); {args.slots} slots, max_seq "
            f"{max_seq}{f', page_size {ps}' if ps else ''}", flush=True)
        try:
            check_layout(sess, args.prefill_chunk)   # before any weights
        except NotImplementedError as e:
            raise SystemExit(f"{args.arch}: {e}") from e
        resident = layout.endswith(RESIDENT)
        if params is None or resident != resident_cut:
            params, resident_cut = None, resident
            if args.ckpt:
                params = sess.restore_params(args.ckpt)
                out(f"params restored from train checkpoint {args.ckpt}")
            else:
                gen = torch.Generator(device=sess.device).manual_seed(0)
                params = sess.init_params(gen)
        if args.report:    # every rank: the step is collective
            logits = first_logits(sess, params, [t for t, _, _ in work])
            if rank == 0:
                np.save(f"{args.report}.{layout}.logits.npy", logits)
        layouts[layout], counts[layout] = _serve_layout(args, sess, params,
                                                        work, rank)
        device = str(sess.device)
        del sess
    if args.report:
        mine = dict(rank=rank, counts=counts, device=device)
        ranks = [mine]
        if torch.distributed.is_initialized():
            ranks = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(ranks, mine)
        if rank == 0:
            with open(args.report, "w") as f:
                json.dump(dict(arch=args.arch, world=_world(args),
                               layouts=layouts, ranks=ranks), f, indent=1)
    out("SERVE_OK", flush=True)


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
        serve(args, rank)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> None:
    args = _args(argv)
    world = _world(args)
    if world == 1:
        if args.backend is not None:
            raise SystemExit(
                "--backend serves on ranks only with --data, --groups or "
                "--pods above 1; --pp alone stacks its stages on one rank")
        serve(args)
        return
    if args.backend is None:
        raise SystemExit(f"{world} ranks need --backend gloo or --backend "
                         "nccl")
    # the spec's checks, before any rank is spawned
    _, max_seq = _workload(args, get_arch(args.arch))
    try:
        for layout in args.layouts:
            _spec(args, max_seq, layout).validate()
    except SessionError as e:
        raise SystemExit(str(e)) from e
    try:
        check_backend(args.backend, world, args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    import torch.multiprocessing as mp

    from repro_torch.launch.train import _free_port
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
