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
pattern, as ``one_card_config()`` cuts it); without it the reduced
smoke config runs. Jamba's Mamba layers keep
per-slot state, so ``--page-size`` and ``--prefill-chunk`` are refused
for it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.api import get_arch, session
from repro_torch.serving.engine import check_layout

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


def main(argv=None):
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
    ap.add_argument("--pp", type=int, default=None,
                    help="pipeline stages the params are stacked in "
                         "(default: the config's)")
    for flag in _LATER:
        ap.add_argument(flag, default=None, nargs="?", const=True)
    args = ap.parse_args(argv)
    for flag, why in _LATER.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise SystemExit(f"{flag} is not in repro_torch yet: {why}")

    mod = get_arch(args.arch)
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

    ov = {} if args.pp is None else {"pp": args.pp}
    sess = session(
        args.arch, reduced=not args.full, device=args.device,
        max_slots=args.slots, max_seq=max_seq,
        prefill_chunk=args.prefill_chunk, page_size=args.page_size,
        max_pages=args.max_pages, prefix_sharing=args.prefix_sharing,
        kv_cache_dtype=args.kv_cache_dtype, overrides=ov)
    print(f"serving {sess.cfg.name} on {sess.device} "
          f"({sess.describe()['n_params']} params, "
          f"{sess.rc.compute_dtype}); {args.slots} slots, max_seq {max_seq}"
          f"{f', page_size {args.page_size}' if args.page_size else ''}")
    try:
        check_layout(sess, args.prefill_chunk)   # before any weights
    except NotImplementedError as e:
        raise SystemExit(f"{args.arch}: {e}") from e
    if args.ckpt:
        params = sess.restore_params(args.ckpt)
        print(f"params restored from train checkpoint {args.ckpt}")
    else:
        gen = torch.Generator(device=sess.device).manual_seed(0)
        params = sess.init_params(gen)
    eng = sess.serve_engine(params)
    del params
    t0 = time.time()
    with eng:
        handles = [
            eng.submit(toks, max_gen=g, stop=stop,
                       temperature=args.temperature, top_p=args.top_p,
                       seed=(None if args.seed is None else args.seed + i))
            for i, (toks, g, stop) in enumerate(work)]
        results = [h.result(timeout=600) for h in handles]
    dt = time.time() - t0
    for i, ((toks, g, _), res) in enumerate(zip(work, results)):
        print(f"  req{i}: prompt {len(toks):3d} -> {len(res)} tokens "
              f"{res[:8]}{'...' if len(res) > 8 else ''}")
    st = eng.stats
    total = st.generated_tokens
    print(f"{len(work)} requests, {total} tokens in {dt:.3f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s, "
          f"{st.prefill_steps} prefill + {st.decode_steps} decode steps, "
          f"slot occupancy {st.occupancy:.2f})")
    if sess.paged:
        print(f"paged: peak pages {st.peak_pages_in_use}/{sess.n_pages} "
              f"prefix_hits={st.prefix_hits} "
              f"prefix_hit_tokens={st.prefix_hit_tokens} "
              f"evictions={st.evictions}")
    print(f"kernels: {sess.describe()['kernels']['counters']}")
    print("SERVE_OK")


if __name__ == "__main__":
    main()
