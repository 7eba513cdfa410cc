#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one NVIDIA GPU, the CUDA toolkit (``nvcc``) and PyTorch built for
CUDA; it imports nothing of jax or of the JAX package. In order:

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints the build time;
2. kernel phases: each kernel at the shapes the serving path gives it, in
   bf16, against its plain PyTorch version on the same inputs: every
   output element within one bf16 ulp of the plain one (``out_err``; the
   int8 phase also shows that V dequantised with the wrong scales fails
   that check), timed beside the plain version, a PyTorch
   library call computing the same attention (``library_ms``; timed only,
   never used by the port) and the least time the card could take
   (``bound_ms``, from the bytes and operations of this run's inputs);
3. serve phases: llama3.2-1b at full published width (16 layers, d_model
   2048, bf16, random weights from a seeded generator) through the port's
   ``ServeEngine``, 8 slots, ``max_seq`` 2048, 16 requests with prompts of
   64-512 tokens and 32 generated tokens each — first with the contiguous
   cache, then paged (page_size 16). Before each engine run the kernels'
   launch counters are set to 0; after it, every kernel of that layout
   must have launched and the plain-version dispatch counters must read 0.
   The first prefill step's logits are held against the same step on the
   plain versions, and across the two layouts;
4. after both timed engine runs, a torch.profiler trace of five decode
   steps in each layout (device busy share, kernels by device time).

Any failure exits non-zero before the result lines. The second-to-last line
of standard output is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Details (the nvcc log, every measured
number, profiler traces) go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core flop/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BF16_ULP = 2.0**-7  # bf16 spacing relative to the value, at most
ARCH = "llama3.2-1b"
N_REQ, GEN, SLOTS, MAX_SEQ, PAGE = 16, 32, 8, 2048, 16

SLOTTED = dict(route="cuda",
               source="src/repro_torch/kernels/csrc/slotted_attention.cu",
               replaces="src/repro/kernels/paged_attention.py:117")
PAGED = dict(route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:265")


def fail(msg: str) -> None:
    print(f"CHIP_SMOKE_FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# Timing
# --------------------------------------------------------------------------- #


def time_ms(torch, fn, flush, iters: int = 10) -> float:
    """Mean device time of one call, each call timed with its own CUDA
    events after a 128 MB write has flushed the 50 MB L2 (the serving
    path reads each layer's cache cold)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_b = nbytes / HBM_BPS * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# --------------------------------------------------------------------------- #
# Kernel phases
# --------------------------------------------------------------------------- #


def kernel_phases(torch, flush):
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, g, e, S = 8, 32, 8, 64, MAX_SEQ
    rep = h // g
    results = []

    def rand(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def sdpa(q, k, v, mask):
        """One library call: SDPA on [b, h, s, e] with K/V repeated over
        the GQA group beforehand (outside the timing)."""
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

    def record(name, meta, kern, plain, lib, nbytes, flops, check):
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        err = check(out_k, out_p)
        t_bound, by = bound(nbytes, flops, "bfloat16")
        row = dict(name=name, **meta, max_abs_err=err,
                   ms=time_ms(torch, kern, flush),
                   plain_ms=time_ms(torch, plain, flush, iters=3),
                   bound_ms=t_bound, bound_by=by,
                   library_ms=(time_ms(torch, lib, flush)
                               if lib is not None else None),
                   bytes=nbytes, flops=flops)
        lib_ms = "n/a" if lib is None else f"{row['library_ms']:.4f} ms"
        log(f"[kernel] {name}: max_abs_err {err:.3e} | kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{lib_ms}, bound {t_bound:.4f} ms ({by})")
        results.append(row)

    def excess(a, p):
        """(max |a - p|, the worst |a - p| / limit) with the elementwise
        limit BF16_ULP * (|p| + mean |p|): both sides round the same
        float32 value to bf16 up to summation order, so they differ by at
        most one ulp; the mean term covers values near zero."""
        a, p = a.float(), p.float()
        diff = (a - p).abs()
        typ = p.abs().mean().item()
        worst = (diff / (BF16_ULP * (p.abs() + typ))).max().item()
        log(f"[kernel]   max |diff| {diff.max().item():.3e}, mean |plain| "
            f"{typ:.3e}, max |plain| {p.abs().max().item():.3e}, worst "
            f"|diff| / limit {worst:.4f}")
        return diff.max().item(), worst

    def out_err(a, p):
        err, worst = excess(a, p)
        if not worst <= 1.0:                           # NaN fails too
            fail(f"kernel disagrees with its plain version: |diff| up to "
                 f"{worst} x the limit")
        return err

    def causal_pairs(pos, sq, limit):
        """Visible (query, key) pairs of causal rows at pos + i."""
        i = torch.arange(sq, device=dev)
        return int((pos[:, None] + i[None, :] + 1).clamp(max=limit).sum())

    # ---- slotted attention (contiguous cache) --------------------------- #
    for phase, sq in (("causal_prefill", 512), ("decode", 1)):
        q = rand(b, sq, h, e)
        k, v = rand(b, S, g, e), rand(b, S, g, e)
        if sq > 1:
            pos = torch.linspace(0, S - sq, b, device=dev).int()
        else:
            pos = (128 + 256 * torch.arange(b, device=dev)).int()
        keys = (pos + sq).clamp(max=S)
        kpos = torch.arange(S, device=dev)
        mask = (kpos[None, None, :] <= (pos[:, None] + torch.arange(
            sq, device=dev))[:, :, None])[:, None]
        nbytes = (2 * q.nbytes + pos.nbytes
                  + int(keys.sum()) * g * 2 * e * 2)
        flops = causal_pairs(pos, sq, S) * h * 2 * (e + e)
        log(f"[kernel] slotted_attention:{phase} b={b} sq={sq} h={h} g={g} "
            f"e={e} S={S} pos={pos.tolist()} (tolerance |diff| <= 2^-7 "
            "(|plain| + mean |plain|) per element)")
        record(f"slotted_attention:{phase}", SLOTTED,
               lambda: pa.flash_attention_slotted(q, k, v, pos=pos),
               lambda: ref.attention(q, k, v, q_offset=pos),
               sdpa(q, k, v, mask), nbytes, flops, out_err)

    # window + stats (decode-attention contract, pos = cache length)
    q = rand(b, 1, h, e)
    k, v = rand(b, S, g, e), rand(b, S, g, e)
    cl = (128 + 256 * torch.arange(b, device=dev)).int()
    wmask = (torch.arange(S, device=dev)[None, :] < cl[:, None])[:, None,
                                                                 None]

    def stats_err(a, p):
        (oa, (ma, la, aa)), (op, (mp, lp, ap)) = a, p
        err = out_err(oa, op)
        for x, y, what in ((ma, mp, "m"), (la, lp, "l"), (aa, ap, "acc")):
            rel = ((x - y).abs().max() / y.abs().max()).item()
            if not rel <= 1e-4:
                fail(f"window stats {what}: max |diff| / max |plain| = "
                     f"{rel} > 1e-4")
        return err

    log(f"[kernel] slotted_attention:window_stats b={b} sq=1 cache_len="
        f"{cl.tolist()} (out: |diff| <= 2^-7 (|plain| + mean |plain|) per "
        "element; m, l, acc: max |diff| <= 1e-4 * max |plain|)")
    record("slotted_attention:window_stats", SLOTTED,
           lambda: pa.decode_attention(q, k, v, cl),
           lambda: ref.decode_attention(q, k, v, cl),
           sdpa(q, k, v, wmask),
           2 * q.nbytes + cl.nbytes + int(cl.sum()) * g * 2 * e * 2
           + b * h * (2 + e) * 4,
           int(cl.sum()) * h * 2 * (e + e), stats_err)

    # ---- paged attention (page pool) ------------------------------------ #
    ppr = S // PAGE
    n_pages = b * ppr

    def paged_inputs(sq, int8):
        q = rand(b, sq, h, e)
        kf, vf = rand(n_pages, PAGE, g, e), rand(n_pages, PAGE, g, e)
        if sq > 1:
            pos = torch.linspace(0, S - sq, b, device=dev).int()
        else:
            pos = (128 + 256 * torch.arange(b, device=dev)).int()
        live = (pos + sq + PAGE - 1) // PAGE
        perm = torch.randperm(n_pages, generator=gen, device=dev)
        pt = perm.reshape(b, ppr).int()
        pt = torch.where(torch.arange(ppr, device=dev)[None] < live[:, None],
                         pt, 0).int()                  # sentinel tails
        mask = torch.ones(b, dtype=torch.bool, device=dev)
        mask[3] = False
        pt[3] = pt[0]                                  # stale table
        ks = vs = None
        if int8:
            ks = kf.float().abs().amax(dim=(1, 3)) / 127.0
            vs = vf.float().abs().amax(dim=(1, 3)) / 127.0
            kf = (kf.float() / ks[:, None, :, None]).round().to(torch.int8)
            vf = (vf.float() / vs[:, None, :, None]).round().to(torch.int8)
        return q, kf, vf, ks, vs, pt, pos, mask, live

    for phase, sq, int8 in (("bf16_decode", 1, False),
                            ("bf16_prefill", 512, False),
                            ("int8_decode", 1, True)):
        q, kp, vp, ks, vs, pt, pos, mask, live = paged_inputs(sq, int8)
        kw = dict(page_tables=pt, pos=pos, k_scale=ks, v_scale=vs,
                  slot_mask=mask)
        on = mask.nonzero().reshape(-1)
        item = kp.element_size()
        nbytes = (2 * q.nbytes + pt.nbytes + pos.nbytes + mask.nbytes
                  + int(live[on].sum()) * PAGE * g * 2 * e * item
                  + (2 * int(live[on].sum()) * g * 4 if int8 else 0))
        flops = causal_pairs(pos[on], sq, S) * h * 2 * (e + e)
        kg = ref.paged_gather(kp, pt, ks).to(bf)
        vg = ref.paged_gather(vp, pt, vs).to(bf)
        off = torch.where(mask, pos, -sq)
        pmask = (torch.arange(kg.shape[1], device=dev)[None, None, :]
                 <= (off[:, None] + torch.arange(sq, device=dev))[:, :, None]
                 )[:, None]

        def check(a, p, mask=mask):
            err = out_err(a, p)
            if a[~mask].any():
                fail("paged kernel: a masked row is not exactly zero")
            return err

        log(f"[kernel] paged_attention:{phase} b={b} sq={sq} h={h} g={g} "
            f"e={e} page_size={PAGE} ppr={ppr} n_pages={n_pages} "
            f"pos={pos.tolist()} masked_row=3 (tolerance |diff| <= 2^-7 "
            "(|plain| + mean |plain|) per element, masked row exactly 0)")
        record(f"paged_attention:{phase}", PAGED,
               lambda: pa.paged_attention(q, kp, vp, **kw),
               lambda: ref.paged_attention(q, kp, vp, **kw),
               sdpa(q, kg, vg, pmask), nbytes, flops, check)
        if int8:
            # the check must see V dequantised with the wrong scales: K's,
            # or those of the next kv head
            plain = ref.paged_attention(q, kp, vp, **kw)
            for what, bad in (("K's scales", ks),
                              ("the next kv head's scales",
                               vs.roll(1, dims=1).contiguous())):
                log(f"[kernel] int8 check, V dequantised with {what}:")
                _, worst = excess(pa.paged_attention(
                    q, kp, vp, **dict(kw, v_scale=bad)), plain)
                if not worst > 1.0:
                    fail(f"the int8 check passes V dequantised with {what}")
    return results


# --------------------------------------------------------------------------- #
# Serve phases
# --------------------------------------------------------------------------- #


def workload():
    import numpy as np

    rng = np.random.RandomState(0)
    lens = rng.randint(64, 513, size=N_REQ)
    return [rng.randint(0, 128256, size=int(n)).astype(np.int32)
            for n in lens]


def first_step(torch, sess, params):
    """Logits of one prefill step on fresh caches: slot 0 takes the first
    prompt at position 0, the other slots are masked."""
    import numpy as np

    prompt = workload()[0]
    n = sess.max_slots
    toks = np.zeros((n, prompt.size), np.int32)
    toks[0] = prompt
    batch = {"tokens": toks, "pos": np.zeros(n, np.int32),
             "slot_mask": np.arange(n) == 0}
    if sess.paged:
        batch["page_tables"] = np.arange(
            n * sess.pages_per_slot, dtype=np.int32).reshape(n, -1)
    caches = sess.init_caches()
    _, logits, _ = sess.serve_step_batched(params, caches, batch,
                                           want_logits=True)
    del caches
    torch.cuda.empty_cache()
    return logits[0].float()


def profile_decode(torch, sess, params, layout, steps=5):
    """Trace ``steps`` decode steps (8 active slots at position 1024, on
    fresh caches) with torch.profiler; prints the device busy share of the
    window and the kernels by device time, writes a chrome trace."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    caches = sess.init_caches()
    n = sess.max_slots
    batch = {"tokens": np.ones((n, 1), np.int32),
             "pos": np.full(n, 1024, np.int32),
             "slot_mask": np.ones(n, bool)}
    if sess.paged:
        batch["page_tables"] = np.arange(
            n * sess.pages_per_slot, dtype=np.int32).reshape(n, -1)
    sess.serve_step_batched(params, caches, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sess.serve_step_batched(params, caches, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    dev = [(e.key, e.self_device_time_total, e.count) for e in kern]
    busy = sum(t for _, t, _ in dev)
    log(f"[profile] {layout} decode: {wall_us / steps / 1e3:.2f} ms a step "
        f"under the profiler, device busy {busy / wall_us:.3f} of it, "
        f"{sum(c for *_, c in dev) / steps:.0f} kernels a step")
    top = sorted(dev, key=lambda r: -r[1])[:12]
    for name, t, c in top:
        log(f"[profile]   {t / steps / 1e3:8.3f} ms/step {c // steps:5d}x "
            f"{name[:90]}")
    prof.export_chrome_trace(str(OUT / f"decode_trace_{layout}.json"))
    return dict(layout=layout, step_ms=wall_us / steps / 1e3,
                busy_share=busy / wall_us,
                kernels_per_step=sum(c for *_, c in dev) / steps,
                top=[dict(name=n, ms_per_step=t / steps / 1e3,
                          calls_per_step=c / steps) for n, t, c in top])


def serve_phase(torch, layout, params=None):
    import numpy as np

    from repro_torch.api import session
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    kw = dict(page_size=PAGE) if layout == "paged" else {}
    sess = session(ARCH, reduced=False, device="cuda", max_slots=SLOTS,
                   max_seq=MAX_SEQ, **kw)
    if params is None:
        t0 = time.perf_counter()
        params = sess.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        log(f"[serve] params: {sess.describe()['n_params']} "
            f"({sess.rc.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    plain = session(ARCH, reduced=False, device="cuda", max_slots=SLOTS,
                    max_seq=MAX_SEQ, overrides=dict(kernel_impl="ref"), **kw)
    lg_k = first_step(torch, sess, params)
    lg_p = first_step(torch, plain, params)
    if not bool(torch.isfinite(lg_k).all()) or lg_k.shape != (128256,):
        fail(f"{layout}: first-step logits are not finite [vocab] values")
    scale = lg_p.abs().max().item()
    d_plain = (lg_k - lg_p).abs().max().item()
    log(f"[serve] {layout}: first-step logits kernel vs plain versions: "
        f"max |diff| {d_plain:.4e} (max |logit| {scale:.3f}; tolerance "
        f"0.05 * max |logit|), argmax {int(lg_k.argmax())} vs "
        f"{int(lg_p.argmax())}")
    if d_plain > 0.05 * scale:
        fail(f"{layout}: first-step logits off the plain versions")

    times = {"prefill": [], "decode": []}
    step = sess.serve_step_batched

    def timed(params_, caches, batch, want_logits=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(params_, caches, batch, want_logits=want_logits)
        torch.cuda.synchronize()
        kind = "decode" if np.shape(batch["tokens"])[1] == 1 else "prefill"
        times[kind].append((time.perf_counter() - t0) * 1e3)
        return res

    sess.serve_step_batched = timed
    eng = sess.serve_engine(params)
    prompts = workload()
    gc.collect()                  # the previous layout's engine and caches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    base = ops.kernel_counters()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_gen=GEN) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.LAUNCHES)
    counters = {k: v - base.get(k, 0) for k, v in ops.kernel_counters().items()
                if v - base.get(k, 0)}
    outs = [r.result(timeout=1) for r in reqs]
    st = eng.stats
    if st.finished_requests != N_REQ or any(len(o) != GEN for o in outs):
        fail(f"{layout}: {st.finished_requests}/{N_REQ} requests finished")
    if any(not 0 <= t < 128256 for o in outs for t in o):
        fail(f"{layout}: token ids outside the vocabulary")
    need = "paged_attention" if layout == "paged" else "slotted_attention"
    if launches[need] == 0:
        fail(f"{layout}: the engine run never launched {need}")
    if any(k.startswith("ref_") for k in counters):
        fail(f"{layout}: the engine run reached a plain version: {counters}")
    sess.serve_step_batched = step
    res = dict(
        layout=layout, wall_s=wall, generated_tokens=st.generated_tokens,
        tok_per_s=st.generated_tokens / wall,
        prefill_steps=st.prefill_steps, decode_steps=st.decode_steps,
        prefill_step_ms=sum(times["prefill"]) / max(len(times["prefill"]), 1),
        decode_step_ms=sum(times["decode"]) / max(len(times["decode"]), 1),
        max_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, counters=counters, first_logits_vs_plain=d_plain)
    log(f"[serve] {layout}: {N_REQ} requests, {st.generated_tokens} tokens "
        f"in {wall:.3f} s = {res['tok_per_s']:.1f} tok/s; "
        f"{st.prefill_steps} prefill steps of {res['prefill_step_ms']:.2f} "
        f"ms, {st.decode_steps} decode steps of {res['decode_step_ms']:.2f} "
        f"ms; peak memory {res['max_memory_gb']:.2f} GiB; launches "
        f"{launches}; dispatch {counters}")
    return res, outs, lg_k, params, sess


# --------------------------------------------------------------------------- #


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no "
             "src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    t_build = time.perf_counter() - t0
    per_lib = {n: round(v["seconds"], 1) for n, v in build.BUILD_LOG.items()}
    log(f"[build] {len(paths)} kernel libraries in {t_build:.1f} s, nvcc "
        f"per source {per_lib or 'none (already built)'}")
    (OUT / "kernel_build.log").write_text("\n".join(
        f"=== {n} ({v['seconds']:.1f} s)\n{v['log']}"
        for n, v in build.BUILD_LOG.items()))

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    kernels = kernel_phases(torch, flush)
    del flush
    torch.cuda.empty_cache()
    contig, outs_c, lg_c, params, sess_c = serve_phase(torch, "contiguous")
    paged, outs_p, lg_p, _, sess_p = serve_phase(torch, "paged", params)
    d = (lg_c - lg_p).abs().max().item()
    agree = sum(a == b for oc, op in zip(outs_c, outs_p)
                for a, b in zip(oc, op)) / (N_REQ * GEN)
    log(f"[serve] contiguous vs paged: first-step logits max |diff| "
        f"{d:.4e} (tolerance 0.05 * max |logit| = "
        f"{0.05 * lg_c.abs().max().item():.4f}); token agreement "
        f"{agree:.4f}")
    if d > 0.05 * lg_c.abs().max().item():
        fail("contiguous and paged first-step logits disagree")
    serve = [contig, paged]
    for row in kernels:
        lay = contig if row["name"].startswith("slotted") else paged
        row["launches"] = lay["launches"][row["name"].split(":")[0]]
    # after every timed run: the profiler slows what follows it
    profiles = [profile_decode(torch, s, params, r["layout"])
                for r, s in ((contig, sess_c), (paged, sess_p))]
    OUT.joinpath("chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": t_build, "kernels": kernels,
         "serve": serve, "profiles": profiles,
         "wall_s": time.perf_counter() - t_start}, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
