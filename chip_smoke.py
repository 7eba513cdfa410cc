#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one NVIDIA GPU, the CUDA toolkit (``nvcc``) and PyTorch built for
CUDA; it imports nothing of jax or of the JAX package. In order:

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints the build time, and
   for the entry functions of the attention kernels, K2 and K5 their
   registers and spills (ptxas) and tensor-core instructions
   (``cuobjdump -sass``): the serving kernels' bf16 entries (the window
   + stats contract's included), K2's in both head layouts and K1/K1b's
   at head dims 96 and 128 must hold HGMMA (wgmma), and those K2 and
   K1/K1b entries and K5's must not spill;
2. kernel phases: each kernel at the shapes its path gives it, against
   its plain PyTorch version on the same inputs — the serving attention
   kernels (K3 slotted at head_dim 64 and 128, K4 paged), the training
   kernels (K1 flash forward, K1b flash backward, K2 fused cross-entropy)
   in bf16 at llama3.2-1b's shapes, K1 and K1b at gpt-1.5B's (b 2, s
   1024, 24 heads of 96) and at head dim 128, K2 over gpt-1.5B's untied
   head [2304, 50304] read in place, K2's two passes apart over one of
   two vocabulary shards (the sharded loss: 2048 gathered rows over
   64,128 rows of llama's table, and over a [2304, 25152] block of
   gpt-1.5B's head.w), and the selective scan (K5) in
   float32 — each timed beside
   the plain version, a PyTorch library call computing the same function
   (``library_ms``; timed only, never used by the port; none exists for
   the scan) and the least time the card could take (``bound_ms``, from
   the bytes and operations of this run's inputs); times are device time
   with the L2 flushed and the host's launch overhead kept out. The K3/K4
   decode phases are also timed at other key-split counts.
   Tolerances: the bf16 outputs of the tensor-core bodies (K3 and K4
   out, K1 out, K1b dq, dk, dv) element by element within 1e-2 of the
   largest |plain| of the element's row plus one bf16 ulp for a bf16
   out (``flash_attention.bf16_excess``: they round P, and dS, to bf16,
   as FlashAttention does; SDPA's own error against the same plain
   version is printed beside it); K3's window + stats contract (the
   same tensor-core body, its stats merged over the key splits) by
   ``paged_attention.window_excess``: out and acc by that row rule, m
   and l within 1e-4 of the largest |plain|, and a row with no key at m
   = -inf and exact zeros; K1's log-sum-exp within 1e-5 relative;
   K2's float32 outputs within 1e-4 of the plain tensor's largest value
   (1e-5 relative for its loss; the bf16 body splits h and dlog into
   two bf16 terms each to hold that rule on the tensor cores); K5's y
   and final state within 1e-5 of the plain tensor's largest value, and
   K5 chained over two halves with h0 equal bit for bit to one pass over
   the whole; K5's phase also logs its resident warps an SM (ptxas
   registers and block size, and the CUDA occupancy query) and its MUFU
   floor. Probes that must fail
   the checks: K with its kv heads rolled by one and V rolled over kv
   heads at the keys of the second half only (K3, K1; for the window
   contract also one extra key, caught by l), one live
   page-table entry pointed at another row's page and, for int8 pages,
   V dequantised with K's or the next kv head's scales (K4), the
   neighbouring q head's log-sum-exp and K rolled over kv heads at the
   keys of the second half (K1b), the head shifted by one vocab tile
   and h rounded to bf16, i.e. no lo term, and the untied head's bytes
   read as a [vocab, d] table (K2), labels not shifted to their shard
   (K2 over a shard, whose shards' statistics, combined with a max and a
   sum, must also equal the whole-vocab K2's loss, dh and dW), B and C
   swapped (K5);
3. serve phases: llama3.2-1b at full published width (16 layers, d_model
   2048, bf16, random weights from a seeded generator) through the port's
   ``ServeEngine``, 8 slots, ``max_seq`` 2048, 16 requests with prompts of
   64-512 tokens and 32 generated tokens each — first with the contiguous
   cache, then paged (page_size 16). Before each engine run the kernels'
   launch counters are set to 0; after it, every kernel of that layout
   must have launched and the plain-version dispatch counters must read 0.
   The first prefill step's logits are held against the same step on the
   plain versions, and across the two layouts;
4. train phase: llama3.2-1b at full width through the train Session
   (zeropp, vpp 2, 4 micro-batches of one 2048-token sequence in units of
   2, bf16 params and compute, float32 master and moments): step 1 runs
   twice on the same params and batch, through the kernels and through
   the plain versions, and the loss and every gradient must agree; then
   five timed steps (train_step + opt_step) with the launch counters set
   to 0 before them: K1, K1b and K2 must launch 128, 64 and 8 times a
   step, no plain version may run, every loss must be finite and step
   1's near ln(vocab). Then the same for the paper's gpt-1.5B at full
   width (22 layers, d_model 2304, 24 heads of 96, LayerNorm, GELU MLP,
   untied head; 4 micro-batches of two 1024-token sequences), after
   llama's session, params and optimizer state are freed: K1, K1b and
   K2 176, 88 and 8 times a step, step 1's loss near ln(vocab) + 1/2;
5. Jamba serve phase, after the training state is freed:
   jamba-v0.1-52b at its published widths cut to depth 8 (one period:
   Mamba, attention and gathered-MoE layers; 26.6 GB of bf16 weights
   from a seeded generator) through the ``ServeEngine`` with the same 8
   slots, ``max_seq`` 2048 and 16 requests. The launch counters are set
   to 0 before the engine run; after it K5 must have launched 7 times a
   prefill step (one per Mamba layer), K3 once a step, and no plain
   version may have run. The first prefill step's logits are held
   against the same step on the plain versions;
6. after every timed run, torch.profiler traces: five decode steps and
   three 512-token prefill steps in each llama serving layout and in
   Jamba (device busy share, kernels by device time, and the device
   kernels of K3/K4 with the key-split combine, and of K5, by name), and one
   training step of each training model on fresh params (device busy
   share, kernels by device time, launches a step, and the device time
   of K1, K1b and K2, K2 also by pass: the split, pass 1, pass 2);
7. multi-rank train phase, last, with the card otherwise empty:
   llama3.2-1b at full width and depth on data 2 x pp 2 — four ranks,
   spawned by ``python -m repro_torch.launch.train --full --data 2 --pp
   2 --seq 1024 --backend gloo --steps 3`` as a subprocess, all on this
   card, collectives staged through host memory (gloo); seq cut from
   2048 to 1024 for four ranks' memory. Before it, one one-rank step of
   the same params and batch runs here; rank 0's step-1 loss must agree
   with it within 2e-3 relative and its pre-clip grad norm within 1e-2,
   every rank must have launched K1 and K1b and the last stage's ranks
   K2 over their vocabulary shard, no plain version may run, and the
   subprocess must exit 0. Steps 2-3 (ms, tokens/s: no throughput claim,
   gloo sets it) and each rank's peak memory are logged.

Any failure exits non-zero before the result lines. The second-to-last line
of standard output is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Details (the nvcc log, every measured
number, profiler traces) go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core flop/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clocks: covers a call's enqueue
ARCH = "llama3.2-1b"
N_REQ, GEN, SLOTS, MAX_SEQ, PAGE = 16, 32, 8, 2048, 16

# the serving kernels' bf16 tensor-core entry functions (slotted_win_*:
# the window + stats contract)
TC_SERVE = ("slotted_tc_e64", "slotted_tc_e128", "slotted_win_e64",
            "slotted_win_e128", "paged_tc_bf16", "paged_tc_int8")
# K2's bf16 tensor-core entry functions in both head layouts (a [V, d]
# table, a [d, V] head), and its split and lse kernels
TC_XENT = tuple(f"{k}<{lay}>" for k in ("stats_tc", "dlog_tc", "dw_tc",
                                         "dh_tc")
                for lay in ("table", "head"))
# K1's and K1b's bf16 tensor-core entries at the head widths this slice
# added (96 runs the 128-wide body with zero pad columns)
TC_FLASH_WIDE = tuple(f"{k}<{e},{e}>" for k in ("flash_fwd_tc", "dq_tc",
                                                 "dkdv_tc")
                      for e in (96, 128))
XENT_PASSES = {"split": ("xent_split",),
               "pass 1": ("stats_tc", "lse_kernel"),
               "pass 2": ("dlog_tc", "dw_tc", "dh_tc")}
# device kernels of each serving kernel, by name, for the serve profiles
SERVE_KERNELS = {"K3 slotted_attention": ("slotted_tc", "slotted_kernel"),
                 "K4 paged_attention": ("paged_tc", "paged_kernel"),
                 "K3/K4 key-split combine": ("combine_e",),
                 "K5 selective_scan": ("::scan_kernel<",)}
SLOTTED = dict(route="cuda",
               source="src/repro_torch/kernels/csrc/slotted_attention.cu",
               replaces="src/repro/kernels/paged_attention.py:117")
PAGED = dict(route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:265")
FLASH_FWD = dict(route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
                 replaces="src/repro/kernels/flash_attention.py:82")
FLASH_BWD = dict(route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 replaces="src/repro/core/tape.py:134")
XENT = dict(route="cuda", source="src/repro_torch/kernels/csrc/fused_xent.cu",
            replaces="src/repro/kernels/fused_xent.py:109")
SCAN = dict(route="cuda",
            source="src/repro_torch/kernels/csrc/selective_scan.cu",
            replaces="src/repro/kernels/selective_scan.py:57")
JAMBA, JAMBA_VOCAB, MAMBA_LAYERS = "jamba-v0.1-52b", 65536, 7
SCAN_B, SCAN_S, SCAN_D, SCAN_N = 8, 512, 8192, 16
# K5 vs its plain version: both compute in float32, the kernel one step at
# a time, the plain version in doubling steps inside chunks of 256, so y
# and the state differ by float32 rounding only
SCAN_RTOL = 1e-5
TRAIN_SEQ, TRAIN_STEPS = 2048, 5
# launches a training step: 16 layers x 4 micro-batches x (F + B's
# recompute) forwards, one backward per layer and micro-batch, two passes
# of the loss per micro-batch
TRAIN_LAUNCHES = {"flash_attention_fwd": 128, "flash_attention_bwd": 64,
                  "fused_xent": 8}
# the training cells: llama3.2-1b (4 sequences of 2048 a step, tied
# head) and the paper's gpt-1.5B (8 of 1024, untied head; 22 layers, so
# 22 x 4 x 2, 22 x 4 and 8 launches a step). loss0: step 1's expected
# loss on random weights, ln(vocab) for llama's near-zero logits (tied
# table, std 1/sqrt(vocab)) and ln(vocab) + 1/2 for gpt's unit-variance
# logits (final LayerNorm, a 1/sqrt(d) head: E[lse] = ln V + var / 2);
# step 1 must land within 0.5 of it
LLAMA = dict(arch=ARCH, seq=TRAIN_SEQ, global_batch=4, vocab=128256,
             launches=TRAIN_LAUNCHES, loss0=math.log(128256))
GPT = dict(arch="gpt_paper", seq=1024, global_batch=8, vocab=50304,
           d_model=2304,
           launches={"flash_attention_fwd": 176, "flash_attention_bwd": 88,
                     "fused_xent": 8}, loss0=math.log(50304) + 0.5)
# device kernels of each training kernel, by name, for the step's profile
TRAIN_KERNELS = {"K1 flash_attention_fwd": ("flash_fwd_tc",),
                 "K1b flash_attention_bwd": ("dq_tc", "dkdv_tc"),
                 "K2 fused_xent": sum(XENT_PASSES.values(), ())}
# the multi-rank train phase: llama3.2-1b at full width and depth on data
# 2 x pp 2 (4 ranks, one process each, all on this card over gloo), seq
# 1024 for four ranks' memory on one card; zeropp, vpp 2, 4 micro-batches
# of one sequence in units of 2 a data rank: 8 x 1024 tokens a step
MULTI = dict(arch=ARCH, data=2, pp=2, seq=1024, global_batch=8, steps=3,
             backend="gloo")
# rank 0's step 1 against one one-rank step of the same params and batch
# (pp 1, vpp 2, micro-batches of 2 sequences): bf16 compute in other
# micro-batch shapes and stage boundaries, and the reductions in another
# order, so the loss agrees to about a bf16 rounding of the logits and
# the norm of 1.24 B gradient elements to about a percent
MULTI_LOSS_RTOL, MULTI_NORM_RTOL = 2e-3, 1e-2
# kernel vs plain versions on step 1: loss within 1e-3 relative; each
# gradient within 5e-2 of the plain tensor's largest value. Both paths
# round the same float32 values to bf16 up to summation order, so their
# activations differ by about one bf16 ulp (2^-8) here and there; the
# backward through 16 bf16 layers carries such differences into every
# gradient, and 5e-2 is about a dozen ulps of the largest value.
STEP1_LOSS_RTOL, STEP1_GRAD_RTOL = 1e-3, 5e-2


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
    path reads each layer's cache cold). A device-side spin of about a
    millisecond after the flush keeps the card busy while the host enqueues
    the start event and the call, so the host's launch overhead stays out
    of the device time."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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


def rel_excess(a, p, rtol: float, what: str) -> tuple[float, float]:
    """(max |a - p|, max |a - p| / (rtol * max |p|)) for float32 outputs
    summed in another order than the plain version's."""
    diff = (a.float() - p.float()).abs().max().item()
    scale = p.float().abs().max().item()
    worst = diff / (rtol * scale) if scale > 0 else float(diff > 0) * 1e30
    log(f"[kernel]   {what}: max |diff| {diff:.3e}, max |plain| "
        f"{scale:.3e}, worst |diff| / ({rtol:g} max |plain|) {worst:.4f}")
    return diff, worst


def rel_err(a, p, rtol: float, what: str) -> float:
    diff, worst = rel_excess(a, p, rtol, what)
    if not worst <= 1.0:
        fail(f"{what}: kernel off its plain version by {worst} x the "
             "limit")
    return diff


def bf16_excess(fa, a, p, what: str) -> tuple[float, float]:
    """(max |a - p|, the worst |a - p| / limit) under the bf16 flash
    kernels' rule (``flash_attention.bf16_excess``: BF16_RTOL of the
    largest |plain| of the element's row, one position of one head, plus
    one bf16 ulp where the plain output is bf16). The tensor-wide reading
    against BF16_RTOL * max |plain| is logged beside it for the record."""
    diff = (a.float() - p.float()).abs().max().item()
    worst = fa.bf16_excess(a, p)
    wide = diff / (fa.BF16_RTOL * p.float().abs().max().item())
    log(f"[kernel]   {what}: max |diff| {diff:.3e}, worst |diff| / row "
        f"limit {worst:.4f} (tensor-wide |diff| / ({fa.BF16_RTOL:g} max "
        f"|plain|) {wide:.4f})")
    return diff, worst


def bf16_err(fa, a, p, what: str) -> float:
    diff, worst = bf16_excess(fa, a, p, what)
    if not worst <= 1.0:
        fail(f"{what}: kernel off its plain version by {worst} x the "
             "limit")
    return diff


def bf16_probe(fa, bad, plain, whats, probe: str) -> None:
    """Each output of a run fed a deliberate fault must fail the check."""
    log(f"[kernel] check, {probe}:")
    for a, p, what in zip(bad, plain, whats):
        if not bf16_excess(fa, a, p, what)[1] > 1.0:
            fail(f"the {what} check passes {probe}")


def late_rolled(x):
    """x [b, s, kv heads, e] with its kv heads rolled by one at the keys
    of the second half: a fault of late tiles only."""
    x = x.clone()
    half = x.shape[1] // 2
    x[:, half:] = x[:, half:].roll(1, dims=2)
    return x


def record_phase(torch, flush, results, name, meta, kern, plain, lib,
                 nbytes, flops, check, iters=10, plain_iters=3,
                 dtype="bfloat16"):
    """Check the kernel against its plain version, then time kernel,
    plain version and library call; appends the phase's row. ``dtype``
    picks the peak rate of the operations' bound."""
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    err = check(out_k, out_p)
    del out_k, out_p
    t_bound, by = bound(nbytes, flops, dtype)
    row = dict(name=name, **meta, max_abs_err=err,
               ms=time_ms(torch, kern, flush, iters),
               plain_ms=time_ms(torch, plain, flush, plain_iters),
               bound_ms=t_bound, bound_by=by,
               library_ms=(time_ms(torch, lib, flush, iters)
                           if lib is not None else None),
               bytes=nbytes, flops=flops)
    lib_ms = "n/a" if lib is None else f"{row['library_ms']:.4f} ms"
    log(f"[kernel] {name}: max_abs_err {err:.3e} | kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
        f"{lib_ms}, bound {t_bound:.4f} ms ({by})")
    results.append(row)


def kernel_resources(build, names=("slotted_attention", "paged_attention",
                                   "flash_attention_fwd",
                                   "flash_attention_bwd",
                                   "fused_xent", "selective_scan")) -> dict:
    """Per entry function of the named libraries (keyed "library:name";
    the serving float32 attention bodies' instantiations share one name;
    K1/K1b's are named by their head widths, K2's by their head layout,
    K5's by their template arguments): registers and spill bytes
    from the ptxas log of this run's build, and the tensor-core
    instructions (HGMMA: wgmma; HMMA: mma.sync) in its SASS from
    cuobjdump (None where the toolkit has no cuobjdump). Fails if a
    serving kernel's (the window contract's included), K2's (either head
    layout) or a 96- or 128-wide K1/K1b bf16 tensor-core entry has no
    HGMMA, or one of those K2 or K1/K1b entries or a K5 entry spills."""
    import os
    import re

    short = TC_SERVE + ("combine_e64", "combine_e128", "combine_stats_e64",
                        "combine_stats_e128", "slotted_kernel",
                        "paged_kernel", "xent_split", "lse_kernel")
    # K1/K1b by head widths <E,EV>; K2 by head layout <0: table, 1: head>
    flash = re.compile(r"(flash_fwd_tc|flash_fwd_kernel|dq_tc|dkdv_tc|"
                       r"dq_kernel|dkdv_kernel)ILi(\d+)ELi(\d+)E")
    xent = re.compile(r"(stats_tc|dlog_tc|dw_tc|dh_tc|stats_kernel|"
                      r"dlog_kernel|dw_kernel|dh_kernel)ILi([01])E")

    def name_of(lib, mangled):
        m = re.search(r"scan_kernelILi(\d+)ELb([01])E", mangled)
        if m:    # K5: scan_kernel<N, 16-byte copies>
            return (f"{lib}:scan_kernel<{m.group(1)},"
                    f"{'true' if m.group(2) == '1' else 'false'}>")
        m = flash.search(mangled)
        if m:
            return f"{lib}:{m.group(1)}<{m.group(2)},{m.group(3)}>"
        m = xent.search(mangled)
        if m:
            return (f"{lib}:{m.group(1)}"
                    f"<{('table', 'head')[int(m.group(2))]}>")
        return f"{lib}:" + next((k for k in short if k in mangled),
                                mangled[:60])

    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    res = {}
    for lib in names:
        fn = None
        for line in build.BUILD_LOG.get(lib, {}).get("log", "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = name_of(lib, m.group(1))
                res[fn] = dict(library=lib, hgmma=None, hmma=None)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                res[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                res[fn]["registers"] = int(m.group(1))
        if not os.path.exists(cuobjdump):
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(build.lib_path(lib))],
                              capture_output=True, text=True, timeout=120)
        fn = None
        for line in sass.stdout.splitlines():
            if "Function :" in line:
                fn = name_of(lib, line.split("Function :")[1].strip())
                res.setdefault(fn, dict(library=lib))
                res[fn].update(hgmma=0, hmma=0)
            elif fn and " HGMMA." in line:
                res[fn]["hgmma"] += 1
            elif fn and " HMMA." in line:
                res[fn]["hmma"] += 1
    for fn, r in res.items():
        sass = ("not measured" if r.get("hgmma") is None else
                f"HGMMA {r['hgmma']}, HMMA {r['hmma']}")
        log(f"[build] {fn}: {r.get('registers')} registers, "
            f"{r.get('spill_bytes')} spill bytes; SASS {sass}")
    for k in TC_SERVE:
        lib = "paged_attention" if k.startswith("paged") else \
            "slotted_attention"
        r = res.get(f"{lib}:{k}")
        if r is None:
            fail(f"the {lib} build has no entry function {k}")
        if r.get("hgmma") == 0:
            fail(f"{lib}:{k} has no HGMMA (wgmma) in its SASS")
    for k in TC_XENT + TC_FLASH_WIDE:
        lib = ("fused_xent" if k in TC_XENT else "flash_attention_fwd"
               if k.startswith("flash") else "flash_attention_bwd")
        r = res.get(f"{lib}:{k}")
        if r is None:
            fail(f"the {lib} build has no entry function {k}")
        if r.get("hgmma") == 0:
            fail(f"{lib}:{k} has no HGMMA (wgmma) in its SASS")
        if r.get("spill_bytes"):
            fail(f"{lib}:{k} spills {r['spill_bytes']} bytes")
    scan = [k for k in res if k.startswith("selective_scan:scan_kernel")]
    if not scan:
        fail("the selective_scan build has no scan_kernel entry")
    for k in scan:
        if res[k].get("spill_bytes"):
            fail(f"{k} spills {res[k]['spill_bytes']} bytes")
    return res


# --------------------------------------------------------------------------- #
# Kernel phases
# --------------------------------------------------------------------------- #


def kernel_phases(torch, flush):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, g, e, S = 8, 32, 8, 64, MAX_SEQ
    rep = h // g
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
        record_phase(torch, flush, results, name, meta, kern, plain, lib,
                     nbytes, flops, check)

    def causal_pairs(pos, sq, limit):
        """Visible (query, key) pairs of causal rows at pos + i."""
        i = torch.arange(sq, device=dev)
        return int((pos[:, None] + i[None, :] + 1).clamp(max=limit).sum())

    def tc_check(lib, rows=None):
        """The bf16 tensor-core rule for out, SDPA's error against the same
        plain version beside it (over ``rows``, the batch rows that see a
        key: SDPA gives NaN for a row that sees none)."""
        def check(a, p):
            sel = slice(None) if rows is None else rows
            bf16_excess(fa, lib().transpose(1, 2)[sel], p[sel],
                        "out (SDPA, for the record)")
            return bf16_err(fa, a, p, "out")
        return check

    tol = (f"tolerance: out |diff| <= {fa.BF16_RTOL:g} max |plain| of its "
           "row + 1 bf16 ulp (P rounded to bf16 on the tensor cores)")

    def split_sweep(kern):
        """A decode kernel's time against the blocks an SM that the key
        splits aim for (``paged_attention._BLOCKS_AN_SM``; 0 = no split),
        recorded beside the phase's row."""
        keep, res = pa._BLOCKS_AN_SM, {}
        try:
            for w in (0, 1, 2, 4, 8):
                pa._BLOCKS_AN_SM = w
                res[w] = (pa.splits(b, g, rep, S, sms),
                          time_ms(torch, kern, flush))
        finally:
            pa._BLOCKS_AN_SM = keep
        log("[kernel]   key splits, blocks an SM (splits): " + ", ".join(
            f"{w} ({n}) {t:.4f} ms" for w, (n, t) in res.items()))
        results[-1]["split_ms"] = {w: t for w, (_, t) in res.items()}

    # ---- slotted attention (contiguous cache) --------------------------- #
    def slotted_phase(phase, sq, hd, rand):
        q = rand(b, sq, h, hd)
        k, v = rand(b, S, g, hd), rand(b, S, g, hd)
        if sq > 1:
            pos = torch.linspace(0, S - sq, b, device=dev).int()
        else:
            pos = (128 + 256 * torch.arange(b, device=dev)).int()
        keys = (pos + sq).clamp(max=S)
        kpos = torch.arange(S, device=dev)
        mask = (kpos[None, None, :] <= (pos[:, None] + torch.arange(
            sq, device=dev))[:, :, None])[:, None]
        nbytes = (2 * q.nbytes + pos.nbytes
                  + int(keys.sum()) * g * 2 * hd * 2)
        flops = causal_pairs(pos, sq, S) * h * 2 * (hd + hd)
        ns = pa.splits(b, g, rep * sq, S, sms)
        log(f"[kernel] slotted_attention:{phase} b={b} sq={sq} h={h} g={g} "
            f"e={hd} S={S} pos={pos.tolist()} key splits {ns} ({tol})")
        lib = sdpa(q, k, v, mask)
        record(f"slotted_attention:{phase}", SLOTTED,
               lambda: pa.flash_attention_slotted(q, k, v, pos=pos),
               lambda: ref.attention(q, k, v, q_offset=pos),
               lib, nbytes, flops, tc_check(lib))
        if sq == 1:
            split_sweep(lambda: pa.flash_attention_slotted(q, k, v, pos=pos))
        # the check must see K with its kv heads rolled by one, and V
        # rolled over kv heads at the keys of the second half only (a
        # fault of late tiles: rows that see no such key stay exact)
        plain = ref.attention(q, k, v, q_offset=pos)
        bf16_probe(fa, (pa.flash_attention_slotted(
            q, k.roll(1, dims=2).contiguous(), v, pos=pos),), (plain,),
            ("slotted_attention out",), "K's kv heads rolled by one")
        bf16_probe(fa, (pa.flash_attention_slotted(
            q, k, late_rolled(v), pos=pos),), (plain,),
            ("slotted_attention out",),
            f"V rolled over kv heads at keys >= {S // 2}")

    for phase, sq in (("causal_prefill", 512), ("decode", 1)):
        slotted_phase(phase, sq, e, rand)

    # window + stats (decode-attention contract, pos = cache length): the
    # tensor-core body with key splits, its stats from the combine
    q = rand(b, 1, h, e)
    k, v = rand(b, S, g, e), rand(b, S, g, e)
    cl = (128 + 256 * torch.arange(b, device=dev)).int()
    wmask = (torch.arange(S, device=dev)[None, :] < cl[:, None])[:, None,
                                                                 None]
    win_sdpa = sdpa(q, k, v, wmask)

    def window_excess(a, p, what=""):
        res = pa.window_excess(a, p)
        log(f"[kernel]   window stats{what}: worst |diff| / limit " + ", "
            .join(f"{n} {x:.4f}" for n, x in res.items()))
        return res

    def window_check(a, p):
        bf16_excess(fa, win_sdpa().transpose(1, 2), p[0],
                    "out (SDPA, for the record)")
        res = window_excess(a, p)
        if not max(res.values()) <= 1.0:
            fail(f"window stats off the plain version: {res}")
        return (a[0].float() - p[0].float()).abs().max().item()

    ns = pa.splits(b, g, rep, S, sms)
    log(f"[kernel] slotted_attention:window_stats b={b} sq=1 h={h} g={g} "
        f"e={e} S={S} cache_len={cl.tolist()} key splits {ns} (tensor-core "
        f"body; {tol}; acc by the same row rule; m, l: max |diff| <= "
        f"{pa.STATS_RTOL:g} max |plain|)")
    record("slotted_attention:window_stats", SLOTTED,
           lambda: pa.decode_attention(q, k, v, cl),
           lambda: ref.decode_attention(q, k, v, cl),
           win_sdpa,
           2 * q.nbytes + cl.nbytes + int(cl.sum()) * g * 2 * e * 2
           + b * h * (2 + e) * 4,
           int(cl.sum()) * h * 2 * (e + e), window_check)
    # a row with no key: m = -inf, and l, acc and out exactly 0
    cl0 = cl.clone()
    cl0[0] = 0
    got0 = pa.decode_attention(q, k, v, cl0)
    res = window_excess(got0, ref.decode_attention(q, k, v, cl0),
                        " (cache_len[0] = 0)")
    out0, (m0, l0, acc0) = got0
    if not (max(res.values()) <= 1.0 and bool(torch.isneginf(m0[0]).all())
            and not l0[0].any() and not acc0[0].any()
            and not out0[0].any()):
        fail("window stats: a row with cache_len 0 is not m = -inf and "
             "exact zeros")
    # probes: one extra key (caught by l), K rolled over kv heads, V
    # rolled over kv heads at the late keys
    plain = ref.decode_attention(q, k, v, cl)
    for what, bad, field in (
            ("cache_len + 1", pa.decode_attention(q, k, v, cl + 1), "l"),
            ("K's kv heads rolled by one", pa.decode_attention(
                q, k.roll(1, dims=2).contiguous(), v, cl), "out"),
            (f"V rolled over kv heads at keys >= {S // 2}",
             pa.decode_attention(q, k, late_rolled(v), cl), "out")):
        log(f"[kernel] window stats check, {what}:")
        if not window_excess(bad, plain)[field] > 1.0:
            fail(f"the window stats {field} check passes {what}")

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
        lib = sdpa(q, kg, vg, pmask)
        tc = tc_check(lib, on)

        def check(a, p, mask=mask, tc=tc):
            err = tc(a, p)
            if a[~mask].any():
                fail("paged kernel: a masked row is not exactly zero")
            return err

        ns = pa.splits(b, g, rep * sq, S, sms)
        log(f"[kernel] paged_attention:{phase} b={b} sq={sq} h={h} g={g} "
            f"e={e} page_size={PAGE} ppr={ppr} n_pages={n_pages} "
            f"pos={pos.tolist()} masked_row=3 key splits {ns} ({tol}; "
            "masked row exactly 0)")
        record(f"paged_attention:{phase}", PAGED,
               lambda: pa.paged_attention(q, kp, vp, **kw),
               lambda: ref.paged_attention(q, kp, vp, **kw),
               lib, nbytes, flops, check)
        if sq == 1:
            split_sweep(lambda: pa.paged_attention(q, kp, vp, **kw))
        plain = ref.paged_attention(q, kp, vp, **kw)
        # the check must see one live page-table entry of one row, past
        # its first 64-key tile, pointed at a page of another row (row 7
        # sees every key of entry 5: keys 80..95)
        wrong = pt.clone()
        wrong[7, 5] = pt[0, 0]
        bf16_probe(fa, (pa.paged_attention(
            q, kp, vp, **dict(kw, page_tables=wrong)),), (plain,),
            ("paged_attention out",),
            "row 7's page-table entry 5 pointed at row 0's first page")
        if int8:
            # and V dequantised with the wrong scales: K's, or those of
            # the next kv head
            for what, bad in (("K's scales", ks),
                              ("the next kv head's scales",
                               vs.roll(1, dims=1).contiguous())):
                bf16_probe(fa, (pa.paged_attention(
                    q, kp, vp, **dict(kw, v_scale=bad)),), (plain,),
                    ("paged_attention out",),
                    f"V dequantised with {what}")

    # ---- slotted attention at head_dim 128 (jamba-v0.1-52b) ------------- #
    gen128 = torch.Generator(device=dev).manual_seed(3)

    def rand128(*shape):
        return torch.randn(shape, generator=gen128, device=dev).to(bf)

    for phase, sq in (("e128_causal_prefill", 512), ("e128_decode", 1)):
        slotted_phase(phase, sq, 128, rand128)
    return results


def train_kernel_phases(torch, flush):
    """K1, K1b and K2 at the training path's shapes (one 2048-token
    micro-batch of llama3.2-1b), each against its plain version."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    h, g, e, S = 32, 8, 64, TRAIN_SEQ
    rep = h // g
    results = []

    def rand(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def pairs(sq, sk, causal, off):
        if not causal:
            return sq * sk
        i = torch.arange(sq, device=dev)
        return int((off + i + 1).clamp(0, sk).sum())

    def rep_kv(x):
        return x.repeat_interleave(rep, dim=2).transpose(1, 2)

    # ---- K1: flash forward ---------------------------------------------- #
    for phase, causal, sq, off in (("causal", True, S, 0),
                                   ("causal_offset", True, S // 2, S // 2),
                                   ("bidirectional", False, S, 0)):
        sk = sq + off
        q, k, v = rand(1, sq, h, e), rand(1, sk, g, e), rand(1, sk, g, e)
        kw = dict(causal=causal, q_offset=off)
        n_pairs = pairs(sq, sk, causal, off)
        nbytes = 2 * q.nbytes + k.nbytes + v.nbytes + 1 * h * sq * 4
        flops = n_pairs * h * 2 * (e + e)
        qt, kt, vt = q.transpose(1, 2), rep_kv(k), rep_kv(v)
        if causal and off:
            mask = (torch.arange(sk, device=dev)[None, :]
                    <= off + torch.arange(sq, device=dev)[:, None])
        else:
            mask = None

        def lib(qt=qt, kt=kt, vt=vt, mask=mask, causal=causal, off=off):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and not off)

        def check(a, p, lib=lib):
            rel_err(a[1], p[1], 1e-5, "lse")
            bf16_excess(fa, lib().transpose(1, 2), p[0],
                        "out (SDPA, for the record)")
            return bf16_err(fa, a[0], p[0], "out")

        log(f"[kernel] flash_attention_fwd:{phase} q [1, {sq}, {h}, {e}], "
            f"k/v [1, {sk}, {g}, {e}], q_offset {off}, causal {causal} "
            f"(tolerance: out |diff| <= {fa.BF16_RTOL:g} max |plain| of its "
            "row + 1 bf16 ulp; lse 1e-5 of max |plain|)")
        record_phase(torch, flush, results, f"flash_attention_fwd:{phase}",
                     FLASH_FWD,
                     lambda q=q, k=k, v=v, kw=kw: fa.flash_attention_fwd(
                         q, k, v, **kw),
                     lambda q=q, k=k, v=v, kw=kw: ref.attention(
                         q, k, v, return_lse=True, **kw),
                     lib, nbytes, flops, check)
        if phase == "causal":
            # the check must see K with its kv heads rolled by one, and V
            # rolled over kv heads at the keys of the second half only (a
            # fault of late tiles: the first half's rows stay exact)
            plain = ref.attention(q, k, v, **kw)
            bf16_probe(fa, fa.flash_attention_fwd(
                q, k.roll(1, dims=2).contiguous(), v, **kw)[:1], (plain,),
                ("flash_attention_fwd out",), "K's kv heads rolled by one")
            bf16_probe(fa, fa.flash_attention_fwd(
                q, k, late_rolled(v), **kw)[:1], (plain,),
                ("flash_attention_fwd out",),
                f"V rolled over kv heads at keys >= {sk // 2}")

    # ---- K1b: flash backward (causal) ----------------------------------- #
    q, k, v = rand(1, S, h, e), rand(1, S, g, e), rand(1, S, g, e)
    do = rand(1, S, h, e)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    n_pairs = pairs(S, S, True, 0)
    # read q, k, v, out, do (bf16) and lse; write dq, dk, dv (float32)
    nbytes = (q.nbytes + k.nbytes + v.nbytes + out.nbytes + do.nbytes
              + lse.nbytes + 4 * (q.numel() + k.numel() + v.numel()))
    # the least work: S, dP, dV, dQ and dK over the visible pairs
    flops = n_pairs * h * 2 * (3 * e + 2 * e)
    qg = q.transpose(1, 2).detach().requires_grad_()
    kg = rep_kv(k).detach().requires_grad_()
    vg = rep_kv(v).detach().requires_grad_()
    o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    do_t = do.transpose(1, 2)

    def lib_bwd():
        return torch.autograd.grad(o_lib, (qg, kg, vg), do_t,
                                   retain_graph=True)

    def sdpa_grads():
        """SDPA's dq, dk, dv in the kernel's layouts (the repeated K/V
        grads summed over each kv head's q heads)."""
        gq, gk, gv = (x.float().transpose(1, 2) for x in lib_bwd())
        return (gq, gk.reshape(1, S, g, rep, e).sum(3),
                gv.reshape(1, S, g, rep, e).sum(3))

    def check_bwd(a, p):
        for x, y, what in zip(sdpa_grads(), p, ("dq", "dk", "dv")):
            bf16_excess(fa, x, y, f"{what} (SDPA, for the record)")
        err = 0.0
        for x, y, what in zip(a, p, ("dq", "dk", "dv")):
            err = max(err, bf16_err(fa, x, y, what))
        return err

    log(f"[kernel] flash_attention_bwd:causal q [1, {S}, {h}, {e}], k/v "
        f"[1, {S}, {g}, {e}], fed the kernel's out and lse (tolerance: "
        f"dq, dk, dv float32 |diff| <= {fa.BF16_RTOL:g} max |plain| of "
        "the row)")
    record_phase(torch, flush, results, "flash_attention_bwd:causal",
                 FLASH_BWD,
                 lambda: fa.flash_attention_bwd(q, k, v, out, do, lse,
                                                causal=True),
                 lambda: ref.attention_bwd(q, k, v, out, do, lse,
                                           causal=True),
                 lib_bwd, nbytes, flops, check_bwd)
    # the check must see the neighbouring q head's log-sum-exp, and K
    # rolled over kv heads at the keys of the second half only (dq of the
    # first half's rows, dk and dv of the first half's keys stay exact)
    plain = ref.attention_bwd(q, k, v, out, do, lse, causal=True)
    whats = tuple(f"flash_attention_bwd {w}" for w in ("dq", "dk", "dv"))
    bad = fa.flash_attention_bwd(q, k, v, out, do,
                                 lse.roll(1, dims=1).contiguous(),
                                 causal=True)
    bf16_probe(fa, bad, plain, whats, "the neighbouring q head's lse")
    bad = fa.flash_attention_bwd(q, late_rolled(k), v, out, do, lse,
                                 causal=True)
    bf16_probe(fa, bad, plain, whats,
               f"K rolled over kv heads at keys >= {S // 2}")
    del qg, kg, vg, o_lib, plain, bad

    # ---- K2: fused cross-entropy ---------------------------------------- #
    n, d, vocab = TRAIN_SEQ, 2048, 128256
    hn = rand(n, d, dtype=torch.float32)
    table = rand(vocab, d, scale=0.02)
    lab = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    mask = torch.ones(n, device=dev)
    mask[torch.randperm(n, generator=gen, device=dev)[: n // 8]] = 0.0
    denom = float(4 * n)
    kw = dict(chunk=8192, mask=mask, denom=denom)
    # read h, the table, labels, mask; write dh and dW (float32)
    nbytes = (hn.nbytes + table.nbytes + lab.nbytes + mask.nbytes
              + hn.nbytes + vocab * d * 4)
    # the least work: the logits, dh and dW products
    flops = 3 * 2 * n * d * vocab

    def lib_xent():
        hh = hn.detach().requires_grad_()
        ww = table.float().requires_grad_()
        lg = hh @ ww.t()
        loss = (F.cross_entropy(lg, lab, reduction="none") * mask).sum() \
            / denom
        return torch.autograd.grad(loss, (hh, ww))

    def check_xent(a, p):
        (la, (dha, dwa)), (lp, (dhp, dwp)) = a, p
        rel_err(la.reshape(1), lp.reshape(1), 1e-5, "loss")
        return max(rel_err(dha, dhp, 1e-4, "dh"),
                   rel_err(dwa, dwp, 1e-4, "dW"))

    log(f"[kernel] fused_xent: h [{n}, {d}] float32, table [{vocab}, {d}] "
        f"bf16 read as the [d, V] head, {int((mask == 0).sum())} rows "
        "masked (tolerance: loss 1e-5 relative; dh, dW max |diff| <= 1e-4 "
        "max |plain|)")
    record_phase(torch, flush, results, "fused_xent", XENT,
                 lambda: fx.softmax_xent(hn, table.t(), lab, **kw),
                 lambda: ref.softmax_xent(hn, table.t(), lab, **kw),
                 lib_xent, nbytes, flops, check_xent, iters=3)
    # the check must see a head shifted by one vocab tile
    plain = ref.softmax_xent(hn, table.t(), lab, **kw)
    bad = fx.softmax_xent(hn, table.roll(fx.TILE, 0).t(), lab, **kw)
    log("[kernel] fused_xent check, head shifted by one vocab tile:")
    _, w_loss = rel_excess(bad[0].reshape(1), plain[0].reshape(1), 1e-5,
                           "loss")
    _, w_dw = rel_excess(bad[1][1], plain[1][1], 1e-4, "dW")
    if not (w_loss > 1.0 and w_dw > 1.0):
        fail("the fused_xent check passes a head shifted by one vocab tile")
    # the bf16 body splits h into hi + lo: fed h rounded to bf16 (no lo
    # term), its dW must fail the check against the float32 h
    bad = fx.softmax_xent(hn.bfloat16().float(), table.t(), lab, **kw)
    log("[kernel] fused_xent check, h rounded to bf16 (no lo term):")
    _, w_dw = rel_excess(bad[1][1], plain[1][1], 1e-4, "dW")
    if not w_dw > 1.0:
        fail("the fused_xent check passes h rounded to bf16")
    return results


def flash_phases(torch, flush, results, tag, b, s, h, g, e):
    """K1 (causal) and K1b at one shape, each against its plain version
    under the bf16 row rule, timed beside SDPA and the bound, with the
    probes that must fail the rule: K's kv heads rolled by one and V
    rolled over kv heads at the keys of the second half (K1); the
    neighbouring q head's lse and K rolled over kv heads at the keys of
    the second half (K1b). With g == h (MHA) a roll over kv heads is a
    roll over heads."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rep = h // g

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def rep_kv(x):
        return x.repeat_interleave(rep, dim=2).transpose(1, 2)

    q, k, v, do = rand(b, s, h, e), rand(b, s, g, e), rand(b, s, g, e), \
        rand(b, s, h, e)
    n_pairs = b * s * (s + 1) // 2
    shapes = (f"q [{b}, {s}, {h}, {e}], k/v [{b}, {s}, {g}, {e}], causal")
    qt, kt, vt = q.transpose(1, 2), rep_kv(k), rep_kv(v)

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def check(a, p):
        rel_err(a[1], p[1], 1e-5, "lse")
        bf16_excess(fa, lib().transpose(1, 2), p[0],
                    "out (SDPA, for the record)")
        return bf16_err(fa, a[0], p[0], "out")

    log(f"[kernel] flash_attention_fwd:{tag} {shapes} (tolerance: out "
        f"|diff| <= {fa.BF16_RTOL:g} max |plain| of its row + 1 bf16 ulp; "
        "lse 1e-5 of max |plain|)")
    record_phase(torch, flush, results, f"flash_attention_fwd:{tag}",
                 FLASH_FWD,
                 lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                 lambda: ref.attention(q, k, v, causal=True,
                                       return_lse=True),
                 lib, 2 * q.nbytes + k.nbytes + v.nbytes + b * h * s * 4,
                 n_pairs * h * 2 * (e + e), check)
    plain = ref.attention(q, k, v, causal=True)
    bf16_probe(fa, fa.flash_attention_fwd(
        q, k.roll(1, dims=2).contiguous(), v, causal=True)[:1], (plain,),
        ("flash_attention_fwd out",), "K's kv heads rolled by one")
    bf16_probe(fa, fa.flash_attention_fwd(q, k, late_rolled(v),
                                          causal=True)[:1], (plain,),
               ("flash_attention_fwd out",),
               f"V rolled over kv heads at keys >= {s // 2}")

    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    do_t = do.transpose(1, 2)

    def lib_bwd():
        return torch.autograd.grad(o_lib, (qg, kg, vg), do_t,
                                   retain_graph=True)

    def check_bwd(a, p):
        gq, gk, gv = (x.float().transpose(1, 2) for x in lib_bwd())
        sdpa = (gq, gk.reshape(b, s, g, rep, e).sum(3),
                gv.reshape(b, s, g, rep, e).sum(3))
        for x, y, what in zip(sdpa, p, ("dq", "dk", "dv")):
            bf16_excess(fa, x, y, f"{what} (SDPA, for the record)")
        return max(bf16_err(fa, x, y, what)
                   for x, y, what in zip(a, p, ("dq", "dk", "dv")))

    log(f"[kernel] flash_attention_bwd:{tag} {shapes}, fed the kernel's out "
        f"and lse (tolerance: dq, dk, dv float32 |diff| <= "
        f"{fa.BF16_RTOL:g} max |plain| of the row)")
    record_phase(torch, flush, results, f"flash_attention_bwd:{tag}",
                 FLASH_BWD,
                 lambda: fa.flash_attention_bwd(q, k, v, out, do, lse,
                                                causal=True),
                 lambda: ref.attention_bwd(q, k, v, out, do, lse,
                                           causal=True),
                 lib_bwd,
                 (q.nbytes + k.nbytes + v.nbytes + out.nbytes + do.nbytes
                  + lse.nbytes + 4 * (q.numel() + k.numel() + v.numel())),
                 n_pairs * h * 2 * (3 * e + 2 * e), check_bwd)
    plain = ref.attention_bwd(q, k, v, out, do, lse, causal=True)
    whats = tuple(f"flash_attention_bwd {w}" for w in ("dq", "dk", "dv"))
    bf16_probe(fa, fa.flash_attention_bwd(
        q, k, v, out, do, lse.roll(1, dims=1).contiguous(), causal=True),
        plain, whats, "the neighbouring q head's lse")
    bf16_probe(fa, fa.flash_attention_bwd(q, late_rolled(k), v, out, do,
                                          lse, causal=True),
               plain, whats, f"K rolled over kv heads at keys >= {s // 2}")


def gpt_kernel_phases(torch, flush):
    """K1 and K1b at gpt-1.5B's attention (b 2, s 1024, 24 heads MHA, head
    dim 96) and at head dim 128 (gpt-6.2B's 32 heads of 128), and K2 over
    gpt-1.5B's untied head read in place as [d, vocab], each against its
    plain version with probes that must fail its rule."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import ref

    results = []
    # one micro-batch: the step's sequences over its four micro-batches
    b, s = GPT["global_batch"] // 4, GPT["seq"]
    flash_phases(torch, flush, results, "gpt_causal_e96", b, s, 24, 24, 96)
    flash_phases(torch, flush, results, "causal_e128", b, s, 32, 32, 128)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    n, d, vocab = b * s, GPT["d_model"], GPT["vocab"]
    hn = torch.randn((n, d), generator=gen, device=dev)
    head = (torch.randn((d, vocab), generator=gen, device=dev)
            / d ** 0.5).to(torch.bfloat16)
    lab = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    mask = torch.ones(n, device=dev)
    kw = dict(chunk=8192, mask=mask, denom=float(4 * n))
    nbytes = (hn.nbytes + head.nbytes + lab.nbytes + mask.nbytes
              + hn.nbytes + vocab * d * 4)

    def lib_xent():
        hh = hn.detach().requires_grad_()
        ww = head.float().requires_grad_()
        loss = F.cross_entropy(hh @ ww, lab, reduction="sum") / (4 * n)
        return torch.autograd.grad(loss, (hh, ww))

    def check_xent(a, p):
        (la, (dha, dwa)), (lp, (dhp, dwp)) = a, p
        if not (dwa.shape == (d, vocab) and dwa.is_contiguous()):
            fail(f"K2's head dW is {tuple(dwa.shape)}, not a contiguous "
                 f"[{d}, {vocab}]")
        rel_err(la.reshape(1), lp.reshape(1), 1e-5, "loss")
        return max(rel_err(dha, dhp, 1e-4, "dh"),
                   rel_err(dwa, dwp, 1e-4, "dW"))

    log(f"[kernel] fused_xent:gpt_head h [{n}, {d}] float32, head.w [{d}, "
        f"{vocab}] bf16 read in place (tolerance: loss 1e-5 relative; dh, "
        "dW max |diff| <= 1e-4 max |plain|)")
    record_phase(torch, flush, results, "fused_xent:gpt_head", XENT,
                 lambda: fx.softmax_xent(hn, head, lab, **kw),
                 lambda: ref.softmax_xent(hn, head, lab, **kw),
                 lib_xent, nbytes, 3 * 2 * n * d * vocab, check_xent,
                 iters=3)
    # the check must see the head's bytes read as a [vocab, d] table
    plain = ref.softmax_xent(hn, head, lab, **kw)
    bad = fx.softmax_xent(hn, head.reshape(vocab, d).t(), lab, **kw)
    log("[kernel] fused_xent check, head.w's bytes read as a [vocab, d] "
        "table:")
    _, w_loss = rel_excess(bad[0].reshape(1), plain[0].reshape(1), 1e-5,
                           "loss")
    _, w_dw = rel_excess(bad[1][1], plain[1][1], 1e-4, "dW")
    if not (w_loss > 1.0 and w_dw > 1.0):
        fail("the fused_xent check passes head.w read as a table")
    return results


def vocab_shard_phase(torch, flush, results, name, n, d, vocab, layout,
                      seed):
    """K2's two passes apart over one of two vocabulary shards (what a
    data rank of the sharded loss runs a micro-batch: pass 1 over its
    shard for all gathered rows, then pass 2 with the lse combined over
    the shards). Checks: each shard's pass 1 against its plain version;
    the shards' statistics combined with a max and a sum against the
    whole-vocab K2's lse, label logit and loss; pass 2 with the combined
    lse against the whole-vocab dh (the sum over the shards) and dW (the
    concatenation), by K2's float32 rule; probe: labels not shifted to
    the second shard must fail it."""
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, vloc = 2, vocab // 2
    hn = torch.randn((n, d), generator=gen, device=dev)
    if layout == "table":     # a tied table [vocab, d]; shards of rows
        full = (0.02 * torch.randn((vocab, d), generator=gen, device=dev)
                ).to(torch.bfloat16)
        shards = [full[r * vloc:(r + 1) * vloc].contiguous().t()
                  for r in range(D)]
        w_full = full.t()
    else:                     # an untied head [d, vocab]; column blocks
        w_full = (torch.randn((d, vocab), generator=gen, device=dev)
                  / d ** 0.5).to(torch.bfloat16)
        shards = [w_full[:, r * vloc:(r + 1) * vloc].contiguous()
                  for r in range(D)]
    lab = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    mask = torch.ones(n, device=dev)
    mask[torch.randperm(n, generator=gen, device=dev)[: n // 8]] = 0.0
    denom = float(4 * n)
    scale = mask / denom

    def local(r, shift=True):
        inw = (lab >= r * vloc) & (lab < (r + 1) * vloc)
        return torch.where(inw, lab - r * vloc if shift else lab, -1)

    def combine(stats):
        lses = torch.stack([a for a, _ in stats])
        m = lses.max(0).values
        lse = m + torch.log(torch.exp(lses - m).sum(0))
        labl = sum(b for _, b in stats)
        return lse, labl, ((lse - labl) * mask).sum() / denom

    log(f"[kernel] fused_xent:{name}: h [{n}, {d}] float32 (the gathered "
        f"rows), {D} shards of {vloc} of a bf16 "
        f"{'table read as [d, vloc]' if layout == 'table' else 'head'}, "
        "labels -1 outside the shard (tolerance: lse, label logit and loss "
        "1e-5 relative; dh, dW max |diff| <= 1e-4 max |plain|)")
    stats = []
    for r in range(D):
        got = fx.xent_stats(hn, shards[r], local(r))
        want = ref.xent_stats(hn, shards[r], local(r))
        rel_err(got[0], want[0], 1e-5, f"shard {r} lse")
        rel_err(got[1], want[1], 1e-5, f"shard {r} label logit")
        if not bool((got[1][local(r) < 0] == 0).all()):
            fail(f"shard {r}'s pass 1 left a label logit of another shard "
                 "non-zero")
        stats.append(got)
    lse, labl, loss = combine(stats)
    whole = fx.xent_stats(hn, w_full, lab)
    wl, (wdh, wdw) = fx.softmax_xent(hn, w_full, lab, mask=mask,
                                     denom=denom)
    rel_err(lse, whole[0], 1e-5, "combined lse vs whole-vocab K2")
    rel_err(labl, whole[1], 1e-5, "combined label logit vs whole-vocab K2")
    rel_err(loss.reshape(1), wl.reshape(1), 1e-5,
            "combined loss vs whole-vocab K2")
    parts = [fx.xent_grads(hn, shards[r], local(r), lse, scale)
             for r in range(D)]
    rel_err(parts[0][0] + parts[1][0], wdh, 1e-4,
            "dh (sum over shards) vs whole-vocab K2")
    rel_err(torch.cat([p[1] for p in parts], 1), wdw, 1e-4,
            "dW (shards concatenated) vs whole-vocab K2")
    del parts, wdh, wdw
    bad = [stats[0], fx.xent_stats(hn, shards[1], local(1, shift=False))]
    log(f"[kernel] fused_xent:{name} check, labels not shifted to shard 1:")
    if not rel_excess(combine(bad)[2].reshape(1), wl.reshape(1), 1e-5,
                      "loss")[1] > 1.0:
        fail(f"the fused_xent:{name} check passes labels not shifted to "
             "the shard")

    w0, l0 = shards[0], local(0)

    def kern():
        return (fx.xent_stats(hn, w0, l0),
                fx.xent_grads(hn, w0, l0, lse, scale))

    def plain():
        return (ref.xent_stats(hn, w0, l0),
                ref.xent_grads(hn, w0, l0, lse, scale))

    def lib():
        # the float32 product and logsumexp over the shard, then dlog's
        # products
        lg = hn @ w0.float()
        lse_l = torch.logsumexp(lg, 1)
        hit = l0 >= 0
        labl_l = lg.gather(1, l0.clamp(min=0)[:, None])[:, 0] * hit
        p = torch.exp(lg - lse[:, None])
        p[hit, l0[hit]] -= 1.0
        p *= scale[:, None]
        return (lse_l, labl_l), (p @ w0.float().t(), hn.t() @ p)

    def check(a, p):
        (sa, ga), (sp, gp) = a, p
        rel_err(sa[0], sp[0], 1e-5, "lse")
        rel_err(sa[1], sp[1], 1e-5, "label logit")
        return max(rel_err(ga[0], gp[0], 1e-4, "dh"),
                   rel_err(ga[1], gp[1], 1e-4, "dW"))

    # read h, the shard, labels, lse and scale; write lse, label logit, dh
    # and dW (float32); the least work: the logits, dh and dW products
    nbytes = (hn.nbytes + w0.nbytes + l0.nbytes + 2 * n * 4 + 2 * n * 4
              + hn.nbytes + vloc * d * 4)
    record_phase(torch, flush, results, f"fused_xent:{name}", XENT, kern,
                 plain, lib, nbytes, 3 * 2 * n * d * vloc, check, iters=3)


def shard_kernel_phases(torch, flush):
    """K2 over a vocabulary shard at the sharded loss's shapes: llama's
    2048 gathered rows (2 data ranks x one 1024-token micro-batch) over
    64,128 rows of the tied table, and gpt-1.5B's over a [2304, 25152]
    block of head.w."""
    results = []
    vocab_shard_phase(torch, flush, results, "vocab_shard", 2 * 1024, 2048,
                      128256, "table", 5)
    vocab_shard_phase(torch, flush, results, "gpt_vocab_shard", 2 * 1024,
                      GPT["d_model"], GPT["vocab"], "head", 6)
    return results


def resident_warps(regs: int, threads: int, smem: int) -> int:
    """Warps an H100 SM holds of a kernel using ``regs`` registers a
    thread (ptxas), ``threads`` a block and ``smem`` bytes of shared
    memory a block: registers go to warps in units of 256, an SM has
    65,536 of them, 64 warps, 32 blocks and 228 KB of shared memory, of
    which each block also reserves 1 KB."""
    per_warp = -(-regs * 32 // 256) * 256
    wpb = threads // 32
    blocks = min(65536 // per_warp // wpb, 64 // wpb, 32,
                 228 * 1024 // (smem + 1024))
    return blocks * wpb


def scan_kernel_phase(torch, flush, resources):
    """K5 at the Jamba prefill's shape (8 rows of 512 steps, 8192
    channels, state 16, float32) against its plain version, then the
    chaining case and the B/C-swap probe. Logs the launch's resident
    warps an SM and the MUFU floor (one ex2 an update at 16 a clock per
    SM, at the card's maximum SM clock)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    b, s, d, n = SCAN_B, SCAN_S, SCAN_D, SCAN_N
    results = []

    def inputs(s):
        """Mamba-like values: dt log-uniform in [1e-3, 1e-1] and A = -(1..n)
        (S4D-real), so exp(dt A) spans short and long memory."""
        x = torch.randn((b, s, d), generator=gen, device=dev)
        dt = torch.exp(torch.empty((b, s, d), device=dev).uniform_(
            -6.9078, -2.3026, generator=gen))
        bm = torch.randn((b, s, n), generator=gen, device=dev)
        cm = torch.randn((b, s, n), generator=gen, device=dev)
        return x, dt, bm, cm

    A = -(torch.arange(1, n + 1, device=dev, dtype=torch.float32)[None]
          * torch.exp(0.1 * torch.randn((d, n), generator=gen, device=dev)))
    D = torch.randn((d,), generator=gen, device=dev)
    x, dt, bm, cm = inputs(2 * s)
    half = [t[:, :s].contiguous() for t in (x, dt, bm, cm)]

    def check(a, p):
        return max(rel_err(a[0], p[0], SCAN_RTOL, "y"),
                   rel_err(a[1], p[1], SCAN_RTOL, "h"))

    f32 = 4
    # read x, dt, B, C, A, D once; write y and the final state
    nbytes = f32 * (3 * b * s * d + 2 * b * s * n + d * n + d + b * d * n)
    # per (row, step, channel, state): dt*A, exp, dt*B, *x, a*h+u, +C*h
    flops = b * s * d * (n * 8 + 2)
    shape = ss.launch_shape(n, d)
    key = (f"selective_scan:scan_kernel<{n},"
           f"{'true' if d % 4 == 0 else 'false'}>")
    regs = resources.get(key, {}).get("registers")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    block_ch = shape["threads"] // shape["lanes"]
    supply = b * -(-d // block_ch) * shape["threads"] / 32 / sms
    warps = {"ptxas": (resident_warps(regs, shape["threads"],
                                      shape["smem_bytes"]) if regs else None),
             "occupancy": shape["blocks_per_sm"] * shape["threads"] // 32}
    from_ptxas = (f"{regs} registers a thread (ptxas): resident warps an "
                  f"SM {warps['ptxas']} from the registers and block size"
                  if regs else "registers not measured (no ptxas log: this "
                  "run did not build the kernels)")
    log(f"[kernel] selective_scan launch: {shape['threads']} threads a "
        f"block ({shape['lanes']} lanes a channel), {shape['smem_bytes']} "
        f"bytes of shared memory a block, {from_ptxas}; "
        f"{warps['occupancy']} resident warps an SM by the CUDA occupancy "
        f"query; the grid offers {supply:.1f} warps an SM")
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    mhz = float(clk[0]) if clk and clk[0].isdigit() else None
    mufu_ms = b * s * d * n / (sms * 16 * mhz * 1e6) * 1e3 if mhz else None
    t_bound, by = bound(nbytes, flops, "float32")
    log(f"[kernel] selective_scan: x, dt [{b}, {s}, {d}], A [{d}, {n}], "
        f"B, C [{b}, {s}, {n}], float32, return_state (tolerance: y and h "
        f"max |diff| <= {SCAN_RTOL:g} max |plain|); bound {t_bound:.4f} ms "
        f"by {by}; MUFU floor ({b * s * d * n} exponentials, 16 a clock "
        "per SM) " + (f"{mufu_ms:.4f} ms at {mhz:g} MHz" if mhz else
                      "not measured (no SM clock from nvidia-smi)"))
    record_phase(torch, flush, results, "selective_scan", SCAN,
                 lambda: ss.selective_scan(*half[:2], A, *half[2:], D,
                                           return_state=True),
                 lambda: ref.selective_scan(*half[:2], A, *half[2:], D,
                                            return_state=True),
                 None, nbytes, flops, check, dtype="float32")
    results[-1].update(resident_warps=warps, mufu_floor_ms=mufu_ms,
                       sm_clock_max_mhz=mhz)
    # chaining: 2s steps in one pass equal s steps, then s more from h0
    rest = [t[:, s:].contiguous() for t in (x, dt, bm, cm)]
    y_all, h_all = ss.selective_scan(x, dt, A, bm, cm, D, return_state=True)
    y1, h1 = ss.selective_scan(*half[:2], A, *half[2:], D, return_state=True)
    y2, h2 = ss.selective_scan(*rest[:2], A, *rest[2:], D, h0=h1,
                               return_state=True)
    same = (torch.equal(torch.cat([y1, y2], 1), y_all)
            and torch.equal(h2, h_all))
    log(f"[kernel] selective_scan chaining: {2 * s} steps in one pass vs "
        f"{s} + {s} through h0: bit-identical {same}")
    if not same:
        fail("selective_scan chained through h0 differs from one pass")
    y_p, h_p = ref.selective_scan(*rest[:2], A, *rest[2:], D, h0=h1,
                                  return_state=True)
    check((y2, h2), (y_p, h_p))
    log("[kernel] selective_scan check, B and C swapped:")
    plain = ref.selective_scan(*half[:2], A, *half[2:], D)
    _, worst = rel_excess(ss.selective_scan(half[0], half[1], A, half[3],
                                            half[2], D), plain, SCAN_RTOL,
                          "y")
    if not worst > 1.0:
        fail("the selective_scan check passes B and C swapped")
    return results


# --------------------------------------------------------------------------- #
# Train phase
# --------------------------------------------------------------------------- #


def train_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx

    return {**fa.LAUNCHES, **fx.LAUNCHES}


def train_session(cell, **kw):
    """The full-width train Session of a training cell on the card."""
    from repro_torch.api import session

    return session(cell["arch"], mode="train", reduced=False,
                   device="cuda", seq_len=cell["seq"],
                   global_batch=cell["global_batch"], **kw)


def train_phase(torch, cell):
    """Step 1 through the kernels and the plain versions, then timed
    steps; returns the result row (the session and its state are
    released)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import ops

    tag = f"[train {cell['arch']}]"
    sess = train_session(cell)
    plain = train_session(cell, overrides=dict(kernel_impl="ref"))
    desc = sess.describe()
    sc = sess.shape_cfg
    log(f"{tag} {desc['n_params']} params, schedule {desc['schedule']}, "
        f"batch {sc.global_batch} x {sc.seq_len}")
    t0 = time.perf_counter()
    params = sess.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"{tag} params ({sess.rc.param_dtype}) in "
        f"{time.perf_counter() - t0:.2f} s")
    stream = sess.stream()
    batch = stream.batch(0)

    # ---- step 1: kernels vs plain versions ------------------------------ #
    t0 = time.perf_counter()
    g_k, m_k = sess.train_step(params, batch)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_p, m_p = plain.train_step(params, batch)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    loss_k, loss_p = float(m_k["loss_sum"]), float(m_p["loss_sum"])
    log(f"{tag} step 1: loss kernels {loss_k:.6f} ({t_k:.2f} s), plain "
        f"versions {loss_p:.6f} ({t_p:.2f} s); tolerance loss "
        f"{STEP1_LOSS_RTOL:g} relative, grads {STEP1_GRAD_RTOL:g} of the "
        "plain tensor's max |value|")
    if not abs(loss_k - loss_p) <= STEP1_LOSS_RTOL * abs(loss_p):
        fail(f"step-1 loss {loss_k} off the plain versions' {loss_p}")
    worst, worst_name, n_t = 0.0, None, 0
    for part in ("io", "segments"):
        gk = g_k[part] if part == "io" else g_k[part]["main"]
        gp = g_p[part] if part == "io" else g_p[part]["main"]
        for name in gk:
            a, b = gk[name], gp[name]
            r = ((a - b).abs().max() / b.abs().max()).item()
            if not math.isfinite(r) or r > worst or worst_name is None:
                worst, worst_name = r, name
            if not math.isfinite(a.abs().max().item()):
                fail(f"step-1 gradient {name} is not finite")
            n_t += 1
    log(f"{tag} step 1: {n_t} gradient tensors, worst max |diff| / max "
        f"|plain| {worst:.4e} ({worst_name})")
    if not worst <= STEP1_GRAD_RTOL:
        fail(f"step-1 gradient {worst_name} off the plain versions by "
             f"{worst} of its max |value|")
    if not abs(loss_k - cell["loss0"]) <= 0.5:
        fail(f"step-1 loss {loss_k} is not near {cell['loss0']:.3f} (see "
             "the training cells)")
    del g_k, g_p, plain
    gc.collect()
    torch.cuda.empty_cache()

    # ---- timed steps ---------------------------------------------------- #
    opt = sess.init_opt_state(params)
    torch.cuda.synchronize()
    fa.reset_launches()
    fx.reset_launches()
    base = ops.kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    tokens = sc.global_batch * sc.seq_len
    for i in range(TRAIN_STEPS):
        b = stream.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, m = sess.train_step(params, b)
        params, opt, om = sess.opt_step(params, grads, opt)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        del grads
        loss = float(m["loss_sum"])
        row = dict(step=i + 1, ms=dt * 1e3, tok_per_s=tokens / dt,
                   loss=loss, grad_norm=float(om["grad_norm"]),
                   max_memory_gb=torch.cuda.max_memory_allocated() / 2**30)
        steps.append(row)
        log(f"{tag} step {i + 1}: {row['ms']:.1f} ms, "
            f"{row['tok_per_s']:.1f} tok/s, loss {loss:.4f}, grad norm "
            f"{row['grad_norm']:.3f}, max memory "
            f"{row['max_memory_gb']:.2f} GiB")
    launches = train_launches()
    counters = {k: v - base.get(k, 0) for k, v in ops.kernel_counters().items()
                if v - base.get(k, 0)}
    log(f"{tag} launches in {TRAIN_STEPS} steps: {launches}; dispatch "
        f"{counters}")
    for name, per_step in cell["launches"].items():
        if launches[name] != per_step * TRAIN_STEPS:
            fail(f"{name} launched {launches[name]} times in "
                 f"{TRAIN_STEPS} steps, expected {per_step} a step")
    if any(k.startswith("ref_") for k in counters):
        fail(f"the timed steps reached a plain version: {counters}")
    if not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"non-finite losses: {[r['loss'] for r in steps]}")
    res = dict(arch=cell["arch"], n_params=desc["n_params"],
               step1_loss_kernels=loss_k, step1_loss_plain=loss_p,
               step1_worst_grad=worst, step1_worst_name=worst_name,
               step1_s_kernels=t_k, step1_s_plain=t_p, steps=steps,
               step_ms=sum(r["ms"] for r in steps) / len(steps),
               tok_per_s=sum(r["tok_per_s"] for r in steps) / len(steps),
               max_memory_gb=max(r["max_memory_gb"] for r in steps),
               launches=launches, counters=counters)
    del sess, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return res


def multirank_phase(torch):
    """llama3.2-1b at full width on data 2 x pp 2: four ranks, spawned by
    ``python -m repro_torch.launch.train`` as a subprocess, all on this
    card over gloo (host-staged collectives). First one one-rank step of
    the same params (the same seed, its layers re-stacked for pp 1) and
    batch in this process; then rank 0's step-1 loss and pre-clip grad
    norm must agree with it, every rank must have launched K1 and K1b and
    the last stage's ranks K2 (over their vocabulary shard), and the
    subprocess must exit 0."""
    from repro_torch import params as tparams
    from repro_torch.api import session
    from repro_torch.optim import adamw

    c = MULTI
    ranks = c["data"] * c["pp"]
    tag = "[multirank]"
    log(f"{tag} backend {c['backend']} (host-staged), {ranks} ranks on 1 "
        f"device: {c['arch']} data {c['data']} x pp {c['pp']}, seq "
        f"{c['seq']} (cut from 2048 for four ranks' memory on one card), "
        f"batch {c['global_batch']} x {c['seq']}")
    sess = session(c["arch"], mode="train", reduced=False, device="cuda",
                   seq_len=c["seq"], global_batch=c["global_batch"])
    rc_mesh = dataclasses.replace(sess.rc, pp=c["pp"])
    full = tparams.init_all_params(
        sess.cfg, rc_mesh, torch.Generator(device="cuda").manual_seed(0),
        "cuda")
    params = tparams.relayout(full, sess.cfg, rc_mesh, sess.rc)
    del full
    t0 = time.perf_counter()
    grads, m = sess.train_step(params, sess.stream().batch(0))
    loss1 = float(m["loss_sum"])
    norm1 = float(adamw.global_norm(grads))
    torch.cuda.synchronize()
    log(f"{tag} one-rank step 1 (pp 1, vpp 2, 4 micro-batches of 2): loss "
        f"{loss1:.6f}, grad norm {norm1:.6f} ({time.perf_counter() - t0:.2f}"
        " s)")
    del grads, params, sess
    gc.collect()
    torch.cuda.empty_cache()

    report = OUT / "multirank.json"
    report.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--full",
           "--arch", c["arch"], "--data", str(c["data"]), "--pp",
           str(c["pp"]), "--seq", str(c["seq"]), "--backend", c["backend"],
           "--steps", str(c["steps"]), "--report", str(report)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [x for x in env.get("PYTHONPATH", "").split(
            os.pathsep) if x])
    log(f"{tag} {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    # its own process group, so that a timeout stops the ranks it spawned
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail("the multi-rank run did not finish in 900 s")
    wall = time.perf_counter() - t0
    (OUT / "multirank.log").write_text(out + "\n--- stderr ---\n" + err)
    for line in out.splitlines():
        log(f"{tag}   {line}")
    if proc.returncode != 0:
        fail(f"the multi-rank run exited {proc.returncode}: {err[-2000:]}")
    rep = json.loads(report.read_text())
    steps = rep["steps"]
    lr, nr = steps[0]["loss"], steps[0]["grad_norm"]
    d_loss, d_norm = abs(lr - loss1) / abs(loss1), abs(nr - norm1) / norm1
    log(f"{tag} step 1, rank 0 vs one rank: loss {lr:.6f} vs {loss1:.6f} "
        f"(relative {d_loss:.3e}, rule {MULTI_LOSS_RTOL:g}); grad norm "
        f"{nr:.6f} vs {norm1:.6f} (relative {d_norm:.3e}, rule "
        f"{MULTI_NORM_RTOL:g})")
    if not d_loss <= MULTI_LOSS_RTOL:
        fail(f"multi-rank step-1 loss {lr} off the one-rank {loss1}")
    if not d_norm <= MULTI_NORM_RTOL:
        fail(f"multi-rank step-1 grad norm {nr} off the one-rank {norm1}")
    if not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"non-finite multi-rank losses: {[r['loss'] for r in steps]}")
    for r in rep["ranks"]:
        la = r["launches"]
        p = r["rank"] % c["pp"]          # rank = d * pp + p (one group)
        need = ["flash_attention_fwd", "flash_attention_bwd"] + (
            ["fused_xent"] if p == c["pp"] - 1 else [])
        missing = [k for k in need if not la.get(k)]
        if missing:
            fail(f"rank {r['rank']} launched no {missing}: {la}")
        if any(k.startswith("ref_") for k in r["counters"]):
            fail(f"rank {r['rank']} reached a plain version: "
                 f"{r['counters']}")
        log(f"{tag} rank {r['rank']} ({r['device']}, stage rank {p}): "
            f"launches {la}, peak {r['max_memory_gb']:.2f} GiB allocated; "
            f"mem_get_info after a step: {r['min_free_gb']:.2f} GiB free "
            "at the least")
    for r in steps[1:]:
        log(f"{tag} step {r['step']}: {r['ms']:.1f} ms, "
            f"{r['tok_per_s']:.1f} tok/s, loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f} (no throughput claim: gloo's host "
            "staging sets it)")
    launches = {k: sum(r["launches"].get(k, 0) for r in rep["ranks"])
                for k in ("flash_attention_fwd", "flash_attention_bwd",
                          "fused_xent")}
    log(f"{tag} {wall:.1f} s in all; launches over the ranks {launches}")
    return dict(backend=c["backend"], ranks=ranks, wall_s=wall,
                one_rank_loss=loss1, one_rank_grad_norm=norm1,
                loss_rel=d_loss, norm_rel=d_norm, steps=steps,
                per_rank=rep["ranks"], launches=launches)


def profile_train(torch, cell):
    """One training step (train_step + opt_step) of a training cell under
    torch.profiler, on fresh params (seed 0) and optimizer state."""
    from torch.profiler import ProfilerActivity, profile

    sess = train_session(cell)
    params = sess.init_params(torch.Generator(device="cuda").manual_seed(0))
    opt = sess.init_opt_state(params)
    batch = sess.stream().batch(TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads, _ = sess.train_step(params, batch)
        sess.opt_step(params, grads, opt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(t for _, t, _ in dev)
    n = sum(c for *_, c in dev)
    del grads, params, opt, sess
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[profile] train step ({cell['arch']}): {wall_us / 1e3:.1f} ms "
        f"under the profiler, device busy {busy / wall_us:.3f} of it, {n} "
        "kernels")
    top = sorted(dev, key=lambda r: -r[1])[:15]
    for name, t, c in top:
        log(f"[profile]   {t / 1e3:9.3f} ms {c:6d}x {name[:90]}")
    # the port's own kernels by the TPU kernel they replace
    ours = {}
    for name, t, c in dev:
        for k, marks in TRAIN_KERNELS.items():
            if any(m in name for m in marks):
                ms, calls = ours.get(k, (0.0, 0))
                ours[k] = (ms + t / 1e3, calls + c)
    for k, (ms, calls) in ours.items():
        log(f"[profile]   {k}: {ms:.3f} ms in {calls} launches "
            f"({ms * 1e3 / wall_us:.3f} of the step)")
    # K2 by pass: the split, pass 1 (with its lse combine), pass 2
    xent = {}
    for part, marks in XENT_PASSES.items():
        rows = [(t, c) for name, t, c in dev
                if any(m in name for m in marks)]
        xent[part] = dict(ms=sum(t for t, _ in rows) / 1e3,
                          kernels=sum(c for _, c in rows))
        log(f"[profile]   K2 {part}: {xent[part]['ms']:.3f} ms in "
            f"{xent[part]['kernels']} kernels")
    prof.export_chrome_trace(str(OUT / f"train_trace_{cell['arch']}.json"))
    return dict(arch=cell["arch"], step_ms=wall_us / 1e3,
                busy_share=busy / wall_us,
                kernels_per_step=n,
                top=[dict(name=k, ms=t / 1e3, calls=c) for k, t, c in top],
                ours={k: dict(ms=ms, launches=c)
                      for k, (ms, c) in ours.items()},
                xent_passes=xent)


# --------------------------------------------------------------------------- #
# Serve phases
# --------------------------------------------------------------------------- #


def workload(vocab: int = 128256):
    """The 16 prompts: lengths 64-512 from seed 0, ids below ``vocab``."""
    import numpy as np

    rng = np.random.RandomState(0)
    lens = rng.randint(64, 513, size=N_REQ)
    return [rng.randint(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def first_step(torch, sess, params):
    """Logits of one prefill step on fresh caches: slot 0 takes the first
    prompt at position 0, the other slots are masked."""
    import numpy as np

    prompt = workload(sess.cfg.vocab)[0]
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


def profile_serve(torch, sess, params, layout, kind="decode", steps=5):
    """Trace ``steps`` serve steps on fresh caches with torch.profiler:
    decode (8 active slots at position 1024) or prefill (slot 0 takes a
    512-token prompt at position 0, the other slots masked, as a lone
    admission does; one step at that shape runs first, outside the
    trace). Prints the device busy share of the window, the kernels by
    device time and the serving attention kernels' device kernels by
    name (with the key-split combine); writes a chrome trace."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    caches = sess.init_caches()
    n = sess.max_slots
    if kind == "decode":
        batch = {"tokens": np.ones((n, 1), np.int32),
                 "pos": np.full(n, 1024, np.int32),
                 "slot_mask": np.ones(n, bool)}
    else:
        toks = np.zeros((n, 512), np.int32)
        toks[0] = np.random.RandomState(1).randint(0, sess.cfg.vocab, 512)
        batch = {"tokens": toks, "pos": np.zeros(n, np.int32),
                 "slot_mask": np.arange(n) == 0}
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
    del caches
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    dev = [(e.key, e.self_device_time_total, e.count) for e in kern]
    busy = sum(t for _, t, _ in dev)
    log(f"[profile] {layout} {kind}: {wall_us / steps / 1e3:.2f} ms a step "
        f"under the profiler, device busy {busy / wall_us:.3f} of it, "
        f"{sum(c for *_, c in dev) / steps:.0f} kernels a step")
    top = sorted(dev, key=lambda r: -r[1])[:12]
    for name, t, c in top:
        log(f"[profile]   {t / steps / 1e3:8.3f} ms/step {c // steps:5d}x "
            f"{name[:90]}")
    ours = []
    for name, t, c in dev:
        for k, marks in SERVE_KERNELS.items():
            if any(m in name for m in marks):
                ours.append(dict(kernel=k, name=name,
                                 ms_per_step=t / steps / 1e3,
                                 calls_per_step=c / steps))
                log(f"[profile]   {k}: {t / steps / 1e3:.4f} ms/step in "
                    f"{c / steps:.0f} launches a step: {name[:80]}")
    prof.export_chrome_trace(str(OUT / f"{kind}_trace_{layout}.json"))
    return dict(layout=layout, kind=kind, step_ms=wall_us / steps / 1e3,
                busy_share=busy / wall_us, ours=ours,
                kernels_per_step=sum(c for *_, c in dev) / steps,
                top=[dict(name=n, ms_per_step=t / steps / 1e3,
                          calls_per_step=c / steps) for n, t, c in top])


def serve_launches():
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import selective_scan as ss

    return {**pa.LAUNCHES, **ss.LAUNCHES}


def reset_serve_launches():
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import selective_scan as ss

    pa.reset_launches()
    ss.reset_launches()


def serve_phase(torch, layout, params=None, arch=ARCH):
    import numpy as np

    from repro_torch.api import session
    from repro_torch.kernels import ops

    kw = dict(page_size=PAGE) if layout == "paged" else {}
    sess = session(arch, reduced=False, device="cuda", max_slots=SLOTS,
                   max_seq=MAX_SEQ, **kw)
    vocab = sess.cfg.vocab
    if params is None:
        t0 = time.perf_counter()
        params = sess.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        log(f"[serve] {arch} params: {sess.describe()['n_params']} "
            f"({sess.rc.param_dtype}) in {time.perf_counter() - t0:.2f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    plain = session(arch, reduced=False, device="cuda", max_slots=SLOTS,
                    max_seq=MAX_SEQ, overrides=dict(kernel_impl="ref"), **kw)
    lg_k = first_step(torch, sess, params)
    lg_p = first_step(torch, plain, params)
    if not bool(torch.isfinite(lg_k).all()) or lg_k.shape != (vocab,):
        fail(f"{layout}: first-step logits are not finite [vocab] values")
    scale = lg_p.abs().max().item()
    d_plain = (lg_k - lg_p).abs().max().item()
    log(f"[serve] {arch} {layout}: first-step logits kernel vs plain "
        "versions: "
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
    prompts = workload(vocab)
    gc.collect()                  # the previous layout's engine and caches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_serve_launches()
    base = ops.kernel_counters()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_gen=GEN) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = serve_launches()
    counters = {k: v - base.get(k, 0) for k, v in ops.kernel_counters().items()
                if v - base.get(k, 0)}
    outs = [r.result(timeout=1) for r in reqs]
    st = eng.stats
    if st.finished_requests != N_REQ or any(len(o) != GEN for o in outs):
        fail(f"{layout}: {st.finished_requests}/{N_REQ} requests finished")
    if any(not 0 <= t < vocab for o in outs for t in o):
        fail(f"{layout}: token ids outside the vocabulary")
    need = "paged_attention" if layout == "paged" else "slotted_attention"
    if launches[need] == 0:
        fail(f"{layout}: the engine run never launched {need}")
    if arch == JAMBA:
        # one K5 launch per Mamba layer a prefill step (decode steps take
        # the plain one-step update, which has no kernel), one K3 launch
        # per step for the attention layer
        if launches["selective_scan"] != MAMBA_LAYERS * st.prefill_steps:
            fail(f"{layout}: selective_scan launched "
                 f"{launches['selective_scan']} times in "
                 f"{st.prefill_steps} prefill steps, expected "
                 f"{MAMBA_LAYERS} a step")
        if launches[need] != st.prefill_steps + st.decode_steps:
            fail(f"{layout}: {need} launched {launches[need]} times in "
                 f"{st.prefill_steps + st.decode_steps} steps")
    if any(k.startswith("ref_") for k in counters):
        fail(f"{layout}: the engine run reached a plain version: {counters}")
    sess.serve_step_batched = step
    res = dict(
        arch=arch,
        layout=layout, wall_s=wall, generated_tokens=st.generated_tokens,
        tok_per_s=st.generated_tokens / wall,
        prefill_steps=st.prefill_steps, decode_steps=st.decode_steps,
        prefill_step_ms=sum(times["prefill"]) / max(len(times["prefill"]), 1),
        decode_step_ms=sum(times["decode"]) / max(len(times["decode"]), 1),
        max_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, counters=counters, first_logits_vs_plain=d_plain)
    log(f"[serve] {arch} {layout}: {N_REQ} requests, "
        f"{st.generated_tokens} tokens "
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
    resources = kernel_resources(build)

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    kernels = kernel_phases(torch, flush)
    train_kernels = train_kernel_phases(torch, flush)
    gpt_kernels = gpt_kernel_phases(torch, flush)
    shard_kernels = shard_kernel_phases(torch, flush)
    scan_kernels = scan_kernel_phase(torch, flush, resources)
    del flush
    gc.collect()
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
    # each training cell frees its session, params and optimizer state
    # before the next phase, so that two peaks never add up
    train = train_phase(torch, LLAMA)
    for row in train_kernels:
        row["launches"] = train["launches"][row["name"].split(":")[0]]
    kernels += train_kernels
    log(f"[train] before gpt: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    train_gpt = train_phase(torch, GPT)
    for row in gpt_kernels:
        row["launches"] = train_gpt["launches"][row["name"].split(":")[0]]
    kernels += gpt_kernels
    log(f"[serve] before jamba: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    jamba, _, _, params_j, sess_j = serve_phase(torch, "contiguous",
                                                arch=JAMBA)
    serve.append(jamba)
    for row in kernels:
        if row["name"].startswith("slotted_attention:e128"):
            row["launches"] = jamba["launches"]["slotted_attention"]
    for row in scan_kernels:
        row["launches"] = jamba["launches"]["selective_scan"]
    kernels += scan_kernels
    # after every timed run: the profiler slows what follows it
    profiles = [profile_serve(torch, s, p, lay, kind, steps)
                for s, p, lay in ((sess_c, params, "contiguous"),
                                  (sess_p, params, "paged"),
                                  (sess_j, params_j, "jamba"))
                for kind, steps in (("decode", 5), ("prefill", 3))]
    del params_j, sess_j
    gc.collect()
    torch.cuda.empty_cache()
    profiles += [profile_train(torch, LLAMA), profile_train(torch, GPT)]
    gc.collect()
    torch.cuda.empty_cache()
    # last: four ranks share the card, with nothing else on it
    multirank = multirank_phase(torch)
    for row in shard_kernels:
        row["launches"] = multirank["launches"]["fused_xent"]
    kernels += shard_kernels
    OUT.joinpath("chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": t_build, "resources": resources,
         "kernels": kernels, "serve": serve,
         "train": [train, train_gpt], "multirank": multirank,
         "profiles": profiles,
         "wall_s": time.perf_counter() - t_start}, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
