#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one NVIDIA GPU, the CUDA toolkit (``nvcc``) and PyTorch built for
CUDA; it imports nothing of jax or of the JAX package. In order:

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints the build time, and
   for the entry functions of the attention kernels, K2, K5 and K6 their
   registers and spills (ptxas) and tensor-core instructions
   (``cuobjdump -sass``): the serving kernels' bf16 entries at every
   head width (K3 causal and window + stats at 64, 96 and 128, K4 over
   bf16 and int8 pages at 64, 96 and 128), K2's in both head layouts
   and K1/K1b's at head dims 96 and 128 must hold HGMMA (wgmma), and
   those K2 and K1/K1b entries and K5's, K6's and K6b's must not spill;
2. kernel phases: each kernel at the shapes its path gives it, against
   its plain PyTorch version on the same inputs — the serving attention
   kernels at each serve cell's shapes (llama3.2-1b's e 64: K3 causal
   and window + stats, K4 over bf16 and int8 pages; Jamba's K3 at e 128;
   gpt-1.5B's e 96, 24 heads, MHA, 1024 keys: K3 causal and window, K4
   over bf16 and int8 pages; yi-9b's K4 at e 128, 32 heads over 4, over
   bf16 and int8 pages; the multi-rank serve path's K3 and K4 decodes:
   llama3.2-1b's heads, 2 rows a micro-batch, 2048 keys, K4 over a
   rank's 512 pages), the training
   kernels (K1 flash forward, K1b flash backward, K2 fused cross-entropy)
   in bf16 at llama3.2-1b's shapes, K1 and K1b at gpt-1.5B's (b 2, s
   1024, 24 heads of 96) and at head dim 128, K2 over gpt-1.5B's untied
   head [2304, 50304] read in place, K2's two passes apart over one of
   two vocabulary shards (the sharded loss: 2048 gathered rows over
   64,128 rows of llama's table, and over a [2304, 25152] block of
   gpt-1.5B's head.w), the selective scan (K5) in
   float32, and the Jamba training path's kernels at its shapes: K5 and
   its backward K5b at one micro-batch (b 1, s 4096, d 8192, n 16,
   float32) and K2 over Jamba's untied head [4096, 65536] at 4096 rows,
   and the kernels of qwen2-moe-a2.7b's and phi-3-vision-4.2b's paths:
   K1 and K1b at one training micro-batch of each (b 1, s 4096; 16
   heads of 128 and 32 of 96, MHA), K2 over qwen's untied head [2048,
   151936] and phi3's [3072, 32064] at 4096 rows (phi3's last 128-column
   vocabulary tile holds 64 columns: the first rows take its labels, and
   the kernel run over the head without them must fail the check), K3
   and K4 at qwen's serve cell (8 rows, 16 heads of 128, MHA) and K3 at
   phi3's (32 heads of 96, MHA), the sLSTM kernels in bf16 at xlstm's
   shapes (4 heads of 512): K6 at one training micro-batch (2 x 2048
   steps) saving the states, K6b from them, K6 at the serve prefill (8 x
   512) and one decode step with the state in and out, with the
   design's sequential floor (K6 and K6b on one warp), and K2 over
   xlstm's untied head [2048, 50304] at 4096 rows — each timed beside
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
   and final state within 1e-5 of the plain tensor's largest value; K6's
   and K6b's bf16 outputs each element within one bf16 ulp of the plain
   value, their float32 states within 1e-5 of the largest, two K6b runs
   equal bit for bit; and
   K5 chained over two halves with h0 equal bit for bit to one pass over
   the whole; K5's phase also logs its resident warps an SM (ptxas
   registers and block size, and the CUDA occupancy query) and its MUFU
   floor; K5b's six gradients each within 1e-4 of the plain tensor's
   largest value, two runs equal bit for bit (no float atomics), its
   launch shape (kernels a call, chunk and tile steps, blocks and waves,
   the occupancy query, ptxas registers and spills of its chunk and
   reverse walks) and MUFU floor at its four exponentials an update
   logged. Probes that must fail
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
   swapped (K5; K5b too, and x's channels rolled by one and A's sign
   flipped, a non-finite reading failing the rule), the gates' i and f
   swapped (K6) and the saved states shifted by a step (K6b); at e 96
   (128-wide tiles, zero pad columns) q, K and V with NaN in the first
   32 columns of every odd head must leave the even heads' K3/K4
   outputs finite and within the rule (a 128-wide read would run into
   the next head);
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
   after ``[ckpt gpt_paper]`` (gpt-1.5B under the fault-tolerance
   controller), ``[train jamba-v0.1-52b]``: Jamba's published widths cut to 2 layers
   (mamba:dense, mamba:moe) and 8 experts (2.33 B parameters; zeropp,
   vpp 1, 4 micro-batches of one 4096-token sequence in units of 2):
   step 1 through the kernels (K5, K5b, K2) and through the plain
   versions, loss within 2e-3 relative and pre-clip gradient norm within
   1e-2, loss near ln(vocab) + 1/2; then three timed steps with the
   counters set to 0: K5, K5b and K2 16, 8 and 8 times a step, no plain
   version, aux_sum and the forward's dropped assignments logged;
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
   kernels of K3/K4 with the key-split combine, and of K5, by name);
   then, after those models are freed, the paper's gpt-1.5B served at
   full width and depth (22 layers, d_model 2304, 24 heads of 96,
   LayerNorm, GELU MLP, untied head; bf16 weights from a seeded
   generator) through the ``ServeEngine`` with 8 slots, ``max_seq``
   1024 (its config's) and the same 16 requests, contiguous (K3 at e 96)
   then paged (K4 at e 96, page 16), and yi-9b paged at full width and
   depth (48 layers, 17.7 GB; K4 at e 128, 32 heads over 4), each with
   the checks of step 3 (counters 0 before the engine run, the kernel
   launched and no plain version after it, first-step logits against
   the plain versions, and gpt's across its two layouts), then the same
   decode and prefill traces of each of those three runs; then
   ``[serve qwen2-moe-a2.7b]``: all 24 layers at full width (60 experts
   top-4 and the shared FFN every layer, 28.6 GB) in both layouts (K3,
   then K4, at e 128 MHA) with the checks of step 3 and the MoE capacity
   deferrals logged, and its decode traced; ``[train qwen2-moe-a2.7b]``:
   the published widths cut to 3 layers (all 60 experts, 2.33 B
   parameters; 4 x 4096 tokens, vpp 1) by the Jamba cell's rules, K1 24,
   K1b 12 and K2 8 times a step; ``[serve phi-3-vision-4.2b]``: all 32
   layers (7.6 GB, K3 at e 96 MHA) through the engine on the same
   requests, then 8 rows of 256 float patch embeddings from the vision
   stream prefilled and 32 greedy steps decoded through the kernels and
   through the plain versions, every row's logits at every step within
   0.05 of the row's max |logit|, token agreement logged;
   ``[train phi-3-vision-4.2b]``: the widths cut to 16 layers (2.01 B
   parameters) on 4 x 4096 float patch embeddings by the same rules,
   ``embed.table``'s step-1 gradient exactly 0 in both runs, K1 128, K1b
   64 and K2 8 times a step; ``[serve xlstm-1.3b]``: all 48 layers (40
   mLSTM, 8 sLSTM, no FFN; 6.8 GB of weights, 5.4 GB of float32 state)
   through the engine on the same requests, contiguous only, K6 launched
   8 times a step (prefill and decode), the first step's logits held
   against the plain versions in float32 compute on the same weights
   cast up (the bf16 reading logged: bf16 rounding alone puts the plain
   versions 0.68 of max |logit| from float32 on these weights), its
   decode traced; ``[train xlstm-1.3b]``: the widths cut to 24 layers
   (1.80 B parameters; vpp 2, 8 x 2048 tokens) by the cut cells' rule,
   K6 32, K6b 16 and K2 8 times a step, step 1 against the plain
   versions at one period of 6 layers (vpp 1) with the sLSTM layer's
   leaves held by Jamba's leaf rule; then one
   training step of each training model (llama, gpt-1.5B, Jamba's cut)
   on fresh params under the profiler (device busy share, kernels by
   device time, launches a step, and the device time of K1, K1b, K2, K5
   and K5b, K2 also by pass: the split, pass 1, pass 2);
7. multi-rank train phases, last, with the card otherwise empty, each
   four ranks spawned by ``python -m repro_torch.launch.train`` as a
   subprocess, all on this card, collectives staged through host memory
   (gloo), gathers and reduce-scatters issued asynchronously and waited
   on late: first llama3.2-1b at full width and depth on data 2 x pp 2
   (``--full --data 2 --pp 2 --seq 1024 --backend gloo --steps 3``; seq
   cut from 2048 to 1024 for four ranks' memory), then llama3.2-1b at
   full width cut to 8 layers on pods 2 x data 2 x pp 1 with the stage
   grads reduced in int8 with error feedback (``--full --pods 2 --data
   2 --pp 1 --layers 8 --seq 1024 --grad-compress int8``: flat slabs,
   gathers a tick ahead; the pods all-reduce in float32). Before each,
   one one-rank step of the same params and batch runs here; rank 0's
   step-1 loss must agree with it within 2e-3 relative and its pre-clip
   grad norm within 1e-2, every rank must have launched K1 and K1b and
   the last stage's ranks K2 over their vocabulary shard, no plain
   version may run, at pods 2 the two pods' params must be equal bit for
   bit after the last step (each rank reports a sha256 of its params),
   and the subprocess must exit 0. Steps 2-3 (ms, tokens/s: no
   throughput claim, gloo sets it) and each rank's peak memory are
   logged;
8. the auto phase, last: the paper's §4 plan selection for gpt-1.5B at
   full width and depth on pp 2 x data 1 (vpp 1, 8 micro-batches of one
   1024-token sequence in units of 4), two ranks spawned on this card by
   ``python3 chip_smoke.py --auto-ranks CONF`` as a subprocess, gloo.
   After one one-rank step of the same params and batch here, each rank
   builds the ``schedule="auto"`` session (a800 preset; every
   candidate's simulated makespan and peak memory are logged, every rank
   must hold the same winner and table), then a second session of the
   same key, which must be a persisted hit of the plan cache with no
   simulation and no measurement; then 3 steps under the winner, under
   ``autogen_gated`` and under ``zeropp``, each from the same params and
   batches: step 1's loss and pre-clip grad norm against the one-rank
   step by the multi-rank rules, K1 and K1b launched on every rank, K2
   on the drain rank, no plain version, per-rank peak memory and step ms
   logged (no claim: the ranks share the card); last
   ``schedule="auto_profiled"`` times the 2 best candidates on both
   ranks, which must agree on the times and the winner. The makespans
   are seconds of the a800 cost model, not times of this card;
9. the multi-rank serve phase, last: llama3.2-1b at full width and
   depth served on data 2 x pp 2 (vpp 2, 2 micro-batches of the serve
   table) by four ranks on this card over gloo, spawned by ``python -m
   repro_torch.launch.serve`` as a subprocess: 8 slots, max_seq 2048,
   the first 8 prompts of step 3 with 16 greedy tokens each, contiguous
   (K3), paged at page 16 (K4), then contiguous with ``serve_resident``
   (``--layouts contiguous+resident``) in the one spawn; the head
   vocabulary-sharded (64,128 rows a shard), the stage blocks gathered
   tick by tick, or under ``serve_resident`` held whole on each rank
   with no gather (every rank's count must read 0). One rank's serve of
   the same params (re-stacked for pp 1) and requests runs here first: in each layout the logits of every
   slot row (both data shards) in a prefill step and the decode step
   after it must agree with the one rank's row by row, within 0.05 of
   the row's max |logit|; the token agreement is logged, every rank
   must have launched K3 (contiguous) and K4 (paged) and no plain
   version, and the subprocess must exit 0.
   Prefill and decode step ms, tokens/s, each rank's peak memory and
   FSDP gather seconds are logged (no claim: gloo stages every gather
   on the host).

Any failure exits non-zero before the result lines. The second-to-last line
of standard output is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Details (the nvcc log, every measured
number, profiler traces) go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import shutil
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
# the serve cells of the paper's gpt-1.5B (its config's 1024 positions:
# 64-512 prompt tokens and 32 generated fit) and of yi-9b (paged)
GPT_SERVE, YI_SERVE, GPT_MAX_SEQ = "gpt_paper", "yi-9b", 1024

# the serving kernels' bf16 tensor-core entry functions (slotted_win_*:
# the window + stats contract)
TC_SERVE = ("slotted_tc_e64", "slotted_tc_e96", "slotted_tc_e128",
            "slotted_win_e64", "slotted_win_e96", "slotted_win_e128",
            "paged_tc_bf16", "paged_tc_int8", "paged_tc_bf16_e96",
            "paged_tc_int8_e96", "paged_tc_bf16_e128", "paged_tc_int8_e128")
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
                 "K5 selective_scan": ("::scan_kernel<",),
                 "K6 slstm_scan": ("slstm_fwd_kernel<",)}
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
SCAN_BWD = dict(route="cuda",
                source="src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
                replaces="src/repro/core/tape.py:148")
JAMBA, JAMBA_VOCAB, MAMBA_LAYERS = "jamba-v0.1-52b", 65536, 7
SCAN_B, SCAN_S, SCAN_D, SCAN_N = 8, 512, 8192, 16
# K5 and K5b at Jamba's training shape: one micro-batch of one
# 4096-token sequence over d_inner 8192 channels, state 16
SCAN_TRAIN = dict(b=1, s=4096, d=8192, n=16)
# K5b vs its plain version, per output, against the output's max |plain|:
# both compute in float32, the kernel walking chunks of 128 steps in
# parallel, carrying states and cotangents across them through each
# chunk's decay, and summing dA, dD over 4096 steps and dB, dC over 8192
# channels in another order than the plain version (doubling steps in
# chunks of 256), with exp2 by MUFU
SCAN_BWD_RTOL = 1e-4
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
# the Jamba training cell: jamba-v0.1-52b at its published widths cut to
# 2 layers (mamba:dense, mamba:moe) and 8 experts (configs/
# jamba_v0p1_52b.py one_card_train_config; 2.33 B parameters), zeropp,
# vpp 1, 4 micro-batches of one 4096-token sequence in units of 2. A step
# launches K5 2 x 4 x 2 times (F and B's recompute), K5b 2 x 4, K2 2 x 4
# (two passes a micro-batch). Step 1 through the kernels against the
# plain versions: loss within 2e-3 relative, the pre-clip gradient norm
# within 1e-2 (bf16 compute: the two runs round differently, and the
# router's top-2 may flip at near ties); its loss near ln(vocab) + 1/2
# (an RMSNorm and a 1/sqrt(d) untied head: unit-variance logits)
JAMBA_TRAIN = dict(arch=JAMBA, seq=4096, global_batch=4, vocab=JAMBA_VOCAB,
                   d_model=4096, steps=3,
                   launches={"selective_scan": 16, "selective_scan_bwd": 8,
                             "fused_xent": 8},
                   loss0=math.log(JAMBA_VOCAB) + 0.5, leaves=".mix.",
                   cuts="depth 32 -> 2 (mamba:dense, mamba:moe), experts "
                        "16 -> 8 (80 GB card)")
# the cut training cells' step-1 rule (Jamba's, qwen2-moe's and
# phi-3-vision's): loss and pre-clip grad norm relative
CUT_LOSS_RTOL, CUT_NORM_RTOL = 2e-3, 1e-2
# and, for Jamba, each Mamba leaf's gradient (layers 0 and 1) within
# JAMBA_LEAF_RTOL of the plain versions', relative to its max |plain|:
# the H100 read 2.8e-3 to 7.2e-3 over the 18 leaves (one to two bf16
# ulps, 2^-8), and a wrong dA, dD or dB from K5b moves its leaves by O(1)
JAMBA_LEAF_RTOL = 2e-2
# the qwen2-moe training cell: qwen2-moe-a2.7b at its published widths
# (all 60 experts top-4, the shared FFN of 5632) cut to 3 attn:moe layers
# (configs/qwen2_moe_a2p7b.py one_card_train_config; 2.33 B parameters),
# zeropp, vpp 1, 4 micro-batches of one 4096-token sequence in units of
# 2. A step launches K1 3 x 4 x 2 times (F and B's recompute), K1b 3 x 4
# (at e = 128, MHA), K2 2 x 4 over the untied [2048, 151936] head. The
# phi-3-vision cell: phi-3-vision-4.2b's widths cut to 16 layers (2.01 B
# parameters), vpp 2, 4 micro-batches of 4096 float patch embeddings
# (the vision stub) in units of 2: K1 16 x 4 x 2, K1b 16 x 4 (e = 96,
# MHA), K2 2 x 4 over [3072, 32064], whose last 128-column tile holds 64;
# the table takes no gradient. Each step 1 by the cut cells' rule, its
# loss near ln(vocab) + 1/2 (RMSNorm and a 1/sqrt(d) untied head)
QWEN, PHI3 = "qwen2-moe-a2.7b", "phi-3-vision-4.2b"
QWEN_TRAIN = dict(arch=QWEN, seq=4096, global_batch=4, vocab=151936,
                  d_model=2048, steps=3,
                  launches={"flash_attention_fwd": 24,
                            "flash_attention_bwd": 12, "fused_xent": 8},
                  loss0=math.log(151936) + 0.5, pin_routing=True,
                  cuts="depth 24 -> 3 (80 GB card); all 60 experts and the "
                       "shared FFN")
PHI3_TRAIN = dict(arch=PHI3, seq=4096, global_batch=4, vocab=32064,
                  d_model=3072, steps=3,
                  launches={"flash_attention_fwd": 128,
                            "flash_attention_bwd": 64, "fused_xent": 8},
                  loss0=math.log(32064) + 0.5, zero_embed=True,
                  cuts="depth 32 -> 16 (80 GB card)")
# the xLSTM cells. Serving: xlstm-1.3b at full width and depth, 48
# layers (40 mLSTM, 8 sLSTM, no FFN; 6.8 GB of bf16 weights and 5.4 GB
# of float32 recurrent state at 8 slots), contiguous caches only (the
# recurrent state has no pages): K6 launches once a step per sLSTM layer,
# prefill and decode alike. Training: the published widths cut to 24
# layers (20 mLSTM, 4 sLSTM; 1.80 B parameters), zeropp, vpp 2 (k = 12),
# 4 micro-batches of two 2048-token sequences in units of 2. A step
# launches K6 4 x 4 x 2 times (F and B's recompute), K6b 4 x 4 and K2 2 x
# 4 over the untied [2048, 50304] head; the mLSTM's scans are plain
# PyTorch on every device. Step 1 by the cut cells' rule, and the
# sLSTM layer's leaves (L5: w_gates, g_bias, w_out) by Jamba's leaf
# rule, at one period of 6 layers (5 mLSTM, then the sLSTM; vpp 1, its
# own params from seed 0): the plain run's sLSTM is a Python loop of ~15
# launches a step (tens of seconds a step at 24 layers), and in bf16 the
# mLSTM's normaliser amplifies rounding from layer to layer (on these
# random weights the plain bf16 serve step reads 0.68 of max |logit|
# from a float32 one, tools/serve_gap.py): at 24 layers one-ulp
# differences in K6's output move those leaves past the rule, at 6
# layers they read 1.3e-3 to 2.7e-3 on the H100
XLSTM, SLSTM_LAYERS = "xlstm-1.3b", 8
XLSTM_TRAIN = dict(arch=XLSTM, seq=2048, global_batch=8, vocab=50304,
                   d_model=2048, steps=3,
                   launches={"slstm_scan": 32, "slstm_scan_bwd": 16,
                             "fused_xent": 8},
                   loss0=math.log(50304) + 0.5, leaves="L5.mix.",
                   step1_layers=6,
                   cuts="depth 48 -> 24 (80 GB card)")
# the serve cells whose first-step check runs in float32 compute (the
# weights cast up), the bf16 reading logged: xlstm-1.3b's bf16 rounding
# alone puts the plain versions 0.68 of max |logit| from float32 (see
# XLSTM_TRAIN), 13x the serve rule
FIRST_STEP_F32 = {XLSTM}
SLSTM = dict(route="cuda",
             source="src/repro_torch/kernels/csrc/slstm_scan.cu",
             replaces="src/repro/kernels/ref.py:419")
# K6 / K6b shapes: one training micro-batch (2 x 2048 steps), the serve
# cell's prefill (8 slots x 512 steps, the longest prompt) and decode
# (one step), 4 heads of 512
SLSTM_SHAPES = {"train": (2, 2048), "prefill": (8, 512), "decode": (8, 1)}
SLSTM_H, SLSTM_E = 4, 512
# float32 outputs of K6 / K6b (the saved and final states, the initial
# state's cotangent) within SLSTM_RTOL of max |plain|: the same float32
# operations in the same order, with other exp / tanh / log1p; bf16
# outputs (y, dgates) each within one bf16 ulp of the plain value
# (|diff| <= 2^-7 (|plain| + mean |plain|), tests/test_torch_cuda.py's
# rule), both rounding the same float32 value
SLSTM_RTOL = 1e-5
# float operations a channel and step counted for the bound (each exp,
# log1p, tanh and division one): the forward's cell ~25, the backward's
# recompute and reverse step ~60
SLSTM_FLOPS = {"fwd": 25, "bwd": 60}
# the phi-3-vision serve cell's float prefill: 8 rows of 256 patch
# embeddings from the stream, then 32 greedy decode steps
VISION_PREFILL, VISION_DECODE = 256, 32
# device kernels of each training kernel, by name, for the step's profile
TRAIN_KERNELS = {"K1 flash_attention_fwd": ("flash_fwd_tc",),
                 "K1b flash_attention_bwd": ("dq_tc", "dkdv_tc"),
                 "K2 fused_xent": sum(XENT_PASSES.values(), ()),
                 "K5 selective_scan": ("::scan_kernel<",),
                 "K5b selective_scan_bwd": tuple(
                     f"(anonymous namespace)::{k}" for k in (
                         "chunk_kernel<", "carry_kernel(", "bwd_kernel<",
                         "reduce_kernel<")),
                 "K6 slstm_scan": ("slstm_fwd_kernel<",),
                 "K6b slstm_scan_bwd": ("slstm_bwd_kernel<",)}
# the checkpoint phase: gpt-1.5B's train cell (full width and depth) for
# 4 steps under the fault-tolerance controller, a checkpoint every 2
# steps (async, keep 1), a failure injected before step 3 (index), so the
# restart resumes at 2. A checkpoint holds bf16 params and float32
# master, m and v: 14 bytes a parameter. The phase needs free disk for
# two of them (the previous step stays until the next is renamed) and
# host memory for one, with margins; where either is short it cuts the
# depth (never skips). Step 2's loss after the restart must equal the
# one before it bit for bit (the forward has no atomics); its grad norm
# agrees within CKPT_NORM_RTOL only, since the embedding's gradient
# (core/vocab.py, index_add_) sums with float atomics on the card
CKPT = dict(steps=4, every=2, keep=1, inject_at=3, resume=[2])
CKPT_BYTES_PER_PARAM = 2 + 4 + 4 + 4
CKPT_DISK_MARGIN, CKPT_RAM_MARGIN = 2.2, 1.2
CKPT_NORM_RTOL = 1e-5
# the multi-rank train phases, each four ranks (one process each, all on
# this card over gloo), seq 1024 for four ranks' memory on one card;
# zeropp, vpp 2, 4 micro-batches of one sequence in units of 2 a batch
# shard. "multirank": llama3.2-1b at full width and depth on data 2 x pp
# 2, float32 reduces: 8 x 1024 tokens a step. "pods": llama3.2-1b at
# full width cut to 8 layers on pods 2 x data 2 x pp 1, the stage grads
# reduced in int8 with error feedback, flat slabs, gathers issued a tick
# ahead: 16 x 1024 tokens a step
MULTI = dict(name="multirank", arch=ARCH, data=2, pp=2, seq=1024,
             global_batch=8, steps=3, backend="gloo",
             cuts="seq 2048 -> 1024 for four ranks' memory on one card")
PODS = dict(name="pods", arch=ARCH, pods=2, data=2, pp=1, layers=8,
            seq=1024, global_batch=16, steps=3, backend="gloo",
            flags=("--grad-compress", "int8"),
            cuts="seq 2048 -> 1024 and depth 16 -> 8 layers for four "
                 "ranks' memory on one card (about 95 GB at 16 layers)")
# the auto phase: the paper's §4 plan selection for gpt-1.5B at full
# width and depth on pp 2 x data 1 (two ranks, one process each, on this
# card over gloo; vpp 1, since 22 layers do not split into 4 stages), 8
# micro-batches of one 1024-token sequence in units of 4, bf16 params and
# compute with float32 master and moments: schedule="auto" under the a800
# preset (each candidate's simulated makespan and peak memory logged),
# then a second session of the same key (a persisted hit: no simulation,
# no measurement), 3 steps under the winner, autogen_gated and zeropp
# from the same params and batches (step 1 held to one one-rank step by
# the multi-rank rules below), and last schedule="auto_profiled" timing
# the 2 best
AUTO = dict(name="auto", arch="gpt_paper", pp=2, data=1, vpp=1, seq=1024,
            global_batch=8, microbatches=8, unit=4, steps=3,
            backend="gloo", preset="a800", top_k=2,
            compare=("autogen_gated", "zeropp"),
            cuts="none (22 layers at full width; seq 1024, the paper's)")
# the multi-rank serve phase: llama3.2-1b at full width and depth served
# on data 2 x pp 2 (vpp 2, 2 micro-batches of the serve table), four
# ranks (one process each, all on this card over gloo) spawned by
# ``python -m repro_torch.launch.serve``: 8 slots, max_seq 2048, 8
# requests (the first 8 prompts of ``workload()``, 64-512 tokens) of 16
# greedy tokens each, contiguous (K3), paged at page 16 (K4), then
# contiguous with serve_resident (every rank holds its stage rows whole:
# no FSDP gather) in the one spawn. At data 2 the head is
# vocabulary-sharded: 64,128 rows a shard. Held to one rank's serve of the same params and requests here:
# every slot row's logits in a prefill and a decode step by the serve
# phases' rule (0.05 of the row's max |logit|), token agreement logged
SERVE_MULTI = dict(name="serve_multirank", arch=ARCH, data=2, pp=2, vpp=2,
                   microbatches=2, slots=SLOTS, max_seq=MAX_SEQ, n_req=8,
                   gen=16, page=PAGE, backend="gloo",
                   cuts="none (16 layers at full width; 8 of the 16 "
                        "requests, 16 of 32 tokens each)")
# rank 0's step 1 against one one-rank step of the same params and batch
# (pp 1, vpp 2, micro-batches of 2 or 4 sequences): bf16 compute in other
# micro-batch shapes and stage boundaries, and the reductions in another
# order, so the loss agrees to about a bf16 rounding of the logits and
# the norm of 1.24 B gradient elements to about a percent. The pods
# phase reduces its stage grads in int8: the loss of step 1 is computed
# before any reduce, and its norm keeps the same 1e-2 (the CPU runs of
# tests/test_torch_multirank.py read 2.6e-4 flat, 1.0e-5 per tensor)
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
                                   "fused_xent", "selective_scan",
                                   "selective_scan_bwd", "slstm_scan")
                     ) -> dict:
    """Per entry function of the named libraries (keyed "library:name";
    the serving float32 attention bodies' instantiations share one name;
    K1/K1b's are named by their head widths, K2's by their head layout,
    K5's by their template arguments): registers and spill bytes
    from the ptxas log of this run's build, and the tensor-core
    instructions (HGMMA: wgmma; HMMA: mma.sync) in its SASS from
    cuobjdump (None where the toolkit has no cuobjdump). Fails if a
    serving kernel's (the window contract's included), K2's (either head
    layout) or a 96- or 128-wide K1/K1b bf16 tensor-core entry has no
    HGMMA, or one of those K2 or K1/K1b entries or a K5, K6 or K6b entry
    spills."""
    import os
    import re

    # longest first: paged_tc_bf16 is a prefix of paged_tc_bf16_e96
    short = sorted(TC_SERVE + tuple(
        f"combine{st}_e{e}" for st in ("", "_stats") for e in (64, 96, 128))
        + ("slotted_kernel", "paged_kernel", "xent_split", "lse_kernel"),
        key=len, reverse=True)
    # K1/K1b by head widths <E,EV>; K2 by head layout <0: table, 1: head>
    flash = re.compile(r"(flash_fwd_tc|flash_fwd_kernel|dq_tc|dkdv_tc|"
                       r"dq_kernel|dkdv_kernel)ILi(\d+)ELi(\d+)E")
    xent = re.compile(r"(stats_tc|dlog_tc|dw_tc|dh_tc|stats_kernel|"
                      r"dlog_kernel|dw_kernel|dh_kernel)ILi([01])E")

    def name_of(lib, mangled):
        m = re.search(r"(slstm_fwd_kernel|slstm_bwd_kernel)I(13__nv_bfloat16"
                      r"|f)E", mangled)
        if m:    # K6 / K6b by the gates' dtype
            return (f"{lib}:{m.group(1)}"
                    f"<{'bf16' if 'bfloat' in m.group(2) else 'float'}>")
        m = re.search(r"(chunk_kernel|bwd_kernel|reduce_kernel)ILi(\d+)E",
                      mangled)
        if m:    # K5b: its templated kernels by state size
            return f"{lib}:{m.group(1)}<{m.group(2)}>"
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
    slstm = [k for k in res if k.startswith("slstm_scan:slstm_")]
    if len(slstm) != 4:
        fail(f"the slstm_scan build has entries {slstm}, not K6 and K6b in "
             "float32 and bf16")
    for k in slstm:
        if res[k].get("spill_bytes"):
            fail(f"{k} spills {res[k]['spill_bytes']} bytes")
    return res


# --------------------------------------------------------------------------- #
# Kernel phases
# --------------------------------------------------------------------------- #


# the serving attention cells of the kernel phases: (tag of the phase
# names, batch rows, q heads, kv heads, head width, keys a row, seed)
LLAMA_ATTN = dict(tag="", b=SLOTS, h=32, g=8, e=64, S=MAX_SEQ, seed=1)
JAMBA_ATTN = dict(tag="e128_", b=SLOTS, h=32, g=8, e=128, S=MAX_SEQ,
                  seed=3)
# gpt-1.5B (MHA, 96 wide: the 128-wide tensor-core body with zero pad
# columns) over its 1024 positions, and yi-9b (GQA 8:1, 128 wide)
GPT_ATTN = dict(tag="e96_", b=SLOTS, h=24, g=24, e=96, S=GPT_MAX_SEQ,
                seed=4)
YI_ATTN = dict(tag="e128_", b=SLOTS, h=32, g=4, e=128, S=MAX_SEQ, seed=5)
# the multi-rank serve path's (SERVE_MULTI): each rank's cached stage
# takes one micro-batch of 2 of its shard's 4 slot rows at a time, over
# 2048 keys a row, and K4 this rank's block of the page pool (512 of
# 1024 pages)
MESH_ATTN = dict(tag="mesh_", b=2, h=32, g=8, e=64, S=MAX_SEQ, seed=6,
                 pages=SLOTS * MAX_SEQ // PAGE // 2)
# qwen2-moe-a2.7b (MHA, 16 heads of 128; both layouts) and
# phi-3-vision-4.2b (MHA, 32 heads of 96; contiguous) over 2048 keys
QWEN_ATTN = dict(tag="qwen_", b=SLOTS, h=16, g=16, e=128, S=MAX_SEQ,
                 seed=7)
PHI3_ATTN = dict(tag="phi3_", b=SLOTS, h=32, g=32, e=96, S=MAX_SEQ, seed=8)


def kernel_phases(torch, flush):
    """The serving attention kernels, K3 and K4, at the shapes of each
    serve cell: llama3.2-1b's (e 64: K3 causal and window, K4 over bf16
    and int8 pages), Jamba's K3 at e 128, gpt-1.5B's K3 and K4 at e 96
    (with the NaN probe of the pad columns), yi-9b's K4 at e 128, and
    the decodes of the multi-rank serve path (b 2, K4 over a rank's 512
    pages)."""
    results = []
    serve_attention_phases(torch, flush, results, LLAMA_ATTN,
                           ("causal_prefill", "decode", "window_stats",
                            "bf16_decode", "bf16_prefill", "int8_decode"))
    serve_attention_phases(torch, flush, results, JAMBA_ATTN,
                           ("causal_prefill", "decode"))
    serve_attention_phases(torch, flush, results, GPT_ATTN,
                           ("causal_prefill", "decode", "window_stats",
                            "bf16_prefill", "bf16_decode", "int8_decode"))
    serve_attention_phases(torch, flush, results, YI_ATTN,
                           ("bf16_prefill", "bf16_decode", "int8_decode"))
    serve_attention_phases(torch, flush, results, MESH_ATTN,
                           ("decode", "bf16_decode"))
    return results


def serve_attention_phases(torch, flush, results, cell, phases):
    """K3 (``causal_prefill``, ``decode``, ``window_stats``) and K4
    (``bf16_prefill``, ``bf16_decode``, ``int8_decode``) at one serve
    cell's shapes, in the order given, from one seeded generator: each
    against its plain version under the bf16 rule, timed beside it, SDPA
    and the bound, then fed its probes; decodes swept over key splits.
    At a head width that is not a multiple of 64 (96), q, K and V with
    NaN in the first 32 columns of their odd heads must leave the even
    heads' outputs finite and within the rule: the body pads its tiles
    in shared memory and never reads the next head's columns."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(cell["seed"])
    tag, b, h, g, e, S = (cell[k] for k in ("tag", "b", "h", "g", "e", "S"))
    rep = h // g
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    padded = e % 64 != 0
    # decode positions and window lengths spread over the cache, the
    # last near its end: 128 + 256 i at 2048 keys and 8 rows, 64 + 128 i
    # at 1024, 128 + 1792 i at 2048 keys and 2 rows
    spread = (S // 16 + (S - S // 8) // max(b - 1, 1)
              * torch.arange(b, device=dev)).int()

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
    shape = f"b={b} h={h} g={g} e={e}"
    if padded:
        shape += f" (tiles {-(-e // 64) * 64} wide, pad columns zero)"

    def split_sweep(kern, rows):
        """A decode kernel's time against the blocks an SM that the key
        splits aim for (``paged_attention._BLOCKS_AN_SM``; 0 = no split),
        recorded beside the phase's row."""
        keep, res = pa._BLOCKS_AN_SM, {}
        try:
            for w in (0, 1, 2, 4, 8):
                pa._BLOCKS_AN_SM = w
                res[w] = (pa.splits(b, g, rows, S, sms),
                          time_ms(torch, kern, flush))
        finally:
            pa._BLOCKS_AN_SM = keep
        log("[kernel]   key splits, blocks an SM (splits): " + ", ".join(
            f"{w} ({n}) {t:.4f} ms" for w, (n, t) in res.items()))
        results[-1]["split_ms"] = {w: t for w, (_, t) in res.items()}

    def nan_probe(name, run, plain, sel=slice(None)):
        """Odd heads' first 32 columns NaN in q, K and V: the even heads of
        the kernel's out finite and within the rule."""
        got, want = run(), plain()
        got, want = got[sel][:, :, ::2], want[sel][:, :, ::2]
        if not bool(torch.isfinite(want).all()):
            fail(f"{name}: the NaN probe's plain version is not finite")
        finite = bool(torch.isfinite(got).all())
        log(f"[kernel] {name} check, NaN in the first 32 columns of the "
            f"odd heads: even heads finite {finite}")
        if not finite:
            fail(f"{name} reads the next head's columns (NaN in the even "
                 "heads' out)")
        bf16_err(fa, got, want, f"{name} out (even heads)")

    def odd_nan(x):
        x = x.clone()
        x[..., 1::2, :32] = float("nan")
        return x

    # ---- slotted attention (contiguous cache) --------------------------- #
    def slotted_phase(phase, sq):
        q = rand(b, sq, h, e)
        k, v = rand(b, S, g, e), rand(b, S, g, e)
        pos = (torch.linspace(0, S - sq, b, device=dev).int() if sq > 1
               else spread)
        keys = (pos + sq).clamp(max=S)
        kpos = torch.arange(S, device=dev)
        mask = (kpos[None, None, :] <= (pos[:, None] + torch.arange(
            sq, device=dev))[:, :, None])[:, None]
        nbytes = (2 * q.nbytes + pos.nbytes
                  + int(keys.sum()) * g * 2 * e * 2)
        flops = causal_pairs(pos, sq, S) * h * 2 * (e + e)
        ns = pa.splits(b, g, rep * sq, S, sms)
        name = f"slotted_attention:{tag}{phase}"
        log(f"[kernel] {name} {shape} sq={sq} S={S} pos={pos.tolist()} key "
            f"splits {ns} ({tol})")
        lib = sdpa(q, k, v, mask)
        record(name, SLOTTED,
               lambda: pa.flash_attention_slotted(q, k, v, pos=pos),
               lambda: ref.attention(q, k, v, q_offset=pos),
               lib, nbytes, flops, tc_check(lib))
        if sq == 1:
            split_sweep(lambda: pa.flash_attention_slotted(q, k, v, pos=pos),
                        rep)
        # the check must see K with its kv heads rolled by one, and V
        # rolled over kv heads at the keys of the second half only (a
        # fault of late tiles: rows that see no such key stay exact)
        plain = ref.attention(q, k, v, q_offset=pos)
        bf16_probe(fa, (pa.flash_attention_slotted(
            q, k.roll(1, dims=2).contiguous(), v, pos=pos),), (plain,),
            (f"{name} out",), "K's kv heads rolled by one")
        bf16_probe(fa, (pa.flash_attention_slotted(
            q, k, late_rolled(v), pos=pos),), (plain,),
            (f"{name} out",), f"V rolled over kv heads at keys >= {S // 2}")
        if padded:
            qn, kn, vn = odd_nan(q), odd_nan(k), odd_nan(v)
            nan_probe(name, lambda: pa.flash_attention_slotted(
                qn, kn, vn, pos=pos), lambda: ref.attention(
                qn, kn, vn, q_offset=pos))

    # ---- window + stats (decode-attention contract, pos = cache length):
    # the tensor-core body with key splits, its stats from the combine --- #
    def window_phase():
        q = rand(b, 1, h, e)
        k, v = rand(b, S, g, e), rand(b, S, g, e)
        cl = spread
        wmask = (torch.arange(S, device=dev)[None, :] < cl[:, None])[
            :, None, None]
        win_sdpa = sdpa(q, k, v, wmask)
        name = f"slotted_attention:{tag}window_stats"

        def window_excess(a, p, what=""):
            res = pa.window_excess(a, p)
            log(f"[kernel]   window stats{what}: worst |diff| / limit "
                + ", ".join(f"{n} {x:.4f}" for n, x in res.items()))
            return res

        def window_check(a, p):
            bf16_excess(fa, win_sdpa().transpose(1, 2), p[0],
                        "out (SDPA, for the record)")
            res = window_excess(a, p)
            if not max(res.values()) <= 1.0:
                fail(f"{name}: window stats off the plain version: {res}")
            return (a[0].float() - p[0].float()).abs().max().item()

        ns = pa.splits(b, g, rep, S, sms)
        log(f"[kernel] {name} {shape} sq=1 S={S} cache_len={cl.tolist()} "
            f"key splits {ns} (tensor-core body; {tol}; acc by the same "
            f"row rule; m, l: max |diff| <= {pa.STATS_RTOL:g} max |plain|)")
        record(name, SLOTTED,
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
        if not (max(res.values()) <= 1.0
                and bool(torch.isneginf(m0[0]).all())
                and not l0[0].any() and not acc0[0].any()
                and not out0[0].any()):
            fail(f"{name}: a row with cache_len 0 is not m = -inf and "
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
            log(f"[kernel] {name} check, {what}:")
            if not window_excess(bad, plain)[field] > 1.0:
                fail(f"the {name} {field} check passes {what}")
        if padded:
            qn, kn, vn = odd_nan(q), odd_nan(k), odd_nan(v)
            nan_probe(name, lambda: pa.decode_attention(qn, kn, vn, cl)[0],
                      lambda: ref.decode_attention(qn, kn, vn, cl)[0])

    # ---- paged attention (page pool) ------------------------------------ #
    ppr = S // PAGE
    n_pages = cell.get("pages", b * ppr)    # the pool
    # a masked row with a stale table (where there are 4 rows or more),
    # and the row of the page-table probe
    masked, probe = (3 if b > 3 else None), min(7, b - 1)

    def paged_inputs(sq, int8):
        q = rand(b, sq, h, e)
        kf, vf = rand(n_pages, PAGE, g, e), rand(n_pages, PAGE, g, e)
        pos = (torch.linspace(0, S - sq, b, device=dev).int() if sq > 1
               else spread)
        live = (pos + sq + PAGE - 1) // PAGE
        perm = torch.randperm(n_pages, generator=gen, device=dev)[:b * ppr]
        pt = perm.reshape(b, ppr).int()
        pt = torch.where(torch.arange(ppr, device=dev)[None] < live[:, None],
                         pt, 0).int()                  # sentinel tails
        mask = torch.ones(b, dtype=torch.bool, device=dev)
        if masked is not None:
            mask[masked] = False
            pt[masked] = pt[0]                         # stale table
        ks = vs = None
        if int8:
            ks = kf.float().abs().amax(dim=(1, 3)) / 127.0
            vs = vf.float().abs().amax(dim=(1, 3)) / 127.0
            kf = (kf.float() / ks[:, None, :, None]).round().to(torch.int8)
            vf = (vf.float() / vs[:, None, :, None]).round().to(torch.int8)
        return q, kf, vf, ks, vs, pt, pos, mask, live

    def paged_phase(phase, sq, int8):
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
        name = f"paged_attention:{tag}{phase}"

        def check(a, p, mask=mask, tc=tc):
            err = tc(a, p)
            if a[~mask].any():
                fail(f"{name}: a masked row is not exactly zero")
            return err

        ns = pa.splits(b, g, rep * sq, S, sms)
        log(f"[kernel] {name} {shape} sq={sq} page_size={PAGE} ppr={ppr} "
            f"n_pages={n_pages} pos={pos.tolist()} masked_row={masked} key "
            f"splits {ns} ({tol}; a masked row exactly 0)")
        record(name, PAGED,
               lambda: pa.paged_attention(q, kp, vp, **kw),
               lambda: ref.paged_attention(q, kp, vp, **kw),
               lib, nbytes, flops, check)
        if sq == 1:
            split_sweep(lambda: pa.paged_attention(q, kp, vp, **kw), rep)
        plain = ref.paged_attention(q, kp, vp, **kw)
        # the check must see one live page-table entry of one row, past
        # its first 64-key tile, pointed at a page of another row (the
        # last row, or row 7, sees every key of entry 5: keys 80..95)
        wrong = pt.clone()
        wrong[probe, 5] = pt[0, 0]
        bf16_probe(fa, (pa.paged_attention(
            q, kp, vp, **dict(kw, page_tables=wrong)),), (plain,),
            (f"{name} out",),
            f"row {probe}'s page-table entry 5 pointed at row 0's first "
            "page")
        if int8:
            # and V dequantised with the wrong scales: K's, or those of
            # the next kv head
            for what, bad in (("K's scales", ks),
                              ("the next kv head's scales",
                               vs.roll(1, dims=1).contiguous())):
                bf16_probe(fa, (pa.paged_attention(
                    q, kp, vp, **dict(kw, v_scale=bad)),), (plain,),
                    (f"{name} out",), f"V dequantised with {what}")
        elif padded:
            qn, kn, vn = odd_nan(q), odd_nan(kp), odd_nan(vp)
            nan_probe(name, lambda: pa.paged_attention(qn, kn, vn, **kw),
                      lambda: ref.paged_attention(qn, kn, vn, **kw), on)

    run = {"causal_prefill": lambda: slotted_phase("causal_prefill", 512),
           "decode": lambda: slotted_phase("decode", 1),
           "window_stats": window_phase,
           "bf16_decode": lambda: paged_phase("bf16_decode", 1, False),
           "bf16_prefill": lambda: paged_phase("bf16_prefill", 512, False),
           "int8_decode": lambda: paged_phase("int8_decode", 1, True)}
    for phase in phases:
        run[phase]()


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
    results = []
    # one micro-batch: the step's sequences over its four micro-batches
    b, s = GPT["global_batch"] // 4, GPT["seq"]
    flash_phases(torch, flush, results, "gpt_causal_e96", b, s, 24, 24, 96)
    flash_phases(torch, flush, results, "causal_e128", b, s, 32, 32, 128)

    head_xent_phase(torch, flush, results, "gpt_head", b * s,
                    GPT["d_model"], GPT["vocab"], seed=4)
    return results


def head_xent_phase(torch, flush, results, tag, n, d, vocab, seed):
    """K2 over an untied head read in place as [d, vocab] bf16, one
    micro-batch's n rows (the step's denominator: four micro-batches),
    against its plain version, with the probe of the head's bytes read
    as a [vocab, d] table. Where vocab is not a multiple of K2's
    128-column tile, the first rows take the labels of the last, partial
    tile, and the check must fail the kernel run over the head without
    those columns (their labels outside it, their dW columns zero)."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    hn = torch.randn((n, d), generator=gen, device=dev)
    head = (torch.randn((d, vocab), generator=gen, device=dev)
            / d ** 0.5).to(torch.bfloat16)
    lab = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    tail = vocab % fx.TILE
    lab[:tail] = torch.arange(vocab - tail, vocab, device=dev)
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

    log(f"[kernel] fused_xent:{tag} h [{n}, {d}] float32, head.w [{d}, "
        f"{vocab}] bf16 read in place (tolerance: loss 1e-5 relative; dh, "
        "dW max |diff| <= 1e-4 max |plain|)")
    record_phase(torch, flush, results, f"fused_xent:{tag}", XENT,
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
    if tail:
        keep = vocab - tail
        bad = fx.softmax_xent(hn, head[:, :keep].contiguous(),
                              torch.where(lab < keep, lab, -1), **kw)
        dw = torch.zeros_like(plain[1][1])
        dw[:, :keep] = bad[1][1]
        log(f"[kernel] fused_xent check, the last {tail} columns (a "
            f"partial {fx.TILE}-column tile) dropped:")
        _, w_loss = rel_excess(bad[0].reshape(1), plain[0].reshape(1), 1e-5,
                               "loss")
        _, w_dh = rel_excess(bad[1][0], plain[1][0], 1e-4, "dh")
        _, w_dw = rel_excess(dw, plain[1][1], 1e-4, "dW")
        if not (w_loss > 1.0 and w_dh > 1.0 and w_dw > 1.0):
            fail(f"the fused_xent check passes the last {tail} columns "
                 "dropped")


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


def jamba_train_kernel_phases(torch, flush, resources):
    """The kernels of the Jamba training path at its shapes: K5 forward
    and K5b (the scan's backward) at one micro-batch (b 1, s 4096, d
    8192, n 16, float32), each against its plain version, K5b with three
    probes that must fail its rule (the channels of x rolled by one, A's
    sign flipped, B and C swapped); then K2 over Jamba's untied head
    [4096, 65536] at one micro-batch's 4096 rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, d, n = (SCAN_TRAIN[k] for k in ("b", "s", "d", "n"))
    results = []
    x = torch.randn((b, s, d), generator=gen, device=dev)
    dt = torch.exp(torch.empty((b, s, d), device=dev).uniform_(
        -6.9078, -2.3026, generator=gen))
    bm = torch.randn((b, s, n), generator=gen, device=dev)
    cm = torch.randn((b, s, n), generator=gen, device=dev)
    dy = torch.randn((b, s, d), generator=gen, device=dev)
    A = -(torch.arange(1, n + 1, device=dev, dtype=torch.float32)[None]
          * torch.exp(0.1 * torch.randn((d, n), generator=gen, device=dev)))
    D = torch.randn((d,), generator=gen, device=dev)
    f32 = 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    mhz = float(clk[0]) if clk and clk[0].isdigit() else None
    mufu_ms = b * s * d * n / (sms * 16 * mhz * 1e6) * 1e3 if mhz else None

    # K5 forward, y only (the training path's call)
    nbytes = f32 * (3 * b * s * d + 2 * b * s * n + d * n + d)
    log(f"[kernel] selective_scan:train x, dt [{b}, {s}, {d}], A [{d}, "
        f"{n}], float32, y only (tolerance: y max |diff| <= {SCAN_RTOL:g} "
        "max |plain|)")
    record_phase(torch, flush, results, "selective_scan:train", SCAN,
                 lambda: ss.selective_scan(x, dt, A, bm, cm, D),
                 lambda: ref.selective_scan(x, dt, A, bm, cm, D),
                 None, nbytes, b * s * d * (n * 8 + 2),
                 lambda a, p: rel_err(a, p, SCAN_RTOL, "y"),
                 dtype="float32")

    # K5b: read x, dt, dy, B, C, A, D once; write dx, ddt, dA, dB, dC, dD
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    nbytes = f32 * (5 * b * s * d + 4 * b * s * n + 2 * (d * n + d))
    # per (row, step, channel, state): exp, the states' a h + u (3), the
    # cotangent g = C dy + a g (2), w = g a h (2), and g B, w A, dt w,
    # g dt x, dy h into dx, ddt, dA, dB, dC (2 each)
    flops = b * s * d * (n * 18 + 6)
    shape = ss.launch_shape_bwd(n)
    # a block a (channel block, chunk, batch row) in the chunk walk and
    # the reverse walk; the waves of the reverse walk at its occupancy
    nblk = -(-d // (shape["threads"] // shape["lanes"]))
    shape["blocks"] = nblk * -(-s // shape["chunk"]) * b
    shape["waves"] = shape["blocks"] / (shape["blocks_per_sm"] * sms)
    regs = {k: resources.get(f"selective_scan_bwd:{k}<{n}>", {})
            for k in ("chunk_kernel", "bwd_kernel")}
    # exponentials an update: the chunk walk, the reverse walk's
    # sub-checkpoints, its tiles' states and its reverse step
    exps = 4
    log(f"[kernel] selective_scan_bwd launch: {shape['kernels']} kernels a "
        f"call, x, dt, dy read in two passes (the chunk walk, the reverse "
        f"walk); chunks of {shape['chunk']} steps, {shape['blocks']} blocks "
        f"in the chunk walk and in the reverse walk ({shape['waves']:.1f} "
        f"waves on {sms} SMs), {shape['threads']} threads a block "
        f"({shape['lanes']} lanes a channel), tiles of {shape['tile']} "
        f"steps, {shape['smem_bytes']} bytes of shared memory a block, "
        f"{shape['blocks_per_sm']} blocks an SM by the CUDA occupancy "
        "query; ptxas registers / spill bytes: "
        + ", ".join(f"{k} {r.get('registers')} / {r.get('spill_bytes')}"
                    for k, r in regs.items())
        + "; MUFU floor at one exponential an update "
        + (f"{mufu_ms:.4f} ms at {mhz:g} MHz, at this design's {exps} "
           f"{exps * mufu_ms:.4f} ms" if mhz else "not measured"))

    def check(a, p):
        return max(rel_err(g, w, SCAN_BWD_RTOL, nm)
                   for g, w, nm in zip(a, p, names))

    log(f"[kernel] selective_scan_bwd:train x, dt, dy [{b}, {s}, {d}], A "
        f"[{d}, {n}], B, C [{b}, {s}, {n}], float32 (tolerance: each "
        f"gradient max |diff| <= {SCAN_BWD_RTOL:g} max |plain|)")
    record_phase(torch, flush, results, "selective_scan_bwd:train",
                 SCAN_BWD,
                 lambda: ss.selective_scan_bwd(x, dt, A, bm, cm, D, dy),
                 lambda: ref.selective_scan_bwd(x, dt, A, bm, cm, D, dy),
                 None, nbytes, flops, check, dtype="float32")
    results[-1].update(launch=shape, registers=regs, mufu_floor_ms=mufu_ms,
                       design_mufu_floor_ms=(exps * mufu_ms if mhz
                                             else None),
                       sm_clock_max_mhz=mhz)
    plain = ref.selective_scan_bwd(x, dt, A, bm, cm, D, dy)
    again = ss.selective_scan_bwd(x, dt, A, bm, cm, D, dy)
    same = all(torch.equal(u, v) for u, v in zip(
        again, ss.selective_scan_bwd(x, dt, A, bm, cm, D, dy)))
    log(f"[kernel] selective_scan_bwd: two runs bit-identical {same}")
    if not same:
        fail("two runs of selective_scan_bwd differ")
    del again
    for probe, args in (
            ("the channels of x rolled by one",
             (x.roll(1, dims=2).contiguous(), dt, A, bm, cm, D, dy)),
            ("A's sign flipped", (x, dt, (-A).contiguous(), bm, cm, D, dy)),
            ("B and C swapped", (x, dt, A, cm, bm, D, dy))):
        log(f"[kernel] selective_scan_bwd check, {probe}:")
        bad = ss.selective_scan_bwd(*args)
        worst = [rel_excess(g, w, SCAN_BWD_RTOL, nm)[1]
                 for g, w, nm in zip(bad, plain, names)]
        # a non-finite reading fails the rule too (A > 0 overflows)
        if all(w <= 1.0 for w in worst):
            fail(f"the selective_scan_bwd check passes {probe}")
        del bad
    del plain, x, dt, bm, cm, dy
    gc.collect()
    torch.cuda.empty_cache()
    c = JAMBA_TRAIN
    head_xent_phase(torch, flush, results, "jamba_head",
                    c["global_batch"] // 4 * c["seq"], c["d_model"],
                    c["vocab"], seed=8)
    return results


def slice_kernel_phases(torch, flush):
    """The kernels of qwen2-moe's and phi-3-vision's paths at their
    shapes: K1 and K1b at one training micro-batch of each (b 1, s 4096:
    qwen's 16 heads of 128, phi3's 32 of 96, both MHA); K2 over qwen's
    untied head [2048, 151936] and phi3's [3072, 32064] (its last
    128-column tile partial, with the dropped-tile probe) at 4096 rows;
    K3 and K4 at qwen's serve cell (8 rows, 16 heads of 128, MHA, 2048
    keys) and K3 at phi3's (32 heads of 96, MHA: with the NaN probe of
    the pad columns). Returns {"qwen": train rows, "phi3": train rows,
    "serve": serve rows}."""
    out = {}
    for key, c, h, e, seed in (("qwen", QWEN_TRAIN, 16, 128, 9),
                               ("phi3", PHI3_TRAIN, 32, 96, 10)):
        out[key] = []
        flash_phases(torch, flush, out[key], f"{key}_causal_e{e}", 1,
                     c["seq"], h, h, e)
        head_xent_phase(torch, flush, out[key], f"{key}_head",
                        c["global_batch"] // 4 * c["seq"], c["d_model"],
                        c["vocab"], seed=seed)
        gc.collect()
        torch.cuda.empty_cache()
    out["serve"] = []
    serve_attention_phases(torch, flush, out["serve"], QWEN_ATTN,
                           ("causal_prefill", "decode", "bf16_prefill",
                            "bf16_decode"))
    serve_attention_phases(torch, flush, out["serve"], PHI3_ATTN,
                           ("causal_prefill", "decode"))
    return out


def ulp_err(a, p, what: str) -> float:
    """max |a - p| of a bf16 output, failing unless each element is within
    one bf16 ulp of the plain value (|diff| <= 2^-7 (|plain| + mean
    |plain|))."""
    a, p = a.float(), p.float()
    diff = (a - p).abs()
    limit = 2.0 ** -7 * (p.abs() + p.abs().mean())
    worst = (diff / limit).max().item()
    log(f"[kernel]   {what}: max |diff| {diff.max().item():.3e}, max "
        f"|plain| {p.abs().max().item():.3e}, worst |diff| / one-ulp "
        f"limit {worst:.4f}")
    if not worst <= 1.0:
        fail(f"{what}: kernel off its plain version by {worst} x the "
             "one-ulp limit")
    return diff.max().item()


def slstm_kernel_phase(torch, flush):
    """K6 and K6b at the xLSTM paths' shapes (bf16 gates, 4 heads of 512)
    against their plain versions: K6 at one training micro-batch (2 x
    2048 steps) saving the states for K6b, as B's recompute runs it; at
    the serve prefill (8 slots x 512 steps) and one decode step, state in
    and out; K6b at the training micro-batch from those saved states.
    Then K2 over xlstm-1.3b's untied head [2048, 50304] at one
    micro-batch's 4096 rows. Each with the byte bound; the plain
    versions are Python loops over the steps. Logs the sequential floor
    of the design (K6 and K6b timed on one warp, 32 channels, at 2048
    steps: s steps of the dependent chain of one step's arithmetic) and
    the loop-carried floor (s x the two dependent operations of m' =
    max(lf + m, i) at 4 clocks each, at the card's maximum SM clock).
    Probes that must fail: the gates' i and f swapped (K6), the saved
    states shifted by a step (K6b)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as sl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16, f32 = torch.bfloat16, torch.float32
    h, e = SLSTM_H, SLSTM_E
    results = []
    shape = sl.launch_shape()
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    mhz = float(clk[0]) if clk and clk[0].isdigit() else None

    def gates(b, s):
        return torch.randn((b, s, h, 4, e), generator=gen,
                           device=dev).to(bf16)

    def state(b):
        return (torch.randn((b, h, e), generator=gen, device=dev),
                torch.randn((b, h, e), generator=gen, device=dev).abs(),
                torch.randn((b, h, e), generator=gen, device=dev))

    # K6 at the training micro-batch, saving the states
    b, s = SLSTM_SHAPES["train"]
    x = gates(b, s)
    n_ch = b * s * h * e
    log(f"[kernel] slstm_scan launch: {shape['threads']} threads a block, "
        f"one a channel ({b * h * e} channels at the training shape: "
        f"{-(-b * h * e // shape['threads'])} blocks), register tiles of "
        f"{shape['tile_fwd']} steps forward, {shape['tile_bwd']} "
        "backward")
    log(f"[kernel] slstm_scan:train gates [{b}, {s}, {h}, 4, {e}] bf16, "
        "states saved (tolerance: y each element within one bf16 ulp; "
        f"the saved states max |diff| <= {SLSTM_RTOL:g} max |plain|)")
    record_phase(torch, flush, results, "slstm_scan:train", SLSTM,
                 lambda: sl.slstm_scan(x, save_states=True),
                 lambda: ref.slstm_walk(x, None, True),
                 None, 2 * 4 * n_ch + 2 * n_ch + 12 * n_ch,
                 SLSTM_FLOPS["fwd"] * n_ch,
                 lambda a, p: max(ulp_err(a[0], p[0], "y"),
                                  rel_err(a[1], p[2], SLSTM_RTOL,
                                          "saved states")),
                 plain_iters=2, dtype="float32")
    y, states = sl.slstm_scan(x, save_states=True)
    log("[kernel] slstm_scan check, the gates' i and f swapped:")
    bad = sl.slstm_scan(x[:, :, :, [1, 0, 2, 3]].contiguous())
    diff = (bad.float() - y.float()).abs()
    if not (diff > 2.0 ** -7 * (y.float().abs()
                                + y.float().abs().mean())).any():
        fail("the slstm_scan check passes the gates' i and f swapped")
    del bad, diff

    # K6b at the training micro-batch, from those states
    dy = torch.randn((b, s, h, e), generator=gen, device=dev).to(bf16)

    def check_bwd(a, p):
        err = ulp_err(a[0], p[0], "dgates")
        scale = max(w.abs().max().item() for w in p[1])
        d0 = max((g - w).abs().max().item() for g, w in zip(a[1], p[1]))
        log(f"[kernel]   d(state in): max |diff| {d0:.3e}, max |plain| "
            f"{scale:.3e}")
        if not d0 <= SLSTM_RTOL * scale:
            fail(f"slstm_scan_bwd's d(state in) off the plain version's by "
                 f"{d0} (max |plain| {scale})")
        return err

    log(f"[kernel] slstm_scan_bwd:train gates, dy [{b}, {s}, {h}, (4,) "
        f"{e}] bf16, the saved states (tolerance: dgates each element "
        f"within one bf16 ulp; d(state in) max |diff| <= {SLSTM_RTOL:g} "
        "max |plain| of the three)")
    record_phase(torch, flush, results, "slstm_scan_bwd:train", SLSTM,
                 lambda: sl.slstm_scan_bwd(x, dy, states),
                 lambda: ref.slstm_scan_bwd(x, dy, states),
                 None, 2 * 4 * n_ch + 2 * n_ch + 12 * n_ch + 2 * 4 * n_ch
                 + 12 * b * h * e, SLSTM_FLOPS["bwd"] * n_ch, check_bwd,
                 plain_iters=2, dtype="float32")
    again = sl.slstm_scan_bwd(x, dy, states)[0]
    same = torch.equal(again, sl.slstm_scan_bwd(x, dy, states)[0])
    log(f"[kernel] slstm_scan_bwd: two runs bit-identical {same}")
    if not same:
        fail("two runs of slstm_scan_bwd differ")
    log("[kernel] slstm_scan_bwd check, the saved states shifted by a "
        "step:")
    bad = sl.slstm_scan_bwd(x, dy, states.roll(1, dims=2).contiguous())[0]
    diff = (bad.float() - again.float()).abs()
    if not (diff > 2.0 ** -7 * (again.float().abs()
                                + again.float().abs().mean())).any():
        fail("the slstm_scan_bwd check passes the states shifted by a step")
    del bad, diff, again, y, states, dy

    # the sequential floor: one warp (32 channels) walking s steps
    xw = torch.randn((1, s, 1, 4, 32), generator=gen, device=dev).to(bf16)
    yw, sw = sl.slstm_scan(xw, save_states=True)
    dyw = torch.randn_like(yw)
    warp = {"fwd": time_ms(torch, lambda: sl.slstm_scan(xw), flush),
            "fwd_save": time_ms(torch, lambda: sl.slstm_scan(
                xw, save_states=True), flush),
            "bwd": time_ms(torch, lambda: sl.slstm_scan_bwd(xw, dyw, sw),
                           flush)}
    chain = s * 2 * 4 / (mhz * 1e6) * 1e3 if mhz else None
    log(f"[kernel] slstm sequential floor at {s} steps: one warp K6 "
        f"{warp['fwd']:.4f} ms ({warp['fwd_save']:.4f} ms saving the "
        f"states), K6b {warp['bwd']:.4f} ms ({warp['fwd'] / s * 1e6:.1f} "
        f"and {warp['bwd'] / s * 1e6:.1f} ns a step); loop-carried chain "
        + (f"{chain:.4f} ms at {mhz:g} MHz" if chain else "not measured"))
    for row, key in zip(results, ("fwd_save", "bwd")):
        row.update(one_warp_ms=warp[key], chain_floor_ms=chain,
                   sm_clock_max_mhz=mhz, launch=shape)
    del xw, yw, sw, dyw

    # K6 at the serve prefill and one decode step, state in and out
    for tag in ("prefill", "decode"):
        b, s = SLSTM_SHAPES[tag]
        xs, st = gates(b, s), state(b)
        n_ch = b * s * h * e
        log(f"[kernel] slstm_scan:{tag} gates [{b}, {s}, {h}, 4, {e}] "
            "bf16, state in and out (tolerance: y within one bf16 ulp; "
            f"the final state max |diff| <= {SLSTM_RTOL:g} max |plain|)")
        record_phase(
            torch, flush, results, f"slstm_scan:{tag}", SLSTM,
            lambda: sl.slstm_scan(xs, state=st, return_state=True),
            lambda: ref.slstm_scan(xs, state=st, return_state=True),
            None, 2 * 4 * n_ch + 2 * n_ch + 2 * 12 * b * h * e,
            SLSTM_FLOPS["fwd"] * n_ch,
            lambda a, p: max([ulp_err(a[0], p[0], "y")] + [
                rel_err(g, w, SLSTM_RTOL, f"final {nm}")
                for g, w, nm in zip(a[1], p[1], "cnm")]),
            plain_iters=2 if s > 1 else 3, dtype="float32")
        results[-1].update(sm_clock_max_mhz=mhz, launch=shape)
        del xs, st
    c = XLSTM_TRAIN
    head_xent_phase(torch, flush, results, "xlstm_head",
                    c["global_batch"] // 4 * c["seq"], c["d_model"],
                    c["vocab"], seed=12)
    gc.collect()
    torch.cuda.empty_cache()
    return results


def cut_train_phase(torch, cell):
    """A cut training cell on the card (jamba-v0.1-52b's, qwen2-moe's,
    phi-3-vision's, xlstm-1.3b's): step 1 through the kernels and
    through the plain versions (loss and pre-clip gradient norm; with
    ``leaves``, each gradient whose name holds it, Jamba's Mamba leaves,
    xlstm's sLSTM leaves; with ``zero_embed``, the table's gradient
    exactly zero in both runs, a float-embedding batch never reading the
    table; with ``pin_routing``, the plain run replays the kernel run's
    expert picks; with ``step1_layers``, step 1 runs at that cut depth,
    vpp 1, on its own params), then timed steps with the launch counters
    set to 0 before them: step ms, tokens/s, peak memory, aux_sum, for a
    MoE model the dropped assignments (the forward's routing calls), and
    the cell's kernels' launches a step.
    Returns the result row (the session and its state are released)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.models import blocks

    tag = f"[train {cell['arch']}]"
    sess = train_session(cell)
    plain = train_session(cell, overrides=dict(kernel_impl="ref"))
    desc = sess.describe()
    sc = sess.shape_cfg
    mo = sess.cfg.moe
    log(f"{tag} {desc['n_params']} params ({cell['cuts']}), "
        f"{sess.cfg.n_layers} layers, schedule "
        f"{desc['schedule']['name']}, vpp {sess.rc.vpp}, "
        f"{sess.rc.microbatches} micro-batches in units of "
        f"{sess.rc.unit}, batch {sc.global_batch} x {sc.seq_len}"
        + (f"; {mo.n_experts} experts top-{mo.top_k} at capacity factor "
           f"{mo.capacity_factor}, {mo.n_shared} shared of "
           f"{mo.d_ff_shared}" if mo is not None else "")
        + ("; float patch embeddings (the vision stub)"
           if sess.cfg.frontend == "vision" else ""))
    t0 = time.perf_counter()
    params = sess.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"{tag} params ({sess.rc.param_dtype}) in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    stream = sess.stream()
    batch = stream.batch(0)
    if sess.cfg.frontend == "vision" and batch["tokens"].shape != (
            sc.global_batch, sc.seq_len, sess.cfg.d_model):
        fail(f"{tag}: the stream's tokens are {batch['tokens'].shape}, not "
             "float patch embeddings [batch, seq, d_model]")

    def norm(grads):
        sq = sum((g.float() ** 2).sum() for part in ("io", "segments")
                 for g in (grads[part] if part == "io"
                           else grads[part]["main"]).values())
        return float(sq.sqrt())

    # the leaves held one by one (Jamba's Mamba mixers, whose gradients
    # K5b feeds: the norm is mostly the head's and the expert banks')
    def leaf_grads(grads):
        return {n_: g_.float().clone()
                for n_, g_ in grads["segments"]["main"].items()
                if cell.get("leaves") and cell["leaves"] in n_}

    # ---- step 1: kernels vs plain versions ------------------------------ #
    # at a cut depth (vpp 1) where the cell names one, on its own params
    # from seed 0
    depth = cell.get("step1_layers")
    if depth:
        sess1, plain1 = (train_session(cell, layers=depth, overrides=dict(
            vpp=1, **extra)) for extra in ({}, dict(kernel_impl="ref")))
        params1 = sess1.init_params(
            torch.Generator(device="cuda").manual_seed(0))
    else:
        sess1, plain1, params1 = sess, plain, params
    at = f" ({depth} layers, vpp 1)" if depth else ""
    # qwen2-moe's plain run replays the kernel run's expert picks (its
    # router's near ties: see PIN_SERVE)
    rows, leaves, picks = {}, {}, None
    for name, s_ in (("kernels", sess1), ("plain versions", plain1)):
        t0 = time.perf_counter()
        with (blocks.pinned_routing(picks) if cell.get("pin_routing")
              else contextlib.nullcontext()) as picks:
            g, m = s_.train_step(params1, batch)
        torch.cuda.synchronize()
        rows[name] = dict(loss=float(m["loss_sum"]), norm=norm(g),
                          aux=float(m["aux_sum"]),
                          s=time.perf_counter() - t0)
        if cell.get("zero_embed"):
            rows[name]["embed_grad_nonzero"] = int(torch.count_nonzero(
                g["io"]["embed.table"]))
        leaves[name] = leaf_grads(g)
        del g, m
        gc.collect()
        torch.cuda.empty_cache()
    k, p = rows["kernels"], rows["plain versions"]
    log(f"{tag} step 1{at}"
        + (f" (expert picks of {len(picks)} routing calls pinned)"
           if picks is not None else "")
        + f": loss kernels {k['loss']:.6f} ({k['s']:.2f} s), "
        f"plain versions {p['loss']:.6f} ({p['s']:.2f} s); pre-clip grad "
        f"norm {k['norm']:.6f} / {p['norm']:.6f}; aux_sum {k['aux']:.6f} "
        f"/ {p['aux']:.6f}; tolerance loss {CUT_LOSS_RTOL:g}, norm "
        f"{CUT_NORM_RTOL:g} relative")
    if not abs(k["loss"] - p["loss"]) <= CUT_LOSS_RTOL * abs(p["loss"]):
        fail(f"step-1 loss {k['loss']} off the plain versions' {p['loss']}")
    if not abs(k["norm"] - p["norm"]) <= CUT_NORM_RTOL * p["norm"]:
        fail(f"step-1 grad norm {k['norm']} off the plain versions' "
             f"{p['norm']}")
    if not abs(k["loss"] - cell["loss0"]) <= 0.5:
        fail(f"step-1 loss {k['loss']} is not near {cell['loss0']:.3f}")
    if cell.get("zero_embed"):
        log(f"{tag} step 1: embed.table gradient nonzero elements: kernels "
            f"{k['embed_grad_nonzero']}, plain versions "
            f"{p['embed_grad_nonzero']} (a float batch reads no table)")
        if k["embed_grad_nonzero"] or p["embed_grad_nonzero"]:
            fail(f"{tag}: embed.table took a gradient from a float batch")
    # each held leaf: max |kernels - plain| over max |plain|
    leaf_err = {}
    for n_, gp in leaves["plain versions"].items():
        scale = float(gp.abs().max())
        if not scale > 0:
            fail(f"step-1 gradient of {n_} is zero")
        leaf_err[n_] = float(
            (leaves["kernels"][n_] - gp).abs().max()) / scale
    if leaf_err:
        worst = max(leaf_err, key=leaf_err.get)
        log(f"{tag} step 1{at} leaves '{cell['leaves']}', max |kernels - "
            "plain| / max |plain|: "
            + ", ".join(f"{n_} {e_:.3e}"
                        for n_, e_ in sorted(leaf_err.items()))
            + f"; tolerance {JAMBA_LEAF_RTOL:g}")
        if not leaf_err[worst] <= JAMBA_LEAF_RTOL:
            fail(f"step-1 gradient of {worst} is {leaf_err[worst]:.3e} off "
                 f"the plain versions' (tolerance {JAMBA_LEAF_RTOL:g})")
        rows["leaf_err"] = leaf_err
    del plain, leaves, sess1, plain1, params1
    gc.collect()
    torch.cuda.empty_cache()

    # ---- timed steps ---------------------------------------------------- #
    # the dropped assignments of the forward's routing calls (the model
    # counts them; B's recompute routes the same tokens again)
    opt = sess.init_opt_state(params)
    torch.cuda.synchronize()
    for mod in (fa, fx, ss, sl):
        mod.reset_launches()
    base = ops.kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    tokens = sc.global_batch * sc.seq_len
    for i in range(cell["steps"]):
        b = stream.batch(i)
        torch.cuda.synchronize()
        with blocks.counting_drops() as routed:
            t0 = time.perf_counter()
            grads, m = sess.train_step(params, b)
            params, opt, om = sess.opt_step(params, grads, opt)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        del grads
        row = dict(step=i + 1, ms=dt * 1e3, tok_per_s=tokens / dt,
                   loss=float(m["loss_sum"]), aux_sum=float(m["aux_sum"]),
                   grad_norm=float(om["grad_norm"]),
                   dropped=routed["dropped"], assignments=routed["picks"],
                   max_memory_gb=torch.cuda.max_memory_allocated() / 2**30)
        steps.append(row)
        log(f"{tag} step {i + 1}: {row['ms']:.1f} ms, "
            f"{row['tok_per_s']:.1f} tok/s, loss {row['loss']:.4f}, "
            f"aux_sum {row['aux_sum']:.4f}, dropped {row['dropped']} "
            f"of {row['assignments']} assignments, grad norm "
            f"{row['grad_norm']:.3f}, max memory "
            f"{row['max_memory_gb']:.2f} GiB")
    if mo is not None and not all(r["assignments"] for r in steps):
        fail(f"no routing was counted in the timed steps: {steps}")
    launches = train_launches()
    counters = {k_: v - base.get(k_, 0)
                for k_, v in ops.kernel_counters().items()
                if v - base.get(k_, 0)}
    n = cell["steps"]
    log(f"{tag} launches in {n} steps: {launches}; dispatch {counters}")
    for name, per_step in cell["launches"].items():
        if launches[name] != per_step * n:
            fail(f"{name} launched {launches[name]} times in {n} steps, "
                 f"expected {per_step} a step")
    if any(k_.startswith("ref_") for k_ in counters):
        fail(f"the timed steps reached a plain version: {counters}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["aux_sum"])
               for r in steps):
        fail(f"non-finite losses: {steps}")
    res = dict(arch=cell["arch"], n_params=desc["n_params"],
               cuts=cell["cuts"], step1=rows, steps=steps,
               step_ms=sum(r["ms"] for r in steps) / n,
               tok_per_s=sum(r["tok_per_s"] for r in steps) / n,
               max_memory_gb=max(r["max_memory_gb"] for r in steps),
               launches=launches,
               launches_per_step={k_: launches[k_] / n
                                  for k_ in cell["launches"]},
               counters=counters)
    del sess, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
# Train phase
# --------------------------------------------------------------------------- #


def train_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import slstm_scan as sl

    return {**fa.LAUNCHES, **fx.LAUNCHES, **ss.LAUNCHES, **sl.LAUNCHES}


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


def _mem_available() -> int:
    """Host memory available to a new allocation, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    fail("no MemAvailable in /proc/meminfo")


def ckpt_phase(torch, cell, card):
    """gpt-1.5B's train cell under the fault-tolerance controller, the
    checkpoints in a directory of this run that the phase removes."""
    d = OUT / "ckpt"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    try:
        return _ckpt_run(torch, cell, card, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _ckpt_run(torch, cell, card, d):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    tag = f"[ckpt {cell['arch']}]"
    sess = train_session(cell)
    n = sess.describe()["n_params"]
    nbytes = n * CKPT_BYTES_PER_PARAM
    disk, ram = shutil.disk_usage(d).free, _mem_available()
    log(f"{tag} {n} params: {nbytes / 1e9:.3f} GB a checkpoint (bf16 "
        f"params, float32 master, m, v); disk free {disk / 1e9:.1f} GB "
        f"(needs {CKPT_DISK_MARGIN}x), host memory available "
        f"{ram / 1e9:.1f} GB (needs {CKPT_RAM_MARGIN}x)")
    cut = None
    if disk < CKPT_DISK_MARGIN * nbytes or ram < CKPT_RAM_MARGIN * nbytes:
        L = sess.cfg.n_layers
        io = sum(math.prod(sp.shape) for sp in M.io_specs(sess.cfg).values())
        fit = min(disk / CKPT_DISK_MARGIN, ram / CKPT_RAM_MARGIN) \
            / CKPT_BYTES_PER_PARAM
        layers = int((fit - io) // ((n - io) / L)) // 2 * 2
        if layers < 2:
            fail(f"{tag} disk {disk} B / host memory {ram} B hold no "
                 "two-layer checkpoint")
        cut = (f"depth {L} -> {layers} layers: disk free {disk / 1e9:.1f} "
               f"GB, host memory {ram / 1e9:.1f} GB for "
               f"{nbytes / 1e9:.3f} GB checkpoints")
        log(f"{tag} cut: {cut}")
        del sess
        sess = train_session(cell, layers=layers)
        n = sess.describe()["n_params"]
        nbytes = n * CKPT_BYTES_PER_PARAM
    ctl = sess.checkpointing(str(d), every=CKPT["every"], keep=CKPT["keep"],
                             async_save=True, digest=True)
    runs, adopt_s = [], []

    def build(restored, manifest):
        if restored is None:
            params = sess.init_params(
                torch.Generator(device="cuda").manual_seed(0))
            st = {"params": params, "opt": sess.init_opt_state(params)}
        else:
            t0 = time.perf_counter()
            st = sess.adopt_state(restored)
            torch.cuda.synchronize()
            adopt_s.append(time.perf_counter() - t0)
            log(f"{tag} restart {ctl.failures}: resumed at step "
                f"{manifest['extra']['step']}, state on the card in "
                f"{adopt_s[-1]:.2f} s")
        stream = sess.stream()

        def run_one(st, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, m = sess.train_step(st["params"], stream.batch(step))
            p, o, om = sess.opt_step(st["params"], g, st["opt"])
            del g
            row = dict(step=step, loss=float(m["loss_sum"]),
                       grad_norm=float(om["grad_norm"]))
            torch.cuda.synchronize()
            row["ms"] = (time.perf_counter() - t0) * 1e3
            runs.append(row)
            log(f"{tag} step {step}: loss {row['loss']!r}, grad norm "
                f"{row['grad_norm']!r}, {row['ms']:.1f} ms")
            return {"params": p, "opt": o}, {"loss": row["loss"]}

        return st, run_one, lambda s: s

    torch.cuda.synchronize()
    fa.reset_launches()
    fx.reset_launches()
    base = ops.kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = ctl.run(build, CKPT["steps"],
                       inject_failure_at=CKPT["inject_at"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = train_launches()
    counters = {k: v - base.get(k, 0) for k, v in
                ops.kernel_counters().items() if v - base.get(k, 0)}
    del state
    gc.collect()
    torch.cuda.empty_cache()

    ev = {(e["op"], e["step"]): e for e in ctl.mgr.events}
    saves = [e for e in ctl.mgr.events if e["op"] == "save"]
    rest = ev.get(("restore", CKPT["resume"][0]))
    for e in saves:
        log(f"{tag} save of step {e['step']}: {e['bytes']} bytes; host "
            f"snapshot {e['snapshot_s']:.2f} s, disk write "
            f"{e['write_s']:.2f} s (on a thread, beside the steps)")
    if rest is None:
        fail(f"{tag} no restore of step {CKPT['resume'][0]}: "
             f"{ctl.mgr.events}")
    log(f"{tag} restore of step {rest['step']}: {rest['bytes']} bytes read "
        f"in {rest['read_s']:.2f} s (with its sha256), to the card in "
        f"{adopt_s[0]:.2f} s; peak {peak:.2f} GiB allocated over the "
        f"phase; resume_steps {ctl.resume_steps}; {wall:.1f} s in all; "
        f"{card}")
    L, mb = sess.cfg.n_layers, sess.rc.microbatches
    per_step = {"flash_attention_fwd": 2 * L * mb,
                "flash_attention_bwd": L * mb, "fused_xent": 2 * mb}
    log(f"{tag} launches in {len(runs)} steps: {launches}; dispatch "
        f"{counters}")
    if ctl.resume_steps != CKPT["resume"]:
        fail(f"{tag} resume_steps {ctl.resume_steps}, expected "
             f"{CKPT['resume']}")
    if [r["step"] for r in runs] != [0, 1, 2, 2, 3]:
        fail(f"{tag} steps run {[r['step'] for r in runs]}")
    for k, per in per_step.items():
        if launches[k] != per * len(runs):
            fail(f"{tag} {k} launched {launches[k]} times in {len(runs)} "
                 f"steps, expected {per} a step")
    if any(k.startswith("ref_") for k in counters):
        fail(f"{tag} the steps reached a plain version: {counters}")
    if not all(math.isfinite(r["loss"]) for r in runs):
        fail(f"{tag} non-finite losses: {[r['loss'] for r in runs]}")
    before, after = runs[2], runs[3]
    d_norm = abs(after["grad_norm"] - before["grad_norm"]) / \
        before["grad_norm"]
    log(f"{tag} step 2 before / after the restart: loss {before['loss']!r}"
        f" / {after['loss']!r} (must be equal); grad norm relative diff "
        f"{d_norm:.3e} (rule {CKPT_NORM_RTOL:g}); sha256 saved "
        f"{ev[('save', 2)]['sha256'][:16]}, restored "
        f"{rest['sha256'][:16]}")
    if after["loss"] != before["loss"]:
        fail(f"{tag} step 2 loss {after['loss']!r} after the restart, "
             f"{before['loss']!r} before")
    if not d_norm <= CKPT_NORM_RTOL:
        fail(f"{tag} step 2 grad norm {after['grad_norm']} after the "
             f"restart, {before['grad_norm']} before")
    if rest["sha256"] != ev[("save", 2)]["sha256"]:
        fail(f"{tag} the restored state's sha256 differs from the saved")
    return dict(arch=cell["arch"], n_params=n, layers=L, cut=cut,
                ckpt_bytes=saves[0]["bytes"], saves=saves, restore=rest,
                adopt_s=adopt_s[0], peak_gb=peak, wall_s=wall,
                resume_steps=ctl.resume_steps, steps=runs,
                norm_rel=d_norm, launches=launches, counters=counters)


def multirank_phase(torch, c):
    """A multi-rank train cell ``c`` (MULTI, PODS): four ranks, spawned by
    ``python -m repro_torch.launch.train`` as a subprocess, all on this
    card over gloo (host-staged collectives). First one one-rank step of
    the same params (the same seed, its layers re-stacked for pp 1) and
    batch in this process; then rank 0's step-1 loss and pre-clip grad
    norm must agree with it, every rank must have launched K1 and K1b and
    the last stage's ranks K2 (over their vocabulary shard), the pods'
    params must be equal bit for bit, and the subprocess must exit 0."""
    from repro_torch import params as tparams
    from repro_torch.api import session
    from repro_torch.optim import adamw

    pods, name = c.get("pods", 1), c["name"]
    ranks = pods * c["data"] * c["pp"]
    tag = f"[{name}]"
    mesh = (f"pods {pods} x " if pods > 1 else "") + \
        f"data {c['data']} x pp {c['pp']}"
    log(f"{tag} backend {c['backend']} (host-staged), {ranks} ranks on 1 "
        f"device: {c['arch']} {mesh}, batch {c['global_batch']} x "
        f"{c['seq']} {' '.join(c.get('flags', ()))}; cut: {c['cuts']}")
    sess = session(c["arch"], mode="train", reduced=False, device="cuda",
                   seq_len=c["seq"], global_batch=c["global_batch"],
                   layers=c.get("layers"))
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
    log(f"{tag} one-rank step 1 ({sess.cfg.n_layers} layers, pp 1, vpp 2, "
        f"4 micro-batches of {c['global_batch'] // 4}): loss {loss1:.6f}, "
        f"grad norm {norm1:.6f} ({time.perf_counter() - t0:.2f} s)")
    del grads, params, sess
    gc.collect()
    torch.cuda.empty_cache()

    report = OUT / f"{name}.json"
    report.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--full",
           "--arch", c["arch"], "--pods", str(pods), "--data",
           str(c["data"]), "--pp", str(c["pp"]), "--seq", str(c["seq"]),
           "--backend", c["backend"], "--steps", str(c["steps"]),
           "--report", str(report), *c.get("flags", ())]
    if c.get("layers"):
        cmd += ["--layers", str(c["layers"])]
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
        fail(f"the {name} run did not finish in 900 s")
    wall = time.perf_counter() - t0
    (OUT / f"{name}.log").write_text(out + "\n--- stderr ---\n" + err)
    for line in out.splitlines():
        log(f"{tag}   {line}")
    if proc.returncode != 0:
        fail(f"the {name} run exited {proc.returncode}: {err[-2000:]}")
    rep = json.loads(report.read_text())
    steps = rep["steps"]
    lr, nr = steps[0]["loss"], steps[0]["grad_norm"]
    d_loss, d_norm = abs(lr - loss1) / abs(loss1), abs(nr - norm1) / norm1
    log(f"{tag} step 1, rank 0 vs one rank: loss {lr:.6f} vs {loss1:.6f} "
        f"(relative {d_loss:.3e}, rule {MULTI_LOSS_RTOL:g}); grad norm "
        f"{nr:.6f} vs {norm1:.6f} (relative {d_norm:.3e}, rule "
        f"{MULTI_NORM_RTOL:g})")
    if not d_loss <= MULTI_LOSS_RTOL:
        fail(f"{name} step-1 loss {lr} off the one-rank {loss1}")
    if not d_norm <= MULTI_NORM_RTOL:
        fail(f"{name} step-1 grad norm {nr} off the one-rank {norm1}")
    if not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"non-finite {name} losses: {[r['loss'] for r in steps]}")
    replicas = {}
    for r in rep["ranks"]:
        la, co = r["launches"], r["coords"]
        need = ["flash_attention_fwd", "flash_attention_bwd"] + (
            ["fused_xent"] if co["stage"] == c["pp"] - 1 else [])
        missing = [k for k in need if not la.get(k)]
        if missing:
            fail(f"rank {r['rank']} launched no {missing}: {la}")
        if any(k.startswith("ref_") for k in r["counters"]):
            fail(f"rank {r['rank']} reached a plain version: "
                 f"{r['counters']}")
        key = (co["data"], co["group"], co["stage"])
        replicas.setdefault(key, set()).add(r["params_sha256"])
        log(f"{tag} rank {r['rank']} ({r['device']}, {co}): launches {la}, "
            f"peak {r['max_memory_gb']:.2f} GiB allocated; mem_get_info "
            f"after a step: {r['min_free_gb']:.2f} GiB free at the least; "
            f"params sha256 {r['params_sha256'][:16]}")
    split = {k: v for k, v in replicas.items() if len(v) != 1}
    if split:
        fail(f"the pods' params differ after step {len(steps)}: {split}")
    if pods > 1:
        log(f"{tag} after step {len(steps)} the {pods} pods hold equal "
            f"params on each of {len(replicas)} (data, group, stage) "
            "ranks (sha256)")
    for r in steps[1:]:
        log(f"{tag} step {r['step']}: {r['ms']:.1f} ms, "
            f"{r['tok_per_s']:.1f} tok/s, loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f} (no throughput claim: gloo's host "
            "staging sets it)")
    launches = {k: sum(r["launches"].get(k, 0) for r in rep["ranks"])
                for k in ("flash_attention_fwd", "flash_attention_bwd",
                          "fused_xent")}
    log(f"{tag} {wall:.1f} s in all; launches over the ranks {launches}")
    return dict(name=name, backend=c["backend"], ranks=ranks, wall_s=wall,
                mesh=mesh, flags=list(c.get("flags", ())), cuts=c["cuts"],
                one_rank_loss=loss1, one_rank_grad_norm=norm1,
                loss_rel=d_loss, norm_rel=d_norm, steps=steps,
                per_rank=rep["ranks"], launches=launches)


def auto_phase(torch, c):
    """The §4 plan selection on two ranks sharing this card (AUTO): one
    one-rank step of the same params and batch here first, then
    ``python3 chip_smoke.py --auto-ranks`` as a subprocess of its own
    process group, which spawns the ranks (``auto_rank``); its report is
    checked here."""
    from repro_torch import params as tparams
    from repro_torch.api import session
    from repro_torch.optim import adamw

    tag = f"[auto {c['arch']}]"
    log(f"{tag} backend {c['backend']} (host-staged), {c['pp']} ranks on 1 "
        f"device: {c['arch']} pp {c['pp']} x data {c['data']}, vpp "
        f"{c['vpp']}, {c['microbatches']} micro-batches of "
        f"{c['global_batch'] // c['microbatches']} x {c['seq']} in units of "
        f"{c['unit']}; cut: {c['cuts']}")
    sess = session(c["arch"], mode="train", reduced=False, device="cuda",
                   seq_len=c["seq"], global_batch=c["global_batch"],
                   overrides=dict(microbatches=c["microbatches"],
                                  unit=c["unit"]))
    rc_mesh = dataclasses.replace(sess.rc, pp=c["pp"], vpp=c["vpp"])
    full = tparams.init_all_params(
        sess.cfg, rc_mesh, torch.Generator(device="cuda").manual_seed(0),
        "cuda")
    params = tparams.relayout(full, sess.cfg, rc_mesh, sess.rc)
    del full
    grads, m = sess.train_step(params, sess.stream().batch(0))
    loss1 = float(m["loss_sum"])
    norm1 = float(adamw.global_norm(grads))
    log(f"{tag} one-rank step 1 (pp 1, vpp {sess.rc.vpp}, zeropp): loss "
        f"{loss1:.6f}, grad norm {norm1:.6f}")
    del grads, params, sess
    gc.collect()
    torch.cuda.empty_cache()

    conf = OUT / "auto_conf.json"
    report = OUT / "auto.json"
    cache = OUT / "auto_plans.json"
    for f in (report, cache):
        f.unlink(missing_ok=True)
    conf.write_text(json.dumps(dict(c, report=str(report))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [x for x in env.get("PYTHONPATH", "").split(
            os.pathsep) if x])
    env["REPRO_TORCH_PLAN_CACHE"] = str(cache)
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--auto-ranks",
           str(conf)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail("the auto run did not finish in 900 s")
    wall = time.perf_counter() - t0
    (OUT / "auto.log").write_text(out + "\n--- stderr ---\n" + err)
    for line in out.splitlines():
        log(f"{tag}   {line}")
    if proc.returncode != 0:
        fail(f"the auto run exited {proc.returncode}: {err[-2000:]}")
    rep = json.loads(report.read_text())
    r0 = rep["ranks"][0]
    sel = r0["selection"]
    win = sel["auto"]["selected"]
    for name, cand in sorted(
            sel["auto"]["candidates"].items(),
            key=lambda kv: (isinstance(kv[1], str), kv[1]["makespan"]
                            if isinstance(kv[1], dict) else 0)):
        if isinstance(cand, str):
            log(f"{tag} candidate {name}: {cand}")
            continue
        log(f"{tag} candidate {name}: simulated makespan "
            f"{cand['makespan']:.6f} s, peak memory "
            f"{cand['peak_mem'] / 2**30:.3f} GiB, stash depth "
            f"{cand['stash_depth']} (a800 cost model){' <- selected' if name == win else ''}")
    for r in rep["ranks"]:
        if r["schedule"] != win or r["table"] != r0["table"]:
            fail(f"rank {r['rank']} selected {r['schedule']} "
                 f"({r['table'][:16]}), rank 0 {win} ({r0['table'][:16]})")
        again = r["again"]
        if (again["this_session"], again["simulate_calls"],
                again["measure_calls"], again["table"]) != (
                "persisted-hit", 0, 0, r0["table"]):
            fail(f"rank {r['rank']}: the second session of the same key "
                 f"was not a persisted hit of the same plan: {again}")
    log(f"{tag} second session of the same key: a persisted hit on every "
        "rank, 0 simulate and 0 measure calls, the same table")
    runs = {}
    for name in rep["schedules"]:
        rows = [r["runs"][name] for r in rep["ranks"]]
        steps = rows[0]["steps"]
        lr, nr = steps[0]["loss"], steps[0]["grad_norm"]
        d_loss, d_norm = abs(lr - loss1) / abs(loss1), \
            abs(nr - norm1) / norm1
        log(f"{tag} {name}: step 1 vs one rank: loss {lr:.6f} (relative "
            f"{d_loss:.3e}, rule {MULTI_LOSS_RTOL:g}); grad norm {nr:.6f} "
            f"(relative {d_norm:.3e}, rule {MULTI_NORM_RTOL:g})")
        if not d_loss <= MULTI_LOSS_RTOL:
            fail(f"auto {name} step-1 loss {lr} off the one-rank {loss1}")
        if not d_norm <= MULTI_NORM_RTOL:
            fail(f"auto {name} step-1 grad norm {nr} off the one-rank "
                 f"{norm1}")
        for r, row in zip(rep["ranks"], rows):
            if not all(math.isfinite(x["loss"]) for x in row["steps"]):
                fail(f"auto {name}: non-finite losses on rank {r['rank']}")
            la = row["launches"]
            need = ["flash_attention_fwd", "flash_attention_bwd"] + (
                ["fused_xent"] if r["stage"] == c["pp"] - 1 else [])
            missing = [k for k in need if not la.get(k)]
            if missing:
                fail(f"auto {name}: rank {r['rank']} launched no "
                     f"{missing}: {la}")
            if any(k.startswith("ref_") for k in row["counters"]):
                fail(f"auto {name}: rank {r['rank']} reached a plain "
                     f"version: {row['counters']}")
            log(f"{tag} {name} rank {r['rank']} (stage {r['stage']}): "
                "steps " + ", ".join(f"{x['ms']:.1f}" for x in row["steps"])
                + f" ms, peak {row['max_memory_gb']:.2f} GiB allocated, "
                f"launches {la} (no claim: the ranks share the card and "
                "gloo stages on the host)")
        runs[name] = dict(
            loss_rel=d_loss, norm_rel=d_norm,
            makespan=sel["auto"]["candidates"][name]["makespan"],
            ms=[[x["ms"] for x in row["steps"]] for row in rows],
            max_memory_gb=[row["max_memory_gb"] for row in rows],
            launches=[row["launches"] for row in rows])
    prof = r0["profiled"]
    measured = prof["auto"]["measured"]
    survivors = prof["auto"]["profile"]["survivors"]
    order = sorted(measured, key=measured.get)
    for r in rep["ranks"]:
        if r["profiled"]["auto"]["measured"] != measured or \
                r["profiled"]["name"] != prof["name"]:
            fail(f"rank {r['rank']} measured {r['profiled']}, rank 0 "
                 f"{prof}")
    log(f"{tag} auto_profiled (top 2): measured us/step " + ", ".join(
        f"{n}={measured[n]:.1f}" for n in order) + f"; simulated order "
        f"{survivors}; winner {prof['name']}; the measured order "
        f"{'agrees with' if order == survivors else 'differs from'} the "
        "simulated one")
    log(f"{tag} {wall:.1f} s in all")
    return dict(name=c["name"], cuts=c["cuts"], wall_s=wall,
                one_rank_loss=loss1, one_rank_grad_norm=norm1,
                selected=win, candidates=sel["auto"]["candidates"],
                runs=runs, profiled=dict(
                    measured=measured, survivors=survivors,
                    winner=prof["name"], agrees=order == survivors),
                per_rank=rep["ranks"])


def auto_ranks_main(conf_path: str) -> None:
    """``--auto-ranks CONF``: spawn AUTO's ranks, one process each."""
    import socket

    import torch.multiprocessing as mp

    c = json.loads(pathlib.Path(conf_path).read_text())
    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    ctx = mp.start_processes(auto_rank, args=(c, port), nprocs=c["pp"],
                             join=False, start_method="spawn")
    try:
        while not ctx.join():
            pass
    except mp.ProcessRaisedException as e:
        print(f"a rank failed:\n{e}", file=sys.stderr, flush=True)
        sys.exit(1)
    except mp.ProcessExitedException as e:
        print(f"a rank exited: {e}", file=sys.stderr, flush=True)
        sys.exit(1)


def auto_rank(rank: int, c: dict, port: int) -> None:
    """One rank of the auto phase: the selection, its persisted hit, the
    steps under each schedule and the profiled selection; rank 0 writes
    every rank's results to the report."""
    import torch
    import torch.distributed as dist

    from repro_torch.api import session
    from repro_torch.core import plan as tplan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import ops

    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(c["backend"],
                            init_method=f"tcp://localhost:{port}",
                            world_size=c["pp"] * c["data"], rank=rank)
    say = print if rank == 0 else (lambda *a, **k: None)

    def make(schedule, **kw):
        return session(
            c["arch"], mode="train", reduced=False, device="cuda",
            seq_len=c["seq"], global_batch=c["global_batch"],
            data=c["data"], optim=dict(lr=1e-2, warmup=1, total=10_000),
            overrides=dict(pp=c["pp"], vpp=c["vpp"], schedule=schedule,
                           microbatches=c["microbatches"], unit=c["unit"]),
            **kw)

    def table_sha(sess):
        return tplan.table_digest(sess.rt.plans["main"].table)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    try:
        t0 = time.perf_counter()
        sess = make("auto", cost_preset=c["preset"])
        mine = dict(rank=rank, stage=sess.mesh.p_rank,
                    schedule=sess.rc.schedule, table=table_sha(sess),
                    selection=sess.describe()["schedule"], runs={})
        say(f"selection: {sess.rc.schedule} in "
            f"{time.perf_counter() - t0:.2f} s", flush=True)
        tplan.clear_plan_cache()     # in memory: the file stays
        again = make("auto", cost_preset=c["preset"])
        d = again.describe()["schedule"]
        mine["again"] = dict(this_session=d["auto"]["provenance"][
            "this_session"], simulate_calls=d["cache"]["simulate_calls"],
            measure_calls=d["cache"]["measure_calls"],
            table=table_sha(again))
        del again
        names = [sess.rc.schedule] + [n for n in c["compare"]
                                      if n != sess.rc.schedule]
        for name in names:
            s = sess if name == sess.rc.schedule else make(name)
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = s.init_params(gen)
            opt = s.init_opt_state(params)
            stream = s.stream()
            base = dict(ops.kernel_counters())
            fa.reset_launches()
            fx.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps = []
            for i in range(c["steps"]):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                grads, m = s.train_step(params, stream.batch(i))
                params, opt, om = s.opt_step(params, grads, opt)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t1
                del grads
                steps.append(dict(step=i + 1, ms=dt * 1e3,
                                  loss=float(m["loss_sum"]),
                                  grad_norm=float(om["grad_norm"])))
                say(f"{name} step {i + 1}: {dt * 1e3:.1f} ms, loss "
                    f"{steps[-1]['loss']:.6f}", flush=True)
            mine["runs"][name] = dict(
                steps=steps, launches={**fa.LAUNCHES, **fx.LAUNCHES},
                counters={k: v - base.get(k, 0)
                          for k, v in ops.kernel_counters().items()
                          if v - base.get(k, 0)},
                max_memory_gb=torch.cuda.max_memory_allocated() / 2**30)
            del params, opt, s
            release()
        del sess
        release()
        t0 = time.perf_counter()
        prof = make("auto_profiled", cost_preset=c["preset"],
                    profile_top_k=c["top_k"])
        d = prof.describe()["schedule"]
        mine["profiled"] = dict(name=prof.rc.schedule, auto=d["auto"],
                                cache=d["cache"],
                                seconds=time.perf_counter() - t0)
        say(f"auto_profiled: {prof.rc.schedule} in "
            f"{time.perf_counter() - t0:.2f} s", flush=True)
        del prof
        release()
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        if rank == 0:
            pathlib.Path(c["report"]).write_text(json.dumps(
                dict(schedules=names, ranks=every), indent=1,
                default=str))
    finally:
        dist.destroy_process_group()


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


def first_step(torch, sess, params, picks=None, record=False):
    """Logits of one prefill step on fresh caches: slot 0 takes the first
    prompt at position 0, the other slots are masked. With ``picks`` (the
    expert ids and slots an earlier first step recorded) the routing
    replays them (``blocks.pinned_routing``); with ``record`` it routes
    freely and records its picks. Returns (logits, the recorded picks or
    None)."""
    import numpy as np

    from repro_torch.models import blocks

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
    with (blocks.pinned_routing(picks) if record or picks is not None
          else contextlib.nullcontext()) as got:
        _, logits, _ = sess.serve_step_batched(params, caches, batch,
                                               want_logits=True)
    del caches
    torch.cuda.empty_cache()
    return logits[0].float(), got


# the serve cells whose first-step check pins the plain run's expert
# picks to the kernel run's (each layout its own: the kernel runs of the
# two layouts route alike). qwen2-moe's 60-way router sits at near ties
# on random weights: one bf16 rounding flips a token's top-4 set and the
# flips compound over the 24 layers (routing freely, kernels and plain
# read 3.27 apart at a max |logit| of 4.36, the rows whose set differs
# rising from 0.16% at layer 0 to 63% at layer 23; PERF.md §6). Jamba's
# 4 MoE layers route alike in both runs and stay free
PIN_SERVE = {QWEN}


def profile_serve(torch, sess, params, layout, kind="decode", steps=5):
    """Trace ``steps`` serve steps on fresh caches with torch.profiler:
    decode (8 active slots at half the cache: position 1024 of 2048, 512
    of gpt-1.5B's 1024) or prefill (slot 0 takes a
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
                 "pos": np.full(n, sess.spec.max_seq // 2, np.int32),
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
    from repro_torch.kernels import slstm_scan as sl

    return {**pa.LAUNCHES, **ss.LAUNCHES, **sl.LAUNCHES}


def reset_serve_launches():
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import slstm_scan as sl

    for mod in (pa, ss, sl):
        mod.reset_launches()


def serve_phase(torch, layout, params=None, arch=ARCH, max_seq=MAX_SEQ):
    import numpy as np

    from repro_torch.api import session
    from repro_torch.kernels import ops

    kw = dict(page_size=PAGE) if layout == "paged" else {}
    sess = session(arch, reduced=False, device="cuda", max_slots=SLOTS,
                   max_seq=max_seq, **kw)
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
                    max_seq=max_seq, overrides=dict(kernel_impl="ref"), **kw)
    lg_k, picks = first_step(torch, sess, params, record=arch in PIN_SERVE)
    lg_p, _ = first_step(torch, plain, params, picks)
    if not bool(torch.isfinite(lg_k).all()) or lg_k.shape != (vocab,):
        fail(f"{layout}: first-step logits are not finite [vocab] values")
    pinned = (f", expert picks of {len(picks)} routing calls pinned"
              if picks is not None else "")
    wide = arch in FIRST_STEP_F32

    def first_check(a, b, label, held):
        """max |a - b| of the first-step logits, failing by the serve rule
        where ``held``."""
        scale = b.abs().max().item()
        diff = (a - b).abs().max().item()
        log(f"[serve] {arch} {layout}: first-step logits{label} kernel vs "
            f"plain versions{pinned}: max |diff| {diff:.4e} (max |logit| "
            f"{scale:.3f}; "
            + ("tolerance 0.05 * max |logit|" if held else "recorded")
            + f"), argmax {int(a.argmax())} vs {int(b.argmax())}")
        if held and diff > 0.05 * scale:
            fail(f"{layout}: first-step logits{label} off the plain "
                 "versions")
        return diff

    d_plain = first_check(lg_k, lg_p, "", held=not wide)
    d_f32 = None
    if wide:
        # the same weights cast up, both paths in float32 compute
        ov = dict(param_dtype="float32", compute_dtype="float32")
        p32 = {"io": {n: t.float() for n, t in params["io"].items()},
               "segments": {sn: {n: t.float() for n, t in sg.items()}
                            for sn, sg in params["segments"].items()}}
        lg32 = [first_step(torch, session(
            arch, reduced=False, device="cuda", max_slots=SLOTS,
            max_seq=max_seq, overrides=dict(ov, **extra), **kw), p32)[0]
            for extra in ({}, dict(kernel_impl="ref"))]
        del p32
        torch.cuda.empty_cache()
        d_f32 = first_check(*lg32, " (float32 compute)", held=True)

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
    need = ("slstm_scan" if arch == XLSTM else "paged_attention"
            if layout == "paged" else "slotted_attention")
    if launches[need] == 0:
        fail(f"{layout}: the engine run never launched {need}")
    if arch == XLSTM and launches[need] != SLSTM_LAYERS * (
            st.prefill_steps + st.decode_steps):
        # one K6 launch per sLSTM layer a step, prefill and decode
        fail(f"{layout}: slstm_scan launched {launches[need]} times in "
             f"{st.prefill_steps + st.decode_steps} steps, expected "
             f"{SLSTM_LAYERS} a step")
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
        capacity_deferrals=st.capacity_deferrals,
        launches=launches, counters=counters, first_logits_vs_plain=d_plain,
        first_logits_vs_plain_f32=d_f32)
    log(f"[serve] {arch} {layout}: {N_REQ} requests, "
        f"{st.generated_tokens} tokens "
        f"in {wall:.3f} s = {res['tok_per_s']:.1f} tok/s; "
        f"{st.prefill_steps} prefill steps of {res['prefill_step_ms']:.2f} "
        f"ms, {st.decode_steps} decode steps of {res['decode_step_ms']:.2f} "
        f"ms; peak memory {res['max_memory_gb']:.2f} GiB; MoE capacity "
        f"deferrals {st.capacity_deferrals}; launches {launches}; "
        f"dispatch {counters}")
    return res, outs, lg_k, params, sess


def vision_prefill_phase(torch, sess, params):
    """phi-3-vision's float prefill on the card: every slot row prefills
    ``VISION_PREFILL`` patch embeddings drawn from the vision stream
    (seed 0), then ``VISION_DECODE`` greedy steps feed the sampled ids
    through the table, through the kernels (``sess``) and the plain
    versions on the same params, each on fresh caches; the plain run is
    fed the kernel run's ids, so both see the same positions. Every
    row's logits at every step must agree within 0.05 of the row's max
    |logit| (the serve phases' rule); token agreement is counted; step
    ms are the kernel run's (host clock, synchronised)."""
    import numpy as np

    from repro_torch.api import session
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import ops

    tag = f"[serve {PHI3} float prefill]"
    n, d = sess.max_slots, sess.cfg.d_model
    emb = SyntheticStream(DataConfig(
        seq_len=VISION_PREFILL, global_batch=n, vocab=sess.cfg.vocab,
        kind="vision", d_model=d)).batch(0)["tokens"]
    if emb.shape != (n, VISION_PREFILL, d) or emb.dtype != np.float32:
        fail(f"{tag} the stream gave {emb.shape} {emb.dtype}")
    plain = session(PHI3, reduced=False, device="cuda", max_slots=n,
                    max_seq=sess.spec.max_seq,
                    overrides=dict(kernel_impl="ref"))
    caches = {"k": sess.init_caches(), "p": plain.init_caches()}
    reset_serve_launches()
    worst, agree, times = 0.0, 0, {"prefill": [], "decode": []}
    counters = {}       # the kernel run's dispatches
    toks = emb
    for i in range(VISION_DECODE + 1):
        pos = np.full(n, 0 if i == 0 else VISION_PREFILL + i - 1, np.int32)
        out = {}
        for key, s_ in (("k", sess), ("p", plain)):
            base = ops.kernel_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, lg, caches[key] = s_.serve_step_batched(
                params, caches[key], {"tokens": toks, "pos": pos},
                want_logits=True)
            torch.cuda.synchronize()
            if key == "k":
                times["decode" if i else "prefill"].append(
                    (time.perf_counter() - t0) * 1e3)
                for k_, v in ops.kernel_counters().items():
                    if v - base.get(k_, 0):
                        counters[k_] = counters.get(k_, 0) + v - base.get(
                            k_, 0)
            out[key] = (np.asarray(tok), lg.float())
        (tk, lk), (tp, lp) = out["k"], out["p"]
        if lk.shape != (n, sess.cfg.vocab) or not bool(
                torch.isfinite(lk).all()):
            fail(f"{tag} step {i}: logits not finite [{n}, vocab] values")
        row = ((lk - lp).abs().max(dim=1).values
               / lp.abs().max(dim=1).values)
        worst = max(worst, float(row.max()))
        agree += int((tk == tp).sum())
        toks = tk.astype(np.int32)[:, None]
    launches = serve_launches()
    if any(k_.startswith("ref_") for k_ in counters):
        fail(f"{tag} the kernel run reached a plain version: {counters}")
    if launches["slotted_attention"] == 0:
        fail(f"{tag} the kernel run never launched slotted_attention")
    steps = VISION_DECODE + 1
    res = dict(rows=n, prefill=VISION_PREFILL, decode_steps=VISION_DECODE,
               worst_row_diff=worst, token_agreement=agree / (n * steps),
               prefill_ms=times["prefill"][0],
               decode_step_ms=sum(times["decode"]) / VISION_DECODE,
               launches=launches)
    log(f"{tag} {n} rows x {VISION_PREFILL} patch embeddings, then "
        f"{VISION_DECODE} greedy steps: logits kernels vs plain versions, "
        f"worst max |diff| / the row's max |logit| {worst:.4e} (tolerance "
        f"0.05); token agreement {res['token_agreement']:.4f}; prefill "
        f"{res['prefill_ms']:.2f} ms, decode steps "
        f"{res['decode_step_ms']:.2f} ms; launches {launches}")
    if not worst <= 0.05:
        fail(f"{tag} logits off the plain versions by {worst:.4e} of the "
             "row's max |logit|")
    del caches, plain
    gc.collect()
    torch.cuda.empty_cache()
    return res


def serve_multirank_phase(torch, c):
    """Multi-rank serving (SERVE_MULTI): first one rank's serve of the
    same params (the same seed, its layers re-stacked for pp 1) and
    requests here, in both layouts; then ``python -m
    repro_torch.launch.serve`` as a subprocess of its own process group,
    four ranks over gloo on this card, both layouts and then the
    contiguous one with ``serve_resident`` (``contiguous+resident``:
    stage rows whole on each rank) in the one spawn. In each layout the
    logits of every slot row in a prefill step and the decode step after
    it (``launch.serve.first_logits``) must agree with the one-rank ones
    of its cache layout row by row by the serve phases' rule, every rank
    must have launched K3 (contiguous) and K4 (paged) and reached no
    plain version, the resident layout must make no FSDP gather on any
    rank, and the subprocess must exit 0. Step times, tokens/s, each
    rank's peak memory and FSDP gather seconds are logged; no claim."""
    import numpy as np

    from repro_torch import params as tparams
    from repro_torch.api import session
    from repro_torch.launch.serve import first_logits

    tag = f"[serve multirank {c['arch']}]"
    ranks = c["data"] * c["pp"]
    log(f"{tag} backend {c['backend']} (host-staged), {ranks} ranks on 1 "
        f"device: data {c['data']} x pp {c['pp']}, vpp {c['vpp']}, "
        f"{c['microbatches']} micro-batches; {c['slots']} slots, max_seq "
        f"{c['max_seq']}, {c['n_req']} requests x {c['gen']} tokens; cut: "
        f"{c['cuts']}")
    prompts = workload()[:c["n_req"]]
    one = {}
    params = None
    for layout in ("contiguous", "paged"):
        kw = dict(page_size=c["page"]) if layout == "paged" else {}
        sess = session(c["arch"], reduced=False, device="cuda",
                       max_slots=c["slots"], max_seq=c["max_seq"], **kw)
        if params is None:
            rc_mesh = dataclasses.replace(sess.rc, pp=c["pp"], vpp=c["vpp"])
            full = tparams.init_all_params(
                sess.cfg, rc_mesh,
                torch.Generator(device="cuda").manual_seed(0), "cuda")
            params = tparams.relayout(full, sess.cfg, rc_mesh, sess.rc)
            del full
        lg = first_logits(sess, params, prompts)
        eng = sess.serve_engine(params)
        reqs = [eng.submit(p, max_gen=c["gen"]) for p in prompts]
        eng.run_until_idle()
        one[layout] = (lg, [r.result(timeout=1) for r in reqs])
        del eng, sess
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} one rank (pp 1): both layouts served")

    req_file = OUT / "serve_multirank_requests.json"
    req_file.write_text(json.dumps([dict(tokens=p.tolist(), max_gen=c["gen"])
                                    for p in prompts]))
    report = OUT / "serve_multirank.json"
    layouts = ("contiguous", "paged", "contiguous+resident")
    for f in [report] + [pathlib.Path(f"{report}.{lay}.logits.npy")
                         for lay in layouts]:
        f.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--full",
           "--arch", c["arch"], "--data", str(c["data"]), "--pp",
           str(c["pp"]), "--vpp", str(c["vpp"]), "--microbatches",
           str(c["microbatches"]), "--slots", str(c["slots"]), "--max-seq",
           str(c["max_seq"]), "--layouts", ",".join(layouts),
           "--page-size", str(c["page"]), "--backend", c["backend"],
           "--requests", str(req_file), "--report", str(report)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [x for x in env.get("PYTHONPATH", "").split(
            os.pathsep) if x])
    log(f"{tag} {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"the {c['name']} run did not finish in 600 s")
    wall = time.perf_counter() - t0
    (OUT / f"{c['name']}.log").write_text(out + "\n--- stderr ---\n" + err)
    for line in out.splitlines():
        log(f"{tag}   {line}")
    if proc.returncode != 0:
        fail(f"the {c['name']} run exited {proc.returncode}: {err[-2000:]}")
    rep = json.loads(report.read_text())
    need = {"contiguous": "slotted_attention", "paged": "paged_attention"}
    res = dict(name=c["name"], backend=c["backend"], ranks=ranks,
               cuts=c["cuts"], wall_s=wall, layouts={})
    for layout in layouts:
        kind, resident = layout.split("+")[0], layout.endswith("+resident")
        lg1, outs1 = one[kind]
        row = rep["layouts"][layout]
        lg = np.load(f"{report}.{layout}.logits.npy")
        if lg.shape != lg1.shape or not np.isfinite(lg).all():
            fail(f"{layout}: multi-rank logits are not finite [2, "
                 f"{c['slots']}, vocab] values: {lg.shape}")
        # per step and slot row: max |diff| over the row's max |logit|
        rows = np.abs(lg - lg1).max(-1) / np.abs(lg1).max(-1)
        scale = float(np.abs(lg1).max())
        d = float(np.abs(lg - lg1).max())
        same = (lg.argmax(-1) == lg1.argmax(-1)).mean()
        outs = row["streams"]
        if len(outs) != c["n_req"] or any(len(o) != c["gen"] for o in outs):
            fail(f"{layout}: {len(outs)} streams of "
                 f"{[len(o) for o in outs]} tokens")
        agree = sum(a == b for o, o1 in zip(outs, outs1)
                    for a, b in zip(o, o1)) / (c["n_req"] * c["gen"])
        log(f"{tag} {layout}: prefill and decode logits of all "
            f"{c['slots']} rows vs one rank: max |diff| {d:.4e} (max "
            f"|logit| {scale:.4f}); worst row |diff| / its max |logit|: "
            f"prefill {rows[0].max():.4e}, decode {rows[1].max():.4e} "
            f"(tolerance 0.05); argmax agreement {same:.4f}; token "
            f"agreement with one rank {agree:.4f}")
        if not (rows <= 0.05).all():
            fail(f"{layout}: multi-rank logits off the one-rank ones in "
                 f"(step, row) {np.argwhere(rows > 0.05).tolist()}")
        per_rank = []
        for r in rep["ranks"]:
            cnt = r["counts"][layout]
            if not cnt["launches"].get(need[kind]):
                fail(f"{layout}: rank {r['rank']} launched no "
                     f"{need[kind]}: {cnt['launches']}")
            if resident and cnt["gathers"]:
                fail(f"{layout}: rank {r['rank']} made {cnt['gathers']} "
                     "FSDP gathers under serve_resident")
            if any(k.startswith("ref_") for k in cnt["counters"]):
                fail(f"{layout}: rank {r['rank']} reached a plain version: "
                     f"{cnt['counters']}")
            per_rank.append(cnt)
            log(f"{tag} {layout} rank {r['rank']}: launches "
                f"{cnt['launches']}, peak {cnt['max_memory_gb']:.2f} GiB "
                f"allocated, {cnt['gathers']} FSDP gathers: "
                f"{cnt['gather_issue_s']:.2f} s issuing, "
                f"{cnt['gather_wait_s']:.2f} s waiting")
        pre, dec = row["prefill_step_ms"], row["decode_step_ms"]
        log(f"{tag} {layout}: {row['generated_tokens']} tokens in "
            f"{row['wall_s']:.2f} s = {row['tok_per_s']:.2f} tok/s; "
            f"{len(pre)} prefill steps of {np.mean(pre):.1f} ms (min "
            f"{min(pre):.1f}, max {max(pre):.1f}), {len(dec)} decode steps "
            f"of {np.mean(dec):.1f} ms (min {min(dec):.1f}, max "
            f"{max(dec):.1f}) (no claim: the ranks share the card and gloo "
            "stages every gather on the host)")
        res["layouts"][layout] = dict(
            logits_vs_one_rank=d, max_logit=scale,
            worst_row_rel=rows.max(-1).tolist(),
            argmax_agreement=float(same),
            token_agreement=agree, wall_s=row["wall_s"],
            tok_per_s=row["tok_per_s"], prefill_step_ms=pre,
            decode_step_ms=dec,
            launches=sum(r["counts"][layout]["launches"][need[kind]]
                         for r in rep["ranks"]),
            gathers=sum(r["counts"][layout]["gathers"]
                        for r in rep["ranks"]),
            per_rank=per_rank)
    log(f"{tag} {wall:.1f} s in all (subprocess)")
    return res


def compare_layouts(arch, lg_c, lg_p, outs_c, outs_p) -> float:
    """The contiguous and paged runs of one model: first-step logits
    within 0.05 of the largest |logit| (both run the bf16 tensor-core
    bodies, over the same keys in other tiles), token agreement logged
    (greedy streams part at near-ties of random weights)."""
    d = (lg_c - lg_p).abs().max().item()
    agree = sum(a == b for oc, op in zip(outs_c, outs_p)
                for a, b in zip(oc, op)) / (N_REQ * GEN)
    log(f"[serve] {arch} contiguous vs paged: first-step logits max |diff| "
        f"{d:.4e} (tolerance 0.05 * max |logit| = "
        f"{0.05 * lg_c.abs().max().item():.4f}); token agreement "
        f"{agree:.4f}")
    if d > 0.05 * lg_c.abs().max().item():
        fail(f"{arch}: contiguous and paged first-step logits disagree")
    return d


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
    phase_s, last = {}, [t_start]

    def mark(name):
        """Log and keep the seconds since the last mark (the phases' share
        of the run's time limit)."""
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now
        log(f"[time] {name}: {phase_s[name]:.1f} s (at {now - t_start:.1f} "
            "s)")

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
    mark("build")

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    serve_kernels = kernel_phases(torch, flush)
    train_kernels = train_kernel_phases(torch, flush)
    gpt_kernels = gpt_kernel_phases(torch, flush)
    shard_kernels = shard_kernel_phases(torch, flush)
    scan_kernels = scan_kernel_phase(torch, flush, resources)
    jamba_train_kernels = jamba_train_kernel_phases(torch, flush, resources)
    slice_kernels = slice_kernel_phases(torch, flush)
    slstm_kernels = slstm_kernel_phase(torch, flush)
    mark("kernel phases")
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    contig, outs_c, lg_c, params, sess_c = serve_phase(torch, "contiguous")
    paged, outs_p, lg_p, _, sess_p = serve_phase(torch, "paged", params)
    compare_layouts(ARCH, lg_c, lg_p, outs_c, outs_p)
    mark("serve llama3.2-1b")
    serve = [contig, paged]
    kernels = []
    # each training cell frees its session, params and optimizer state
    # before the next phase, so that two peaks never add up
    train = train_phase(torch, LLAMA)
    for row in train_kernels:
        row["launches"] = train["launches"][row["name"].split(":")[0]]
    kernels += train_kernels
    mark("train llama3.2-1b")
    log(f"[train] before gpt: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    train_gpt = train_phase(torch, GPT)
    for row in gpt_kernels:
        row["launches"] = train_gpt["launches"][row["name"].split(":")[0]]
    kernels += gpt_kernels
    mark("train gpt_paper")
    ckpt = ckpt_phase(torch, GPT, card)
    mark("ckpt gpt_paper")
    log(f"[train] before jamba: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    train_jamba = cut_train_phase(torch, JAMBA_TRAIN)
    for row in jamba_train_kernels:
        row["launches"] = train_jamba["launches"][row["name"].split(":")[0]]
    kernels += jamba_train_kernels
    mark("train jamba-v0.1-52b")
    log(f"[serve] before jamba: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    jamba, _, _, params_j, sess_j = serve_phase(torch, "contiguous",
                                                arch=JAMBA)
    serve.append(jamba)
    for row in scan_kernels:
        row["launches"] = jamba["launches"]["selective_scan"]
    kernels += scan_kernels
    # after every timed run: the profiler slows what follows it
    profiles = [profile_serve(torch, s, p, lay, kind, steps)
                for s, p, lay in ((sess_c, params, "contiguous"),
                                  (sess_p, params, "paged"),
                                  (sess_j, params_j, "jamba"))
                for kind, steps in (("decode", 5), ("prefill", 3))]
    mark("serve jamba and profiles")
    del params_j, sess_j, params, sess_c, sess_p
    gc.collect()
    torch.cuda.empty_cache()
    # the paper's gpt-1.5B at full width and depth in both layouts (K3,
    # then K4 at head_dim 96), then yi-9b paged (K4 at 128): 21 GB of
    # weights together, freed after their profiles
    log(f"[serve] before gpt: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    gpt_c, outs_gc, lg_gc, params_g, sess_gc = serve_phase(
        torch, "contiguous", arch=GPT_SERVE, max_seq=GPT_MAX_SEQ)
    gpt_p, outs_gp, lg_gp, _, sess_gp = serve_phase(
        torch, "paged", params_g, arch=GPT_SERVE, max_seq=GPT_MAX_SEQ)
    compare_layouts(GPT_SERVE, lg_gc, lg_gp, outs_gc, outs_gp)
    log(f"[serve] before yi: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    yi, _, _, params_y, sess_y = serve_phase(torch, "paged", arch=YI_SERVE)
    serve += [gpt_c, gpt_p, yi]
    # their profiles after their timed runs
    profiles += [profile_serve(torch, s, p, lay, kind, steps)
                 for s, p, lay in ((sess_gc, params_g, "gpt_contiguous"),
                                   (sess_gp, params_g, "gpt_paged"),
                                   (sess_y, params_y, "yi_paged"))
                 for kind, steps in (("decode", 5), ("prefill", 3))]
    mark("serve gpt_paper, yi-9b and profiles")
    del params_g, sess_gc, sess_gp, params_y, sess_y
    gc.collect()
    torch.cuda.empty_cache()
    # qwen2-moe-a2.7b at full width and depth (28.6 GB of weights) in both
    # layouts (K3, then K4, at e = 128 MHA), its decode profiled
    log(f"[serve] before qwen: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    qwen_c, outs_qc, lg_qc, params_q, sess_qc = serve_phase(
        torch, "contiguous", arch=QWEN)
    qwen_p, outs_qp, lg_qp, params_q, sess_qp = serve_phase(
        torch, "paged", params_q, arch=QWEN)
    compare_layouts(QWEN, lg_qc, lg_qp, outs_qc, outs_qp)
    del sess_qp
    profiles.append(profile_serve(torch, sess_qc, params_q,
                                  "qwen_contiguous", "decode", 5))
    serve += [qwen_c, qwen_p]
    del params_q, sess_qc
    gc.collect()
    torch.cuda.empty_cache()
    mark("serve qwen2-moe-a2.7b")
    train_qwen = cut_train_phase(torch, QWEN_TRAIN)
    mark("train qwen2-moe-a2.7b")
    # phi-3-vision-4.2b at full width and depth (7.6 GB; K3 at e = 96
    # MHA): the engine on token-id prompts, then the float prefill
    phi3, _, _, params_v, sess_v = serve_phase(torch, "contiguous",
                                               arch=PHI3)
    phi3["float_prefill"] = vision_prefill_phase(torch, sess_v, params_v)
    serve.append(phi3)
    del params_v, sess_v
    gc.collect()
    torch.cuda.empty_cache()
    mark("serve phi-3-vision-4.2b")
    train_phi3 = cut_train_phase(torch, PHI3_TRAIN)
    mark("train phi-3-vision-4.2b")
    for cell, train_ in (("qwen", train_qwen), ("phi3", train_phi3)):
        for row in slice_kernels[cell]:
            row["launches"] = train_["launches"][row["name"].split(":")[0]]
        kernels += slice_kernels[cell]
    # xlstm-1.3b at full width and depth (48 layers, 6.8 GB of weights,
    # contiguous caches: K6 at every sLSTM layer of every step), its
    # decode profiled, then the 24-layer training cut (K6, K6b, K2)
    xl, _, _, params_x, sess_x = serve_phase(torch, "contiguous", arch=XLSTM)
    serve.append(xl)
    profiles.append(profile_serve(torch, sess_x, params_x,
                                  "xlstm_contiguous", "decode", 5))
    del params_x, sess_x
    gc.collect()
    torch.cuda.empty_cache()
    mark("serve xlstm-1.3b")
    train_xlstm = cut_train_phase(torch, XLSTM_TRAIN)
    mark("train xlstm-1.3b")
    for row in slstm_kernels:
        lib, phase = row["name"].split(":")
        row["launches"] = (xl if phase in ("prefill", "decode")
                           else train_xlstm)["launches"][lib]
    kernels += slstm_kernels
    # each serving kernel row reads its wrapper's launches in the serve run
    # of its cell: the phase name's tag and the wrapper pick it
    runs = {("", "slotted_attention"): contig, ("", "paged_attention"): paged,
            ("e128_", "slotted_attention"): jamba,
            ("e128_", "paged_attention"): yi,
            ("e96_", "slotted_attention"): gpt_c,
            ("e96_", "paged_attention"): gpt_p,
            ("qwen_", "slotted_attention"): qwen_c,
            ("qwen_", "paged_attention"): qwen_p,
            ("phi3_", "slotted_attention"): phi3}
    def serve_launches(rows):
        for row in rows:
            lib, phase = row["name"].split(":")
            tag = next((t for t in ("e96_", "e128_", "mesh_", "qwen_",
                                    "phi3_") if phase.startswith(t)), "")
            row["launches"] = runs[tag, lib]["launches"][lib]

    serve_kernels += slice_kernels["serve"]
    mesh_kernels = [r for r in serve_kernels if ":mesh_" in r["name"]]
    serve_launches([r for r in serve_kernels if r not in mesh_kernels])
    kernels = serve_kernels + kernels
    profiles += [profile_train(torch, c) for c in (LLAMA, GPT, JAMBA_TRAIN)]
    mark("train profiles")
    gc.collect()
    torch.cuda.empty_cache()
    # last: four ranks share the card, with nothing else on it
    log(f"[multirank] before: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated here, {torch.cuda.mem_get_info()[0] / 2**30:.2f} "
        "GiB of the card free")
    multirank = [multirank_phase(torch, c) for c in (MULTI, PODS)]
    mark("multirank, pods")
    gc.collect()
    torch.cuda.empty_cache()
    auto = auto_phase(torch, AUTO)
    mark("auto gpt_paper")
    gc.collect()
    torch.cuda.empty_cache()
    serve_multi = serve_multirank_phase(torch, SERVE_MULTI)
    mark("serve multirank llama3.2-1b")
    # the multi-rank path's decodes: the four ranks' launches
    for lib, layout in (("slotted_attention", "contiguous"),
                        ("paged_attention", "paged")):
        runs["mesh_", lib] = {"launches": {
            lib: serve_multi["layouts"][layout]["launches"]}}
    serve_launches(mesh_kernels)
    for row in shard_kernels:    # both runs: K2 over a 64,128-row shard
        row["launches"] = sum(r["launches"]["fused_xent"]
                              for r in multirank)
    kernels += shard_kernels
    OUT.joinpath("chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": t_build, "resources": resources,
         "kernels": kernels, "serve": serve,
         "train": [train, train_gpt, train_jamba, train_qwen, train_phi3,
                   train_xlstm],
         "ckpt": ckpt,
         "multirank": multirank,
         "auto": auto, "serve_multirank": serve_multi,
         "profiles": profiles,
         "phase_s": phase_s, "wall_s": time.perf_counter() - t_start},
        indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--auto-ranks"]:
        auto_ranks_main(sys.argv[2])
    else:
        main()
