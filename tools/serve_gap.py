#!/usr/bin/env python3
"""Where a served model's first step through the kernels leaves the plain
versions, layer by layer, with a float32 run as the second witness.

Runs the first step of ``chip_smoke.py``'s serve phases (slot 0 takes the
workload's first prompt at position 0, the other slots masked; one
contiguous session at the model's one-card run, random weights from seed
0) three ways on one card:

- ``kernels``: bf16 compute through the kernels (K3);
- ``plain``: bf16 compute through the plain versions;
- ``float32``: the plain versions in float32 compute, on the same bf16
  weights cast up (the bf16 copy freed first).

For a MoE model the ``plain`` and ``float32`` runs replay the kernel
run's expert picks (``blocks.pinned_routing``), so that the three differ
only in rounding. Prints, for every layer's output (slot 0's rows of the
residual stream) and then for the logits, ``max |a - b| / max |b|`` for
kernels vs plain, kernels vs float32 and plain vs float32, and writes
them to ``build/chip_smoke/serve_gap.json``::

    python3 tools/serve_gap.py qwen2-moe-a2.7b phi-3-vision-4.2b

Needs one NVIDIA GPU; builds the kernels into ``build/``; imports nothing
of jax.
"""

from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def run(torch, cs, arch: str, base=None, **spec) -> dict:
    """The three runs of one arch; ``base`` and ``spec`` are the session's
    overrides and knobs (by default the one-card run on the card)."""
    from repro_torch.api import session
    from repro_torch.models import model as M

    spec = dict(dict(reduced=False, device="cuda", max_slots=cs.SLOTS,
                     max_seq=cs.MAX_SEQ), **spec)

    def make(**ov):
        return session(arch, overrides=dict(base or {}, **ov), **spec)

    sess = make()
    params = sess.init_params(
        torch.Generator(device=spec["device"]).manual_seed(0))
    moe = sess.cfg.moe is not None
    layer_out: list = []
    inner = M.cached_layer

    def recording(ctx, params_, kind, pfx, x, cache, pos):
        y, c = inner(ctx, params_, kind, pfx, x, cache, pos)
        layer_out.append(y[0].float())       # slot 0's rows
        return y, c

    M.cached_layer = recording
    outs, logits = {}, {}
    try:
        lg, picks = cs.first_step(torch, sess, params, record=moe)
        outs["kernels"], logits["kernels"] = layer_out[:], lg
        layer_out.clear()
        del sess
        plain = make(kernel_impl="ref")
        logits["plain"], _ = cs.first_step(torch, plain, params, picks)
        outs["plain"] = layer_out[:]
        layer_out.clear()
        del plain
        # the same weights in float32, one tensor at a time
        for tree in (params["io"], *params["segments"].values()):
            for n in list(tree):
                tree[n] = tree[n].float()
        gc.collect()
        torch.cuda.empty_cache()
        wide = make(kernel_impl="ref", param_dtype="float32",
                    compute_dtype="float32")
        logits["float32"], _ = cs.first_step(torch, wide, params, picks)
        outs["float32"] = layer_out[:]
        del wide
    finally:
        M.cached_layer = inner
    n = len(outs["kernels"])
    if not n or any(len(v) != n for v in outs.values()):
        cs.fail(f"{arch}: layer records {[len(v) for v in outs.values()]}")
    pairs = (("kernels", "plain"), ("kernels", "float32"),
             ("plain", "float32"))
    res = dict(arch=arch, layers=n, pinned_calls=len(picks or []),
               max_abs_logit=float(logits["plain"].abs().max()),
               logits={f"{a} vs {b}": rel(logits[a], logits[b])
                       for a, b in pairs},
               logits_max_abs_diff={f"{a} vs {b}": float(
                   (logits[a] - logits[b]).abs().max()) for a, b in pairs},
               per_layer={f"{a} vs {b}": [rel(x, y) for x, y in zip(
                   outs[a], outs[b])] for a, b in pairs},
               max_abs_residual=[float(x.abs().max())
                                 for x in outs["float32"]])
    cs.log(f"[gap] {arch}: {n} layers, expert picks of "
           f"{res['pinned_calls']} routing calls pinned; max |a - b| / "
           "max |b| of slot 0's residual stream after each layer, then of "
           "the logits")
    for k, v in res["per_layer"].items():
        cs.log(f"[gap]   {k}: " + " ".join(f"{e:.3e}" for e in v))
    cs.log("[gap]   max |residual| (float32): " + " ".join(
        f"{e:.1f}" for e in res["max_abs_residual"]))
    cs.log(f"[gap]   logits (max |logit| {res['max_abs_logit']:.3f}): "
           + "; ".join(f"{k} {v:.4e} (max |diff| "
                       f"{res['logits_max_abs_diff'][k]:.4e})"
                       for k, v in res["logits"].items()))
    del params, outs, logits
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main() -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        cs.fail("no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.OUT.mkdir(parents=True, exist_ok=True)
    build.build_all()
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip())
    out = [run(torch, cs, arch) for arch in sys.argv[1:]]
    (cs.OUT / "serve_gap.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
