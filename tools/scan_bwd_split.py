#!/usr/bin/env python3
"""Split K5b (``csrc/selective_scan_bwd.cu``) over its four kernels, on
one NVIDIA GPU.

Run from the root of a checkout, after or without ``chip_smoke.py``::

    python3 tools/scan_bwd_split.py

At Jamba's training shape (``chip_smoke.py``'s ``SCAN_TRAIN``: b 1, s
4096, d 8192, N 16, the inputs of its K5b phase) the kernel, built by
the port from the checkout's sources, must agree with the plain version
within ``SCAN_BWD_RTOL`` on every gradient; it is timed as
``chip_smoke.time_ms`` times the call (device time after an L2 flush),
and one call under ``torch.profiler`` splits its time over the four
kernels (chunk walk, carry pass, reverse walk, fixed-order sums). The
reverse walk's static SASS instructions (``bwd_kernel<16>``, by
cuobjdump) are counted in all and by kind. The last line is the
readings as JSON. Needs CUDA; imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNELS = ("chunk_kernel", "carry_kernel", "bwd_kernel", "reduce_kernel")


def sass_counts(build, so) -> dict | None:
    """Static SASS instructions of the reverse walk (``bwd_kernel<16>``)
    in the library ``so``: in all and of the kinds its step spends
    (shuffles, exponentials, shared-memory loads, float32 arithmetic,
    selects); None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    ops, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "bwd_kernelILi16E" in line
        elif inside:
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", line)
            if m:
                ops.append(m.group(1))
    return {"all": len(ops), **{k: sum(o in v for o in ops) for k, v in (
        ("SHFL", ("SHFL",)), ("MUFU", ("MUFU",)), ("LDS", ("LDS",)),
        ("FP32", ("FFMA", "FMUL", "FADD")), ("FSEL", ("FSEL",)))}}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("scan_bwd_split: needs an NVIDIA GPU")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build, ref, selective_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    so = build.build_all()["selective_scan_bwd"]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, d, n = (cs.SCAN_TRAIN[k] for k in ("b", "s", "d", "n"))
    x = torch.randn((b, s, d), generator=gen, device=dev)
    dt = torch.exp(torch.empty((b, s, d), device=dev).uniform_(
        -6.9078, -2.3026, generator=gen))
    B = torch.randn((b, s, n), generator=gen, device=dev)
    C = torch.randn((b, s, n), generator=gen, device=dev)
    dy = torch.randn((b, s, d), generator=gen, device=dev)
    A = -(torch.arange(1, n + 1, device=dev, dtype=torch.float32)[None]
          * torch.exp(0.1 * torch.randn((d, n), generator=gen, device=dev)))
    D = torch.randn((d,), generator=gen, device=dev)
    want = ref.selective_scan_bwd(x, dt, A, B, C, D, dy)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def call():
        return selective_scan.selective_scan_bwd(x, dt, A, B, C, D, dy)

    got = call()
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("dx", "ddt", "dA", "dB", "dC", "dD")):
        cs.rel_err(g, w, cs.SCAN_BWD_RTOL, what)
    ms = cs.time_ms(torch, call, flush, 10)
    print(f"[split] K5b {ms:.4f} ms a call", flush=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        k = next((k for k in KERNELS if f"{k}<" in ev.key
                  or ev.key.endswith(k) or f"::{k}(" in ev.key), None)
        if k is not None:
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
            split[k] = split.get(k, 0.0) + us / 1e3
    print(f"[split] ms by kernel (profiler, one call) {split}", flush=True)
    sass = sass_counts(build, so)
    print(f"[split] static SASS of bwd_kernel<16> {sass}", flush=True)
    print(json.dumps({"card": smi, "ms": ms, "split_ms": split,
                      "sass": sass}))


if __name__ == "__main__":
    main()
