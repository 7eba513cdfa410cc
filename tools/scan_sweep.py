#!/usr/bin/env python3
"""Time K5 (``csrc/selective_scan.cu``) under other splits of a channel's
states over the lanes of a warp, on one NVIDIA GPU.

Run from the root of a checkout, after or without ``chip_smoke.py``::

    python3 tools/scan_sweep.py

Each variant is the kernel's source with ``lanes<N>()`` (and, where 64
registers would spill, ``MIN_BLOCKS``) changed for N = 16, compiled with
the port's nvcc flags into ``build/scan_sweep/``; ptxas's registers and
spills are printed for its N = 16 entry. At the Jamba prefill's shape
(``chip_smoke.py``'s b 8, s 512, d 8192, N 16, same inputs) each variant
must agree with the plain version within ``SCAN_RTOL``, and is timed as
``chip_smoke.time_ms`` times kernels (device time after an L2 flush), in
turns: every variant, then every variant again in reverse order. The
last line is the times as JSON. Needs CUDA; imports nothing of jax.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "scan_sweep"
# name -> (lanes a channel at N = 16, blocks an SM for __launch_bounds__)
VARIANTS = {"4 lanes x 4 states": (4, 4),
            "2 lanes x 8 states (the kernel)": (2, 4),
            "1 lane x 16 states": (1, 2)}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("scan_sweep: needs an NVIDIA GPU")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    src = (build.CSRC / "selective_scan.cu").read_text()
    lanes_at = "return N >= 8 ? N / 8 : 1;"
    blocks_at = "constexpr int MIN_BLOCKS = 4;"
    if lanes_at not in src or blocks_at not in src:
        sys.exit("scan_sweep: selective_scan.cu no longer has the lines "
                 "the variants change")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (lanes, blocks)) in enumerate(VARIANTS.items()):
        cu = OUT / f"scan_{i}.cu"
        cu.write_text(src.replace(
            lanes_at, f"return N == 16 ? {lanes} : (N >= 8 ? N / 8 : 1);")
            .replace(blocks_at, f"constexpr int MIN_BLOCKS = {blocks};"))
        so = OUT / f"scan_{i}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"scan_sweep: {name} does not build:\n{log}")
        m = re.search(r"scan_kernelILi16ELb1E.*?Used (\d+) registers", log,
                      re.S)
        sp = re.search(r"scan_kernelILi16ELb1E.*?(\d+) bytes spill stores",
                       log, re.S)
        print(f"[sweep] {name}: {m.group(1) if m else '?'} registers, "
              f"{sp.group(1) if sp else '?'} bytes spilled", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.selective_scan.argtypes = \
            build.SIGNATURES["selective_scan"]["selective_scan"]
        lib.selective_scan.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    b, s, d, n = cs.SCAN_B, cs.SCAN_S, cs.SCAN_D, cs.SCAN_N
    x = torch.randn((b, s, d), generator=gen, device=dev)
    dt = torch.exp(torch.empty((b, s, d), device=dev).uniform_(
        -6.9078, -2.3026, generator=gen))
    B = torch.randn((b, s, n), generator=gen, device=dev)
    C = torch.randn((b, s, n), generator=gen, device=dev)
    A = -(torch.arange(1, n + 1, device=dev, dtype=torch.float32)[None]
          * torch.exp(0.1 * torch.randn((d, n), generator=gen, device=dev)))
    D = torch.randn((d,), generator=gen, device=dev)
    want = ref.selective_scan(x, dt, A, B, C, D, return_state=True)
    y, h = torch.empty_like(x), torch.empty((b, d, n), device=dev)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def call(lib):
        def f():
            rc = lib.selective_scan(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), None, y.data_ptr(),
                h.data_ptr(), b, s, d, n,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"selective_scan launch failed ({rc})")
        return f

    times = {}
    for name in list(libs) + list(libs)[::-1]:
        f = call(libs[name])
        f()
        torch.cuda.synchronize()
        for got, w, what in ((y, want[0], "y"), (h, want[1], "h")):
            cs.rel_err(got, w, cs.SCAN_RTOL, f"{name} {what}")
        times.setdefault(name, []).append(cs.time_ms(torch, f, flush, 20))
        print(f"[sweep] {name}: {times[name][-1]:.4f} ms", flush=True)
    print(json.dumps({"card": smi, "ms": times}))


if __name__ == "__main__":
    main()
