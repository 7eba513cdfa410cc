"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. All sources compile at once, one
``nvcc`` each, at first use. The libraries go to ``build/kernels/`` at
the root of the checkout, named by a digest of the sources and flags, so
an edited source rebuilds and an unchanged one is reused. Nothing is
compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
SOURCES = ("slotted_attention", "paged_attention", "flash_attention_fwd",
           "flash_attention_bwd", "fused_xent", "selective_scan")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each library's C entry points, by source (pointers
# as void*: a bare Python int would be passed as a 32-bit int and cut)
SIGNATURES = {
    "slotted_attention": {"slotted_attention": (
        [_I, _I] + [_P] * 9 + [_I] * 9 + [_F, _P])},
    "paged_attention": {"paged_attention": (
        [_I, _I] + [_P] * 9 + [_I] * 10 + [_F, _P])},
    "flash_attention_fwd": {"flash_attention_fwd": (
        [_I] + [_P] * 5 + [_I] * 9 + [_F, _P])},
    "flash_attention_bwd": {"flash_attention_bwd": (
        [_I] + [_P] * 10 + [_I] * 9 + [_F, _P])},
    "fused_xent": {
        "fused_xent_fwd": [_I, _I] + [_P] * 8 + [_I] * 3 + [_P],
        "fused_xent_bwd": [_I, _I] + [_P] * 9 + [_I] * 4 + [_P],
        "fused_xent_split": [_P, _P, ctypes.c_longlong, _P]},
    "selective_scan": {"selective_scan": [_P] * 9 + [_I] * 4 + [_P],
                       "selective_scan_occupancy": [_I, _I, _P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# name -> {"seconds": wall time of its nvcc, "log": nvcc/ptxas output}
BUILD_LOG: dict[str, dict] = {}
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "kernels/csrc at first use and need the CUDA toolkit")


def lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every library that is not built yet, all nvcc processes at
    once. Raises with the compiler's output on a failure."""
    out = {n: lib_path(n) for n in SOURCES}
    todo = [n for n in SOURCES if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed, with its entry points' argument types declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            for entry, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
