"""Selective scan (the Mamba-1 diagonal SSM): the wrapper over K5.

The port's counterpart of ``repro/kernels/selective_scan.py``. Kernel:
``csrc/selective_scan.cu``: a channel's states split over lanes of a warp
(8 states a lane: 2 lanes at d_state 16), each lane walking the sequence
with its states in registers, x, dt, B and C staged through a cp.async
ring. Unlike the TPU
kernel it takes an initial state ``h0`` and returns the final state,
which the serve path's prefill needs (``models/blocks.py
mamba_cached``).

``selective_scan`` takes the plain version (``ref.selective_scan``) for a
tensor on the CPU. For CUDA tensors it checks device, dtype (float32
throughout), shape and contiguity, launches the kernel on the current
stream and raises if the launch is refused: there is no fallback to the
plain version on the card. ``LAUNCHES`` counts the kernel launches, and
nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_attention import _check, _on_cpu, _raise_on

LAUNCHES = {"selective_scan": 0}
_F32 = (torch.float32,)


def reset_launches() -> None:
    LAUNCHES["selective_scan"] = 0


def selective_scan(x, dt, A, B, C, D, *, chunk=256, h0=None,
                   return_state=False):
    """Same contract as ``ref.selective_scan``: x, dt [b, s, d]; A [d, n];
    B, C [b, s, n]; D [d]; optional h0 [b, d, n]. Returns y [b, s, d]
    and, with ``return_state``, the final state [b, d, n] float32. On the
    card every input is float32; ``chunk`` only shapes the plain
    version's memory (the kernel walks the sequence in one pass)."""
    if _on_cpu(x):
        return ref.selective_scan(x, dt, A, B, C, D, chunk=chunk, h0=h0,
                                  return_state=return_state)
    dev = x.device
    for name, t, nd in (("x", x, 3), ("dt", dt, 3), ("A", A, 2),
                        ("B", B, 3), ("C", C, 3), ("D", D, 1)):
        _check(name, t, _F32, nd, dev)
    b, s, d = x.shape
    n = A.shape[1]
    if (tuple(dt.shape) != (b, s, d) or tuple(A.shape) != (d, n)
            or tuple(B.shape) != (b, s, n) or tuple(C.shape) != (b, s, n)
            or tuple(D.shape) != (d,)):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, D "
            f"{tuple(D.shape)} do not agree")
    if h0 is not None:
        _check("h0", h0, _F32, 3, dev)
        if tuple(h0.shape) != (b, d, n):
            raise ValueError(f"h0 must be [{b}, {d}, {n}], got "
                             f"{tuple(h0.shape)}")
    y = torch.empty_like(x)
    h = (torch.empty((b, d, n), dtype=torch.float32, device=dev)
         if return_state else None)
    if b and d:
        fn = build.load("selective_scan").selective_scan
        with torch.cuda.device(dev):
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), D.data_ptr(),
                    None if h0 is None else h0.data_ptr(), y.data_ptr(),
                    None if h is None else h.data_ptr(), b, s, d, n,
                    torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "selective_scan")
        LAUNCHES["selective_scan"] += 1
    return (y, h) if return_state else y


def launch_shape(n: int, d: int) -> dict:
    """How the kernel launches for state size n over d channels on the
    current card: blocks resident on an SM (the CUDA occupancy query),
    threads and dynamic shared memory a block, lanes a channel."""
    import ctypes

    out = (ctypes.c_int * 4)()
    rc = build.load("selective_scan").selective_scan_occupancy(n, d, out)
    _raise_on(rc, "selective_scan_occupancy")
    return dict(blocks_per_sm=out[0], threads=out[1], smem_bytes=out[2],
                lanes=out[3])
