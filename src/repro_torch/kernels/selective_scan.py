"""Selective scan (the Mamba-1 diagonal SSM): the wrappers over K5 and
its backward, K5b.

The port's counterpart of ``repro/kernels/selective_scan.py``. Kernel:
``csrc/selective_scan.cu``: a channel's states split over lanes of a warp
(8 states a lane: 2 lanes at d_state 16), each lane walking the sequence
with its states in registers, x, dt, B and C staged through a cp.async
ring. Unlike the TPU
kernel it takes an initial state ``h0`` and returns the final state,
which the serve path's prefill needs (``models/blocks.py
mamba_cached``).

K5b (``csrc/selective_scan_bwd.cu``) is the gradient, which the reference
takes from ``jax.vjp`` over its jnp scan. It cuts the sequence into
chunks of 128 steps that run in parallel: each chunk walks from a zero
state (its local end state, decay and the cotangent it sends back), a
short pass across the chunks gives each chunk's entry state and carry,
each chunk then recomputes its states from its entry state and walks them
back from its carry, and a last pass sums the per-block partials of dB,
dC, dA and dD in a fixed order (no float atomics). ``scan`` is the
differentiable op of the training path: forward by K5, backward by K5b
on CUDA tensors, by the plain versions on CPU ones.

``selective_scan`` and ``selective_scan_bwd`` take the plain versions
(``ref.selective_scan``, ``ref.selective_scan_bwd``) for a tensor on the
CPU. For CUDA tensors they check device, dtype (float32 throughout),
shape and contiguity, launch the kernel on the current stream and raise
if the launch is refused: there is no fallback to the plain version on
the card. ``LAUNCHES`` counts the kernel launches (K5b's four kernels
count once a call), and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_attention import _check, _on_cpu, _raise_on

LAUNCHES = {"selective_scan": 0, "selective_scan_bwd": 0}
_F32 = (torch.float32,)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_shapes(x, dt, A, B, C, D, dy=None) -> None:
    dev = x.device
    for name, t, nd in (("x", x, 3), ("dt", dt, 3), ("A", A, 2),
                        ("B", B, 3), ("C", C, 3), ("D", D, 1)) + (
            () if dy is None else (("dy", dy, 3),)):
        _check(name, t, _F32, nd, dev)
    b, s, d = x.shape
    n = A.shape[1]
    if (tuple(dt.shape) != (b, s, d) or tuple(A.shape) != (d, n)
            or tuple(B.shape) != (b, s, n) or tuple(C.shape) != (b, s, n)
            or tuple(D.shape) != (d,)
            or (dy is not None and tuple(dy.shape) != (b, s, d))):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, D "
            f"{tuple(D.shape)}"
            + ("" if dy is None else f", dy {tuple(dy.shape)}")
            + " do not agree")


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
    _check_shapes(x, dt, A, B, C, D)
    b, s, d = x.shape
    n = A.shape[1]
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
    out = (ctypes.c_int * 4)()
    rc = build.load("selective_scan").selective_scan_occupancy(n, d, out)
    _raise_on(rc, "selective_scan_occupancy")
    return dict(blocks_per_sm=out[0], threads=out[1], smem_bytes=out[2],
                lanes=out[3])


def selective_scan_bwd(x, dt, A, B, C, D, dy):
    """The gradient of ``selective_scan`` (no h0, y only) for the
    cotangent dy: (dx, ddt, dA, dB, dC, dD), the contract of
    ``ref.selective_scan_bwd``. On the card every input is float32 and
    contiguous, the state size 4, 8 or 16 (the kernel walks chunks of
    128 steps in parallel)."""
    if _on_cpu(x):
        return ref.selective_scan_bwd(x, dt, A, B, C, D, dy)
    _check_shapes(x, dt, A, B, C, D, dy)
    b, s, d = x.shape
    n = A.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dA = torch.zeros((d, n), **f32)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dD = torch.zeros((d,), **f32)
    if b and s and d:
        lib = build.load("selective_scan_bwd")
        sizes = (ctypes.c_longlong * 4)()
        _raise_on(lib.selective_scan_bwd_workspace(b, s, d, n, sizes),
                  "selective_scan_bwd")
        ws = torch.empty((sum(sizes),), **f32)
        with torch.cuda.device(x.device):
            rc = lib.selective_scan_bwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                dD.data_ptr(), ws.data_ptr(), b, s, d, n,
                torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(rc, "selective_scan_bwd")
        LAUNCHES["selective_scan_bwd"] += 1
    else:
        dx.zero_()
        ddt.zero_()
    return dx, ddt, dA, dB, dC, dD


def launch_shape_bwd(n: int) -> dict:
    """How K5b's reverse walk launches for state size n on the current
    card: the keys of :func:`launch_shape`, and the steps a chunk (a
    block's share of the sequence), the steps a register tile and the
    kernels a call launches."""
    out = (ctypes.c_int * 7)()
    rc = build.load("selective_scan_bwd").selective_scan_bwd_occupancy(
        n, out)
    _raise_on(rc, "selective_scan_bwd_occupancy")
    return dict(blocks_per_sm=out[0], threads=out[1], smem_bytes=out[2],
                lanes=out[3], chunk=out[4], tile=out[5], kernels=out[6])


class _Scan(torch.autograd.Function):
    """The differentiable scan: K5 forward and K5b backward, or the plain
    versions; ``count`` is called with the dispatch event of each
    forward and backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, use_kernel, count):
        if use_kernel:
            count("kernel_scan")
            y = selective_scan(x, dt, A, B, C, D)
        else:
            count("ref_scan")
            y = ref.selective_scan(x, dt, A, B, C, D)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.use_kernel, ctx.count = use_kernel, count
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, D = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.use_kernel:
            ctx.count("kernel_scan_bwd")
            grads = selective_scan_bwd(x, dt, A, B, C, D, dy)
        else:
            ctx.count("ref_scan_bwd")
            grads = ref.selective_scan_bwd(x, dt, A, B, C, D, dy)
        return (*grads, None, None)


def scan(x, dt, A, B, C, D, *, use_kernel=True, count=lambda event: None):
    """The differentiable scan of the training path (no h0, y only):
    K5 / K5b for CUDA tensors when ``use_kernel``, the plain versions
    otherwise. Returns y [b, s, d] in x.dtype."""
    if use_kernel and _on_cpu(x):
        raise ValueError("the scan kernels need CUDA tensors; pass "
                         "use_kernel=False for the plain versions")
    return _Scan.apply(*(t.contiguous() for t in (x, dt, A, B, C, D)),
                       bool(use_kernel), count)
