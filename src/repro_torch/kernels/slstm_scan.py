"""The sLSTM recurrence (xLSTM's scalar-memory cell): the wrappers over K6
(the forward) and K6b (its backward).

Kernel: ``csrc/slstm_scan.cu``, one thread a (batch row, head, channel)
walking the sequence with the state (c, n, m) in float32 registers. It
replaces no TPU kernel: the reference runs the cell as a ``lax.scan`` in
plain jnp (``repro/kernels/ref.py:419``), one loop in XLA, which eager
PyTorch could only run as a loop of small launches a step. K6 takes and
returns the state, as the serve path's prefill and decode need
(``models/blocks.py slstm_cached``), and can save the state before each
step for K6b. K6b walks back from the last step, recomputing each step's
forward from its saved state, and gives the gates' gradient and the
initial state's. ``scan`` is the differentiable op of the training path:
forward by K6 (saving the states when a gradient is wanted), backward by
K6b on CUDA tensors, by the plain versions on CPU ones.

``slstm_scan`` and ``slstm_scan_bwd`` take the plain versions
(``ref.slstm_scan``, ``ref.slstm_scan_bwd``) for a tensor on the CPU. For
CUDA tensors they check device, dtype (float32 or bfloat16 gates; the
state float32), shape and contiguity, launch the kernel on the current
stream and raise if the launch is refused: there is no fallback to the
plain version on the card. ``LAUNCHES`` counts the kernel launches, and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_attention import _check, _on_cpu, _raise_on

LAUNCHES = {"slstm_scan": 0, "slstm_scan_bwd": 0}
_TYPES = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_gates(x_gates) -> tuple[int, int, int, int]:
    _check("x_gates", x_gates, _TYPES, 5, x_gates.device)
    b, s, h, four, e = x_gates.shape
    if four != 4:
        raise ValueError(f"x_gates must be [b, s, h, 4, e], got "
                         f"{tuple(x_gates.shape)}")
    return b, s, h, e


def _check_state(name, state, b, h, e, dev):
    if state is None:
        return (None, None, None)
    if len(state) != 3:
        raise ValueError(f"{name} must be (c, n, m)")
    for nm, t in zip("cnm", state):
        _check(f"{name}.{nm}", t, _F32, 3, dev)
        if tuple(t.shape) != (b, h, e):
            raise ValueError(f"{name}.{nm} must be [{b}, {h}, {e}], got "
                             f"{tuple(t.shape)}")
    return tuple(t.data_ptr() for t in state)


def slstm_scan(x_gates, *, state=None, return_state=False,
               save_states=False):
    """Same contract as ``ref.slstm_scan``: x_gates [b, s, h, 4, e] (i, f,
    z, o); optional state (c, n, m) [b, h, e] float32. Returns y [b, s,
    h, e] in x_gates.dtype and, with ``return_state``, the final state;
    with ``save_states`` also the state before each step [3, b, s, h, e]
    float32 (for :func:`slstm_scan_bwd`), as a last element."""
    if _on_cpu(x_gates):
        y, st, states = ref.slstm_walk(x_gates, state, save_states)
    else:
        y, st, states = _launch_fwd(x_gates, state, return_state,
                                    save_states)
    out = (y,) + ((st,) if return_state else ()) + (
        (states,) if save_states else ())
    return out[0] if len(out) == 1 else out


def _launch_fwd(x_gates, state, return_state, save_states):
    dev = x_gates.device
    b, s, h, e = _check_gates(x_gates)
    c0, n0, m0 = _check_state("state", state, b, h, e, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((b, s, h, e), dtype=x_gates.dtype, device=dev)
    st = (tuple(torch.empty((b, h, e), **f32) for _ in range(3))
          if return_state else None)
    states = torch.empty((3, b, s, h, e), **f32) if save_states else None
    if b * h * e and s:
        fn = build.load("slstm_scan").slstm_scan_fwd
        c1, n1, m1 = ((None,) * 3 if st is None
                      else tuple(t.data_ptr() for t in st))
        with torch.cuda.device(dev):
            rc = fn(x_gates.data_ptr(), c0, n0, m0, y.data_ptr(), c1, n1, m1,
                    None if states is None else states.data_ptr(), b, s, h,
                    e, _DTYPE_CODE[x_gates.dtype],
                    torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "slstm_scan")
        LAUNCHES["slstm_scan"] += 1
    elif st is not None:      # no step: the state passes through
        for o, i in zip(st, state or (None,) * 3):
            o.copy_(i) if i is not None else o.zero_()
    return y, st, states


def slstm_scan_bwd(x_gates, dy, states, d_state=None):
    """The gradient of ``slstm_scan``, the contract of
    ``ref.slstm_scan_bwd``: from x_gates, the cotangent dy [b, s, h, e]
    of y (x_gates' dtype), the states K6 saved [3, b, s, h, e] float32
    and the final state's cotangent (dc, dn, dm), zeros when None.
    Returns (dgates [b, s, h, 4, e] in x_gates.dtype, the initial state's
    cotangent (dc, dn, dm) float32)."""
    if _on_cpu(x_gates):
        return ref.slstm_scan_bwd(x_gates, dy, states, d_state)
    dev = x_gates.device
    b, s, h, e = _check_gates(x_gates)
    _check("dy", dy, (x_gates.dtype,), 4, dev)
    _check("states", states, _F32, 5, dev)
    if tuple(dy.shape) != (b, s, h, e) or tuple(states.shape) != (
            3, b, s, h, e):
        raise ValueError(
            f"shapes x_gates {tuple(x_gates.shape)}, dy {tuple(dy.shape)}, "
            f"states {tuple(states.shape)} do not agree")
    dc1, dn1, dm1 = _check_state("d_state", d_state, b, h, e, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dg = torch.empty_like(x_gates)
    d0 = tuple(torch.empty((b, h, e), **f32) for _ in range(3))
    if b * h * e and s:
        fn = build.load("slstm_scan").slstm_scan_bwd
        with torch.cuda.device(dev):
            rc = fn(x_gates.data_ptr(), dy.data_ptr(), states.data_ptr(),
                    dc1, dn1, dm1, dg.data_ptr(),
                    *(t.data_ptr() for t in d0), b, s, h, e,
                    _DTYPE_CODE[x_gates.dtype],
                    torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "slstm_scan_bwd")
        LAUNCHES["slstm_scan_bwd"] += 1
    else:                     # no step: the cotangent passes through
        for o, i in zip(d0, d_state or (None,) * 3):
            o.copy_(i) if i is not None else o.zero_()
    return dg, d0


def launch_shape() -> dict:
    """Threads a block (one a channel) and the steps of the forward's and
    the backward's register tiles."""
    out = (ctypes.c_int * 3)()
    _raise_on(build.load("slstm_scan").slstm_scan_shape(out),
              "slstm_scan_shape")
    return dict(threads=out[0], tile_fwd=out[1], tile_bwd=out[2])


class _Scan(torch.autograd.Function):
    """The differentiable sLSTM (zero initial state, y only): K6 forward
    saving the states and K6b backward, or the plain versions; ``count``
    is called with the dispatch event of each forward and backward."""

    @staticmethod
    def forward(ctx, x_gates, use_kernel, count):
        count("kernel_slstm" if use_kernel else "ref_slstm")
        if use_kernel:
            y, states = slstm_scan(x_gates, save_states=True)
        else:
            y, _, states = ref.slstm_walk(x_gates, save_states=True)
        ctx.save_for_backward(x_gates, states)
        ctx.use_kernel, ctx.count = use_kernel, count
        return y

    @staticmethod
    def backward(ctx, dy):
        x_gates, states = ctx.saved_tensors
        dy = dy.to(x_gates.dtype).contiguous()
        if ctx.use_kernel:
            ctx.count("kernel_slstm_bwd")
            dg, _ = slstm_scan_bwd(x_gates, dy, states)
        else:
            ctx.count("ref_slstm_bwd")
            dg, _ = ref.slstm_scan_bwd(x_gates, dy, states)
        return dg, None, None


def scan(x_gates, *, use_kernel=True, count=lambda event: None):
    """The sLSTM of the training path (zero initial state, y only): K6 /
    K6b for CUDA tensors when ``use_kernel``, the plain versions
    otherwise. Saves the states for the backward only when a gradient is
    wanted (the tape's F task runs without one). Returns y [b, s, h, e]
    in x_gates.dtype."""
    if use_kernel and _on_cpu(x_gates):
        raise ValueError("the sLSTM kernels need CUDA tensors; pass "
                         "use_kernel=False for the plain versions")
    x_gates = x_gates.contiguous()
    if torch.is_grad_enabled() and x_gates.requires_grad:
        return _Scan.apply(x_gates, bool(use_kernel), count)
    count("kernel_slstm" if use_kernel else "ref_slstm")
    if use_kernel:
        return slstm_scan(x_gates)
    return ref.slstm_scan(x_gates)
