"""Training attention: wrappers over the flash forward and backward kernels.

The port's counterpart of ``repro/kernels/flash_attention.py`` (K1) and of
the ``jax.vjp`` the JAX package takes of it inside ``Tape.prim`` (K1b):

  * ``flash_attention_fwd`` — q ``[b, sq, h, e]``, k ``[b, sk, g, e]``, v
    ``[b, sk, g, ev]``, causal (row i sees ``k <= q_offset + i``) or
    bidirectional, static int ``q_offset``. Returns the output and the
    per-row log-sum-exp ``[b, h, sq]`` float32. Kernel:
    ``csrc/flash_attention_fwd.cu``.
  * ``flash_attention_bwd`` — dq, dk, dv (float32) from q, k, v, the
    output, its cotangent and the log-sum-exp. Kernel:
    ``csrc/flash_attention_bwd.cu``.
  * ``attention`` — the differentiable op (a ``torch.autograd.Function``):
    forward through the first, backward through the second.

Each wrapper takes the plain version (``ref.attention(...,
return_lse=True)``, ``ref.attention_bwd``) for a tensor on the CPU, or
when the caller asks for it (``use_kernel=False``). For a CUDA tensor it
checks device, dtype, shape and contiguity, launches its kernel on the
current stream and raises if the launch is refused: there is no fallback
to the plain version on the card. ``LAUNCHES`` counts the kernel
launches, and nothing else.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_attention import (
    _CODES,
    _check,
    _check_dims,
    _on_cpu,
    _raise_on,
)

LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_qkv(q, k, v):
    dev = q.device
    types = (torch.float32, torch.bfloat16)
    _check("q", q, types, 4, dev)
    _check("k", k, (q.dtype,), 4, dev)
    _check("v", v, (q.dtype,), 4, dev)
    b, sq, h, e = q.shape
    sk, g, ev = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != e:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    _check_dims(e, ev, h, g)
    return b, sq, h, e, sk, g, ev


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention_fwd(q, k, v, *, causal=True, q_offset=0):
    """(out [b, sq, h, ev] in q.dtype, lse [b, h, sq] float32)."""
    q_offset = int(q_offset)
    if _on_cpu(q):
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset,
                             return_lse=True)
    b, sq, h, e, sk, g, ev = _check_qkv(q, k, v)
    dev = q.device
    out = torch.empty((b, sq, h, ev), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if out.numel():
        fn = build.load("flash_attention_fwd").flash_attention_fwd
        with torch.cuda.device(dev):
            rc = fn(_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, h,
                    g, sk, e, ev, int(causal), q_offset, 1.0 / math.sqrt(e),
                    _stream(dev))
        _raise_on(rc, "flash_attention_fwd")
        LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, q_offset=0):
    """(dq, dk, dv) in float32 for ``flash_attention_fwd``'s contract."""
    q_offset = int(q_offset)
    if _on_cpu(q):
        return ref.attention_bwd(q, k, v, o, do, lse, causal=causal,
                                 q_offset=q_offset)
    b, sq, h, e, sk, g, ev = _check_qkv(q, k, v)
    dev = q.device
    _check("o", o, (q.dtype,), 4, dev)
    _check("do", do, (q.dtype,), 4, dev)
    _check("lse", lse, (torch.float32,), 3, dev)
    if tuple(o.shape) != (b, sq, h, ev) or tuple(do.shape) != tuple(
            o.shape) or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty((b, sq, h, e), **f32)
    dk = torch.empty((b, sk, g, e), **f32)
    dv = torch.empty((b, sk, g, ev), **f32)
    if dq.numel():
        d = torch.empty((b, h, sq), **f32)       # rowsum(do * o) scratch
        fn = build.load("flash_attention_bwd").flash_attention_bwd
        with torch.cuda.device(dev):
            rc = fn(_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), d.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), b, sq, h, g, sk, e, ev,
                    int(causal), q_offset, 1.0 / math.sqrt(e), _stream(dev))
        _raise_on(rc, "flash_attention_bwd")
        LAUNCHES["flash_attention_bwd"] += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Differentiable flash attention; ``count`` is called with the
    dispatch event of each forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, use_kernel, count):
        if use_kernel:
            count("kernel_flash")
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           q_offset=q_offset)
        else:
            count("ref_flash")
            out, lse = ref.attention(q, k, v, causal=causal,
                                     q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.use_kernel, ctx.count = use_kernel, count
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if ctx.use_kernel:
            ctx.count("kernel_flash_bwd")
            dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                             causal=ctx.causal,
                                             q_offset=ctx.q_offset)
        else:
            ctx.count("ref_flash_bwd")
            dq, dk, dv = ref.attention_bwd(q, k, v, out, do, lse,
                                           causal=ctx.causal,
                                           q_offset=ctx.q_offset)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def attention(q, k, v, *, causal=True, q_offset=0, use_kernel=True,
              count=lambda event: None):
    """Differentiable attention with a static int ``q_offset``: the flash
    kernels for CUDA tensors when ``use_kernel``, the plain versions
    otherwise. Returns [b, sq, h, ev] in q.dtype."""
    if use_kernel and _on_cpu(q):
        raise ValueError("the flash kernels need CUDA tensors; pass "
                         "use_kernel=False for the plain versions")
    return _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            bool(causal), int(q_offset), bool(use_kernel),
                            count)
