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

Both kernels replace TPU work bound by operations (17.2 GFLOP forward and
43 GFLOP backward for a causal call at the training shape: sq = sk =
2048, 32 q heads over 8 kv heads, head dim 64). The C entry point picks
the body by dtype:

  * bfloat16 (the training path): tensor-core bodies. One warpgroup owns
    64 query rows of one kv head (all its q heads), or in the backward's
    dK/dV pass three warpgroups share 64 keys and split the query tiles;
    bf16 tiles in shared memory in the 128-byte swizzle, streamed through
    a two-stage ``cp.async`` ring; every product is a ``wgmma`` (bf16 in,
    float32 accumulate), with P and dS rounded to bf16 in registers as the
    A operand of the products that consume them.
  * float32: CUDA-core bodies (products in float32), for float32 callers
    and tests; no path of the port runs them on the card.

Head widths: e == ev in ``HEAD_DIMS`` (64, 96, 128). The tensor-core
bodies work in 64-column blocks, so e = 96 runs the 128-wide body with
its last 32 columns zero-filled in shared memory (4/3 of the products)
and the softmax scale 1/sqrt(96). Other head widths or dtypes have no
instantiation and raise.
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
# (e == ev) head widths K1 and K1b are instantiated for: llama3.2-1b's 64,
# gpt-1.5B's 96 and the 128 of the wider models
HEAD_DIMS = (64, 96, 128)

# Agreement of the bf16 kernels with the float32 plain versions, element
# by element against the largest |plain| of the element's row (its last
# dim: one position of one head): |kernel - plain| <= BF16_RTOL * that
# row's max |plain|, plus one bf16 ulp of |plain| (2^-7 |plain|) where the
# plain output is bf16 itself (out: both sides round to bf16). The
# tensor-core bodies round P (and dS) to bf16 before their products, as
# FlashAttention does, which costs a few bf16 ulps of the row's largest
# value. A row scale, not the tensor's largest value, keeps late causal
# rows (|out| about 0.04 at 2048 positions against about 4 in the first
# rows) held as tightly as the first ones. tests/test_torch_train_kernels.py
# emulates the kernels' rounding on the CPU and holds it within half of
# this limit. The log-sum-exp sums exact bf16 products in float32 and is
# held to 1e-5 relative.
BF16_RTOL = 1e-2
# a row whose plain values are all near zero (dq of a causal row that sees
# one key cancels exactly) is scaled by this share of the tensor's max
ROW_FLOOR = 1e-3


def bf16_excess(got: torch.Tensor, want: torch.Tensor,
                rtol: float = BF16_RTOL) -> float:
    """The worst ``|got - want|`` over its limit (above 1 fails) for a bf16
    kernel's output against its plain version: ``rtol`` times the largest
    ``|want|`` of the element's row, floored at ``ROW_FLOOR`` of the
    tensor's largest, plus one bf16 ulp of ``|want|`` where ``want`` is
    bf16."""
    ulp = 2.0**-7 if want.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    mag = want.abs()
    row = mag.amax(-1, keepdim=True).clamp_min(
        ROW_FLOOR * mag.max().item())
    limit = rtol * row + ulp * mag
    return ((got - want).abs() / limit).max().item()


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
    _check_dims(e, ev, h, g, HEAD_DIMS)
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
