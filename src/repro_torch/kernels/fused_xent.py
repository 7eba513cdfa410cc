"""Fused vocabulary cross-entropy: the wrapper over the K2 kernels.

The port's counterpart of ``repro/kernels/fused_xent.py``: loss, dh and
dW of softmax cross-entropy over a ``[d, vocab]`` head without the
``[n, vocab]`` logits reaching device memory. Kernels:
``csrc/fused_xent.cu`` — ``fused_xent_fwd`` (pass 1: per-row log-sum-exp
and label logit) and ``fused_xent_bwd`` (pass 2: dlog one vocabulary
chunk at a time, dW by vocabulary tile, dh by row tile). A bf16 table
(the training path) runs every product on the tensor cores, with h and
dlog each split into two bf16 terms (hi + lo) so that loss, dh and dW
stay within the float32 plain version's tolerance; a float32 table runs
the float32 CUDA-core body.

``softmax_xent`` takes the plain version (``ref.softmax_xent``) for a
tensor on the CPU. For CUDA tensors it checks dtype, shape and layout
(h float32 ``[n, d]``; the head ``[d, vocab]`` float32 or bfloat16, read
in place in one of two layouts: the transposed view of a contiguous
``[vocab, d]`` table, as a tied embedding is, or a contiguous ``[d,
vocab]`` matrix, as an untied ``head.w`` is), launches both passes on the
current stream and raises if a launch is refused; any other layout
raises. ``LAUNCHES`` counts kernel launches, one per pass.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_attention import (
    _CODES, _on_cpu, _ptr, _raise_on)

LAUNCHES = {"fused_xent": 0}
TILE = 128   # the kernels' output tile; the vocabulary chunk is a multiple


def reset_launches() -> None:
    LAUNCHES["fused_xent"] = 0


# the C entries' layout codes: the [vocab, d] table behind a transposed
# view (a tied embedding), or a contiguous [d, vocab] head (head.w)
TABLE, HEAD = 0, 1


def _table(w_head: torch.Tensor, d: int) -> tuple[torch.Tensor, int]:
    """(the contiguous tensor behind the [d, vocab] head w_head, its
    layout code): a [vocab, d] table read through its transpose, or the
    [d, vocab] head itself."""
    if w_head.ndim != 2 or w_head.shape[0] != d:
        raise ValueError(f"w_head {tuple(w_head.shape)} is not a [d = {d}, "
                         "vocab] head")
    if w_head.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w_head has dtype {w_head.dtype}; the kernel "
                         "takes float32 or bfloat16")
    vocab = w_head.shape[1]
    if w_head.is_contiguous() and vocab % 8 == 0:
        base, layout = w_head, HEAD
    elif w_head.t().is_contiguous():
        base, layout = w_head.t(), TABLE
    else:
        raise ValueError(
            f"w_head {tuple(w_head.shape)} with strides {w_head.stride()} "
            "must be a contiguous [d, vocab] head with vocab % 8 == 0, or "
            f"the [d, vocab] transpose of a contiguous [vocab, {d}] table")
    if base.data_ptr() % 16:
        raise ValueError("w_head must be 16-byte aligned")
    return base, layout


def softmax_xent(h, w_head, labels, *, chunk=8192, mask=None, denom=None):
    """Same contract as ``ref.softmax_xent``: (loss, (dh, dW [d, vocab])).

    On the card h must be float32; dh comes back float32 and dW float32
    in the head's layout: a ``[d, vocab]`` view of a contiguous ``[vocab,
    d]`` buffer for a table, a contiguous ``[d, vocab]`` one for a head.
    """
    if _on_cpu(h):
        return ref.softmax_xent(h, w_head, labels, chunk=chunk, mask=mask,
                                denom=denom)
    dev = h.device
    if h.dtype != torch.float32 or h.ndim != 2 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous float32 [n, d] matrix, "
                         f"got {h.dtype} {tuple(h.shape)}")
    n, d = h.shape
    if d % 8:
        raise ValueError(f"d = {d}: the kernels need d % 8 == 0")
    table, layout = _table(w_head, d)
    if table.device != dev:
        raise ValueError(f"w_head is on {table.device}, h on {dev}")
    vocab = w_head.shape[1]
    lab = labels.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
    if lab.shape[0] != n:
        raise ValueError(f"labels {tuple(labels.shape)} do not fit h "
                         f"{tuple(h.shape)}")
    if mask is None:
        mask = torch.ones((n,), dtype=torch.float32, device=dev)
    mask = mask.to(device=dev, dtype=torch.float32).reshape(-1)
    if denom is None:
        denom = torch.clamp_min(mask.sum(), 1.0)
    scale = (mask / denom).contiguous()
    vc = max(TILE, min(-(-int(chunk) // TILE), -(-vocab // TILE)) * TILE)
    f32 = dict(dtype=torch.float32, device=dev)
    lse = torch.empty((n,), **f32)
    labl = torch.empty((n,), **f32)
    dh = torch.empty((n, d), **f32)
    dw = torch.empty((vocab, d) if layout == TABLE else (d, vocab), **f32)
    if n:
        lib = build.load("fused_xent")
        lib_f, lib_b = lib.fused_xent_fwd, lib.fused_xent_bwd
        nvt = -(-vocab // TILE)
        pm = torch.empty((n, nvt), **f32)
        pl = torch.empty((n, nvt), **f32)
        code = _CODES[table.dtype]
        # bf16 table: h as two bf16 terms (written by the fwd call, read
        # by the bwd call) and dlog as two bf16 terms; float32: dlog
        tc = table.dtype == torch.bfloat16
        hs = torch.empty((2, n, d), dtype=torch.bfloat16,
                         device=dev) if tc else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = lib_f(code, layout, h.data_ptr(), table.data_ptr(),
                       lab.data_ptr(), lse.data_ptr(), labl.data_ptr(),
                       pm.data_ptr(), pl.data_ptr(), _ptr(hs), n, d, vocab,
                       stream)
            _raise_on(rc, "fused_xent_fwd")
            LAUNCHES["fused_xent"] += 1
            del pm, pl
            dlog = (torch.empty((2, n, vc), dtype=torch.bfloat16, device=dev)
                    if tc else torch.empty((n, vc), **f32))
            rc = lib_b(code, layout, h.data_ptr(), table.data_ptr(),
                       lab.data_ptr(), lse.data_ptr(), scale.data_ptr(),
                       dh.data_ptr(), dw.data_ptr(), dlog.data_ptr(),
                       _ptr(hs), n, d, vocab, vc, stream)
            _raise_on(rc, "fused_xent_bwd")
            LAUNCHES["fused_xent"] += 1
    else:
        dw.zero_()
    loss = ((lse - labl) * mask).sum() / denom
    return loss, (dh, dw.t() if layout == TABLE else dw)
