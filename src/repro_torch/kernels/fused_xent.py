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

Entry points: ``xent_stats`` (pass 1: lse and label logit) and
``xent_grads`` (pass 2: dh and dW for a given lse and per-row scale),
which the vocabulary-sharded loss runs apart with a cross-shard combine
between them, and ``softmax_xent``, their composition (the replicated
head's loss). Labels outside ``[0, vocab)`` — ``-1`` for a row whose label
lies in another vocabulary shard — get label logit 0 in pass 1 and no
one-hot in pass 2.

Each takes the plain version (``ref.xent_stats`` etc.) for a tensor on
the CPU. For CUDA tensors it checks dtype, shape and layout (h float32
``[n, d]``; the head ``[d, vocab]`` float32 or bfloat16, read in place in
one of two layouts: the transposed view of a contiguous ``[vocab, d]``
table, as a tied embedding is, or a contiguous ``[d, vocab]`` matrix, as
an untied ``head.w`` is: with vocab % 8 == 0 (16-byte rows), or, bf16,
any even vocab, such as whisper's 51866 columns, whose 4-byte rows the
kernel fills its tiles from with 4-byte copies), launches its pass on the
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
    # the kernel's row alignment: 16-byte copies, or for a bf16 head 4-byte
    # ones (an even vocab)
    rows_ok = vocab % 8 == 0 or (w_head.dtype == torch.bfloat16
                                 and vocab % 2 == 0)
    if w_head.is_contiguous() and rows_ok:
        base, layout = w_head, HEAD
    elif w_head.t().is_contiguous():
        base, layout = w_head.t(), TABLE
    else:
        raise ValueError(
            f"w_head {w_head.dtype} {tuple(w_head.shape)} with strides "
            f"{w_head.stride()} must be a contiguous [d, vocab] head with "
            "vocab % 8 == 0 (bfloat16: vocab even), or the [d, vocab] "
            f"transpose of a contiguous [vocab, {d}] table")
    if base.data_ptr() % 16:
        raise ValueError("w_head must be 16-byte aligned")
    return base, layout


def _prep(h, w_head, labels):
    """Checks; returns (table, layout, int32 labels)."""
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
    lab = labels.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
    if lab.shape[0] != n:
        raise ValueError(f"labels {tuple(labels.shape)} do not fit h "
                         f"{tuple(h.shape)}")
    return table, layout, lab


def _split(h, table):
    """Scratch for h as two bf16 terms (bf16 table only), or None."""
    if table.dtype != torch.bfloat16:
        return None
    return torch.empty((2,) + tuple(h.shape), dtype=torch.bfloat16,
                       device=h.device)


def _stats(h, table, layout, lab, hs):
    """Pass 1 (writes hs for a bf16 table); returns (lse, labl)."""
    n, d = h.shape
    dev = h.device
    vocab = table.shape[0] if layout == TABLE else table.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    lse = torch.empty((n,), **f32)
    labl = torch.empty((n,), **f32)
    if n:
        nvt = -(-vocab // TILE)
        pm = torch.empty((n, nvt), **f32)
        pl = torch.empty((n, nvt), **f32)
        with torch.cuda.device(dev):
            rc = build.load("fused_xent").fused_xent_fwd(
                _CODES[table.dtype], layout, h.data_ptr(), table.data_ptr(),
                lab.data_ptr(), lse.data_ptr(), labl.data_ptr(),
                pm.data_ptr(), pl.data_ptr(), _ptr(hs), n, d, vocab,
                torch.cuda.current_stream(dev).cuda_stream)
            _raise_on(rc, "fused_xent_fwd")
            LAUNCHES["fused_xent"] += 1
    return lse, labl


def _grads(h, table, layout, lab, lse, scale, hs, chunk):
    """Pass 2 from pass 1's split hs (bf16 table); returns (dh, dW in
    the head's [d, vocab] view)."""
    n, d = h.shape
    dev = h.device
    vocab = table.shape[0] if layout == TABLE else table.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    vc = max(TILE, min(-(-int(chunk) // TILE), -(-vocab // TILE)) * TILE)
    dh = torch.empty((n, d), **f32)
    dw = torch.empty((vocab, d) if layout == TABLE else (d, vocab), **f32)
    if n:
        sc = scale.to(device=dev, dtype=torch.float32).reshape(-1)
        sc = sc.contiguous()
        lse = lse.to(dtype=torch.float32).contiguous()
        # bf16 table: dlog as two bf16 terms; float32: dlog
        dlog = (torch.empty((2, n, vc), dtype=torch.bfloat16, device=dev)
                if hs is not None else torch.empty((n, vc), **f32))
        with torch.cuda.device(dev):
            rc = build.load("fused_xent").fused_xent_bwd(
                _CODES[table.dtype], layout, h.data_ptr(), table.data_ptr(),
                lab.data_ptr(), lse.data_ptr(), sc.data_ptr(),
                dh.data_ptr(), dw.data_ptr(), dlog.data_ptr(), _ptr(hs), n,
                d, vocab, vc, torch.cuda.current_stream(dev).cuda_stream)
            _raise_on(rc, "fused_xent_bwd")
            LAUNCHES["fused_xent"] += 1
    else:
        dw.zero_()
    return dh, (dw.t() if layout == TABLE else dw)


def xent_stats(h, w_head, labels, *, chunk=8192):
    """Pass 1, same contract as ``ref.xent_stats``: (lse [n], label logit
    [n]) float32 over the head ``w_head`` [d, vocab] (a vocabulary
    shard's, with labels local to it and -1 elsewhere)."""
    if _on_cpu(h):
        return ref.xent_stats(h, w_head, labels, chunk=chunk)
    table, layout, lab = _prep(h, w_head, labels)
    return _stats(h, table, layout, lab, _split(h, table))


def xent_grads(h, w_head, labels, lse, scale, *, chunk=8192):
    """Pass 2, same contract as ``ref.xent_grads``: (dh [n, d], dW [d,
    vocab]) float32 for the given lse [n] (combined over the shards) and
    per-row scale [n] (mask / denom). A bf16 head re-splits h into its
    two bf16 terms first (in the same call)."""
    if _on_cpu(h):
        return ref.xent_grads(h, w_head, labels, lse, scale, chunk=chunk)
    table, layout, lab = _prep(h, w_head, labels)
    hs = _split(h, table)
    if hs is not None and h.numel():
        with torch.cuda.device(h.device):
            _raise_on(build.load("fused_xent").fused_xent_split(
                h.data_ptr(), _ptr(hs), h.numel(),
                torch.cuda.current_stream(h.device).cuda_stream),
                "fused_xent_split")
    return _grads(h, table, layout, lab, lse, scale, hs, chunk)


def softmax_xent(h, w_head, labels, *, chunk=8192, mask=None, denom=None):
    """Same contract as ``ref.softmax_xent``: (loss, (dh, dW [d, vocab])),
    pass 1 then pass 2 (which reuses pass 1's split of h).

    On the card h must be float32; dh comes back float32 and dW float32
    in the head's layout: a ``[d, vocab]`` view of a contiguous ``[vocab,
    d]`` buffer for a table, a contiguous ``[d, vocab]`` one for a head.
    """
    if _on_cpu(h):
        return ref.softmax_xent(h, w_head, labels, chunk=chunk, mask=mask,
                                denom=denom)
    table, layout, lab = _prep(h, w_head, labels)
    n = h.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.float32, device=h.device)
    mask = mask.to(device=h.device, dtype=torch.float32).reshape(-1)
    if denom is None:
        denom = torch.clamp_min(mask.sum(), 1.0)
    hs = _split(h, table)
    lse, labl = _stats(h, table, layout, lab, hs)
    dh, dw = _grads(h, table, layout, lab, lse, mask / denom, hs, chunk)
    loss = ((lse - labl) * mask).sum() / denom
    return loss, (dh, dw)
