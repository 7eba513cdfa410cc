"""Dispatch layer: the CUDA kernels for CUDA tensors, the plain versions
for CPU ones.

The port's counterpart of ``repro/kernels/ops.py``. The choice is made per
call from the tensor's device and an explicit ``impl=`` override: "ref"
forces the plain version (``kernels/ref.py``) on any device, "kernel"
forces the kernel and raises on a CPU tensor, None picks by device. A
CUDA tensor never falls back to the plain version by itself: the kernel
runs, or the call raises.

Attention dispatches by the type of its offset, as the reference does
(``repro/kernels/ops.py:62-96``): a tensor offset (per-row positions,
serving) goes to the slotted kernel (K3), a static Python int (training,
causal or bidirectional) to the flash kernels (K1 forward, K1b backward)
through a differentiable ``torch.autograd.Function``. ``softmax_xent``
goes to the fused cross-entropy kernel (K2), ``selective_scan`` to the
selective-scan kernel (K5); ``xent_stats`` / ``xent_grads``, K2's two
passes apart, serve the vocabulary-sharded loss. ``selective_scan_step``,
one decode step of the scan, is plain PyTorch on every device, as in the
reference (which has no kernel for it either); it is not counted.

Every call bumps a process-wide counter (``kernel_counters``), one count
per executed call — the port runs eagerly, so there is no trace-time
distinction; the flash backward counts when autograd runs it
(``kernel_flash_bwd`` / ``ref_flash_bwd``). ``Session.describe()
["kernels"]`` reports per-session deltas.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_xent as fx
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as ss

_COUNTERS: dict[str, int] = {}


def _count(event: str) -> None:
    _COUNTERS[event] = _COUNTERS.get(event, 0) + 1


def kernel_counters() -> dict[str, int]:
    """Snapshot of the dispatch counters (copy, safe to keep)."""
    return dict(_COUNTERS)


def _use_kernel(t, impl: str | None) -> bool:
    if impl == "ref":
        return False
    if impl not in (None, "kernel"):
        raise ValueError(f"unknown impl {impl!r}; pick 'kernel', 'ref' or "
                         "None (by device)")
    if t.device.type == "cuda":
        return True
    if impl == "kernel":
        raise ValueError(f"impl='kernel' needs CUDA tensors, got a tensor "
                         f"on {t.device}")
    return False


def attention(q, k, v, *, causal=True, q_offset=0, block_k=512, impl=None):
    """q: [b, sq, h, e]; k: [b, sk, g, e]; v: [b, sk, g, ev]. A Python int
    ``q_offset`` takes the differentiable flash path (causal or not); a
    tensor offset (0-d or per-row ``[b]``) the causal slotted path."""
    use = _use_kernel(q, impl)
    if isinstance(q_offset, int):
        return fa.attention(q, k, v, causal=causal, q_offset=q_offset,
                            use_kernel=use, count=_count)
    if not use:
        _count("ref_attention")
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset,
                             block_k=block_k)
    if not causal:
        raise ValueError(
            "a tensor q_offset is causal only (the slotted kernel); pass a "
            "Python int offset for bidirectional attention")
    _count("kernel_slotted")
    return pa.flash_attention_slotted(q, k, v, pos=q_offset)


def paged_attention(q, k_pool, v_pool, *, page_tables, pos, k_scale=None,
                    v_scale=None, slot_mask=None, block_k=512, impl=None):
    """Attention straight out of a paged KV pool (optionally int8 pages)."""
    if not _use_kernel(q, impl):
        _count("ref_paged")
        return ref.paged_attention(
            q, k_pool, v_pool, page_tables=page_tables, pos=pos,
            k_scale=k_scale, v_scale=v_scale, slot_mask=slot_mask,
            block_k=block_k)
    _count("kernel_paged")
    return pa.paged_attention(
        q, k_pool, v_pool, page_tables=page_tables, pos=pos,
        k_scale=k_scale, v_scale=v_scale, slot_mask=slot_mask)


def softmax_xent(h, w_head, labels, *, chunk=8192, mask=None, denom=None,
                 impl=None):
    """(loss, (dh, dW [d, vocab] float32)) of softmax cross-entropy over
    the head ``w_head`` [d, vocab]; see ``ref.softmax_xent``."""
    kw = dict(chunk=chunk, mask=mask, denom=denom)
    if not _use_kernel(h, impl):
        _count("ref_xent")
        return ref.softmax_xent(h, w_head, labels, **kw)
    _count("kernel_xent")
    return fx.softmax_xent(h, w_head, labels, **kw)


def xent_stats(h, w_head, labels, *, chunk=8192, impl=None):
    """K2's pass 1 over a (vocabulary-sharded) head: (lse, label logit);
    see ``ref.xent_stats``."""
    if not _use_kernel(h, impl):
        _count("ref_xent_stats")
        return ref.xent_stats(h, w_head, labels, chunk=chunk)
    _count("kernel_xent_stats")
    return fx.xent_stats(h, w_head, labels, chunk=chunk)


def xent_grads(h, w_head, labels, lse, scale, *, chunk=8192, impl=None):
    """K2's pass 2 for a given lse and per-row scale: (dh, dW); see
    ``ref.xent_grads``."""
    if not _use_kernel(h, impl):
        _count("ref_xent_grads")
        return ref.xent_grads(h, w_head, labels, lse, scale, chunk=chunk)
    _count("kernel_xent_grads")
    return fx.xent_grads(h, w_head, labels, lse, scale, chunk=chunk)


def selective_scan(x, dt, A, B, C, D, *, chunk=256, h0=None,
                   return_state=False, impl=None):
    """The Mamba-1 scan over a sequence; see ``ref.selective_scan``."""
    kw = dict(chunk=chunk, h0=h0, return_state=return_state)
    if not _use_kernel(x, impl):
        _count("ref_scan")
        return ref.selective_scan(x, dt, A, B, C, D, **kw)
    _count("kernel_scan")
    return ss.selective_scan(x, dt, A, B, C, D, **kw)


def selective_scan_step(h, x, dt, A, B, C, D):
    """One decode step of the scan (plain PyTorch on every device)."""
    return ref.selective_scan_step(h, x, dt, A, B, C, D)
