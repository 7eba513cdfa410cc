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
selective-scan kernel (K5) and ``selective_scan_train``, the training
path's differentiable scan, to K5 forward and K5b backward through a
``torch.autograd.Function``; ``xent_stats`` / ``xent_grads``, K2's two
passes apart, serve the vocabulary-sharded loss. ``slstm_scan`` goes to
the sLSTM kernel (K6) and ``slstm_scan_train``, the training path's
differentiable sLSTM, to K6 forward and K6b backward. ``selective_scan_step``,
one decode step of the scan, is plain PyTorch on every device, as in the
reference (which has no kernel for it either); it is not counted. The
mLSTM's scans, ``mlstm_chunkwise`` and ``mlstm_step``, are plain PyTorch
on every device too (float32 products over chunks of 128, a few hundred
launches a layer); they are counted under their own names, with no
``ref_`` prefix, since no kernel stands beside them.

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
from repro_torch.kernels import slstm_scan as sl

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


def selective_scan_train(x, dt, A, B, C, D, *, impl=None):
    """The differentiable scan (no h0, y only) of the training path: K5
    forward and K5b backward on the card, the plain versions on the CPU
    (``kernel_scan`` / ``kernel_scan_bwd`` or ``ref_scan`` /
    ``ref_scan_bwd`` in the counters)."""
    return ss.scan(x, dt, A, B, C, D, use_kernel=_use_kernel(x, impl),
                   count=_count)


def selective_scan_step(h, x, dt, A, B, C, D):
    """One decode step of the scan (plain PyTorch on every device)."""
    return ref.selective_scan_step(h, x, dt, A, B, C, D)


def mlstm_chunkwise(q, k, v, i_gate, f_gate, *, chunk=128, state=None,
                    return_state=False):
    """The chunkwise mLSTM (plain PyTorch on every device); see
    ``ref.mlstm_chunkwise``."""
    _count("mlstm_chunkwise")
    return ref.mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk=chunk,
                               state=state, return_state=return_state)


def mlstm_step(state, q, k, v, i_gate, f_gate):
    """One mLSTM decode step (plain PyTorch on every device)."""
    _count("mlstm_step")
    return ref.mlstm_step(state, q, k, v, i_gate, f_gate)


def slstm_scan(x_gates, *, state=None, return_state=False, impl=None):
    """The sLSTM over a sequence (prefill, or one decode step); see
    ``ref.slstm_scan``."""
    if not _use_kernel(x_gates, impl):
        _count("ref_slstm")
        return ref.slstm_scan(x_gates, state=state,
                              return_state=return_state)
    _count("kernel_slstm")
    if state is not None:
        state = tuple(t.float().contiguous() for t in state)
    return sl.slstm_scan(x_gates.contiguous(), state=state,
                         return_state=return_state)


def slstm_scan_train(x_gates, *, impl=None):
    """The differentiable sLSTM (zero initial state, y only) of the
    training path: K6 forward and K6b backward on the card, the plain
    versions on the CPU (``kernel_slstm`` / ``kernel_slstm_bwd`` or
    ``ref_slstm`` / ``ref_slstm_bwd`` in the counters)."""
    return sl.scan(x_gates, use_kernel=_use_kernel(x_gates, impl),
                   count=_count)
