"""Dispatch layer: the CUDA kernels for CUDA tensors, the plain versions
for CPU ones.

The port's counterpart of ``repro/kernels/ops.py``. The choice is made per
call from the tensor's device and an explicit ``impl=`` override: "ref"
forces the plain version (``kernels/ref.py``) on any device, "kernel"
forces the kernel and raises on a CPU tensor, None picks by device. A
CUDA tensor never falls back to the plain version by itself: the kernel
runs, or the call raises.

Every call bumps a process-wide counter (``kernel_counters``), one count
per executed call — the port runs eagerly, so there is no trace-time
distinction. ``Session.describe()["kernels"]`` reports per-session deltas.
"""

from __future__ import annotations

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

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
    if not _use_kernel(q, impl):
        _count("ref_attention")
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset,
                             block_k=block_k)
    if not causal:
        raise NotImplementedError(
            "bidirectional attention on the card needs the flash-attention "
            "kernel (K1), which is still to be ported: ROADMAP.md queue 2")
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

