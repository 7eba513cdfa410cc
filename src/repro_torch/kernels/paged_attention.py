"""Slot-aware serving attention: wrappers over the two Hopper kernels.

The port's counterpart of ``repro/kernels/paged_attention.py``:

  * ``flash_attention_slotted`` — contiguous cache ``[b, S, g, e]`` with a
    per-row int32 ``pos``, causal (``k_pos <= pos[b] + i``). Kernel:
    ``csrc/slotted_attention.cu``.
  * ``decode_attention`` — the window contract (``k_pos < cache_len[b]``)
    with ``(m, l, acc)`` stats, on the same kernel.
  * ``paged_attention`` — K/V read straight out of a page pool through
    per-row page tables, fp32/bf16 or int8 pages (dequantised in the
    kernel). Kernel: ``csrc/paged_attention.cu``.

Each wrapper takes the plain version (``kernels/ref.py``: ``attention``
with a ``[b]`` offset, ``decode_attention``, ``paged_attention``) for a
tensor on the CPU. For a CUDA tensor it checks device, dtype, shape and
contiguity, launches its kernel on the tensor's device and current
stream, and raises if the launch is refused: there is no fallback to the
plain version on the card. ``LAUNCHES`` counts the kernel launches, and nothing else.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"slotted_attention": 0, "paged_attention": 0}

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64,)   # (e == ev) widths the kernels are built for


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {t.device}")
    return False


def _check(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                         f"{[str(d) for d in dtypes]}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_dims(e: int, ev: int, h: int, g: int) -> None:
    if e != ev or e not in _HEAD_DIMS:
        raise ValueError(
            f"head dims e={e}, ev={ev}: the kernels are built for e == ev "
            f"in {_HEAD_DIMS}")
    if g < 1 or h % g:
        raise ValueError(f"{h} q heads do not group over {g} kv heads")


def _rows(pos, b: int, device) -> torch.Tensor:
    """pos (int or tensor, scalar or [b]) as a contiguous int32 [b]."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.int32).reshape(-1)
        return p.expand(b).contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, name: str) -> None:
    if rc == -1:
        raise ValueError(f"{name}: no kernel instantiation for these "
                         "dtypes/shapes")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")


def _slotted(q, k, v, pos, window):
    """Launch the slotted kernel on CUDA tensors: causal rows, or the
    window contract with its (m, l, acc) stats."""
    dev = q.device
    kv_types = (torch.float32, torch.bfloat16)
    _check("q", q, kv_types, 4, dev)
    _check("k", k, kv_types, 4, dev)
    _check("v", v, (k.dtype,), 4, dev)
    b, sq, h, e = q.shape
    S, g, ev = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != e:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    _check_dims(e, ev, h, g)
    out = torch.empty((b, sq, h, ev), dtype=q.dtype, device=dev)
    m = l = acc = None
    if window:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        acc = torch.empty((b, h, sq, ev), dtype=torch.float32, device=dev)
    if out.numel():
        p = _rows(pos, b, dev)
        fn = build.load("slotted_attention").slotted_attention
        with torch.cuda.device(dev):
            rc = fn(_CODES[q.dtype], _CODES[k.dtype], q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), p.data_ptr(),
                    out.data_ptr(), _ptr(m), _ptr(l), _ptr(acc), b, sq, h,
                    g, S, e, ev, int(window), 1.0 / math.sqrt(e),
                    torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "slotted_attention")
        LAUNCHES["slotted_attention"] += 1
    return (out, (m, l, acc)) if window else out


def flash_attention_slotted(q, k, v, *, pos):
    """Per-row causal attention over a contiguous cache.

    q: [b, sq, h, e]; k: [b, S, g, e]; v: [b, S, g, ev]; pos: [b] int (or
    a scalar). Row i of batch row b sees k_pos <= pos[b] + i. Returns
    [b, sq, h, ev] in q.dtype.
    """
    if _on_cpu(q):
        return ref.attention(q, k, v, causal=True, q_offset=pos)
    return _slotted(q, k, v, pos, window=False)


def decode_attention(q, k_cache, v_cache, cache_len=None):
    """Drop-in for ``ref.decode_attention`` on the slotted kernel.

    q: [b, sq, h, e]; caches [b, S, g, e/ev]; cache_len scalar or [b]
    (None → the full cache is valid): every q row sees k_pos <
    cache_len[b]. Returns (out, (m, l, acc)) with m, l [b, h, sq] and the
    unnormalised acc [b, h, sq, ev] in float32.
    """
    if cache_len is None:
        cache_len = k_cache.shape[1]
    if _on_cpu(q):
        return ref.decode_attention(q, k_cache, v_cache, cache_len)
    return _slotted(q, k_cache, v_cache, cache_len, window=True)


def paged_attention(q, k_pool, v_pool, *, page_tables, pos, k_scale=None,
                    v_scale=None, slot_mask=None):
    """Attention straight out of the page pool — no per-row gather.

    q: [b, sq, h, e]; pools [n_pages, ps, g, e] / [n_pages, ps, g, ev]
    (int8 with ``k_scale``/``v_scale`` [n_pages, g] float32, else float);
    page_tables: [b, ppr] int page ids (sentinel tails allowed); pos: [b]
    first absolute position of each row's q. ``slot_mask`` [b] bool:
    masked-off rows emit zeros (their page tables may be stale). Returns
    [b, sq, h, ev] in q.dtype.
    """
    if _on_cpu(q):
        return ref.paged_attention(q, k_pool, v_pool,
                                   page_tables=page_tables, pos=pos,
                                   k_scale=k_scale, v_scale=v_scale,
                                   slot_mask=slot_mask)
    dev = q.device
    _check("q", q, (torch.float32, torch.bfloat16), 4, dev)
    _check("k_pool", k_pool, tuple(_CODES), 4, dev)
    _check("v_pool", v_pool, (k_pool.dtype,), 4, dev)
    b, sq, h, e = q.shape
    n_pages, ps, g, ev = v_pool.shape
    if k_pool.shape[:3] != v_pool.shape[:3] or k_pool.shape[3] != e:
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    _check_dims(e, ev, h, g)
    quant = k_pool.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("int8 pools need k_scale and v_scale (and float "
                         "pools take none)")
    if quant:
        for nm, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(nm, sc, (torch.float32,), 2, dev)
            if tuple(sc.shape) != (n_pages, g):
                raise ValueError(f"{nm} must be [{n_pages}, {g}], got "
                                 f"{tuple(sc.shape)}")
    pt = page_tables.to(device=dev, dtype=torch.int32).contiguous()
    if pt.ndim != 2 or pt.shape[0] != b:
        raise ValueError(f"page_tables must be [{b}, ppr], got "
                         f"{tuple(pt.shape)}")
    p = _rows(pos, b, dev)
    if slot_mask is not None:
        # masked rows: push the causal offset below every key position so
        # the row sees no key (l == 0 → output exactly 0)
        p = torch.where(slot_mask.to(dev), p, -sq).to(torch.int32)
    out = torch.empty((b, sq, h, ev), dtype=q.dtype, device=dev)
    if out.numel():
        fn = build.load("paged_attention").paged_attention
        with torch.cuda.device(dev):
            rc = fn(_CODES[q.dtype], _CODES[k_pool.dtype], q.data_ptr(),
                    k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
                    _ptr(v_scale), pt.data_ptr(), p.data_ptr(),
                    out.data_ptr(), b, sq, h, g, n_pages, ps, pt.shape[1],
                    e, ev, 1.0 / math.sqrt(e),
                    torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "paged_attention")
        LAUNCHES["paged_attention"] += 1
    return out
