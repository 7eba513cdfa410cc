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
plain version on the card. ``LAUNCHES`` counts the wrapper calls that
launched a kernel, once a call, and nothing else.

The C entry points pick the body by dtype. bf16 q over a bf16 cache
(causal, or the window + stats contract) or bf16/int8 pools runs the
tensor-core body (``csrc/attention_tc.cuh``): S and P V are ``wgmma``
products with P rounded to bf16 in registers, so its out is held to the
plain version by ``flash_attention.bf16_excess`` (1e-2 of the largest
|plain| of the element's row plus one bf16 ulp), as the bf16 flash
kernels are. When the grid would hold under two blocks an SM (decode),
the keys are split over ``n_split`` blocks a (row, kv head)
(``splits``); the wrapper allocates their float32 scratch and the same
call launches the combine kernel. The window contract's stats come from
the body itself with one split, and from the combine with more: m and l
sum float32 P (1e-4 of the largest |plain|), acc carries P's bf16
rounding and is held by ``bf16_excess`` over its rows like out.
float32 or mixed dtypes run the CUDA-core body, whose outputs round the
same float32 values as the plain version (one bf16 ulp for a bf16 out).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"slotted_attention": 0, "paged_attention": 0}

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (e == ev) head widths each kernel is instantiated for: the slotted
# kernel also at 128 (jamba-v0.1-52b's attention layer); the paged kernel
# at 64 only (the flash kernels have their own, flash_attention.HEAD_DIMS)
_HEAD_DIMS = (64,)
_SLOTTED_HEAD_DIMS = (64, 128)


# blocks a (batch row, kv head) row tile of the tensor-core body: 64
# query rows (one wgmma tile) and 64-key tiles
_ROWS_A_BLOCK = _KEYS_A_TILE = 64


# blocks an SM a launch should hold before its keys are split (two
# waves): at decode on the H100 (b 8, g 8) 5 splits, within noise of 9
# and 17 over bf16 caches (chip_smoke.py's key-split sweep, PERF.md)
_BLOCKS_AN_SM = 2


def splits(b: int, g: int, rows: int, keys: int, sms: int) -> int:
    """Key splits of a tensor-core launch: 1 when the b * g * (row tiles)
    blocks fill ``_BLOCKS_AN_SM`` blocks on each of ``sms`` SMs, else
    enough splits to reach that, at most one a 64-key tile of the
    ``keys`` a row may see. ``rows`` is a kv head's query rows (q heads
    a kv head times sq). At decode on an H100 (b 8, g 8, 2048 keys): 5."""
    blocks = b * g * -(-rows // _ROWS_A_BLOCK)
    want = _BLOCKS_AN_SM * sms
    if blocks >= want:
        return 1
    return max(1, min(-(-want // blocks), -(-keys // _KEYS_A_TILE)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scratch(q, g: int, ev: int, keys: int):
    """(n_split, float32 scratch or None) for a tensor-core launch on q
    over g kv heads of ``keys`` keys."""
    b, sq, h, _ = q.shape
    ns = splits(b, g, h // g * sq, keys, _sms(q.device.index or 0))
    if ns == 1:
        return 1, None
    part = torch.empty(ns * b * h * sq * (ev + 2), dtype=torch.float32,
                       device=q.device)
    return ns, part


# the window contract's m and l against their plain versions: max |diff|
# within this share of the largest |plain| (both sum float32 P)
STATS_RTOL = 1e-4


def window_excess(got, want) -> dict:
    """The bf16 window + stats contract against its plain version
    (``ref.decode_attention``): for out, m, l and acc the worst |diff|
    over its limit (above 1 fails). out and acc by
    ``flash_attention.bf16_excess`` (1e-2 of the largest |plain| of the
    element's row, one (b, head, position), plus one bf16 ulp for the
    bf16 out): P is rounded to bf16 before P V. m and l within
    ``STATS_RTOL`` of their largest |plain|: l sums the float32 P. m must
    be -inf exactly where the plain m is (rows that see no key) and is
    compared where it is finite."""
    from repro_torch.kernels import flash_attention as fa

    (out, (m, l, acc)), (w_out, (w_m, w_l, w_acc)) = got, want
    res = {"out": fa.bf16_excess(out, w_out),
           "acc": fa.bf16_excess(acc, w_acc)}
    for name, a, w in (("m", m, w_m), ("l", l, w_l)):
        a, w = a.float(), w.float()
        fin = torch.isfinite(w)
        if not (torch.equal(torch.isfinite(a), fin)
                and torch.equal(a[~fin], w[~fin])):
            res[name] = float("inf")
        elif not fin.any():
            res[name] = 0.0
        else:
            diff = (a[fin] - w[fin]).abs().max().item()
            scale = w[fin].abs().max().item()
            res[name] = (diff / (STATS_RTOL * scale) if scale > 0
                         else (float("inf") if diff > 0 else 0.0))
    return res


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


def _check_dims(e: int, ev: int, h: int, g: int,
                dims: tuple = _HEAD_DIMS) -> None:
    if e != ev or e not in dims:
        raise ValueError(
            f"head dims e={e}, ev={ev}: the kernel is built for e == ev "
            f"in {dims}")
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
    _check_dims(e, ev, h, g, _SLOTTED_HEAD_DIMS)
    out = torch.empty((b, sq, h, ev), dtype=q.dtype, device=dev)
    m = l = acc = None
    if window:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        acc = torch.empty((b, h, sq, ev), dtype=torch.float32, device=dev)
    if out.numel():
        p = _rows(pos, b, dev)
        tc = q.dtype == k.dtype == torch.bfloat16
        ns, part = _scratch(q, g, ev, S) if tc else (1, None)
        fn = build.load("slotted_attention").slotted_attention
        with torch.cuda.device(dev):
            rc = fn(_CODES[q.dtype], _CODES[k.dtype], q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), p.data_ptr(),
                    out.data_ptr(), _ptr(m), _ptr(l), _ptr(acc), _ptr(part),
                    b, sq, h, g, S, e, ev, int(window), ns,
                    1.0 / math.sqrt(e),
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
        tc = q.dtype == torch.bfloat16 and k_pool.dtype != torch.float32
        ns, part = (_scratch(q, g, ev, pt.shape[1] * ps) if tc
                    else (1, None))
        fn = build.load("paged_attention").paged_attention
        with torch.cuda.device(dev):
            rc = fn(_CODES[q.dtype], _CODES[k_pool.dtype], q.data_ptr(),
                    k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
                    _ptr(v_scale), pt.data_ptr(), p.data_ptr(),
                    out.data_ptr(), _ptr(part), b, sq, h, g, n_pages, ps,
                    pt.shape[1], e, ev, ns, 1.0 / math.sqrt(e),
                    torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "paged_attention")
        LAUNCHES["paged_attention"] += 1
    return out
