"""Plain PyTorch versions of the serving attention hot spots.

The port's copy of ``repro/kernels/ref.py`` for the functions the serving
slice runs. These are (a) the CPU execution path, and (b) the oracle the
CUDA kernels in ``kernels/csrc`` are held against on the card. Masking
follows the reference: ``-inf`` scores with ``isfinite`` guards, so a row
that sees no key comes out as exact zeros. The slotted kernel's plain
versions are ``attention`` with a ``[b]`` ``q_offset`` (causal) and
``decode_attention`` (window, with stats).
"""

from __future__ import annotations

import torch


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: kv head ``j`` serves q heads ``j*rep .. j*rep+rep-1``."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=2)


def attention(q, k, v, *, causal=True, q_offset=0, block_k=512, scale=None):
    """Streaming-softmax attention; O(sq * block_k) live memory.

    q: [b, sq, h, e]; k: [b, sk, g, e]; v: [b, sk, g, ev] (h % g == 0).
    ``q_offset`` is the absolute position of q[0] (an int, a 0-d tensor,
    or a ``[b]`` tensor giving each batch row its own offset). Accumulates
    in float32 whatever the input dtype; returns [b, sq, h, ev] in q.dtype.
    """
    b, sq, h, e = q.shape
    sk, g = k.shape[1], k.shape[2]
    ev = v.shape[-1]
    rep = h // g
    scale = scale if scale is not None else (1.0 / e ** 0.5)
    dev = q.device

    n_blocks = -(-sk // block_k)
    pad = n_blocks * block_k - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))

    qf = (q * scale).float()
    kf = k.float().reshape(b, n_blocks, block_k, g, e)
    vf = v.float().reshape(b, n_blocks, block_k, g, ev)

    off = torch.as_tensor(q_offset, device=dev)
    per_row = off.ndim == 1
    ar_q = torch.arange(sq, device=dev)
    q_pos = ar_q + (off[:, None] if per_row else off)   # [b, sq] or [sq]

    m = torch.full((b, h, sq), float("-inf"), device=dev)
    l = torch.zeros((b, h, sq), device=dev)
    acc = torch.zeros((b, h, sq, ev), device=dev)
    for blk in range(n_blocks):
        k_pos = blk * block_k + torch.arange(block_k, device=dev)
        s = torch.einsum("bqhe,bkhe->bhqk", qf,
                         _repeat_heads(kf[:, blk], rep))
        if causal:
            mask = k_pos[None, :] <= q_pos[..., :, None]
        else:
            mask = (k_pos[None, :] >= 0) & torch.ones(
                (sq, 1), dtype=torch.bool, device=dev)
        mask = mask & (k_pos < sk)[None, :]
        # [sq, bk] -> [1, 1, sq, bk]; per-row [b, sq, bk] -> [b, 1, sq, bk]
        mask = mask[:, None] if mask.ndim == 3 else mask[None, None]
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhe->bhqe", p, _repeat_heads(vf[:, blk], rep))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len=None, scale=None):
    """Cached attention where every q row sees ``k_pos < cache_len``.

    q: [b, sq, h, e], caches [b, S, g, e/ev]; ``cache_len`` scalar or [b].
    Returns ([b, sq, h, ev] in q.dtype, (m, l, acc)) with the float32
    stats m, l [b, h, sq] and the unnormalised acc [b, h, sq, ev], for
    cross-shard combination.
    """
    b, sq, h, e = q.shape
    S, g = k_cache.shape[1], k_cache.shape[2]
    rep = h // g
    scale = scale if scale is not None else (1.0 / e ** 0.5)
    s = torch.einsum("bqhe,bkhe->bhqk", (q * scale).float(),
                     _repeat_heads(k_cache, rep).float())
    if cache_len is not None:
        cl = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
        valid = torch.arange(S, device=q.device)[None, :] < cl
        s = torch.where(valid[:, None, None], s, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhe->bhqe", p,
                       _repeat_heads(v_cache, rep).float())
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype), (m, l, acc)


def paged_gather(pool, page_tables, scale=None):
    """Materialise per-row KV from a page pool.

    pool: [n_pages, ps, ...]; page_tables: [b, ppr] int (sentinel tail ids
    allowed — callers mask those positions causally; ids are clipped into
    range); scale: optional [n_pages, ...head-dims] per-page dequant
    scales for int8 pools. Returns [b, ppr*ps, ...] in float32 when
    dequantising, else the pool dtype.
    """
    pt = page_tables.long().clamp(0, pool.shape[0] - 1)
    g = pool[pt]                                  # [b, ppr, ps, ...]
    if scale is not None:
        sg = scale.float()[pt]                    # [b, ppr, ...]
        sg = sg.reshape(sg.shape[:2] + (1,) + sg.shape[2:] + (1,))
        g = g.float() * sg
    return g.reshape((pt.shape[0], -1) + tuple(pool.shape[2:]))


def paged_attention(q, k_pool, v_pool, *, page_tables, pos, k_scale=None,
                    v_scale=None, slot_mask=None, block_k=512, scale=None):
    """Plain version of the paged kernel: gather + dequant + attention.

    q: [b, sq, h, e]; pools [n_pages, ps, g, e/ev] (int8 with
    k_scale/v_scale [n_pages, g]); page_tables [b, ppr]; pos [b] absolute
    position of q[:, 0]. Sentinel tail pages are masked by the exact
    causal mask (their logical positions exceed pos). slot_mask [b] bool
    zeroes masked-off rows.
    """
    sq = q.shape[1]
    k = paged_gather(k_pool, page_tables, k_scale)
    v = paged_gather(v_pool, page_tables, v_scale)
    off = torch.as_tensor(pos, device=q.device).long().reshape(-1)
    if slot_mask is not None:
        off = torch.where(slot_mask, off, -sq)
    return attention(q, k, v, causal=True, q_offset=off, block_k=block_k,
                     scale=scale)
