"""Plain PyTorch versions of the port's kernels.

The port's copy of ``repro/kernels/ref.py`` for the functions the serving
and training slices run. These are (a) the CPU execution path, and (b)
the oracle the CUDA kernels in ``kernels/csrc`` are held against on the
card. Masking follows the reference: ``-inf`` scores with ``isfinite``
guards, so a row that sees no key comes out as exact zeros. Attention
scales q after upcasting it to float32, as the TPU kernels do
(``repro/kernels/paged_attention.py:75``, ``flash_attention.py:43``); the
jnp reference scales in q's dtype, which differs only for bfloat16 q
with a scale that is not a power of two (head_dim 128). Plain
versions by kernel: slotted — ``attention`` with a ``[b]`` ``q_offset``
(causal) and ``decode_attention`` (window, with stats); paged —
``paged_attention``; flash forward — ``attention`` with an int offset and
``return_lse``; flash backward — ``attention_bwd``; fused cross-entropy —
``softmax_xent``, the composition of its two passes ``xent_stats`` and
``xent_grads`` (the vocabulary-sharded loss runs them apart); selective
scan — ``selective_scan``.
``selective_scan_step`` (one decode step of the scan) has no kernel on
either side and runs as plain PyTorch on every device.
"""

from __future__ import annotations

import torch


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: kv head ``j`` serves q heads ``j*rep .. j*rep+rep-1``."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=2)


def attention(q, k, v, *, causal=True, q_offset=0, block_k=512, scale=None,
              return_lse=False):
    """Streaming-softmax attention; O(sq * block_k) live memory.

    q: [b, sq, h, e]; k: [b, sk, g, e]; v: [b, sk, g, ev] (h % g == 0).
    ``q_offset`` is the absolute position of q[0] (an int, a 0-d tensor,
    or a ``[b]`` tensor giving each batch row its own offset). Accumulates
    in float32 whatever the input dtype; returns [b, sq, h, ev] in q.dtype
    and, with ``return_lse``, also the per-row log-sum-exp [b, h, sq]
    float32 (-inf for a row that sees no key), the flash kernel's residual.
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

    qf = q.float() * scale        # upcast before the scale (see above)
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
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)),
                          float("-inf"))
        return out, lse
    return out


def attention_bwd(q, k, v, o, do, lse, *, causal=True, q_offset=0,
                  block_q=512, scale=None):
    """Gradients of ``attention`` (int ``q_offset``) written out from the
    recomputed probabilities, as the flash backward kernel computes them.

    o, do: [b, sq, h, ev] (the forward's output and its cotangent); lse
    [b, h, sq] the forward's log-sum-exp. With S = scale q k^T,
    P = exp(S - lse) and D = rowsum(do * o): dV = P^T do,
    dS = P (do V^T - D), dQ = scale dS K, dK = scale dS^T q; the rep q
    heads of a kv head sum into its dK, dV. Returns float32 (dq [b, sq, h,
    e], dk [b, sk, g, e], dv [b, sk, g, ev]); query blocks of ``block_q``
    rows bound the live [h, block_q, sk] score memory.
    """
    b, sq, h, e = q.shape
    sk, g = k.shape[1], k.shape[2]
    ev = v.shape[-1]
    rep = h // g
    scale = scale if scale is not None else (1.0 / e ** 0.5)
    dev = q.device
    kf = _repeat_heads(k, rep).float()                  # [b, sk, h, e]
    vf = _repeat_heads(v, rep).float()
    k_pos = torch.arange(sk, device=dev)
    dq = torch.empty((b, sq, h, e), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, sk, h, e), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, sk, h, ev), dtype=torch.float32, device=dev)
    for i0 in range(0, sq, block_q):
        i1 = min(i0 + block_q, sq)
        qb = q[:, i0:i1].float()
        dob = do[:, i0:i1].float()
        lb = lse[:, :, i0:i1]                            # [b, h, bq]
        dd = (dob * o[:, i0:i1].float()).sum(-1).permute(0, 2, 1)
        s = torch.einsum("bqhe,bkhe->bhqk", qb * scale, kf)
        if causal:
            q_pos = q_offset + torch.arange(i0, i1, device=dev)
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((i1 - i0, sk), dtype=torch.bool, device=dev)
        keep = mask[None, None] & torch.isfinite(lb)[..., None]
        p = torch.where(keep, torch.exp(s - torch.where(
            torch.isfinite(lb), lb, 0.0)[..., None]), 0.0)
        dv += torch.einsum("bhqk,bqhe->bkhe", p, dob)
        dp = torch.einsum("bqhe,bkhe->bhqk", dob, vf)
        ds = p * (dp - dd[..., None])
        dq[:, i0:i1] = torch.einsum("bhqk,bkhe->bqhe", ds, kf) * scale
        dk += torch.einsum("bhqk,bqhe->bkhe", ds, qb) * scale
    dk = dk.reshape(b, sk, g, rep, e).sum(3)
    dv = dv.reshape(b, sk, g, rep, ev).sum(3)
    return dq, dk, dv


def xent_stats(h, w_head, labels, *, chunk=8192):
    """Pass 1 of K2: (lse [n], label logit [n]) of the logits h @ w_head,
    both float32, streamed over vocab chunks. h [n, d]; w_head [d, vocab]
    (upcast one chunk at a time); labels [n] int, where a label outside
    [0, vocab) — -1 for a row whose label lies in another vocabulary
    shard — has label logit 0."""
    n = h.shape[0]
    vocab = w_head.shape[1]
    dev = h.device
    hf = h.float()
    lab = labels.long()
    m = torch.full((n,), float("-inf"), device=dev)
    l = torch.zeros((n,), device=dev)
    lab_logit = torch.zeros((n,), device=dev)
    rows = torch.arange(n, device=dev)
    for lo in range(0, vocab, chunk):
        hi = min(lo + chunk, vocab)
        logits = hf @ w_head[:, lo:hi].float()           # [n, chunk]
        m_new = torch.maximum(m, logits.amax(dim=1))
        l = l * torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0) \
            + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
        inc = (lab >= lo) & (lab < hi)
        got = logits[rows, (lab - lo).clamp(0, hi - lo - 1)]
        lab_logit = torch.where(inc, got, lab_logit)
    return m + torch.log(torch.clamp_min(l, 1e-30)), lab_logit


def xent_grads(h, w_head, labels, lse, scale, *, chunk=8192):
    """Pass 2 of K2: dlog = (exp(logit - lse) - onehot) * scale[:, None]
    streamed over vocab chunks; returns (dh = dlog W^T [n, d], dW = h^T
    dlog [d, vocab]), both float32. ``lse`` may be combined over several
    vocabulary shards; a label outside [0, vocab) adds no one-hot."""
    n, d = h.shape
    vocab = w_head.shape[1]
    dev = h.device
    hf = h.float()
    lab = labels.long()
    dh = torch.zeros((n, d), dtype=torch.float32, device=dev)
    dw = torch.empty((d, vocab), dtype=torch.float32, device=dev)
    for lo in range(0, vocab, chunk):
        hi = min(lo + chunk, vocab)
        wc = w_head[:, lo:hi].float()
        p = torch.exp(hf @ wc - lse[:, None])
        onehot = (lab[:, None] == torch.arange(lo, hi, device=dev)[None])
        dlog = (p - onehot.float()) * scale[:, None]
        dh += dlog @ wc.t()
        dw[:, lo:hi] = hf.t() @ dlog
    return dh, dw


def softmax_xent(h, w_head, labels, *, chunk=8192, mask=None, denom=None):
    """Returns (loss, (dh, dW)) without materializing [n, vocab] logits.

    h [n, d] final hiddens; w_head [d, vocab] (a transposed view of the
    tied [vocab, d] table is read in place, one chunk upcast at a time);
    labels [n] int; mask [n] (1.0 = count this token). loss =
    sum((lse - label logit) * mask) / denom with ``denom`` the reference's
    max(sum(mask), 1) when None (the trainer passes the step's global
    token count). dlog = (softmax - onehot) * mask / denom is streamed over
    vocab chunks: dh = dlog W^T, dW = h^T dlog, in float32 (h and W are
    upcast), returned as dh in h.dtype and dW [d, vocab] in float32 (the
    reference casts dW to the head's dtype; the trainer accumulates it in
    float32). The composition of :func:`xent_stats` and :func:`xent_grads`.
    """
    n = h.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.float32, device=h.device)
    mask = mask.float()
    if denom is None:
        denom = torch.clamp_min(mask.sum(), 1.0)
    lse, lab_logit = xent_stats(h, w_head, labels, chunk=chunk)
    loss = ((lse - lab_logit) * mask).sum() / denom
    dh, dw = xent_grads(h, w_head, labels, lse, mask / denom, chunk=chunk)
    return loss, (dh.to(h.dtype), dw)


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
    s = torch.einsum("bqhe,bkhe->bhqk", q.float() * scale,
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


def _scan_pairs(a, u):
    """Inclusive scan along dim 1 of the affine maps h -> a h + u, the
    earlier map applied first: returns (a_cum, u_cum) with h_t = a_cum[t]
    h_{-1} + u_cum[t]. Written out in log2(len) doubling steps (torch has
    no ``associative_scan``); each step pairs position t with t - off.
    Updates a and u in place, one temporary at a time."""
    c = a.shape[1]
    off = 1
    while off < c:
        u[:, off:] += a[:, off:] * u[:, :-off]
        a[:, off:] = a[:, off:] * a[:, :-off]
        off *= 2
    return a, u


def selective_scan(x, dt, A, B, C, D, *, chunk=256, h0=None,
                   return_state=False):
    """y_t = C_t · h_t + D x_t with h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t.

    x, dt: [b, s, d] (post-conv activations, softplus'd timestep); A: [d, n]
    (negative); B, C: [b, s, n]; D: [d]; h0: optional [b, d, n] initial
    state. Chunked as the reference: within a chunk the diagonal
    recurrence is an inclusive scan of (a_t, u_t) = (exp(dt_t A), dt_t B_t
    x_t); chunks chain through the [b, d, n] float32 state. Live memory
    is a few [b, chunk, d, n] float32 tensors. Returns y [b, s, d] in
    x.dtype and, with ``return_state``, the final state [b, d, n] float32
    (padding past s has dt = 0, the identity map, so it is the state
    after step s - 1).
    """
    b, s, d = x.shape
    n = A.shape[1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    if pad:
        xf, dtf, Bf, Cf = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                           for t in (xf, dtf, Bf, Cf))
    Af = A.float()
    h = (h0.float() if h0 is not None
         else torch.zeros((b, d, n), dtype=torch.float32, device=x.device))
    ys = []
    for c0 in range(0, nc * chunk, chunk):
        xc, dtc = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        Bc, Cc = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]
        a = torch.exp(dtc[..., None] * Af[None, None])         # [b,c,d,n]
        u = dtc[..., None] * Bc[:, :, None, :] * xc[..., None]
        a_cum, u_cum = _scan_pairs(a, u)
        h_all = a_cum.mul_(h[:, None]).add_(u_cum)              # [b,c,d,n]
        del u, u_cum
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, Cc))
        h = h_all[:, -1].clone()
        del a, a_cum, h_all
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + x.float() * D[None, None]
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def selective_scan_step(h, x, dt, A, B, C, D):
    """One decode step. h: [b, d, n]; x, dt: [b, d]; B, C: [b, n].
    Returns (h_new [b, d, n], y [b, d] in x.dtype)."""
    g = torch.exp(dt[..., None] * A[None])
    h_new = g * h + dt[..., None] * B[:, None, :] * x[..., None]
    y = torch.einsum("bdn,bn->bd", h_new, C) + D[None] * x
    return h_new, y.to(x.dtype)
