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
sLSTM — ``slstm_scan`` (K6, through ``slstm_walk``) and its gradient
``slstm_scan_bwd`` (K6b).
``selective_scan_step`` (one decode step of the scan), ``mlstm_chunkwise``
and ``mlstm_step`` (the mLSTM's scans) have no kernel on either side and
run as plain PyTorch on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def _chunk_states(xc, dtc, Bc, Af, h):
    """(a, h_all) of one chunk: a_t = exp(dt_t A) and the states h_t after
    each step [b, c, d, n], from the entry state h [b, d, n]."""
    a = torch.exp(dtc[..., None] * Af[None, None])
    u = dtc[..., None] * Bc[:, :, None, :] * xc[..., None]
    a_cum, u_cum = _scan_pairs(a.clone(), u)
    return a, a_cum.mul_(h[:, None]).add_(u_cum)


def selective_scan_bwd(x, dt, A, B, C, D, dy, *, chunk=256):
    """The gradient of :func:`selective_scan` (h0 = 0, y only) for the
    cotangent dy [b, s, d]: (dx, ddt, dA, dB, dC, dD), each in its
    input's dtype. The plain reverse scan, written out: a forward pass
    keeps each chunk's entry state ([b, d, n] a chunk); then, from the
    last chunk to the first, the chunk's states are recomputed from its
    entry state and the state cotangent walks back,

      g_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1},

    as an inclusive scan of the flipped chunk (doubling steps, as the
    forward), carrying a_{t0} g_{t0} into the chunk before. With
    w_t = g_t a_t h_{t-1}:

      dx_t = D dy_t + dt_t sum_n g_t B_t,  ddt_t = sum_n (w_t A + g_t B_t x_t),
      dA = sum_t dt_t w_t,  dB_t = sum_d g_t dt_t x_t,  dC_t = sum_d dy_t h_t,
      dD = sum_t dy_t x_t.

    Live memory is a few [b, chunk, d, n] float32 tensors, as the
    forward's; padding past s has dt = 0 and dy = 0, so it adds nothing.
    """
    b, s, d = x.shape
    n = A.shape[1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    if pad:
        xf, dtf, Bf, Cf, dyf = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                                for t in (xf, dtf, Bf, Cf, dyf))
    Af = A.float()
    h = torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
    entry = []
    for k in range(nc):
        entry.append(h)
        if k < nc - 1:
            sl = slice(k * chunk, (k + 1) * chunk)
            _, h_all = _chunk_states(xf[:, sl], dtf[:, sl], Bf[:, sl], Af, h)
            h = h_all[:, -1].clone()
            del h_all
    dA = torch.zeros((d, n), dtype=torch.float32, device=x.device)
    G = torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
    outs = []
    for k in reversed(range(nc)):
        sl = slice(k * chunk, (k + 1) * chunk)
        xc, dtc, Bc, Cc, dyc = (t[:, sl] for t in (xf, dtf, Bf, Cf, dyf))
        a, h_all = _chunk_states(xc, dtc, Bc, Af, entry[k])
        dC = torch.einsum("bcdn,bcd->bcn", h_all, dyc)
        # the flipped chunk: g_r = a'_r g_{r-1} + u_r with a'_r = a_{t+1}
        u = Cc[:, :, None, :] * dyc[..., None]
        u[:, -1] += G
        ar = torch.zeros_like(a)
        ar[:, :-1] = a[:, 1:]
        _, g = _scan_pairs(ar.flip(1), u.flip(1))
        g = g.flip(1)
        del ar, u
        G = a[:, 0] * g[:, 0]
        w = a.mul_(g)                              # g_t a_t h_{t-1}
        w[:, 1:] *= h_all[:, :-1]
        w[:, 0] *= entry[k]
        del h_all
        sgB = torch.einsum("bcdn,bcn->bcd", g, Bc)
        dx = dyc * D.float() + dtc * sgB
        ddt = torch.einsum("bcdn,dn->bcd", w, Af) + xc * sgB
        dA += torch.einsum("bcd,bcdn->dn", dtc, w)
        dB = torch.einsum("bcdn,bcd->bcn", g, dtc * xc)
        outs.append((dx, ddt, dB, dC))
        del g, w, a
    dx, ddt, dB, dC = (torch.cat(o[::-1], dim=1)[:, :s]
                       for o in zip(*outs))
    dD = (dyf * xf).sum(dim=(0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype), dD.to(D.dtype))


def selective_scan_step(h, x, dt, A, B, C, D):
    """One decode step. h: [b, d, n]; x, dt: [b, d]; B, C: [b, n].
    Returns (h_new [b, d, n], y [b, d] in x.dtype)."""
    g = torch.exp(dt[..., None] * A[None])
    h_new = g * h + dt[..., None] * B[:, None, :] * x[..., None]
    y = torch.einsum("bdn,bn->bd", h_new, C) + D[None] * x
    return h_new, y.to(x.dtype)


# --------------------------------------------------------------------------- #
# mLSTM (xLSTM matrix-memory cell), chunkwise-parallel
# --------------------------------------------------------------------------- #


def mlstm_chunkwise(q, k, v, i_gate, f_gate, *, chunk=128, state=None,
                    return_state=False):
    """Chunkwise mLSTM (``repro/kernels/ref.py mlstm_chunkwise``): within
    a chunk a quadratic form, across chunks the [b, h, e, e] float32
    matrix state, stabilised by the running max-log-gate m.

    q, k, v: [b, s, h, e]; i_gate: [b, s, h] (the pre-exp log input
    gate); f_gate: [b, s, h] (the forget logits, pre-sigmoid). ``state``
    is (C [b, h, e, e], n [b, h, e], m [b, h]) float32, zeros when None.
    The state is kept scaled by exp(-m). A ragged last chunk is padded
    with i = -1e30 (no write) and f = +1e30 (log-sigmoid 0, no decay), so
    the padding leaves the state as it is. Returns y [b, s, h, e] in
    q.dtype and, with ``return_state``, the state after step s - 1.
    """
    b, s, h, e = q.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        def z(a, cv=0.0):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad), value=cv)

        q, k, v = z(q), z(k), z(v)
        i_gate, f_gate = z(i_gate, -1e30), z(f_gate, 1e30)
    qf = q.float().reshape(b, nc, chunk, h, e) * (e ** -0.5)
    kf = k.float().reshape(b, nc, chunk, h, e)
    vf = v.float().reshape(b, nc, chunk, h, e)
    ig = i_gate.float().reshape(b, nc, chunk, h)
    fg = F.logsigmoid(f_gate.float()).reshape(b, nc, chunk, h)
    if state is None:
        C = torch.zeros((b, h, e, e), dtype=torch.float32, device=q.device)
        nrm = torch.zeros((b, h, e), dtype=torch.float32, device=q.device)
        m = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    else:
        C, nrm, m = state
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()[None, :, :, None]
    ys = []
    for j in range(nc):
        qc, kc, vc, ic, fc = (t[:, j] for t in (qf, kf, vf, ig, fg))
        Fc = torch.cumsum(fc, dim=1)                     # [b, c, h]
        # per-position stabiliser m_t = max(m + F_t, F_t + cummax(i - F))
        Mi = torch.cummax(ic - Fc, dim=1).values
        m_t = torch.maximum(m[:, None] + Fc, Fc + Mi)
        w_old = torch.exp(m[:, None] + Fc - m_t)
        out_inter = torch.einsum("bche,bhef->bchf", qc, C) \
            * w_old[..., None]
        nrm_inter = torch.einsum("bche,bhe->bch", qc, nrm) * w_old
        # pair weights exp(F_t - F_j + i_j - m_t), j <= t: [b, t, j, h]
        lw = (Fc[:, :, None, :] - Fc[:, None, :, :] + ic[:, None, :, :]
              - m_t[:, :, None, :])
        w_pair = torch.where(causal, torch.exp(lw), 0.0)
        sw = torch.einsum("bche,bjhe->bcjh", qc, kc) * w_pair
        out_intra = torch.einsum("bcjh,bjhe->bche", sw, vc)
        nrm_t = nrm_inter + sw.sum(dim=2)
        denom = torch.maximum(nrm_t.abs(), torch.exp(-m_t))
        ys.append((out_inter + out_intra) / denom[..., None])
        # the state at the chunk's end
        m_end = m_t[:, -1]
        decay = torch.exp(m + Fc[:, -1] - m_end)
        w_j = torch.exp(Fc[:, -1:, :] - Fc + ic - m_end[:, None])
        kw = kc * w_j[..., None]
        C = C * decay[..., None, None] \
            + torch.einsum("bche,bchf->bhef", kw, vc)
        nrm = nrm * decay[..., None] + kw.sum(dim=1)
        m = m_end
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, e)[:, :s]
    y = y.to(q.dtype)
    if return_state:
        return y, (C, nrm, m)
    return y


def mlstm_step(state, q, k, v, i_gate, f_gate):
    """One mLSTM decode step (``repro/kernels/ref.py mlstm_step``). q, k,
    v: [b, h, e]; gates [b, h]; state (C, n, m) float32. Returns (the new
    state, y [b, h, e] in q.dtype)."""
    C, nrm, m = state
    e = q.shape[-1]
    qf = q.float() * (e ** -0.5)
    ig = i_gate.float()
    lf = F.logsigmoid(f_gate.float())
    m_new = torch.maximum(lf + m, ig)
    i_w = torch.exp(ig - m_new)
    decay = torch.exp(lf + m - m_new)
    kw = k.float() * i_w[..., None]
    C_new = C * decay[..., None, None] \
        + kw[..., :, None] * v.float()[..., None, :]
    n_new = nrm * decay[..., None] + kw
    num = torch.einsum("bhe,bhef->bhf", qf, C_new)
    den = torch.maximum(torch.einsum("bhe,bhe->bh", qf, n_new).abs(),
                        torch.exp(-m_new))
    y = num / den[..., None]
    return (C_new, n_new, m_new), y.to(q.dtype)


# --------------------------------------------------------------------------- #
# sLSTM (scalar-memory cell with exponential gating), sequential scan
# --------------------------------------------------------------------------- #

# the clamp of the sLSTM's normaliser (``max(n, 1e-6)``)
SLSTM_N_MIN = 1e-6


def _slstm_zeros(b, h, e, device):
    z = torch.zeros((b, h, e), dtype=torch.float32, device=device)
    return z, z, z


def slstm_walk(x_gates, state=None, save_states=False):
    """The sLSTM recurrence one step at a time (the reference's
    ``lax.scan``), per channel in float32:

      lf = log_sigmoid(f), m' = max(lf + m, i),
      c' = exp(lf + m - m') c + exp(i - m') tanh(z),
      n' = exp(lf + m - m') n + exp(i - m'),
      y = sigmoid(o) c' / max(n', 1e-6).

    x_gates: [b, s, h, 4, e] pre-activations (i, f, z, o). Returns (y
    [b, s, h, e] in x_gates.dtype, the state after the last step, and
    with ``save_states`` the state before each step, [3, b, s, h, e]
    float32 (c, n, m): what K6 saves for K6b; else None)."""
    b, s, h, _, e = x_gates.shape
    xg = x_gates.float()
    c, n, m = (state if state is not None
               else _slstm_zeros(b, h, e, x_gates.device))
    floor = torch.tensor(SLSTM_N_MIN, dtype=torch.float32,
                         device=x_gates.device)
    ys, saved = [], []
    for t in range(s):
        if save_states:
            saved.append(torch.stack((c, n, m)))
        gi, gf, gz, go = xg[:, t].unbind(2)
        lf = F.logsigmoid(gf)
        m_new = torch.maximum(lf + m, gi)
        i_w = torch.exp(gi - m_new)
        f_w = torch.exp(lf + m - m_new)
        c = f_w * c + i_w * torch.tanh(gz)
        n = f_w * n + i_w
        m = m_new
        ys.append(torch.sigmoid(go) * c / torch.maximum(n, floor))
    y = (torch.stack(ys, dim=1) if s else
         xg.new_zeros((b, 0, h, e))).to(x_gates.dtype)
    states = None
    if save_states:
        states = (torch.stack(saved, dim=2) if s else
                  xg.new_zeros((3, b, 0, h, e)))
    return y, (c, n, m), states


def slstm_scan(x_gates, *, state=None, return_state=False):
    """sLSTM over a sequence (``repro/kernels/ref.py slstm_scan``):
    x_gates [b, s, h, 4, e] (i, f, z, o pre-activations); ``state`` (c,
    n, m) [b, h, e] float32 each, zeros when None. Returns y [b, s, h, e]
    in x_gates.dtype and, with ``return_state``, the final state."""
    y, st, _ = slstm_walk(x_gates, state)
    return (y, st) if return_state else y


def _tie_weight(a, b):
    """d max(a, b) / da: 1 where a > b, 0.5 at a tie, 0 below (JAX's and
    torch's ``maximum`` split a tie evenly)."""
    return (a > b).float() + 0.5 * (a == b).float()


def slstm_scan_bwd(x_gates, dy, states, d_state=None):
    """The gradient of :func:`slstm_scan` for the cotangents dy [b, s, h,
    e] of y and ``d_state`` (dc, dn, dm) of the final state (zeros when
    None), from the state before each step, ``states`` [3, b, s, h, e]
    (``slstm_walk(..., save_states=True)``). The reverse walk, step by
    step, in K6b's order of operations (the kernel's oracle): each step
    recomputes its forward from the saved state, then

      dc' += dy sg / nd,  dn' += -dy sg c' / nd^2 [n' > 1e-6],
      dfw = dc' c + dn' n,  diw = dc' tanh(z) + dn',
      dm' -= diw iw + dfw fw, split over (lf + m, i) by the max,
      dc = dc' fw, dn = dn' fw, dm = d(lf + m).

    The clamp max(n', 1e-6) passes nothing to n' where it binds (half at
    a tie), as the max of m' does. Returns (dgates [b, s, h, 4, e] in
    x_gates.dtype, (dc, dn, dm) of the initial state, float32)."""
    b, s, h, _, e = x_gates.shape
    xg = x_gates.float()
    dyf = dy.float()
    if d_state is None:
        dc, dn, dm = _slstm_zeros(b, h, e, x_gates.device)
    else:
        dc, dn, dm = (t.float() for t in d_state)
    floor = torch.tensor(SLSTM_N_MIN, dtype=torch.float32,
                         device=x_gates.device)
    dg = torch.empty((b, s, h, 4, e), dtype=torch.float32,
                     device=x_gates.device)
    for t in reversed(range(s)):
        c, n, m = states[:, :, t]
        gi, gf, gz, go = xg[:, t].unbind(2)
        g = dyf[:, t]
        # the step's forward, recomputed
        lf = F.logsigmoid(gf)
        a = lf + m
        mn = torch.maximum(a, gi)
        iw = torch.exp(gi - mn)
        fw = torch.exp(a - mn)
        tz = torch.tanh(gz)
        cn = fw * c + iw * tz
        nn = fw * n + iw
        sg = torch.sigmoid(go)
        nd = torch.maximum(nn, floor)
        # y = sg cn / nd
        p = sg * cn
        dp = g / nd
        dnd = -(g * p) / (nd * nd)
        dcn = dc + dp * sg
        dnn = dn + dnd * _tie_weight(nn, floor)
        dgo = dp * cn * sg * (1.0 - sg)
        # cn = fw c + iw tz, nn = fw n + iw
        dfw = dcn * c + dnn * n
        diw = dcn * tz + dnn
        dgz = dcn * iw * (1.0 - tz * tz)
        dc, dn = dcn * fw, dnn * fw
        # iw = exp(i - mn), fw = exp(a - mn), mn = max(a, i)
        e_i, e_f = diw * iw, dfw * fw
        dmn = dm - e_i - e_f
        wa = _tie_weight(a, gi)
        da = e_f + dmn * wa
        dgi = e_i + dmn * (1.0 - wa)
        # a = lf + m, lf = log_sigmoid(f)
        dm = da
        dgf = da * torch.sigmoid(-gf)
        dg[:, t] = torch.stack((dgi, dgf, dgz, dgo), dim=2)
    return dg.to(x_gates.dtype), (dc, dn, dm)
