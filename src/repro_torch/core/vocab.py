"""Vocabulary head: embedding lookup and grad, the training loss, and the
serving logits.

The port's counterpart of ``repro/core/vocab.py``. The head is replicated
(``vloc=None``: one rank, or a vocabulary the data axis does not divide)
or vocabulary-sharded over the data axis (``vloc`` rows a shard, from
:func:`vocab_shard`): the data ranks then hold different tokens AND
different vocabulary shards, and ``comm`` is the data axis's
communicator (``rank = comm.index``, rows ``[rank * vloc, (rank + 1) *
vloc)``). As in the reference:

* lookup: gather every data rank's ids, serve the ids of this shard from
  the local rows, sum over the data axis, keep this rank's block;
* embedding grad: a capacity-padded all-to-all sends each row's gradient
  to the rank that owns the row, ``cap = max(8, ceil(2 n / dsize))``
  entries a destination; what overflows is dropped and counted;
* loss: gather the normed hiddens, labels and mask over data; this
  shard's statistics for all gathered rows; combine them with a max and
  a sum over data; dW of the shard is local and complete, dh is summed
  over data and sliced back.

Training (``loss_and_dy``): the final norm (RMSNorm, or LayerNorm with
its bias) and its explicit backward, then the loss. The reference's
replicated branch holds the ``[n, vocab]`` logits in float32; the port
computes the same function — loss = sum((lse - label logit) * mask) /
denom, dh = dlog W^T, dW = hn^T dlog — through ``ops.softmax_xent``, the
fused cross-entropy kernel (K2) on the card, with the bf16 head read in
place (no float32 or transposed copy): the tied table through its
transpose (dW goes to ``embed.table``), or the untied ``head.w`` [d,
vocab] itself (dW goes to ``head.w``; ``embed.table`` then gets only the
lookup's gradient). The sharded branch runs K2's two passes apart
(``ops.xent_stats`` over the shard, the cross-shard combine, then
``ops.xent_grads`` with the combined log-sum-exp); labels outside the
shard go in as -1. The reference computes that branch outside its
kernel, as a plain scan over vocabulary chunks.

Serving: the ``[b, d] @ [d, vocab]`` product is a plain float32 matrix
product (the reference upcasts the head to float32 the same way); the
head is the tied table's transpose, or ``head.w`` [d, vocab] when the
embedding is untied. Serving runs on one rank (replicated head).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

SHARDED = ("embed.table", "head.w")   # the io params a vocab shard cuts


def vocab_shard(vocab: int, dsize: int) -> int | None:
    """Rows per shard, or None -> replicated."""
    if dsize > 1 and vocab % dsize == 0 and vocab // dsize >= 8:
        return vocab // dsize
    return None


def _replicated(vloc):
    if vloc is not None:
        raise NotImplementedError(
            "serving runs on one rank with the head replicated (vloc=None); "
            "multi-rank serving is ROADMAP.md queue 1 item 1b")


# --------------------------------------------------------------------------- #
# Embedding
# --------------------------------------------------------------------------- #


def embed_lookup(table, ids, vloc: int | None, dtype, comm=None):
    """table [vloc|vocab, d]; ids [b, s] int -> [b, s, d] in ``dtype``.

    Sharded: the rows of every data rank's ids that fall in this shard,
    summed over the data axis (one shard holds each row, so the sum is
    exact; it runs in float32), then this rank's block."""
    if vloc is None:
        return table[ids.long()].to(dtype)
    r, b = comm.index, ids.shape[0]
    ids_all = comm.all_gather(ids.long())                # [D b, s]
    lo = r * vloc
    hit = (ids_all >= lo) & (ids_all < lo + vloc)
    loc = (ids_all - lo).clamp(0, vloc - 1)
    e = table[loc].float() * hit[..., None]
    e = comm.all_reduce(e)
    return e[r * b:(r + 1) * b].to(dtype)


def embed_grad(ids, dx, vloc: int | None, vocab: int, acc, comm=None):
    """Scatter-add dx [b, s, d] into the table-grad accumulator ``acc``
    ([vocab | vloc, d]), in place (the reference returns a new array).
    Returns (acc, n_dropped): nothing drops when replicated; sharded,
    the entries past a destination's capacity."""
    n = ids.numel()
    d = dx.shape[-1]
    idf = ids.reshape(n).long()
    dxf = dx.reshape(n, d).to(acc.dtype)
    if vloc is None:
        acc.index_add_(0, idf, dxf)
        return acc, 0
    dsize = vocab // vloc
    dest = idf // vloc
    cap = max(8, -(-2 * n // dsize))
    oh = torch.nn.functional.one_hot(dest, dsize)
    slot = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)     # rank within dest
    keep = slot < cap
    dropped = n - int(keep.sum())
    dest, slot = dest[keep], slot[keep]
    buf = torch.zeros((dsize, cap, d), dtype=acc.dtype, device=acc.device)
    buf[dest, slot] = dxf[keep]
    rows = torch.zeros((dsize, cap), dtype=torch.long, device=acc.device)
    rows[dest, slot] = idf[keep] % vloc + 1              # 0 = empty slot
    buf, rows = comm.all_to_all(buf), comm.all_to_all(rows)
    rows = rows.reshape(-1)
    ok = rows > 0
    acc.index_add_(0, rows[ok] - 1, buf.reshape(-1, d)[ok])
    return acc, dropped


# --------------------------------------------------------------------------- #
# Loss (final RMS/LayerNorm + softmax cross-entropy) with explicit backward
# --------------------------------------------------------------------------- #


def _final_norm_fwd(cfg, io_p, h):
    """Final RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5, with its bias) in
    float32; returns (hn, residuals for the bwd)."""
    hf = h.float()
    scale = io_p["final_norm.scale"].float()
    if cfg.norm == "layernorm":
        mu = hf.mean(dim=-1, keepdim=True)
        var = ((hf - mu) ** 2).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + 1e-5)
        hn = (hf - mu) * inv
        y = hn * scale + io_p["final_norm.bias"].float()
        return y, (hf, hn, inv, scale)
    inv = torch.rsqrt((hf * hf).mean(dim=-1, keepdim=True) + 1e-6)
    return hf * inv * scale, (hf, hf * inv, inv, scale)


def _final_norm_bwd(cfg, res, dy):
    hf, hn, inv, scale = res
    rows = tuple(range(dy.ndim - 1))
    dscale = (dy * hn).sum(dim=rows)
    g = dy * scale
    if cfg.norm == "layernorm":
        gm = g.mean(dim=-1, keepdim=True)
        ghn = (g * hn).mean(dim=-1, keepdim=True)
        dh = inv * (g - gm - hn * ghn)
        return dh, {"final_norm.scale": dscale,
                    "final_norm.bias": dy.sum(dim=rows)}
    dot = (g * hf).mean(dim=-1, keepdim=True)
    dh = inv * g - hf * (inv ** 3) * dot
    return dh, {"final_norm.scale": dscale}


def loss_and_dy(cfg, rc, io_p, h, labels, denom: float, vloc: int | None,
                dsize: int = 1, mask=None, comm=None):
    """h: [n, d] final hiddens (one micro-batch, flattened), labels [n].

    Returns (loss_sum_scaled, dh [n, d] in h.dtype, io grads {name:
    float32}). ``denom`` is the global token count — gradients come out
    mean-normalised; ``mask`` [n] zeroes positions. Sharded (``vloc``
    rows a shard over ``comm``'s ``dsize`` data ranks): the loss is that
    of this rank's own rows and the head's grad is that of this rank's
    shard.
    """
    hn, res = _final_norm_fwd(cfg, io_p, h)
    tied = cfg.tie_embeddings
    key = "embed.table" if tied else "head.w"
    # [d, vocab | vloc], read in place: the table's transpose, or head.w
    w_head = io_p["embed.table"].t() if tied else io_p["head.w"]
    kw = dict(chunk=rc.vocab_chunk, impl=rc.kernel_impl)
    if vloc is None:
        loss, (dhn, dw) = ops.softmax_xent(hn, w_head, labels, mask=mask,
                                           denom=denom, **kw)
    else:
        n, r = h.shape[0], comm.index
        if mask is None:
            mask = torch.ones((n,), dtype=torch.float32, device=h.device)
        hn_all = comm.all_gather(hn)                         # [D n, d]
        lab_all = comm.all_gather(labels.reshape(-1).long())
        mask_all = comm.all_gather(mask.float())
        lo = r * vloc
        inw = (lab_all >= lo) & (lab_all < lo + vloc)
        lab_loc = torch.where(inw, lab_all - lo, -1)   # -1: another shard
        lse_loc, labl = ops.xent_stats(hn_all, w_head, lab_loc, **kw)
        m = comm.all_reduce(lse_loc, "max")
        lse = m + torch.log(comm.all_reduce(torch.exp(lse_loc - m)))
        lab_logit = comm.all_reduce(labl)
        # each rank reports the loss of its OWN rows (no double count)
        loss = ((lse - lab_logit) * mask_all)[r * n:(r + 1) * n].sum() \
            / denom
        dhn_all, dw = ops.xent_grads(hn_all, w_head, lab_loc, lse,
                                     mask_all / denom, **kw)
        dhn = comm.all_reduce(dhn_all)[r * n:(r + 1) * n]
    dh, grads = _final_norm_bwd(cfg, res, dhn)
    grads[key] = dw.t() if tied else dw
    return loss, dh.to(h.dtype), grads


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #


def serve_logits(cfg, rc, io_p, h, vloc: int | None = None):
    """Full next-token logits [b, vocab] (float32) from final hiddens
    h [b, d]. Feeds the host-side sampling layer."""
    _replicated(vloc)
    hn, _ = _final_norm_fwd(cfg, io_p, h)
    w = (io_p["embed.table"].t() if cfg.tie_embeddings
         else io_p["head.w"])
    return hn @ w.float()


def greedy_sample(cfg, rc, io_p, h, vloc: int | None = None):
    """Greedy next token [b] int32 (first index of the maximum, as
    ``jnp.argmax``)."""
    return torch.argmax(serve_logits(cfg, rc, io_p, h, vloc),
                        dim=-1).to(torch.int32)
