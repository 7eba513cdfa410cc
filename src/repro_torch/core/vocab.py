"""Vocabulary head: embedding lookup and grad, the training loss, and the
serving logits.

The port's counterpart of ``repro/core/vocab.py`` with the head
replicated (``vloc=None``): one rank holds the whole head. The
vocab-sharded head needs several ranks and arrives with them.

Training (``loss_and_dy``): the final norm (RMSNorm, or LayerNorm with
its bias) and its explicit backward, then the loss. The reference's
one-rank branch holds the ``[n, vocab]`` logits in float32; the port
computes the same function — loss = sum((lse - label logit) * mask) /
denom, dh = dlog W^T, dW = hn^T dlog — through ``ops.softmax_xent``, the
fused cross-entropy kernel (K2) on the card, with the bf16 head read in
place (no float32 or transposed copy): the tied table through its
transpose (dW goes to ``embed.table``), or the untied ``head.w`` [d,
vocab] itself (dW goes to ``head.w``; ``embed.table`` then gets only the
lookup's gradient).

Serving: the ``[b, d] @ [d, vocab]`` product is a plain float32 matrix
product (the reference upcasts the head to float32 the same way); the
head is the tied table's transpose, or ``head.w`` [d, vocab] when the
embedding is untied.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def _replicated(vloc):
    if vloc is not None:
        raise NotImplementedError(
            "the vocab-sharded head spans several data ranks; the port "
            "runs on one rank with the head replicated (vloc=None)")


# --------------------------------------------------------------------------- #
# Embedding
# --------------------------------------------------------------------------- #


def embed_lookup(table, ids, vloc: int | None, dtype):
    """table [vocab, d]; ids [b, s] int -> [b, s, d] in ``dtype``."""
    _replicated(vloc)
    return table[ids.long()].to(dtype)


def embed_grad(ids, dx, vloc: int | None, vocab: int, acc):
    """Scatter-add dx [b, s, d] into the table-grad accumulator ``acc``
    [vocab, d], in place (the reference returns a new array). Returns
    (acc, n_dropped) — nothing drops on one rank."""
    _replicated(vloc)
    n = ids.numel()
    acc.index_add_(0, ids.reshape(n).long(),
                   dx.reshape(n, dx.shape[-1]).to(acc.dtype))
    return acc, 0


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
                dsize: int = 1, mask=None):
    """h: [n, d] final hiddens (one micro-batch, flattened), labels [n].

    Returns (loss_sum_scaled, dh [n, d] in h.dtype, io grads {name:
    float32}). ``denom`` is the global token count — gradients come out
    mean-normalised; ``mask`` [n] zeroes positions.
    """
    _replicated(vloc)
    hn, res = _final_norm_fwd(cfg, io_p, h)
    tied = cfg.tie_embeddings
    # [d, vocab], read in place: the table's transpose, or head.w itself
    w_head = io_p["embed.table"].t() if tied else io_p["head.w"]
    loss, (dhn, dw) = ops.softmax_xent(
        hn, w_head, labels, chunk=rc.vocab_chunk, mask=mask, denom=denom,
        impl=rc.kernel_impl)
    dh, grads = _final_norm_bwd(cfg, res, dhn)
    grads["embed.table" if tied else "head.w"] = dw.t() if tied else dw
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
