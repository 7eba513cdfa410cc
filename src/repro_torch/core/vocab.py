"""Vocabulary head for serving: final norm, full logits, greedy tokens.

The port's counterpart of ``repro/core/vocab.py:253-280`` with the head
replicated (``vloc=None``): one rank holds the whole head, tied to the
embedding table, and the ``[b, d] @ [d, vocab]`` product is a plain
float32 matrix product (the reference upcasts the head to float32 the
same way). The vocab-sharded head needs several ranks and arrives with
them.
"""

from __future__ import annotations

import torch


def _final_norm_fwd(cfg, io_p, h):
    """Final RMSNorm in float32."""
    hf = h.float()
    scale = io_p["final_norm.scale"].float()
    inv = torch.rsqrt((hf * hf).mean(dim=-1, keepdim=True) + 1e-6)
    return hf * inv * scale


def _replicated(vloc):
    if vloc is not None:
        raise NotImplementedError(
            "the vocab-sharded head spans several data ranks; the port "
            "serves on one rank with the head replicated (vloc=None)")


def serve_logits(cfg, rc, io_p, h, vloc: int | None = None):
    """Full next-token logits [b, vocab] (float32) from final hiddens
    h [b, d]. Feeds the host-side sampling layer."""
    _replicated(vloc)
    hn = _final_norm_fwd(cfg, io_p, h)
    return hn @ io_p["embed.table"].t().float()


def greedy_sample(cfg, rc, io_p, h, vloc: int | None = None):
    """Greedy next token [b] int32 (first index of the maximum, as
    ``jnp.argmax``)."""
    return torch.argmax(serve_logits(cfg, rc, io_p, h, vloc),
                        dim=-1).to(torch.int32)
