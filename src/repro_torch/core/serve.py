"""The one-rank serve step and the serve cache tree.

The port's counterpart of ``repro/core/pipeline.py:533-653``
(``init_serve_caches``, ``reset_slot_caches``, ``reset_pages``,
``copy_pages``) and of the reference's serve body at one rank.

``serve_step`` runs no tick engine: on one rank there is nothing to
schedule, so it embeds the tokens, walks the stages in logical order
(stage ``s = v·pp + p`` at stacked index ``p·V + v``, for any pp/vpp the
params were stacked with), and samples greedily from the last position's
hidden state. On a mesh of ranks the serve step runs the forward-only
table on the tick engine instead (``core/executor.py serve_body``); its
cache tree is this rank's part of the same tree (``init_serve_caches``
with ``stages=V``, the rank's slot rows or page block), and
``copy_pages_across`` moves a page between the pods × data shards.

Caches are updated in place, where the reference returns new arrays (its
jitted step donates them instead):

* ``serve_step`` writes each layer's K/V, and int8 page scales, into the
  cache leaves it is given (``models/blocks.py``), and returns the same
  tree;
* ``reset_slot_caches``, ``reset_pages`` and ``copy_pages`` zero or copy
  rows/pages of every leaf in place.

Callers that need the old cache contents must clone them first.

Cache tree: ``{"main": {"L{j}.k": [P·V, slots, max_seq, g, e], ...}}``
(on a mesh ``[V, b_loc, ...]``, or ``[V, n_pages / (pods·data), ...]``
paged),
or with paging ``[P·V, n_pages, page_size, g, e]`` leaves plus
``L{j}.k_scale``/``L{j}.v_scale`` ``[P·V, n_pages, g]`` float32 leaves
for int8 pools. A Mamba layer slot holds ``L{j}.conv`` ``[P·V, slots,
d_conv-1, di]`` (compute dtype) and ``L{j}.h`` ``[P·V, slots, di,
d_state]`` (float32); its state has no positions, so it is never paged.
An encoder-decoder's tree is its decoder's, ``{"dec": {...}}``, with the
memory beside it: ``"enc_memory"`` ``[slots, enc_ctx, d]`` in the compute
dtype, which the caller fills (``models/model.py encode``) and a slot
reset zeroes, as the reference's; it has no page layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import vocab as Vb
from repro_torch.models import model as M
from repro_torch.models.blocks import LayerCtx
from repro_torch.models.common import rope_tables, torch_dtype


def init_serve_caches(cfg, rc, geo, *, slots: int, max_seq: int,
                      page_size: int = 0, n_pages: int = 0, device="cuda",
                      stages: int | None = None):
    """Zeroed cache tree on ``device``: ``stages`` leading rows (default
    every stage, P·V; a rank of a mesh holds its V), ``slots`` rows or
    ``n_pages`` pages."""
    tree = {}
    for seg in geo.segments:
        if seg.name == "enc":
            continue
        rows = stages or geo.seg_stages(seg)
        slots_tree = {}
        for j, kind in enumerate(seg.kinds):
            cs = dict(M.layer_cache_spec(cfg, rc, kind, slots, max_seq))
            if page_size and set(cs) != {"k", "v"}:
                raise ValueError(
                    f"layer kind {kind!r} keeps per-slot recurrent state "
                    "that has no pages; build its caches without "
                    "page_size")
            for n in list(cs):
                shape, dt = cs[n]
                if page_size:
                    cs[n] = ((n_pages, page_size) + shape[2:], dt)
                    if rc.kv_cache_dtype == "int8":
                        # scales live beside the pool and move with its
                        # pages through reset_pages/copy_pages
                        cs[n + "_scale"] = ((n_pages,) + shape[2:-1],
                                            torch.float32)
            for n, (shape, dt) in cs.items():
                slots_tree[f"L{j}.{n}"] = torch.zeros(
                    (rows,) + shape, dtype=dt, device=device)
        tree[seg.name] = slots_tree
    if cfg.encdec is not None:
        if page_size:
            raise ValueError("the encoder's memory has no page layout; "
                             "build an encoder-decoder's caches without "
                             "page_size")
        tree["enc_memory"] = torch.zeros(
            (slots, cfg.encdec.enc_ctx, cfg.d_model),
            dtype=torch_dtype(rc.compute_dtype), device=device)
    return tree


def reset_slot_caches(caches, rows: torch.Tensor):
    """Zero the cache rows ``rows`` (int64 slot indices) of every leaf in
    place (batch on axis 1). Slot reclaim: stale bytes beyond the new
    request's horizon must not leak into it. The memory's rows (axis 0)
    too."""
    for key, sub in caches.items():
        if key == "enc_memory":
            sub[rows] = 0
            continue
        for a in sub.values():
            a[:, rows] = 0
    return caches


def reset_pages(caches, pages: torch.Tensor):
    """Zero the pages ``pages`` (int64 ids) of every paged leaf in place
    (page axis 1, scales included): fresh pages must read as zeros."""
    return reset_slot_caches(caches, pages)


def copy_pages(caches, src: torch.Tensor, dst: torch.Tensor):
    """Copy page ``src[i]`` -> ``dst[i]`` in every paged leaf, in place.
    ``dst`` entries repeat only as exact repeats of one (src, dst) pair,
    so duplicate writes carry identical values."""
    for sub in caches.values():
        for a in sub.values():
            a[:, dst] = a[:, src]
    return caches


TAG_PAGE = 16   # tags of page copies: TAG_PAGE + the pair's index


def copy_pages_across(caches, src, dst, *, dev_pages: int, shard: int,
                      peer, exchange):
    """``copy_pages`` on a mesh, in place: ``src`` / ``dst`` are *global*
    page ids (numpy), shard ``i`` of the pods × data axes holds pages
    ``[i·dev_pages, (i+1)·dev_pages)`` as local ids ``gid % dev_pages``,
    and this rank holds shard ``shard``. A pair within one shard copies
    locally; a pair across shards is a send of the source page's rows
    from the rank of the same model index in the source shard
    (``peer(shard)`` gives its global rank) to this one, through
    ``exchange`` (``Mesh.exchange``). Every source is read before any
    destination is written, as the reference's ``a.at[:, dst].set(a[:,
    src])``; repeats of one (src, dst) pair count once."""
    pairs = list(dict.fromkeys(zip(np.asarray(src).reshape(-1).tolist(),
                                   np.asarray(dst).reshape(-1).tolist())))
    for sub in caches.values():
        for a in sub.values():
            put, sends, recvs, into = {}, [], [], []
            for i, (s, d) in enumerate(pairs):
                ss, ds = s // dev_pages, d // dev_pages
                if ds == shard and ss == shard:
                    put[i] = a[:, s % dev_pages].clone()
                elif ds == shard:
                    recvs.append((peer(ss), TAG_PAGE + i))
                    into.append(i)
                elif ss == shard:
                    sends.append((a[:, s % dev_pages], peer(ds),
                                  TAG_PAGE + i))
            got = exchange(sends, recvs, a[:, 0].shape, a.dtype) \
                if sends or recvs else []
            put.update(zip(into, got))
            for i, t in put.items():
                a[:, pairs[i][1] % dev_pages] = t
    return caches


def rope_for(cfg, max_seq: int, device) -> dict:
    """Full-length RoPE tables per rotated head dim."""
    return {cfg.head_dim: rope_tables(max_seq, cfg.head_dim, cfg.rope_theta,
                                      device=device)}


def serve_step(cfg, rc, geo, params, caches, batch, *, rope,
               page_size: int = 0, want_logits: bool = False,
               write_rows=None):
    """One prefill chunk (s > 1) or decode step (s == 1) over every row
    (an encoder-decoder's decoder, its cross-attention reading
    ``caches["enc_memory"]``).

    ``batch``: ``tokens`` int [b, s] on the device (or a vision
    prefill's float embeddings [b, s, d], which go in as they are);
    ``pos`` an int (every row at the same position) or an int [b] tensor
    (per slot);
    optional ``slot_mask`` bool [b] (rows allowed to write their cache;
    ``write_rows`` is its index form, if the caller has it) and
    ``page_tables`` int [b, ppr] for paged caches. Returns ``(tokens,
    caches)`` — or ``(tokens, logits, caches)`` with ``want_logits`` —
    with tokens int32 [b] sampled greedily from each row's last position
    and logits float32 [b, vocab], both on the device.
    """
    io = params["io"]
    tokens = batch["tokens"]
    pos = batch.get("pos", 0)
    page_tables = batch.get("page_tables")
    per_slot = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if page_tables is not None and not (per_slot and page_size > 0):
        raise ValueError(
            "page_tables require a per-slot pos vector and page_size > 0")
    seg = geo.segments[-1]   # the decoder of an encoder-decoder
    seg_p = params["segments"][seg.name]
    tree = caches[seg.name]
    ctx = LayerCtx(cfg=cfg, rc=rc, rope=rope, causal=True,
                   enc_memory=caches.get("enc_memory"),
                   slot_mask=batch.get("slot_mask"), write_rows=write_rows,
                   page_tables=page_tables, page_size=page_size)
    x = M.embed_tokens(io, tokens, cfg, torch_dtype(rc.compute_dtype))
    n_kinds = len(seg.kinds)
    for s in range(geo.seg_stages(seg)):
        idx = M.storage_index(s % geo.pp, s // geo.pp, seg.vpp)
        sp = {n: a[idx] for n, a in seg_p.items()}
        ch = [{n.split(".", 1)[1]: a[idx] for n, a in tree.items()
               if n.startswith(f"L{j}.")} for j in range(n_kinds)]
        # the layers write into the leaf views in ch, so the stage's
        # returned caches need no copy back
        x, _ = M.cached_stage(ctx, seg, sp, x, ch, s, pos)
    h_last = x[:, -1]
    if want_logits:
        logits = Vb.serve_logits(cfg, rc, io, h_last)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return tok, logits, caches
    return Vb.greedy_sample(cfg, rc, io, h_last), caches
