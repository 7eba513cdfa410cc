"""Transformer blocks for cached serving (prefill s > 1 / decode s == 1).

The port's counterpart of the serving half of ``repro/models/blocks.py``
for dense attention layers: RMSNorm, the SwiGLU FFN, and ``attn_cached``
with its three cache layouts (paged pool, per-slot positions, one scalar
position). The reference's sequence-sharded cache branch
(``blocks.py:832``) combines attention across ranks and waits for the
multi-rank slices. Params are flat dicts named like the reference's (``L{j}.``
prefixes are added by the stage assembly in ``model.py``).

Two JAX behaviours are reproduced on purpose, because the serve engine
relies on them:

* ``dynamic_slice``/``dynamic_update_slice`` clamp their start into
  ``[0, S - s]``; PyTorch slicing would raise or cut instead. A
  co-admitted prefill hands in-flight neighbours their own ``pos``, so
  ``pos + s`` may pass the cache end on rows the mask keeps from writing.
* Scatters with ``mode="drop"`` skip masked rows; here the rows allowed to
  write are selected up front (``LayerCtx.write_rows``), so masked rows
  never reach an index.

Unlike the reference, the caches are updated in place: the leaves handed
in are views of the session's cache tree, and ``attn_cached`` writes K/V
(and int8 scales) straight into them and returns the same tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    RunConfig,
    apply_rope,
)

# --------------------------------------------------------------------------- #
# Context threaded through layer application
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class LayerCtx:
    cfg: ModelConfig
    rc: RunConfig
    rope: dict[int, tuple[torch.Tensor, torch.Tensor]]  # head_dim -> tables
    causal: bool = True
    slot_mask: Any = None            # [b] bool: rows allowed to write their
    #                                  cache slot (continuous batching);
    #                                  None = every row writes
    write_rows: Any = None           # int64 indices of slot_mask's True
    #                                  rows (None: derived from slot_mask);
    #                                  the serve step computes them once on
    #                                  the host instead of once per layer
    page_tables: Any = None          # [b, pages_per_req] int page ids
    #                                  (paged KV cache); None = the
    #                                  contiguous per-row cache layout
    page_size: int = 0               # tokens per page when paged


def _write_rows(ctx: LayerCtx, b: int, device) -> torch.Tensor:
    if ctx.write_rows is not None:
        return ctx.write_rows
    if ctx.slot_mask is None:
        return torch.arange(b, device=device)
    return torch.nonzero(ctx.slot_mask).reshape(-1)


# --------------------------------------------------------------------------- #
# Param specs (same names and shapes as the reference)
# --------------------------------------------------------------------------- #


def norm_specs(cfg: ModelConfig, pfx: str) -> dict[str, ParamSpec]:
    return {f"{pfx}.scale": ParamSpec((cfg.d_model,), "ones", fsdp_dim=0)}


def attn_specs(cfg: ModelConfig, pfx: str):
    d, h, g, e = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        f"{pfx}.wq": ParamSpec((d, h, e), fsdp_dim=0),
        f"{pfx}.wk": ParamSpec((d, g, e), fsdp_dim=0),
        f"{pfx}.wv": ParamSpec((d, g, e), fsdp_dim=0),
        f"{pfx}.wo": ParamSpec((h, e, d), fsdp_dim=2),
    }


def ffn_specs(cfg: ModelConfig, pfx: str):
    d, f = cfg.d_model, cfg.d_ff
    return {
        f"{pfx}.wg": ParamSpec((d, f), fsdp_dim=1),
        f"{pfx}.wu": ParamSpec((d, f), fsdp_dim=1),
        f"{pfx}.wd": ParamSpec((f, d), fsdp_dim=0),
    }


# --------------------------------------------------------------------------- #
# Forward pieces
# --------------------------------------------------------------------------- #


def _dense(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Contract the last ``n_in`` dims of x with the first ``n_in`` of w
    (the reference's einsums, as one matrix product)."""
    lead = x.shape[:x.ndim - n_in]
    k = math.prod(w.shape[:n_in])
    y = x.reshape(-1, k) @ w.reshape(k, -1)
    return y.reshape(*lead, *w.shape[n_in:])


def norm_fwd(cfg, params, pfx, x):
    """RMSNorm in float32, cast back to x.dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (y * params[f"{pfx}.scale"]).to(x.dtype)


def ffn_fwd(ctx, params, pfx, x):
    """SwiGLU."""
    g = _dense(x, params[f"{pfx}.wg"])
    u = _dense(x, params[f"{pfx}.wu"])
    return _dense(F.silu(g) * u, params[f"{pfx}.wd"])


# --------------------------------------------------------------------------- #
# Cache writes
# --------------------------------------------------------------------------- #


def _rope_slice(ctx, e, pos, s):
    """cos/sin rows [pos, pos+s) of the full tables [max_seq, e/2]: [s, e/2]
    for a scalar pos, [b, s, e/2] for per-row positions. The start is
    clamped into [0, max_seq - s], as ``jax.lax.dynamic_slice`` does."""
    cos, sin = ctx.rope[e]
    hi = cos.shape[0] - s
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        start = pos.to(cos.device).long().clamp(0, hi)
        idx = start[:, None] + torch.arange(s, device=cos.device)
        return cos[idx], sin[idx]
    p = min(max(int(pos), 0), hi)
    return cos[p:p + s], sin[p:p + s]


def _slot_scatter(ctx, cache_arr, new, pos):
    """Write ``new`` [b, s, ...] into ``cache_arr`` [b, S, ...] in place at
    each row's position ``pos`` [b] (start clamped into [0, S - s]).
    Rows outside ``ctx.slot_mask`` are not written: a prefill into one
    slot never clobbers a neighbouring in-flight request."""
    b, s = new.shape[:2]
    rows = _write_rows(ctx, b, new.device)
    start = pos.to(new.device).long().clamp(0, cache_arr.shape[1] - s)
    idx = start[rows][:, None] + torch.arange(s, device=new.device)
    cache_arr[rows[:, None], idx] = new[rows].to(cache_arr.dtype)
    return cache_arr


def _paged_scatter(ctx, pool, new, pos, scale=None):
    """Write ``new`` [b, s, ...] into the page pool in place at each
    writing row's absolute positions ``pos + [0, s)``, routed through its
    page table. Rows never share writable pages (shared prefix pages are
    read-only and prefill resumes past them), so the flat indices are
    collision-free. Returns ``(pool, scale)``.

    With ``scale`` (int8 pages, [n_pages, ...head-dims] float32): per-page
    scales only grow (scatter-max of amax/127); the pages this write
    touches are requantised by the old/new ratio (exactly 1.0 where the
    scale did not grow, so their bytes are unchanged — the reference
    requantises every page with that identity ratio), then the incoming
    tokens are quantised with their page's new scale, rounding half to
    even as ``jnp.round`` does.
    """
    b, s = new.shape[:2]
    ps = ctx.page_size
    n_loc = pool.shape[0]
    dev = new.device
    rows = _write_rows(ctx, b, dev)
    new = new[rows]
    t = pos.to(dev).long()[rows][:, None] + torch.arange(s, device=dev)
    page = torch.gather(ctx.page_tables.to(dev).long()[rows], 1, t // ps)
    flat = (page * ps + t % ps).reshape(-1)
    touched = page.reshape(-1)
    if scale is not None:
        nf = new.float()
        amax = nf.abs().amax(dim=-1)                    # [r, s] + head dims
        src = (amax / 127.0).reshape((-1,) + tuple(scale.shape[1:]))
        idx = touched.reshape((-1,) + (1,) * (src.ndim - 1)).expand_as(src)
        old = scale.clone()
        scale.scatter_reduce_(0, idx, src, reduce="amax", include_self=True)
        ratio = torch.where(scale > 0,
                            old / torch.clamp_min(scale, 1e-30), 1.0)
        r = ratio[touched]
        r = r.reshape((r.shape[0], 1) + tuple(scale.shape[1:]) + (1,))
        pool[touched] = torch.clamp(torch.round(pool[touched].float() * r),
                                    -127, 127).to(pool.dtype)
        sc_tok = scale[touched].reshape(
            tuple(page.shape) + tuple(scale.shape[1:]))[..., None]
        new = torch.clamp(torch.round(nf / torch.clamp_min(sc_tok, 1e-30)),
                          -127, 127)
    pool_flat = pool.view((n_loc * ps,) + tuple(pool.shape[2:]))
    pool_flat[flat] = new.reshape(
        (-1,) + tuple(new.shape[2:])).to(pool.dtype)
    return pool, scale


# --------------------------------------------------------------------------- #
# Cached attention
# --------------------------------------------------------------------------- #


def attn_cached(ctx: LayerCtx, params, pfx, x, cache, pos):
    """x: [b, s, d]; cache k/v: [b, S, g, e] (or page pools); pos: first
    absolute position — an int, or a [b] tensor (slotted serving): each
    row scatters into its cache at its own position, writes gated by
    ``ctx.slot_mask``, and attends with a per-row causal offset."""
    cfg = ctx.cfg
    e = cfg.head_dim
    s = x.shape[1]
    q = _dense(x, params[f"{pfx}.wq"])
    k = _dense(x, params[f"{pfx}.wk"])
    v = _dense(x, params[f"{pfx}.wv"])
    cos, sin = _rope_slice(ctx, e, pos, s)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    impl = ctx.rc.kernel_impl
    if ctx.page_tables is not None:
        # paged KV: scatter this step's K/V through the page tables
        # (quantising when the pool is int8), then attend straight out of
        # the pool; the kernel (or its plain version) applies the per-row
        # causal offset and the sentinel masking itself.
        ksc, vsc = cache.get("k_scale"), cache.get("v_scale")
        kp, ksc = _paged_scatter(ctx, cache["k"], k, pos, ksc)
        vp, vsc = _paged_scatter(ctx, cache["v"], v, pos, vsc)
        o = ops.paged_attention(
            q, kp, vp, page_tables=ctx.page_tables, pos=pos,
            k_scale=ksc, v_scale=vsc, slot_mask=ctx.slot_mask,
            block_k=ctx.rc.attn_block_k, impl=impl)
        cache = {"k": kp, "v": vp}
        if ksc is not None:
            cache["k_scale"], cache["v_scale"] = ksc, vsc
    elif isinstance(pos, torch.Tensor) and pos.ndim == 1:
        kc = _slot_scatter(ctx, cache["k"], k, pos)
        vc = _slot_scatter(ctx, cache["v"], v, pos)
        o = ops.attention(q, kc, vc, causal=True, q_offset=pos,
                          block_k=ctx.rc.attn_block_k, impl=impl)
        cache = {"k": kc, "v": vc}
    else:
        kc, vc = cache["k"], cache["v"]
        p = min(max(int(pos), 0), kc.shape[1] - s)   # dynamic_update_slice
        kc[:, p:p + s] = k.to(kc.dtype)
        vc[:, p:p + s] = v.to(vc.dtype)
        o = ops.attention(q, kc, vc, causal=True, q_offset=pos,
                          block_k=ctx.rc.attn_block_k, impl=impl)
        cache = {"k": kc, "v": vc}
    y = _dense(o, params[f"{pfx}.wo"], n_in=2)
    return y, cache
