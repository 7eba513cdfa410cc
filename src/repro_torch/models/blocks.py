"""Transformer blocks: tape versions for training, cached for serving.

The port's counterpart of ``repro/models/blocks.py`` for dense attention,
Mamba, xLSTM (mLSTM and sLSTM) and gathered-MoE layers. Training:
``apply_norm`` (RMSNorm or LayerNorm), ``apply_attn``, ``apply_ffn``
(SwiGLU or the GELU MLP), ``apply_mamba`` (the selective scan: K5
forward, K5b backward on the card), ``apply_mlstm`` (the chunkwise
mLSTM, plain PyTorch), ``apply_slstm`` (the sLSTM: K6 forward, K6b
backward on the card) and ``apply_moe`` (gathered top-k experts with the
router's load-balance loss) are written against the ZeroPP tape
(``core/tape.py``): every parameterised GEMM is a ``dense`` node
(deferred dW, the W task; the expert banks too), everything else a
``prim`` (immediate grads in B). Serving: ``norm_fwd`` (RMSNorm or
LayerNorm), ``ffn_fwd`` (SwiGLU or the GELU MLP), ``attn_cached`` with
its three cache layouts (paged pool, per-slot positions, one scalar
position), ``mamba_cached`` (prefill through the selective-scan kernel,
decode one SSM step), ``mlstm_cached`` / ``slstm_cached`` (prefill and
decode of the xLSTM cells; the sLSTM through K6) and ``moe_fwd`` (the
gathered top-k MoE, no tape). The reference's sequence-sharded cache
branch (``blocks.py:832``) combines attention across ranks and waits for
the multi-rank slices. Params are flat dicts named like the reference's
(``L{j}.`` prefixes are added by the stage assembly in ``model.py``).

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
(and int8 scales) straight into them and returns the same tensors;
``_slot_state`` writes a recurrent layer's new state (Mamba's conv and
SSM state, the mLSTM's C, n, m, the sLSTM's c, n, m) into its leaves on
the writing rows only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.tape import Tape, TVal
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
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {
            f"{pfx}.scale": ParamSpec((d,), "ones", fsdp_dim=0),
            f"{pfx}.bias": ParamSpec((d,), "zeros", fsdp_dim=0),
        }
    return {f"{pfx}.scale": ParamSpec((d,), "ones", fsdp_dim=0)}


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
    if cfg.act == "gelu_mlp":
        return {
            f"{pfx}.wi": ParamSpec((d, f), fsdp_dim=1),
            f"{pfx}.wd": ParamSpec((f, d), fsdp_dim=0),
        }
    return {
        f"{pfx}.wg": ParamSpec((d, f), fsdp_dim=1),
        f"{pfx}.wu": ParamSpec((d, f), fsdp_dim=1),
        f"{pfx}.wd": ParamSpec((f, d), fsdp_dim=0),
    }


# --------------------------------------------------------------------------- #
# Tape versions (training: F / B / W)
# --------------------------------------------------------------------------- #


def layer_norm(v, scale, bias):
    """LayerNorm over the last dim in float32 (eps 1e-5, the reference's),
    cast back to v's dtype."""
    vf = v.float()
    mu = vf.mean(dim=-1, keepdim=True)
    var = ((vf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (vf - mu) * torch.rsqrt(var + 1e-5)
    return (y * scale + bias).to(v.dtype)


def apply_norm(t: Tape, cfg: ModelConfig, pfx: str, x: TVal) -> TVal:
    """RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5) in float32, cast back to
    x.dtype; the scale's (and bias's) gradient is immediate."""
    if cfg.norm == "layernorm":
        return t.prim(lambda scale, bias, v: layer_norm(v, scale, bias), x,
                      pnames=(f"{pfx}.scale", f"{pfx}.bias"))

    def rms(scale, v):
        vf = v.float()
        y = vf * torch.rsqrt((vf * vf).mean(dim=-1, keepdim=True) + 1e-6)
        return (y * scale).to(v.dtype)

    return t.prim(rms, x, pnames=(f"{pfx}.scale",))


def apply_attn(t: Tape, ctx: LayerCtx, pfx: str, x: TVal) -> TVal:
    """Self-attention: QKV and O are dense nodes; RoPE and the attention
    core (the flash kernels on the card) are one prim."""
    cfg, rc = ctx.cfg, ctx.rc
    q = t.dense(x, f"{pfx}.wq", "bsd,dhe->bshe")
    k = t.dense(x, f"{pfx}.wk", "bsd,dge->bsge")
    v = t.dense(x, f"{pfx}.wv", "bsd,dge->bsge")
    cos, sin = ctx.rope[cfg.head_dim]

    def core(qv, kv, vv):
        return ops.attention(apply_rope(qv, cos, sin),
                             apply_rope(kv, cos, sin), vv,
                             causal=ctx.causal, q_offset=0,
                             block_k=rc.attn_block_k, impl=rc.kernel_impl)

    o = t.prim(core, q, k, v)
    return t.dense(o, f"{pfx}.wo", "bshe,hed->bsd")


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_ffn(t: Tape, ctx: LayerCtx, pfx: str, x: TVal) -> TVal:
    """SwiGLU: three dense nodes around one element-wise prim; the GELU
    MLP: two dense nodes around the tanh GELU."""
    if ctx.cfg.act == "gelu_mlp":
        h = t.dense(x, f"{pfx}.wi", "bsd,df->bsf")
        h = t.elementwise(gelu, h)
        return t.dense(h, f"{pfx}.wd", "bsf,fd->bsd")
    g = t.dense(x, f"{pfx}.wg", "bsd,df->bsf")
    u = t.dense(x, f"{pfx}.wu", "bsd,df->bsf")
    h = t.prim(lambda a, b: F.silu(a) * b, g, u)
    return t.dense(h, f"{pfx}.wd", "bsf,fd->bsd")


# --------------------------------------------------------------------------- #
# Forward pieces (serving)
# --------------------------------------------------------------------------- #


def _dense(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Contract the last ``n_in`` dims of x with the first ``n_in`` of w
    (the reference's einsums, as one matrix product)."""
    lead = x.shape[:x.ndim - n_in]
    k = math.prod(w.shape[:n_in])
    y = x.reshape(-1, k) @ w.reshape(k, -1)
    return y.reshape(*lead, *w.shape[n_in:])


def check_serves(cfg) -> None:
    """The blocks compute RMSNorm or LayerNorm and the SwiGLU or GELU MLP,
    serving and training: refuse a config that asks for anything else
    rather than compute the wrong function."""
    if cfg.norm not in ("rmsnorm", "layernorm") or cfg.act not in (
            "swiglu", "gelu_mlp"):
        raise NotImplementedError(
            f"norm={cfg.norm!r}, act={cfg.act!r} of {cfg.name}: the port "
            "computes RMSNorm or LayerNorm and the SwiGLU or GELU MLP")


def norm_fwd(cfg, params, pfx, x):
    """RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5, with its bias) in
    float32, cast back to x.dtype."""
    check_serves(cfg)
    if cfg.norm == "layernorm":
        return layer_norm(x, params[f"{pfx}.scale"], params[f"{pfx}.bias"])
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (y * params[f"{pfx}.scale"]).to(x.dtype)


def ffn_fwd(ctx, params, pfx, x):
    """SwiGLU, or the GELU MLP ``gelu(x wi) wd`` (tanh approximation),
    told apart by their params (``ffn_specs`` gives the GELU MLP ``wi``
    and ``wd``, SwiGLU ``wg``, ``wu`` and ``wd``)."""
    if f"{pfx}.wi" in params:
        h = gelu(_dense(x, params[f"{pfx}.wi"]))
        return _dense(h, params[f"{pfx}.wd"])
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


# --------------------------------------------------------------------------- #
# MoE (routed top-k, capacity-based dispatch; gathered experts, serving)
# --------------------------------------------------------------------------- #


def moe_specs(cfg: ModelConfig, pfx: str):
    mo = cfg.moe
    d, fe = cfg.d_model, mo.d_ff_expert
    sp = {
        f"{pfx}.router": ParamSpec((d, mo.n_experts), fsdp_dim=0, scale=0.1),
        f"{pfx}.e_wg": ParamSpec((mo.n_experts, d, fe), fsdp_dim=2, ep=True),
        f"{pfx}.e_wu": ParamSpec((mo.n_experts, d, fe), fsdp_dim=2, ep=True),
        f"{pfx}.e_wd": ParamSpec((mo.n_experts, fe, d), fsdp_dim=1, ep=True),
    }
    if mo.n_shared:
        fs = mo.d_ff_shared or fe * mo.n_shared
        sp.update({
            f"{pfx}.s_wg": ParamSpec((d, fs), fsdp_dim=1),
            f"{pfx}.s_wu": ParamSpec((d, fs), fsdp_dim=1),
            f"{pfx}.s_wd": ParamSpec((fs, d), fsdp_dim=0),
        })
    return sp


def _capacity(n_tok: int, mo) -> int:
    c = int(n_tok * mo.top_k / mo.n_experts * mo.capacity_factor) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


def _route(logits: torch.Tensor, mo, cap: int):
    """Top-k routing of the [n, E] router logits: (weights [n, K] float32
    renormalised over the k picks, expert ids [n, K], capacity slot [n,
    K] with ``cap`` for a dropped pick). The weights are differentiable
    in the logits (the training path's ``route``). Ties go to the lower expert id,
    as ``jax.lax.top_k`` breaks them (a stable descending sort); a pick's
    slot is its rank among its expert's picks in flattened (token, k)
    order."""
    n, E = logits.shape
    K = mo.top_k
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :K], topi[:, :K]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    flat_oh = F.one_hot(topi.reshape(n * K), E)          # [n*K, E] int64
    rank = torch.cumsum(flat_oh, dim=0) - flat_oh
    slot = (rank * flat_oh).sum(-1).reshape(n, K)
    slot = torch.where(slot < cap, slot, cap)
    if _PINNED:
        box = _PINNED[-1]
        if box["replay"]:
            if box["next"] >= len(box["picks"]):
                raise ValueError("pinned_routing: more routing calls than "
                                 "the recorded run made")
            topi, slot = box["picks"][box["next"]]
            if topi.shape != (n, K):
                raise ValueError(f"pinned_routing: call {box['next']} routes "
                                 f"[{n}, {K}], the recorded run "
                                 f"{list(topi.shape)}")
            box["next"] += 1
            topw = probs.gather(1, topi)
            topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
        else:
            box["picks"].append((topi, slot))
    return topw, topi, slot


_PINNED: list[dict] = []


@contextlib.contextmanager
def pinned_routing(picks: list | None = None):
    """Pin every routing call's discrete decisions while open, to hold two
    runs of a MoE model to each other where its routers sit at near ties
    (random weights: one bf16 rounding flips a token's top-k set, and the
    flips compound over the layers). With ``picks`` None it records each
    call's expert ids and capacity slots, in call order, into the yielded
    list; given that list from a run on the same shapes, it replays them
    call by call, with the weights renormalised from this run's router
    probabilities at the pinned ids (so they stay differentiable)."""
    box = {"picks": [] if picks is None else picks,
           "replay": picks is not None, "next": 0}
    _PINNED.append(box)
    try:
        yield box["picks"]
    finally:
        _PINNED.remove(box)


_DROP_COUNTS: list[dict] = []


@contextlib.contextmanager
def counting_drops():
    """Count the training path's routed picks while open: yields a dict
    whose ``dropped`` and ``picks`` hold, on exit, the picks that forward
    (``fwd``-mode tape) routing calls made and the ones of them that fell
    past their expert's capacity. B's recompute routes the same tokens
    again and is not counted. The sums stay on the device until exit."""
    box = {"dropped": 0, "picks": 0}
    _DROP_COUNTS.append(box)
    try:
        yield box
    finally:
        _DROP_COUNTS.remove(box)
        box["dropped"], box["picks"] = int(box["dropped"]), int(box["picks"])


def apply_moe(t: Tape, ctx: LayerCtx, pfx: str, x: TVal) -> tuple[TVal, TVal]:
    """The gathered top-k MoE FFN on the tape (the reference's
    ``apply_moe`` without expert parallelism or stats).
    Returns (y, aux): aux is the Switch load-balance term, E times the sum
    over experts of (share of first picks) x (mean probability).

    The router is a dense node; routing is a two-output prim (weights,
    aux) whose expert ids and capacity slots leave the tape as closure
    captures (integers, no gradient), as in the reference. Dispatch
    scatters every pick into [E, cap + 1, d] (the last slot takes the
    dropped picks and is cut off), the three expert banks are dense nodes
    (dW deferred to W), and combine gathers each pick's output through the
    drop slot (zeros for a dropped pick), weighted by its routing
    weight. With shared experts (``n_shared``) every token also runs the
    shared SwiGLU FFN: its three banks are dense nodes, and its output is
    added to the routed one."""
    mo = ctx.cfg.moe
    b, s, d = x.shape
    n = b * s
    cap = _capacity(n, mo)
    E, K = mo.n_experts, mo.top_k
    logits = t.dense(x, f"{pfx}.router", "bsd,de->bse")
    holder = {}

    def route(lg):
        lgf = lg.reshape(n, E)
        topw, topi, slot = _route(lgf, mo, cap)
        holder["topi"], holder["slot"] = topi, slot
        if t.mode == "fwd":
            for box in _DROP_COUNTS:
                box["dropped"] = box["dropped"] + (slot == cap).sum()
                box["picks"] += slot.numel()
        frac_tok = F.one_hot(topi[:, 0], E).float().mean(dim=0)
        frac_prob = torch.softmax(lgf.float(), dim=-1).mean(dim=0)
        aux = (frac_tok * frac_prob).sum() * E
        return topw, aux

    topw, aux = t.prim(route, logits, n_out=2)

    def dispatch(xv):
        buf = torch.zeros((E, cap + 1, d), dtype=xv.dtype, device=xv.device)
        xk = xv.reshape(n, d).repeat_interleave(K, dim=0)
        buf = buf.index_put((holder["topi"].reshape(-1),
                             holder["slot"].reshape(-1)), xk,
                            accumulate=True)
        return buf[:, :cap]

    xe = t.prim(dispatch, x)                                # [E, cap, d]
    g = t.dense(xe, f"{pfx}.e_wg", "ecd,edf->ecf")
    u = t.dense(xe, f"{pfx}.e_wu", "ecd,edf->ecf")
    hh = t.prim(lambda a, b2: F.silu(a) * b2, g, u)
    ye = t.dense(hh, f"{pfx}.e_wd", "ecf,efd->ecd")

    def combine(yv, wv):
        ypad = F.pad(yv, (0, 0, 0, 1))       # the drop slot reads zeros
        gathered = ypad[holder["topi"], holder["slot"]]     # [n, K, d]
        out = (gathered * wv[..., None].to(yv.dtype)).sum(dim=1)
        return out.reshape(b, s, d)

    y = t.prim(combine, ye, topw)
    if mo.n_shared:
        g2 = t.dense(x, f"{pfx}.s_wg", "bsd,df->bsf")
        u2 = t.dense(x, f"{pfx}.s_wu", "bsd,df->bsf")
        h2 = t.prim(lambda a, b2: F.silu(a) * b2, g2, u2)
        y = t.add(y, t.dense(h2, f"{pfx}.s_wd", "bsf,fd->bsd"))
    return y, aux


def moe_fwd(ctx, params, pfx, x):
    """Gathered top-k MoE for serving (the reference's ``moe_fwd``: its
    tape forward of ``apply_moe`` without expert parallelism or stats).

    Every row of the batch is routed, masked serving rows included:
    capacity ranks count every token in flattened (row, position, k)
    order, so masked rows compete for capacity as in the reference.
    Dispatch scatters each kept pick into its expert's [cap, d] buffer
    (dropped picks land in an extra slot that is cut off), the experts run
    as batched SwiGLU products, and combine gathers each pick's output
    (zeros for a dropped one) weighted by its routing weight.
    """
    mo = ctx.cfg.moe
    b, s, d = x.shape
    n = b * s
    E, K = mo.n_experts, mo.top_k
    cap = _capacity(n, mo)
    logits = _dense(x, params[f"{pfx}.router"]).reshape(n, E)
    topw, topi, slot = _route(logits, mo, cap)
    ti, sl = topi.reshape(-1), slot.reshape(-1)
    buf = torch.zeros((E, cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((ti, sl), x.reshape(n, d).repeat_interleave(K, dim=0),
                   accumulate=True)
    xe = buf[:, :cap]                                     # [E, cap, d]
    g = torch.bmm(xe, params[f"{pfx}.e_wg"])
    u = torch.bmm(xe, params[f"{pfx}.e_wu"])
    ye = torch.bmm(F.silu(g) * u, params[f"{pfx}.e_wd"])  # [E, cap, d]
    ypad = F.pad(ye, (0, 0, 0, 1))           # the drop slot reads zeros
    out = (ypad[topi, slot] * topw[..., None].to(ye.dtype)).sum(dim=1)
    y = out.reshape(b, s, d)
    if mo.n_shared:
        g2 = _dense(x, params[f"{pfx}.s_wg"])
        u2 = _dense(x, params[f"{pfx}.s_wu"])
        y = y + _dense(F.silu(g2) * u2, params[f"{pfx}.s_wd"])
    return y


# --------------------------------------------------------------------------- #
# Mamba (selective SSM; serving)
# --------------------------------------------------------------------------- #


def _mamba_dims(cfg):
    mc = cfg.mamba
    di = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or max(1, cfg.d_model // 16)
    return mc, di, dt_rank


def mamba_specs(cfg: ModelConfig, pfx: str):
    mc, di, dt_rank = _mamba_dims(cfg)
    d, n = cfg.d_model, mc.d_state
    return {
        f"{pfx}.w_in": ParamSpec((d, 2 * di), fsdp_dim=1),
        f"{pfx}.conv_w": ParamSpec((mc.d_conv, di), "small", fsdp_dim=1,
                                   scale=0.5),
        f"{pfx}.conv_b": ParamSpec((di,), "zeros"),
        f"{pfx}.w_x": ParamSpec((di, dt_rank + 2 * n), fsdp_dim=0),
        f"{pfx}.w_dt": ParamSpec((dt_rank, di), fsdp_dim=1),
        f"{pfx}.dt_bias": ParamSpec((di,), "zeros"),
        f"{pfx}.A_log": ParamSpec((di, n), "ones"),
        f"{pfx}.Dd": ParamSpec((di,), "ones"),
        f"{pfx}.w_out": ParamSpec((di, d), fsdp_dim=0),
    }


def apply_mamba(t: Tape, ctx: LayerCtx, pfx: str, x: TVal) -> TVal:
    """The Mamba mixer on the tape (the reference's ``apply_mamba``):
    in_proj, out_proj and the x projection are dense nodes; the causal
    depthwise conv with SiLU (and the split off of the gate z) is a
    two-output prim with the conv's params; the SSM is a prim with the
    dt projection, dt bias, A_log and D, which runs the differentiable
    scan (``ops.selective_scan_train``: K5 / K5b on the card). The dtype
    steps are the reference's: softplus in the compute dtype, then float32
    for the scan and for ``y * silu(z)``, cast back."""
    mc, di, dt_rank = _mamba_dims(ctx.cfg)
    n = mc.d_state
    xz = t.dense(x, f"{pfx}.w_in", "bsd,de->bse")           # e = 2 di

    def conv_split(cw, cb, v):
        xs, z = v[..., :di], v[..., di:]
        pad = F.pad(xs, (0, 0, mc.d_conv - 1, 0))
        out = sum(pad[:, i:i + xs.shape[1]] * cw[i]
                  for i in range(mc.d_conv)) + cb
        return F.silu(out), z

    xs, z = t.prim(conv_split, xz,
                   pnames=(f"{pfx}.conv_w", f"{pfx}.conv_b"), n_out=2)
    bcdt = t.dense(xs, f"{pfx}.w_x", "bse,er->bsr")   # r = dt_rank + 2 n

    def ssm(w_dt, dt_bias, a_log, dd, xs_v, bcdt_v, z_v):
        dt_in = bcdt_v[..., :dt_rank]
        Bm = bcdt_v[..., dt_rank:dt_rank + n].float()
        Cm = bcdt_v[..., dt_rank + n:].float()
        dt = F.softplus(torch.einsum("bsr,re->bse", dt_in, w_dt)
                        + dt_bias).float()
        A = -torch.exp(a_log.float())
        y = ops.selective_scan_train(xs_v.float(), dt, A, Bm, Cm, dd.float(),
                                     impl=ctx.rc.kernel_impl)
        return (y * F.silu(z_v.float())).to(xs_v.dtype)

    y = t.prim(ssm, xs, bcdt, z, pnames=(f"{pfx}.w_dt", f"{pfx}.dt_bias",
                                         f"{pfx}.A_log", f"{pfx}.Dd"))
    return t.dense(y, f"{pfx}.w_out", "bse,ed->bsd")


def _ssm_inputs(params, pfx, xs_c, dt_rank, n):
    """dt (softplus, float32), B, C (float32, contiguous) and A = -exp(A_log)
    from the post-conv activations [..., di]."""
    bcdt = _dense(xs_c, params[f"{pfx}.w_x"])
    dt = F.softplus(_dense(bcdt[..., :dt_rank], params[f"{pfx}.w_dt"])
                    + params[f"{pfx}.dt_bias"]).float()
    Bm = bcdt[..., dt_rank:dt_rank + n].float().contiguous()
    Cm = bcdt[..., dt_rank + n:].float().contiguous()
    A = -torch.exp(params[f"{pfx}.A_log"].float())
    return dt, Bm, Cm, A


def mamba_cached(ctx, params, pfx, x, cache, pos):
    """Prefill (s > 1) runs the selective scan (the K5 kernel on the card)
    with the state out; decode (s == 1) steps the SSM. As in the
    reference, prefill ignores the incoming cache: the conv is zero-padded,
    the scan starts from h = 0, and the new conv state is the last
    ``d_conv - 1`` pre-conv activations. Returns (y, new state); the
    caller stores the state (``_slot_state``)."""
    cfg = ctx.cfg
    mc, di, dt_rank = _mamba_dims(cfg)
    b, s, d = x.shape
    if s == 1:
        return mamba_decode(ctx, params, pfx, x, cache, pos)
    if s < mc.d_conv - 1:
        raise ValueError(
            f"a Mamba prefill of {s} tokens cannot fill the conv state of "
            f"d_conv - 1 = {mc.d_conv - 1} positions (the reference "
            "mis-shapes the cache here); prefill at least "
            f"{mc.d_conv - 1} tokens, or one")
    xz = _dense(x, params[f"{pfx}.w_in"])
    xs, z = xz[..., :di], xz[..., di:]
    pad = F.pad(xs, (0, 0, mc.d_conv - 1, 0))
    cw = params[f"{pfx}.conv_w"]
    out = sum(pad[:, i:i + s] * cw[i] for i in range(mc.d_conv)) \
        + params[f"{pfx}.conv_b"]
    xs_c = F.silu(out)
    dt, Bm, Cm, A = _ssm_inputs(params, pfx, xs_c, dt_rank, mc.d_state)
    y, h = ops.selective_scan(
        xs_c.float(), dt, A, Bm, Cm, params[f"{pfx}.Dd"].float(),
        return_state=True, impl=ctx.rc.kernel_impl)
    y = (y * F.silu(z.float())).to(x.dtype)
    y = _dense(y, params[f"{pfx}.w_out"])
    conv_state = xs[:, -(mc.d_conv - 1):]
    return y, {"conv": conv_state.to(cache["conv"].dtype), "h": h}


def mamba_decode(ctx, params, pfx, x, cache, pos):
    """One SSM step. cache: {"conv": [b, d_conv-1, di], "h": [b, di, n]};
    x [b, 1, d]."""
    cfg = ctx.cfg
    mc, di, dt_rank = _mamba_dims(cfg)
    xz = _dense(x, params[f"{pfx}.w_in"])[:, 0]
    xs, z = xz[..., :di], xz[..., di:]
    conv_in = torch.cat([cache["conv"], xs[:, None]], dim=1)
    cw = params[f"{pfx}.conv_w"]
    out = sum(conv_in[:, i] * cw[i] for i in range(mc.d_conv))
    xs_c = F.silu(out + params[f"{pfx}.conv_b"])
    dt, Bm, Cm, A = _ssm_inputs(params, pfx, xs_c, dt_rank, mc.d_state)
    h_new, y = ops.selective_scan_step(
        cache["h"], xs_c.float(), dt, A, Bm, Cm,
        params[f"{pfx}.Dd"].float())
    y = (y * F.silu(z.float())).to(x.dtype)
    y = _dense(y, params[f"{pfx}.w_out"])[:, None]
    return y, {"conv": conv_in[:, 1:], "h": h_new}


def _slot_state(ctx, cache, new):
    """Store a recurrent layer's new state in its cache leaves, in place,
    on the writing rows only (``LayerCtx.write_rows``): masked-off rows
    keep their previous state, as the reference's per-row select does.
    Returns the cache."""
    for name, v in new.items():
        old = cache[name]
        rows = _write_rows(ctx, old.shape[0], old.device)
        old[rows] = v[rows].to(old.dtype)
    return cache


# --------------------------------------------------------------------------- #
# xLSTM blocks (mLSTM and sLSTM mixers; training and serving)
# --------------------------------------------------------------------------- #


def _mlstm_dims(cfg):
    """(di, heads, e) of the mLSTM: the up-projection di = proj_factor d
    split over the heads."""
    di = int(cfg.xlstm.proj_factor * cfg.d_model)
    return di, cfg.n_heads, di // cfg.n_heads


def mlstm_specs(cfg: ModelConfig, pfx: str):
    d = cfg.d_model
    di, h, e = _mlstm_dims(cfg)
    return {
        f"{pfx}.w_up": ParamSpec((d, 2 * di), fsdp_dim=1),
        f"{pfx}.wq": ParamSpec((di, h, e), fsdp_dim=0),
        f"{pfx}.wk": ParamSpec((di, h, e), fsdp_dim=0),
        f"{pfx}.wv": ParamSpec((di, h, e), fsdp_dim=0),
        f"{pfx}.w_if": ParamSpec((di, 2, h), fsdp_dim=0, scale=0.1),
        f"{pfx}.if_bias": ParamSpec((2, h), "zeros"),
        f"{pfx}.w_out": ParamSpec((di, d), fsdp_dim=0),
    }


def _mlstm_gates(w_if, if_bias, xb):
    """(log input gate, forget logits) [..., h] from the up-projected
    activations, in float32; the block adds 1.0 to the forget logits."""
    gates = _dense(xb.float(), w_if.float()) + if_bias
    return gates[..., 0, :], gates[..., 1, :] + 1.0


def apply_mlstm(t: Tape, ctx: LayerCtx, pfx: str, x: TVal) -> TVal:
    """The mLSTM mixer on the tape (the reference's ``apply_mlstm``): the
    up-projection, q / k / v and the out-projection are dense nodes; the
    split into the cell's input and the gate z is a prim; the core (the
    input and forget gates from ``w_if`` and ``if_bias``, the chunkwise
    scan in plain PyTorch, ``y * silu(z)`` in the compute dtype) is a
    prim with those two params."""
    di, _, _ = _mlstm_dims(ctx.cfg)
    up = t.dense(x, f"{pfx}.w_up", "bsd,de->bse")
    xb, z = t.prim(lambda v: (v[..., :di], v[..., di:]), up, n_out=2)
    q = t.dense(xb, f"{pfx}.wq", "bse,ehf->bshf")
    k = t.dense(xb, f"{pfx}.wk", "bse,ehf->bshf")
    v = t.dense(xb, f"{pfx}.wv", "bse,ehf->bshf")

    def core(w_if, if_bias, xbv, qv, kv, vv, zv):
        ig, fg = _mlstm_gates(w_if, if_bias, xbv)
        y = ops.mlstm_chunkwise(qv, kv, vv, ig, fg)
        return y.reshape(y.shape[0], y.shape[1], -1) * F.silu(zv)

    y = t.prim(core, xb, q, k, v, z,
               pnames=(f"{pfx}.w_if", f"{pfx}.if_bias"))
    return t.dense(y, f"{pfx}.w_out", "bse,ed->bsd")


def _mlstm_proj(params, pfx, x, di):
    """(xb, z, q, k, v, i gate, f logits) of the serve path's mLSTM."""
    up = _dense(x, params[f"{pfx}.w_up"])
    xb, z = up[..., :di], up[..., di:]
    q, k, v = (_dense(xb, params[f"{pfx}.{w}"]) for w in ("wq", "wk", "wv"))
    ig, fg = _mlstm_gates(params[f"{pfx}.w_if"], params[f"{pfx}.if_bias"],
                          xb)
    return z, q, k, v, ig, fg


def mlstm_cached(ctx, params, pfx, x, cache, pos):
    """Prefill (s > 1) runs the chunkwise scan with the state out; decode
    (s == 1) steps the cell (``mlstm_decode``). As in the reference,
    prefill ignores the incoming state and starts from zero, and takes
    ``silu(z)`` in float32, cast to the compute dtype (the tape form takes
    it in the compute dtype). Returns (y, new state {C, n, m}); the
    caller stores the state (``_slot_state``)."""
    if x.shape[1] == 1:
        return mlstm_decode(ctx, params, pfx, x, cache, pos)
    b, s, _ = x.shape
    di, _, _ = _mlstm_dims(ctx.cfg)
    z, q, k, v, ig, fg = _mlstm_proj(params, pfx, x, di)
    y, state = ops.mlstm_chunkwise(q, k, v, ig, fg, return_state=True)
    y = y.reshape(b, s, -1)
    y = y * F.silu(z.float()).to(y.dtype)
    y = _dense(y.to(x.dtype), params[f"{pfx}.w_out"])
    return y, dict(zip("Cnm", state))


def mlstm_decode(ctx, params, pfx, x, cache, pos):
    """One mLSTM step from the cached state. cache: {"C": [b, h, e, e],
    "n": [b, h, e], "m": [b, h]} float32; x [b, 1, d]."""
    di, _, _ = _mlstm_dims(ctx.cfg)
    z, q, k, v, ig, fg = _mlstm_proj(params, pfx, x[:, 0], di)
    state, y = ops.mlstm_step((cache["C"], cache["n"], cache["m"]), q, k, v,
                              ig, fg)
    y = (y.reshape(y.shape[0], -1) * F.silu(z)).to(x.dtype)
    return _dense(y, params[f"{pfx}.w_out"])[:, None], dict(zip("Cnm",
                                                                state))


def slstm_specs(cfg: ModelConfig, pfx: str):
    d, h = cfg.d_model, cfg.n_heads
    e = d // h
    return {
        f"{pfx}.w_gates": ParamSpec((d, h, 4, e), fsdp_dim=0),
        f"{pfx}.g_bias": ParamSpec((h, 4, e), "zeros"),
        f"{pfx}.w_out": ParamSpec((d, d), fsdp_dim=0),
    }


def apply_slstm(t: Tape, ctx: LayerCtx, pfx: str, x: TVal) -> TVal:
    """The sLSTM mixer on the tape (the reference's ``apply_slstm``): the
    gate projection and the out-projection are dense nodes; the core (the
    gate bias, then the recurrence through ``ops.slstm_scan_train``: K6
    forward, K6b backward on the card) is a prim with ``g_bias``."""
    g = t.dense(x, f"{pfx}.w_gates", "bsd,dhge->bshge")

    def core(g_bias, gv):
        return ops.slstm_scan_train(gv + g_bias, impl=ctx.rc.kernel_impl)

    y = t.prim(core, g, pnames=(f"{pfx}.g_bias",))
    y = t.prim(lambda v: v.reshape(v.shape[0], v.shape[1], -1), y)
    return t.dense(y, f"{pfx}.w_out", "bsd,de->bse")


def slstm_cached(ctx, params, pfx, x, cache, pos):
    """Prefill (s > 1) or one decode step (s == 1) of the sLSTM through
    ``ops.slstm_scan`` (K6 on the card) with the state in and out. Unlike
    the mLSTM's, the prefill starts from the cached state, as the
    reference's does (the engine zeroes a slot's rows on admission).
    Returns (y, new state {c, n, m})."""
    b, s, _ = x.shape
    g = _dense(x, params[f"{pfx}.w_gates"]) + params[f"{pfx}.g_bias"]
    y, state = ops.slstm_scan(g, state=(cache["c"], cache["n"], cache["m"]),
                              return_state=True, impl=ctx.rc.kernel_impl)
    y = _dense(y.reshape(b, s, -1).to(x.dtype), params[f"{pfx}.w_out"])
    return y, dict(zip("cnm", state))


def slstm_decode(ctx, params, pfx, x, cache, pos):
    """One sLSTM step (``slstm_cached`` at s == 1, the reference's
    ``slstm_decode``)."""
    return slstm_cached(ctx, params, pfx, x, cache, pos)
