"""Architecture assembly: geometry, stage params, tape stages (training),
cached stages (serving) and the single-device reference forward.

The port's counterpart of ``repro/models/model.py``.
Geometry and parameter stacking follow the reference exactly: stage
``s = v·pp + p`` holds ``k`` consecutive layers, and the stacked params
and caches store it at index ``storage_index(p, v, V) = p·V + v``, so a
reference parameter tree carries over name for name.

The port has blocks for decoder layers with an attention or a Mamba
mixer and a SwiGLU, GELU-MLP or gathered-MoE FFN (``attn:dense``,
``attn:moe``, ``mamba:dense``, ``mamba:moe``), for xLSTM's FFN-free
layers (``mlstm:none``, ``slstm:none``: the mixer alone, no ``ln2`` and
no FFN, as the reference's ``"<mix>:none"``), RMSNorm or LayerNorm, and
a tied or untied head. Serving and training run all six kinds with
either norm, either dense MLP and either head; a MoE layer's router adds
its load-balance term to the stage's auxiliary loss, and its shared
experts (``n_shared``) add a SwiGLU FFN that every token runs. A vision
config (``frontend="vision"``) takes float patch embeddings [b, s, d] in
place of token ids, as the reference's stub does. Any other layer kind
or variant raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tape import Tape, TVal
from repro_torch.models import blocks
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    RunConfig,
    rope_tables,
    torch_dtype,
)

_NOT_PORTED = ("{what} of {name} has no block in repro_torch yet; the "
               "encoder-decoder with the audio stub, and MLA with the MTP "
               "head arrive in later slices (ROADMAP.md queue 1 items "
               "6d-6e)")
_SERVE_KINDS = ("attn:dense", "attn:moe", "mamba:dense", "mamba:moe",
                "mlstm:none", "slstm:none")
# each mixer's specs, tape form and cached form (prefill / decode)
_MIXERS = {
    "attn": (blocks.attn_specs, blocks.apply_attn, blocks.attn_cached),
    "mamba": (blocks.mamba_specs, blocks.apply_mamba, blocks.mamba_cached),
    "mlstm": (blocks.mlstm_specs, blocks.apply_mlstm, blocks.mlstm_cached),
    "slstm": (blocks.slstm_specs, blocks.apply_slstm, blocks.slstm_cached),
}

# --------------------------------------------------------------------------- #
# Geometry
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str                # "main" | "enc" | "dec"
    n_layers: int            # real (unpadded) layers
    vpp: int                 # V
    k: int                   # layers per stage
    kinds: tuple[str, ...]   # static kind per layer slot j (len k)
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class Geometry:
    pp: int                  # ranks per pipeline group
    groups: int              # pipeline groups on the model axis
    segments: tuple[Segment, ...]

    @property
    def model_ranks(self):
        return self.pp * self.groups

    def seg_stages(self, seg: Segment) -> int:
        return self.pp * seg.vpp

    def padded_layers(self, seg: Segment) -> int:
        return self.pp * seg.vpp * seg.k


def _check_supported(cfg: ModelConfig) -> None:
    missing = [what for what, bad in (
        ("the encoder-decoder", cfg.encdec is not None),
        ("the MTP head", cfg.mtp),
        (f"the {cfg.frontend} frontend",
         cfg.frontend not in (None, "vision"))) if bad]
    if missing:
        raise NotImplementedError(_NOT_PORTED.format(
            what=", ".join(missing), name=cfg.name))
    # the blocks and the final norm compute two norms and two MLPs, in
    # both modes, whatever else a config names
    blocks.check_serves(cfg)


def build_geometry(cfg: ModelConfig, rc: RunConfig) -> Geometry:
    """Derive (and validate) the static stage layout."""
    _check_supported(cfg)
    L = cfg.n_layers
    pv = rc.pp * rc.vpp
    k = -(-L // pv)
    kinds = tuple(cfg.layer_kind(j) for j in range(k))
    for i in range(L):
        if cfg.layer_kind(i) != kinds[i % k]:
            raise ValueError(
                f"{cfg.name}: layer kinds are not static per slot with "
                f"pp={rc.pp} vpp={rc.vpp} (k={k}); adjust geometry")
    return Geometry(rc.pp, rc.groups, (Segment("main", L, rc.vpp, k, kinds),))


def storage_index(p: int, v: int, V: int) -> int:
    """Rank-major stacked index for logical stage s = v·pp + p."""
    return p * V + v


# --------------------------------------------------------------------------- #
# Param specs
# --------------------------------------------------------------------------- #


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in _SERVE_KINDS:
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"layer kind {kind!r}", name=cfg.name))


def layer_slot_specs(cfg: ModelConfig, kind: str, pfx: str):
    """Specs for one layer slot of the given static kind."""
    _check_kind(cfg, kind)
    mix, ffn = kind.split(":")
    sp: dict[str, ParamSpec] = {}
    sp.update(blocks.norm_specs(cfg, f"{pfx}.ln1"))
    sp.update(_MIXERS[mix][0](cfg, f"{pfx}.mix"))
    if ffn != "none":
        sp.update(blocks.norm_specs(cfg, f"{pfx}.ln2"))
        if ffn == "moe":
            sp.update(blocks.moe_specs(cfg, f"{pfx}.ffn"))
        else:
            sp.update(blocks.ffn_specs(cfg, f"{pfx}.ffn"))
    return sp


def stage_specs(cfg: ModelConfig, seg: Segment) -> dict[str, ParamSpec]:
    sp = {}
    for j, kind in enumerate(seg.kinds):
        sp.update(layer_slot_specs(cfg, kind, f"L{j}"))
    return sp


def io_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """Embedding, final norm (with its bias for LayerNorm) and, when
    untied, the head ``head.w`` [d, vocab], outside the pipeline."""
    _check_supported(cfg)
    sp = {
        "embed.table": ParamSpec((cfg.vocab, cfg.d_model), fsdp_dim=0,
                                 scale=1.0),
        "final_norm.scale": ParamSpec((cfg.d_model,), "ones"),
    }
    if cfg.norm == "layernorm":
        sp["final_norm.bias"] = ParamSpec((cfg.d_model,), "zeros")
    if not cfg.tie_embeddings:
        sp["head.w"] = ParamSpec((cfg.d_model, cfg.vocab), fsdp_dim=1)
    return sp


# --------------------------------------------------------------------------- #
# Stage application (tape — the train path)
# --------------------------------------------------------------------------- #


def rope_for(cfg: ModelConfig, seq: int, device=None):
    """{head_dim: (cos, sin) [seq, head_dim/2]} for a training sequence."""
    return {cfg.head_dim: rope_tables(seq, cfg.head_dim, cfg.rope_theta,
                                      device)}


def apply_layer(t: Tape, ctx: blocks.LayerCtx, kind: str, pfx: str, x: TVal,
                keep: float) -> tuple[TVal, TVal | None]:
    """Pre-norm residual layer; ``keep`` (0.0 for padding layers) scales
    each residual branch, as the reference's ``u + v * keep``. An
    FFN-free kind (``<mix>:none``) is the mixer's branch alone. Returns
    (y, the MoE router's auxiliary loss, or None for a dense FFN or
    none)."""
    _check_kind(ctx.cfg, kind)
    mix, ffn = kind.split(":")

    def res_add(a, b):
        return t.prim(lambda u, v: u + v * keep, a, b)

    h = blocks.apply_norm(t, ctx.cfg, f"{pfx}.ln1", x)
    h = _MIXERS[mix][1](t, ctx, f"{pfx}.mix", h)
    x = res_add(x, h)
    aux = None
    if ffn == "none":
        return x, aux
    h2 = blocks.apply_norm(t, ctx.cfg, f"{pfx}.ln2", x)
    if ffn == "moe":
        h2, aux = blocks.apply_moe(t, ctx, f"{pfx}.ffn", h2)
    else:
        h2 = blocks.apply_ffn(t, ctx, f"{pfx}.ffn", h2)
    return res_add(x, h2), aux


def apply_stage(t: Tape, ctx: blocks.LayerCtx, seg: Segment, x: TVal,
                stage_id: int) -> tuple[TVal, TVal]:
    """Apply the k layers of one stage. Returns (y, aux scalar): the sum
    of the MoE layers' auxiliary losses, each scaled by its layer's keep,
    chained on the tape (a value with no record for dense stages)."""
    aux_total = t.value(torch.zeros((), dtype=torch.float32,
                                    device=x.val.device))
    for j, kind in enumerate(seg.kinds):
        keep = float(stage_id * seg.k + j < seg.n_layers)
        x, aux = apply_layer(t, ctx, kind, f"L{j}", x, keep)
        if aux is not None:
            aux_total = t.prim(
                lambda a, b, keep=keep: a + b.float() * keep, aux_total, aux)
    return x, aux_total


def reference_logits(cfg, rc, params, tokens):
    """Full forward on one device, looping stages in logical order; the
    plain oracle of the pipeline. ``tokens`` are ids [b, s] or, for a
    vision config, float embeddings [b, s, d]. Returns (logits [b, s,
    vocab] in the compute dtype, aux)."""
    geo = build_geometry(cfg, rc)
    dtype = torch_dtype(rc.compute_dtype)
    io = params["io"]
    seg = geo.segments[0]
    x = embed_tokens(io, tokens, cfg, dtype)
    ctx = blocks.LayerCtx(cfg=cfg, rc=rc,
                          rope=rope_for(cfg, x.shape[1], x.device),
                          causal=seg.causal)
    stacked = params["segments"][seg.name]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(geo.seg_stages(seg)):
        idx = storage_index(s % geo.pp, s // geo.pp, seg.vpp)
        t = Tape({n: a[idx] for n, a in stacked.items()}, mode="fwd")
        xv, aux = apply_stage(t, ctx, seg, t.value(x), s)
        x, aux_total = xv.val, aux_total + aux.val
    xf = x.float()
    if cfg.norm == "layernorm":
        hn = blocks.layer_norm(xf, io["final_norm.scale"],
                               io["final_norm.bias"])
    else:
        hn = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6) \
            * io["final_norm.scale"]
    w = io["embed.table"].t() if cfg.tie_embeddings else io["head.w"]
    return hn.to(dtype) @ w, aux_total


def reference_loss(cfg, rc, params, tokens, labels):
    """Mean token cross-entropy of :func:`reference_logits` (float32),
    plus ``router_aux_weight`` times the auxiliary loss for a MoE
    model."""
    logits, aux = reference_logits(cfg, rc, params, tokens)
    lf = logits.reshape(-1, logits.shape[-1]).float()
    lse = torch.logsumexp(lf, dim=-1)
    lab = lf.gather(1, labels.reshape(-1, 1).long())[:, 0]
    loss = (lse - lab).mean()
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss


# --------------------------------------------------------------------------- #
# Cached stage execution (prefill / decode serving)
# --------------------------------------------------------------------------- #


def layer_cache_spec(cfg, rc, kind, batch, max_seq) -> dict[str, tuple]:
    """(shape, dtype) of each leaf of one layer's serve cache. The KV
    storage dtype is decoupled from compute: fp32/bf16, or int8 for
    quantised pages (their scales are added by ``init_serve_caches``).
    A Mamba layer keeps its conv state [batch, d_conv-1, di] in the
    compute dtype and its SSM state [batch, di, d_state] in float32; an
    mLSTM layer its matrix memory C [batch, h, e, e], normaliser n [batch,
    h, e] and stabiliser m [batch, h], an sLSTM layer c, n and m [batch,
    h, d / h], all float32."""
    _check_kind(cfg, kind)
    f32 = torch.float32
    mix = kind.split(":")[0]
    if mix == "mamba":
        mc, di, _ = blocks._mamba_dims(cfg)
        return {"conv": ((batch, mc.d_conv - 1, di),
                         torch_dtype(rc.compute_dtype)),
                "h": ((batch, di, mc.d_state), f32)}
    if mix == "mlstm":
        _, h, e = blocks._mlstm_dims(cfg)
        return {"C": ((batch, h, e, e), f32), "n": ((batch, h, e), f32),
                "m": ((batch, h), f32)}
    if mix == "slstm":
        h = cfg.n_heads
        return {n: ((batch, h, cfg.d_model // h), f32) for n in "cnm"}
    kv_dt = torch_dtype(rc.kv_cache_dtype or rc.compute_dtype)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, kv_dt), "v": (shape, kv_dt)}


def embed_tokens(params, tokens, cfg, dtype):
    """tokens int [b, s] -> [b, s, d], or float embeddings [b, s, d] (the
    vision stub's patches) cast to ``dtype``. Ids are clamped into the
    table, as a JAX gather clamps out-of-range indices."""
    if tokens.is_floating_point():
        return tokens.to(dtype)
    ids = tokens.long().clamp(0, params["embed.table"].shape[0] - 1)
    return params["embed.table"][ids].to(dtype)


def cached_layer(ctx, params, kind, pfx, x, cache, pos):
    """Unified prefill (s>1) / decode (s=1) for one pre-norm layer."""
    _check_kind(ctx.cfg, kind)
    cfg = ctx.cfg
    blocks.check_serves(cfg)
    mix, ffn = kind.split(":")
    h = blocks.norm_fwd(cfg, params, f"{pfx}.ln1", x)
    dh, c2 = _MIXERS[mix][2](ctx, params, f"{pfx}.mix", h, cache, pos)
    # attention writes its K/V in place; a recurrent layer's new state is
    # stored on the writing rows
    cache = c2 if mix == "attn" else blocks._slot_state(ctx, cache, c2)
    x = x + dh
    if ffn == "none":
        return x, cache
    h2 = blocks.norm_fwd(cfg, params, f"{pfx}.ln2", x)
    if ffn == "moe":
        x = x + blocks.moe_fwd(ctx, params, f"{pfx}.ffn", h2)
    else:
        x = x + blocks.ffn_fwd(ctx, params, f"{pfx}.ffn", h2)
    return x, cache


def cached_stage(ctx, seg, params, x, caches, stage_id, pos):
    """caches: list (per layer slot j) of cache dicts. Padding layers past
    ``seg.n_layers`` are applied with weight 0, as in the reference
    (``x + (y - x) * keep``, kept literally so the rounding matches)."""
    new_caches = []
    for j, kind in enumerate(seg.kinds):
        keep = float(stage_id * seg.k + j < seg.n_layers)
        y, cj = cached_layer(ctx, params, kind, f"L{j}", x, caches[j], pos)
        x = x + (y - x) * keep
        new_caches.append(cj)
    return x, new_caches

