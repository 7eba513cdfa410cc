"""Architecture assembly: geometry, stage params, tape stages (training),
cached stages (serving) and the single-device reference forward.

The port's counterpart of ``repro/models/model.py``.
Geometry and parameter stacking follow the reference exactly: stage
``s = v·pp + p`` holds ``k`` consecutive layers, and the stacked params
and caches store it at index ``storage_index(p, v, V) = p·V + v``, so a
reference parameter tree carries over name for name.

The port has blocks for decoder layers with an attention or a Mamba
mixer and a SwiGLU, GELU-MLP or gathered-MoE FFN (``attn:dense``,
``attn:moe``, ``mamba:dense``, ``mamba:moe``), RMSNorm or LayerNorm, and
a tied or untied head. Serving runs all four kinds with RMSNorm and
SwiGLU; training runs ``attn:dense`` with either norm and dense MLP and
either head. Any other layer kind or variant raises
``NotImplementedError``.
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

_NOT_PORTED = ("{what} of {name} has no block in repro_torch yet; MLA, "
               "xLSTM, enc-dec and the other variants arrive in later "
               "slices (ROADMAP.md queue 1)")
_SERVE_KINDS = ("attn:dense", "attn:moe", "mamba:dense", "mamba:moe")

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
        (f"the {cfg.frontend} frontend", cfg.frontend is not None)) if bad]
    if missing:
        raise NotImplementedError(_NOT_PORTED.format(
            what=", ".join(missing), name=cfg.name))
    # the blocks and the final norm compute these two of each, whatever
    # else a config names
    if cfg.norm not in ("rmsnorm", "layernorm") or cfg.act not in (
            "swiglu", "gelu_mlp"):
        raise NotImplementedError(
            f"norm={cfg.norm!r}, act={cfg.act!r} of {cfg.name}: the port "
            "computes RMSNorm or LayerNorm and the SwiGLU or GELU MLP")


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
    if mix == "attn":
        sp.update(blocks.attn_specs(cfg, f"{pfx}.mix"))
    else:
        sp.update(blocks.mamba_specs(cfg, f"{pfx}.mix"))
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
                keep: float) -> TVal:
    """Pre-norm residual layer; ``keep`` (0.0 for padding layers) scales
    each residual branch, as the reference's ``u + v * keep``. Dense
    kinds have no auxiliary loss. Training runs ``attn:dense`` layers
    only: Mamba and MoE on the tape wait for the Jamba training slice."""
    if kind != "attn:dense":
        raise NotImplementedError(
            f"training a {kind!r} layer of {ctx.cfg.name} waits for the "
            "Jamba training slice (apply_mamba and apply_moe on the tape; "
            "ROADMAP.md queue 1)")

    def res_add(a, b):
        return t.prim(lambda u, v: u + v * keep, a, b)

    h = blocks.apply_norm(t, ctx.cfg, f"{pfx}.ln1", x)
    x = res_add(x, blocks.apply_attn(t, ctx, f"{pfx}.mix", h))
    h2 = blocks.apply_norm(t, ctx.cfg, f"{pfx}.ln2", x)
    return res_add(x, blocks.apply_ffn(t, ctx, f"{pfx}.ffn", h2))


def apply_stage(t: Tape, ctx: blocks.LayerCtx, seg: Segment, x: TVal,
                stage_id: int) -> tuple[TVal, TVal]:
    """Apply the k layers of one stage. Returns (y, aux scalar): the aux
    loss stays 0 for dense layers, kept for the ``aux_sum`` metric."""
    aux_total = t.value(torch.zeros((), dtype=torch.float32,
                                    device=x.val.device))
    for j, kind in enumerate(seg.kinds):
        keep = float(stage_id * seg.k + j < seg.n_layers)
        x = apply_layer(t, ctx, kind, f"L{j}", x, keep)
    return x, aux_total


def reference_logits(cfg, rc, params, tokens):
    """Full forward on one device, looping stages in logical order; the
    plain oracle of the pipeline. Returns (logits [b, s, vocab] in the
    compute dtype, aux)."""
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
    """Mean token cross-entropy of :func:`reference_logits` (float32)."""
    logits, _ = reference_logits(cfg, rc, params, tokens)
    lf = logits.reshape(-1, logits.shape[-1]).float()
    lse = torch.logsumexp(lf, dim=-1)
    lab = lf.gather(1, labels.reshape(-1, 1).long())[:, 0]
    return (lse - lab).mean()


# --------------------------------------------------------------------------- #
# Cached stage execution (prefill / decode serving)
# --------------------------------------------------------------------------- #


def layer_cache_spec(cfg, rc, kind, batch, max_seq) -> dict[str, tuple]:
    """(shape, dtype) of each leaf of one layer's serve cache. The KV
    storage dtype is decoupled from compute: fp32/bf16, or int8 for
    quantised pages (their scales are added by ``init_serve_caches``).
    A Mamba layer keeps its conv state [batch, d_conv-1, di] in the
    compute dtype and its SSM state [batch, di, d_state] in float32."""
    _check_kind(cfg, kind)
    if kind.startswith("mamba:"):
        mc, di, _ = blocks._mamba_dims(cfg)
        return {"conv": ((batch, mc.d_conv - 1, di),
                         torch_dtype(rc.compute_dtype)),
                "h": ((batch, di, mc.d_state), torch.float32)}
    kv_dt = torch_dtype(rc.kv_cache_dtype or rc.compute_dtype)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, kv_dt), "v": (shape, kv_dt)}


def embed_tokens(params, tokens, cfg, dtype):
    """tokens int [b, s] -> [b, s, d]. Ids are clamped into the table, as
    a JAX gather clamps out-of-range indices."""
    ids = tokens.long().clamp(0, params["embed.table"].shape[0] - 1)
    return params["embed.table"][ids].to(dtype)


def cached_layer(ctx, params, kind, pfx, x, cache, pos):
    """Unified prefill (s>1) / decode (s=1) for one pre-norm layer."""
    _check_kind(ctx.cfg, kind)
    cfg = ctx.cfg
    blocks.check_serves(cfg)
    mix, ffn = kind.split(":")
    h = blocks.norm_fwd(cfg, params, f"{pfx}.ln1", x)
    if mix == "attn":
        dh, cache = blocks.attn_cached(ctx, params, f"{pfx}.mix", h, cache,
                                       pos)
    else:
        dh, c2 = blocks.mamba_cached(ctx, params, f"{pfx}.mix", h, cache,
                                     pos)
        cache = blocks._slot_state(ctx, cache, c2)
    x = x + dh
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

