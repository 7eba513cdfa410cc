"""Architecture assembly for serving: geometry, stage params, cached stages.

The port's counterpart of ``repro/models/model.py`` for the serving slice.
Geometry and parameter stacking follow the reference exactly: stage
``s = v·pp + p`` holds ``k`` consecutive layers, and the stacked params
and caches store it at index ``storage_index(p, v, V) = p·V + v``, so a
reference parameter tree carries over name for name.

Only llama-style models have blocks in the port so far: dense attention
layers (``attn:dense``) with RMSNorm, a SwiGLU FFN and a tied head. Any
other layer kind or variant raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models import blocks
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    RunConfig,
    torch_dtype,
)

_NOT_PORTED = ("{what} of {name} has no block in repro_torch yet; MLA, "
               "MoE, Mamba, xLSTM, enc-dec and the other variants arrive in "
               "later slices (ROADMAP.md queue 1)")

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
        (f"the {cfg.frontend} frontend", cfg.frontend is not None),
        (f"norm={cfg.norm!r}", cfg.norm != "rmsnorm"),
        (f"act={cfg.act!r}", cfg.act != "swiglu"),
        ("the untied head", not cfg.tie_embeddings)) if bad]
    if missing:
        raise NotImplementedError(_NOT_PORTED.format(
            what=", ".join(missing), name=cfg.name))


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
    if kind != "attn:dense":
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"layer kind {kind!r}", name=cfg.name))


def layer_slot_specs(cfg: ModelConfig, kind: str, pfx: str):
    """Specs for one layer slot of the given static kind."""
    _check_kind(cfg, kind)
    sp: dict[str, ParamSpec] = {}
    sp.update(blocks.norm_specs(cfg, f"{pfx}.ln1"))
    sp.update(blocks.attn_specs(cfg, f"{pfx}.mix"))
    sp.update(blocks.norm_specs(cfg, f"{pfx}.ln2"))
    sp.update(blocks.ffn_specs(cfg, f"{pfx}.ffn"))
    return sp


def stage_specs(cfg: ModelConfig, seg: Segment) -> dict[str, ParamSpec]:
    sp = {}
    for j, kind in enumerate(seg.kinds):
        sp.update(layer_slot_specs(cfg, kind, f"L{j}"))
    return sp


def io_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """Embedding (tied to the head) and final norm, outside the pipeline."""
    _check_supported(cfg)
    return {
        "embed.table": ParamSpec((cfg.vocab, cfg.d_model), fsdp_dim=0,
                                 scale=1.0),
        "final_norm.scale": ParamSpec((cfg.d_model,), "ones"),
    }


# --------------------------------------------------------------------------- #
# Cached stage execution (prefill / decode serving)
# --------------------------------------------------------------------------- #


def layer_cache_spec(cfg, rc, kind, batch, max_seq) -> dict[str, tuple]:
    """(shape, dtype) of each leaf of one layer's serve cache. The KV
    storage dtype is decoupled from compute: fp32/bf16, or int8 for
    quantised pages (their scales are added by ``init_serve_caches``)."""
    _check_kind(cfg, kind)
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
    h = blocks.norm_fwd(cfg, params, f"{pfx}.ln1", x)
    dh, cache = blocks.attn_cached(ctx, params, f"{pfx}.mix", h, cache, pos)
    x = x + dh
    h2 = blocks.norm_fwd(cfg, params, f"{pfx}.ln2", x)
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

