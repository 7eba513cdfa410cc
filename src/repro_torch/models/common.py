"""Model/shape/run configuration dataclasses and parameter-spec machinery.

The port's own copy of ``repro/models/common.py``: the dataclasses keep the
reference's fields and defaults one for one (a test compares them field by
field), so a config or a parameter tree carries across by name. The jax
initializer becomes :func:`init_params` over a ``torch.Generator``; RoPE
tables and their application compute in float32 as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# --------------------------------------------------------------------------- #
# Configs
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0          # d_ff of the shared expert(s)
    capacity_factor: float = 1.25
    every: int = 1                # MoE FFN every N layers (else dense FFN)
    offset: int = 0               # which residue (mod every) gets MoE
    first_dense: int = 0          # first N layers use a dense FFN instead
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dims: int = 64
    v_head: int = 128
    qk_nope: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> d_model // 16


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    slstm_every: int = 8   # one sLSTM block every N (rest mLSTM)
    proj_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int = 32
    enc_ctx: int = 1500   # whisper audio frames after conv frontend


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int               # decoder layers for encdec families
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | gelu_mlp
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    mamba: MambaCfg | None = None
    attn_every: int = 0         # hybrid: attention layer every N (else mamba)
    attn_offset: int = 0        # which residue mod attn_every is attention
    xlstm: XLSTMCfg | None = None
    encdec: EncDecCfg | None = None
    frontend: str | None = None  # "audio" | "vision" (stubbed embeddings)
    mtp: bool = False            # DeepSeek multi-token-prediction aux head
    max_seq: int = 131_072

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def layer_kind(self, i: int) -> str:
        """Static mixer/ffn kind of global layer i (pre-pipeline-padding)."""
        if self.xlstm is not None:
            mix = "slstm" if (i % self.xlstm.slstm_every
                              == self.xlstm.slstm_every - 1) else "mlstm"
            return f"{mix}:none"
        if self.mamba is not None and self.attn_every:
            mix = ("attn" if i % self.attn_every == self.attn_offset
                   else "mamba")
        elif self.mamba is not None:
            mix = "mamba"
        elif self.mla is not None:
            mix = "mla"
        else:
            mix = "attn"
        if self.moe is not None:
            if (i < self.moe.first_dense
                    or (i % self.moe.every) != self.moe.offset):
                ffn = "dense"
            else:
                ffn = "moe"
        elif self.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"
        return f"{mix}:{ffn}"

    @property
    def is_mixed(self) -> bool:
        """Do layers differ in kind (union stage blocks needed)?"""
        kinds = {self.layer_kind(i) for i in range(self.n_layers)}
        return len(kinds) > 1


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Distribution + schedule hyper-parameters for one launch."""

    pp: int = 16                 # pipeline size P (per pipeline group)
    vpp: int = 2                 # interleaved stages per device V
    groups: int = 1              # pipeline groups sharing the model axis
    microbatches: int = 8        # B: micro-batches per pipeline per step
    unit: int = 0                # U: scheduling-unit size (0 -> B)
    schedule: str = "zeropp"     # zeropp|gpipe|1f1b|interleaved|bfs|
                                 # autogen|autogen_gated (§4; _gated keeps
                                 # unit-depth stash buffers)
    fsdp: bool = True
    moe_mode: str = "gathered"   # gathered | ep | auto (Session resolves
                                 # "auto" to a concrete mode via the
                                 # a2a-aware cost model before any build)
    moe_stats: bool = False      # collect per-layer expert-load histograms
                                 # + capacity-drop counters (train metrics
                                 # "moe_load"/"moe_dropped"; serve steps
                                 # return an extra trailing stats dict)
    remat: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    grad_compress: str = "none"  # none | int8
    grad_rs_dtype: str = "float32"  # reduce-scatter wire dtype (bf16 halves
                                    # grad traffic; accum stays fp32)
    coalesce: str = "flat"          # flat: one all-gather / reduce-scatter
                                    # per stage segment per tick (flat
                                    # buffers, §3.3 bandwidth-bound); none:
                                    # one collective per tensor (escape
                                    # hatch / debugging)
    serve_resident: bool = False    # serving: keep non-EP params gathered
                                    # (no per-step FSDP gathers)
    no_defer_extra: tuple = ()      # param-name substrings whose dW is
                                    # computed in B (partial W-deferral —
                                    # trades bubble-filler mass for stash
                                    # memory on huge projections)
    opt_moment_dtype: str = "float32"
    gather_prefetch: int = 1        # issue stage gathers N ticks early
                                    # (paper §3.3 prefetch; ≥1 lets the
                                    # async all-gather overlap the prior
                                    # block's compute; 0 = gather at use)
    attn_block_k: int = 512
    vocab_chunk: int = 8192
    kernel_impl: str | None = None  # None: by device (the CUDA kernels on
                                    # CUDA tensors, the plain versions on
                                    # CPU ones); "kernel"/"ref" force a path
                                    # ("kernel" on a CPU tensor raises)
    kv_cache_dtype: str | None = None  # serving KV-cache storage dtype:
                                       # None (= compute_dtype) | "fp32" |
                                       # "bf16" | "int8" (paged only;
                                       # per-page×head scales ride along)

    @property
    def unit_size(self) -> int:
        return self.unit or self.microbatches


# --------------------------------------------------------------------------- #
# Parameter specs
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"         # normal | zeros | ones | small
    fsdp_dim: int = 0            # which dim FSDP shards over "data"
    scale: float = 1.0           # init scale multiplier
    ep: bool = False             # expert-parallel: dim0 stays sharded over
                                 # "data" (never FSDP-gathered) in ep mode


@dataclasses.dataclass(frozen=True)
class FlatEntry:
    """One gatherable tensor's slice of a stage's flat segment.

    The segment stores each tensor with its data-sharded dim moved to
    axis 0 and flattened, laid out *shard-major*: the per-rank local
    packs concatenate in entry order, and the gathered segment is the
    rank-order concatenation of those locals. ``offset``/``size`` index
    the LOCAL (per-shard) pack — the gathered view of tensor ``i`` is
    ``seg.reshape(dsize, local_size)[:, offset:offset+size]``.
    """

    name: str
    shape: tuple[int, ...]       # full (unsharded) tensor shape
    ld: int                      # data-sharded dim (moved to axis 0)
    offset: int                  # start in the local flat pack (elements)
    size: int                    # local element count (= prod(shape)/dsize)


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static offsets of one stage segment's flat parameter buffer."""

    entries: tuple[FlatEntry, ...]
    local_size: int              # per-shard flat length
    dsize: int                   # data-axis size the layout was built for

    @property
    def full_size(self) -> int:
        return self.local_size * self.dsize

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(e.name for e in self.entries)


_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a RunConfig dtype name ("bfloat16", "fp32", ...)."""
    return _DTYPES[name]


def init_param(spec: ParamSpec, dtype, generator: torch.Generator,
               device) -> torch.Tensor:
    """One tensor under the reference's rules: zeros/ones, else a normal
    draw scaled by ``spec.scale / sqrt(fan_in)`` with fan_in = shape[0]
    (scaled in place: one float32 copy of the tensor while it is made)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if spec.shape else 1
    std = spec.scale / np.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)


def init_params(specs: dict[str, ParamSpec], dtype, generator, device
                ) -> dict[str, torch.Tensor]:
    """Every spec in sorted-name order, drawn from one generator."""
    return {name: init_param(specs[name], dtype, generator, device)
            for name in sorted(specs)}


def rope_tables(seq: int, d: int, theta: float, device=None):
    """cos/sin tables [seq, d/2] in float32 (computed in float64 numpy,
    like the reference, then rounded once)."""
    inv = 1.0 / theta ** (np.arange(0, d, 2) / d)
    pos = np.arange(seq)
    ang = np.einsum("s,f->sf", pos, inv)
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x: [..., s, h, e] with cos/sin [s, e/2] — or [b, s, e/2] when each
    batch row sits at its own absolute position (slotted serving) —
    broadcast over heads. Rotation in fp32, result cast back to x.dtype."""
    e = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : e // 2], xf[..., e // 2:]
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
