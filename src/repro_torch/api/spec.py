"""SessionSpec: the validated builder behind ``repro_torch.api.session``.

The port's slice of ``repro/api/spec.py``: architecture resolution,
RunConfig overrides, the training shape and optimizer knobs, and the
serving knobs, checked before any device work. Training runs on a data x
(groups x pp) mesh of ranks (``data``, ``overrides["pp"]``,
``overrides["groups"]``; the session checks them against the process
group) with flat coalescing and one pod; serving runs on one rank.
``schedule="auto"``/``"auto_profiled"``, topologies, expert parallelism,
Mamba/MoE training, serving LayerNorm / GELU models (the paper's GPT),
checkpoints, and the pod axis, int8 gradient compression,
``coalesce="none"`` and multi-rank serving are refused with the slice
they wait for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.api.registry import (
    SCHEDULE_REGISTRY,
    RegistryError,
    get_arch,
)
from repro_torch.models.common import RunConfig


class SessionError(ValueError):
    """Invalid session specification (message says how to fix it)."""


LATER = "ROADMAP.md queue 1 item 1b"


_RC_FIELDS = {f.name for f in dataclasses.fields(RunConfig)}


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """Everything needed to build a Session. Validated, not built."""

    arch: str
    mode: str = "serve"
    reduced: bool = True            # reduced() smoke config vs the
    #                                 published width on one card
    schedule: str | None = None     # shorthand for overrides["schedule"]
    overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    optim: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    seq_len: int | None = None      # train: sequence length (default 32)
    topology: Any = None            # hardware topology (refused: one card)
    data: int | None = None         # data-axis size (train; default 1)
    pods: int | None = None         # pod axis (one pod: 1)
    max_seq: int | None = None      # serving cache length
    max_slots: int | None = None    # continuous-batching slot count
    global_batch: int | None = None  # serve: same quantity as max_slots;
    #                                  train: sequences a step (default one
    #                                  per micro-batch)
    prefill_chunk: int | None = None  # split prompts into chunks of this
    #                                   width
    page_size: int | None = None    # paged KV cache: tokens per page
    #                                 (None -> contiguous per-slot rows)
    max_pages: int | None = None    # paged KV cache: total page count
    #                                 (None -> max_slots * max_seq/page)
    prefix_sharing: str = "on"      # radix prefix sharing across requests
    kv_cache_dtype: str | None = None  # "fp32" | "bf16" | "int8" (int8 =
    #                                    quantised pages, needs page_size)
    device: str = "cuda"            # "cuda" (default) or "cpu" (tests)

    def __post_init__(self):
        object.__setattr__(self, "overrides", dict(self.overrides or {}))
        object.__setattr__(self, "optim", dict(self.optim or {}))
        if self.schedule is not None:
            prev = self.overrides.get("schedule")
            if prev is not None and prev != self.schedule:
                raise SessionError(
                    f"schedule given twice and inconsistently: "
                    f"schedule={self.schedule!r} vs "
                    f"overrides['schedule']={prev!r}")
            self.overrides["schedule"] = self.schedule
        if self.kv_cache_dtype is not None:
            prev = self.overrides.get("kv_cache_dtype")
            if prev is not None and prev != self.kv_cache_dtype:
                raise SessionError(
                    f"kv_cache_dtype given twice and inconsistently: "
                    f"kv_cache_dtype={self.kv_cache_dtype!r} vs "
                    f"overrides['kv_cache_dtype']={prev!r}")
            self.overrides["kv_cache_dtype"] = self.kv_cache_dtype

    def validate(self) -> "SessionSpec":
        if self.mode not in ("train", "serve"):
            raise SessionError(
                f"mode={self.mode!r}: pick 'train' or 'serve' (the dry-run "
                "mode lowers for a TPU mesh and has no port)")
        try:
            get_arch(self.arch)
        except RegistryError as e:
            raise SessionError(str(e)) from e
        bad = sorted(set(self.overrides) - _RC_FIELDS)
        if bad:
            raise SessionError(
                f"unknown RunConfig override(s) {bad}; valid fields: "
                f"{', '.join(sorted(_RC_FIELDS))}")
        ki = self.overrides.get("kernel_impl")
        if ki not in (None, "kernel", "ref"):
            raise SessionError(
                f"unknown kernel_impl {ki!r}; pick 'kernel' (the CUDA "
                "kernels; needs device='cuda'), 'ref' (the plain PyTorch "
                "versions), or None (by device)")
        if ki == "kernel" and self.device != "cuda":
            raise SessionError("kernel_impl='kernel' needs device='cuda'")
        kvd = self.overrides.get("kv_cache_dtype")
        if kvd is not None:
            if kvd not in ("fp32", "bf16", "int8"):
                raise SessionError(
                    f"unknown kv_cache_dtype {kvd!r}; pick 'fp32', "
                    "'bf16', or 'int8' (quantized pages)")
            if kvd == "int8" and self.page_size is None:
                raise SessionError(
                    "kv_cache_dtype='int8' quantizes *pages* (per-page "
                    "scales live beside the page pool); pass "
                    "page_size=<tokens per page>")
        if self.pods not in (None, 1):
            raise SessionError(
                f"pods={self.pods}: the pod axis (gradients all-reduced "
                f"across pods) waits for {LATER}")
        if self.data is not None and self.data < 1:
            raise SessionError(f"data must be >= 1, got {self.data}")
        if self.device not in ("cuda", "cpu"):
            raise SessionError(
                f"device={self.device!r}: pick 'cuda' or 'cpu'")
        if self.topology is not None:
            raise SessionError(
                "topology presets lay a model over a cluster; the port takes "
                "the mesh as data= and overrides pp / groups (a multi-rank "
                "slice beyond ROADMAP.md queue 1 item 1)")
        moe = self.overrides.get("moe_mode", "gathered")
        if moe != "gathered":
            raise SessionError(
                f"moe_mode={moe!r}: the port routes MoE layers in the "
                "gathered mode only; 'ep' and 'auto' wait for the "
                "expert-parallel MoE slice (ROADMAP.md queue 1)")
        if self.overrides.get("moe_stats"):
            raise SessionError(
                "moe_stats: the per-layer expert-load histograms and "
                "capacity-drop counters wait for the expert-parallel MoE "
                "slice (ROADMAP.md queue 1)")
        if self.mode == "train":
            return self._validate_train()
        if (self.data or 1) > 1 or self.overrides.get("groups", 1) != 1:
            raise SessionError(
                "serving runs on one rank: multi-rank serving on the tick "
                f"engine waits for {LATER}")
        mod = get_arch(self.arch)
        cfg = (mod.reduced()[0] if self.reduced
               else getattr(mod, "one_card_config", mod.config)())
        if cfg.norm != "rmsnorm" or cfg.act != "swiglu":
            raise SessionError(
                f"serving {cfg.name} (norm={cfg.norm!r}, act={cfg.act!r}) "
                "waits for GPT serving: LayerNorm and the GELU MLP on the "
                "serve path and K3/K4 at head_dim 96 (ROADMAP.md queue 1 "
                "item 2); train it with mode='train'")
        if self.max_seq is None or self.max_seq < 1:
            raise SessionError(
                "serve sessions need max_seq=<prompt+gen+slack> (the KV "
                "cache length)")
        if self.max_slots is not None:
            if self.max_slots < 1:
                raise SessionError(
                    f"max_slots must be >= 1, got {self.max_slots}")
            if self.global_batch is not None \
                    and self.global_batch != self.max_slots:
                raise SessionError(
                    f"max_slots ({self.max_slots}) and global_batch "
                    f"({self.global_batch}) disagree; in serve mode they "
                    "are the same quantity — pass one of them")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise SessionError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.prefix_sharing not in ("on", "off"):
            raise SessionError(
                f"prefix_sharing must be 'on' or 'off', got "
                f"{self.prefix_sharing!r}")
        if self.page_size is not None:
            if self.page_size < 1:
                raise SessionError(
                    f"page_size must be >= 1, got {self.page_size}")
            if self.max_seq % self.page_size != 0:
                raise SessionError(
                    f"page_size ({self.page_size}) must divide max_seq "
                    f"({self.max_seq}) so page tables have a fixed width")
        if self.max_pages is not None:
            if self.page_size is None:
                raise SessionError(
                    "max_pages needs page_size=<tokens per page> (it "
                    "sizes the paged KV cache)")
            if self.max_pages < 1:
                raise SessionError(
                    f"max_pages must be >= 1, got {self.max_pages}")
        return self

    def _validate_train(self) -> "SessionSpec":
        cfg = get_arch(self.arch).config()
        if cfg.mamba is not None or cfg.moe is not None:
            raise SessionError(
                f"training {cfg.name} (Mamba and MoE layers) waits for the "
                "Jamba training slice: apply_mamba and apply_moe on the "
                "tape, the selective-scan backward and the router aux "
                "loss (ROADMAP.md queue 1); serve it with mode='serve'")
        sched = self.overrides.get("schedule")
        if sched in ("auto", "auto_profiled", "autogen", "autogen_gated"):
            raise SessionError(
                f"schedule={sched!r}: the simulated plan selection and the "
                "§4 auto-generated schedules wait for the auto slice "
                "(ROADMAP.md queue 1); pick one of "
                f"{', '.join(SCHEDULE_REGISTRY.names())}")
        if sched is not None:
            try:
                SCHEDULE_REGISTRY.get(sched)
            except RegistryError as e:
                raise SessionError(str(e)) from e
        for knob in ("pp", "groups"):
            if self.overrides.get(knob, 1) < 1:
                raise SessionError(
                    f"{knob} must be >= 1, got {self.overrides[knob]}")
        g = self.overrides.get("groups", 1)
        if g & (g - 1):
            raise SessionError(
                f"groups={g}: the cross-group gradient butterfly needs a "
                "power of two")
        if self.overrides.get("grad_compress", "none") != "none":
            raise SessionError(
                "grad_compress='int8' (the cross-rank reduce-scatter in int8 "
                f"with error feedback) waits for {LATER}")
        if self.overrides.get("coalesce", "flat") != "flat":
            raise SessionError(
                f"coalesce={self.overrides['coalesce']!r}: the port packs "
                "each stage into one flat slab; per-tensor collectives "
                f"wait for {LATER}")
        if self.seq_len is not None and self.seq_len < 1:
            raise SessionError(f"seq_len must be >= 1, got {self.seq_len}")
        if self.global_batch is not None and self.global_batch < 1:
            raise SessionError(
                f"global_batch must be >= 1, got {self.global_batch}")
        return self

    def resolve_configs(self):
        """Returns (arch_module, ModelConfig, RunConfig) post-overrides.

        Train mode: the reduced RunConfig's pp (2, the reference's
        multi-device smoke layout) becomes 1 unless ``overrides`` set it,
        and the full width takes the module's ``one_card_train_run()``
        (pp, groups from ``overrides``). The full width
        is the module's ``one_card_config()`` where it defines one (a
        model cut in depth to fit one card), else ``config()``."""
        mod = get_arch(self.arch)
        if self.reduced:
            cfg, rc = mod.reduced()
            if self.mode == "train":
                rc = dataclasses.replace(rc, pp=1)
        else:
            cfg = getattr(mod, "one_card_config", mod.config)()
            rc = (mod.one_card_train_run() if self.mode == "train"
                  else mod.one_card_run())
        if self.overrides:
            rc = dataclasses.replace(rc, **self.overrides)
        return mod, cfg, rc
