"""SessionSpec: the validated builder behind ``repro_torch.api.session``.

The port's slice of ``repro/api/spec.py``: architecture resolution,
RunConfig overrides, the training shape and optimizer knobs, and the
serving knobs, checked before any device work. Training runs on a pods x
data x (groups x pp) mesh of ranks (``pods``, ``data``,
``overrides["pp"]``, ``overrides["groups"]``; the session checks them
against the process group), with flat or per-tensor collectives
(``coalesce``) and float32 or int8 gradient reduces
(``grad_compress``); serving runs on one rank or on the same mesh, with
the reference's checks that the slot rows and the page arena split
evenly over pods x data (x FSDP groups, paged). Train sessions take any
registered schedule, the §4 ``autogen`` / ``autogen_gated``, or
``schedule="auto"`` / ``"auto_profiled"`` (the plan selection under
``cost_preset``, ``mem_budget``, ``profile_top_k`` and
``profile_budget_s``, with the reference's checks); serve sessions take
``"auto"`` too. Serving takes RMSNorm or LayerNorm and the SwiGLU or
GELU MLP (the paper's GPT included). Topologies, expert parallelism and
Mamba/MoE training are refused with the roadmap item they wait for.
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


AUTO_MODES = ("auto", "auto_profiled")


_RC_FIELDS = {f.name for f in dataclasses.fields(RunConfig)}


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """Everything needed to build a Session. Validated, not built."""

    arch: str
    mode: str = "serve"
    reduced: bool = True            # reduced() smoke config vs the
    #                                 published width on one card
    schedule: str | None = None     # shorthand for overrides["schedule"]
    #                                 (a registered name, "auto" for the
    #                                 §4 simulated selection, or
    #                                 "auto_profiled" to also time the
    #                                 top-K survivors; train only)
    cost_preset: str = "a800"       # simulator preset of the selection
    profile_top_k: int = 3          # auto_profiled: survivors measured
    profile_budget_s: float | None = None  # auto_profiled: seconds cap
    #                                 on measuring (the simulated-best
    #                                 survivor is always measured)
    mem_budget: float | None = None  # auto: simulated peak-memory cap
    #                                  (bytes under the preset)
    overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    optim: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    seq_len: int | None = None      # train: sequence length (default 32)
    topology: Any = None            # hardware topology (refused: one card)
    data: int | None = None         # data-axis size (default 1)
    pods: int | None = None         # pod axis (default 1)
    layers: int | None = None       # train: the model cut to this depth
    #                                 (its widths kept; default: all)
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
        for knob in ("pods", "data", "layers"):
            val = getattr(self, knob)
            if val is not None and val < 1:
                raise SessionError(f"{knob} must be >= 1, got {val}")
        if self.device not in ("cuda", "cpu"):
            raise SessionError(
                f"device={self.device!r}: pick 'cuda' or 'cpu'")
        if self.topology is not None:
            raise SessionError(
                "topology presets lay a model over a cluster; the port takes "
                "the mesh as data= and overrides pp / groups (topologies "
                "arrive with elasticity, ROADMAP.md queue 1 item 8)")
        moe = self.overrides.get("moe_mode", "gathered")
        if moe != "gathered":
            raise SessionError(
                f"moe_mode={moe!r}: the port routes MoE layers in the "
                "gathered mode only; 'ep' and 'auto' wait for the "
                "expert-parallel MoE slice (ROADMAP.md queue 1 item 7)")
        if self.overrides.get("moe_stats"):
            raise SessionError(
                "moe_stats: the per-layer expert-load histograms and "
                "capacity-drop counters wait for the expert-parallel MoE "
                "slice (ROADMAP.md queue 1 item 7)")
        self._validate_selection()
        if self.mode == "train":
            return self._validate_train()
        if self.layers is not None:
            raise SessionError("layers= cuts a model for training; serving "
                               "takes the config's depth")
        for knob in ("pp", "groups"):
            if self.overrides.get(knob, 1) < 1:
                raise SessionError(
                    f"{knob} must be >= 1, got {self.overrides[knob]}")
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
            shards = (self.pods or 1) * (self.data or 1)
            if self.max_slots % shards != 0:
                raise SessionError(
                    f"max_slots ({self.max_slots}) must divide evenly "
                    f"over the pods×data axes ({shards}): the slotted "
                    "(per-slot pos) serve path needs a batch-sharded "
                    "cache — round max_slots up or shrink data=/pods=")
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
            shards = (self.pods or 1) * (self.data or 1)
            if self.max_pages % shards != 0:
                raise SessionError(
                    f"max_pages ({self.max_pages}) must divide evenly "
                    f"over the pods×data axes ({shards}): the page axis "
                    "shards exactly like the slot batch axis")
        if self.page_size is not None:
            # the page arena and the slot rows partition over pods×data
            # × FSDP groups (cache leaves shard over the stage axis, so
            # a page exists only in the group replica that wrote it) —
            # catch a bad count here with the full partition count, not
            # deep in PagePool at engine construction.
            try:
                groups = self.resolve_configs()[2].groups
            except Exception:   # resolution errors surface on their own
                groups = None
            if groups is not None and groups > 1:
                shards = (self.pods or 1) * (self.data or 1)
                parts = shards * groups
                if self.max_pages is not None \
                        and self.max_pages % parts != 0:
                    raise SessionError(
                        f"max_pages ({self.max_pages}) must divide "
                        f"evenly over the {parts} cache partitions "
                        f"(pods×data ({shards}) × FSDP groups "
                        f"({groups})): a page lives only in the stage "
                        "replica of the group that wrote it — round "
                        f"max_pages to a multiple of {parts}")
                if self.max_slots is not None \
                        and self.max_slots % parts != 0:
                    raise SessionError(
                        f"max_slots ({self.max_slots}) must divide "
                        f"evenly over the {parts} cache partitions "
                        f"(pods×data ({shards}) × FSDP groups "
                        f"({groups})) for the paged serve path")
        return self

    def _validate_selection(self) -> None:
        """The schedule name and the plan-selection knobs (the
        reference's checks, ``repro/api/spec.py``)."""
        sched = self.overrides.get("schedule")
        if sched is not None and sched not in AUTO_MODES:
            try:
                SCHEDULE_REGISTRY.get(sched)
            except RegistryError as e:
                raise SessionError(
                    str(e) + " (or pass schedule='auto' to search the "
                    "registered schedules, 'auto_profiled' to also time "
                    "the finalists on the live mesh)") from e
        if sched == "auto_profiled" and self.mode != "train":
            raise SessionError(
                "schedule='auto_profiled' measures real *train* steps "
                f"during selection; this session is mode={self.mode!r} — "
                "use schedule='auto' (simulated-only) here, or tune in a "
                "train session and pass the winning schedule explicitly")
        if self.profile_top_k < 1:
            raise SessionError(
                f"profile_top_k must be >= 1 (at least the simulated-best "
                f"candidate gets measured), got {self.profile_top_k}")
        if self.profile_budget_s is not None and self.profile_budget_s < 0:
            raise SessionError(
                f"profile_budget_s must be >= 0 (0 still measures the "
                f"simulated-best candidate), got {self.profile_budget_s}")
        if sched != "auto_profiled" and (
                self.profile_top_k != 3 or self.profile_budget_s
                is not None):
            raise SessionError(
                "profile_top_k/profile_budget_s only steer the "
                "schedule='auto_profiled' measured refinement; pass "
                "schedule='auto_profiled' (or drop them)")
        from repro_torch.core.plan import PRESETS
        if self.cost_preset == "tpu_v5e":
            raise SessionError(
                "cost_preset='tpu_v5e': the port does not carry the "
                "reference's TPU preset — it runs on NVIDIA cards and "
                "states no rate taken on or for a TPU; known presets: "
                f"{', '.join(sorted(PRESETS))}")
        if self.cost_preset not in PRESETS:
            raise SessionError(
                f"unknown cost_preset {self.cost_preset!r}; known "
                f"presets: {', '.join(sorted(PRESETS))}")
        if self.mem_budget is not None:
            if self.mem_budget <= 0:
                raise SessionError(
                    f"mem_budget must be a positive simulated-peak-memory "
                    f"cap (bytes under the {self.cost_preset!r} preset), "
                    f"got {self.mem_budget}")
            if sched not in AUTO_MODES:
                raise SessionError(
                    "mem_budget only steers the schedule='auto'/"
                    "'auto_profiled' selection; pass one of those (or "
                    "drop mem_budget)")

    def _validate_train(self) -> "SessionSpec":
        for knob in ("pp", "groups"):
            if self.overrides.get(knob, 1) < 1:
                raise SessionError(
                    f"{knob} must be >= 1, got {self.overrides[knob]}")
        g = self.overrides.get("groups", 1)
        if g & (g - 1):
            raise SessionError(
                f"groups={g}: the cross-group gradient butterfly needs a "
                "power of two")
        gc = self.overrides.get("grad_compress", "none")
        if gc not in ("none", "int8"):
            raise SessionError(
                f"grad_compress={gc!r}: pick 'none' (float32 reduces) or "
                "'int8' (int8 reduces with error feedback)")
        co = self.overrides.get("coalesce", "flat")
        if co not in ("flat", "none"):
            raise SessionError(
                f"coalesce={co!r}: pick 'flat' (one collective a stage "
                "block) or 'none' (one a tensor)")
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
        is the module's ``one_card_train_config()`` in train mode and its
        ``one_card_config()`` in serve mode where it defines them (a model
        cut to fit one card), else ``config()``; a ``layers`` cuts its
        depth (an encoder-decoder's encoder and decoder alike)."""
        mod = get_arch(self.arch)
        if self.reduced:
            cfg, rc = mod.reduced()
            if self.mode == "train":
                rc = dataclasses.replace(rc, pp=1)
        else:
            cut = getattr(mod, "one_card_config", mod.config)
            if self.mode == "train":
                cut = getattr(mod, "one_card_train_config", cut)
            cfg = cut()
            rc = (mod.one_card_train_run() if self.mode == "train"
                  else mod.one_card_run())
        if self.overrides:
            rc = dataclasses.replace(rc, **self.overrides)
        if self.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=self.layers)
            if cfg.encdec is not None:   # both segments
                cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
                    cfg.encdec, enc_layers=self.layers))
        return mod, cfg, rc
