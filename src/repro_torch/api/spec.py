"""SessionSpec: the validated builder behind ``repro_torch.api.session``.

The serving slice of ``repro/api/spec.py``: architecture resolution,
RunConfig overrides and the serving knobs, checked before any device
work. The port runs on one rank, so the data/pod axes are 1 and the
schedule, cost-model, topology and mesh knobs of the reference have no
counterpart yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.api.registry import RegistryError, get_arch
from repro_torch.models.common import RunConfig


class SessionError(ValueError):
    """Invalid session specification (message says how to fix it)."""


_RC_FIELDS = {f.name for f in dataclasses.fields(RunConfig)}


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """Everything needed to build a serve Session. Validated, not built."""

    arch: str
    mode: str = "serve"
    reduced: bool = True            # reduced() smoke config vs the
    #                                 published width on one card
    overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    data: int | None = None         # data-axis size (one rank: 1)
    pods: int | None = None         # pod axis (one rank: 1)
    max_seq: int | None = None      # serving cache length
    max_slots: int | None = None    # continuous-batching slot count
    global_batch: int | None = None  # same quantity as max_slots
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
        if self.kv_cache_dtype is not None:
            prev = self.overrides.get("kv_cache_dtype")
            if prev is not None and prev != self.kv_cache_dtype:
                raise SessionError(
                    f"kv_cache_dtype given twice and inconsistently: "
                    f"kv_cache_dtype={self.kv_cache_dtype!r} vs "
                    f"overrides['kv_cache_dtype']={prev!r}")
            self.overrides["kv_cache_dtype"] = self.kv_cache_dtype

    def validate(self) -> "SessionSpec":
        if self.mode != "serve":
            raise SessionError(
                f"mode={self.mode!r}: repro_torch serves only so far; the "
                "training side (tape, tick engine, FSDP, AdamW) is the next "
                "slice of the port (ROADMAP.md queue 1)")
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
        for axis in ("data", "pods"):
            if getattr(self, axis) not in (None, 1):
                raise SessionError(
                    f"{axis}={getattr(self, axis)}: repro_torch serves on "
                    "one rank; data-parallel serving arrives with the "
                    "multi-rank slices (ROADMAP.md queue 1)")
        if self.device not in ("cuda", "cpu"):
            raise SessionError(
                f"device={self.device!r}: pick 'cuda' or 'cpu'")
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

    def resolve_configs(self):
        """Returns (arch_module, ModelConfig, RunConfig) post-overrides."""
        mod = get_arch(self.arch)
        if self.reduced:
            cfg, rc = mod.reduced()
        else:
            cfg, rc = mod.config(), mod.one_card_run()
        if self.overrides:
            rc = dataclasses.replace(rc, **self.overrides)
        return mod, cfg, rc
