"""The Session facade of the port, serving side.

The serving half of ``repro/api/session.py`` — everything
:class:`repro_torch.serving.ServeEngine` reads::

    sess = repro_torch.api.session("llama3.2-1b", max_slots=8,
                                   max_seq=2048, reduced=False)
    params = sess.init_params()
    eng = sess.serve_engine(params)

It runs on one rank and one device: ``device="cuda"`` (the default, which
raises when no GPU is present) or ``device="cpu"`` (the tests). Batches
arrive as numpy arrays from the engine and move to the device here;
tokens and logits come back as CPU tensors, which ``np.asarray`` reads.
Caches stay on the device and are updated in place (``core/serve.py``).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from repro_torch.api.spec import SessionError, SessionSpec
from repro_torch.core import serve as CS
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.params import init_all_params


def session(arch: str, *, mode: str = "serve", overrides=None,
            **kw) -> "Session":
    """Build a validated serve Session. See SessionSpec for every knob."""
    return Session(SessionSpec(arch=arch, mode=mode,
                               overrides=dict(overrides or {}), **kw))


class Session:
    """A bound (arch × RunConfig × device) with its serve steps."""

    def __init__(self, spec: SessionSpec):
        self.spec = spec.validate()
        self.arch_mod, self.cfg, self.rc = spec.resolve_configs()
        if spec.device == "cuda" and not torch.cuda.is_available():
            raise SessionError(
                "device='cuda' but torch finds no GPU; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        self.device = torch.device(spec.device)
        if self.rc.groups != 1:
            raise SessionError(
                f"groups={self.rc.groups}: one rank holds one pipeline "
                "group; several groups need several ranks")
        try:
            self.geo = M.build_geometry(self.cfg, self.rc)
        except ValueError as e:
            raise SessionError(
                f"invalid geometry for {spec.arch!r}: {e}. Adjust the "
                "pp/vpp overrides.") from e
        for seg in self.geo.segments:   # unported layer kinds fail here
            M.stage_specs(self.cfg, seg)
        # the engine reads rt.G (page partitions per FSDP group)
        self.rt = types.SimpleNamespace(G=self.rc.groups)
        self._rope = None
        self._engine_stats = None   # serving EngineStats (engine attaches)
        # baseline for the per-session dispatch counters (process-wide)
        self._kernel_counter_base = ops.kernel_counters()

    # ------------------------------------------------------------------ #
    # Geometry the engine reads
    # ------------------------------------------------------------------ #

    data_size = 1
    pods_size = 1

    def _max_seq(self) -> int:
        return self.spec.max_seq

    @property
    def max_slots(self) -> int:
        """Serving slot count (the serve-mode global batch)."""
        return self.spec.max_slots or self.spec.global_batch or 8

    @property
    def paged(self) -> bool:
        return self.spec.page_size is not None

    @property
    def page_size(self) -> int:
        return self.spec.page_size or 0

    @property
    def pages_per_slot(self) -> int:
        return self._max_seq() // self.spec.page_size

    @property
    def n_pages(self) -> int:
        if self.spec.max_pages is not None:
            return self.spec.max_pages
        return self.max_slots * self.pages_per_slot

    def check_slot_sharding(self) -> None:
        """Nothing to check: one rank computes every slot row in one
        pass (the reference checks that its micro-batch tiling covers
        the rows of each data shard)."""

    def sampling_unsupported_reason(self) -> str | None:
        return None   # the replicated head always returns full logits

    # ------------------------------------------------------------------ #
    # Params / caches
    # ------------------------------------------------------------------ #

    def init_params(self, generator: torch.Generator | None = None):
        """Fresh params on the session's device (seed 0 when no
        generator is given)."""
        return init_all_params(self.cfg, self.rc, generator, self.device)

    def init_caches(self):
        return CS.init_serve_caches(
            self.cfg, self.rc, self.geo, slots=self.max_slots,
            max_seq=self._max_seq(), page_size=self.page_size,
            n_pages=self.n_pages if self.paged else 0, device=self.device)

    def reset_slot_caches(self, caches, slot_mask):
        """Zero the cache rows of the slots flagged in ``slot_mask``, in
        place (slot reclaim)."""
        return CS.reset_slot_caches(caches, self._index(slot_mask))

    def reset_pages(self, caches, page_mask):
        """Zero the pages flagged in ``page_mask`` [n_pages], in place."""
        return CS.reset_pages(caches, self._index(page_mask))

    def copy_pages(self, caches, src, dst):
        """Copy page ``src[i]`` -> ``dst[i]`` in every paged leaf."""
        return CS.copy_pages(caches, self._ids(src), self._ids(dst))

    # ------------------------------------------------------------------ #
    # Serve steps
    # ------------------------------------------------------------------ #

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def _index(self, mask) -> torch.Tensor:
        return self._ids(np.flatnonzero(np.asarray(mask)))

    def _step(self, params, caches, batch, want_logits):
        """Move a numpy batch to the device and run one serve step."""
        if self._rope is None:
            self._rope = CS.rope_for(self.cfg, self._max_seq(), self.device)
        dev = self.device
        tb = {"tokens": torch.as_tensor(np.asarray(batch["tokens"]),
                                        dtype=torch.int32, device=dev)}
        pos = np.asarray(batch.get("pos", 0))
        tb["pos"] = (int(pos) if pos.ndim == 0 else
                     torch.as_tensor(pos, dtype=torch.int32, device=dev))
        rows = None
        if batch.get("slot_mask") is not None:
            mask = np.asarray(batch["slot_mask"], bool)
            tb["slot_mask"] = torch.as_tensor(mask, device=dev)
            rows = self._index(mask)   # once per step, not once per layer
        if batch.get("page_tables") is not None:
            tb["page_tables"] = torch.as_tensor(
                np.asarray(batch["page_tables"]), dtype=torch.int32,
                device=dev)
        res = CS.serve_step(
            self.cfg, self.rc, self.geo, params, caches, tb, rope=self._rope,
            page_size=self.page_size, want_logits=want_logits,
            write_rows=rows)
        if want_logits:
            tok, logits, caches = res
            return tok.cpu(), logits.cpu(), caches
        tok, caches = res
        return tok.cpu(), caches

    def serve_prefill(self, params, caches, batch):
        """Run a prompt (scalar ``pos``, every row) through the stages;
        returns (tokens, caches)."""
        if self.paged:
            raise SessionError(
                "paged sessions serve through the slotted path "
                "(serve_step_batched / serve_engine); the scalar-pos "
                "serve_prefill has no page tables")
        return self._step(params, caches, batch, False)

    def serve_decode(self, params, caches, batch):
        """One cached decode step (scalar ``pos``); returns (tokens,
        caches)."""
        return self.serve_prefill(params, caches, batch)

    def serve_step_batched(self, params, caches, batch,
                           want_logits: bool = False):
        """One slot-aware step (prefill chunk s>=1 or decode s==1):
        ``pos`` int32 [max_slots] (each slot's first position), optional
        ``slot_mask`` bool [max_slots] gating cache writes, and for paged
        sessions ``page_tables`` int32 [max_slots, pages_per_slot].
        Returns ``(tokens[max_slots], caches)`` or, with ``want_logits``,
        ``(tokens, logits[max_slots, vocab], caches)``."""
        pos = batch.get("pos")
        if np.ndim(pos) != 1:
            raise SessionError(
                "serve_step_batched needs batch['pos'] as a per-slot "
                f"[{self.max_slots}] int32 vector (got "
                f"{getattr(pos, 'shape', None)}); use serve_prefill/"
                "serve_decode for the scalar-pos path")
        if self.paged and batch.get("page_tables") is None:
            raise SessionError(
                "paged sessions need batch['page_tables'] (int32 "
                f"[{self.max_slots}, {self.pages_per_slot}] page ids; see "
                "PagedSlotPool.page_table_matrix)")
        return self._step(params, caches, batch, want_logits)

    def serve_engine(self, params, **kw):
        """A continuous-batching :class:`repro_torch.serving.ServeEngine`
        over this session."""
        from repro_torch.serving import ServeEngine
        return ServeEngine(self, params, **kw)

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #

    def describe(self) -> dict:
        cfg, rc, geo = self.cfg, self.rc, self.geo
        n_params = sum(int(np.prod(s.shape))
                       for s in M.io_specs(cfg).values())
        for sg in geo.segments:
            n_params += geo.seg_stages(sg) * sum(
                int(np.prod(s.shape))
                for s in M.stage_specs(cfg, sg).values())
        now = ops.kernel_counters()
        base = self._kernel_counter_base
        out = {
            "arch": cfg.name,
            "mode": self.spec.mode,
            "device": str(self.device),
            "geometry": {
                "pp": rc.pp, "vpp": rc.vpp, "groups": rc.groups,
                "segments": [{"name": sg.name, "layers": sg.n_layers,
                              "stages": geo.seg_stages(sg), "k": sg.k}
                             for sg in geo.segments],
            },
            "kernels": {
                "impl": rc.kernel_impl or "auto",
                "kv_cache_dtype": rc.kv_cache_dtype or "compute",
                "counters": {k: v - base.get(k, 0) for k, v in now.items()
                             if v - base.get(k, 0) > 0},
            },
            "n_params": n_params,
        }
        if self._engine_stats is not None:
            out["serving"] = dataclasses.asdict(self._engine_stats)
        return out

    def __repr__(self):
        return (f"Session({self.cfg.name!r}, mode={self.spec.mode!r}, "
                f"device={str(self.device)!r}, P={self.rc.pp} "
                f"V={self.rc.vpp})")
