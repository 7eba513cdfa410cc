"""The Session facade of the port: training and serving.

The port's counterpart of ``repro/api/session.py``. Training::

    sess = repro_torch.api.session("llama3.2-1b", mode="train",
                                   reduced=False, seq_len=2048)
    params = sess.init_params()
    opt = sess.init_opt_state(params)
    grads, metrics = sess.train_step(params, sess.stream().batch(0))
    params, opt, om = sess.opt_step(params, grads, opt)

Serving — everything :class:`repro_torch.serving.ServeEngine` reads::

    sess = repro_torch.api.session("llama3.2-1b", max_slots=8,
                                   max_seq=2048, reduced=False)
    eng = sess.serve_engine(sess.init_params())

``session("jamba-v0.1-52b", reduced=False, max_slots=8, max_seq=2048)``
serves Jamba's published widths at depth 8 (``one_card_config()``) the
same way, with Mamba, attention and gathered-MoE layers; Jamba trains in
a later slice (a train session raises ``SessionError``).

Training on a mesh of ranks runs the same calls in every rank's process,
after ``torch.distributed.init_process_group`` (world size data x groups
x pp; ``repro_torch.launch.train`` spawns the ranks and does it)::

    sess = repro_torch.api.session("llama3.2-1b", mode="train",
                                   reduced=False, data=2,
                                   overrides=dict(pp=2))

Each rank draws the same full tree from the seed and keeps its part
(``params.shard_for_rank``); ``train_step`` takes the same global batch
on every rank and returns this rank's grads; ``opt_step`` clips by the
global norm. Serving runs on one rank.

The device is ``device="cuda"`` (the default, which raises when no GPU is
present; on a mesh, card ``local rank % device count``) or
``device="cpu"`` (the tests). Batches arrive as numpy arrays and move to
the device here; serve tokens and logits come back as CPU tensors, which
``np.asarray`` reads. Caches stay on the device and are updated in place
(``core/serve.py``).
"""

from __future__ import annotations

import dataclasses
import os
import types

import numpy as np
import torch

from repro_torch.api.spec import SessionError, SessionSpec
from repro_torch.core import serve as CS
from repro_torch.core.comm import Mesh
from repro_torch.core.pipeline import Runtime, make_train_step
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.common import ShapeConfig
from repro_torch.optim import adamw
from repro_torch.params import init_all_params, shard_for_rank

_OPT_FIELDS = {f.name for f in dataclasses.fields(adamw.AdamWConfig)}
_CKPT = ("checkpoints (ckpt/checkpoint.py) and the fault-tolerance "
         "controller wait for the checkpoint slice (ROADMAP.md queue 1)")


def session(arch: str, *, mode: str = "serve", overrides=None,
            **kw) -> "Session":
    """Build a validated Session. See SessionSpec for every knob."""
    return Session(SessionSpec(arch=arch, mode=mode,
                               overrides=dict(overrides or {}), **kw))


def _rank_card() -> torch.device:
    """This rank's card: local rank modulo the host's device count."""
    dist = torch.distributed
    rank = os.environ.get("LOCAL_RANK")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(rank) % torch.cuda.device_count())


class Session:
    """A bound (arch × RunConfig × device) with its train or serve
    steps."""

    def __init__(self, spec: SessionSpec):
        self.spec = spec.validate()
        self.arch_mod, self.cfg, self.rc = spec.resolve_configs()
        if spec.device == "cuda" and not torch.cuda.is_available():
            raise SessionError(
                "device='cuda' but torch finds no GPU; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        self.data_size = spec.data or 1
        world = self.data_size * self.rc.groups * self.rc.pp
        self.device = torch.device(spec.device)
        mesh = None
        if spec.mode == "train" and world > 1:
            if spec.device == "cuda":
                self.device = _rank_card()
                torch.cuda.set_device(self.device)
            try:
                mesh = Mesh(self.data_size, self.rc.pp, self.rc.groups,
                            self.device)
            except ValueError as e:
                raise SessionError(str(e)) from e
        self.mesh = mesh
        try:
            self.geo = M.build_geometry(self.cfg, self.rc)
        except NotImplementedError as e:    # unported model features
            raise SessionError(str(e)) from e
        except ValueError as e:
            raise SessionError(
                f"invalid geometry for {spec.arch!r}: {e}. Adjust the "
                "pp/vpp overrides.") from e
        for seg in self.geo.segments:   # unported layer kinds fail here
            M.stage_specs(self.cfg, seg)
        self._shape_cfg = None
        self._train_step = None
        if spec.mode == "train":
            try:
                self.rt = Runtime(self.cfg, self.rc, self.device, mesh)
            except ValueError as e:
                raise SessionError(str(e)) from e
        else:
            # the engine reads rt.G (page partitions per FSDP group)
            self.rt = types.SimpleNamespace(G=self.rc.groups)
        self._rope = None
        self._engine_stats = None   # serving EngineStats (engine attaches)
        # baseline for the per-session dispatch counters (process-wide)
        self._kernel_counter_base = ops.kernel_counters()

    # ------------------------------------------------------------------ #
    # Geometry the engine reads
    # ------------------------------------------------------------------ #

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
        generator is given); on a mesh, this rank's part of the full tree
        that every rank draws alike."""
        full = init_all_params(self.cfg, self.rc, generator, self.device)
        if self.mesh is None:
            return full
        return shard_for_rank(self.rt, full, self.mesh.rank)

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
    # Training
    # ------------------------------------------------------------------ #

    @property
    def shape_cfg(self) -> ShapeConfig:
        """The train shape: ``seq_len`` (default 32) by ``global_batch``
        (default one sequence per micro-batch of every pipeline group of
        every data rank)."""
        if self._shape_cfg is None:
            sp = self.spec
            self._shape_cfg = ShapeConfig(
                "train", sp.seq_len or 32,
                sp.global_batch or (self.data_size * self.rc.groups
                                    * self.rc.microbatches), "train")
        return self._shape_cfg

    def _need_train(self, what: str) -> None:
        if self.spec.mode != "train":
            raise SessionError(f"{what} needs a mode='train' session")

    def train_step(self, params, batch):
        """One pipeline step on the schedule's tick table; returns (grads,
        metrics): float32 grads shaped like params (this rank's), metrics
        ``loss_sum`` (the step's mean token loss), ``aux_sum`` and
        ``emb_dropped`` (summed over the mesh). ``batch`` is the global
        batch, the same on every rank."""
        self._need_train("train_step")
        if self._train_step is None:
            try:
                self._train_step = make_train_step(self.rt, self.shape_cfg)
            except ValueError as e:
                raise SessionError(str(e)) from e
        return self._train_step(params, batch)

    def opt_config(self):
        """(AdamWConfig, use_lr_schedule, warmup, total) from spec.optim."""
        kw = dict(self.spec.optim)
        use_sched = "warmup" in kw or "total" in kw
        warmup = kw.pop("warmup", 100)
        total = kw.pop("total", 10_000)
        bad = sorted(set(kw) - _OPT_FIELDS)
        if bad:
            raise SessionError(
                f"unknown optim option(s) {bad}; valid: warmup, total, "
                f"{', '.join(sorted(_OPT_FIELDS))}")
        kw.setdefault("moment_dtype", self.rc.opt_moment_dtype)
        return adamw.AdamWConfig(**kw), use_sched, warmup, total

    def init_opt_state(self, params):
        """Float32 master weights and zero moments for ``params``."""
        return adamw.init_state(params, self.opt_config()[0])

    def opt_step(self, params, grads, opt_state):
        """One AdamW update (in place); returns (params, opt_state,
        metrics) with ``grad_norm`` (of the global gradient) and ``lr``."""
        cfg, use_sched, warmup, total = self.opt_config()
        scale = adamw.lr_schedule(opt_state["step"], base_lr=1.0,
                                  warmup=warmup, total=total) \
            if use_sched else 1.0
        mesh = {}
        if self.mesh is not None:
            mesh = dict(owned=self.rt.owned(),
                        all_reduce=self.mesh.world_comm.all_reduce)
        return adamw.apply_updates(params, grads, opt_state, cfg, scale,
                                   **mesh)

    def stream(self, seed: int = 0) -> SyntheticStream:
        """The deterministic synthetic token stream of the train shape."""
        sc = self.shape_cfg
        return SyntheticStream(DataConfig(
            seq_len=sc.seq_len, global_batch=sc.global_batch,
            vocab=self.cfg.vocab, seed=seed))

    def checkpointing(self, ckpt_dir: str, **kw):
        raise SessionError(_CKPT)

    def restore_params(self, ckpt_dir: str, **kw):
        raise SessionError(_CKPT)

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
                "data": self.data_size,
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
        if self.mesh is not None:
            m = self.mesh
            out["mesh"] = {"rank": m.rank, "world": m.world,
                           "backend": m.backend, "data_rank": m.d_rank,
                           "group": m.g_rank, "stage_rank": m.p_rank,
                           "vocab_shard": self.rt.vloc}
        if self.spec.mode == "train":
            plan = self.rt.plans["main"]
            pt = plan.packed
            sc = self.shape_cfg
            out["schedule"] = {
                "name": plan.name, "microbatches": rc.microbatches,
                "unit": pt.U, "vpp": rc.vpp, "ticks": pt.T,
                "prefetch": pt.prefetch, "counts": plan.table.counts(),
                "coalesce": rc.coalesce}
            out["shape"] = {"seq_len": sc.seq_len,
                            "global_batch": sc.global_batch}
        if self._engine_stats is not None:
            out["serving"] = dataclasses.asdict(self._engine_stats)
        return out

    def __repr__(self):
        return (f"Session({self.cfg.name!r}, mode={self.spec.mode!r}, "
                f"device={str(self.device)!r}, P={self.rc.pp} "
                f"V={self.rc.vpp})")
