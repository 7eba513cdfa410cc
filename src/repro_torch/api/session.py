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
same way, with Mamba, attention and gathered-MoE layers;
``session("jamba-v0.1-52b", mode="train", reduced=False)`` trains them at
the published widths cut to two layers and eight experts
(``one_card_train_config()``): the selective scan runs K5 forward and K5b
backward, and the router's load-balance loss is seeded into each B task
(``describe()["last_step"]["aux_sum"]`` after a step). qwen2-moe-a2.7b
adds shared experts (a SwiGLU FFN every token runs beside the routed
ones); phi-3-vision-4.2b takes the vision stub's float patch embeddings
[b, s, d] as its ``tokens`` (the stream draws them; ``serve_prefill`` and
``serve_step_batched`` take them too; the engine takes token-id prompts).

Training on a mesh of ranks runs the same calls in every rank's process,
after ``torch.distributed.init_process_group`` (world size pods x data x
groups x pp; ``repro_torch.launch.train`` spawns the ranks and does it)::

    sess = repro_torch.api.session("llama3.2-1b", mode="train",
                                   reduced=False, data=2,
                                   overrides=dict(pp=2))
    sess = repro_torch.api.session("llama3.2-1b", mode="train",
                                   reduced=False, pods=2, data=2,
                                   overrides=dict(grad_compress="int8"))

``schedule="auto"`` runs the paper's §4 plan selection before the
runtime is built: every registered schedule and the two autogen
heuristics simulated under ``cost_preset`` (``"a800"``, the paper's
testbed), the minimum simulated makespan winning (under ``mem_budget``
when given); ``"auto_profiled"`` then times the ``profile_top_k`` best on
this session's device and mesh. The winner's table runs as it is
(``Runtime(plan=...)``); ``describe()["schedule"]`` reports its simulated
makespan, bubble ratio and collective profile and, for an auto session,
every candidate and the plan cache (``core/plan_cache.py``,
``~/.cache/repro_torch/plans.json``; ``REPRO_TORCH_PLAN_CACHE`` moves it,
``off`` disables it)::

    sess = repro_torch.api.session("gpt_paper", mode="train",
                                   reduced=False, schedule="auto",
                                   overrides=dict(pp=2, microbatches=8,
                                                  unit=4))

Each rank draws the same full tree from the seed and keeps its part
(``params.shard_for_rank``; every pod keeps the same); ``train_step``
takes the same global batch on every rank and returns this rank's grads
(summed over the pods); ``opt_step`` clips by the global norm.

Serving on a mesh runs the same way: every rank builds the same serve
session (``data``, ``pods``, ``overrides=dict(pp=..., groups=...)``)
and its own engine, and the serve step runs the forward-only table on
the tick engine (``core/executor.py serve_body``). Each rank holds its
part of the params and of the cache tree (its V stage slots, its slot
rows or its block of pages); every call takes the whole batch, the same
on every rank, and returns the whole batch's tokens (and logits). The
ranks' engines must run in lockstep: each serve step, slot reset, page
reset and page copy first checks that every rank is making the same
call with the same arrays (a sha256 gathered over the mesh) and raises
``SessionError`` if not. A serve session spans ranks when pods, data
or groups is above 1; with pp > 1 alone it runs on one rank, walking
the stages, whatever process group exists::

    sess = repro_torch.api.session("llama3.2-1b", mode="serve",
                                   reduced=False, data=2, max_slots=8,
                                   max_seq=2048, overrides=dict(pp=2))
    eng = sess.serve_engine(sess.init_params())

Checkpoints, in the reference's on-disk format (``ckpt/checkpoint.py``):
``checkpointing(dir, every=50)`` gives the fault-tolerance
``TrainController`` (on a mesh it saves collectively and restores this
rank's part), ``adopt_state`` puts its restored ``{"params", "opt"}``
on the device, and ``restore_params(dir)`` / ``adopt_params(tree)``
boot params from a train checkpoint, e.g. a serve session's::

    ctl = sess.checkpointing("ckpt", every=50)
    state, history = ctl.run(build, total_steps)
    params = repro_torch.api.session("llama3.2-1b", max_seq=2048,
                                     overrides=dict(pp=1)
                                     ).restore_params("ckpt")

The device is ``device="cuda"`` (the default, which raises when no GPU is
present; on a mesh, card ``local rank % device count``) or
``device="cpu"`` (the tests). Batches arrive as numpy arrays and move to
the device here; serve tokens and logits come back as CPU tensors, which
``np.asarray`` reads. Caches stay on the device and are updated in place
(``core/serve.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import types

import numpy as np
import torch

from repro_torch.api.spec import AUTO_MODES, SessionError, SessionSpec
from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    MeshLayout,
    flatten,
    unflatten,
)
from repro_torch.core import serve as CS
from repro_torch.core.comm import Mesh
from repro_torch.core.pipeline import (
    Runtime,
    make_serve_step,
    make_train_step,
    serve_tiling,
)
from repro_torch.core.plan import (
    COLLECTIVE_ALPHA_BETA,
    PlanAnalysis,
    fused_cost_model,
    plan_cache_info,
    preset_cost_model,
    select_plan,
    table_digest,
)
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.common import ShapeConfig, torch_dtype
from repro_torch.optim import adamw
from repro_torch.params import (
    from_reference,
    init_all_params,
    shard_for_rank,
)
from repro_torch.runtime.fault_tolerance import (
    FaultToleranceConfig,
    TrainController,
)

_OPT_FIELDS = {f.name for f in dataclasses.fields(adamw.AdamWConfig)}


def _as_tensor(a) -> torch.Tensor:
    """A leaf as a tensor (numpy arrays, bfloat16 ones too, as their
    bits)."""
    return a if isinstance(a, torch.Tensor) else from_reference(a, "cpu")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


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
        self.pods_size = spec.pods or 1
        world = self.pods_size * self.data_size * self.rc.groups \
            * self.rc.pp
        self.device = torch.device(spec.device)
        mesh = None
        # a serve session spans ranks when a pods, data or groups axis
        # does; pp alone walks its stages on one rank
        on_mesh = world > 1 and (spec.mode == "train"
                                 or world > self.rc.pp)
        if on_mesh:
            if spec.device == "cuda":
                self.device = _rank_card()
                torch.cuda.set_device(self.device)
            try:
                mesh = Mesh(self.data_size, self.rc.pp, self.rc.groups,
                            self.device, pods=self.pods_size)
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
        # schedule="auto" / "auto_profiled": the §4 plan selection runs
        # here, so the runtime and the rest of the session see a concrete
        # schedule name and its plan
        self.plan_selection = None
        self._plan_key = None
        self._plan_source = None   # memory-hit | persisted-hit | search |
        #                            search+measured: THIS construction's
        #                            lookup outcome, for describe()
        if self.rc.schedule in AUTO_MODES:
            self.plan_selection = self._auto_select(
                profiled=self.rc.schedule == "auto_profiled")
            self.rc = dataclasses.replace(
                self.rc, schedule=self.plan_selection.selected.name)
        if spec.mode == "train" or mesh is not None:
            try:
                self.rt = Runtime(
                    self.cfg, self.rc, self.device, mesh,
                    plan=(self.plan_selection.selected
                          if self.plan_selection is not None else None))
            except ValueError as e:
                raise SessionError(str(e)) from e
        else:
            # the engine reads rt.G (page partitions per FSDP group)
            self.rt = types.SimpleNamespace(G=self.rc.groups)
        self._serve_steps: dict = {}
        self._rope = None
        self._engine_stats = None   # serving EngineStats (engine attaches)
        self._last_metrics = None   # the last train_step's metrics
        self._fault_tolerance = None  # a TrainController (attach())
        # baseline for the per-session dispatch counters (process-wide)
        self._kernel_counter_base = ops.kernel_counters()

    # ------------------------------------------------------------------ #
    # Schedule-plan selection (schedule="auto" / "auto_profiled")
    # ------------------------------------------------------------------ #

    def _cost_shape(self) -> tuple[int, int, int]:
        """(seq, mbs, dp) for the cost model. The port always knows its
        data axis (``data=``, default 1), so dp is that, not the
        reference's guess of 8 for a session whose mesh is not built
        yet; mbs is the train shape's sequences a micro-batch. A serve
        session has no train shape: seq is its ``max_seq`` and mbs 1, as
        the reference's serve session reads them."""
        if self.spec.mode == "serve":
            return self.spec.seq_len or self.spec.max_seq or 32, 1, \
                self.data_size
        sc, rc = self.shape_cfg, self.rc
        per_mb = self.pods_size * self.data_size * rc.groups \
            * rc.microbatches
        return sc.seq_len, max(sc.global_batch // per_mb, 1), \
            self.data_size

    def _coll_counts(self, seg) -> tuple[int, int]:
        """(per-gather-tick, per-reduce-tick) collective counts for the
        α–β cost model — 1 each under the flat-segment layout, the
        gatherable tensor count under per-tensor collectives (the
        reference's rule: a tensor whose FSDP dim divides by dp); none
        under ``serve_resident``."""
        if self.rc.serve_resident:
            return 0, 0
        _, _, dp = self._cost_shape()
        n_gath = n_repl = 0
        for sp in M.stage_specs(self.cfg, seg).values():
            if sp.shape and sp.shape[sp.fsdp_dim] % dp == 0:
                n_gath += 1
            else:
                n_repl += 1   # replicated: summed per tensor on reduce
        if n_gath == 0:
            return 0, n_repl
        if self.rc.coalesce == "flat":
            return 1, 1 + n_repl
        return n_gath, n_gath + n_repl

    def _cost_model(self, vpp: int):
        seq, mbs, dp = self._cost_shape()
        n_g, n_r = self._coll_counts(self.geo.segments[-1])
        return preset_cost_model(
            self.spec.cost_preset, self.cfg, P=self.rc.pp, V=vpp,
            seq=seq, mbs=mbs, dp=dp, n_coll_gather=n_g, n_coll_reduce=n_r)

    def _sync_max(self):
        """x -> its maximum over the mesh's ranks (None on one rank)."""
        if self.mesh is None:
            return None
        comm = self.mesh.world_comm

        def sync(x: float) -> float:
            t = torch.tensor([x], dtype=torch.float64, device=self.device)
            return float(comm.all_reduce(t, op="max")[0])
        return sync

    def _auto_select(self, profiled: bool = False):
        """Simulate every registered schedule (+ the §4 autogen
        heuristics) for this (arch × shape × mesh) and pick the
        minimum-makespan plan — or, ``profiled``, the minimum *measured*
        step among the top-K simulated survivors. Selections are cached
        process-wide on the key below and persisted on disk by rank 0
        (``core/plan_cache.py``). The arch component names the depth and
        width too, since ``layers=`` cuts a config of the same name. On a
        mesh every rank selects alike and the ranks then check that they
        hold the same winner and table."""
        rc = self.rc
        seg = self.geo.segments[-1]
        seq, mbs, dp = self._cost_shape()
        preset = self.spec.cost_preset
        cfg = self.cfg
        # component order mirrors plan.SELECT_KEY_SCHEMA
        key = (f"{cfg.name}/L{cfg.n_layers}/d{cfg.d_model}", rc.pp,
               seg.vpp, rc.groups, rc.microbatches, rc.unit_size,
               rc.gather_prefetch, seq, mbs, dp, self.pods_size, preset,
               rc.coalesce, rc.grad_compress, rc.moe_mode,
               self.spec.mem_budget, rc.schedule,
               self.spec.profile_top_k if profiled else None)
        self._plan_key = key
        sync = self._sync_max()
        measure = self._build_measure_fn(sync) if profiled else None
        before = plan_cache_info()
        try:
            sel = select_plan(
                rc.pp, seg.vpp, rc.microbatches, rc.unit_size,
                self._cost_model(seg.vpp), preset=preset,
                prefetch=rc.gather_prefetch, cache_key=key,
                mem_budget=self.spec.mem_budget, measure_fn=measure,
                top_k=self.spec.profile_top_k,
                profile_budget_s=self.spec.profile_budget_s,
                persist=True,
                store=self.mesh is None or self.mesh.rank == 0, sync=sync)
        except RuntimeError as e:
            raise SessionError(str(e)) from e
        after = plan_cache_info()
        if after["hits"].get(key, 0) > before["hits"].get(key, 0):
            self._plan_source = "memory-hit"
        elif after["disk_hits"].get(key, 0) > \
                before["disk_hits"].get(key, 0):
            self._plan_source = "persisted-hit"
        else:
            self._plan_source = sel.provenance
        if self.mesh is not None:
            self._check_same_plan(sel)
        return sel

    def _check_same_plan(self, sel) -> None:
        """Every rank holds the same winner: its name and a sha256 of its
        table's arrays, all-gathered over the mesh."""
        mine = (sel.selected.name, table_digest(sel.selected.table))
        every = [None] * self.mesh.world
        torch.distributed.all_gather_object(every, mine)
        if any(x != mine for x in every):
            raise SessionError(
                f"the ranks selected different plans: {every} (name, "
                "table sha256 by rank)")

    def _build_measure_fn(self, sync=None):
        """The auto_profiled fine pass: ``measure_fn(plan) -> us/step``.

        Each candidate gets its own Runtime (same mesh, same params and
        batch — the parameter layout does not depend on the schedule)
        with the plan injected: one warm-up step, then the median of 3
        timed ``train_step`` calls (CUDA events after a synchronize on
        the card, ``time.perf_counter`` on the CPU). On a mesh the time
        is the maximum over the ranks and a failure on any rank fails
        the candidate on every rank (``sync``), so that all ranks go on
        measuring the same candidates. Only called on a cache miss."""
        state: dict = {}
        cuda = self.device.type == "cuda"

        def once(plan) -> float:
            rc = dataclasses.replace(self.rc, schedule=plan.name)
            rt = Runtime(self.cfg, rc, self.device, self.mesh, plan=plan)
            step = make_train_step(rt, self.shape_cfg)
            if "params" not in state:
                gen = torch.Generator(device=self.device).manual_seed(0)
                full = init_all_params(self.cfg, rc, gen, self.device)
                state["params"] = full if self.mesh is None else \
                    shard_for_rank(rt, full, self.mesh.rank)
                state["batch"] = self.stream(seed=0).batch(0)
            run = lambda: step(state["params"], state["batch"])  # noqa
            run()   # warm-up
            times = []
            for _ in range(3):
                if cuda:
                    torch.cuda.synchronize(self.device)
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    run()
                    t1.record()
                    t1.synchronize()
                    times.append(t0.elapsed_time(t1) * 1e3)
                else:
                    t0 = time.perf_counter()
                    run()
                    times.append((time.perf_counter() - t0) * 1e6)
            return float(np.median(times))

        def measure(plan) -> float:
            err, us = None, 0.0
            try:
                us = once(plan)
            except Exception as e:  # noqa: BLE001 — agreed on below
                err = e
            failed = err is not None
            if sync is not None:
                us, failed = sync(us), sync(float(failed)) > 0
            if failed:
                raise RuntimeError(
                    f"{plan.name}: {err}" if err is not None else
                    f"{plan.name}: the step failed on another rank")
            return us

        return measure

    # ------------------------------------------------------------------ #
    # Geometry the engine reads
    # ------------------------------------------------------------------ #

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

    @property
    def _shards(self) -> int:
        return self.pods_size * self.data_size

    def check_slot_sharding(self) -> None:
        """On a mesh the serve step's micro-batch tiling must cover every
        slot row of a shard — rows beyond it would silently never be
        computed (the reference's check; the batch-sharded layout is
        checked when the session is built). One rank computes every row
        in one pass."""
        if self.mesh is None:
            return
        b_loc, Btot, mbs = serve_tiling(self.rt, self.max_slots)
        covered = self.rt.G * Btot * mbs
        if covered != b_loc:
            raise SessionError(
                f"max_slots ({self.max_slots}) gives {b_loc} slot rows "
                f"per data shard, but the serve step tiles them as "
                f"groups×microbatches×mbs = {self.rt.G}×{Btot}×{mbs}, "
                f"covering only {covered} — pick max_slots so "
                f"slots/(pods·data) is a multiple of "
                f"groups·min(microbatches, slots/(pods·data)), or "
                "adjust the microbatches override")

    def sampling_unsupported_reason(self) -> str | None:
        """None when the serve step can return full next-token logits (the
        host-side sampling layer's input); otherwise why it cannot (the
        reference's rule: not on a multi-pod mesh)."""
        if self.mesh is not None and self.rt.multi_pod:
            return ("logits return is not wired for multi-pod meshes "
                    f"(pods={self.pods_size})")
        return None

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
        """Zeroed caches on the device; on a mesh this rank's part: its V
        stage slots and its shard's slot rows, or its block of pages."""
        on_mesh = self.mesh is not None
        shards = self._shards if on_mesh else 1
        return CS.init_serve_caches(
            self.cfg, self.rc, self.geo, slots=self.max_slots // shards,
            max_seq=self._max_seq(), page_size=self.page_size,
            n_pages=self.n_pages // shards if self.paged else 0,
            device=self.device, stages=self.rc.vpp if on_mesh else None)

    def _lockstep(self, what: str, *arrays) -> None:
        """On a mesh: check that every rank makes the same call ``what``
        with the same arrays (a sha256 of their dtypes, shapes and bytes,
        gathered over the mesh); raise if any rank differs, before any
        collective of the call could pair with another call's."""
        if self.mesh is None:
            return
        h = hashlib.sha256(what.encode())
        for a in arrays:
            a = np.ascontiguousarray(np.asarray(a))
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
        mine = int.from_bytes(h.digest()[:8], "little", signed=True)
        every = self.mesh.world_comm.all_gather(torch.tensor(
            [mine], dtype=torch.int64, device=self.device)).cpu()
        if bool((every != mine).any()):
            raise SessionError(
                f"the ranks' serve calls left lockstep at {what}: rank "
                f"{self.mesh.rank} holds digest {mine}, the ranks hold "
                f"{every.tolist()}; every rank must see the same "
                "submissions in the same order")

    def _local(self, mask, per_shard: int) -> np.ndarray:
        """This rank's shard of a global mask (slot rows or pages)."""
        i = self.mesh.shard_of(self.mesh.rank)
        return np.asarray(mask, bool)[i * per_shard:(i + 1) * per_shard]

    def reset_slot_caches(self, caches, slot_mask):
        """Zero the cache rows of the slots flagged in ``slot_mask``
        [max_slots], in place (slot reclaim); on a mesh, this shard's."""
        if self.mesh is not None:
            self._lockstep("reset_slot_caches", slot_mask)
            slot_mask = self._local(slot_mask,
                                    self.max_slots // self._shards)
        return CS.reset_slot_caches(caches, self._index(slot_mask))

    def reset_pages(self, caches, page_mask):
        """Zero the pages flagged in ``page_mask`` [n_pages], in place; on
        a mesh, this shard's block of them."""
        if self.mesh is not None:
            self._lockstep("reset_pages", page_mask)
            page_mask = self._local(page_mask, self.n_pages // self._shards)
        return CS.reset_pages(caches, self._index(page_mask))

    def copy_pages(self, caches, src, dst):
        """Copy page ``src[i]`` -> ``dst[i]`` (global page ids) in every
        paged leaf, in place. On a mesh a pair across two pods × data
        shards is a send between the two ranks of this model index."""
        if self.mesh is None:
            return CS.copy_pages(caches, self._ids(src), self._ids(dst))
        self._lockstep("copy_pages", src, dst)
        m = self.mesh
        return CS.copy_pages_across(
            caches, src, dst, dev_pages=self.n_pages // self._shards,
            shard=m.shard_of(m.rank), exchange=m.exchange,
            peer=lambda i: m.rank_of(i % m.data, m.g_rank, m.p_rank,
                                     i // m.data))

    # ------------------------------------------------------------------ #
    # Training
    # ------------------------------------------------------------------ #

    @property
    def shape_cfg(self) -> ShapeConfig:
        """The train shape: ``seq_len`` (default 32) by ``global_batch``
        (default one sequence per micro-batch of every pipeline group of
        every data rank of every pod)."""
        if self._shape_cfg is None:
            sp = self.spec
            self._shape_cfg = ShapeConfig(
                "train", sp.seq_len or 32,
                sp.global_batch or (self.pods_size * self.data_size
                                    * self.rc.groups
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
        grads, metrics = self._train_step(params, batch)
        self._last_metrics = metrics
        return grads, metrics

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
        """The deterministic synthetic stream of the train shape: token
        ids, or for a vision config float patch embeddings [b, s, d]."""
        cfg, sc = self.cfg, self.shape_cfg
        return SyntheticStream(DataConfig(
            seq_len=sc.seq_len, global_batch=sc.global_batch,
            vocab=cfg.vocab, seed=seed,
            kind="vision" if cfg.frontend == "vision" else "lm",
            d_model=cfg.d_model))

    # ------------------------------------------------------------------ #
    # Checkpoints
    # ------------------------------------------------------------------ #

    def checkpointing(self, ckpt_dir: str, *, every: int = 50,
                      digest: bool = False, **kw) -> TrainController:
        """A fault-tolerance TrainController over this checkpoint dir
        (``kw``: the other :class:`FaultToleranceConfig` fields; ``digest``
        records each saved and restored state's sha256). On a mesh it
        saves collectively and restores this rank's part
        (:class:`MeshLayout`)."""
        try:
            cfg = FaultToleranceConfig(ckpt_every=every, **kw)
        except TypeError as e:
            raise SessionError(f"checkpointing: {e}") from e
        layout = None if self.mesh is None else MeshLayout(self.rt,
                                                           self.mesh)
        return TrainController(ckpt_dir, cfg, layout=layout, digest=digest)

    def param_shapes(self, part: bool = False) -> dict:
        """{leaf path: shape} of this session's params: the global tree,
        or with ``part`` this rank's part of it."""
        full = {"io": {n: torch.empty(sp.shape, device="meta")
                       for n, sp in M.io_specs(self.cfg).items()},
                "segments": {}}
        for seg in self.geo.segments:
            S = self.geo.seg_stages(seg)
            full["segments"][seg.name] = {
                n: torch.empty((S,) + sp.shape, device="meta")
                for n, sp in M.stage_specs(self.cfg, seg).items()}
        if part and self.mesh is not None:
            full = shard_for_rank(self.rt, full, self.mesh.rank)
        return {k: tuple(t.shape) for k, t in flatten(full).items()}

    @staticmethod
    def _checked(tree, want: dict, what: str) -> dict:
        """The leaves of ``tree`` at ``want``'s paths ({path: shape}); a
        missing leaf or one of another shape raises, naming it."""
        got = flatten(tree)
        missing = sorted(set(want) - set(got))
        if missing:
            raise SessionError(
                f"checkpoint is missing {what} leaves {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''}; was it written by "
                "another architecture?")
        for k, shape in want.items():
            if tuple(got[k].shape) != shape:
                raise SessionError(
                    f"{what} {k} has shape {tuple(got[k].shape)} in the "
                    f"checkpoint but this session needs {shape}: the mesh "
                    "and pipeline geometry (data, pp, vpp) must match the "
                    "trainer's")
        return {k: got[k] for k in want}

    def restore_params(self, ckpt_dir: str, *, step: int | None = None):
        """Boot this session's params from a train checkpoint (the
        train -> serve handoff): the tree is the params tree or nests it
        under ``"params"`` (the controller's state); the optimizer's
        leaves are not read. See :meth:`adopt_params`."""
        mgr = CheckpointManager(ckpt_dir)
        tree, _ = mgr.restore(step, select=lambda k: not k.startswith(
            "opt/"))
        if tree is None:
            raise SessionError(
                f"no checkpoint found under {ckpt_dir!r} "
                f"(steps: {mgr.list_steps()})")
        return self.adopt_params(tree)

    def adopt_params(self, tree):
        """A global params tree (host or device tensors or numpy arrays,
        bare or nested under ``"params"``) as this session's params:
        every leaf's shape checked against this session's geometry (a
        mismatch names the leaf), cast to the param dtype, cut to this
        rank's part on a mesh, on this session's device."""
        if "params" in tree and "io" not in tree:
            tree = tree["params"]
        if not ("io" in tree and "segments" in tree):
            raise SessionError(
                f"params tree has keys {sorted(tree)}; expected 'io' and "
                "'segments' (or a tree nested under 'params')")
        got = self._checked({"io": tree["io"], "segments": tree["segments"]},
                            self.param_shapes(), "param")
        dtype = torch_dtype(self.rc.param_dtype)
        full = unflatten({k: _as_tensor(a).to(dtype=dtype)
                          for k, a in got.items()})
        if self.mesh is not None:
            full = shard_for_rank(self.rt, full, self.mesh.rank)
        return _map(full, lambda t: t.to(self.device))

    def adopt_state(self, tree):
        """The controller's restored ``{"params", "opt"}`` tree (already
        this rank's part when restored by :meth:`checkpointing`'s) as
        this session's state on its device: params in the param dtype,
        ``master`` in float32, moments in the moment dtype, ``step`` an
        int; leaf shapes checked against this rank's parts."""
        want = self.param_shapes(part=True)
        mdt = torch_dtype(self.opt_config()[0].moment_dtype)
        opt = tree["opt"]
        out = {"opt": {"step": int(opt["step"])}}
        for name, sub, dtype in (
                ("params", tree["params"], torch_dtype(self.rc.param_dtype)),
                ("master", opt["master"], torch.float32),
                ("m", opt["m"], mdt), ("v", opt["v"], mdt)):
            got = self._checked(sub, want, name)
            dev = unflatten({k: t.to(self.device, dtype)
                             for k, t in got.items()})
            (out if name == "params" else out["opt"])[name] = dev
        return out

    # ------------------------------------------------------------------ #
    # Serve steps
    # ------------------------------------------------------------------ #

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def _index(self, mask) -> torch.Tensor:
        return self._ids(np.flatnonzero(np.asarray(mask)))

    def _mesh_step(self, params, caches, batch, want_logits):
        """One serve step on the mesh's tick engine (``make_serve_step``,
        built once per prompt width and logits flag)."""
        self.check_slot_sharding()
        toks = np.asarray(batch["tokens"])
        self._lockstep("serve", toks, batch.get("pos", 0),
                       batch.get("slot_mask", False),
                       batch.get("page_tables", 0), want_logits)
        key = (toks.shape[1], want_logits)
        if key not in self._serve_steps:
            try:
                self._serve_steps[key] = make_serve_step(
                    self.rt, ShapeConfig("serve", self._max_seq(),
                                         self.max_slots, "decode"),
                    prompt_len=toks.shape[1], max_seq=self._max_seq(),
                    page_size=self.page_size, want_logits=want_logits,
                    rope=self._rope)
            except ValueError as e:
                raise SessionError(str(e)) from e
        res = self._serve_steps[key](params, caches, batch)
        if want_logits:
            tok, logits, caches = res
            return tok.cpu(), logits.cpu(), caches
        tok, caches = res
        return tok.cpu(), caches

    def _step(self, params, caches, batch, want_logits):
        """Move a numpy batch to the device and run one serve step."""
        if self._rope is None:
            self._rope = CS.rope_for(self.cfg, self._max_seq(), self.device)
        if self.mesh is not None:
            return self._mesh_step(params, caches, batch, want_logits)
        dev = self.device
        toks = torch.as_tensor(np.asarray(batch["tokens"]))
        # token ids, or a vision prefill's float embeddings [b, s, d]
        tb = {"tokens": toks.to(device=dev, dtype=(
            torch.float32 if toks.is_floating_point() else torch.int32))}
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
        """Run a prompt (scalar ``pos``, every row) through the stages:
        ``tokens`` ids [b, s], or for a vision config float patch
        embeddings [b, s, d]; returns (tokens, caches)."""
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
        ``tokens`` ids [max_slots, s] or float embeddings [max_slots, s,
        d] (a vision prefill), ``pos`` int32 [max_slots] (each slot's
        first position), optional ``slot_mask`` bool [max_slots] gating
        cache writes, and for paged sessions ``page_tables`` int32
        [max_slots, pages_per_slot].
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
                "data": self.data_size, "pods": self.pods_size,
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
                           "backend": m.backend, "pod": m.pod_rank,
                           "data_rank": m.d_rank,
                           "group": m.g_rank, "stage_rank": m.p_rank,
                           "vocab_shard": self.rt.vloc}
        if self.spec.mode == "train":
            sc = self.shape_cfg
            out["schedule"] = self._describe_schedule()
            out["shape"] = {"seq_len": sc.seq_len,
                            "global_batch": sc.global_batch}
        elif self.plan_selection is not None:
            # the reference's report of a serve session's selection; it
            # changes nothing served: the serve step runs the
            # forward-only table whatever the selection picked
            out["schedule"] = dict(self._describe_schedule(),
                                   serve_table="fwd_only")
        if self._last_metrics is not None:
            # the last train step's metrics: the loss, the router's
            # auxiliary losses (aux_sum; 0 for a dense model) and the
            # embedding rows dropped
            m = self._last_metrics
            out["last_step"] = {"loss_sum": float(m["loss_sum"]),
                                "aux_sum": float(m["aux_sum"]),
                                "emb_dropped": int(m["emb_dropped"])}
        if self._engine_stats is not None:
            out["serving"] = dataclasses.asdict(self._engine_stats)
        if self._fault_tolerance is not None:
            out["fault_tolerance"] = self._fault_tolerance.summary()
        return out

    def _describe_schedule(self) -> dict:
        """The plan this session runs and its simulated cost under the
        session's preset (seconds of the cost model, not of a card); for
        an auto session also every candidate and the plan cache's
        state, with the reference's keys."""
        rc = self.rc
        sel = self.plan_selection
        plan = sel.selected if sel is not None else self.rt.plans["main"]
        pt = plan.packed
        if sel is not None:
            ana = sel.analysis
        else:
            cm = self._cost_model(rc.vpp)
            ana = plan.analyze(cm if plan.has_w else fused_cost_model(cm),
                               preset=self.spec.cost_preset)
        alpha, beta = COLLECTIVE_ALPHA_BETA[self.spec.cost_preset]
        a2a_alpha, a2a_beta = COLLECTIVE_ALPHA_BETA[
            f"{self.spec.cost_preset}:a2a"]
        n_g, n_r = self._coll_counts(self.geo.segments[-1])
        sched = {
            "name": plan.name, "microbatches": rc.microbatches,
            "unit": pt.U, "vpp": rc.vpp, "ticks": pt.T,
            "prefetch": pt.prefetch, "counts": plan.table.counts(),
            "coalesce": rc.coalesce, "grad_compress": rc.grad_compress,
            "preset": ana.preset,
            "makespan": ana.makespan,
            "bubble_ratio": ana.bubble_frac,
            "peak_mem": ana.peak_mem,
            "gathers_per_rank": ana.gathers_per_rank,
            "reduces": ana.n_reduce,
            "comm_frac": ana.comm_frac,
            # the stash depth this plan's tables claim (U for
            # zeropp/autogen_gated, n_mb for full-depth schedules)
            "stash_depth": plan.table.unit,
            "rs_overlap": {"exposed_s": ana.rs_exposed,
                           "saved_s": ana.rs_overlap_saved},
            # α–β collective profile; the EP all-to-all terms stay 0
            # until expert parallelism (ROADMAP.md queue 1 item 7)
            "collectives": {
                "coalesce": rc.coalesce,
                "per_gather_tick": n_g,
                "per_reduce_tick": n_r,
                "alpha_s": alpha,
                "beta_s_per_byte": beta,
                "moe_mode": rc.moe_mode,
                "a2a_per_f_tick": 0,
                "a2a_per_b_tick": 0,
                "a2a_bytes": 0.0,
                "a2a_alpha_s": a2a_alpha,
                "a2a_beta_s_per_byte": a2a_beta,
                "a2a_t_event_s": ana.t_a2a,
                "a2a_total_s": ana.a2a_total,
            },
        }
        sel = self.plan_selection
        if sel is None:
            return sched

        def cand(a):
            if not isinstance(a, PlanAnalysis):
                return str(a)
            d = {"makespan": a.makespan, "peak_mem": a.peak_mem,
                 "stash_depth": a.stash_depth,
                 "rs_overlap_saved": a.rs_overlap_saved}
            if a.measured_us is not None:
                d["measured_us"] = a.measured_us
            return d

        sched["auto"] = {
            "selected": sel.selected.name,
            "mem_budget": sel.mem_budget,
            "provenance": {"selection": sel.provenance,
                           "this_session": self._plan_source},
            "candidates": {n: cand(a) for n, a in sel.candidates.items()},
        }
        if sel.measured:
            sched["auto"]["measured"] = dict(sel.measured)
        if sel.profile:
            sched["auto"]["profile"] = dict(sel.profile)
        info = plan_cache_info()
        key = self._plan_key
        sched["cache"] = {
            "key": repr(key),
            "hits": info["hits"].get(key, 0),
            "disk_hits": info["disk_hits"].get(key, 0),
            "misses": info["misses"],
            "simulate_calls": info["simulate_calls"],
            "measure_calls": info["measure_calls"],
            "entries": info["entries"],
            "persisted": info["persisted"],
        }
        return sched

    def __repr__(self):
        return (f"Session({self.cfg.name!r}, mode={self.spec.mode!r}, "
                f"device={str(self.device)!r}, P={self.rc.pp} "
                f"V={self.rc.vpp})")
