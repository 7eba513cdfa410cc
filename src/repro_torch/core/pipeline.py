"""Runtime and the train- and serve-step builders of the port.

The port's counterpart of ``repro/core/pipeline.py``: ``Runtime`` builds
the segment's ``SchedulePlan`` (or adopts an injected one, e.g. the
winner of ``schedule="auto"``) and, once a serve step asks, the
forward-only serve plan (``plans["serve_main"]``), the parameter specs,
the gatherable sets (none under ``serve_resident``), the flat FSDP
layouts (``coalesce="flat"``; none for ``"none"``) and
the vocabulary shard for one rank of a pods x data x (groups x pp)
mesh; ``make_train_step`` wraps the executor's ``train_body`` into
``step(params, batch) -> (grads, metrics)`` and ``make_serve_step`` the
executor's ``serve_body`` into ``step(params, caches, batch) ->
(tokens, [logits,] caches)`` (``serve_tiling`` splits a rank's slot
rows into groups x micro-batches x rows). The batch is sharded over
(pod, data): a rank takes shard ``pod * data + d`` of ``pods * data``;
a serve batch must split evenly (the batch-sharded cache layout; the
reference's sequence-sharded fallback is not ported). Without a mesh
one rank holds one pipeline group (pp = data = groups = pods = 1) and
the data axis is
:class:`repro_torch.core.fsdp.LocalComm`; with a live
:class:`repro_torch.core.comm.Mesh` it is the mesh's data communicator
(the D ranks of one pod). A :class:`repro_torch.core.comm.MeshShape` alone gives the
layout without collectives (cutting and re-assembling trees,
``repro_torch.params``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fsdp
from repro_torch.core import vocab as Vb
from repro_torch.core.comm import Mesh, MeshShape
from repro_torch.core import serve as CS
from repro_torch.core.executor import serve_body, train_body
from repro_torch.core.generators import SchedParams
from repro_torch.core.plan import (
    UNIT_GATED_SCHEDULES,
    PackedTable,
    SchedulePlan,
)
from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig, RunConfig

GRAD_COMPRESS = ("none", "int8")
COALESCE = ("flat", "none")


class Runtime:
    """Plans, specs, flat layouts and the vocabulary shard for one
    (ModelConfig, RunConfig) on one rank of ``mesh``.

    ``plan`` (optional) injects a pre-selected :class:`SchedulePlan` —
    e.g. the winner of ``schedule="auto"``, whose table was generated
    under a cost preset — which is used as it is (re-packed only for
    another gather prefetch), never regenerated from its name; its
    table's unit sets the stash depth."""

    def __init__(self, cfg: ModelConfig, rc: RunConfig, device,
                 mesh: MeshShape | None = None,
                 plan: SchedulePlan | None = None):
        self.cfg, self.rc = cfg, rc
        self.device = torch.device(device)
        self.geo = M.build_geometry(cfg, rc)
        self.shape = mesh if mesh is not None else MeshShape(1, 1, 1)
        # collectives only on a live mesh of several ranks
        self.mesh = mesh if isinstance(mesh, Mesh) and mesh.world > 1 \
            else None
        self.dsize = self.shape.data
        self.Pe, self.G = rc.pp, rc.groups
        if (self.shape.pp, self.shape.groups) != (self.Pe, self.G):
            raise ValueError(
                f"pp={rc.pp}, groups={rc.groups} on a mesh of pp="
                f"{self.shape.pp}, groups={self.shape.groups}: several "
                "ranks need a mesh of the same shape (torch.distributed; "
                "repro_torch.launch.train spawns one)")
        if rc.coalesce not in COALESCE:
            raise ValueError(f"coalesce={rc.coalesce!r}: pick one of "
                             f"{COALESCE}")
        if rc.grad_compress not in GRAD_COMPRESS:
            raise ValueError(f"grad_compress={rc.grad_compress!r}: pick "
                             f"one of {GRAD_COMPRESS}")
        self.comm = (self.mesh.data_comm if self.mesh is not None
                     else fsdp.LocalComm())
        self.rank = self.mesh.rank if self.mesh is not None else 0
        _, self.g_rank, self.p_rank = self.shape.coords(self.rank)
        self.vloc = Vb.vocab_shard(cfg.vocab, self.dsize)
        self.segs = {s.name: s for s in self.geo.segments}
        # scheduling units only gate ZeroPP-family schedules; the others
        # keep the whole batch live, so their stashes are n_mb deep. The
        # engine sizes its stashes by the plan's own table (packed.U), so
        # an injected plan keeps the unit it was generated at
        unit = (rc.unit_size if rc.schedule in UNIT_GATED_SCHEDULES
                else rc.microbatches)
        sp = SchedParams(P=rc.pp, V=rc.vpp, n_mb=rc.microbatches,
                         unit=unit)
        self.plans = {"main": (
            self._adopt(plan, sp) if plan is not None else
            SchedulePlan.build(rc.schedule, sp,
                               prefetch=rc.gather_prefetch))}
        self.sp = sp
        self.multi_pod = self.shape.pods > 1
        self.io_specs = M.io_specs(cfg)
        self.stage_specs = {s.name: M.stage_specs(cfg, s)
                            for s in self.geo.segments}
        # weight-resident serving (the reference's serve_resident): every
        # stage tensor stays whole on each rank, so no tick gathers and a
        # train step all-reduces the stage grads over the data axis
        self.gatherable = {
            sname: [] if rc.serve_resident else
            sorted(n for n, sp_ in sps.items()
                   if fsdp.local_dim(sp_, self.dsize) is not None)
            for sname, sps in self.stage_specs.items()}
        self.flat_layouts = {
            sname: (fsdp.build_flat_layout(self.stage_specs[sname],
                                           self.gatherable[sname],
                                           self.dsize)
                    if rc.coalesce == "flat" else None)
            for sname in self.stage_specs}

    def _adopt(self, plan: SchedulePlan, sp: SchedParams) -> SchedulePlan:
        """Validate an injected plan against this runtime's geometry and
        re-pack it for this runtime's gather-prefetch depth."""
        pp = plan.params
        if (pp.P, pp.V, pp.n_mb) != (sp.P, sp.V, sp.n_mb):
            raise ValueError(
                f"injected plan {plan.name!r} was built for "
                f"(P={pp.P}, V={pp.V}, B={pp.n_mb}) but this runtime "
                f"needs (P={sp.P}, V={sp.V}, B={sp.n_mb})")
        return plan.with_prefetch(self.rc.gather_prefetch)

    def serve_plan(self) -> SchedulePlan:
        """The forward-only serve table, ``plans["serve_main"]``, built
        when a serve step first asks for it (a train runtime never
        does): not unit-gated, its wires hold every micro-batch."""
        if "serve_main" not in self.plans:
            self.plans["serve_main"] = SchedulePlan.build(
                "fwd_only",
                dataclasses.replace(self.sp, unit=self.rc.microbatches),
                prefetch=self.rc.gather_prefetch)
        return self.plans["serve_main"]

    @property
    def tables(self) -> dict[str, PackedTable]:
        return {k: p.packed for k, p in self.plans.items()}

    def io_sharded(self, name: str) -> bool:
        """Whether io param ``name`` is cut into vocabulary shards."""
        return self.vloc is not None and name in Vb.SHARDED

    def local_dim(self, sname: str, n: str) -> int | None:
        """The dim of stage tensor ``n`` cut over the data axis, or None
        where each data rank holds it whole (a dim the axis does not
        divide, or ``serve_resident``)."""
        return (fsdp.local_dim(self.stage_specs[sname][n], self.dsize)
                if n in self.gatherable[sname] else None)

    def local_shape(self, sname: str, n: str) -> tuple[int, ...]:
        """This rank's shape of stage tensor ``n`` (one stage block)."""
        sp_ = self.stage_specs[sname][n]
        return (fsdp.local_shape(sp_, self.dsize)
                if n in self.gatherable[sname] else tuple(sp_.shape))

    def owned(self) -> dict[str, bool]:
        """{keystr path: whether this rank's copy counts in the global
        norm}: every element of the global gradient exactly once. Pods
        replicate everything (pod 0 counts); stage rows are duplicated
        across groups (group 0 counts) and replicated over the data axis
        when not gatherable (data index 0 counts); io params are
        replicated over the model axis (model index 0 counts) and, unless
        vocabulary-sharded, over the data axis."""
        d, g, p = self.shape.coords(self.rank)
        first = self.shape.pod_of(self.rank) == 0
        out = {f"['io']['{n}']": first and g == p == 0 and (
            d == 0 or self.io_sharded(n)) for n in self.io_specs}
        for sname, sps in self.stage_specs.items():
            for n in sps:
                out[f"['segments']['{sname}']['{n}']"] = first and g == 0 \
                    and (d == 0 or n in self.gatherable[sname])
        return out


def make_train_step(rt: Runtime, shape_cfg):
    """Returns step(params, batch) -> (grads, metrics). ``batch`` holds
    the global ``tokens`` and ``labels`` [global_batch, seq] (numpy or
    tensors; a vision config's ``tokens`` are float patch embeddings
    [global_batch, seq, d_model]), the same on every rank; each rank
    takes its data shard.
    Grads are float32 trees shaped like this rank's params, summed over
    the pods; metrics are ``loss_sum`` (the step's mean token loss),
    ``aux_sum`` (the auxiliary losses of every micro-batch's stages; the
    step's objective adds ``router_aux_weight`` times its mean over the
    global micro-batches) and ``emb_dropped``, summed over the mesh."""
    rc = rt.rc
    if rt.shape.world > 1 and rt.mesh is None:
        raise ValueError(f"a step on a {rt.shape.world}-rank mesh needs the "
                         "live Mesh of this rank's process")
    seq, gb = shape_cfg.seq_len, shape_cfg.global_batch
    Btot = rc.microbatches
    shards = rt.shape.pods * rt.dsize
    n_local = gb // shards
    mbs = max(n_local // (rt.G * Btot), 1)
    if mbs * rt.G * Btot * shards != gb:
        raise ValueError(f"global_batch {gb} must split into pods * data * "
                         f"groups * microbatches ({rt.shape.pods} * "
                         f"{rt.dsize} * {rt.G} * {Btot}) micro-batches")
    denom = float(gb * seq)   # the global token count
    # the reference's semantics: loss += w * the mean over the global
    # micro-batches of each one's aux (summed over stages)
    aux_seed = (rt.cfg.moe.router_aux_weight
                / (Btot * rt.G * rt.dsize * rt.shape.pods)
                if rt.cfg.moe is not None else 0.0)
    shard = rt.shape.shard_of(rt.rank)
    rows = slice(shard * n_local, (shard + 1) * n_local)

    def step(params, batch):
        b = {}
        for k in ("tokens", "labels"):
            a = batch[k]
            a = a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a))
            want = ((gb, seq, rt.cfg.d_model)
                    if k == "tokens" and a.is_floating_point() else (gb, seq))
            if tuple(a.shape) != want:
                raise ValueError(f"batch[{k!r}] is {tuple(a.shape)}, the "
                                 f"step takes {list(want)}")
            b[k] = a[rows].to(device=rt.device, dtype=(
                torch.float32 if a.is_floating_point() else torch.long))
        return train_body(params, b, rt=rt, shape_cfg=shape_cfg, mbs=mbs,
                          denom=denom, aux_seed=aux_seed)

    return step


# --------------------------------------------------------------------------- #
# Serving: prefill (s = prompt len) and decode (s = 1) steps
# --------------------------------------------------------------------------- #


def batch_shardable(rt: Runtime, gb: int) -> bool:
    """Whether ``gb`` slot rows split evenly over the pods x data shards
    (the batch-sharded cache layout, the only one ported)."""
    shards = rt.shape.pods * rt.dsize
    return gb % shards == 0 and gb >= shards


SEQ_SHARD_LATER = (
    "the reference falls back to the sequence-sharded KV cache "
    "(kv_seq_shard), which waits for ROADMAP.md queue 1 item 8; use a "
    "slot count divisible by the pods x data axes")


def serve_tiling(rt: Runtime, gb: int) -> tuple[int, int, int]:
    """(b_loc, Btot, mbs): how the serve step tiles a rank's ``b_loc``
    slot rows into (groups x micro-batches x mbs), as the reference's
    ``serve_tiling`` does for the batch-sharded layout. Rows beyond
    ``G·Btot·mbs`` would never be computed, so slotted callers check
    exact coverage (``Session.check_slot_sharding``)."""
    b_loc = gb // (rt.shape.pods * rt.dsize)
    Btot = min(rt.rc.microbatches, b_loc)
    mbs = b_loc // (rt.G * Btot) if b_loc >= rt.G * Btot else 1
    # degenerate tiny batches: one micro-batch a group
    if b_loc < rt.G * Btot:
        Btot = max(b_loc // rt.G, 1)
        mbs = 1
    return b_loc, Btot, mbs


def make_serve_step(rt: Runtime, shape_cfg, *, prompt_len: int = 1,
                    max_seq: int | None = None, page_size: int = 0,
                    want_logits: bool = False, rope: dict | None = None):
    """Returns step(params, caches, batch) -> (tokens, caches), or (tokens,
    logits, caches) with ``want_logits``, on this rank of ``rt``'s mesh.

    ``batch`` is the step's whole batch, the same on every rank (numpy
    arrays or tensors): ``tokens`` [gb, prompt_len] (or float embeddings
    [gb, prompt_len, d_model], a vision prefill); ``pos`` an int, or
    [gb] per slot; optional ``slot_mask`` [gb] and ``page_tables`` [gb,
    max_seq // page_size] (shard-local page ids). Each rank takes its
    shard's rows. ``tokens`` come back int32 [gb] and ``logits`` float32
    [gb, vocab] (the drain ranks' rows, gathered), on the device. A batch
    that does not split over pods x data (the reference's
    sequence-sharded layout, logits or not) is refused, and so are
    logits on a multi-pod mesh, as the reference refuses them."""
    gb = shape_cfg.global_batch
    max_seq = max_seq or shape_cfg.seq_len
    if not batch_shardable(rt, gb):
        # a serve session's spec refuses such a slot count first
        raise ValueError(f"global_batch {gb} does not split over the "
                         f"pods x data axes: {SEQ_SHARD_LATER}")
    if want_logits and rt.multi_pod:
        raise NotImplementedError(
            "logits return is not wired for multi-pod meshes")
    if rt.shape.world > 1 and rt.mesh is None:
        raise ValueError(f"a step on a {rt.shape.world}-rank mesh needs the "
                         "live Mesh of this rank's process")
    b_loc, Btot, mbs = serve_tiling(rt, gb)
    shard = rt.shape.shard_of(rt.rank)
    rows = slice(shard * b_loc, (shard + 1) * b_loc)
    dev = rt.device
    if rope is None:
        rope = CS.rope_for(rt.cfg, max_seq, dev)

    def local(a, dtype):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return a[rows].to(device=dev, dtype=dtype)

    def step(params, caches, batch):
        toks = batch["tokens"]
        toks = toks if isinstance(toks, torch.Tensor) else torch.as_tensor(
            np.asarray(toks))
        flt = toks.is_floating_point()   # a vision prefill's embeddings
        want = (gb, prompt_len) + ((rt.cfg.d_model,) if flt else ())
        if tuple(toks.shape) != want:
            raise ValueError(f"batch['tokens'] is {tuple(toks.shape)}, "
                             f"the step takes {list(want)}")
        b = {"tokens": local(toks, torch.float32 if flt else torch.int32)}
        pos = batch.get("pos", 0)
        b["pos"] = (local(pos, torch.int32) if np.ndim(pos) == 1
                    else int(pos))
        if batch.get("slot_mask") is not None:
            b["slot_mask"] = local(batch["slot_mask"], torch.bool)
        if batch.get("page_tables") is not None:
            b["page_tables"] = local(batch["page_tables"], torch.int32)
        return serve_body(params, caches, b, rt=rt, mbs=mbs, Btot=Btot,
                          rope=rope, page_size=page_size,
                          want_logits=want_logits)

    return step
