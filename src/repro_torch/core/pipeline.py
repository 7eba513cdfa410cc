"""Runtime and the train-step builder of the port.

The port's counterpart of the train side of ``repro/core/pipeline.py``:
``Runtime`` builds the segment's ``SchedulePlan``, the parameter specs,
the gatherable sets, the flat FSDP layouts and the vocabulary shard for
one rank of a data x (groups x pp) mesh; ``make_train_step`` wraps the
executor's ``train_body`` into ``step(params, batch) -> (grads,
metrics)``. Without a mesh one rank holds one pipeline group (pp = data
= groups = 1) and the data axis is :class:`repro_torch.core.fsdp.LocalComm`;
with a live :class:`repro_torch.core.comm.Mesh` it is the mesh's data
communicator. A :class:`repro_torch.core.comm.MeshShape` alone gives the
layout without collectives (cutting and re-assembling trees,
``repro_torch.params``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fsdp
from repro_torch.core import vocab as Vb
from repro_torch.core.comm import Mesh, MeshShape
from repro_torch.core.executor import train_body
from repro_torch.core.generators import SchedParams
from repro_torch.core.plan import (
    UNIT_GATED_SCHEDULES,
    PackedTable,
    SchedulePlan,
)
from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig, RunConfig

_LATER = "ROADMAP.md queue 1 item 1b"


class Runtime:
    """Plans, specs, flat layouts and the vocabulary shard for one
    (ModelConfig, RunConfig) on one rank of ``mesh``."""

    def __init__(self, cfg: ModelConfig, rc: RunConfig, device,
                 mesh: MeshShape | None = None):
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
        if rc.coalesce != "flat":
            raise ValueError(
                f"coalesce={rc.coalesce!r}: the port packs each stage into "
                "one flat slab; per-tensor collectives wait for "
                f"{_LATER}")
        self.comm = (self.mesh.data_comm if self.mesh is not None
                     else fsdp.LocalComm())
        self.rank = self.mesh.rank if self.mesh is not None else 0
        _, self.g_rank, self.p_rank = self.shape.coords(self.rank)
        self.vloc = Vb.vocab_shard(cfg.vocab, self.dsize)
        self.segs = {s.name: s for s in self.geo.segments}
        # scheduling units only gate ZeroPP-family schedules; the others
        # keep the whole batch live, so their stashes are n_mb deep
        unit = (rc.unit_size if rc.schedule in UNIT_GATED_SCHEDULES
                else rc.microbatches)
        sp = SchedParams(P=rc.pp, V=rc.vpp, n_mb=rc.microbatches,
                         unit=unit)
        self.plans = {"main": SchedulePlan.build(
            rc.schedule, sp, prefetch=rc.gather_prefetch)}
        self.io_specs = M.io_specs(cfg)
        self.stage_specs = {s.name: M.stage_specs(cfg, s)
                            for s in self.geo.segments}
        self.gatherable = {
            sname: sorted(n for n, sp_ in sps.items()
                          if fsdp.local_dim(sp_, self.dsize) is not None)
            for sname, sps in self.stage_specs.items()}
        self.flat_layouts = {
            sname: fsdp.build_flat_layout(self.stage_specs[sname],
                                          self.gatherable[sname], self.dsize)
            for sname in self.stage_specs}

    @property
    def tables(self) -> dict[str, PackedTable]:
        return {k: p.packed for k, p in self.plans.items()}

    def io_sharded(self, name: str) -> bool:
        """Whether io param ``name`` is cut into vocabulary shards."""
        return self.vloc is not None and name in Vb.SHARDED

    def owned(self) -> dict[str, bool]:
        """{keystr path: whether this rank's copy counts in the global
        norm}: every element of the global gradient exactly once. Stage
        rows are duplicated across groups (group 0 counts) and replicated
        over the data axis when not gatherable (data index 0 counts); io
        params are replicated over the model axis (model index 0 counts)
        and, unless vocabulary-sharded, over the data axis."""
        d, g, p = self.shape.coords(self.rank)
        out = {f"['io']['{n}']": g == p == 0 and (d == 0
                                                  or self.io_sharded(n))
               for n in self.io_specs}
        for sname, sps in self.stage_specs.items():
            for n in sps:
                out[f"['segments']['{sname}']['{n}']"] = g == 0 and (
                    d == 0 or n in self.gatherable[sname])
        return out


def make_train_step(rt: Runtime, shape_cfg):
    """Returns step(params, batch) -> (grads, metrics). ``batch`` holds
    the global ``tokens`` and ``labels`` [global_batch, seq] (numpy or
    tensors), the same on every rank; each rank takes its data shard.
    Grads are float32 trees shaped like this rank's params; metrics are
    ``loss_sum`` (the step's mean token loss), ``aux_sum`` and
    ``emb_dropped``, summed over the mesh."""
    rc = rt.rc
    if rt.shape.world > 1 and rt.mesh is None:
        raise ValueError(f"a step on a {rt.shape.world}-rank mesh needs the "
                         "live Mesh of this rank's process")
    seq, gb = shape_cfg.seq_len, shape_cfg.global_batch
    Btot = rc.microbatches
    n_local = gb // rt.dsize
    mbs = max(n_local // (rt.G * Btot), 1)
    if mbs * rt.G * Btot * rt.dsize != gb:
        raise ValueError(f"global_batch {gb} must split into data * groups "
                         f"* microbatches ({rt.dsize} * {rt.G} * {Btot}) "
                         "micro-batches")
    denom = float(gb * seq)   # the global token count
    d_rank = rt.shape.coords(rt.rank)[0]
    rows = slice(d_rank * n_local, (d_rank + 1) * n_local)

    def to_dev(a):
        if isinstance(a, torch.Tensor):
            return a[rows].to(device=rt.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(a)[rows], dtype=torch.long,
                               device=rt.device)

    def step(params, batch):
        for k in ("tokens", "labels"):
            if tuple(batch[k].shape) != (gb, seq):
                raise ValueError(f"batch[{k!r}] is "
                                 f"{tuple(batch[k].shape)}, the step takes "
                                 f"[{gb}, {seq}]")
        b = {k: to_dev(batch[k]) for k in ("tokens", "labels")}
        return train_body(params, b, rt=rt, shape_cfg=shape_cfg, mbs=mbs,
                          denom=denom)

    return step
