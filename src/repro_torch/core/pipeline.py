"""Runtime and the train-step builder of the port.

The port's counterpart of the train side of ``repro/core/pipeline.py``:
``Runtime`` builds the segment's ``SchedulePlan``, the parameter specs,
the gatherable sets and the flat FSDP layouts; ``make_train_step`` wraps
the executor's ``train_body`` into ``step(params, batch) -> (grads,
metrics)``. One rank holds one pipeline group (pp = 1, data = 1): the
communicator is :class:`repro_torch.core.fsdp.LocalComm`, and wider
layouts wait for the multi-rank slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fsdp
from repro_torch.core.executor import train_body
from repro_torch.core.generators import SchedParams
from repro_torch.core.plan import (
    UNIT_GATED_SCHEDULES,
    PackedTable,
    SchedulePlan,
)
from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig, RunConfig


class Runtime:
    """Plans, specs and flat layouts for one (ModelConfig, RunConfig) on
    one rank."""

    def __init__(self, cfg: ModelConfig, rc: RunConfig, device, comm=None):
        self.cfg, self.rc = cfg, rc
        self.device = torch.device(device)
        self.comm = comm if comm is not None else fsdp.LocalComm()
        self.geo = M.build_geometry(cfg, rc)
        self.dsize = self.comm.size
        self.Pe, self.G = rc.pp, rc.groups
        if self.Pe != 1 or self.G != 1 or self.dsize != 1:
            raise ValueError(
                f"pp={rc.pp}, groups={rc.groups}, data={self.dsize}: the "
                "port trains on one rank (multi-rank: next slice)")
        if rc.coalesce != "flat":
            raise ValueError(
                f"coalesce={rc.coalesce!r}: the port packs each stage into "
                "one flat slab; per-tensor collectives come with the "
                "multi-rank slice")
        self.segs = {s.name: s for s in self.geo.segments}
        # scheduling units only gate ZeroPP-family schedules; the others
        # keep the whole batch live, so their stashes are n_mb deep
        unit = (rc.unit_size if rc.schedule in UNIT_GATED_SCHEDULES
                else rc.microbatches)
        sp = SchedParams(P=rc.pp, V=rc.vpp, n_mb=rc.microbatches,
                         unit=unit)
        self.plans = {"main": SchedulePlan.build(
            rc.schedule, sp, prefetch=rc.gather_prefetch)}
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


def make_train_step(rt: Runtime, shape_cfg):
    """Returns step(params, batch) -> (grads, metrics). ``batch`` holds
    ``tokens`` and ``labels`` [global_batch, seq] (numpy or tensors);
    grads are float32 trees shaped like params; metrics are ``loss_sum``
    (the step's mean token loss), ``aux_sum`` and ``emb_dropped``."""
    rc = rt.rc
    seq, gb = shape_cfg.seq_len, shape_cfg.global_batch
    Btot = rc.microbatches
    mbs = max(gb // (rt.G * Btot), 1)
    if mbs * rt.G * Btot != gb:
        raise ValueError(f"global_batch {gb} must split into groups * "
                         f"microbatches ({rt.G} * {Btot}) micro-batches")
    denom = float(gb * seq)   # the global token count

    def to_dev(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=rt.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=rt.device)

    def step(params, batch):
        b = {k: to_dev(batch[k]) for k in ("tokens", "labels")}
        for k, a in b.items():
            if tuple(a.shape) != (gb, seq):
                raise ValueError(f"batch[{k!r}] is {tuple(a.shape)}, the "
                                 f"step takes [{gb}, {seq}]")
        return train_body(params, b, rt=rt, shape_cfg=shape_cfg, mbs=mbs,
                          denom=denom)

    return step

