"""FSDP flat layout and collectives of the port, behind a communicator.

The port's copy of the flat-segment half of ``repro/core/fsdp.py``
(DESIGN: one collective per stage block per tick). Every gatherable tensor
of a stage (its fsdp dim divides the data axis) is packed into one flat
slab, shard-major: each rank's local slab is the entry-order
concatenation of its local shards (``FlatLayout.local_size`` long) and
the gathered segment is the rank-order concatenation of slabs, so
``FlatEntry.offset/size`` are static LOCAL offsets. A tensor whose fsdp
dim does not divide the data axis stays replicated beside the slab, and
its gradient is summed over the data axis (the reference's
``reduce_scatter_grad`` with ``d is None``).

The collectives go through a communicator over the data axis with two
operations on a flat tensor: ``all_gather`` (rank-order concatenation)
and ``reduce_scatter`` (sum over ranks, then this rank's 1/size chunk),
and ``all_reduce`` for the replicated tensors. :class:`LocalComm` is the
one-rank communicator, where all three are the identity; several ranks
use :class:`repro_torch.core.comm.DistComm` (gloo or NCCL).
:func:`group_allreduce` is the reference's butterfly across pipeline
groups.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import FlatEntry, FlatLayout, ParamSpec


class LocalComm:
    """The one-rank communicator: gather, reduce-scatter and all-reduce
    over a data axis of size 1 return the tensor unchanged."""

    size = 1

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return x


def local_dim(spec: ParamSpec, dsize: int) -> int | None:
    """Which (unstacked) dim is data-sharded locally, or None."""
    if spec.shape and spec.shape[spec.fsdp_dim] % dsize == 0:
        return spec.fsdp_dim
    return None


def local_shape(spec: ParamSpec, dsize: int) -> tuple[int, ...]:
    """This rank's shard shape of a tensor (its full shape if
    replicated)."""
    ld = local_dim(spec, dsize)
    sh = list(spec.shape)
    if ld is not None:
        sh[ld] //= dsize
    return tuple(sh)


def group_allreduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Butterfly all-reduce across the pipeline groups of ``mesh``.

    The reference's ``group_allreduce``: partners differ in one bit of
    the group index (same data index and stage rank), and each step adds
    the partner's running sum, so every group ends with the same values
    in the same order of additions. groups must be a power of two."""
    G = mesh.groups
    if G == 1:
        return x
    if G & (G - 1):
        raise ValueError(f"groups={G}: the butterfly needs a power of two")
    step = 1
    while step < G:
        partner = mesh.rank_of(mesh.d_rank, mesh.g_rank ^ step, mesh.p_rank)
        got, = mesh.exchange([(x, partner, 0)], [(partner, 0)], x.shape,
                             x.dtype)
        x = x + got
        step *= 2
    return x


def build_flat_layout(specs: dict, gatherable, dsize: int
                      ) -> FlatLayout | None:
    """Static offsets for one stage segment's flat buffer (None if empty)."""
    entries = []
    off = 0
    for n in sorted(gatherable):
        sp = specs[n]
        ld = local_dim(sp, dsize)
        if ld is None:
            raise ValueError(f"{n} is not flat-packable (replicated)")
        size = int(np.prod(sp.shape)) // dsize
        entries.append(FlatEntry(name=n, shape=tuple(sp.shape), ld=ld,
                                 offset=off, size=size))
        off += size
    if not entries:
        return None
    return FlatLayout(entries=tuple(entries), local_size=off, dsize=dsize)


def _rest_shape(e: FlatEntry) -> tuple[int, ...]:
    return tuple(s for i, s in enumerate(e.shape) if i != e.ld)


def pack_flat_stack(seg_p: dict, fl: FlatLayout) -> torch.Tensor:
    """[V, local_size] slab stack from the local param stacks
    ``seg_p[n]`` [V, *local_shape]. Packed once per step: a gather tick
    then just indexes a row."""
    parts = []
    for e in fl.entries:
        x = seg_p[e.name]
        parts.append(torch.movedim(x, e.ld + 1, 1).reshape(x.shape[0],
                                                           e.size))
    return torch.cat(parts, dim=1)


def all_gather_flat(local_slab: torch.Tensor, fl: FlatLayout,
                    comm) -> torch.Tensor:
    """ONE all-gather for the whole stage segment: [local] -> [full]."""
    return comm.all_gather(local_slab)


def unpack_flat(seg: torch.Tensor, fl: FlatLayout) -> dict:
    """Per-tensor views of a gathered [full_size] segment."""
    m = seg.reshape(fl.dsize, fl.local_size)
    out = {}
    for e in fl.entries:
        t = m[:, e.offset:e.offset + e.size].reshape(
            (e.shape[e.ld],) + _rest_shape(e))
        out[e.name] = torch.movedim(t, 0, e.ld)
    return out


def unpack_flat_local(loc: torch.Tensor, fl: FlatLayout) -> dict:
    """Per-tensor local shards of a [local_size] slab."""
    out = {}
    for e in fl.entries:
        t = loc[e.offset:e.offset + e.size].reshape(
            (e.shape[e.ld] // fl.dsize,) + _rest_shape(e))
        out[e.name] = torch.movedim(t, 0, e.ld)
    return out


def _pack_full_flat(grads: dict, fl: FlatLayout, dtype) -> torch.Tensor:
    """[full_size] shard-major flat buffer from full-size grads."""
    parts = []
    for e in fl.entries:
        g = torch.movedim(grads[e.name], e.ld, 0).to(dtype)
        parts.append(g.reshape(fl.dsize, e.size))
    return torch.cat(parts, dim=1).reshape(-1)


def reduce_scatter_flat(grads: dict, fl: FlatLayout, rs_dtype,
                        comm) -> dict:
    """ONE reduce-scatter for the whole stage segment's gradients:
    full-size per-rank grads in, each tensor's reduced LOCAL shard out."""
    flat = _pack_full_flat(grads, fl, rs_dtype)
    return unpack_flat_local(comm.reduce_scatter(flat), fl)
