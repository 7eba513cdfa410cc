"""FSDP layouts and collectives of the port, behind a communicator.

The port's copy of ``repro/core/fsdp.py`` without expert parallelism.
Two layouts of a stage's tensors (``RunConfig.coalesce``):

* ``"flat"`` (DESIGN: one collective per stage block per tick): every
  gatherable tensor of a stage (its fsdp dim divides the data axis) is
  packed into one flat slab, shard-major: each rank's local slab is the
  entry-order concatenation of its local shards (``FlatLayout.local_size``
  long) and the gathered segment is the rank-order concatenation of
  slabs, so ``FlatEntry.offset/size`` are static LOCAL offsets;
* ``"none"``: one collective per gatherable tensor along its
  data-sharded dim ``ld`` (:func:`gather_param_async`,
  :func:`reduce_scatter_grad_async`). Both collectives are element-exact
  and each element's sum over the data axis is the same, so the values
  equal the flat layout's bit for bit.

A tensor whose fsdp dim does not divide the data axis stays replicated
in either layout, and its gradient is summed over the data axis (the
reference's ``reduce_scatter_grad`` with ``d is None``).

``grad_compress="int8"`` reduces the gatherable gradients in int8 with
error feedback (:func:`reduce_scatter_flat_int8_async`,
:func:`reduce_scatter_grad_int8_async`): the float32 gradient plus the
carried error is quantised with a scale shared over the data axis (a
max all-reduce of each rank's ``max |g| / 127``), rounded to nearest
even and clipped to ±127; the wire carries the int8 values (an
all-to-all of each rank's shards, summed locally in int32, which is
exact: the reference's int32 reduce-scatter at a quarter of its
bytes), and the sum is dequantised with the scale. The new error is
``gf - q * scale``.

The collectives go through a communicator over the data axis,
:class:`repro_torch.core.comm.DistComm` (gloo or NCCL), or its one-rank
form :class:`LocalComm`, where each is the identity:
``all_gather_async`` (rank-order concatenation over dim 0),
``reduce_scatter_async`` (sum over ranks, then this rank's 1/size
chunk), ``all_reduce_async`` and ``all_to_all_async``, each returning a
:class:`repro_torch.core.comm.Pending`; and ``all_reduce``, waited on at
once (the int8 scale's max). :func:`group_allreduce` is the reference's
butterfly across pipeline groups.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.comm import DistComm, Pending, done
from repro_torch.models.common import FlatEntry, FlatLayout, ParamSpec


class LocalComm(DistComm):
    """The one-rank communicator: every collective over a data axis of
    size 1 returns its input."""

    def __init__(self):
        super().__init__([0], None, None, 0)


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
        partner = mesh.rank_of(mesh.d_rank, mesh.g_rank ^ step,
                               mesh.p_rank, mesh.pod_rank)
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


def reduce_scatter_flat_async(grads: dict, fl: FlatLayout, rs_dtype,
                              comm) -> Pending:
    """ONE reduce-scatter for the whole stage segment's gradients:
    full-size per-rank grads in, each tensor's reduced LOCAL shard out
    (at ``wait()``)."""
    flat = _pack_full_flat(grads, fl, rs_dtype)
    return comm.reduce_scatter_async(flat).then(
        lambda r: unpack_flat_local(r, fl))


# --------------------------------------------------------------------------- #
# Per-tensor collectives (coalesce="none")
# --------------------------------------------------------------------------- #


def gather_param_async(x: torch.Tensor, ld: int | None, comm) -> Pending:
    """All-gather one (v-indexed) stage tensor over the data axis along
    its data-sharded dim ``ld``; a replicated tensor (``ld`` None) is
    its own result."""
    if ld is None:
        return done(x)
    return comm.all_gather_async(torch.movedim(x, ld, 0)).then(
        lambda r: torch.movedim(r, 0, ld))


def reduce_scatter_grad_async(g: torch.Tensor, ld: int | None,
                              comm) -> Pending:
    """A full-size gradient back to this rank's shard along ``ld``: a
    reduce-scatter; summed whole over the data axis when replicated."""
    if ld is None:
        return comm.all_reduce_async(g)
    return comm.reduce_scatter_async(torch.movedim(g, ld, 0)).then(
        lambda r: torch.movedim(r, 0, ld))


# --------------------------------------------------------------------------- #
# int8 gradient compression with error feedback
# --------------------------------------------------------------------------- #


def _quantize(gf: torch.Tensor, comm):
    """(q, scale, new err): ``gf`` over a scale shared by a max over the
    data axis, rounded to nearest even and clipped to ±127 (q as int8),
    and ``gf - q * scale``, written over ``gf`` (a tensor of the
    caller's own: at full width each float32 temporary is a stage
    block's size)."""
    local = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
    scale = comm.all_reduce(local, "max")
    q = (gf / scale).round_().clamp_(-127, 127)
    err = gf.sub_(q * scale)
    return q.to(torch.int8), scale, err


def _int8_reduce_scatter_async(q: torch.Tensor, comm) -> Pending:
    """int32 sum over the data axis of the int8 ``q`` [size * k, ...],
    this rank's chunk of dim 0: the int8 shards go out by an all-to-all and are
    summed here (exact)."""
    D = comm.size
    qs = q.reshape((D, q.shape[0] // D) + q.shape[1:])
    return comm.all_to_all_async(qs).then(
        lambda r: r.sum(0, dtype=torch.int32))


def reduce_scatter_flat_int8_async(grads: dict, err: torch.Tensor,
                                   fl: FlatLayout, comm):
    """int8 flat reduce with error feedback over the whole segment: ONE
    all-to-all and one scale shared over the data axis for the segment.
    ``err`` is the [full_size] float32 feedback carried across reduce
    ticks; returns (Pending of the per-tensor local shards, new err)."""
    gf = _pack_full_flat(grads, fl, torch.float32).add_(err)
    q, scale, new_err = _quantize(gf, comm)
    pend = _int8_reduce_scatter_async(q, comm).then(
        lambda r: unpack_flat_local(r.to(torch.float32) * scale, fl))
    return pend, new_err


def reduce_scatter_grad_int8_async(g: torch.Tensor, err: torch.Tensor,
                                   ld: int | None, comm):
    """The per-tensor int8 reduce with error feedback: the tensor's own
    shared scale; reduce-scattered along ``ld``, or summed whole (an int32
    all-reduce) when replicated. Returns (Pending of the reduced float32
    tensor, new err)."""
    q, scale, new_err = _quantize(g.to(torch.float32) + err, comm)

    def deq(r):
        return r.to(torch.float32) * scale

    if ld is None:
        pend = comm.all_reduce_async(q.to(torch.int32)).then(deq)
    else:
        pend = _int8_reduce_scatter_async(torch.movedim(q, ld, 0),
                                          comm).then(
            lambda r: torch.movedim(deq(r), 0, ld))
    return pend, new_err
