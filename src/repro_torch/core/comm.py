"""The mesh of ranks and its collectives over ``torch.distributed``.

The reference lays its ranks on a JAX mesh with a ``data`` and a
``model`` axis (``repro/core/executor.py:37``) and reduces with
``jax.lax`` collectives inside ``shard_map``; this module is their torch
form. Rank layout, as the reference's: ``rank = d * M + m`` with the
model index ``m = g * pp + p`` (pipeline group g, stage rank p) and ``M =
groups * pp`` (``repro/core/fsdp.py`` ``pipe_perm`` / ``group_allreduce``).

* :class:`MeshShape` — the (data, pp, groups) sizes and the rank
  arithmetic; no process group needed (the tests cut and re-assemble
  trees with it in one process).
* :class:`Mesh` — the live mesh of one rank's process: the default
  process group must be initialised with world size ``data * groups *
  pp``. It holds three communicators: ``data_comm`` (the D ranks of this
  model index: FSDP gathers and reduce-scatters, the vocabulary shards),
  ``model_comm`` (the M ranks of this data index: io-gradient sums) and
  ``world_comm``; and ``exchange``, the point-to-point sends and receives
  of the stage ring and the cross-group butterfly.

:class:`DistComm` has :class:`repro_torch.core.fsdp.LocalComm`'s interface
(``size``, ``all_gather``, ``reduce_scatter``) plus ``all_reduce`` (sum or
max) and ``all_to_all``. The backend is the caller's choice, never
guessed. ``gloo`` stages every call through host memory (a CUDA tensor is
copied to the CPU, reduced there and copied back) and reduce-scatters as
an all-reduce followed by a slice; ``nccl`` hands CUDA tensors to its own
collectives and refuses ranks that share a device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# tags of the stage ring's two wires (gloo matches on them; NCCL matches
# a pair's messages in the order they are posted, the same on both sides)
TAG_F, TAG_B = 1, 2


@dataclasses.dataclass
class MeshShape:
    """Sizes of the data x (groups x pp) mesh and its rank arithmetic."""

    data: int
    pp: int
    groups: int

    @property
    def model(self) -> int:
        return self.groups * self.pp

    @property
    def world(self) -> int:
        return self.data * self.model

    def coords(self, rank: int) -> tuple[int, int, int]:
        """(data index, group index, stage rank) of ``rank``."""
        d, m = divmod(rank, self.model)
        g, p = divmod(m, self.pp)
        return d, g, p

    def rank_of(self, d: int, g: int, p: int) -> int:
        return d * self.model + g * self.pp + p


def check_backend(backend: str, world: int, device: str) -> None:
    """Refuse a backend that cannot carry ``world`` ranks on this host:
    NCCL needs a card of its own for every rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: pick one of {BACKENDS}")
    if backend != "nccl":
        return
    n_dev = torch.cuda.device_count() if device == "cuda" else 0
    if world > n_dev:
        raise ValueError(
            f"backend 'nccl' puts each rank on a card of its own: {world} "
            f"ranks on {n_dev} {device} device(s) would share one; use "
            "--backend gloo (host-staged collectives, any number of ranks "
            "a device)")


class DistComm:
    """Collectives over one process group of ``ranks`` (this rank is
    ``ranks[index]``). Tensors come back on the input's device."""

    def __init__(self, ranks: list[int], group, backend: str, rank: int):
        self.ranks, self.group, self.backend = ranks, group, backend
        self.size = len(ranks)
        self.index = ranks.index(rank)

    def _host(self, x: torch.Tensor, copy: bool = False) -> torch.Tensor:
        """x where the backend reads it: on the host for gloo; a copy of
        its own when ``copy`` (the in-place reductions)."""
        dev = "cpu" if self.backend == "gloo" else x.device
        return x.detach().to(dev, copy=copy).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Rank-order concatenation over dim 0."""
        if self.size == 1:
            return x
        xs = self._host(x)
        if self.backend == "gloo":
            parts = [torch.empty_like(xs) for _ in range(self.size)]
            dist.all_gather(parts, xs, group=self.group)
            return torch.cat(parts).to(x.device)
        out = torch.empty((self.size * xs.shape[0],) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=xs.device)
        dist.all_gather_into_tensor(out, xs, group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise sum or max over the group (a new tensor)."""
        if self.size == 1:
            return x
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        xs = self._host(x, copy=True)
        dist.all_reduce(xs, op=rop, group=self.group)
        return xs.to(x.device)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group, then this rank's 1/size chunk of dim 0."""
        if self.size == 1:
            return x
        k = x.shape[0] // self.size
        if self.backend == "gloo":
            return self.all_reduce(x)[self.index * k:(self.index + 1) * k]
        out = torch.empty((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [size, ...]: row j goes to rank j; row i of the result came
        from rank i."""
        if self.size == 1:
            return x
        xs = self._host(x)
        out = torch.empty_like(xs)
        dist.all_to_all_single(out, xs, group=self.group)
        return out.to(x.device)


class Mesh(MeshShape):
    """This process's rank on a live data x (groups x pp) mesh."""

    def __init__(self, data: int, pp: int, groups: int, device):
        super().__init__(data=data, pp=pp, groups=groups)
        if not dist.is_initialized():
            raise ValueError(
                f"data={data} x groups={groups} x pp={pp} needs "
                "torch.distributed: initialise the default process group "
                "(repro_torch.launch.train spawns the ranks and does)")
        world, backend = dist.get_world_size(), dist.get_backend()
        if world != self.world:
            raise ValueError(
                f"data={data} x groups={groups} x pp={pp} = {self.world} "
                f"ranks, but the process group has {world}")
        self.device = torch.device(device)
        check_backend(backend, world, self.device.type)
        self.backend, self.rank = backend, dist.get_rank()
        self.d_rank, self.g_rank, self.p_rank = self.coords(self.rank)
        self.m_rank = self.g_rank * pp + self.p_rank
        M = self.model

        def comm(ranks):
            # every rank creates every sub-group, in the same order
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            return DistComm(ranks, g, backend, self.rank) \
                if self.rank in ranks else None

        datas = [comm([d * M + m for d in range(data)]) for m in range(M)]
        models = [comm([d * M + m for m in range(M)]) for d in range(data)]
        self.data_comm = datas[self.m_rank]
        self.model_comm = models[self.d_rank]
        self.world_comm = DistComm(list(range(world)), dist.group.WORLD,
                                   backend, self.rank)

    def exchange(self, sends, recvs, shape, dtype) -> list[torch.Tensor]:
        """Point-to-point: ``sends`` [(tensor, dst rank, tag)] and
        ``recvs`` [(src rank, tag)], all posted at once, then waited on;
        returns the received tensors in ``recvs`` order on this rank's
        device. Each receive must have its send posted by its peer."""
        host = self.backend == "gloo"
        ops, bufs = [], []
        for t, dst, tag in sends:
            t = t.detach().to("cpu") if host else t
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, tag=tag))
        for src, tag in recvs:
            b = torch.empty(shape, dtype=dtype,
                            device="cpu" if host else self.device)
            bufs.append(b)
            ops.append(dist.P2POp(dist.irecv, b, src, tag=tag))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return [b.to(self.device) for b in bufs]

    def ring_rank(self, p: int) -> int:
        """Global rank of stage rank ``p`` of this rank's pipeline group."""
        return self.rank_of(self.d_rank, self.g_rank, p % self.pp)
