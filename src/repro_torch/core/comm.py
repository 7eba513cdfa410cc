"""The mesh of ranks and its collectives over ``torch.distributed``.

The reference lays its ranks on a JAX mesh with a ``pod``, a ``data`` and
a ``model`` axis (``repro/api/session.py``, ``repro/core/executor.py``)
and reduces with ``jax.lax`` collectives inside ``shard_map``; this
module is their torch form. Rank layout, as the reference's: ``rank =
pod * (D * M) + d * M + m`` with the model index ``m = g * pp + p``
(pipeline group g, stage rank p) and ``M = groups * pp``
(``repro/core/fsdp.py`` ``pipe_perm`` / ``group_allreduce``). Pods
replicate parameters (hybrid-sharded DP, paper §5.2) and only all-reduce
gradients.

* :class:`MeshShape` — the (data, pp, groups, pods) sizes and the rank
  arithmetic; no process group needed (the tests cut and re-assemble
  trees with it in one process).
* :class:`Mesh` — the live mesh of one rank's process: the default
  process group must be initialised with world size ``pods * data *
  groups * pp``. It holds four communicators: ``data_comm`` (the D ranks
  of this pod and model index: FSDP gathers and reduce-scatters, the
  vocabulary shards), ``model_comm`` (the M ranks of this pod and data
  index: io-gradient sums), ``pod_comm`` (the ranks of this (d, g, p) in
  every pod: the gradient all-reduce across pods) and ``world_comm``;
  and ``exchange``, the point-to-point sends and receives of the stage
  ring and the cross-group butterfly.

:class:`DistComm` gives ``size`` and ``all_gather``, ``reduce_scatter``,
``all_reduce`` (sum or max) and ``all_to_all`` as ``*_async`` forms,
and all but ``reduce_scatter`` also waited on at once; over a group of
one rank each returns its input
(:class:`repro_torch.core.fsdp.LocalComm`). The backend is the
caller's choice, never guessed. ``gloo`` stages every call through host
memory (a CUDA tensor is copied to the CPU, reduced there and copied
back) and reduce-scatters as an all-reduce followed by a slice; ``nccl``
hands CUDA tensors to its own collectives and refuses ranks that share a
device.

The ``*_async`` forms issue the collective and return a :class:`Pending`
whose ``wait()`` gives the result on the input's device: over gloo the
input is staged to the host at issue and the collective runs on gloo's
own threads; over NCCL it runs on NCCL's stream and ``wait()`` makes the
caller's stream wait on it. A failed collective raises at ``wait()``.
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
    """Sizes of the pods x data x (groups x pp) mesh and its rank
    arithmetic."""

    data: int
    pp: int
    groups: int
    pods: int = 1

    @property
    def model(self) -> int:
        return self.groups * self.pp

    @property
    def world(self) -> int:
        return self.pods * self.data * self.model

    def coords(self, rank: int) -> tuple[int, int, int]:
        """(data index, group index, stage rank) of ``rank`` (the same in
        every pod)."""
        d, m = divmod(rank % (self.data * self.model), self.model)
        g, p = divmod(m, self.pp)
        return d, g, p

    def pod_of(self, rank: int) -> int:
        return rank // (self.data * self.model)

    def rank_of(self, d: int, g: int, p: int, pod: int = 0) -> int:
        return (pod * self.data + d) * self.model + g * self.pp + p

    def shard_of(self, rank: int) -> int:
        """Index of ``rank``'s batch shard among ``pods * data``."""
        return self.pod_of(rank) * self.data + self.coords(rank)[0]


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


class Pending:
    """An issued collective: ``wait()`` waits for it (raising if it
    failed) and returns its result on ``device``, after ``post``."""

    def __init__(self, work, out, device, post=None):
        self.work, self.out, self.device, self.post = work, out, device, post

    def then(self, fn) -> "Pending":
        """Apply ``fn`` to the result after the earlier ``post``."""
        prev = self.post
        self.post = fn if prev is None else (lambda r: fn(prev(r)))
        return self

    def ready(self) -> bool:
        """Whether the collective has completed (``wait()`` won't
        block)."""
        return self.work is None or self.work.is_completed()

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
        out = self.out.to(self.device)
        return self.post(out) if self.post is not None else out


def done(x: torch.Tensor, post=None) -> Pending:
    """A collective over one rank: its result is ``x`` (after
    ``post``)."""
    return Pending(None, x, x.device, post)


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

    def all_gather_async(self, x: torch.Tensor) -> Pending:
        """Rank-order concatenation over dim 0."""
        if self.size == 1:
            return done(x)
        xs = self._host(x)
        out = torch.empty((self.size * xs.shape[0],) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=xs.device)
        if self.backend == "gloo":
            parts = list(out.chunk(self.size))
            work = dist.all_gather(parts, xs, group=self.group,
                                   async_op=True)
        else:
            work = dist.all_gather_into_tensor(out, xs, group=self.group,
                                               async_op=True)
        return Pending(work, out, x.device)

    def all_reduce_async(self, x: torch.Tensor, op: str = "sum") -> Pending:
        """Elementwise sum or max over the group (a new tensor)."""
        if self.size == 1:
            return done(x)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        xs = self._host(x, copy=True)
        work = dist.all_reduce(xs, op=rop, group=self.group, async_op=True)
        return Pending(work, xs, x.device)

    def reduce_scatter_async(self, x: torch.Tensor) -> Pending:
        """Sum over the group, then this rank's 1/size chunk of dim 0."""
        if self.size == 1:
            return done(x)
        k = x.shape[0] // self.size
        if self.backend == "gloo":
            i = self.index
            return self.all_reduce_async(x).then(
                lambda r: r[i * k:(i + 1) * k])
        out = torch.empty((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        work = dist.reduce_scatter_tensor(out, x.contiguous(),
                                          group=self.group, async_op=True)
        return Pending(work, out, x.device)

    def all_to_all_async(self, x: torch.Tensor) -> Pending:
        """x [size, ...]: row j goes to rank j; row i of the result came
        from rank i."""
        if self.size == 1:
            return done(x)
        xs = self._host(x)
        out = torch.empty_like(xs)
        work = dist.all_to_all_single(out, xs, group=self.group,
                                      async_op=True)
        return Pending(work, out, x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather_async(x).wait()

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.all_reduce_async(x, op).wait()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_to_all_async(x).wait()


class Mesh(MeshShape):
    """This process's rank on a live pods x data x (groups x pp) mesh."""

    def __init__(self, data: int, pp: int, groups: int, device,
                 pods: int = 1):
        super().__init__(data=data, pp=pp, groups=groups, pods=pods)
        what = (f"pods={pods} x data={data} x groups={groups} x pp={pp}"
                if pods > 1 else f"data={data} x groups={groups} x pp={pp}")
        if not dist.is_initialized():
            raise ValueError(
                f"{what} needs torch.distributed: initialise the default "
                "process group (repro_torch.launch.train spawns the ranks "
                "and does)")
        world, backend = dist.get_world_size(), dist.get_backend()
        if world != self.world:
            raise ValueError(
                f"{what} = {self.world} ranks, but the process group has "
                f"{world}")
        self.device = torch.device(device)
        check_backend(backend, world, self.device.type)
        self.backend, self.rank = backend, dist.get_rank()
        self.d_rank, self.g_rank, self.p_rank = self.coords(self.rank)
        self.pod_rank = self.pod_of(self.rank)
        self.m_rank = self.g_rank * pp + self.p_rank
        M, D = self.model, data

        def comm(ranks):
            # every rank creates every sub-group, in the same order
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            return DistComm(ranks, g, backend, self.rank) \
                if self.rank in ranks else None

        datas = [comm([(q * D + d) * M + m for d in range(D)])
                 for q in range(pods) for m in range(M)]
        models = [comm([(q * D + d) * M + m for m in range(M)])
                  for q in range(pods) for d in range(D)]
        pod_groups = [comm([(q * D + d) * M + m for q in range(pods)])
                      for d in range(D) for m in range(M)]
        self.data_comm = datas[self.pod_rank * M + self.m_rank]
        self.model_comm = models[self.pod_rank * D + self.d_rank]
        self.pod_comm = pod_groups[self.d_rank * M + self.m_rank]
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
        return self.rank_of(self.d_rank, self.g_rank, p % self.pp,
                            self.pod_rank)
