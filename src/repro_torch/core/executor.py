"""The tick engine and its training handlers, as an eager loop.

The port's counterpart of ``repro/core/executor.py`` (``TickEngine``,
``validate_unit_stash_packed``, ``make_tok_slice``, ``segment_train_scan``,
``train_body``). The JAX engine scans a ``PackedTable`` with ``lax.scan``
inside ``shard_map``; here each rank walks its column of the table in
Python. Each tick:

  1. stores the wires that arrived at the end of the previous tick
     (activations forward, input grads backward) per the plan's receive
     maps;
  2. starts this tick's blockwise FSDP gather of a stage block's flat
     slab (one all-gather over the data axis) into a two-slot buffer;
  3. runs this rank's cell: NOP, F, B or W;
  4. reduce-scatters a finished stage block's gradients over the data
     axis (once per scheduling unit, §3.3); tensors the data axis does
     not divide are all-reduced instead;
  5. hands the boundary activations on around the stage ring. At pp = 1
     the ring is a local hand-off that arrives on the next tick, as the
     reference's one-device ``ppermute`` does. At pp > 1 the hand-off is a
     send to stage rank p + 1 (activations) and p - 1 (input grads) of the
     same pipeline group and data index. Where the reference permutes a
     fixed buffer every tick on every rank, each rank here posts exactly
     the sends its neighbours' rows of the next tick receive, and the
     receives of its own row: both sides read the same ``PackedTable``, so
     every receive has its send and nothing else is posted.

Stashes live in dicts keyed by micro-batch (wires) or (stage slot,
micro-batch) (F->B activations, B->W ``(x, dy)`` pairs), and each entry
is freed by its consumer; the JAX version's fixed ``[V, U, ...]`` carry
buffers exist for ``lax.scan``. ``validate_unit_stash_packed`` still
bounds them: a table that could outlive a unit-depth slot is refused
before the first tick, and the engine checks the bound as it stores.

F runs the stage under ``no_grad`` and stashes its input (remat); B
recomputes the stage on a ``bwd`` tape, seeds the loss at the last stage
through ``loss_and_dy``, and accumulates float32 grads per stage slot; W
replays the stashed dW GEMMs. After the walk, ``train_body`` runs the
reference's cross-rank reductions: the butterfly of stage grads across
pipeline groups, the io grads summed over the model axis and, unless
vocabulary-sharded, over the data axis, and the metrics summed over the
whole mesh. On one rank every one of them is a sum over that rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import fsdp
from repro_torch.core import vocab as Vb
from repro_torch.core.comm import TAG_B, TAG_F
from repro_torch.core.plan import PackedTable
from repro_torch.core.schedules import B as KB
from repro_torch.core.schedules import F as KF
from repro_torch.core.schedules import W as KW
from repro_torch.core.schedules import stash_window_violations
from repro_torch.core.tape import Tape
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.models.common import torch_dtype


def make_tok_slice(g_rank: int, Btot: int, mbs: int):
    """This rank's micro-batch slice of its data shard [n_local, ...]."""
    def tok_slice(arr, u):
        start = (g_rank * Btot + u) * mbs
        return arr[start:start + mbs]
    return tok_slice


def validate_unit_stash_packed(pt: PackedTable) -> None:
    """Reject packed tables whose task spacing exceeds unit-depth stashes.

    Micro-batch ``u + U`` takes micro-batch ``u``'s stash slot, so a
    table where a postponed W (or a late B) outlives its slot would
    replay the wrong micro-batch. The same window rules as
    ``schedules.stash_window_violations``.
    """
    U, n_mb = pt.U, pt.n_mb
    if not (0 < U < n_mb):
        return
    tick: dict[tuple, int] = {}
    for t in range(pt.T):
        for r in range(pt.Pe):
            k = int(pt.kind[t, r])
            if k:
                s = int(pt.v[t, r]) * pt.Pe + r
                tick[(k, int(pt.mb[t, r]), s)] = t
    bad = stash_window_violations(tick, U, n_mb, pt.Pe * pt.V)
    if bad:
        raise ValueError(
            f"packed table illegal at unit depth U={U}: "
            f"{len(bad)} stash violation(s), first: {bad[0]}")


class _Stash(dict):
    """A dict of per-micro-batch entries that never holds more than
    ``depth`` entries of one stage slot (the unit-depth bound)."""

    def __init__(self, depth: int, what: str):
        super().__init__()
        self.depth, self.what = depth, what

    def put(self, key, val) -> None:
        v = key[0] if isinstance(key, tuple) else None
        live = sum(1 for k in self if (k[0] if isinstance(k, tuple)
                                       else None) == v)
        if key in self or live >= self.depth:
            raise RuntimeError(
                f"{self.what} stash overflow at {key}: {live} live entries "
                f"at unit depth {self.depth}")
        self[key] = val


@dataclasses.dataclass
class TickEngine:
    """Walks one PackedTable with the gather / reduce / wire plumbing.

    Handlers receive ``(engine, row)``; they read stage parameters via
    :meth:`stage_params` and the engine's ``state`` dict. The stage's
    gatherable tensors live in the flat layout ``flat`` (one collective a
    tick); the others (``specs`` minus the layout: a dim the data axis
    does not divide) stay replicated in ``seg_p``, are read in place and
    have their grads all-reduced over the data axis. ``mesh`` (a live
    :class:`repro_torch.core.comm.Mesh`, or None on one rank) carries the
    stage ring at pp > 1; ``act`` is the wire's (shape, dtype).
    """

    pt: PackedTable
    specs: dict
    seg_p: dict
    flat: Any                   # FlatLayout of the gatherable tensors
    comm: Any                   # the data axis (LocalComm on one rank)
    cdt: torch.dtype
    rs_dtype: torch.dtype
    p_rank: int = 0
    mesh: Any = None
    act: Any = None
    state: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        validate_unit_stash_packed(self.pt)
        flat_names = set(self.flat.names) if self.flat is not None else set()
        self.replicated = sorted(set(self.specs) - flat_names)
        if self.replicated and self.comm.size == 1:
            raise ValueError("on one rank the flat layout must cover every "
                             f"stage tensor, not {self.replicated}")
        # packed once per step: a gather tick indexes a row
        self.seg_flat = (fsdp.pack_flat_stack(self.seg_p, self.flat)
                         if self.flat is not None else None)
        self.gbuf: list = [None, None]
        self.ring = self.mesh is not None and self.pt.Pe > 1

    def stage_params(self, v: int, use_slot: int) -> dict:
        """Params of local stage slot ``v``: the gathered slab in slot
        ``use_slot``, and the replicated tensors in place."""
        out = (fsdp.unpack_flat(self.gbuf[use_slot], self.flat)
               if self.flat is not None else {})
        for n in self.replicated:
            out[n] = self.seg_p[n][v]
        return out

    def _gather_step(self, row) -> None:
        if row["gather_v"] >= 0 and self.flat is not None:
            full = fsdp.all_gather_flat(self.seg_flat[row["gather_v"]],
                                        self.flat, self.comm)
            self.gbuf[row["gather_slot"]] = full.to(self.cdt)

    def _reduce_step(self, row) -> None:
        rv = row["reduce_v"]
        if rv < 0:
            return
        full, shard = self.state["acc_full"], self.state["acc_shard"]
        if self.flat is not None:
            red = fsdp.reduce_scatter_flat(
                {n: full[n][rv] for n in self.flat.names}, self.flat,
                self.rs_dtype, self.comm)
            for n, r in red.items():
                shard[n][rv] += r.float()
                full[n][rv].zero_()
        for n in self.replicated:
            shard[n][rv] += self.comm.all_reduce(
                full[n][rv].to(self.rs_dtype)).float()
            full[n][rv].zero_()

    def _boundary(self, t: int) -> None:
        s = self.state
        if not self.ring:
            s["recv_f"], s["recv_b"] = s.get("send_f"), s.get("send_b")
            return
        pt, p, mesh = self.pt, self.p_rank, self.mesh
        if t + 1 >= pt.T:
            return
        nxt, prv = (p + 1) % pt.Pe, (p - 1) % pt.Pe
        # F-wire messages before B-wire ones, on both sides
        sends, recvs, into = [], [], []
        if pt.recv_f_u[t + 1, nxt] >= 0:
            sends.append((s["send_f"], mesh.ring_rank(nxt), TAG_F))
        if pt.recv_b_u[t + 1, prv] >= 0:
            sends.append((s["send_b"], mesh.ring_rank(prv), TAG_B))
        if pt.recv_f_u[t + 1, p] >= 0:
            recvs.append((mesh.ring_rank(prv), TAG_F))
            into.append("recv_f")
        if pt.recv_b_u[t + 1, p] >= 0:
            recvs.append((mesh.ring_rank(nxt), TAG_B))
            into.append("recv_b")
        for w, x in zip(into, mesh.exchange(sends, recvs, *self.act)):
            s[w] = x

    def run(self, branches: dict) -> None:
        """Walk the ticks, dispatching cells to ``branches`` {kind: fn}."""
        for t in range(self.pt.T):
            row = self.pt.row(t, self.p_rank)
            s = self.state
            if row["recv_f_u"] >= 0:
                s["xbuf"].put(row["recv_f_u"], s["recv_f"])
            if row["recv_b_u"] >= 0:
                s["bbuf"].put(row["recv_b_u"], s["recv_b"])
            self._gather_step(row)
            fn = branches.get(row["kind"])
            if fn is not None:
                fn(self, row)
            self._reduce_step(row)
            self._boundary(t)


# --------------------------------------------------------------------------- #
# Training: one segment's table as F / B / W handlers over the engine
# --------------------------------------------------------------------------- #


def segment_train_scan(rt, seg, pt: PackedTable, seg_p, io_p, batch, mbs,
                       seq, denom, io_g, metrics):
    """Run one segment's plan on the tick engine; accumulates into io_g
    and metrics in place and returns this rank's stage grads {name: [V,
    *local shape]} (reduced over the data axis, not yet across
    groups)."""
    cfg, rc = rt.cfg, rt.rc
    cdt = torch_dtype(rc.compute_dtype)
    V, Pe, U = seg.vpp, rt.Pe, pt.U
    p_rank = rt.p_rank
    specs = rt.stage_specs[seg.name]
    dev = rt.device
    vloc, comm = rt.vloc, rt.comm
    # fused-backward baselines have no W tasks: every dense dW is
    # computed inside B (classic 1F1B / GPipe semantics)
    no_defer = set() if pt.has_w else set(specs)
    if rc.no_defer_extra and pt.has_w:
        no_defer |= {n for n in specs
                     if any(sub in n for sub in rc.no_defer_extra)}
    no_defer = frozenset(no_defer)
    tokens, labels = batch["tokens"], batch["labels"]
    rope = M.rope_for(cfg, seq, dev)
    d = cfg.d_model

    eng = TickEngine(
        pt=pt, specs=specs, seg_p=seg_p, flat=rt.flat_layouts[seg.name],
        comm=comm, cdt=cdt, rs_dtype=torch_dtype(rc.grad_rs_dtype),
        p_rank=p_rank, mesh=rt.mesh, act=((mbs, seq, d), cdt))
    eng.state.update(
        xbuf=_Stash(U, "fwd wire"), bbuf=_Stash(U, "bwd wire"),
        fstash=_Stash(U, "F->B"), wstash=_Stash(U, "B->W"),
        acc_full={n: torch.zeros((V, *specs[n].shape), dtype=torch.float32,
                                 device=dev) for n in specs},
        acc_shard={n: torch.zeros((V, *fsdp.local_shape(specs[n], rt.dsize)),
                                  dtype=torch.float32, device=dev)
                   for n in specs})
    st = eng.state
    tok_slice = make_tok_slice(rt.g_rank, pt.n_mb, mbs)

    def ctx():
        return blocks.LayerCtx(cfg=cfg, rc=rc, rope=rope, causal=seg.causal)

    def f_branch(eng, row):
        u, v = row["mb"], row["v"]
        if p_rank == 0 and v == 0:
            x = Vb.embed_lookup(io_p["embed.table"], tok_slice(tokens, u),
                                vloc, cdt, comm)
        else:
            x = st["xbuf"].pop(u)
        t = Tape(eng.stage_params(v, row["use_slot"]), mode="fwd",
                 no_defer=no_defer)
        y, _ = M.apply_stage(t, ctx(), seg, t.value(x), v * Pe + p_rank)
        st["fstash"].put((v, u), x)
        st["send_f"] = y.val

    def b_branch(eng, row):
        u, v = row["mb"], row["v"]
        x = st["fstash"].pop((v, u))
        t = Tape(eng.stage_params(v, row["use_slot"]), mode="bwd",
                 no_defer=no_defer)
        xin = t.value(x)
        out, aux = M.apply_stage(t, ctx(), seg, xin, v * Pe + p_rank)
        if p_rank == Pe - 1 and v == V - 1:
            h = out.val.reshape(mbs * seq, d)
            lab = tok_slice(labels, u).reshape(mbs * seq)
            loss, dh, iog = Vb.loss_and_dy(cfg, rc, io_p, h, lab, denom,
                                           vloc, rt.dsize, comm=comm)
            for n, g in iog.items():
                io_g[n] += g
            metrics["loss_sum"] += loss.detach().float()
            dy = dh.reshape(mbs, seq, d)
        else:
            dy = st["bbuf"].pop(u)
        cots, igrads, stash = t.backward({out.idx: dy.to(out.val.dtype)})
        dx = cots[xin.idx]
        st["send_b"] = dx.to(cdt)
        if stash:
            st["wstash"].put((v, u), stash)
        for n, g in igrads.items():
            st["acc_full"][n][v] += g.float()
        if p_rank == 0 and v == 0:
            _, dropped = Vb.embed_grad(tok_slice(tokens, u), dx.float(),
                                       vloc, cfg.vocab, io_g["embed.table"],
                                       comm)
            metrics["emb_dropped"] += dropped
        metrics["aux_sum"] += aux.val.float()

    def w_branch(eng, row):
        u, v = row["mb"], row["v"]
        for s in st["wstash"].pop((v, u), ()):
            st["acc_full"][s.pname][v] += torch.einsum(
                s.dw_spec, s.x, s.dy).float()

    eng.run({KF: f_branch, KB: b_branch, KW: w_branch})
    leftover = [k for k in ("xbuf", "bbuf", "fstash", "wstash") if st[k]]
    if leftover:
        raise RuntimeError(f"table left live stashes: {leftover}")
    return st["acc_shard"]


def train_body(params, batch, *, rt, shape_cfg, mbs, denom):
    """One rank's training step: (grads, metrics), grads in float32 in
    this rank's local shapes; ``batch`` is this rank's data shard."""
    io_p = params["io"]
    dev = rt.device
    io_g = {n: torch.zeros(a.shape, dtype=torch.float32, device=dev)
            for n, a in io_p.items()}
    metrics = {"loss_sum": torch.zeros((), dtype=torch.float32, device=dev),
               "aux_sum": torch.zeros((), dtype=torch.float32, device=dev),
               "emb_dropped": 0}
    seg = rt.segs["main"]
    seg_grads = segment_train_scan(
        rt, seg, rt.tables["main"], params["segments"]["main"], io_p, batch,
        mbs, shape_cfg.seq_len, denom, io_g, metrics)
    mesh = rt.mesh
    if mesh is None:
        # one rank: the cross-group and data reductions of the reference
        # are sums over a single rank
        return {"io": io_g, "segments": {"main": seg_grads}}, metrics
    # ---- cross-group gradient reduction (stage rows duplicated across
    # groups), then the io grads over the model axis and, unless their
    # vocabulary shard is local and complete, over the data axis -------- #
    seg_grads = {n: fsdp.group_allreduce(g, mesh)
                 for n, g in seg_grads.items()}
    for n in io_g:
        g = mesh.model_comm.all_reduce(io_g[n])
        if rt.vloc is None or n not in Vb.SHARDED:
            g = mesh.data_comm.all_reduce(g)
        io_g[n] = g
    w = mesh.world_comm
    dropped = torch.tensor(metrics["emb_dropped"], dtype=torch.int64,
                           device=dev)
    metrics = {"loss_sum": w.all_reduce(metrics["loss_sum"]),
               "aux_sum": w.all_reduce(metrics["aux_sum"]),
               "emb_dropped": int(w.all_reduce(dropped))}
    return {"io": io_g, "segments": {"main": seg_grads}}, metrics
