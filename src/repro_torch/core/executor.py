"""The tick engine and its training and serving handlers, as an eager
loop.

The port's counterpart of ``repro/core/executor.py`` (``TickEngine``,
``validate_unit_stash_packed``, ``make_tok_slice``, ``segment_train_scan``,
``train_body``, ``make_cache_io``, ``serve_body``). The JAX engine scans a ``PackedTable`` with ``lax.scan``
inside ``shard_map``; here each rank walks its column of the table in
Python. Each tick:

  1. stores the wires that arrived at the end of the previous tick
     (activations forward, input grads backward) per the plan's receive
     maps;
  2. issues this tick's blockwise FSDP gather of a stage block (one
     all-gather of its flat slab over the data axis, or one a tensor
     with ``coalesce="none"``) for a slot of a two-slot buffer; the cell
     that first reads the slot waits for it (the §3.3 prefetch places
     the gather up to ``gather_prefetch`` ticks ahead, so it overlaps
     the cells between);
  3. runs this rank's cell: NOP, F, B or W;
  4. issues the reduce-scatter of a finished stage block's gradients
     over the data axis (once per scheduling unit, §3.3; in int8 with
     error feedback under ``grad_compress="int8"``); tensors the data
     axis does not divide are all-reduced instead. A reduce is added
     into the shard once it has completed (on one rank at once), at the
     latest when the walk ends; the shards are read only after it;
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

An encoder-decoder walks three tables a step (``train_body``): the
encoder's forward, the decoder's F / B / W with cross-attention over
the memory, and the encoder's B / W seeded by the memory's cotangent,
with the memory and that cotangent summed over the model axis between
the walks.

F runs the stage under ``no_grad`` and stashes its input (remat); B
recomputes the stage on a ``bwd`` tape, seeds the loss at the last stage
through ``loss_and_dy``, and accumulates float32 grads per stage slot; W
replays the stashed dW GEMMs. After the walk, ``train_body`` runs the
reference's cross-rank reductions: the butterfly of stage grads across
pipeline groups, then their float32 all-reduce across pods; the io
grads summed over the model axis, across pods and, unless
vocabulary-sharded, over the data axis; and the metrics summed over the
whole mesh. On one rank every one of them is a sum over that rank.

Serving (``serve_body``) walks the forward-only table on the same engine:
F cells and NOPs, the stage blocks gathered tick by tick as in training
(none under ``serve_resident``: each rank holds its stage rows whole),
no reduces and no tape. Each F cell embeds at stage 0, runs the cached
stage on its micro-batch's rows of this rank's cache tree
(``make_cache_io``), and the drain rank samples at the last stage; the
tokens (and logits) are then summed over the model axis from the drain
ranks and gathered over the data and pod axes, so that every rank
returns the whole batch's. Serve steps count into ``COLL_TIME`` the
seconds the engine spends issuing gathers (on gloo, the copy of the
slab to the host) and waiting for them (the collective and the copy
back), for the serve launcher's report; training steps time nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core import fsdp
from repro_torch.core import vocab as Vb
from repro_torch.core.comm import TAG_B, TAG_F
from repro_torch.core.plan import PackedTable, slot_violations
from repro_torch.core.schedules import B as KB
from repro_torch.core.schedules import F as KF
from repro_torch.core.schedules import W as KW
from repro_torch.core.schedules import stash_window_violations
from repro_torch.core.tape import Tape
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.models.common import torch_dtype


COLL_TIME = {"gathers": 0, "issue_s": 0.0, "wait_s": 0.0}


def reset_coll_time() -> None:
    COLL_TIME.update(gathers=0, issue_s=0.0, wait_s=0.0)


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
    ``schedules.stash_window_violations``. A table whose F or B cells read
    a gather slot that does not hold their stage block
    (``plan.slot_violations``) is refused too, at any depth.
    """
    bad = slot_violations(pt)
    if bad:
        raise ValueError(f"packed table reads evicted stage blocks: "
                         f"{len(bad)} cell(s), first: {bad[0]}")
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
    gatherable tensors (``gatherable``, the Runtime's set: those whose
    fsdp dim the data axis divides, none under ``serve_resident``) are
    gathered a tick at a time: with a flat layout ``flat`` as one slab (one collective a
    tick), without one (``coalesce="none"``) one collective a tensor.
    The others (a dim the data axis does not divide, or every tensor
    under ``serve_resident``) stay whole in ``seg_p``, are read in place
    and have their grads all-reduced over the data axis. ``mesh`` (a live
    :class:`repro_torch.core.comm.Mesh`, or None on one rank) carries the
    stage ring at pp > 1; ``act`` is the wire's (shape, dtype).

    The collectives overlap the cells. A gather is issued at its table
    tick into a receive buffer of its own and waited on when
    :meth:`stage_params` first reads its slot; a reduce packs and zeroes
    the block's ``acc_full`` at its tick, issues the reduce-scatter, and
    is added into ``acc_shard``, in issue order, once it has completed
    (checked at each reduce tick) or when the walk ends (:meth:`drain`)
    — the shards are read only after it, as in the reference. With
    ``grad_compress="int8"`` the gatherable gradients go through the
    int8 reduce with error feedback; its float32 buffer (``[V,
    full_size]`` flat, else ``[V, *shape]`` a tensor) starts each step at
    zero and is carried across the step's reduce units.
    """

    pt: PackedTable
    specs: dict
    seg_p: dict
    flat: Any                   # FlatLayout of the gatherable tensors
    comm: Any                   # the data axis (LocalComm on one rank)
    cdt: torch.dtype
    rs_dtype: torch.dtype
    gatherable: Any             # names gathered over the data axis
    p_rank: int = 0
    mesh: Any = None
    act: Any = None
    grad_compress: str = "none"
    times: dict | None = None   # COLL_TIME-shaped: gather counts, seconds
    state: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        validate_unit_stash_packed(self.pt)
        D = self.comm.size
        self.gatherable = sorted(self.gatherable)
        self.ld = {n: fsdp.local_dim(sp, D) if n in self.gatherable
                   else None for n, sp in self.specs.items()}
        self.replicated = sorted(set(self.specs) - set(self.gatherable))
        if (self.flat is not None
                and sorted(self.flat.names) != self.gatherable):
            raise ValueError(f"the flat layout holds {sorted(self.flat.names)}"
                             f", the gatherable tensors are {self.gatherable}")
        # packed once per step: a gather tick indexes a row
        self.seg_flat = (fsdp.pack_flat_stack(self.seg_p, self.flat)
                         if self.flat is not None else None)
        self.gbuf: list = [None, None]
        self.held: list = [None, None]      # stage block of each slot
        self.pending: list = [None, None]   # issued gathers, by slot
        self.reduces: list = []             # issued reduces, in order
        self.tick = -1
        self.ring = self.mesh is not None and self.pt.Pe > 1
        V = self.pt.V
        self.gerr = None
        if self.grad_compress == "int8" and self.gatherable:
            dev = next(iter(self.seg_p.values())).device
            self.gerr = (
                torch.zeros((V, self.flat.full_size), dtype=torch.float32,
                            device=dev) if self.flat is not None else
                {n: torch.zeros((V, *self.specs[n].shape),
                                dtype=torch.float32, device=dev)
                 for n in self.gatherable})

    def stage_params(self, v: int, use_slot: int) -> dict:
        """Params of local stage slot ``v``: the gathered tensors in slot
        ``use_slot`` (waiting for its gather if it is still in flight),
        and the replicated tensors in place. Raises if the slot does
        not hold block ``v`` (a table that reads an evicted block)."""
        if self.held[use_slot] != v:
            raise RuntimeError(
                f"tick {self.tick}: stage block {v} read from gather slot "
                f"{use_slot}, which holds block {self.held[use_slot]}")
        if self.pending[use_slot] is not None:
            self._land(use_slot)
        out = dict(self.gbuf[use_slot] or {})
        for n in self.replicated:
            out[n] = self.seg_p[n][v]
        return out

    def _land(self, slot: int) -> None:
        pend, self.pending[slot] = self.pending[slot], None
        t0 = time.perf_counter() if self.times is not None else 0.0
        if self.flat is not None:
            buf = fsdp.unpack_flat(pend.wait().to(self.cdt), self.flat)
        else:
            buf = {n: p.wait().to(self.cdt) for n, p in pend.items()}
        # on a mesh, a tensor cut on a dim other than 0 lands as a
        # strided view (its shards are stacked on dim 0); it is copied
        # into the layout the params are stored in, so that a cell reads
        # it as it reads a resident tensor, bit for bit (the summation
        # order of a product of one or two rows follows the operand's
        # strides). Tensors cut on dim 0 land contiguous and are not
        # copied; one rank keeps its views.
        copy = self.comm.size > 1
        self.gbuf[slot] = {n: t.contiguous() if copy and self.ld[n] else t
                           for n, t in buf.items()}
        if self.times is not None:
            self.times["wait_s"] += time.perf_counter() - t0

    def _gather_step(self, row) -> None:
        gv, slot = row["gather_v"], row["gather_slot"]
        if gv < 0:
            return
        self.held[slot] = gv
        if not self.gatherable:
            return
        if self.pending[slot] is not None:   # issued, never read
            self._land(slot)
        t0 = time.perf_counter() if self.times is not None else 0.0
        if self.flat is not None:
            self.pending[slot] = self.comm.all_gather_async(
                self.seg_flat[gv])
        else:
            self.pending[slot] = {
                n: fsdp.gather_param_async(self.seg_p[n][gv], self.ld[n],
                                           self.comm)
                for n in self.gatherable}
        self.gbuf[slot] = None
        if self.times is not None:
            self.times["gathers"] += 1
            self.times["issue_s"] += time.perf_counter() - t0

    def _reduce_step(self, row) -> None:
        rv = row["reduce_v"]
        if rv < 0:
            return
        full, comm = self.state["acc_full"], self.comm
        int8 = self.gerr is not None
        issued = {}
        if self.flat is not None:
            grads = {n: full[n][rv] for n in self.flat.names}
            if int8:
                pend, err = fsdp.reduce_scatter_flat_int8_async(
                    grads, self.gerr[rv], self.flat, comm)
                self.gerr[rv] = err
            else:
                pend = fsdp.reduce_scatter_flat_async(
                    grads, self.flat, self.rs_dtype, comm)
            issued[None] = pend
        for n in self.specs:
            if self.flat is not None and n in self.flat.names:
                continue
            g = full[n][rv]
            if int8 and n in self.gerr:
                issued[n], self.gerr[n][rv] = \
                    fsdp.reduce_scatter_grad_int8_async(
                        g, self.gerr[n][rv], self.ld[n], comm)
            else:
                # a copy of its own: acc_full is zeroed below
                issued[n] = fsdp.reduce_scatter_grad_async(
                    g.to(self.rs_dtype, copy=True), self.ld[n], comm)
        for n in self.specs:
            full[n][rv].zero_()
        self.reduces.append((rv, issued))
        # what has completed (at once on one rank) is added now, so that
        # its buffers are not held to the end of the walk
        self._add_reduces(wait=False)

    def _add_reduces(self, wait: bool) -> None:
        """Add issued reduces into ``acc_shard`` in issue order: every one
        (``wait``), or those up to the first still in flight."""
        while self.reduces:
            shard = self.state["acc_shard"]
            rv, issued = self.reduces[0]
            if not wait and not all(p.ready() for p in issued.values()):
                return
            self.reduces.pop(0)
            for n, pend in issued.items():
                red = pend.wait()
                for m, r in (red.items() if n is None else ((n, red),)):
                    shard[m][rv] += r.float()

    def drain(self) -> None:
        """Wait for every gather still in flight and add every issued
        reduce into ``acc_shard``, in issue order."""
        for slot in (0, 1):
            if self.pending[slot] is not None:
                self._land(slot)
        self._add_reduces(wait=True)

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
            self.tick = t
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
        self.drain()


# --------------------------------------------------------------------------- #
# Training: one segment's table as F / B / W handlers over the engine
# --------------------------------------------------------------------------- #


def segment_train_scan(rt, seg, pt: PackedTable, seg_p, io_p, batch, mbs,
                       seq, denom, io_g, metrics, aux_seed=0.0, *,
                       inject: str = "tokens", seed: str | None = "loss",
                       membuf=None, dmembuf: str | None = None,
                       seed_buf=None, carry_in=None) -> dict:
    """Run one segment's plan on the tick engine; accumulates into io_g
    and metrics in place. ``aux_seed`` is the cotangent of each B task's
    auxiliary-loss output (the router weight over the global
    micro-batch count). The reference's segment arguments:

      inject:  the batch key of stage 0's inputs (ids or float embeds)
      seed:    what B seeds at the last stage: "loss" (the head's loss
               and dh), "buffer" (``seed_buf[u]``) or None (a table with
               no B)
      membuf:  None, "collect" (keep each micro-batch's last-stage
               output: the encoder's memory) or a tensor [n_mb, mbs,
               enc_ctx, d], the memory cross-attention reads
      dmembuf: "collect" to sum the memory's cotangent of every B task
               (float32) by micro-batch
      carry_in: the F->B stash of an earlier walk of the same segment
               (the encoder's backward after its forward walk)

    Returns ``stage_grads`` (this rank's {name: [V, *local shape]},
    reduced over the data axis, not yet across groups; None for a table
    with no B), ``membuf``, ``dmembuf`` and ``carry`` (the F->B stash,
    for a later walk)."""
    cfg, rc = rt.cfg, rt.rc
    cdt = torch_dtype(rc.compute_dtype)
    V, Pe, U = seg.vpp, rt.Pe, pt.U
    p_rank = rt.p_rank
    specs = rt.stage_specs[seg.name]
    dev = rt.device
    vloc, comm = rt.vloc, rt.comm
    has_b = bool((pt.kind == KB).any())
    # fused-backward baselines have no W tasks: every dense dW is
    # computed inside B (classic 1F1B / GPipe semantics)
    no_defer = set() if pt.has_w else set(specs)
    if rc.no_defer_extra and pt.has_w:
        no_defer |= {n for n in specs
                     if any(sub in n for sub in rc.no_defer_extra)}
    no_defer = frozenset(no_defer)
    tokens, labels = batch[inject], batch.get("labels")
    # the vision stub's patches and the audio stub's frames (float
    # embeddings [n, seq, d]) go in as they are (cast to the compute
    # dtype): no table lookup and no gradient to the table, as in the
    # reference
    int_tokens = not tokens.is_floating_point()
    rope = M.rope_for(cfg, seq, dev)
    d = cfg.d_model
    n_mb = pt.n_mb
    is_last = (lambda v: p_rank == Pe - 1 and v == V - 1)

    eng = TickEngine(
        pt=pt, specs=specs, seg_p=seg_p, flat=rt.flat_layouts[seg.name],
        comm=comm, cdt=cdt, rs_dtype=torch_dtype(rc.grad_rs_dtype),
        p_rank=p_rank, mesh=rt.mesh, act=((mbs, seq, d), cdt),
        grad_compress=rc.grad_compress, gatherable=rt.gatherable[seg.name])
    eng.state.update(
        xbuf=_Stash(U, "fwd wire"), bbuf=_Stash(U, "bwd wire"),
        fstash=(carry_in if carry_in is not None
                else _Stash(U, "F->B")),
        wstash=_Stash(U, "B->W"))
    if has_b:
        eng.state.update(
            acc_full={n: torch.zeros((V, *specs[n].shape),
                                     dtype=torch.float32, device=dev)
                      for n in specs},
            acc_shard={n: torch.zeros((V, *rt.local_shape(seg.name, n)),
                                      dtype=torch.float32, device=dev)
                       for n in specs})
    st = eng.state
    if isinstance(membuf, str):
        membuf = torch.zeros((n_mb, mbs, seq, d), dtype=cdt, device=dev)
        collect = membuf
    else:
        collect = None
    if dmembuf == "collect":
        dmembuf = torch.zeros((n_mb, mbs, cfg.encdec.enc_ctx, d),
                              dtype=torch.float32, device=dev)
    tok_slice = make_tok_slice(rt.g_rank, n_mb, mbs)

    def ctx(t, u):
        """(the layer context, the memory's tape value or None)."""
        mem = t.value(membuf[u]) if collect is None and membuf is not None \
            else None
        return blocks.LayerCtx(cfg=cfg, rc=rc, rope=rope, causal=seg.causal,
                               enc_memory=mem), mem

    def f_branch(eng, row):
        u, v = row["mb"], row["v"]
        if p_rank == 0 and v == 0:
            ids = tok_slice(tokens, u)
            x = (Vb.embed_lookup(io_p["embed.table"], ids, vloc, cdt, comm)
                 if int_tokens else M.embed_tokens(io_p, ids, cfg, cdt))
        else:
            x = st["xbuf"].pop(u)
        t = Tape(eng.stage_params(v, row["use_slot"]), mode="fwd",
                 no_defer=no_defer)
        y, _ = M.apply_stage(t, ctx(t, u)[0], seg, t.value(x),
                             v * Pe + p_rank)
        st["fstash"].put((v, u), x)
        st["send_f"] = y.val
        if collect is not None and is_last(v):
            collect[u] = y.val

    def b_branch(eng, row):
        u, v = row["mb"], row["v"]
        x = st["fstash"].pop((v, u))
        t = Tape(eng.stage_params(v, row["use_slot"]), mode="bwd",
                 no_defer=no_defer)
        xin = t.value(x)
        c, mem = ctx(t, u)
        out, aux = M.apply_stage(t, c, seg, xin, v * Pe + p_rank)
        if seed == "loss" and is_last(v):
            h = out.val.reshape(mbs * seq, d)
            lab = tok_slice(labels, u).reshape(mbs * seq)
            loss, dh, iog = Vb.loss_and_dy(cfg, rc, io_p, h, lab, denom,
                                           vloc, rt.dsize, comm=comm)
            for n, g in iog.items():
                io_g[n] += g
            metrics["loss_sum"] += loss.detach().float()
            dy = dh.reshape(mbs, seq, d)
        elif seed == "buffer" and is_last(v):
            dy = seed_buf[u].to(cdt)
        else:
            dy = st["bbuf"].pop(u)
        seeds = {out.idx: dy.to(out.val.dtype)}
        if aux_seed:
            seeds[aux.idx] = torch.tensor(aux_seed, dtype=torch.float32,
                                          device=dev)
        cots, igrads, stash = t.backward(seeds)
        dx = cots[xin.idx]
        st["send_b"] = dx.to(cdt)
        if stash:
            st["wstash"].put((v, u), stash)
        for n, g in igrads.items():
            st["acc_full"][n][v] += g.float()
        if p_rank == 0 and v == 0 and int_tokens:
            _, dropped = Vb.embed_grad(tok_slice(tokens, u), dx.float(),
                                       vloc, cfg.vocab, io_g["embed.table"],
                                       comm)
            metrics["emb_dropped"] += dropped
        if dmembuf is not None and mem is not None and mem.idx in cots:
            # the cross-attention memory's cotangent: this stage's share
            dmembuf[u] += cots[mem.idx].float()
        metrics["aux_sum"] += aux.val.float()

    def w_branch(eng, row):
        u, v = row["mb"], row["v"]
        for s in st["wstash"].pop((v, u), ()):
            st["acc_full"][s.pname][v] += torch.einsum(
                s.dw_spec, s.x, s.dy).float()

    eng.run({KF: f_branch, KB: b_branch, KW: w_branch})
    # a forward-only walk hands its F->B stash on to the backward walk
    live = ("xbuf", "bbuf", "wstash") + (("fstash",) if has_b else ())
    leftover = [k for k in live if st[k]]
    if leftover:
        raise RuntimeError(f"table left live stashes: {leftover}")
    return {"stage_grads": st.get("acc_shard"), "membuf": collect,
            "dmembuf": dmembuf, "carry": st["fstash"]}


def train_body(params, batch, *, rt, shape_cfg, mbs, denom, aux_seed=0.0):
    """One rank's training step: (grads, metrics), grads in float32 in
    this rank's local shapes; ``batch`` is this rank's data shard;
    ``aux_seed`` seeds each micro-batch's auxiliary loss.

    An encoder-decoder walks three tables, as the reference does: the
    encoder forward (``enc_fwd``; the drain rank keeps each
    micro-batch's memory), the decoder's (``dec``: F / B / W with
    cross-attention over the memory, each B adding the memory's
    cotangent), then the encoder's B and W (``enc_bwd``), seeded at its
    last stage by that cotangent. The memory and its cotangent are summed
    over the model axis between the walks, so every stage rank holds
    them; the grads of both segments then take the same reductions."""
    cfg = rt.cfg
    io_p = params["io"]
    dev = rt.device
    io_g = {n: torch.zeros(a.shape, dtype=torch.float32, device=dev)
            for n, a in io_p.items()}
    metrics = {"loss_sum": torch.zeros((), dtype=torch.float32, device=dev),
               "aux_sum": torch.zeros((), dtype=torch.float32, device=dev),
               "emb_dropped": 0}
    mesh = rt.mesh
    seq = shape_cfg.seq_len
    args = (io_p, batch, mbs)
    if cfg.encdec is None:
        res = segment_train_scan(
            rt, rt.segs["main"], rt.tables["main"],
            params["segments"]["main"], *args, seq, denom, io_g, metrics,
            aux_seed)
        seg_grads = {"main": res["stage_grads"]}
    else:
        enc, ctx_len = rt.segs["enc"], cfg.encdec.enc_ctx

        def over_model(t):
            return mesh.model_comm.all_reduce(t) if mesh is not None else t

        res_e = segment_train_scan(
            rt, enc, rt.tables["enc_fwd"], params["segments"]["enc"], *args,
            ctx_len, denom, io_g, metrics, aux_seed, inject="enc_tokens",
            seed=None, membuf="collect")
        res_d = segment_train_scan(
            rt, rt.segs["dec"], rt.tables["dec"], params["segments"]["dec"],
            *args, seq, denom, io_g, metrics, aux_seed,
            membuf=over_model(res_e["membuf"]), dmembuf="collect")
        res_eb = segment_train_scan(
            rt, enc, rt.tables["enc_bwd"], params["segments"]["enc"], *args,
            ctx_len, denom, io_g, metrics, aux_seed, inject="enc_tokens",
            seed="buffer", seed_buf=over_model(res_d["dmembuf"]),
            carry_in=res_e["carry"])
        seg_grads = {"enc": res_eb["stage_grads"],
                     "dec": res_d["stage_grads"]}
    if mesh is None:
        # one rank: the cross-group and data reductions of the reference
        # are sums over a single rank
        return {"io": io_g, "segments": seg_grads}, metrics
    # ---- cross-group gradient reduction (stage rows duplicated across
    # groups) and the float32 sum across pods; then the io grads over the
    # model axis, across pods and, unless their vocabulary shard is local
    # and complete, over the data axis ---------------------------------- #
    pod = mesh.pod_comm
    seg_grads = {sname: {n: pod.all_reduce(fsdp.group_allreduce(g, mesh))
                         for n, g in sg.items()}
                 for sname, sg in seg_grads.items()}
    for n in io_g:
        g = pod.all_reduce(mesh.model_comm.all_reduce(io_g[n]))
        if rt.vloc is None or n not in Vb.SHARDED:
            g = mesh.data_comm.all_reduce(g)
        io_g[n] = g
    w = mesh.world_comm
    dropped = torch.tensor(metrics["emb_dropped"], dtype=torch.int64,
                           device=dev)
    metrics = {"loss_sum": w.all_reduce(metrics["loss_sum"]),
               "aux_sum": w.all_reduce(metrics["aux_sum"]),
               "emb_dropped": int(w.all_reduce(dropped))}
    return {"io": io_g, "segments": seg_grads}, metrics


# --------------------------------------------------------------------------- #
# Serving: KV-cache hooks + F handler over the same engine
# --------------------------------------------------------------------------- #


def make_cache_io(*, g_rank: int, Btot: int, mbs: int, paged: bool):
    """(cache_get, cache_put) hooks for this rank's layer-cache tree
    ``{"L{j}.<name>": [V, b_loc | n_loc, ...]}``.

    ``cache_get(tree, j, v, u)`` hands the stage every leaf of layer slot
    ``j`` (``L{j}.`` and a dot, so that L1 never matches L10; int8 page
    scales beside their pools too) at stage slot ``v``: a paged leaf
    whole (rows gather and scatter through their page tables), a
    contiguous one as micro-batch ``u``'s rows ``(g_rank·Btot + u)·mbs``
    onward. Both are views, which the cached layers write in place;
    ``cache_put`` copies back only a leaf the stage returned as a tensor
    of its own."""

    def cache_get(tree, j, v, u):
        pfx, out = f"L{j}.", {}
        for key, a in tree.items():
            if not key.startswith(pfx):
                continue
            start = (g_rank * Btot + u) * mbs
            out[key[len(pfx):]] = a[v] if paged else \
                a[v, start:start + mbs]
        return out

    def cache_put(tree, j, v, u, cd):
        views = cache_get(tree, j, v, u)
        for n, val in cd.items():
            if val.data_ptr() != views[n].data_ptr():
                views[n].copy_(val)
        return tree

    return cache_get, cache_put


def serve_body(params, caches, batch, *, rt, mbs: int, Btot: int,
               rope: dict, page_size: int = 0, want_logits: bool = False):
    """One rank's serve step on the tick engine (prefill chunk or decode).

    ``batch`` holds this rank's rows of the step's batch, on the device:
    ``tokens`` int [b_loc, s] (or a vision prefill's float embeddings
    [b_loc, s, d], which go in as they are), ``pos`` an int or an int
    [b_loc] tensor, optional ``slot_mask`` bool [b_loc] and
    ``page_tables`` int [b_loc, pages_per_slot] (shard-local page ids). ``caches`` is this rank's
    cache tree, written in place. Returns ``(tokens, caches)`` or
    ``(tokens, logits, caches)``: int32 [gb] and float32 [gb, vocab], the
    same on every rank (logits are not returned on a multi-pod mesh).
    An encoder-decoder walks its decoder segment, each micro-batch's
    cross-attention reading its rows of ``caches["enc_memory"]``."""
    cfg, rc = rt.cfg, rt.rc
    io_p = params["io"]
    Pe, G, p_rank, g_rank = rt.Pe, rt.G, rt.p_rank, rt.g_rank
    vloc, comm, mesh = rt.vloc, rt.comm, rt.mesh
    cdt = torch_dtype(rc.compute_dtype)
    tokens = batch["tokens"]
    pos = batch.get("pos", 0)
    slot_mask = batch.get("slot_mask")
    page_tables = batch.get("page_tables")
    per_slot = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if page_tables is not None and not (per_slot and page_size > 0):
        raise ValueError(
            "page_tables require a per-slot pos vector and page_size > 0")
    key = rt.seg_key
    seg = rt.segs[key]
    V, n_kinds = seg.vpp, len(seg.kinds)
    pt = rt.serve_plan().packed
    if (pt.reduce_v >= 0).any():
        raise ValueError("the serve table reduces gradients: it must be "
                         "forward-only")
    tree = caches[key]
    # an encoder-decoder's memory, [b_loc, enc_ctx, d] beside the caches
    memory = caches.get("enc_memory")
    dev = tokens.device
    s, d = tokens.shape[1], cfg.d_model
    eng = TickEngine(
        pt=pt, specs=rt.stage_specs[key], seg_p=params["segments"][key],
        flat=rt.flat_layouts[key], comm=comm, cdt=cdt,
        rs_dtype=torch.float32, p_rank=p_rank, mesh=mesh,
        act=((mbs, s, d), cdt), times=COLL_TIME,
        gatherable=rt.gatherable[key])
    st = eng.state
    st["xbuf"] = _Stash(pt.U, "fwd wire")
    tok_slice = make_tok_slice(g_rank, Btot, mbs)
    cache_get, cache_put = make_cache_io(g_rank=g_rank, Btot=Btot, mbs=mbs,
                                         paged=page_tables is not None)
    ctx = blocks.LayerCtx(cfg=cfg, rc=rc, rope=rope, causal=True,
                          page_size=page_size)
    out_tok = torch.zeros((G * Btot, mbs), dtype=torch.int32, device=dev)
    out_logits = None
    if want_logits:
        # vocabulary-sharded: the drain rank's slice for the rows of every
        # data rank (the all-gather in serve_logits), hence D·mbs rows
        lrows = (rt.dsize if vloc else 1) * mbs
        out_logits = torch.zeros((G * Btot, lrows, vloc or cfg.vocab),
                                 dtype=torch.float32, device=dev)

    def f_branch(eng, row):
        u, v = row["mb"], row["v"]
        if u >= Btot:
            # a micro-batch past a degenerate tiling (fewer rows than
            # groups x micro-batches: the table still runs every one).
            # The reference recomputes clamped rows there, re-applying
            # their state and overwriting a sampled token; here it is
            # inert: nothing is written or sampled, the wire carries zeros
            if not (p_rank == 0 and v == 0):
                st["xbuf"].pop(u)
            st["send_f"] = torch.zeros((mbs, s, d), dtype=cdt, device=dev)
            return
        if p_rank == 0 and v == 0:
            ids = tok_slice(tokens, u)
            x = (Vb.embed_lookup(io_p["embed.table"], ids, vloc, cdt, comm)
                 if vloc is not None and not ids.is_floating_point()
                 else M.embed_tokens(io_p, ids, cfg, cdt))
        else:
            x = st["xbuf"].pop(u)
        params_v = eng.stage_params(v, row["use_slot"])
        ctx.slot_mask = (tok_slice(slot_mask, u) if slot_mask is not None
                         else None)
        # the writing rows once a cell, not once a layer
        ctx.write_rows = (torch.nonzero(ctx.slot_mask).reshape(-1)
                          if slot_mask is not None else None)
        ctx.page_tables = (tok_slice(page_tables, u)
                           if page_tables is not None else None)
        if memory is not None:
            ctx.enc_memory = tok_slice(memory, u)
        ch = [cache_get(tree, j, v, u) for j in range(n_kinds)]
        y, ch2 = M.cached_stage(ctx, seg, params_v, x, ch, v * Pe + p_rank,
                                tok_slice(pos, u) if per_slot else pos)
        for j in range(n_kinds):
            cache_put(tree, j, v, u, ch2[j])
        st["send_f"] = y
        if p_rank == Pe - 1 and v == V - 1:
            h_last = y[:, -1]
            idx = g_rank * Btot + u % Btot
            out_tok[idx] = Vb.greedy_sample(cfg, rc, io_p, h_last, vloc,
                                            comm)
            if want_logits:
                out_logits[idx] = Vb.serve_logits(cfg, rc, io_p, h_last,
                                                  vloc, comm)

    eng.run({KF: f_branch})
    if st["xbuf"]:
        raise RuntimeError(f"serve table left live wires: {list(st['xbuf'])}")
    tok = out_tok.reshape(-1)
    logits = None
    if want_logits:
        if vloc is not None:
            # [G·Btot, D·mbs, vloc] -> [D·b_loc, vloc]: the pod's row r is
            # data rank r // b_loc's local row r % b_loc, and each u-block
            # holds every data rank's mbs rows
            D = rt.dsize
            logits = out_logits.reshape(G * Btot, D, mbs, vloc).transpose(
                0, 1).reshape(D * G * Btot * mbs, vloc)
        else:
            logits = out_logits.reshape(G * Btot * mbs, cfg.vocab)
    if mesh is None:
        return (tok, logits, caches) if want_logits else (tok, caches)
    # the drain ranks hold the sampled rows of their group: share them over
    # the model axis, then over the data and pod axes
    drain = p_rank == Pe - 1
    tok = mesh.model_comm.all_reduce(tok if drain else torch.zeros_like(tok))
    tok = mesh.pod_comm.all_gather(mesh.data_comm.all_gather(tok))
    if not want_logits:
        return tok, caches
    logits = mesh.model_comm.all_reduce(
        logits if drain else torch.zeros_like(logits))
    every = mesh.data_comm.all_gather(logits)
    if vloc is not None:
        # every data rank's vocabulary slice of the same rows, side by side
        D, n = rt.dsize, logits.shape[0]
        every = every.reshape(D, n, vloc).transpose(0, 1).reshape(n, D * vloc)
    return tok, every, caches
