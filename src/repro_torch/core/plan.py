"""SchedulePlan: the one schedule object that is built and run.

The port's copy of the runnable half of ``repro/core/plan.py``: the
``PackedTable`` the tick engine (``core/executor.py``) walks, ``pack_table``
(with the §3.3 gather prefetch) and ``SchedulePlan``. Unlike the
reference's, ``pack_table`` tracks which stage block each of the two
gather slots holds: at vpp > 2 a gather can evict a block that a later F
or B cell still reads, and such a block is gathered again before that
cell (or the table is refused); wherever the reference's table reads
only resident blocks (every table at vpp <= 2) the two are equal field
for field. The simulator
analyses, the cost presets and ``select_plan`` (``schedule="auto"``)
arrive with the ``auto`` slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.generators import SchedParams, generate
from repro_torch.core.schedules import B as KB
from repro_torch.core.schedules import F as KF
from repro_torch.core.schedules import KIND_NAMES as KIND
from repro_torch.core.schedules import W as KW
from repro_torch.core.schedules import (
    TickTable,
    to_arrays,
    unit_stash_violations,
)

# --------------------------------------------------------------------------- #
# Static table preprocessing (arrays for the executor)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class PackedTable:
    """Device-ready per-tick arrays [T, Pe] + static metadata."""

    T: int
    Pe: int            # ranks per pipeline group
    V: int
    U: int             # unit size (xbuf/stash depth)
    n_mb: int
    prefetch: int      # gather lead (ticks) the arrays were packed for
    kind: np.ndarray   # [T, Pe] {0 nop, 1 F, 2 B, 3 W}
    mb: np.ndarray     # [T, Pe] microbatch index
    v: np.ndarray      # [T, Pe] local stage slot
    gather_v: np.ndarray    # [T, Pe] slot to all-gather (-1 none)
    gather_slot: np.ndarray  # [T, Pe] double-buffer slot for that gather
    use_slot: np.ndarray    # [T, Pe] which buffer slot holds params of v
    reduce_v: np.ndarray    # [T, Pe] slot to reduce-scatter (-1 none)
    recv_f_u: np.ndarray    # [T, Pe] mb arriving on fwd wire this tick (-1)
    recv_b_u: np.ndarray    # [T, Pe] mb arriving on bwd wire this tick (-1)

    FIELDS = ("kind", "mb", "v", "gather_v", "gather_slot", "use_slot",
              "reduce_v", "recv_f_u", "recv_b_u")

    def row(self, t: int, p: int) -> dict[str, int]:
        """Tick t's cell of rank p, every field as a Python int."""
        return {f: int(getattr(self, f)[t, p]) for f in self.FIELDS}

    @property
    def has_w(self) -> bool:
        """False for fused-backward baselines (dW computed inside B)."""
        return bool((self.kind == KW).any())


def _assign_slots(kind, v, gv, forced):
    """One rank's slots: gathers alternate between the two slots (a
    re-gather in ``forced`` {tick: slot} takes its slot, and the next
    gather the other); an F or B cell reads the slot holding its block.
    Returns (gather_slot, use_slot, first tick whose F or B block is in
    neither slot, or None). A W cell reads no params and keeps the
    reference's slot: the one its block was last gathered into, else 0."""
    T = len(kind)
    gather_slot = -np.ones(T, np.int32)
    use_slot = np.zeros(T, np.int32)
    nxt, last, held, bad = 0, {}, [-1, -1], None
    for t in range(T):
        if gv[t] >= 0:
            s = forced.get(t, nxt)
            gather_slot[t] = s
            last[int(gv[t])] = s
            held[s] = int(gv[t])
            nxt = 1 - s
        if kind[t] in (KF, KB, KW):
            blk = int(v[t])
            s = last.get(blk, 0)
            if kind[t] != KW and held[s] != blk:
                if held[1 - s] == blk:
                    s = 1 - s
                elif bad is None:
                    bad = t
            use_slot[t] = s
    return gather_slot, use_slot, bad


def _next_use(kind, v, t, blk) -> int:
    """The first tick after ``t`` whose F or B cell reads ``blk``."""
    for u in range(t + 1, len(kind)):
        if kind[u] in (KF, KB) and v[u] == blk:
            return u
    return len(kind)


def _regather(kind, v, mb, gv, prefetch: int, p: int):
    """Slots of one rank's column, re-gathering every block that an F or
    B cell reads after a later gather evicted it (``gv`` is updated in
    place). Each re-gather goes at the earliest gather-free tick at most
    ``prefetch`` ticks before its cell, into the slot whose block is
    needed latest, where no cell between the re-gather and its own cell
    loses its block; the block's next gather is dropped when that keeps
    every cell up to the re-gathered one right (it would gather a block
    already held). Raises ValueError naming the first cell that no such
    re-gather can serve."""
    T = len(kind)
    forced: dict[int, int] = {}
    gs, us, bad = _assign_slots(kind, v, gv, forced)
    while bad is not None:
        blk, placed = int(v[bad]), False
        for c in range(max(0, bad - prefetch), bad + 1):
            if gv[c] >= 0:
                continue
            # the slot state just before tick c, to rank the victims
            held = [-1, -1]
            for t in range(c):
                if gv[t] >= 0:
                    held[gs[t]] = int(gv[t])
            victims = sorted((0, 1), key=lambda s: -_next_use(
                kind, v, c - 1, held[s]) if held[s] >= 0 else -T)
            later = [t for t in range(c + 1, T) if gv[t] == blk][:1]
            for s in victims:
                for drop in (later, []):
                    tgv = gv.copy()
                    tgv[c] = blk
                    tgv[drop] = -1
                    trial = {t: x for t, x in forced.items()
                             if t not in drop}
                    trial[c] = s
                    tgs, tus, tbad = _assign_slots(kind, v, tgv, trial)
                    if tbad is None or tbad > bad:
                        gv[:] = tgv
                        forced, gs, us, placed = trial, tgs, tus, True
                        break
                if placed:
                    break
            if placed:
                bad = tbad
                break
        if not placed:
            raise ValueError(
                f"no tick free to re-gather stage block {blk} for "
                f"{KIND[int(kind[bad])]}(u{mb[bad]}) at tick {bad} on stage "
                f"rank {p} "
                f"(prefetch {prefetch}): its gather slot was reused")
    return gs, us, bad


def slot_violations(pt: "PackedTable") -> list[str]:
    """The F and B cells of a packed table whose ``use_slot`` does not
    hold their stage block at their tick (empty when every cell reads its
    own block; W cells read no params)."""
    out = []
    for p in range(pt.Pe):
        held = [-1, -1]
        for t in range(pt.T):
            if pt.gather_v[t, p] >= 0:
                held[pt.gather_slot[t, p]] = int(pt.gather_v[t, p])
            k = int(pt.kind[t, p])
            if k in (KF, KB) and held[pt.use_slot[t, p]] != pt.v[t, p]:
                out.append(
                    f"{KIND[k]}(u{pt.mb[t, p]}) of stage block "
                    f"{pt.v[t, p]} at tick {t} on stage rank {p} reads "
                    f"slot {pt.use_slot[t, p]}, which holds block "
                    f"{held[pt.use_slot[t, p]]}")
    return out


def pack_table(tt: TickTable, prefetch: int = 0) -> PackedTable:
    # unit-gated stash legality: packed arrays drive U-deep executor
    # buffers, so a W-bearing table claiming unit < n_mb must fit the
    # stash-reuse window (B→W distance ≤ unit depth) before it can scan.
    if 0 < tt.unit < tt.n_mb:
        bad = unit_stash_violations(tt)
        if bad:
            raise ValueError(
                f"cannot pack table at unit depth {tt.unit}: "
                f"{len(bad)} stash violation(s), first: {bad[0]}")
    arr = to_arrays(tt)
    T, Pe = arr["kind"].shape
    V = tt.V
    kind, mb, v = arr["kind"], arr["mb"], arr["v"]
    gather_v = arr["gather"]
    reduce_v = arr["reduce"]

    if prefetch > 0:
        # §3.3 prefetch: start each stage-block gather up to `prefetch`
        # ticks before its first use so the async all-gather overlaps the
        # previous block's compute. Safe moves only: the target tick must
        # be gather-free, and no task between target and origin may still
        # be *reading* the destination buffer slot (the slot parity
        # alternates per gather, so skipping past reads of the other slot
        # is fine — we recompute slot assignments afterwards).
        for p_ in range(Pe):
            order = [t for t in range(T) if gather_v[t, p_] >= 0]
            for gi, t in enumerate(order):
                slot_parity = gi % 2
                tgt = t
                for back in range(1, prefetch + 1):
                    cand = t - back
                    if cand < 0 or gather_v[cand, p_] >= 0:
                        break
                    # reads of the same slot between cand and t?
                    conflict = False
                    for tt_ in range(cand, t):
                        if kind[tt_, p_] in (KF, KB, KW):
                            # which slot does that task read? parity of
                            # the most recent gather before tt_
                            prev = [g for g in order[:gi] if g <= tt_]
                            if prev and (len(prev) - 1) % 2 == slot_parity:
                                conflict = True
                                break
                    if conflict:
                        break
                    tgt = cand
                if tgt != t:
                    gather_v[tgt, p_] = gather_v[t, p_]
                    gather_v[t, p_] = -1

    # Two-slot gather buffer assignment, alternating as the reference's;
    # a block evicted before a cell reads it is gathered again.
    gather_slot = -np.ones((T, Pe), np.int32)
    use_slot = np.zeros((T, Pe), np.int32)
    for p in range(Pe):
        col = _regather(kind[:, p], v[:, p], mb[:, p], gather_v[:, p],
                        prefetch, p)
        gather_slot[:, p], use_slot[:, p], _ = col
    # Receive maps: what lands on each wire at the END of tick t-1 (i.e. is
    # available at tick t). Sender of fwd wire for rank p is p-1 (ring).
    recv_f_u = -np.ones((T, Pe), np.int32)
    recv_b_u = -np.ones((T, Pe), np.int32)
    S = Pe * V
    for t in range(1, T):
        for p in range(Pe):
            prev = (p - 1) % Pe
            if kind[t - 1, prev] == KF:
                stage = v[t - 1, prev] * Pe + prev
                if stage < S - 1:
                    recv_f_u[t, p] = mb[t - 1, prev]
            nxt_r = (p + 1) % Pe
            if kind[t - 1, nxt_r] == KB:
                stage = v[t - 1, nxt_r] * Pe + nxt_r
                if stage > 0:
                    recv_b_u[t, p] = mb[t - 1, nxt_r]
    return PackedTable(
        T=T, Pe=Pe, V=V, U=tt.unit, n_mb=tt.n_mb, prefetch=prefetch,
        kind=kind, mb=mb, v=v,
        gather_v=gather_v, gather_slot=gather_slot, use_slot=use_slot,
        reduce_v=reduce_v, recv_f_u=recv_f_u, recv_b_u=recv_b_u,
    )


# --------------------------------------------------------------------------- #
# SchedulePlan
# --------------------------------------------------------------------------- #


# Schedules whose tables gate micro-batches into §3.1 scheduling units:
# their buffers only need unit depth; every other schedule keeps the
# whole batch live (unit = n_mb).
UNIT_GATED_SCHEDULES = {"zeropp", "autogen_gated"}


@dataclasses.dataclass
class SchedulePlan:
    """A runnable schedule: the TickTable and the PackedTable the tick
    engine walks, derived from exactly that table."""

    name: str
    params: SchedParams
    table: TickTable
    packed: PackedTable
    prefetch: int = 0

    @classmethod
    def build(cls, name: str, sp: SchedParams, *,
              prefetch: int = 0) -> "SchedulePlan":
        """Generate a registered schedule's table and pack it."""
        return cls.from_table(name, sp, generate(name, sp),
                              prefetch=prefetch)

    @classmethod
    def from_table(cls, name: str, sp: SchedParams, tt: TickTable, *,
                   prefetch: int = 0) -> "SchedulePlan":
        try:
            packed = pack_table(tt, prefetch=prefetch)
        except ValueError as e:
            raise ValueError(f"schedule {name!r} at pp={sp.P}, vpp={sp.V}, "
                             f"{sp.n_mb} micro-batches: {e}") from e
        return cls(name=name, params=sp, table=tt, packed=packed,
                   prefetch=prefetch)
