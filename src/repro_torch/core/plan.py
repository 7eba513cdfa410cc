"""SchedulePlan: the one schedule object that is built and run.

The port's copy of the runnable half of ``repro/core/plan.py``: the
``PackedTable`` the tick engine (``core/executor.py``) walks, ``pack_table``
(with the §3.3 gather prefetch) and ``SchedulePlan``. The simulator
analyses, the cost presets and ``select_plan`` (``schedule="auto"``)
arrive with the ``auto`` slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.generators import SchedParams, generate
from repro_torch.core.schedules import B as KB
from repro_torch.core.schedules import F as KF
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

    # Rotating two-slot gather buffer assignment.
    gather_slot = -np.ones((T, Pe), np.int32)
    use_slot = np.zeros((T, Pe), np.int32)
    for p in range(Pe):
        nxt = 0
        holds = {}  # v -> slot
        for t in range(T):
            if gather_v[t, p] >= 0:
                gather_slot[t, p] = nxt
                holds[gather_v[t, p]] = nxt
                nxt = 1 - nxt
            if kind[t, p] in (KF, KB, KW):
                use_slot[t, p] = holds.get(v[t, p], 0)

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
        return cls(name=name, params=sp, table=tt,
                   packed=pack_table(tt, prefetch=prefetch),
                   prefetch=prefetch)
