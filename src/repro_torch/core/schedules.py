"""Schedule IR: typed tasks, per-rank tick tables, and validity checking.

The port's copy of ``repro/core/schedules.py`` (numpy only; the port's
tick engine is ``core/executor.py``, an eager loop over the table).

A schedule is materialized as a dense tick table ``[T, P]`` of
``(kind, mb, v)`` cells plus per-tick FSDP communication events. The same
table drives (a) the discrete-event simulator (with a real cost model) and
(b) the executor (core/executor.py), so what we analyze is exactly
what runs.

Task kinds (int codes used in device tables):
  NOP=0, F=1, B=2 (input-grad, includes the remat re-forward), W=3
  (weight-grad GEMMs), and for serving F-only tables.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

NOP, F, B, W = 0, 1, 2, 3
KIND_NAMES = {NOP: "·", F: "F", B: "B", W: "W"}


@dataclasses.dataclass(frozen=True)
class Task:
    kind: int
    mb: int      # microbatch index within the step (0..n_mb-1)
    stage: int   # global stage id (0..S-1)

    def __repr__(self):
        return f"{KIND_NAMES[self.kind]}(u{self.mb},s{self.stage})"


@dataclasses.dataclass
class TickTable:
    """Dense schedule: cell [t, r] = Task or None. Plus comm events."""

    P: int                      # ranks per pipeline group
    V: int                      # stage slots per rank
    n_mb: int                   # B micro-batches
    unit: int                   # U scheduling-unit size
    grid: list[list[Task | None]]            # [T][P]
    # FSDP events: per tick per rank, gather/reduce of local slot v (or -1).
    gather: np.ndarray | None = None         # [T, P] int, -1 = none
    reduce: np.ndarray | None = None         # [T, P] int, -1 = none
    segment: str = "main"

    @property
    def T(self) -> int:
        return len(self.grid)

    def tasks(self) -> Iterable[tuple[int, int, Task]]:
        for t, row in enumerate(self.grid):
            for r, task in enumerate(row):
                if task is not None:
                    yield t, r, task

    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        """Check dependency, placement and completeness invariants."""
        P, V, n_mb = self.P, self.V, self.n_mb
        S = P * V
        start: dict[tuple[int, int, int], int] = {}
        for t, r, task in self.tasks():
            assert 0 <= task.stage < S, f"bad stage {task}"
            assert task.stage % P == r, (
                f"task {task} at rank {r}: circular placement requires "
                f"rank {task.stage % P}"
            )
            key = (task.kind, task.mb, task.stage)
            assert key not in start, f"duplicate {task}"
            start[key] = t

        # completeness
        has_bwd = any(k == B for (k, _, _) in start)
        has_w = any(k == W for (k, _, _) in start)
        for u in range(n_mb):
            for s in range(S):
                assert (F, u, s) in start, f"missing F(u{u},s{s})"
                if has_bwd:
                    assert (B, u, s) in start, f"missing B(u{u},s{s})"
                if has_w:
                    assert (W, u, s) in start, f"missing W(u{u},s{s})"

        # dependencies (producer tick < consumer tick; ppermute delivers
        # at the tick boundary)
        for (k, u, s), t in start.items():
            if k == F and s > 0:
                assert start[(F, u, s - 1)] < t, f"F dep violated u{u} s{s}"
            if k == B:
                assert start[(F, u, s)] < t, f"B needs F u{u} s{s}"
                if s < S - 1:
                    assert start[(B, u, s + 1)] < t, f"B dep violated u{u} s{s}"
            if k == W:
                assert start[(B, u, s)] <= t, f"W needs B u{u} s{s}"

        # unit-depth stash legality: a split-backward table claiming
        # ``unit < n_mb`` must actually be runnable on U-deep buffers
        # (fused baselines may carry a nominal unit label; they are
        # executed full-depth, so only W-bearing tables are gated here).
        if has_w and 0 < self.unit < self.n_mb:
            bad = unit_stash_violations(self)
            assert not bad, (
                f"table claims unit depth {self.unit} but violates the "
                f"stash-reuse window ({len(bad)} violation(s)): {bad[0]}")

    # ------------------------------------------------------------------ #
    def render(self, max_ticks: int | None = None) -> str:
        """ASCII timeline (ranks × ticks)."""
        out = []
        Tt = min(self.T, max_ticks or self.T)
        for r in range(self.P):
            row = []
            for t in range(Tt):
                task = self.grid[t][r]
                if task is None:
                    row.append(" · ")
                else:
                    row.append(
                        f"{KIND_NAMES[task.kind]}{task.mb:<2d}"
                    )
            out.append(f"r{r:<2d} " + "".join(row))
        return "\n".join(out)

    def counts(self) -> dict[str, int]:
        c = {"F": 0, "B": 0, "W": 0, "nop": 0, "gather": 0, "reduce": 0}
        for t, row in enumerate(self.grid):
            for r, task in enumerate(row):
                if task is None:
                    c["nop"] += 1
                else:
                    c[KIND_NAMES[task.kind]] += 1
        if self.gather is not None:
            c["gather"] = int((self.gather >= 0).sum())
        if self.reduce is not None:
            c["reduce"] = int((self.reduce >= 0).sum())
        return c

    def bubble_ratio(self) -> float:
        """Fraction of (tick, rank) slots idle between each rank's first
        and last task — the tick-quantized pipeline-bubble measure."""
        idle = 0
        span = 0
        for r in range(self.P):
            ticks = [t for t in range(self.T) if self.grid[t][r] is not None]
            if not ticks:
                continue
            lo, hi = ticks[0], ticks[-1]
            span += hi - lo + 1
            idle += (hi - lo + 1) - len(ticks)
        return idle / max(span, 1)


def unit_stash_violations(tt: "TickTable") -> list[str]:
    """Unit-depth buffer legality: the reasons a table with ``unit < n_mb``
    could NOT run on U-deep stash/wire buffers.

    The executor (core/executor.py) holds every per-micro-batch buffer at
    unit depth, indexed by ``mb % U``: ``fstash``/``wx``/``wdy`` (the F→B
    activation and B→W (x, dy) stashes) and ``xbuf``/``bbuf`` (the wire
    landing buffers). Micro-batch ``u + U`` therefore *overwrites* micro-
    batch ``u``'s slot, so every reader of slot ``u % U`` must run before
    the overwrite lands:

      * ``W(u, s)`` before ``B(u+U, s)``   — the B→W (x, dy) stash; this
        is the "B→W distance exceeds the unit-depth stash" check the §4
        postponed-W tables used to violate;
      * ``B(u, s)`` before ``F(u+U, s)``   — the F→B activation stash;
      * ``F(u, s)`` no later than ``F(u+U, s-1)`` — the fwd wire buffer
        (the overwriting activation lands one tick after its producer);
      * ``B(u, s)`` no later than ``B(u+U, s+1)`` — the bwd wire buffer.

    Pairwise-nearest checks suffice: together with the task dependencies
    they order all same-slot occupants transitively. Returns a list of
    human-readable violations (empty = legal at depth ``tt.unit``).

    The same window rules gate packed tables at the engine boundary
    (``core/executor.py:validate_unit_stash_packed``) through
    ``stash_window_violations`` below, so the two layers cannot drift.
    """
    tick = {(task.kind, task.mb, task.stage): t
            for t, _, task in tt.tasks()}
    return stash_window_violations(tick, tt.unit, tt.n_mb, tt.P * tt.V)


def stash_window_violations(tick: dict, U: int, n_mb: int, S: int,
                            ) -> list[str]:
    """The shared stash-window rule set over a (kind, mb, stage) → tick
    map (see ``unit_stash_violations`` for the derivation)."""
    if U <= 0 or U >= n_mb:
        return []
    out: list[str] = []

    def _chk(a, b, strict, what):
        ta, tb = tick.get(a), tick.get(b)
        if ta is None or tb is None:
            return
        if (ta >= tb) if strict else (ta > tb):
            out.append(
                f"{what}: {KIND_NAMES[a[0]]}(u{a[1]},s{a[2]})@t{ta} vs "
                f"{KIND_NAMES[b[0]]}(u{b[1]},s{b[2]})@t{tb} "
                f"(unit depth {U})")

    for u in range(n_mb - U):
        for s in range(S):
            _chk((W, u, s), (B, u + U, s), True, "B->W stash overwrite")
            _chk((B, u, s), (F, u + U, s), True, "F->B stash overwrite")
            if s > 0:
                _chk((F, u, s), (F, u + U, s - 1), False,
                     "fwd wire overwrite")
            if s < S - 1:
                _chk((B, u, s), (B, u + U, s + 1), False,
                     "bwd wire overwrite")
    return out


def stage_of(rank: int, v: int, P: int) -> int:
    return v * P + rank


def rank_of(stage: int, P: int) -> int:
    return stage % P


def slot_of(stage: int, P: int) -> int:
    return stage // P


def to_arrays(tt: TickTable):
    """Pack the table into device-ready int32 arrays.

    Returns dict of [T, P] arrays: kind, mb, v  (+ gather/reduce slots).
    """
    T, P = tt.T, tt.P
    kind = np.zeros((T, P), np.int32)
    mb = np.zeros((T, P), np.int32)
    v = np.zeros((T, P), np.int32)
    for t, r, task in tt.tasks():
        kind[t, r] = task.kind
        mb[t, r] = task.mb
        v[t, r] = slot_of(task.stage, P)
    gather = tt.gather if tt.gather is not None else -np.ones((T, P), np.int32)
    reduce = tt.reduce if tt.reduce is not None else -np.ones((T, P), np.int32)
    return {
        "kind": kind, "mb": mb, "v": v,
        "gather": gather.astype(np.int32), "reduce": reduce.astype(np.int32),
    }
