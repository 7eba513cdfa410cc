"""§4 heuristic schedule auto-generation.

Faithful reproduction of the paper's algorithm:

1. Schedule the F and B passes gradient-fast-propagation style and postpone
   all W passes to the end (``w_fill="postpone"``).
2. Simulate ("profile the actual timeline" — profiled here with the cost
   model; ``schedule="auto_profiled"`` times the finalists' real steps).
3. Find the PP rank with the longest schedule, then the interleaved stage
   within that rank with the largest total bubble; insert a postponed W of
   that same stage (whose B is already complete and whose F precedes the
   bubble) into the largest such bubble.
4. Repeat — the longest rank may shift — until no insertion shortens the
   makespan.

The result is expressed as per-rank task orders and re-quantized into a
TickTable so it can be executed by the tick engine.

The port's copy of ``repro/core/autogen.py``. ``retick`` lives in
``core/generators.py`` (the interleaved construction needs it too) and is
re-exported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.generators import SchedParams, generate, retick
from repro_torch.core.schedules import B, W, Task, TickTable, slot_of
from repro_torch.core.simulator import CostModel, simulate

__all__ = ["AutogenResult", "autogen", "orders_from_table", "retick"]


def orders_from_table(tt: TickTable) -> list[list[Task]]:
    orders: list[list[Task]] = [[] for _ in range(tt.P)]
    for t, r, task in tt.tasks():
        orders[r].append(task)
    return orders


@dataclasses.dataclass
class AutogenResult:
    table: TickTable
    makespan_before: float
    makespan_after: float
    n_insertions: int
    log: list[str]
    # simulated makespan after init and after each accepted W insertion —
    # §4's loop only accepts strictly-improving moves, so this is
    # monotonically non-increasing (tests/test_torch_autogen.py)
    makespans: list[float] = dataclasses.field(default_factory=list)


def autogen(sp: SchedParams, cm: CostModel, max_iters: int = 2000, *,
            unit_gated: bool = False) -> AutogenResult:
    """Run the §4 loop starting from the postponed-W fast-propagation
    schedule.

    unit_gated=False (the registered ``"autogen"`` schedule) postpones W
    across the whole step, so the result needs full-depth (n_mb) stash
    buffers. unit_gated=True (``"autogen_gated"``) postpones W only to the
    tail of its own §3.1 scheduling unit and constrains every insertion to
    bubbles inside that unit's live window, so stash depth stays ``sp.U``
    and the paper's O(U) activation-memory bound survives; each trial is
    re-quantized with ``retick(unit_gated=True)``, whose stash-legality
    gate rejects any move that would stretch a B→W distance past the
    unit-depth buffers. Gated insertions also scan candidates first-in-
    first-out (lowest task index first) instead of most-postponed-first,
    preserving the per-(rank, stage-slot) W execution order of the greedy
    zeropp table — which keeps gradient accumulation order, and therefore
    bits, identical to the baseline schedule.
    """
    U = sp.U if unit_gated else sp.n_mb
    base = _postponed(sp, per_unit=unit_gated)
    orders = orders_from_table(base)
    P, V = sp.P, sp.V
    tt = retick(orders, P, V, sp.n_mb, sp.U, unit_gated=unit_gated)
    res = simulate(tt, cm)
    t0 = res.makespan
    log = [f"init makespan {t0:.3f}"]
    n_ins = 0
    history = [t0]

    for it in range(max_iters):
        res = simulate(tt, cm)
        # rank with the longest schedule
        last_end = np.zeros(P)
        for (k, u, s), e in res.task_end.items():
            last_end[s % P] = max(last_end[s % P], e)
        r_star = int(np.argmax(last_end))
        order = orders[r_star]
        # bubbles on r_star: gaps between consecutive tasks
        gaps = []  # (size, after_index, gap_start)
        for i in range(len(order) - 1):
            a = (order[i].kind, order[i].mb, order[i].stage)
            b2 = (order[i + 1].kind, order[i + 1].mb, order[i + 1].stage)
            gap = res.task_start[b2] - res.task_end[a]
            if gap > 1e-9:
                gaps.append((gap, i, res.task_end[a]))
        if not gaps:
            log.append(f"iter {it}: no bubbles on longest rank r{r_star}")
            break
        # group bubbles by the interleaved stage of the *preceding* task
        by_v: dict[int, float] = {}
        for gap, i, _ in gaps:
            v = slot_of(order[i].stage, P)
            by_v[v] = by_v.get(v, 0.0) + gap
        v_star = max(by_v, key=by_v.get)
        cands = [(g, i, gs) for (g, i, gs) in gaps
                 if slot_of(order[i].stage, P) == v_star]
        cands.sort(reverse=True)
        inserted = False
        for gap, i, gap_start in cands:
            # find a postponed W of stage slot v_star on r_star whose B is
            # done before the gap and which currently sits *after* i.
            # Gated mode scans forward (FIFO: the earliest such W moves
            # first, keeping per-slot W order) and only into bubbles of
            # the W's own unit (per-rank unit blocks stay contiguous, so
            # unit-depth stash reuse and per-unit reduce batching hold);
            # full-depth mode keeps the original most-postponed-first scan.
            j_range = (range(i + 1, len(order)) if unit_gated
                       else range(len(order) - 1, i, -1))
            for j in j_range:
                tsk = order[j]
                if tsk.kind != W or slot_of(tsk.stage, P) != v_star:
                    continue
                if unit_gated and order[i].mb // U != tsk.mb // U:
                    continue  # bubble outside this W's unit live window
                bkey = (B, tsk.mb, tsk.stage)
                if bkey not in res.task_end or res.task_end[bkey] > gap_start:
                    continue
                cand = order[: i + 1] + [tsk] + [
                    o for idx2, o in enumerate(order) if idx2 > i and idx2 != j
                ]
                trial_orders = [list(o) for o in orders]
                trial_orders[r_star] = cand
                try:
                    trial_tt = retick(trial_orders, P, V, sp.n_mb, sp.U,
                                      unit_gated=unit_gated)
                except RuntimeError:
                    continue
                trial_res = simulate(trial_tt, cm)
                if trial_res.makespan < res.makespan - 1e-12:
                    orders = trial_orders
                    tt = trial_tt
                    n_ins += 1
                    history.append(trial_res.makespan)
                    log.append(
                        f"iter {it}: moved {tsk} into {gap:.3f} bubble on "
                        f"r{r_star} v{v_star} -> {trial_res.makespan:.3f}"
                    )
                    inserted = True
                break
            if inserted:
                break
        if not inserted:
            log.append(f"iter {it}: no W insertion improves r{r_star}")
            break

    final = simulate(tt, cm)
    return AutogenResult(tt, t0, final.makespan, n_ins, log,
                         makespans=history)


def _postponed(sp: SchedParams, per_unit: bool = False) -> TickTable:
    """F/B fast-propagation with W postponed to the tail (§4 step 1).

    per_unit=False: every W moves to the very end of its rank's order
    (the paper's full-depth starting point). per_unit=True: each W only
    moves to the tail of its own scheduling unit's block, so unit blocks
    stay contiguous per rank and unit-depth stash reuse stays legal.
    """
    tt = generate("zeropp", sp)
    orders = orders_from_table(tt)
    U = sp.U
    for r in range(len(orders)):
        if per_unit:
            n_units = -(-sp.n_mb // U)
            blocks: list[Task] = []
            for n in range(n_units):
                blk = [t for t in orders[r] if t.mb // U == n]
                blocks += [t for t in blk if t.kind != W]
                blocks += [t for t in blk if t.kind == W]
            orders[r] = blocks
        else:
            fb = [t for t in orders[r] if t.kind != W]
            ws = [t for t in orders[r] if t.kind == W]
            orders[r] = fb + ws
    return retick(orders, sp.P, sp.V, sp.n_mb, sp.U,
                  unit_gated=per_unit)
