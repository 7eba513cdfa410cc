"""Schedule generators: ZeroPP + every baseline the paper compares against.

The port's copy of ``repro/core/generators.py``: zeropp, gpipe, 1f1b,
bfs, interleaved and fwd_only, with ``retick`` (from
``repro/core/autogen.py``) for the explicit interleaved construction. The
§4 auto-generated schedules (``autogen``, ``autogen_gated``) arrive with
the ``auto`` slice.

All schedules are produced by one greedy list scheduler driven by
per-method task priorities and gating rules, then packed into a TickTable.
This mirrors how the paper builds schedules (§3.2: blockwise F order, input
gradients as early as possible, weight gradients into bubbles; §3.1: units
are strictly sequential so their memory can be reused).

Baselines (gpipe / 1f1b / interleaved / bfs) do not split the backward:
they carry F and fused-B tasks only (``split_bw=False``), exactly like the
methods they model.

Every built-in is registered in the schedule registry
(``repro_torch.api.registry``); new schedules plug in without touching this
file — register a ``(SchedParams) -> TickTable`` builder (usually a thin
wrapper over ``greedy_schedule`` with a custom priority).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.api.registry import register_schedule
from repro_torch.core.schedules import (
    B,
    F,
    NOP,
    W,
    Task,
    TickTable,
    rank_of,
    slot_of,
    stage_of,
    unit_stash_violations,
)


@dataclasses.dataclass(frozen=True)
class SchedParams:
    P: int
    V: int
    n_mb: int
    unit: int = 0            # U; 0 -> n_mb (single unit)
    split_bw: bool = True    # ZeroPP-style dx/dW separation
    w_fill: str = "greedy"   # greedy | postpone (autogen then inserts)
    spill_w: bool = False    # beyond-paper: let W spill into the next unit

    @property
    def U(self) -> int:
        return self.unit or self.n_mb


def _unit_of(u: int, sp: SchedParams) -> int:
    return u // sp.U


def generate(method: str, sp: SchedParams) -> TickTable:
    """Build the TickTable for any registered schedule by name."""
    from repro_torch.api.registry import SCHEDULE_REGISTRY

    return SCHEDULE_REGISTRY.get(method)(sp)


def _interleaved(sp: SchedParams) -> TickTable:
    """Megatron-style interleaved 1F1B (explicit construction).

    Virtual micro-batches are processed chunk-major in groups of P; each
    rank warms up with (P−r−1)·2 + (V−1)·P forwards then alternates 1F1B.
    """
    P, V, n_mb = sp.P, sp.V, sp.n_mb
    total = n_mb * V

    def f_task(k: int, r: int) -> Task:
        chunk = (k % (P * V)) // P
        mb = P * (k // (P * V)) + (k % P)
        return Task(F, mb, stage_of(r, chunk, P))

    def b_task(k: int, r: int) -> Task:
        chunk = V - 1 - (k % (P * V)) // P
        mb = P * (k // (P * V)) + (k % P)
        return Task(B, mb, stage_of(r, chunk, P))

    orders: list[list[Task]] = []
    for r in range(P):
        warmup = min((P - r - 1) * 2 + (V - 1) * P, total)
        order = [f_task(k, r) for k in range(warmup)]
        nf, nb = warmup, 0
        while nf < total or nb < total:
            if nf < total:
                order.append(f_task(nf, r))
                nf += 1
            if nb < total:
                order.append(b_task(nb, r))
                nb += 1
        orders.append(order)
    return retick(orders, P, V, n_mb, sp.U)


# --------------------------------------------------------------------------- #
# Re-quantising per-rank orders (from repro/core/autogen.py)
# --------------------------------------------------------------------------- #


def retick(orders: list[list[Task]], P: int, V: int, n_mb: int,
           unit: int, assume_f: bool = False,
           unit_gated: bool = False) -> TickTable:
    """Quantize per-rank orders into the densest valid tick table.

    assume_f: treat all F tasks as already done (encoder-backward tables,
    whose forwards ran in a previous segment scan).
    unit_gated: additionally reject (RuntimeError) any quantization whose
    B→W / stash distances exceed the unit-depth buffers — the legality
    gate the gated §4 insertion loop leans on to discard trial moves.
    """
    S = P * V
    pos = [0] * P
    placed: dict[tuple, int] = {}
    if assume_f:
        for u in range(n_mb):
            for s in range(S):
                placed[(F, u, s)] = -1
    grid: list[list[Task | None]] = []
    total = sum(len(o) for o in orders)
    done = 0
    t = 0
    while done < total and t < total * 3 + 64:
        row: list[Task | None] = [None] * P
        for r in range(P):
            if pos[r] >= len(orders[r]):
                continue
            task = orders[r][pos[r]]
            deps = []
            if task.kind == F and task.stage > 0:
                deps.append((F, task.mb, task.stage - 1))
            if task.kind == B:
                deps.append((F, task.mb, task.stage))
                if task.stage < S - 1:
                    deps.append((B, task.mb, task.stage + 1))
            if task.kind == W:
                deps.append((B, task.mb, task.stage))
            if all(d in placed and placed[d] < t for d in deps):
                row[r] = task
        for r in range(P):
            if row[r] is not None:
                placed[(row[r].kind, row[r].mb, row[r].stage)] = t
                pos[r] += 1
                done += 1
        grid.append(row)
        t += 1
    if done < total:
        raise RuntimeError("retick failed: invalid order")
    tt = TickTable(P=P, V=V, n_mb=n_mb, unit=unit, grid=grid)
    if unit_gated:
        bad = unit_stash_violations(tt)
        if bad:
            raise RuntimeError(
                f"retick: order illegal at unit depth {unit}: {bad[0]}")
    attach_fsdp_events(tt)
    return tt


# --------------------------------------------------------------------------- #
# Greedy list scheduler
# --------------------------------------------------------------------------- #


def _prio_fwd_only(sp: SchedParams, kind: int, u: int, s: int):
    return (slot_of(s, sp.P), u, s)


def _prio_gpipe(sp: SchedParams, kind: int, u: int, s: int):
    # strict F-then-B phases, microbatch-major
    return (0 if kind == F else 1, slot_of(s, sp.P), u, s)


def _prio_bfs(sp: SchedParams, kind: int, u: int, s: int):
    # breadth-first by stage (v-major blocks), GPipe-like phases
    v = slot_of(s, sp.P)
    return (0 if kind == F else 1, v if kind == F else (sp.V - 1 - v), u)


def _prio_1f1b(sp: SchedParams, kind: int, u: int, s: int):
    # backward as early as possible (classic 1F1B emerges greedily)
    return (0 if kind == B else 1, u, slot_of(s, sp.P))


def _prio_interleaved(sp: SchedParams, kind: int, u: int, s: int):
    # megatron-style chunked round-robin: groups of P micro-batches
    v = slot_of(s, sp.P)
    if kind == B:
        return (0, u, sp.V - 1 - v)
    return (1, u // sp.P, v, u % sp.P)


def _prio_zeropp(sp: SchedParams, kind: int, u: int, s: int):
    # per-unit blocks; B first (input grads as early as possible,
    # breadth-first by stage block §3.2), blockwise F (v-major within
    # unit), W lowest (fills bubbles greedily).
    v = slot_of(s, sp.P)
    unit = _unit_of(u, sp)
    if kind == B:
        return (unit, 0, sp.V - 1 - v, u)
    if kind == F:
        return (unit, 1, v, u)
    return (unit, 2, v, u)  # W


def greedy_schedule(sp: SchedParams, priority, *, name: str = "custom",
                    split_bw: bool = False, fwd_only: bool = False,
                    unit_gated: bool = False) -> TickTable:
    """Greedy list scheduler driven by ``priority(sp, kind, u, s)``.

    ``split_bw`` generates separate W (weight-grad) tasks when the
    SchedParams ask for it; ``unit_gated`` enforces ZeroPP's per-unit
    memory-reuse gating. This is the building block custom registered
    schedules compose (see the registered built-ins below).
    """
    P, V, n_mb = sp.P, sp.V, sp.n_mb
    S = P * V
    split = sp.split_bw and split_bw

    # --- build the task set and dependency map --------------------------- #
    tasks: list[tuple[int, int, int]] = []  # (kind, u, s)
    for u in range(n_mb):
        for s in range(S):
            tasks.append((F, u, s))
            if not fwd_only:
                tasks.append((B, u, s))
                if split:
                    tasks.append((W, u, s))

    deps: dict[tuple, list[tuple]] = {t: [] for t in tasks}
    for u in range(n_mb):
        for s in range(S):
            if s > 0:
                deps[(F, u, s)].append((F, u, s - 1))
            if fwd_only:
                continue
            deps[(B, u, s)].append((F, u, s))
            if s < S - 1:
                deps[(B, u, s)].append((B, u, s + 1))
            if split:
                deps[(W, u, s)].append((B, u, s))
    # unit gating: nothing of unit n+1 starts before unit n fully done
    # (ZeroPP memory-reuse semantics; other methods use a single unit).
    if unit_gated and sp.U < n_mb:
        n_units = -(-n_mb // sp.U)
        unit_tasks = {n: [] for n in range(n_units)}
        for t in tasks:
            unit_tasks[_unit_of(t[1], sp)].append(t)
        for n in range(1, n_units):
            prev = [
                t for t in unit_tasks[n - 1]
                if t[0] != W or not sp.spill_w
            ]
            # gate only the F tasks of the next unit (B/W follow F anyway)
            for t in unit_tasks[n]:
                if t[0] == F and slot_of(t[2], P) == 0:
                    deps[t].extend(prev)

    # --- greedy tick loop (indegree-tracked list scheduling) -------------- #
    dependents: dict[tuple, list[tuple]] = {t_: [] for t_ in tasks}
    indeg: dict[tuple, int] = {}
    for t_, ds in deps.items():
        indeg[t_] = len(ds)
        for d in ds:
            dependents[d].append(t_)

    avail: list[list] = [[] for _ in range(P)]  # heaps of (prio, task)
    for t_ in tasks:
        if indeg[t_] == 0:
            heapq.heappush(
                avail[rank_of(t_[2], P)], (priority(sp, *t_), t_)
            )

    n_left = len(tasks)
    grid: list[list[Task | None]] = []
    staged: list[tuple] = []  # become available next tick
    max_ticks = len(tasks) * 3 + 64
    t = 0
    while n_left and t < max_ticks:
        row: list[Task | None] = [None] * P
        completed = []
        for r in range(P):
            if avail[r]:
                _, (k, u, s) = heapq.heappop(avail[r])
                row[r] = Task(k, u, s)
                completed.append((k, u, s))
                n_left -= 1
        grid.append(row)
        # tasks enabled by this tick's completions are usable from t+1
        for c in completed:
            for dep in dependents[c]:
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    staged.append(dep)
        for t_ in staged:
            heapq.heappush(
                avail[rank_of(t_[2], P)], (priority(sp, *t_), t_)
            )
        staged = []
        t += 1
    if n_left:
        raise RuntimeError(
            f"schedule {name} did not converge: {n_left} tasks left"
        )

    tt = TickTable(P=P, V=V, n_mb=n_mb, unit=sp.U, grid=grid)
    attach_fsdp_events(tt)
    return tt


# --------------------------------------------------------------------------- #
# Built-in schedules (registered; new ones plug in the same way)
# --------------------------------------------------------------------------- #


@register_schedule("zeropp")
def _gen_zeropp(sp: SchedParams) -> TickTable:
    return greedy_schedule(sp, _prio_zeropp, name="zeropp",
                           split_bw=True, unit_gated=True)


@register_schedule("gpipe")
def _gen_gpipe(sp: SchedParams) -> TickTable:
    return greedy_schedule(sp, _prio_gpipe, name="gpipe")


@register_schedule("1f1b")
def _gen_1f1b(sp: SchedParams) -> TickTable:
    return greedy_schedule(sp, _prio_1f1b, name="1f1b")


@register_schedule("bfs")
def _gen_bfs(sp: SchedParams) -> TickTable:
    return greedy_schedule(sp, _prio_bfs, name="bfs")


@register_schedule("interleaved")
def _gen_interleaved(sp: SchedParams) -> TickTable:
    if sp.n_mb % sp.P == 0 and sp.V > 1:
        return _interleaved(sp)
    return greedy_schedule(sp, _prio_interleaved, name="interleaved")


@register_schedule("fwd_only")
def _gen_fwd_only(sp: SchedParams) -> TickTable:
    return greedy_schedule(sp, _prio_fwd_only, name="fwd_only",
                           fwd_only=True)


# --------------------------------------------------------------------------- #
# FSDP communication events (blockwise gathers, per-unit reduce-scatters)
# --------------------------------------------------------------------------- #


def attach_fsdp_events(tt: TickTable) -> None:
    """Gather before first use per (unit, v, phase); reduce after last
    weight-grad per (unit, v). Mirrors §3.3: 2V−1 gathers per unit (the
    F-phase gather of the last stage block is still resident when its
    backward starts)."""
    T, P, V, U = tt.T, tt.P, tt.V, tt.unit
    gather = -np.ones((T, P), np.int32)
    reduce = -np.ones((T, P), np.int32)
    first_use: dict[tuple, int] = {}   # (r, unit, v, phase) -> tick
    last_w: dict[tuple, int] = {}      # (r, unit, v) -> tick
    for t, r, task in tt.tasks():
        unit = task.mb // U
        v = slot_of(task.stage, P)
        phase = 0 if task.kind == F else 1
        key = (r, unit, v, phase)
        if task.kind in (F, B) and key not in first_use:
            first_use[key] = t
        if task.kind in (W, B):
            k2 = (r, unit, v)
            last_w[k2] = max(last_w.get(k2, -1), t)
    for (r, unit, v, phase), t in first_use.items():
        if phase == 1:
            # reuse: no re-gather if this block's F-phase gather is still
            # resident, i.e. no other stage block was gathered in between
            # (the buffer holds one stage block, §3.4).
            f_t = first_use.get((r, unit, v, 0))
            intervening = [
                tf for (r2, u2, v2, p2), tf in first_use.items()
                if r2 == r and (u2, v2, p2) != (unit, v, 0)
                and f_t is not None and f_t < tf <= t
                and not (u2 == unit and v2 == v and p2 == 1)
            ]
            if f_t is not None and not intervening:
                continue
        gather[t, r] = v
    for (r, unit, v), t in last_w.items():
        reduce[t, r] = v
    tt.gather = gather
    tt.reduce = reduce
