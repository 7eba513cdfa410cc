"""SchedulePlan: the one schedule object that is built and run.

The port's copy of the runnable half of ``repro/core/plan.py``: the
``PackedTable`` the tick engine (``core/executor.py``) walks, ``pack_table``
(with the §3.3 gather prefetch) and ``SchedulePlan``. Unlike the
reference's, ``pack_table`` tracks which stage block each of the two
gather slots holds: at vpp > 2 a gather can evict a block that a later F
or B cell still reads, and such a block is gathered again before that
cell (or the table is refused); wherever the reference's table reads
only resident blocks (every table at vpp <= 2) the two are equal field
for field.

The selection half follows ``repro/core/plan.py``: per-preset
``PlanAnalysis`` (the discrete-event simulator, ``core/simulator.py``),
the A800 cost preset (the reference's TPU preset is not carried),
``select_plan`` — the §4 selection behind ``schedule="auto"`` and, with a
``measure_fn``, ``"auto_profiled"`` — and its in-memory and persisted
(``core/plan_cache.py``) caches. On a mesh of ranks ``select_plan`` runs
on every rank alike (it is deterministic); ``sync`` makes the profiling
budget's clock the same on every rank.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core.generators import SchedParams, generate, retick
from repro_torch.core.schedules import B as KB
from repro_torch.core.schedules import F as KF
from repro_torch.core.schedules import KIND_NAMES as KIND
from repro_torch.core.schedules import W as KW
from repro_torch.core.schedules import (
    TickTable,
    to_arrays,
    unit_stash_violations,
)
from repro_torch.core.simulator import (
    A800,
    CostModel,
    cost_model_for,
    simulate,
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


def strip_fwd(tt: TickTable) -> TickTable:
    """The B / W tasks of ``tt`` alone, re-ticked with every F taken as
    done: the encoder's backward table, whose forwards ran in an earlier
    walk (the reference's ``strip_fwd``)."""
    from repro_torch.core.autogen import orders_from_table
    orders = [[task for task in o if task.kind != KF]
              for o in orders_from_table(tt)]
    return retick(orders, tt.P, tt.V, tt.n_mb, tt.unit, assume_f=True)


# --------------------------------------------------------------------------- #
# SchedulePlan
# --------------------------------------------------------------------------- #


def table_digest(tt: TickTable) -> str:
    """sha256 of a table's arrays (``to_arrays``): the ranks of a mesh
    compare it to check that they run the same plan."""
    h = hashlib.sha256()
    for k, a in sorted(to_arrays(tt).items()):
        h.update(k.encode() + np.ascontiguousarray(a, np.int32).tobytes())
    return h.hexdigest()


# Schedules whose tables gate micro-batches into §3.1 scheduling units —
# their buffers only need unit depth. Everything else keeps the whole
# batch live (unit = n_mb); notably the full-depth §4 "autogen" schedule
# postpones W tasks across unit boundaries, which is incompatible with
# unit-depth stash reuse. Its "autogen_gated" sibling constrains the §4
# insertion loop to each unit's live window (B→W distance ≤ U, enforced
# by the stash-legality gate in retick/pack_table), so it keeps the
# requested unit depth and the O(U) activation bound.
UNIT_GATED_SCHEDULES = {"zeropp", "autogen_gated"}


@dataclasses.dataclass(frozen=True)
class PlanAnalysis:
    """Discrete-event-simulated properties of one plan under one preset."""

    preset: str
    makespan: float
    bubble_frac: float
    peak_mem: float
    n_gather: int
    n_reduce: int
    gathers_per_rank: float
    comm_frac: float       # mean per-rank collective time / makespan
    prefetch: int = 0      # gather issue distance the analysis assumed
    coll_alpha: float = 0.0      # per-collective latency of the cost model
    n_coll_gather: int = 1       # collectives per gather tick (1 = flat)
    n_coll_reduce: int = 1
    stash_depth: int = 0         # unit depth the executor buffers need
    #                              (U for unit-gated tables, n_mb else)
    rs_exposed: float = 0.0      # reduce-scatter time on the critical path
    rs_overlap_saved: float = 0.0  # worst rank's reduce time hidden under
    #                                the next unit's B/W compute
    measured_us: float | None = None  # profiled real-step time
    #                                   (auto_profiled refinement; None =
    #                                   simulated-only candidate)
    # EP MoE all-to-all terms of the reference's cost model; the port has
    # no expert parallelism yet (ROADMAP.md queue 1 item 7), so they stay 0
    t_a2a: float = 0.0           # one a2a event's α–β time (s)
    n_a2a_f: int = 0             # a2a events inside one F tick
    n_a2a_b: int = 0             # a2a events inside one B tick
    a2a_bytes: float = 0.0       # wire bytes of one a2a event
    a2a_total: float = 0.0       # simulated a2a time summed over the step

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SchedulePlan:
    """A runnable + analyzable schedule: the TickTable, the PackedTable the
    tick engine walks (derived from exactly that table) and its
    per-preset analyses."""

    name: str
    params: SchedParams
    table: TickTable
    packed: PackedTable
    prefetch: int = 0
    analyses: dict = dataclasses.field(default_factory=dict)

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

    def with_prefetch(self, prefetch: int) -> "SchedulePlan":
        """Same table, re-packed for a different gather-prefetch depth.

        Analyses are NOT carried over: the simulation models prefetch
        (prefetch=0 gathers block at use; ≥1 overlap), so cached numbers
        would be stale for the new depth.
        """
        if prefetch == self.prefetch:
            return self
        return SchedulePlan.from_table(self.name, self.params, self.table,
                                       prefetch=prefetch)

    @property
    def has_w(self) -> bool:
        return self.packed.has_w

    def validate(self) -> None:
        self.table.validate()

    def analyze(self, cm: CostModel, preset: str = "abstract"
                ) -> PlanAnalysis:
        """Simulate this plan under ``cm``; cached per preset name and
        collective profile.

        Prefetch-aware: a plan packed with ``prefetch == 0`` gathers at
        use time, so its collectives are simulated blocking
        (``overlap_comm=False``); ``prefetch >= 1`` keeps the async
        overlapped issue the engine performs.
        """
        key = (preset, cm.n_coll_gather, cm.n_coll_reduce, cm.coll_alpha,
               cm.n_a2a_f, cm.n_a2a_b, cm.t_a2a)
        if key not in self.analyses:
            cm_eff = (cm if self.prefetch > 0 else
                      dataclasses.replace(cm, overlap_comm=False))
            res = simulate(self.table, cm_eff)
            # reduce-scatter overlap accounting: the worst rank's total
            # reduce time is what fully-serial charging would add to it;
            # whatever the simulator did not expose on the critical path
            # overlapped the next unit's B/W compute.
            if self.table.reduce is not None and cm_eff.t_reduce > 0:
                rs_total = float(
                    (self.table.reduce >= 0).sum(axis=0).max()
                    * cm_eff.t_reduce)
            else:
                rs_total = 0.0
            self.analyses[key] = PlanAnalysis(
                preset=preset,
                makespan=res.makespan,
                bubble_frac=res.bubble_frac,
                peak_mem=res.peak_mem,
                n_gather=res.n_gather,
                n_reduce=res.n_reduce,
                gathers_per_rank=res.n_gather / self.table.P,
                comm_frac=float(res.comm_busy.mean()
                                / max(res.makespan, 1e-12)),
                prefetch=self.prefetch,
                coll_alpha=cm.coll_alpha,
                n_coll_gather=cm.n_coll_gather,
                n_coll_reduce=cm.n_coll_reduce,
                stash_depth=self.table.unit,
                rs_exposed=res.rs_exposed,
                rs_overlap_saved=max(0.0, rs_total - res.rs_exposed),
                t_a2a=cm_eff.t_a2a,
                n_a2a_f=cm_eff.n_a2a_f,
                n_a2a_b=cm_eff.n_a2a_b,
                a2a_bytes=cm_eff.a2a_bytes,
                a2a_total=cm_eff.t_a2a * sum(
                    cm_eff.n_a2a_f if task.kind == KF
                    else cm_eff.n_a2a_b if task.kind == KB else 0
                    for _, _, task in self.table.tasks()),
            )
        return self.analyses[key]


# --------------------------------------------------------------------------- #
# Hardware cost presets
# --------------------------------------------------------------------------- #

PRESETS = {"a800": A800}

#: Calibrated α–β collective constants per preset: (alpha, beta) with
#: t_collective(n, bytes) = n·α + bytes·β.  α is the per-collective launch
#: latency (the term a per-tensor gather tick pays #tensors times and the
#: flat-segment tick pays once): the published small-message latency of
#: an NCCL intra-node all-gather on A800 NVSwitch (≈ 8 µs).  β is the
#: inverse *effective* collective bandwidth on the FSDP (data) axis: the
#: preset's intra-node peak at ~90% efficiency.  The EP all-to-all row
#: doubles α (a pairwise exchange) over the same β.
COLLECTIVE_ALPHA_BETA: dict[str, tuple[float, float]] = {
    "a800": (8.0e-06, 1.0 / 180e9),     # NVSwitch intra-node DP axis
    "a800:a2a": (1.6e-05, 1.0 / 180e9),
}


def fused_cost_model(cm: CostModel) -> CostModel:
    """Fold W into B for schedules without split backward (baselines)."""
    return dataclasses.replace(cm, t_b=cm.t_b + cm.t_w, t_w=0.0,
                               m_wstash=0.0)


def preset_cost_model(preset: str, cfg=None, *, P: int, V: int,
                      seq: int = 1024, mbs: int = 1, dp: int = 1,
                      mfu: float = 0.5, n_coll_gather: int = 1,
                      n_coll_reduce: int | None = None,
                      n_a2a_f: int = 0, n_a2a_b: int = 0,
                      a2a_bytes: float = 0.0,
                      extra_stage_param_bytes: float = 0.0) -> CostModel:
    """CostModel for a hardware preset and a (model × shape) workload.

    With a ModelConfig, per-task durations come from transformer napkin
    math (GEMM flops at an assumed MFU, stage-boundary activation bytes,
    blockwise FSDP gather bytes) via ``cost_model_for``; without one, the
    abstract unit-cost model (F=1, B=2, W=1) is returned so device-free
    callers still get a simulatable preset.

    Collective ticks are costed α–β style with the calibrated
    ``COLLECTIVE_ALPHA_BETA`` constants: ``n_coll_gather`` /
    ``n_coll_reduce`` are the collectives issued per gather/reduce tick —
    1 under the flat-segment layout (``coalesce="flat"``), the gatherable
    tensor count under per-tensor collectives (``coalesce="none"``).
    ``n_a2a_f``/``n_a2a_b``/``a2a_bytes`` are the EP all-to-all terms
    (0 in the port, which has no expert parallelism yet).
    """
    if preset not in PRESETS:
        raise ValueError(
            f"unknown cost preset {preset!r}; known: "
            f"{', '.join(sorted(PRESETS))}")
    if cfg is None:
        return CostModel()
    hw = PRESETS[preset]
    alpha, beta = COLLECTIVE_ALPHA_BETA[preset]
    d = cfg.d_model
    L = max(cfg.n_layers, 1)
    layers_per_stage = max(L / (P * V), 1e-9)
    layer_flops = 2 * (12 * d * d) * seq * mbs + 2 * seq * seq * d * mbs
    act_bytes = seq * mbs * d * 2
    stage_param_bytes = (12 * d * d * layers_per_stage * 2
                         + max(extra_stage_param_bytes, 0.0))
    a2a_alpha, a2a_beta = COLLECTIVE_ALPHA_BETA.get(
        f"{preset}:a2a", (2 * alpha, beta))
    return cost_model_for(
        hw, layer_flops_f=layer_flops, layers_per_stage=layers_per_stage,
        act_bytes=act_bytes, stage_param_bytes=stage_param_bytes,
        dp=max(dp, 1), mfu=mfu, alpha=alpha, beta=beta,
        n_coll_gather=max(n_coll_gather, 0),
        n_coll_reduce=max(n_coll_reduce if n_coll_reduce is not None
                          else n_coll_gather, 0),
        a2a_alpha=a2a_alpha, a2a_beta=a2a_beta, a2a_bytes=a2a_bytes,
        n_a2a_f=max(n_a2a_f, 0), n_a2a_b=max(n_a2a_b, 0))


# --------------------------------------------------------------------------- #
# §4 plan selection (schedule="auto")
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class PlanSelection:
    """Outcome of one auto-selection: winner + every candidate's analysis."""

    selected: SchedulePlan
    analysis: PlanAnalysis
    preset: str
    candidates: dict    # name -> PlanAnalysis | "failed: ..." str
    key: tuple | None = None
    mem_budget: float | None = None   # peak-mem cap the ranking honoured
    # how this selection came to be: "search" (simulated screen only),
    # "search+measured" (auto_profiled coarse→fine refinement), or
    # "cache:disk" (rebuilt from the persisted plan cache — zero
    # simulate, zero measure). In-memory hits return the original
    # object, so its provenance stays whatever produced it; per-lookup
    # hit/miss accounting lives in plan_cache_info().
    provenance: str = "search"
    measured: dict | None = None      # name -> measured us/step for the
    #                                   refined survivors (profiled mode)
    profile: dict | None = None       # measurement metadata: top_k,
    #                                   budget_s, seconds spent,
    #                                   simulated-best name + its us

    def ranking(self) -> list[tuple[str, float]]:
        ok = [(n, a.makespan) for n, a in self.candidates.items()
              if isinstance(a, PlanAnalysis)]
        return sorted(ok, key=lambda x: x[1])

    def measured_ranking(self) -> list[tuple[str, float]]:
        """(name, measured us/step) for the profiled survivors, best
        first."""
        return sorted((self.measured or {}).items(), key=lambda x: x[1])


_PLAN_CACHE: dict[tuple, PlanSelection] = {}
# process-wide selection accounting: per-key hit counts + the work
# counters the persisted-cache tests assert on ("zero simulate calls on
# a warm hit" is checked against simulate_calls/measure_calls deltas).
_CACHE_STATS: dict = {
    "hits": {},        # key -> in-memory hit count
    "disk_hits": {},   # key -> persisted-cache hit count
    "misses": 0,       # full searches run
    "simulate_calls": 0,   # candidate discrete-event simulations
    "measure_calls": 0,    # real-step measurements (auto_profiled)
}


def clear_plan_cache(persisted: bool = False) -> None:
    """Reset the in-memory selection cache and its counters;
    ``persisted=True`` also deletes the on-disk cache file."""
    _PLAN_CACHE.clear()
    _CACHE_STATS["hits"] = {}
    _CACHE_STATS["disk_hits"] = {}
    _CACHE_STATS["misses"] = 0
    _CACHE_STATS["simulate_calls"] = 0
    _CACHE_STATS["measure_calls"] = 0
    if persisted:
        from repro_torch.core import plan_cache

        plan_cache.clear_disk()


def plan_cache_info() -> dict:
    """Selection-cache state: entries, per-key hit counts, and the
    simulate/measure work counters (reset by ``clear_plan_cache``)."""
    from repro_torch.core import plan_cache

    return {
        "entries": len(_PLAN_CACHE),
        # keys mix None/float/str at the same position (mem_budget,
        # profile_top_k), so sort on repr — tuple order would TypeError
        "keys": sorted(_PLAN_CACHE, key=repr),
        "hits": dict(_CACHE_STATS["hits"]),
        "disk_hits": dict(_CACHE_STATS["disk_hits"]),
        "misses": _CACHE_STATS["misses"],
        "simulate_calls": _CACHE_STATS["simulate_calls"],
        "measure_calls": _CACHE_STATS["measure_calls"],
        "persisted": plan_cache.info(),
    }


def candidate_schedules() -> list[str]:
    """Registered schedules eligible for auto-selection (trainable ones)."""
    from repro_torch.api.registry import SCHEDULE_REGISTRY

    return [n for n in SCHEDULE_REGISTRY.names() if n != "fwd_only"]


#: Ordered component names of the Session-level selection cache key —
#: folded into the persisted-cache fingerprint, so *adding a selection
#: knob* in a later version invalidates every stored entry.
SELECT_KEY_SCHEMA = (
    "arch", "pp", "vpp", "groups", "microbatches", "unit",
    "gather_prefetch", "seq", "mbs", "dp", "pods", "preset", "coalesce",
    "grad_compress", "moe_mode", "mem_budget", "select_mode",
    "profile_top_k",
)


def select_plan(P: int, V: int, n_mb: int, unit: int, cm: CostModel, *,
                preset: str = "abstract", prefetch: int = 0,
                candidates: list[str] | None = None,
                cache_key: tuple | None = None,
                mem_budget: float | None = None,
                measure_fn=None, top_k: int = 3,
                profile_budget_s: float | None = None,
                persist: bool = False, store: bool = True,
                sync=None) -> PlanSelection:
    """Build + simulate every candidate schedule; the minimum simulated
    makespan wins (ties keep the earlier candidate). Unit-gated schedules
    (UNIT_GATED_SCHEDULES: zeropp and the gated §4 heuristic
    ``autogen_gated``) use the requested unit; all others — including
    full-depth autogen, whose postponed W passes cross unit boundaries
    and therefore need full-depth stash buffers — keep the whole batch
    live (unit = n_mb). Fused-backward candidates are costed with W
    folded into B so total work is identical across candidates. A
    candidate whose table cannot be built or packed (the port's
    ``pack_table`` refuses a table with no tick free to gather an
    evicted stage block again) is recorded as ``"failed: ..."``.

    ``mem_budget`` (same units as the cost model's memory terms — bytes
    under the hardware presets) makes the ranking a memory/makespan
    trade-off: candidates whose simulated peak memory exceeds the budget
    are ranked only among themselves if *nothing* fits (min peak memory
    wins then).

    ``measure_fn`` turns the search coarse→fine (``auto_profiled``): the
    simulated screen above still runs every candidate, but then the
    ``top_k`` budget-respecting survivors (best simulated makespan
    first) are *measured* — ``measure_fn(plan) -> us/step`` times real
    steps — and the minimum measured time wins. The simulated-best
    survivor is always measured first. ``profile_budget_s`` caps the
    seconds spent measuring (at least one candidate is always measured);
    a candidate whose measurement raises is excluded from the measured
    ranking but keeps its simulated numbers.

    ``persist=True`` (with a ``cache_key``) reads the on-disk plan cache
    (``core/plan_cache.py``) and, with ``store``, writes it: a
    fingerprint-valid disk hit rebuilds the whole selection — winner
    table included — with zero simulate and zero measure calls.

    On a mesh of ranks every rank calls ``select_plan`` alike, with
    ``sync(x)`` mapping a float of this process to its maximum over the
    ranks (a collective; the identity by default) and ``store`` on one
    rank only. The ranks then agree on a search where any of them misses
    its caches (after every rank has read the file, so the storing rank
    cannot write it first), and on the seconds spent measuring, so that
    every rank measures the same candidates in the same steps."""
    from repro_torch.core import plan_cache

    fp = plan_cache.fingerprint(cm, SELECT_KEY_SCHEMA)
    sel, where = None, "miss"
    if cache_key is not None and cache_key in _PLAN_CACHE:
        sel, where = _PLAN_CACHE[cache_key], "hits"
    elif persist and cache_key is not None:
        rec = plan_cache.load_entry(cache_key, fp)
        if rec is not None:
            try:
                sel = plan_cache.selection_from_record(rec, cache_key)
                where = "disk_hits"
            except Exception:  # noqa: BLE001 — corrupt record: clean search
                sel = None
    if sync is not None and sync(0.0 if sel is not None else 1.0) > 0:
        sel, where = None, "miss"     # another rank searches: all do
    if sel is not None:
        _CACHE_STATS[where][cache_key] = \
            _CACHE_STATS[where].get(cache_key, 0) + 1
        # seed the in-memory cache: repeated sessions in this process
        # must share the identical PlanSelection object
        _PLAN_CACHE[cache_key] = sel
        return sel

    _CACHE_STATS["misses"] += 1
    names = list(candidates) if candidates is not None \
        else candidate_schedules()
    cm_fused = fused_cost_model(cm)
    results: dict = {}
    plans: dict[str, SchedulePlan] = {}
    fits: tuple[SchedulePlan, PlanAnalysis] | None = None   # within budget
    slim: tuple[SchedulePlan, PlanAnalysis] | None = None   # min peak_mem
    for name in names:
        sp = SchedParams(
            P=P, V=V, n_mb=n_mb,
            unit=(unit if name in UNIT_GATED_SCHEDULES else n_mb),
            split_bw=True)
        try:
            if name in ("autogen", "autogen_gated"):
                # §4 heuristic profiles with the *preset* cost model, not
                # the abstract default the registry builder would use.
                from repro_torch.core.autogen import autogen

                tt = autogen(sp, cm,
                             unit_gated=(name == "autogen_gated")).table
                plan = SchedulePlan.from_table(name, sp, tt,
                                               prefetch=prefetch)
            else:
                plan = SchedulePlan.build(name, sp, prefetch=prefetch)
        except Exception as e:  # noqa: BLE001 — skip broken candidates
            results[name] = f"failed: {e}"
            continue
        ana = plan.analyze(cm if plan.has_w else cm_fused, preset=preset)
        _CACHE_STATS["simulate_calls"] += 1
        results[name] = ana
        plans[name] = plan
        if mem_budget is None or ana.peak_mem <= mem_budget:
            if fits is None or ana.makespan < fits[1].makespan - 1e-12:
                fits = (plan, ana)
        if slim is None or ana.peak_mem < slim[1].peak_mem - 1e-12:
            slim = (plan, ana)
    best = fits or slim
    if best is None:
        raise RuntimeError(
            f"no schedule candidate could be built for P={P} V={V} "
            f"n_mb={n_mb} unit={unit}: {results}")

    provenance, measured, profile = "search", None, None
    if measure_fn is not None:
        best, measured, profile = _measured_refine(
            plans, results, fits, best, measure_fn,
            mem_budget=mem_budget, top_k=top_k,
            profile_budget_s=profile_budget_s, sync=sync)
        provenance = "search+measured"
    sel = PlanSelection(selected=best[0], analysis=best[1], preset=preset,
                        candidates=results, key=cache_key,
                        mem_budget=mem_budget, provenance=provenance,
                        measured=measured, profile=profile)
    if cache_key is not None:
        _PLAN_CACHE[cache_key] = sel
        if persist and store:
            try:
                plan_cache.store_entry(
                    cache_key, fp, plan_cache.selection_record(sel))
            except Exception:  # noqa: BLE001 — persistence is best-effort
                pass
    return sel


def _measured_refine(plans: dict, results: dict, fits, best, measure_fn, *,
                     mem_budget, top_k: int,
                     profile_budget_s: float | None, sync=None):
    """Fine pass of the coarse→fine search: measure the top-K simulated
    survivors with ``measure_fn`` and re-rank by real us/step.

    Survivor order is the coarse ranking the purely simulated selection
    uses — budget-fitting candidates by makespan when anything fits, else
    everything by peak memory — so the first measurement is always the
    plan ``schedule="auto"`` would have picked. Returns
    ``((plan, analysis), measured, profile)`` with measured numbers
    attached to the surviving candidates' analyses.
    """
    import time as _time

    ok = [(n, a) for n, a in results.items()
          if isinstance(a, PlanAnalysis)]
    if fits is not None:
        pool = [(n, a) for n, a in ok
                if mem_budget is None or a.peak_mem <= mem_budget]
        pool.sort(key=lambda x: x[1].makespan)
    else:
        pool = sorted(ok, key=lambda x: x[1].peak_mem)
    survivors = pool[:max(top_k, 1)]
    sim_best_name = survivors[0][0] if survivors else None

    measured: dict[str, float] = {}
    t_start = _time.perf_counter()
    for i, (name, _) in enumerate(survivors):
        if i > 0 and profile_budget_s is not None:
            spent = _time.perf_counter() - t_start
            if sync is not None:
                spent = sync(spent)
            if spent >= profile_budget_s:
                break   # budget exhausted; the sim-best was measured first
        try:
            us = float(measure_fn(plans[name]))
        except Exception as e:  # noqa: BLE001 — a plan that won't run
            results[name] = f"measure failed: {e}"   # can't win on merit
            continue
        finally:
            _CACHE_STATS["measure_calls"] += 1
        measured[name] = us
        results[name] = dataclasses.replace(results[name], measured_us=us)
    spent = _time.perf_counter() - t_start
    profile = {
        "top_k": top_k,
        "budget_s": profile_budget_s,
        "measure_s": sync(spent) if sync is not None else spent,
        "survivors": [n for n, _ in survivors],
        "simulated_best": sim_best_name,
        "simulated_best_us": measured.get(sim_best_name),
    }
    if measured:
        win = min(measured, key=measured.get)
        best = (plans[win], results[win])
    # else: every measurement failed — keep the simulated winner
    return best, measured, profile
