"""Continuous-time discrete-event simulator for pipeline schedules.

Takes a TickTable (which fixes each rank's task *order*) plus a CostModel
(per-task durations, p2p latency, collective times) and computes the real
timeline: makespan, per-rank busy/idle, bubble fraction, memory watermark,
and communication counts. This is the engine behind the paper-table
reproductions (Tables 2/3/5, Figs 5–7) and behind the §4 heuristic
auto-generator (autogen.py), which needs "profiled" timelines.

The port's copy of ``repro/core/simulator.py`` (numpy only). It carries
one hardware preset, A800: the paper's testbed, an NVIDIA card. The
reference's TPU preset is not carried: the port runs on NVIDIA cards and
states no rate taken on or for a TPU. The simulator's times are seconds
of this cost model, never times measured on a card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.schedules import B, F, W, TickTable

# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class CostModel:
    t_f: float = 1.0          # forward, one stage × one micro-batch
    t_b: float = 2.0          # input-grad (includes remat re-forward)
    t_w: float = 1.0          # weight-grad GEMMs
    t_p2p: float = 0.05       # stage-boundary activation transfer
    t_gather: float = 0.5     # FSDP all-gather, one stage block (α·n + β·B)
    t_reduce: float = 0.5     # grad reduce-scatter, one stage block
    overlap_comm: bool = True  # collectives overlap compute (async)
    # memory accounting (arbitrary units, per stage block)
    m_act: float = 1.0        # activation stash of one (mb, stage) F→B
    m_wstash: float = 0.5     # (x, dy) stash of one (mb, stage) B→W
    m_weight: float = 1.0     # one stage block of parameters (gathered)
    # α–β collective metadata (already folded into t_gather/t_reduce; kept
    # so analyses/describe() can report the latency-vs-bandwidth split)
    coll_alpha: float = 0.0       # per-collective launch latency (s)
    n_coll_gather: int = 1        # collectives issued per gather tick
    n_coll_reduce: int = 1        # collectives issued per reduce tick
    # EP MoE all-to-all: dispatch/combine ride *inside* the F/B compute of
    # a stage tick (they are lax.all_to_all calls in the traced layer
    # body), so a2a time charges into dur() rather than the gather/reduce
    # channels. n_a2a_f/_b count a2a events per F/B tick of one stage
    # (0 for gathered MoE / dense models); t_a2a is one event's α–β time.
    t_a2a: float = 0.0            # one all-to-all event (s)
    n_a2a_f: int = 0              # a2a events inside one F tick
    n_a2a_b: int = 0              # a2a events inside one B tick
    a2a_bytes: float = 0.0        # wire bytes of one a2a event (metadata)
    a2a_alpha: float = 0.0        # a2a launch latency (s, metadata)

    def dur(self, kind: int) -> float:
        if kind == F:
            return self.t_f + self.n_a2a_f * self.t_a2a
        if kind == B:
            return self.t_b + self.n_a2a_b * self.t_a2a
        return self.t_w


@dataclasses.dataclass
class SimResult:
    makespan: float
    busy: np.ndarray          # [P] busy time
    bubble_frac: float        # 1 - mean(busy)/makespan
    peak_mem: float           # per-rank max of the memory trace
    peak_mem_rank: np.ndarray  # [P]
    n_gather: int
    n_reduce: int
    task_start: dict          # (kind, mb, stage) -> start time
    task_end: dict
    comm_busy: np.ndarray     # [P]
    rs_exposed: float = 0.0   # reduce-scatter time visible in the makespan
    #                           (tail + any serial reduce charges); the
    #                           hidden remainder overlapped B/W compute

    def throughput(self, samples_per_step: float) -> float:
        return samples_per_step / self.makespan


def simulate(tt: TickTable, cm: CostModel, *,
             _skip_mem: bool = False) -> SimResult:
    """List-scheduled execution: each rank runs its tasks in table order,
    starting each as soon as (a) the rank is free and (b) dependencies
    (+ p2p) and any required parameter gather have completed.

    Reduce-scatters are issued when the task they are attached to (the
    unit's last weight-grad) finishes. With ``overlap_comm`` they ride an
    async per-rank reduce channel: a unit's tail reduce-scatter overlaps
    the next unit's B/W compute and only its *exposed* part — whatever
    outlives the last compute on the timeline — reaches the makespan
    (``rs_exposed``). Without overlap (blocking gathers, prefetch-0
    plans) each reduce charges its full α–β time serially on the rank.
    """
    P, V = tt.P, tt.V
    S = P * V
    orders: list[list] = [[] for _ in range(P)]
    for t, r, task in tt.tasks():
        g = tt.gather[t, r] if tt.gather is not None else -1
        red = tt.reduce is not None and tt.reduce[t, r] >= 0
        orders[r].append((task, g, red))

    end: dict[tuple, float] = {}
    start: dict[tuple, float] = {}
    rank_free = np.zeros(P)
    comm_free = np.zeros(P)   # per-rank gather channel
    red_free = np.zeros(P)    # per-rank reduce-scatter channel
    comm_busy = np.zeros(P)
    reduce_end_max = 0.0
    n_gather = 0

    # iterate in rounds until all scheduled (tasks unlock across ranks)
    idx = [0] * P
    total = sum(len(o) for o in orders)
    done_ct = 0
    guard = 0
    while done_ct < total and guard < total * P + 64:
        guard += 1
        progressed = False
        for r in range(P):
            while idx[r] < len(orders[r]):
                task, g, red = orders[r][idx[r]]
                key = (task.kind, task.mb, task.stage)
                # dependency readiness
                deps = []
                if task.kind == F and task.stage > 0:
                    deps.append((F, task.mb, task.stage - 1))
                if task.kind == B:
                    deps.append((F, task.mb, task.stage))
                    if task.stage < S - 1:
                        deps.append((B, task.mb, task.stage + 1))
                if task.kind == W:
                    deps.append((B, task.mb, task.stage))
                if any(d not in end for d in deps):
                    break  # must wait; revisit next round
                ready = rank_free[r]
                for d in deps:
                    cross = (d[2] % P) != r
                    ready = max(ready, end[d] + (cm.t_p2p if cross else 0.0))
                # parameter gather (FSDP)
                if g >= 0:
                    if cm.overlap_comm:
                        # issued as early as the comm channel allows
                        g_start = comm_free[r]
                        g_end = g_start + cm.t_gather
                        comm_free[r] = g_end
                    else:
                        g_end = ready + cm.t_gather
                    comm_busy[r] += cm.t_gather
                    n_gather += 1
                    ready = max(ready, g_end)
                s0 = ready
                e0 = s0 + cm.dur(task.kind)
                start[key] = s0
                end[key] = e0
                rank_free[r] = e0
                # reduce-scatter attached to this tick (unit's last W):
                # issued at task end; async channel when overlapped,
                # serial rank time when blocking.
                if red and cm.t_reduce > 0:
                    if cm.overlap_comm:
                        r_end = max(e0, red_free[r]) + cm.t_reduce
                        red_free[r] = r_end
                    else:
                        r_end = e0 + cm.t_reduce
                        rank_free[r] = r_end
                    reduce_end_max = max(reduce_end_max, r_end)
                comm_busy[r] += cm.t_reduce if red else 0.0
                idx[r] += 1
                done_ct += 1
                progressed = True
        if not progressed:
            # stuck: deadlock in table (shouldn't happen on valid tables)
            raise RuntimeError("simulator deadlock — invalid schedule order")

    task_makespan = float(max(end.values()))
    makespan = max(task_makespan, reduce_end_max)
    busy = np.zeros(P)
    for (k, u, s), e in end.items():
        busy[s % P] += cm.dur(k)

    n_reduce = int((tt.reduce >= 0).sum()) if tt.reduce is not None else 0

    # exposed reduce-scatter time: what the reduces actually add to the
    # critical path (tail exposure under overlap; the serial charges are
    # already folded into the task timeline when blocking, so compare
    # against a reduce-free replay of the same table — timeline only,
    # the replay's memory trace would be discarded).
    rs_exposed = makespan - task_makespan
    if not cm.overlap_comm and n_reduce and cm.t_reduce > 0:
        rs_exposed = makespan - simulate(
            tt, dataclasses.replace(cm, t_reduce=0.0),
            _skip_mem=True).makespan

    if _skip_mem:
        peak, peak_rank = 0.0, np.zeros(P)
    else:
        peak, peak_rank = _memory_trace(tt, cm, start, end)
    return SimResult(
        makespan=makespan,
        busy=busy,
        bubble_frac=float(1.0 - busy.mean() / makespan),
        peak_mem=float(peak),
        peak_mem_rank=peak_rank,
        n_gather=n_gather,
        n_reduce=n_reduce,
        task_start=start,
        task_end=end,
        comm_busy=comm_busy,
        rs_exposed=float(max(rs_exposed, 0.0)),
    )


def _memory_trace(tt, cm, start, end):
    """Activation/stash/weight-buffer watermark per rank (paper §3.4 model).

    * activation of (mb, stage): alive F-end → B-end
    * W-stash of (mb, stage):    alive B-end → W-end (split schedules)
    * gathered weights: double-buffer of 2 stage blocks when FSDP events
      exist, else resident L/P share (non-FSDP baselines).
    """
    P = tt.P
    events: list[list[tuple[float, float]]] = [[] for _ in range(P)]
    has_w = any(task.kind == W for _, _, task in tt.tasks())
    for (k, u, s), e in end.items():
        r = s % P
        if k == F:
            events[r].append((e, +cm.m_act))
        elif k == B:
            events[r].append((e, -cm.m_act))
            if has_w:
                events[r].append((e, +cm.m_wstash))
        elif k == W:
            events[r].append((e, -cm.m_wstash))
    peak_rank = np.zeros(P)
    for r in range(P):
        cur = 0.0
        for _, delta in sorted(events[r], key=lambda x: (x[0], -x[1])):
            cur += delta
            peak_rank[r] = max(peak_rank[r], cur)
    fsdp = tt.gather is not None and (tt.gather >= 0).any()
    wbuf = 2 * cm.m_weight if fsdp else tt.V * cm.m_weight
    peak_rank = peak_rank + wbuf
    return peak_rank.max(), peak_rank


# --------------------------------------------------------------------------- #
# Hardware presets → CostModel for a given model/stage workload
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    flops: float          # peak per chip, per second
    hbm_bw: float         # bytes/s
    link_bw: float        # bytes/s inter-chip (p2p / collective)
    intra_bw: float = 0.0  # bytes/s within a node (if hierarchical)


A800 = Hardware("A800", flops=312e12, hbm_bw=2.0e12, link_bw=25e9,
                intra_bw=200e9)


def cost_model_for(
    hw: Hardware,
    *,
    layer_flops_f: float,      # forward flops of one layer × one micro-batch
    layers_per_stage: float,
    act_bytes: float,          # stage-boundary activation bytes (one mb)
    stage_param_bytes: float,
    dp: int,
    mfu: float = 0.5,
    remat: bool = True,
    cross_node_dp: bool = False,
    alpha: float = 0.0,        # per-collective launch latency (s)
    beta: float | None = None,  # s/byte on the collective path (1/bw_eff)
    n_coll_gather: int = 1,    # collectives per gather tick (1 = flat)
    n_coll_reduce: int = 1,    # collectives per reduce tick
    a2a_alpha: float = 0.0,    # EP all-to-all launch latency (s)
    a2a_beta: float | None = None,  # s/byte on the a2a path
    a2a_bytes: float = 0.0,    # wire bytes of one a2a event
    n_a2a_f: int = 0,          # a2a events inside one F tick
    n_a2a_b: int = 0,          # a2a events inside one B tick
) -> CostModel:
    """Napkin-math durations from hardware peaks at an assumed MFU.

    Collective ticks are costed α–β style: ``n_collectives × α`` (launch
    latency — the term per-tensor collectives lose on) plus
    ``bytes × β`` (bandwidth — identical either way). ``beta=None``
    falls back to the preset's link/intra bandwidth.
    """
    eff = hw.flops * mfu
    t_f = layers_per_stage * layer_flops_f / eff
    # B = input-grad (≈ fwd flops) + remat re-forward when enabled
    t_b = (layers_per_stage * layer_flops_f * (2 if remat else 1)) / eff
    t_w = layers_per_stage * layer_flops_f / eff
    bw = hw.link_bw if cross_node_dp or hw.intra_bw == 0 else hw.intra_bw
    b = beta if beta is not None else 1.0 / bw
    wire_bytes = stage_param_bytes * (dp - 1) / dp
    # 0 collectives per tick = none issued at all (weight-resident serve)
    t_gather = (alpha * n_coll_gather + wire_bytes * b
                if n_coll_gather > 0 else 0.0)
    t_reduce = (alpha * n_coll_reduce + wire_bytes * b
                if n_coll_reduce > 0 else 0.0)
    ab = a2a_beta if a2a_beta is not None else b
    t_a2a = (a2a_alpha + a2a_bytes * ab
             if (n_a2a_f or n_a2a_b) else 0.0)
    return CostModel(
        t_f=t_f, t_b=t_b, t_w=t_w,
        t_p2p=act_bytes / hw.link_bw,
        t_gather=t_gather, t_reduce=t_reduce,
        m_act=act_bytes, m_wstash=2 * act_bytes,
        m_weight=stage_param_bytes,
        coll_alpha=alpha, n_coll_gather=n_coll_gather,
        n_coll_reduce=n_coll_reduce,
        t_a2a=t_a2a, n_a2a_f=n_a2a_f, n_a2a_b=n_a2a_b,
        a2a_bytes=a2a_bytes, a2a_alpha=a2a_alpha,
    )
