"""Explore the port's schedule plans: the §4 selection behind
``schedule="auto"`` (every registered schedule + the autogen heuristics,
simulated under a hardware cost preset) for reduced llama3.2-1b, and the
selected plan's simulated makespan / bubble ratio / gathers, as
``Session.describe()["schedule"]`` reports them.

Device-free: the selection only generates tick tables and simulates
them; no step runs and no device is touched. The makespans are seconds
of the preset's cost model (``a800``: the paper's A800 testbed), not
times of any card. A train session at pp > 1 runs this same selection on
every rank of its mesh (``repro_torch.launch.train --schedule auto``).

    PYTHONPATH=src python examples/schedule_explorer_torch.py [B] [U] [P] [preset]
"""

import sys

from repro_torch.api import get_arch, list_schedules
from repro_torch.core.plan import preset_cost_model, select_plan

args = sys.argv[1:]
B, U, P = (int(x) for x in (args[:3] + [8, 4, 2][len(args[:3]):]))
preset = args[3] if len(args) > 3 else "a800"
cfg, rc = get_arch("llama3.2-1b").reduced()
V, seq = rc.vpp, 32

print(f"registered schedules: {', '.join(list_schedules())}")
print(f"=== schedule=\"auto\" ({cfg.name}, P={P} V={V} B={B} U={U}, "
      f"seq {seq}, preset={preset}) ===")
cm = preset_cost_model(preset, cfg, P=P, V=V, seq=seq, mbs=1, dp=1)
sel = select_plan(P, V, B, U, cm, preset=preset,
                  prefetch=rc.gather_prefetch)

print(f"candidates (simulated makespan / peak mem / stash depth, "
      f"{preset} preset):")
ranked = dict(sel.ranking())
for name in list(ranked) + [n for n in sel.candidates if n not in ranked]:
    a = sel.candidates[name]
    mark = " <== selected" if name == sel.selected.name else ""
    if isinstance(a, str):
        print(f"  {name:14s} {a}")
        continue
    print(f"  {name:14s} {a.makespan:.3e}  mem={a.peak_mem:.2e}  "
          f"U={a.stash_depth}  rs_saved={a.rs_overlap_saved:.1e}{mark}")

a, plan = sel.analysis, sel.selected
print(f"\nselected plan: {plan.name}  (P={P} V={V} B={B} "
      f"U={plan.table.unit})")
print(f"  ticks            {plan.table.T}")
print(f"  makespan         {a.makespan:.3e}  ({a.preset})")
print(f"  bubble ratio     {a.bubble_frac:.3f}  (simulated)")
print(f"  gathers/rank     {a.gathers_per_rank:.1f}")
print(f"  peak mem (sim)   {a.peak_mem:.3e}")

print(f"\n=== selected tick table ({plan.name}) ===")
print(plan.table.render(max_ticks=48))
