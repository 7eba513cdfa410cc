"""The port's §4 schedule generator and plan selection against the JAX
package, on the CPU.

Grid: (P, V, n_mb, U) in {(2,1,4,2), (2,2,4,2), (4,1,8,2), (4,2,8,4)},
prefetch 0 and 1; cost models: the abstract ``CostModel()`` and
``preset_cost_model("a800", ...)`` for llama3.2-1b and gpt_paper at data
1 and 2, flat and per-tensor collectives. Each copy does the same float64
operations in the same order as the reference, so outputs compare with
``==``:

* ``simulate``: every ``SimResult`` field, for every registered schedule;
* ``autogen``, full depth and unit-gated: table, unit, gather and reduce
  events, insertions, ``log`` and ``makespans``;
* ``analyze`` for every method, ``n_allgather``,
  ``optimal_active_microbatches``, ``zeropp_max_alloc``;
* ``preset_cost_model`` field for field;
* ``select_plan``: winner, ``ranking()`` and every candidate's
  ``PlanAnalysis.as_dict()``, with no budget, a budget only the
  unit-depth candidates fit, one nothing fits, and a ``measure_fn`` that
  inverts the simulated order. Where the port's ``pack_table`` refuses a
  candidate the reference packs (``KNOWN_REFUSALS``: a table with no tick
  free to gather an evicted stage block again), that candidate is
  ``"failed: ..."`` in the port and named here;
* the reference's properties (``tests/test_plan.py``) restated: makespans
  never increase, autogen is full depth, autogen_gated keeps U with no
  stash violation and a lower peak;
* the plan cache: persisted hits with zero simulate calls, corrupt files,
  fingerprints, ``off``, and a path of its own;
* the facade: the spec's checks, ``schedule="auto"`` picking the
  reference Session's plan with the same ``describe()["schedule"]``
  simulated values, ``tpu_v5e`` refused, and a serve session's
  ``auto`` running the reference serve Session's selection;
* the train step at one rank under ``autogen`` / ``autogen_gated``
  against ``jax.value_and_grad(reference_loss)`` (loss 1e-5 relative,
  gradients 1e-4 of max |ref|) and the JAX ``make_train_step``, and
  ``autogen_gated``'s gradients bit-identical to ``zeropp``'s;
* ``launch/train.py --schedule auto``.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.api import session as jsession  # noqa: E402
from repro.core import analysis as janalysis  # noqa: E402
from repro.core import autogen as jautogen  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import plan_cache as jplan_cache  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.generators import SchedParams as JSP  # noqa: E402
from repro.core.generators import generate as jgenerate  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError, list_schedules  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import gpt_paper as tgpt  # noqa: E402
from repro_torch.configs import llama3p2_1b as tllama  # noqa: E402
from repro_torch.core import analysis as tanalysis  # noqa: E402
from repro_torch.core import autogen as tautogen  # noqa: E402
from repro_torch.core import generators as tgenerators  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import plan_cache as tplan_cache  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.generators import SchedParams as TSP  # noqa: E402
from repro_torch.core.generators import generate as tgenerate  # noqa: E402
from repro_torch.core.schedules import to_arrays  # noqa: E402
from repro_torch.core.schedules import unit_stash_violations  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402

GRID = [(2, 1, 4, 2), (2, 2, 4, 2), (4, 1, 8, 2), (4, 2, 8, 4)]
PREFETCH = (0, 1)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
ARCHS = {"llama3.2-1b": tllama, "gpt_paper": tgpt}
# candidates the port's pack_table refuses where the reference packs a
# table: (schedule, P, V, prefetch) -> a fragment of the port's refusal
KNOWN_REFUSALS = {
    ("interleaved", 1, 4, 2): "no tick free to re-gather",
}


@pytest.fixture(autouse=True)
def _plan_caches(tmp_path, monkeypatch):
    """Both packages' persisted caches in this test's directory, and both
    in-memory caches empty."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE",
                       str(tmp_path / "port_plans.json"))
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "ref_plans.json"))
    tplan.clear_plan_cache()
    jplan.clear_plan_cache()
    yield
    tplan.clear_plan_cache()
    jplan.clear_plan_cache()


def _cost_models():
    """(label, reference CostModel, port CostModel) for every P, V."""
    out = [("abstract", lambda P, V: (jsim.CostModel(), tsim.CostModel()))]
    for arch, mod in ARCHS.items():
        jcfg, tcfg = jmodel.get_arch(arch).config(), mod.config()
        for dp in (1, 2):
            for n_coll in (1, 9):   # flat / per tensor
                def cms(P, V, jcfg=jcfg, tcfg=tcfg, dp=dp, n=n_coll):
                    kw = dict(P=P, V=V, seq=1024, mbs=1, dp=dp,
                              n_coll_gather=n, n_coll_reduce=n + 1)
                    return (jplan.preset_cost_model("a800", jcfg, **kw),
                            tplan.preset_cost_model("a800", tcfg, **kw))
                out.append((f"{arch}/dp{dp}/coll{n_coll}", cms))
    return out


COST_MODELS = _cost_models()


def _sim_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x, err_msg=f.name)
        else:
            assert y == x, f.name


def _tables_equal(want, got):
    assert (got.P, got.V, got.n_mb, got.unit) == \
        (want.P, want.V, want.n_mb, want.unit)
    a, b = jplan.to_arrays(want), to_arrays(got)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _sp(name, P, V, n_mb, U):
    unit = U if name in tplan.UNIT_GATED_SCHEDULES else n_mb
    return dict(P=P, V=V, n_mb=n_mb, unit=unit)


# --------------------------------------------------------------------------- #
# Simulator, autogen, analysis, cost presets
# --------------------------------------------------------------------------- #


def test_list_schedules_equals_the_reference():
    from repro.api import list_schedules as jlist

    assert list_schedules() == jlist()
    assert {"autogen", "autogen_gated"} <= set(list_schedules())
    assert tplan.candidate_schedules() == jplan.candidate_schedules()


@pytest.mark.parametrize("P,V,n_mb,U", GRID)
def test_simulate_equals_the_reference(P, V, n_mb, U):
    n = 0
    for name in list_schedules():
        kw = _sp(name, P, V, n_mb, U)
        jt, tt = jgenerate(name, JSP(**kw)), tgenerate(name, TSP(**kw))
        _tables_equal(jt, tt)
        for label, cms in COST_MODELS:
            jcm, tcm = cms(P, V)
            assert dataclasses.asdict(tcm) == dataclasses.asdict(jcm)
            _sim_equal(jsim.simulate(jt, jcm), tsim.simulate(tt, tcm))
            n += 1
    assert n == len(list_schedules()) * len(COST_MODELS)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("P,V,n_mb,U", GRID)
def test_autogen_equals_the_reference(P, V, n_mb, U, gated):
    for label, cms in [COST_MODELS[i] for i in (0, 1, 6)]:
        jcm, tcm = cms(P, V)
        want = jautogen.autogen(JSP(P=P, V=V, n_mb=n_mb, unit=U), jcm,
                                unit_gated=gated)
        got = tautogen.autogen(TSP(P=P, V=V, n_mb=n_mb, unit=U), tcm,
                               unit_gated=gated)
        _tables_equal(want.table, got.table)
        assert got.table.unit == U
        for f in ("makespan_before", "makespan_after", "n_insertions",
                  "log", "makespans"):
            assert getattr(got, f) == getattr(want, f), (label, f)


def test_autogen_reexports_the_generators_retick():
    assert tautogen.retick is tgenerators.retick


METHODS = ["gpipe", "1f1b", "fs-1f1b", "interleaved", "bfs", "fs-bfs",
           "zeropp", "fs-zeropp", "fs-autogen", "fs-autogen-gated"]


@pytest.mark.parametrize("method", METHODS)
def test_analysis_equals_the_reference(method):
    for L, P, V, B, U, D in [(16, 4, 2, 8, 4, 2), (22, 2, 1, 8, 4, 1),
                             (32, 8, 2, 16, 15, 8), (8, 2, 2, 4, None, 4)]:
        kw = dict(L=L, P=P, V=V, B=B, U=U, D=D, M_w=1.5, M_a=0.25)
        assert dataclasses.asdict(tanalysis.analyze(method, **kw)) == \
            dataclasses.asdict(janalysis.analyze(method, **kw))
        if U:
            assert tanalysis.n_allgather(B=B, L=L, V=V, U=U, P=P) == \
                janalysis.n_allgather(B=B, L=L, V=V, U=U, P=P)
            kw2 = dict(L=L, P=P, D=D, V=V, B=B, U=U, M_w=1.5, M_a=0.25)
            assert tanalysis.zeropp_max_alloc(**kw2) == \
                janalysis.zeropp_max_alloc(**kw2)
        assert tanalysis.optimal_active_microbatches(P) == \
            janalysis.optimal_active_microbatches(P)
    with pytest.raises(ValueError):
        tanalysis.analyze("nope", L=1, P=1, V=1, B=1)


def test_preset_cost_model_equals_the_reference_and_refuses_tpu():
    n = 0
    for arch, mod in ARCHS.items():
        jcfg, tcfg = jmodel.get_arch(arch).config(), mod.config()
        for P, V, seq, mbs, dp, ng, nr in [
                (2, 1, 1024, 1, 1, 1, None), (4, 2, 2048, 2, 8, 9, 11),
                (16, 2, 4096, 1, 4, 0, 3)]:
            kw = dict(P=P, V=V, seq=seq, mbs=mbs, dp=dp,
                      n_coll_gather=ng, n_coll_reduce=nr)
            assert dataclasses.asdict(
                tplan.preset_cost_model("a800", tcfg, **kw)) == \
                dataclasses.asdict(
                    jplan.preset_cost_model("a800", jcfg, **kw))
            n += 1
    assert tplan.preset_cost_model("a800", P=2, V=1) == tsim.CostModel()
    assert tplan.COLLECTIVE_ALPHA_BETA == {
        k: v for k, v in jplan.COLLECTIVE_ALPHA_BETA.items()
        if k.startswith("a800")}
    assert list(tplan.PRESETS) == ["a800"]
    assert not hasattr(tsim, "TPU_V5E")
    jplan.preset_cost_model("tpu_v5e", P=2, V=1)   # the reference's own
    with pytest.raises(ValueError, match="unknown cost preset 'tpu_v5e'"):
        tplan.preset_cost_model("tpu_v5e", P=2, V=1)
    assert n == 6


# --------------------------------------------------------------------------- #
# select_plan
# --------------------------------------------------------------------------- #


def _gpt_cms(P, V, dp=1):
    kw = dict(P=P, V=V, seq=1024, mbs=1, dp=dp)
    return (jplan.preset_cost_model("a800", jmodel.get_arch(
                "gpt_paper").config(), **kw),
            tplan.preset_cost_model("a800", tgpt.config(), **kw))


def _selections_equal(want, got, P, V, prefetch):
    """Winner, ranking and every candidate's analysis equal, except the
    named refusals (which then take no part in the winner)."""
    refused = {}
    for name, a in got.candidates.items():
        if isinstance(a, str) and a.startswith("failed:") and \
                isinstance(want.candidates[name], jplan.PlanAnalysis):
            frag = KNOWN_REFUSALS.get((name, P, V, prefetch))
            assert frag is not None and frag in a, (name, P, V, prefetch, a)
            refused[name] = a
    assert set(got.candidates) == set(want.candidates)
    for name, a in want.candidates.items():
        if name in refused:
            continue
        b = got.candidates[name]
        if isinstance(a, str):
            assert isinstance(b, str) and b.split(":")[0] == \
                a.split(":")[0], (name, a, b)
        else:
            assert b.as_dict() == a.as_dict(), name
    assert got.ranking() == [r for r in want.ranking()
                             if r[0] not in refused]
    if not refused:
        assert got.selected.name == want.selected.name
        assert got.analysis.as_dict() == want.analysis.as_dict()
        _tables_equal(want.selected.table, got.selected.table)
    return refused


@pytest.mark.parametrize("prefetch", PREFETCH)
@pytest.mark.parametrize("P,V,n_mb,U", GRID)
def test_select_plan_equals_the_reference(P, V, n_mb, U, prefetch):
    jcm, tcm = _gpt_cms(P, V)
    want = jplan.select_plan(P, V, n_mb, U, jcm, preset="a800",
                             prefetch=prefetch)
    got = tplan.select_plan(P, V, n_mb, U, tcm, preset="a800",
                            prefetch=prefetch)
    assert _selections_equal(want, got, P, V, prefetch) == {}
    assert got.provenance == want.provenance == "search"


def test_select_plan_names_the_port_refusals():
    """pp 1, vpp 4, gathers two ticks ahead: the reference packs
    interleaved reading evicted stage blocks; the port refuses it, and
    every other candidate agrees."""
    jcm, tcm = _gpt_cms(1, 4)
    want = jplan.select_plan(1, 4, 4, 2, jcm, preset="a800", prefetch=2)
    got = tplan.select_plan(1, 4, 4, 2, tcm, preset="a800", prefetch=2)
    refused = _selections_equal(want, got, 1, 4, 2)
    assert sorted(refused) == ["interleaved"]
    for name in refused:    # the reference's packed table reads stale
        jt = jplan.SchedulePlan.build(
            name, JSP(P=1, V=4, n_mb=4, unit=4), prefetch=2).packed
        assert tplan.slot_violations(jt) != []
    assert got.selected.name not in refused


@pytest.mark.parametrize("P,V,n_mb,U", [(2, 2, 4, 2), (4, 2, 8, 4)])
def test_select_plan_memory_budgets_equal_the_reference(P, V, n_mb, U):
    """A budget only the unit-depth candidates (autogen_gated, zeropp)
    fit, and one nothing fits (the lowest peak wins), with the
    reference's three-candidate comparison."""
    jcm, tcm = _gpt_cms(P, V)
    names = ["autogen", "autogen_gated", "zeropp"]
    free = tplan.select_plan(P, V, n_mb, U, tcm, preset="a800",
                             candidates=names)
    full = free.candidates["autogen"].peak_mem
    unit = max(free.candidates[n].peak_mem for n in names[1:])
    assert unit < full
    for budget in ((unit + full) / 2, 1.0):
        want = jplan.select_plan(P, V, n_mb, U, jcm, preset="a800",
                                 candidates=names, mem_budget=budget)
        got = tplan.select_plan(P, V, n_mb, U, tcm, preset="a800",
                                candidates=names, mem_budget=budget)
        _selections_equal(want, got, P, V, 0)
        assert got.mem_budget == budget
        assert got.selected.table.unit == U
    assert got.analysis.peak_mem == min(
        got.candidates[n].peak_mem for n in names)


def test_select_plan_measured_refinement_equals_the_reference():
    """A measure_fn that inverts the simulated order flips the winner to
    the third survivor in both packages, with the same measured dict and
    profile keys."""
    P, V, n_mb, U = 4, 2, 8, 4
    jcm, tcm = _gpt_cms(P, V)
    order = [n for n, _ in tplan.select_plan(
        P, V, n_mb, U, tcm, preset="a800").ranking()]
    tplan.clear_plan_cache()

    def stub(plan):
        return 1000.0 - order.index(plan.name)

    want = jplan.select_plan(P, V, n_mb, U, jcm, preset="a800",
                             measure_fn=stub, top_k=3)
    got = tplan.select_plan(P, V, n_mb, U, tcm, preset="a800",
                            measure_fn=stub, top_k=3)
    assert got.selected.name == want.selected.name == order[2]
    assert got.measured == want.measured
    assert got.measured_ranking() == want.measured_ranking()
    assert set(got.profile) == set(want.profile)
    for k in ("top_k", "budget_s", "survivors", "simulated_best",
              "simulated_best_us"):
        assert got.profile[k] == want.profile[k], k
    assert got.provenance == want.provenance == "search+measured"
    assert got.candidates[order[2]].measured_us == 998.0
    assert tplan.plan_cache_info()["measure_calls"] == 3


def test_select_plan_measure_budget_and_failures():
    """profile_budget_s 0 measures the simulated best only; a failing
    measurement keeps its simulated numbers out of the measured ranking;
    ``sync`` sees the seconds spent before each further candidate."""
    P, V, n_mb, U = 2, 2, 4, 2
    _, tcm = _gpt_cms(P, V)
    seen = []

    def sync(x):
        seen.append(x)
        return x

    sel = tplan.select_plan(P, V, n_mb, U, tcm, preset="a800",
                            measure_fn=lambda plan: 5.0, top_k=3,
                            profile_budget_s=0.0, sync=sync)
    assert list(sel.measured) == [sel.profile["simulated_best"]]
    assert len(seen) == 3   # the cache agreement, the budget, the total
    tplan.clear_plan_cache()
    first = sel.profile["simulated_best"]

    def flaky(plan):
        if plan.name == first:
            raise RuntimeError("no room")
        return 7.0

    sel = tplan.select_plan(P, V, n_mb, U, tcm, preset="a800",
                            measure_fn=flaky, top_k=2)
    assert sel.candidates[first] == "measure failed: no room"
    assert first not in sel.measured and len(sel.measured) == 1


# --------------------------------------------------------------------------- #
# The reference's properties, on the port
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("P,V,n_mb,U", GRID)
def test_autogen_properties(P, V, n_mb, U):
    _, tcm = _gpt_cms(P, V)
    for cm in (tsim.CostModel(), tcm):
        full = tautogen.autogen(TSP(P=P, V=V, n_mb=n_mb, unit=n_mb), cm)
        gated = tautogen.autogen(TSP(P=P, V=V, n_mb=n_mb, unit=U), cm,
                                 unit_gated=True)
        for res in (full, gated):
            ms = res.makespans
            assert len(ms) == res.n_insertions + 1
            assert ms[0] == res.makespan_before and \
                ms[-1] == res.makespan_after
            assert all(b < a for a, b in zip(ms, ms[1:])), ms
            res.table.validate()
        assert full.table.unit == n_mb
        assert gated.table.unit == U < n_mb
        assert unit_stash_violations(gated.table) == []
        assert tplan.pack_table(gated.table).U == U
        assert tsim.simulate(gated.table, cm).peak_mem < \
            tsim.simulate(full.table, cm).peak_mem
    assert tgenerate("autogen", TSP(P=P, V=V, n_mb=n_mb, unit=U)).unit \
        == n_mb
    assert "autogen" not in tplan.UNIT_GATED_SCHEDULES


@pytest.mark.parametrize("name", ["autogen", "autogen_gated"])
def test_autogen_tables_read_their_own_blocks(name):
    """Every table of tests/test_torch_slots.py's grid (pp 1/2/4, vpp
    1-4, 4 and 8 micro-batches, prefetch 0-2) packs with every F and B
    cell reading the slot that holds its block."""
    n = 0
    for P in (1, 2, 4):
        for V in (1, 2, 3, 4):
            for n_mb in (4, 8):
                unit = 2 if name == "autogen_gated" else n_mb
                sp = TSP(P=P, V=V, n_mb=n_mb, unit=unit)
                tt = tgenerate(name, sp)
                for pf in (0, 1, 2):
                    plan = tplan.SchedulePlan.from_table(name, sp, tt,
                                                         prefetch=pf)
                    assert tplan.slot_violations(plan.packed) == []
                    n += 1
    assert n == 72


# --------------------------------------------------------------------------- #
# The plan cache
# --------------------------------------------------------------------------- #

KEY = ("gpt-1.5b/L22/d2304", 2, 1, 1, 8, 4, 1, 1024, 1, 1, 1, "a800",
       "flat", "none", "gathered", None, "auto", None)


def test_plan_cache_persisted_hit_rebuilds_without_simulating(tmp_path):
    _, tcm = _gpt_cms(2, 1)
    cold = tplan.select_plan(2, 1, 8, 4, tcm, preset="a800", prefetch=1,
                             cache_key=KEY, persist=True)
    info = tplan.plan_cache_info()
    assert info["misses"] == 1 and info["simulate_calls"] == 7
    assert info["persisted"] == {"path": str(tmp_path / "port_plans.json"),
                                 "enabled": True, "entries": 1}
    assert tplan.select_plan(2, 1, 8, 4, tcm, cache_key=KEY,
                             persist=True) is cold   # in memory
    tplan.clear_plan_cache()
    warm = tplan.select_plan(2, 1, 8, 4, tcm, preset="a800", prefetch=1,
                             cache_key=KEY, persist=True)
    info = tplan.plan_cache_info()
    assert (info["simulate_calls"], info["measure_calls"],
            info["misses"]) == (0, 0, 0)
    assert info["disk_hits"] == {KEY: 1}
    assert warm.provenance == "cache:disk"
    assert warm.selected.name == cold.selected.name == "autogen"
    _tables_equal(cold.selected.table, warm.selected.table)
    for f in warm.selected.packed.FIELDS:
        np.testing.assert_array_equal(getattr(warm.selected.packed, f),
                                      getattr(cold.selected.packed, f))
    assert warm.analysis == cold.analysis
    assert warm.ranking() == cold.ranking()


def test_plan_cache_store_and_the_ranks_agreement(tmp_path):
    """``store=False`` (every rank but 0) reads the file and never writes
    it; where ``sync`` says another rank missed its caches, a rank with a
    persisted hit searches too."""
    path = tmp_path / "port_plans.json"
    _, tcm = _gpt_cms(2, 1)
    tplan.select_plan(2, 1, 8, 4, tcm, preset="a800", cache_key=KEY,
                      persist=True, store=False)
    assert not path.exists()
    cold = tplan.select_plan(2, 1, 8, 4, tcm, preset="a800",
                             cache_key=KEY[:-1] + (0,), persist=True)
    assert path.exists() and cold.provenance == "search"
    tplan.clear_plan_cache()
    seen = []

    def other_rank_missed(x):
        seen.append(x)
        return 1.0

    sel = tplan.select_plan(2, 1, 8, 4, tcm, preset="a800",
                            cache_key=KEY[:-1] + (0,), persist=True,
                            sync=other_rank_missed)
    assert seen == [0.0]            # this rank had a persisted hit
    assert sel.provenance == "search"
    assert tplan.plan_cache_info()["misses"] == 1
    assert tplan.plan_cache_info()["disk_hits"] == {}


def test_session_refuses_ranks_that_selected_different_plans(
        monkeypatch):
    """The ranks all-gather the winner's name and table sha256; a rank
    that disagrees fails the session."""
    import types

    s = tsession("llama3.2-1b", mode="train", device="cpu",
                 schedule="auto")
    s.mesh = types.SimpleNamespace(world=2)

    def gather(out, mine):
        out[:] = [mine, (mine[0], "0" * 64)]

    monkeypatch.setattr(torch.distributed, "all_gather_object", gather)
    with pytest.raises(SessionError, match="selected different plans"):
        s._check_same_plan(s.plan_selection)
    monkeypatch.setattr(torch.distributed, "all_gather_object",
                        lambda out, mine: out.__setitem__(
                            slice(None), [mine, mine]))
    s._check_same_plan(s.plan_selection)


def test_plan_cache_corrupt_file_searches_cleanly(tmp_path):
    path = tmp_path / "port_plans.json"
    _, tcm = _gpt_cms(2, 1)
    for junk in ("{not json", json.dumps({"version": 1, "entries": {
            tplan_cache.entry_key(KEY): {
                "fp": tplan_cache.fingerprint(tcm, tplan.SELECT_KEY_SCHEMA),
                "record": {"schedule": "zeropp"}}}})):
        path.write_text(junk)
        tplan.clear_plan_cache()
        sel = tplan.select_plan(2, 1, 8, 4, tcm, preset="a800",
                                cache_key=KEY, persist=True)
        assert sel.provenance == "search"
        assert tplan.plan_cache_info()["misses"] == 1
    assert json.loads(path.read_text())["version"] == 1


def test_plan_cache_fingerprint_follows_the_cost_model():
    _, a = _gpt_cms(2, 1)
    _, b = _gpt_cms(2, 1, dp=2)
    fp = tplan_cache.fingerprint
    schema = tplan.SELECT_KEY_SCHEMA
    assert fp(a, schema) == fp(dataclasses.replace(a), schema)
    assert fp(a, schema) != fp(b, schema)
    assert fp(a, schema) != fp(a, schema + ("new_knob",))
    # a fingerprint from another cost model is a miss
    tplan.select_plan(2, 1, 8, 4, a, preset="a800", cache_key=KEY,
                      persist=True)
    tplan.clear_plan_cache()
    tplan.select_plan(2, 1, 8, 4, b, preset="a800", cache_key=KEY,
                      persist=True)
    assert tplan.plan_cache_info()["misses"] == 1


@pytest.mark.parametrize("off", ["off", "0", "none", "disabled"])
def test_plan_cache_off_disables_persistence(off, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", off)
    assert tplan_cache.cache_path() is None
    _, tcm = _gpt_cms(2, 1)
    tplan.select_plan(2, 1, 8, 4, tcm, cache_key=KEY, persist=True)
    tplan.clear_plan_cache()
    tplan.select_plan(2, 1, 8, 4, tcm, cache_key=KEY, persist=True)
    info = tplan.plan_cache_info()
    assert info["misses"] == 1 and info["disk_hits"] == {}
    assert info["persisted"] == {"path": None, "enabled": False,
                                 "entries": 0}
    assert list(tmp_path.iterdir()) == []


def test_plan_cache_path_is_never_the_references(tmp_path, monkeypatch):
    assert tplan_cache.ENV_VAR == "REPRO_TORCH_PLAN_CACHE" != \
        jplan_cache.ENV_VAR
    assert tplan_cache.DEFAULT_PATH == "~/.cache/repro_torch/plans.json"
    assert tplan_cache.DEFAULT_PATH != jplan_cache.DEFAULT_PATH
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path))
    ref = tmp_path / "ref_plans.json"
    assert tplan_cache.cache_path() == str(
        tmp_path / ".cache" / "repro_torch" / "plans.json")
    _, tcm = _gpt_cms(2, 1)
    tplan.select_plan(2, 1, 8, 4, tcm, cache_key=KEY, persist=True)
    assert not ref.exists()
    assert (tmp_path / ".cache" / "repro_torch" / "plans.json").exists()
    assert not (tmp_path / ".cache" / "repro").exists()
    assert tplan_cache._SALT_FILES == jplan_cache._SALT_FILES
    assert os.path.dirname(tplan_cache.__file__) != \
        os.path.dirname(jplan_cache.__file__)


# --------------------------------------------------------------------------- #
# The facade
# --------------------------------------------------------------------------- #


BAD_SPECS = [
    dict(schedule="auto_profiled", profile_top_k=0),
    dict(schedule="auto_profiled", profile_budget_s=-1.0),
    dict(schedule="auto", profile_top_k=5),
    dict(schedule="zeropp", profile_budget_s=3.0),
    dict(schedule="auto", mem_budget=0.0),
    dict(schedule="zeropp", mem_budget=1e9),
]


@pytest.mark.parametrize("kw", BAD_SPECS)
def test_spec_checks_equal_the_reference(kw):
    with pytest.raises(Exception) as want:
        jsession("llama3.2-1b", mode="train", data=1, **kw)
    with pytest.raises(SessionError) as got:
        tsession("llama3.2-1b", mode="train", device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_spec_refuses_tpu_unknown_presets_and_serve_auto():
    with pytest.raises(SessionError, match="does not carry the reference's "
                                           "TPU preset"):
        tsession("llama3.2-1b", mode="train", device="cpu",
                 schedule="auto", cost_preset="tpu_v5e")
    with pytest.raises(SessionError, match="unknown cost_preset 'h100'"):
        tsession("llama3.2-1b", mode="train", device="cpu",
                 cost_preset="h100")
    # a serve session's schedule="auto" runs the reference serve
    # Session's selection (seq = max_seq, one sequence a micro-batch)
    # and describe() reports it, beside the table serving runs
    js = jsession("llama3.2-1b", mode="serve", data=1, max_seq=16,
                  schedule="auto")
    ts = tsession("llama3.2-1b", mode="serve", device="cpu", max_seq=16,
                  schedule="auto")
    jd, td = js.describe()["schedule"], ts.describe()["schedule"]
    assert ts.rc.schedule == js.rc.schedule == td["auto"]["selected"]
    assert td["auto"] == jd["auto"]
    assert td["serve_table"] == "fwd_only"
    for k in SIMULATED:
        assert td[k] == jd[k], k
    with pytest.raises(Exception) as want:
        jsession("llama3.2-1b", mode="serve", max_seq=16,
                 schedule="auto_profiled")
    with pytest.raises(SessionError) as got:
        tsession("llama3.2-1b", mode="serve", device="cpu", max_seq=16,
                 schedule="auto_profiled")
    assert str(got.value) == str(want.value)
    with pytest.raises(SessionError, match="or pass schedule='auto'"):
        tsession("llama3.2-1b", mode="train", device="cpu",
                 schedule="nope")


SIMULATED = ("name", "microbatches", "unit", "ticks", "preset", "makespan",
             "bubble_ratio", "peak_mem", "gathers_per_rank", "reduces",
             "comm_frac", "prefetch", "stash_depth", "rs_overlap",
             "collectives")


@pytest.mark.parametrize("arch,ov", [
    ("llama3.2-1b", dict(pp=1, microbatches=8, unit=4)),
    ("gpt_paper", dict(pp=1, vpp=2, microbatches=4, unit=2,
                       gather_prefetch=0)),
])
def test_auto_session_matches_the_reference_session(arch, ov):
    """``schedule="auto"`` at one rank picks the reference Session's plan
    at the same dp; ``describe()["schedule"]`` has the reference's keys
    (and the port's own) with equal simulated values and the same
    ``auto`` and ``cache`` blocks."""
    js = jsession(arch, mode="train", data=1, schedule="auto",
                  cost_preset="a800", overrides=ov)
    ts = tsession(arch, mode="train", device="cpu", schedule="auto",
                  cost_preset="a800", overrides=ov)
    jd, td = js.describe()["schedule"], ts.describe()["schedule"]
    assert ts.rc.schedule == js.rc.schedule == jd["auto"]["selected"]
    assert set(jd) <= set(td)
    for k in SIMULATED:
        assert td[k] == jd[k], k
    assert td["auto"] == jd["auto"]
    assert set(td["cache"]) == set(jd["cache"])
    for k in ("hits", "disk_hits", "misses", "simulate_calls",
              "measure_calls", "entries"):
        assert td["cache"][k] == jd["cache"][k], k
    assert ts.rt.plans["main"] is ts.plan_selection.selected
    _tables_equal(js.plan_selection.selected.table,
                  ts.plan_selection.selected.table)
    # a second session: the in-memory hit, the same plan object
    again = tsession(arch, mode="train", device="cpu", schedule="auto",
                     overrides=ov)
    assert again.rt.plans["main"] is ts.rt.plans["main"]
    assert again.describe()["schedule"]["auto"]["provenance"] == {
        "selection": "search", "this_session": "memory-hit"}


@pytest.mark.parametrize("schedule", ["zeropp", "autogen_gated", "1f1b"])
def test_fixed_schedule_describe_matches_the_reference(schedule):
    ov = dict(pp=1, vpp=2, microbatches=4, unit=2, schedule=schedule)
    jd = jsession("llama3.2-1b", mode="train", data=1,
                  overrides=ov).describe()["schedule"]
    td = tsession("llama3.2-1b", mode="train", device="cpu",
                  overrides=ov).describe()["schedule"]
    for k in SIMULATED:
        assert td[k] == jd[k], k
    assert "auto" not in td and "cache" not in td


# --------------------------------------------------------------------------- #
# The train step
# --------------------------------------------------------------------------- #


OV = dict(pp=1, vpp=2, microbatches=4, unit=2)


@pytest.fixture(scope="module")
def ref_step():
    """Reduced llama3.2-1b at pp 1, vpp 2: the reference's params and
    batch, and ``jax.value_and_grad`` of its ``reference_loss``."""
    js = jsession("llama3.2-1b", mode="train", seq_len=16, data=1,
                  overrides=dict(OV, schedule="zeropp"))
    jp = jax.tree.map(np.asarray, js.init_params(jax.random.PRNGKey(0)))
    batch = js.stream(seed=3).batch(0)
    cfg, rc = js.cfg, js.rc
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.reference_loss(cfg, rc, p, batch["tokens"],
                                        batch["labels"])))(jp)
    return jp, batch, float(loss), jax.tree.map(np.asarray, grads)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_step(schedule, jp, batch):
    ts = tsession("llama3.2-1b", mode="train", seq_len=16, device="cpu",
                  overrides=dict(OV, schedule=schedule))
    g, m = ts.train_step(tparams.from_reference(jp, device="cpu"), batch)
    return ts, g, float(m["loss_sum"])


def _close(grads, want, loss, want_loss):
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    n = 0
    for path, w in _leaves(want):
        got = _get(grads, path).numpy()
        assert np.abs(got - w).max() <= GRAD_RTOL * np.abs(w).max(), path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))


@pytest.mark.parametrize("schedule", ["autogen", "autogen_gated"])
def test_autogen_step_matches_jax(ref_step, schedule):
    """One step against ``jax.value_and_grad(reference_loss)`` and, where
    the reference's packed table reads only resident stage blocks, the
    JAX ``make_train_step`` under the same schedule."""
    jp, batch, want_loss, want = ref_step
    ts, g, loss = _port_step(schedule, jp, batch)
    assert ts.describe()["schedule"]["stash_depth"] == (
        2 if schedule == "autogen_gated" else 4)
    _close(g, want, loss, want_loss)
    js = jsession("llama3.2-1b", mode="train", seq_len=16, data=1,
                  overrides=dict(OV, schedule=schedule))
    jt = js.rt.tables["main"]
    assert tplan.slot_violations(jt) == []
    _tables_equal(js.rt.plans["main"].table, ts.rt.plans["main"].table)
    jg, jm = js.train_step(jax.tree.map(np.asarray, jp), batch)
    _close(g, jax.tree.map(np.asarray, jg), loss, float(jm["loss_sum"]))


def test_autogen_gated_grads_bit_identical_to_zeropp(ref_step):
    jp, batch, _, _ = ref_step
    _, gz, lz = _port_step("zeropp", jp, batch)
    ts, gg, lg = _port_step("autogen_gated", jp, batch)
    assert ts.rc.schedule == "autogen_gated"
    assert lg == lz
    bad = [p for p, t in _leaves(gg) if not torch.equal(t, _get(gz, p))]
    assert bad == []


def test_launch_train_auto_names_the_selected_schedule():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch.main(["--device", "cpu", "--arch", "gpt_paper",
                      "--schedule", "auto", "--steps", "2",
                      "--microbatches", "4", "--unit", "2"])
    text = buf.getvalue()
    sel = tsession("gpt_paper", mode="train", device="cpu",
                   schedule="auto", seq_len=32,
                   overrides=dict(microbatches=4, unit=2)).rc.schedule
    assert f"schedule=auto selected {sel!r} (search; this session: " \
           "search;" in text, text
    assert "simulated ranking: " in text
    assert "TRAIN_OK steps=2" in text and f"schedule={sel} " in text


def test_launch_train_restart_keeps_the_selected_plan(tmp_path):
    """Under the fault-tolerance controller the restart's session takes
    the selection from the in-memory cache (the same plan object, never
    regenerated from its name): the report's schedule is the rebuilt
    session's, a memory hit of the first one's selection."""
    report = tmp_path / "report.json"
    with contextlib.redirect_stdout(io.StringIO()):
        tlaunch.main(["--device", "cpu", "--arch", "gpt_paper",
                      "--schedule", "auto", "--steps", "2",
                      "--microbatches", "4", "--unit", "2",
                      "--ckpt-dir", str(tmp_path / "ckpt"),
                      "--ckpt-every", "1", "--inject-failure-at", "1",
                      "--report", str(report)])
    rep = json.loads(report.read_text())
    assert rep["fault_tolerance"]["failures"] == 1
    auto = rep["schedule"]["auto"]
    assert auto["provenance"] == {"selection": "search",
                                  "this_session": "memory-hit"}
    assert rep["schedule"]["name"] == auto["selected"]
    assert rep["schedule"]["cache"]["misses"] == 1
