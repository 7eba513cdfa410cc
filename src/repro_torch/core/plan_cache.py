"""Persisted on-disk plan cache for ``select_plan`` outcomes.

The port's copy of ``repro/core/plan_cache.py``, with a file of its own:
it never reads or writes the reference's path or environment variable.

A production job should pay for the §4 schedule search — and for the
``auto_profiled`` measured refinement, which times real steps — exactly
once per (arch × shape × mesh × preset × knobs × code-version) point,
across *processes*. This module stores the winner's
TickTable (via ``to_arrays``) plus every candidate's analysis in one
JSON file, so a warm hit rebuilds the selection with zero schedule
generation, zero simulation and zero measurement: pure array
reconstruction + ``pack_table``.

Location: ``~/.cache/repro_torch/plans.json`` by default; the
``REPRO_TORCH_PLAN_CACHE`` env var overrides the path, and the values
``0``/``off``/``none``/``disabled`` disable persistence entirely.

Invalidation is by fingerprint, not by deleting entries: every entry
records a hash of (cost-model profile × knob schema × code salt), where
the code salt covers the port's own schedule-generation/simulation sources
(``plan.py``, ``simulator.py``, ``schedules.py``, ``generators.py`` and
``autogen.py`` of ``repro_torch/core``). An
entry whose fingerprint no longer matches is treated as a miss — a
changed α–β profile, a new selection knob, or edited scheduling code can
never serve a stale plan. Corrupt or partial cache files (killed writer,
concurrent truncation, hand edits) degrade to a clean search; they never
raise into the session.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile

import numpy as np

DEFAULT_PATH = "~/.cache/repro_torch/plans.json"
ENV_VAR = "REPRO_TORCH_PLAN_CACHE"
_OFF_VALUES = ("0", "off", "none", "disabled")
_VERSION = 1

# sources whose edits can change what select_plan would pick — the code
# salt folds their bytes into every entry fingerprint
_SALT_FILES = ("plan.py", "simulator.py", "schedules.py", "generators.py",
               "autogen.py")
_SALT_CACHE: dict[str, str] = {}


def cache_path() -> str | None:
    """Resolved cache file path, or None when persistence is disabled."""
    v = os.environ.get(ENV_VAR)
    if v is not None:
        if v.strip().lower() in _OFF_VALUES:
            return None
        return os.path.abspath(os.path.expanduser(v))
    return os.path.expanduser(DEFAULT_PATH)


def code_salt() -> str:
    """Hash of the schedule-generation/simulation sources (cached)."""
    d = os.path.dirname(os.path.abspath(__file__))
    if d not in _SALT_CACHE:
        h = hashlib.sha256()
        for fn in _SALT_FILES:
            try:
                with open(os.path.join(d, fn), "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(fn.encode())
        _SALT_CACHE[d] = h.hexdigest()[:16]
    return _SALT_CACHE[d]


def fingerprint(cm, knob_schema: tuple) -> str:
    """Entry validity stamp: cost-model profile × knob schema × code.

    ``knob_schema`` is the *names* of the key components (not their
    values — values live in the key itself): adding a selection knob in
    a later version changes the schema and invalidates every old entry.
    """
    payload = {
        "cost_model": dataclasses.asdict(cm),
        "knob_schema": list(knob_schema),
        "salt": code_salt(),
    }
    blob = json.dumps(payload, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def entry_key(cache_key: tuple) -> str:
    """Stable string form of a selection cache key tuple."""
    return "|".join(repr(k) for k in cache_key)


# --------------------------------------------------------------------------- #
# (De)serialization
# --------------------------------------------------------------------------- #


def table_record(tt) -> dict:
    """JSON-able form of a TickTable (dense arrays; no Task objects)."""
    from repro_torch.core.schedules import to_arrays

    arr = to_arrays(tt)
    return {
        "P": tt.P, "V": tt.V, "n_mb": tt.n_mb, "unit": tt.unit,
        "segment": tt.segment,
        "kind": arr["kind"].tolist(), "mb": arr["mb"].tolist(),
        "v": arr["v"].tolist(), "gather": arr["gather"].tolist(),
        "reduce": arr["reduce"].tolist(),
    }


def table_from_record(rec: dict):
    """Rebuild a TickTable from :func:`table_record` output (validated)."""
    from repro_torch.core.schedules import NOP, Task, TickTable

    P, V, n_mb = int(rec["P"]), int(rec["V"]), int(rec["n_mb"])
    kind = np.asarray(rec["kind"], np.int32)
    mb = np.asarray(rec["mb"], np.int32)
    v = np.asarray(rec["v"], np.int32)
    if kind.ndim != 2 or kind.shape[1] != P or kind.shape != mb.shape \
            or kind.shape != v.shape:
        raise ValueError(f"table arrays malformed: {kind.shape}")
    grid = [[(Task(int(kind[t, r]), int(mb[t, r]), int(v[t, r]) * P + r)
              if kind[t, r] != NOP else None)
             for r in range(P)] for t in range(kind.shape[0])]
    tt = TickTable(
        P=P, V=V, n_mb=n_mb, unit=int(rec["unit"]), grid=grid,
        gather=np.asarray(rec["gather"], np.int32),
        reduce=np.asarray(rec["reduce"], np.int32),
        segment=rec.get("segment", "main"))
    tt.validate()
    return tt


def selection_record(sel) -> dict:
    """JSON-able form of a PlanSelection (winner table + all analyses)."""
    from repro_torch.core.plan import PlanAnalysis

    win = sel.selected
    return {
        "schedule": win.name,
        "sched_params": dataclasses.asdict(win.params),
        "prefetch": win.prefetch,
        "table": table_record(win.table),
        "analysis": sel.analysis.as_dict(),
        "candidates": {
            n: (a.as_dict() if isinstance(a, PlanAnalysis) else str(a))
            for n, a in sel.candidates.items()},
        "preset": sel.preset,
        "mem_budget": sel.mem_budget,
        "provenance": sel.provenance,
        "measured": sel.measured,
        "profile": sel.profile,
    }


def selection_from_record(rec: dict, cache_key: tuple):
    """Rebuild a PlanSelection — no generate/autogen/simulate calls."""
    from repro_torch.core.generators import SchedParams
    from repro_torch.core.plan import (
        PlanAnalysis,
        PlanSelection,
        SchedulePlan,
    )

    sp_fields = {f.name for f in dataclasses.fields(SchedParams)}
    sp = SchedParams(**{k: v for k, v in rec["sched_params"].items()
                        if k in sp_fields})
    plan = SchedulePlan.from_table(rec["schedule"], sp,
                                   table_from_record(rec["table"]),
                                   prefetch=int(rec["prefetch"]))
    ana_fields = {f.name for f in dataclasses.fields(PlanAnalysis)}

    def _ana(d):
        if not isinstance(d, dict):
            return str(d)
        return PlanAnalysis(**{k: v for k, v in d.items()
                               if k in ana_fields})

    analysis = _ana(rec["analysis"])
    if not isinstance(analysis, PlanAnalysis):
        raise ValueError("winner analysis malformed")
    # seed the plan's per-preset analysis cache so .analyze() under the
    # same collective profile returns the stored numbers without a sim
    plan.analyses[(analysis.preset, analysis.n_coll_gather,
                   analysis.n_coll_reduce, analysis.coll_alpha,
                   analysis.n_a2a_f, analysis.n_a2a_b,
                   analysis.t_a2a)] = analysis
    return PlanSelection(
        selected=plan, analysis=analysis, preset=rec["preset"],
        candidates={n: _ana(a) for n, a in rec["candidates"].items()},
        key=cache_key, mem_budget=rec.get("mem_budget"),
        provenance="cache:disk",
        measured=rec.get("measured"), profile=rec.get("profile"))


# --------------------------------------------------------------------------- #
# File I/O (best-effort, never raises into the caller)
# --------------------------------------------------------------------------- #


def _read(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict) or \
                data.get("version") != _VERSION or \
                not isinstance(data.get("entries"), dict):
            return {"version": _VERSION, "entries": {}}
        return data
    except (OSError, ValueError):
        # missing / corrupt / truncated file: clean-search fallback
        return {"version": _VERSION, "entries": {}}


def _write(path: str, data: dict) -> bool:
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   prefix=".plans-", suffix=".json")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return True
    except OSError:
        return False


def load_entry(cache_key: tuple, fp: str):
    """The stored record for (key, fingerprint) or None (miss/invalid)."""
    path = cache_path()
    if path is None:
        return None
    ent = _read(path)["entries"].get(entry_key(cache_key))
    if not isinstance(ent, dict) or ent.get("fp") != fp:
        return None
    return ent.get("record")


def store_entry(cache_key: tuple, fp: str, record: dict) -> bool:
    """Write (merge) one selection record; False when disabled/failed."""
    path = cache_path()
    if path is None:
        return False
    data = _read(path)   # re-read: merge with concurrent writers
    data["entries"][entry_key(cache_key)] = {"fp": fp, "record": record}
    return _write(path, data)


def clear_disk() -> bool:
    """Delete the persisted cache file (True if one was removed)."""
    path = cache_path()
    if path is None:
        return False
    try:
        os.remove(path)
        return True
    except OSError:
        return False


def info() -> dict:
    """Persisted-cache summary for ``plan_cache_info()``."""
    path = cache_path()
    if path is None:
        return {"path": None, "enabled": False, "entries": 0}
    return {"path": path, "enabled": True,
            "entries": len(_read(path)["entries"])}
