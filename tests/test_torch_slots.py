"""The port's two-slot gather buffer: every F and B cell reads the stage
block it computes with, at every vpp.

* ``pack_table`` over every registered schedule, pp in {1, 2, 4}, vpp in
  {1, 2, 3, 4} and prefetch 0-2 (4 and 8 micro-batches; units as the
  ``Runtime`` sets them: 2 for zeropp, the whole batch otherwise): each F
  and B cell's ``use_slot`` holds its block at its tick, or the table is
  refused naming the schedule, pp, vpp and the first cell;
* at vpp <= 2 the port's ``PackedTable`` equals the reference's
  ``pack_table`` field for field;
* the vpp 4 step of zeropp, 1f1b and gpipe on reduced llama3.2-1b at
  pp 1 (the JAX engine reads evicted blocks there) against the port's
  ``reference_loss`` and ``jax.value_and_grad`` of the reference's:
  loss 1e-5 relative, every gradient max |diff| <= 1e-4 * max |ref|, as
  ``tests/test_torch_multirank.py`` holds a mesh;
* a refused table becomes a ``SessionError``; a hand-corrupted
  ``use_slot`` is refused by ``validate_unit_stash_packed`` and, past
  it, makes ``TickEngine.stage_params`` raise.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.api import session as jsession  # noqa: E402
from repro.core.generators import SchedParams as JSP  # noqa: E402
from repro.core.generators import generate as jgenerate  # noqa: E402
from repro.core.plan import pack_table as jpack  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.api.registry import SCHEDULE_REGISTRY  # noqa: E402
from repro_torch.core import fsdp  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    TickEngine,
    validate_unit_stash_packed,
)
from repro_torch.core.generators import SchedParams as TSP  # noqa: E402
from repro_torch.core.plan import (  # noqa: E402
    UNIT_GATED_SCHEDULES,
    SchedulePlan,
    slot_violations,
)
from repro_torch.core.schedules import B as KB  # noqa: E402
from repro_torch.core.schedules import F as KF  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
SCHEDULES = SCHEDULE_REGISTRY.names()


def _sp(name, P, V, n_mb):
    unit = 2 if name in UNIT_GATED_SCHEDULES else n_mb
    return dict(P=P, V=V, n_mb=n_mb, unit=unit)


def _held(pt, p):
    """Per tick, the block each slot holds once that tick's gather is
    issued (the gather comes before the cell in a tick)."""
    held, out = [-1, -1], []
    for t in range(pt.T):
        if pt.gather_v[t, p] >= 0:
            held[pt.gather_slot[t, p]] = int(pt.gather_v[t, p])
        out.append(tuple(held))
    return out


@pytest.mark.parametrize("V", [1, 2, 3, 4])
@pytest.mark.parametrize("name", SCHEDULES)
def test_every_cell_reads_its_own_block_or_is_refused(name, V):
    n_ok = 0
    for P in (1, 2, 4):
        for n_mb in (4, 8):
            for pf in (0, 1, 2):
                sp = TSP(**_sp(name, P, V, n_mb))
                try:
                    pt = SchedulePlan.build(name, sp, prefetch=pf).packed
                except ValueError as e:
                    msg = str(e)
                    assert "stash" not in msg, msg   # never at these units
                    assert msg.startswith(
                        f"schedule {name!r} at pp={P}, vpp={V}"), msg
                    assert "no tick free to re-gather" in msg, msg
                    continue
                for p in range(P):
                    held = _held(pt, p)
                    for t in range(pt.T):
                        if pt.kind[t, p] in (KF, KB):
                            assert held[t][pt.use_slot[t, p]] == \
                                pt.v[t, p], (P, n_mb, pf, t, p)
                assert slot_violations(pt) == []
                validate_unit_stash_packed(pt)
                n_ok += 1
    # refusals are the exception: most of the grid packs
    assert n_ok >= 14, n_ok


@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("name", SCHEDULES)
def test_packed_tables_at_vpp_le_2_equal_reference(name, V):
    for P in (1, 2, 4):
        for n_mb in (4, 8):
            for pf in (0, 1, 2):
                kw = _sp(name, P, V, n_mb)
                want = jpack(jgenerate(name, JSP(**kw)), prefetch=pf)
                got = SchedulePlan.build(name, TSP(**kw),
                                         prefetch=pf).packed
                for f in got.FIELDS:
                    np.testing.assert_array_equal(
                        getattr(got, f), getattr(want, f),
                        err_msg=f"{f} P={P} n_mb={n_mb} prefetch={pf}")


def test_regathers_where_the_reference_reads_evicted_blocks():
    """zeropp at pp 1, vpp 4: the reference's table reads evicted blocks
    (its first: F of block 3 at tick 11, slot 1 holding block 1; queue 3
    of ROADMAP.md); the port's gathers those blocks again and differs
    from it only by gathers: same cells, more gathers."""
    kw = _sp("zeropp", 1, 4, 4)
    want = jpack(jgenerate("zeropp", JSP(**kw)), prefetch=1)
    bad = slot_violations(want)
    assert bad and bad[0].startswith("F(u1) of stage block 3 at tick 11 "
                                     "on stage rank 0 reads slot 1, which "
                                     "holds block 1"), bad
    got = SchedulePlan.build("zeropp", TSP(**kw), prefetch=1).packed
    assert slot_violations(got) == []
    for f in ("kind", "mb", "v", "reduce_v", "recv_f_u", "recv_b_u"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.gather_v >= 0).sum() > (want.gather_v >= 0).sum()


# --------------------------------------------------------------------------- #
# The vpp 4 step against reference_loss
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def vpp4():
    """Reduced llama3.2-1b at pp 1, vpp 4 (one layer a stage block): the
    reference's params and batch, and ``jax.value_and_grad`` of its
    ``reference_loss`` on them."""
    ov = dict(pp=1, vpp=4, microbatches=4, unit=2)
    js = jsession("llama3.2-1b", mode="train", seq_len=16, data=1,
                  overrides=ov)
    jp = jax.tree.map(np.asarray, js.init_params(jax.random.PRNGKey(0)))
    batch = js.stream(seed=3).batch(0)
    cfg, rc = js.cfg, dataclasses.replace(js.rc, pp=1, vpp=4)
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.reference_loss(cfg, rc, p, batch["tokens"],
                                        batch["labels"]))(jp)
    return ov, jp, batch, float(loss), jax.tree.map(np.asarray, grads)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("schedule", ["zeropp", "1f1b", "gpipe"])
def test_vpp4_step_equals_reference_loss(vpp4, schedule):
    ov, jp, batch, want, jgrads = vpp4
    ts = tsession("llama3.2-1b", mode="train", seq_len=16, device="cpu",
                  overrides=dict(ov, schedule=schedule))
    tp = tparams.from_reference(jp, device="cpu")
    grads, m = ts.train_step(tp, batch)
    ref = float(tmodel.reference_loss(ts.cfg, ts.rc, tp,
                                      torch.from_numpy(batch["tokens"]),
                                      torch.from_numpy(batch["labels"])))
    got = float(m["loss_sum"])
    assert abs(got - ref) <= LOSS_RTOL * abs(ref)
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    n = 0
    for path, w in _leaves(jgrads):
        g = grads
        for k in path:
            g = g[k]
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))


# --------------------------------------------------------------------------- #
# Refusals and the engine's own check
# --------------------------------------------------------------------------- #


def test_session_refuses_a_table_with_no_tick_for_a_regather():
    """interleaved at pp 1, vpp 4 with gathers two ticks ahead leaves no
    free tick to gather block 2 again before its B."""
    with pytest.raises(SessionError) as e:
        tsession("llama3.2-1b", mode="train", device="cpu",
                 overrides=dict(pp=1, vpp=4, schedule="interleaved",
                                microbatches=4, gather_prefetch=2))
    msg = str(e.value)
    assert "schedule 'interleaved' at pp=1, vpp=4" in msg, msg
    assert "B(u" in msg and "tick" in msg and "block 2" in msg, msg


def _corrupted():
    """zeropp at pp 1, vpp 2 with the first B cell pointed at the other
    slot: (table, its tick)."""
    pt = SchedulePlan.build("zeropp", TSP(**_sp("zeropp", 1, 2, 4)),
                            prefetch=1).packed
    t = int(np.flatnonzero(pt.kind[:, 0] == KB)[0])
    pt.use_slot[t, 0] = 1 - pt.use_slot[t, 0]
    return pt, t


def test_validate_refuses_a_corrupted_use_slot():
    pt, t = _corrupted()
    with pytest.raises(ValueError, match=f"at tick {t} on stage rank 0"):
        validate_unit_stash_packed(pt)


@pytest.mark.parametrize("corrupt", [False, True])
def test_stage_params_raises_on_a_corrupted_use_slot(corrupt):
    """The engine records which block each slot holds: a cell that reads
    a slot holding another block raises instead of computing with it."""
    pt, t = _corrupted()
    bad = pt.use_slot[t, 0]
    pt.use_slot[t, 0] = 1 - bad
    eng = TickEngine(pt=pt, specs={}, seg_p={}, flat=None,
                     comm=fsdp.LocalComm(), cdt=torch.float32,
                     rs_dtype=torch.float32, gatherable=[])
    eng.state.update(acc_full={}, acc_shard={}, xbuf={}, bbuf={})
    if corrupt:
        pt.use_slot[t, 0] = bad    # past the engine's validation
    reads = []

    def cell(e, row):
        e.stage_params(row["v"], row["use_slot"])
        reads.append(e.tick)

    for wire in ("xbuf", "bbuf"):     # the wires carry nothing here
        eng.state[wire] = type("Sink", (dict,), {"put": dict.__setitem__})()

    if not corrupt:
        eng.run({KF: cell, KB: cell})
        assert len(reads) == int(((pt.kind == KF) | (pt.kind == KB)).sum())
        return
    with pytest.raises(RuntimeError, match=f"tick {t}: stage block"):
        eng.run({KF: cell, KB: cell})
    assert reads and reads[-1] < t
