"""The tick engine's collectives overlap its cells, and the facade's
multi-rank knobs; one process, no ranks spawned.

* A recording communicator (the one-rank identity, with every
  collective issued asynchronously, in flight until waited on, and its
  wait logged at the engine's tick) drives one rank's engine on reduced
  llama3.2-1b (pp 1, vpp 2, 4 micro-batches in units of 2) at gather
  prefetch 2. Each gather is issued at its ``PackedTable`` tick, and
  waited on at the first cell that reads its slot, never earlier; some
  gathers run ahead of that cell (the overlap). Each reduce is issued at
  its table tick and waited on after the walk (it is in flight until
  then), in issue order, before ``train_step`` returns (under int8,
  only the scale's max is synchronous); its grads equal the plain
  one-rank step's bit for bit. On one rank, where a reduce has
  completed when it is issued, it is added at its tick.
* ``pods=``, ``grad_compress="int8"`` and ``coalesce="none"`` are
  accepted by the train facade; multi-rank serving and
  ``moe_mode="ep"`` still raise ``SessionError`` naming their items.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.api.spec import SessionSpec  # noqa: E402
from repro_torch.core import executor  # noqa: E402
from repro_torch.core.comm import Pending  # noqa: E402
from repro_torch.core.fsdp import LocalComm  # noqa: E402
from repro_torch.core.schedules import B as KB  # noqa: E402
from repro_torch.core.schedules import F as KF  # noqa: E402
from repro_torch.core.schedules import W as KW  # noqa: E402

OV = dict(pp=1, vpp=2, schedule="zeropp", microbatches=4, unit=2,
          gather_prefetch=2)


class InFlight:
    """A collective that stays in flight until it is waited on, which
    is logged at the engine's tick."""

    def __init__(self, rec, comm):
        self.rec, self.comm = rec, comm

    def is_completed(self) -> bool:
        return False

    def wait(self) -> None:
        assert self.rec["waited"] is None, f"{self.rec} waited twice"
        self.rec["waited"] = self.comm.engine.tick


class RecordingComm(LocalComm):
    """The one-rank communicator whose collectives are all asynchronous:
    each logs (kind, tick issued, tick waited) on ``engine.tick``."""

    def __init__(self):
        super().__init__()
        self.engine, self.log = None, []

    def _issue(self, kind, x) -> Pending:
        rec = dict(kind=kind, issued=self.engine.tick, waited=None)
        self.log.append(rec)
        return Pending(InFlight(rec, self), x, x.device)

    def all_gather_async(self, x):
        return self._issue("gather", x)

    def reduce_scatter_async(self, x):
        return self._issue("reduce", x)

    def all_to_all_async(self, x):
        return self._issue("reduce", x)

    def all_reduce_async(self, x, op="sum"):
        return self._issue("reduce", x)

    def all_reduce(self, x, op="sum"):
        # synchronous: the int8 scale's max over the data axis
        t = self.engine.tick
        self.log.append(dict(kind="sync", issued=t, waited=t))
        return x


def _run(monkeypatch, overrides, record: bool):
    """One train step of reduced llama on one rank; with ``record`` the
    engine's communicator records, and the reads of each slot are
    logged as (tick, slot)."""
    sess = tsession("llama3.2-1b", mode="train", seq_len=16, device="cpu",
                    overrides=dict(OV, **overrides))
    params = sess.init_params(torch.Generator().manual_seed(0))
    batch = sess.stream(seed=3).batch(0)
    reads = []
    if record:
        comm = RecordingComm()
        sess.rt.comm = comm
        post_init = executor.TickEngine.__post_init__
        stage_params = executor.TickEngine.stage_params

        def hooked_init(eng):
            post_init(eng)
            comm.engine = eng

        def logged_read(eng, v, use_slot):
            reads.append((eng.tick, use_slot))
            return stage_params(eng, v, use_slot)

        monkeypatch.setattr(executor.TickEngine, "__post_init__",
                            hooked_init)
        monkeypatch.setattr(executor.TickEngine, "stage_params", logged_read)
    grads, _ = sess.train_step(params, batch)
    monkeypatch.undo()
    return sess, grads, reads, (comm.log if record else None)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("overrides", [
    dict(), dict(coalesce="none", grad_compress="int8")],
    ids=["flat", "none-int8"])
def test_gathers_wait_at_use_and_reduces_drain_before_return(
        monkeypatch, overrides):
    sess, grads, reads, log = _run(monkeypatch, overrides, record=True)
    pt = sess.rt.tables["main"]
    per = 1 if sess.rc.coalesce == "flat" else len(
        sess.rt.gatherable["main"])
    gathers = [r for r in log if r["kind"] == "gather"]
    ticks = [t for t in range(pt.T) if pt.gather_v[t, 0] >= 0]
    # each gather is issued at its table tick (per tensor: one a tensor)
    assert [g["issued"] for g in gathers] == [t for t in ticks
                                              for _ in range(per)]
    ahead = 0
    for i, t in enumerate(ticks):
        slot = int(pt.gather_slot[t, 0])
        first = min(rt for rt, s in reads if rt >= t and s == slot)
        assert int(pt.kind[first, 0]) in (KF, KB, KW)
        for g in gathers[i * per:(i + 1) * per]:
            # waited at the first cell that reads its slot, not at issue
            assert g["waited"] == first, (t, g)
        ahead += first > t
    assert ahead > 0, "no gather runs ahead of the cell that reads it"
    # every reduce is issued at a reduce tick and waited on after the
    # walk, in issue order, before train_step returned
    reduces = [r for r in log if r["kind"] == "reduce"]
    rticks = sorted({r["issued"] for r in reduces})
    assert rticks == [t for t in range(pt.T) if pt.reduce_v[t, 0] >= 0]
    assert all(r["waited"] == pt.T - 1 for r in reduces), reduces
    # the int8 scales' max, one a reduce, waited on at once
    sync = [r["issued"] for r in log if r["kind"] == "sync"]
    if sess.rc.grad_compress == "int8":
        assert sorted(sync) == sorted(r["issued"] for r in reduces)
    else:
        assert sync == []
    # the recording run's grads are the plain one-rank step's
    _, want, _, _ = _run(monkeypatch, overrides, record=False)
    for path, g in _leaves(grads):
        w = want
        for k in path:
            w = w[k]
        assert torch.equal(g, w), path


def test_train_session_accepts_the_multi_rank_knobs():
    for kw in (dict(overrides=dict(grad_compress="int8")),
               dict(overrides=dict(coalesce="none")), dict(pods=1),
               dict(layers=2)):
        s = tsession("llama3.2-1b", mode="train", device="cpu", **kw)
        d = s.describe()
        assert d["geometry"]["pods"] == 1
        assert d["schedule"]["grad_compress"] == s.rc.grad_compress
    assert s.cfg.n_layers == 2
    with pytest.raises(SessionError, match="process group"):
        tsession("llama3.2-1b", mode="train", device="cpu", pods=2)


@pytest.mark.parametrize("kw,match", [
    # multi-rank serving landed (ROADMAP.md queue 1 item 4; ids kept from
    # when it was item 1b): these specs validate, and the session then
    # needs the ranks' process group, as a train session does
    pytest.param(dict(mode="serve", max_seq=32, pods=2), None,
                 id="kw0-item 1b"),
    pytest.param(dict(mode="serve", max_seq=32, data=2), None,
                 id="kw1-item 1b"),
    (dict(mode="train", overrides=dict(moe_mode="ep")), "MoE slice"),
    (dict(mode="train", overrides=dict(grad_compress="int4")), "int8"),
    (dict(mode="train", overrides=dict(coalesce="tensor")), "'none'"),
    (dict(mode="train", pods=0), "pods must be >= 1"),
])
def test_session_still_refuses_multi_rank_serving_and_ep(kw, match):
    if match is None:
        spec = SessionSpec(arch="llama3.2-1b", device="cpu", **kw)
        assert spec.validate() is spec
        with pytest.raises(SessionError, match="process group"):
            tsession("llama3.2-1b", device="cpu", **kw)
        return
    with pytest.raises(SessionError, match=match):
        tsession("llama3.2-1b", device="cpu", **kw)


def test_recording_comm_is_the_identity():
    x = torch.from_numpy(np.arange(6, dtype=np.float32))
    comm = RecordingComm()
    comm.engine = type("E", (), {"tick": 3})()
    pend = comm.all_gather_async(x)
    assert not pend.ready()
    assert torch.equal(pend.wait(), x) and pend.ready()
    assert comm.log == [dict(kind="gather", issued=3, waited=3)]


def test_one_rank_reduces_are_added_at_their_tick(monkeypatch):
    """On one rank a reduce has completed when it is issued: it is added
    into the shard at its tick, and no packed gradient is held to the
    end of the walk."""
    held = []
    add = executor.TickEngine._add_reduces

    def logged(eng, wait):
        add(eng, wait)
        held.append((eng.tick, len(eng.reduces)))

    monkeypatch.setattr(executor.TickEngine, "_add_reduces", logged)
    sess = tsession("llama3.2-1b", mode="train", seq_len=16, device="cpu",
                    overrides=OV)
    sess.train_step(sess.init_params(torch.Generator().manual_seed(0)),
                    sess.stream(seed=3).batch(0))
    pt = sess.rt.tables["main"]
    assert [t for t, _ in held[:-1]] == [
        t for t in range(pt.T) if pt.reduce_v[t, 0] >= 0]
    assert all(n == 0 for _, n in held)
