"""Weight-resident serving (``RunConfig.serve_resident``) in the port;
one process, no ranks spawned.

The reference keeps every (non-EP) stage tensor whole on each model rank
under the knob: no FSDP gather a tick, a train step all-reduces the stage
grads over the data axis, and the cost model counts no collective
(``repro/core/pipeline.py`` ``Runtime``, ``repro/api/session.py``
``_coll_counts``). Here:

* ``describe()["schedule"]["collectives"]`` equals the reference
  Session's with and without the knob, in serve and in train mode
  (reduced llama3.2-1b, pp 1);
* on one rank a resident train step equals the gathered one bit for bit;
* at data 2 x pp 2 (a ``MeshShape``, no collectives) the Runtime gathers
  nothing, each rank's part holds its stage rows whole, ``unshard`` is
  its inverse, ``owned`` counts each stage tensor on data index 0 only,
  and the tick engine reads every tensor in place;
* the serve launcher's ``--layouts contiguous+resident`` sets the knob
  on that layout only, and one rank serves the same streams with it.

The mesh itself (streams, logits and 0 gathers at data 2 x pp 2) is a
case of the one gloo spawn in ``tests/test_torch_multirank.py``.
"""

import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import session as jsession  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import llama3p2_1b as tllama  # noqa: E402
from repro_torch.core.comm import MeshShape  # noqa: E402
from repro_torch.core.executor import TickEngine  # noqa: E402
from repro_torch.core.pipeline import Runtime  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

TRAIN_OV = dict(pp=1, vpp=2, microbatches=4, unit=2)


@pytest.fixture(autouse=True)
def _plan_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "j.json"))


@pytest.mark.parametrize("resident", [False, True],
                         ids=["gathered", "resident"])
@pytest.mark.parametrize("mode", ["serve", "train"])
def test_collectives_equal_the_reference_session(mode, resident):
    """A serve session reports its schedule under ``schedule="auto"``
    (the port's serve describe() has no other), so the serve case also
    holds the selection to the reference's."""
    ov = dict(TRAIN_OV, serve_resident=resident)
    kw = (dict(max_seq=16, schedule="auto", cost_preset="a800")
          if mode == "serve" else {})
    want = jsession("llama3.2-1b", mode=mode, data=1, overrides=ov,
                    **kw).describe()["schedule"]
    got = tsession("llama3.2-1b", mode=mode, device="cpu", overrides=ov,
                   **kw).describe()["schedule"]
    assert got["collectives"] == want["collectives"]
    assert got["name"] == want["name"]
    n = (got["collectives"]["per_gather_tick"],
         got["collectives"]["per_reduce_tick"])
    assert (n == (0, 0)) == resident, n


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_one_rank_resident_train_step_equals_the_gathered_one():
    out = []
    for resident in (False, True):
        sess = tsession("llama3.2-1b", mode="train", seq_len=16,
                        device="cpu",
                        overrides=dict(TRAIN_OV, serve_resident=resident))
        assert (sess.rt.gatherable["main"] == []) == resident
        params = sess.init_params(torch.Generator().manual_seed(0))
        grads, m = sess.train_step(params, sess.stream(seed=3).batch(0))
        out.append((dict(_leaves(grads)), m))
    (g0, m0), (g1, m1) = out
    assert set(g0) == set(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert torch.equal(m0["loss_sum"], m1["loss_sum"])


def test_resident_layout_on_a_data_2_pp_2_mesh():
    cfg, rc = tllama.reduced()
    rc = dataclasses.replace(rc, pp=2, vpp=2, serve_resident=True)
    shape = MeshShape(2, 2, 1, 1)
    rt = Runtime(cfg, rc, "cpu", shape)
    sharded = Runtime(cfg, dataclasses.replace(rc, serve_resident=False),
                      "cpu", shape)
    specs = rt.stage_specs["main"]
    assert rt.gatherable == {"main": []}
    assert rt.flat_layouts == {"main": None}
    assert sharded.gatherable["main"] and sharded.flat_layouts["main"]
    assert all(rt.local_dim("main", n) is None for n in specs)
    assert all(rt.local_shape("main", n) == tuple(sp.shape)
               for n, sp in specs.items())
    full = tparams.init_all_params(cfg, rc, torch.Generator().manual_seed(1),
                                   "cpu")
    parts = [tparams.shard_for_rank(rt, full, r) for r in range(4)]
    for r, part in enumerate(parts):
        d, _, p = shape.coords(r)
        rows = [p * rc.vpp + v for v in range(rc.vpp)]
        for n, a in part["segments"]["main"].items():
            assert torch.equal(a, full["segments"]["main"][n][rows]), n
    assert all(rt.owned().values())      # rank 0 counts everything
    back = tparams.unshard(rt, parts)
    for (k, a), (k2, b) in zip(_leaves(back), _leaves(full)):
        assert k == k2 and torch.equal(a, b), k
    # owned: stage tensors of data index 1 are copies; io as before
    rt1 = Runtime(cfg, rc, "cpu", shape)
    rt1.rank = shape.rank_of(1, 0, 0)
    s1 = Runtime(cfg, sharded.rc, "cpu", shape)
    s1.rank = rt1.rank
    own, own_sharded = rt1.owned(), s1.owned()
    for k, v in own.items():
        if k.startswith("['segments']"):
            assert v is False, k
        else:
            assert v == own_sharded[k], k
    assert any(own_sharded[k] for k in own if k.startswith("['segments']"))
    # the tick engine over a data axis of two reads every tensor in place
    seg_p = parts[0]["segments"]["main"]
    eng = TickEngine(pt=rt.serve_plan().packed, specs=specs, seg_p=seg_p,
                     flat=None, comm=types.SimpleNamespace(size=2),
                     cdt=torch.float32, rs_dtype=torch.float32,
                     gatherable=rt.gatherable["main"])
    assert eng.gatherable == [] and eng.replicated == sorted(specs)
    assert all(v is None for v in eng.ld.values())
    eng.held[0] = 1
    got = eng.stage_params(1, 0)
    assert set(got) == set(specs)
    for n in specs:
        assert got[n].data_ptr() == seg_p[n][1].data_ptr(), n
    # without the knob the same engine gathers the sharded set
    eng2 = TickEngine(pt=sharded.serve_plan().packed, specs=specs,
                      seg_p=tparams.shard_for_rank(sharded, full,
                                                   0)["segments"]["main"],
                      flat=sharded.flat_layouts["main"],
                      comm=types.SimpleNamespace(size=2), cdt=torch.float32,
                      rs_dtype=torch.float32,
                      gatherable=sharded.gatherable["main"])
    assert eng2.gatherable == sharded.gatherable["main"]
    assert np.all([eng2.ld[n] is not None for n in eng2.gatherable])


def test_serve_launcher_takes_the_resident_layout(tmp_path, capsys):
    """``--layouts contiguous+resident`` sets the knob on that layout's
    session only; one rank serves the same streams in both layouts."""
    args = tserve._args(["--layouts", "contiguous,contiguous+resident"])
    assert args.layouts == ["contiguous", "contiguous+resident"]
    assert "serve_resident" not in tserve._spec(args, 32,
                                                "contiguous").overrides
    assert tserve._spec(args, 32, "contiguous+resident").overrides[
        "serve_resident"] is True
    with pytest.raises(SystemExit, match="unknown layout"):
        tserve._args(["--layouts", "contiguous+gathered"])
    with pytest.raises(SystemExit, match="needs --page-size"):
        tserve._args(["--layouts", "paged+resident"])
    report = tmp_path / "serve.json"
    tserve.main(["--device", "cpu", "--n-requests", "2", "--prompt", "6",
                 "--gen", "3", "--layouts", "contiguous,contiguous+resident",
                 "--report", str(report)])
    assert "SERVE_OK" in capsys.readouterr().out
    rep = json.loads(report.read_text())["layouts"]
    assert rep["contiguous+resident"]["streams"] == \
        rep["contiguous"]["streams"]
