"""Serving on a mesh of ranks, the parts one process holds: the serve
table, the tiling, the tick-engine serve body at one rank, the spec's
serve checks and the launcher's flags. The ranks themselves run in the
one gloo spawn of ``tests/test_torch_multirank.py``.

* ``Runtime.serve_plan()`` (``plans["serve_main"]``, built on first
  use) equals the reference's ``fwd_only`` plan at ``unit =
  microbatches`` (what its ``Runtime`` builds) field for field, over pp
  1/2 x vpp 1/2 and gather prefetch 0/1;
* ``serve_tiling`` equals the reference's on a grid of slot counts,
  pods, data, groups and micro-batches (its degenerate tilings too);
* the tick-engine serve body at one rank (``LocalComm``) against
  ``core/serve.py serve_step`` on the same params and batch, contiguous
  and paged: with one micro-batch the same computation, so tokens,
  logits and every cache leaf are equal with ``==``; with two
  micro-batches tokens and caches with ``==`` and logits within 1e-6 of
  the largest |logit| (the head's product then runs over fewer rows at
  a time, and the CPU's BLAS rounds a transposed operand's product by
  its row count: measured 4.2e-7);
* a degenerate tiling (more micro-batches than a rank's rows) serves
  the same tokens as one micro-batch: the extra micro-batches are
  inert, where the reference's overwrite a sampled token (its
  ``serve_body`` runs them on clamped rows);
* the spec's serve checks raise the reference's messages (the cases of
  ``tests/test_serving.py``), and a mesh serve session needs the ranks'
  process group;
* ``launch/serve.py``: the world size from the flags (``--pp`` alone
  stacks the stages on one rank, with or without ``--backend``), NCCL
  refused for ranks sharing a device, a slot count the pods x data axes
  do not divide refused with the spec's message, all without a spawn.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.api import session as jsession  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.generators import SchedParams as JSP  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import llama3p2_1b as tllama  # noqa: E402
from repro_torch.core import serve as CS  # noqa: E402
from repro_torch.core.comm import MeshShape  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    Runtime,
    make_serve_step,
    serve_tiling,
)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.common import ShapeConfig  # noqa: E402
from repro_torch.params import init_all_params  # noqa: E402

FIELDS = ("kind", "mb", "v", "gather_v", "gather_slot", "use_slot",
          "reduce_v", "recv_f_u", "recv_b_u")
SLOTS, MAX_SEQ, PAGE = 4, 32, 4


@pytest.mark.parametrize("pp,vpp,prefetch",
                         [(p, v, f) for p in (1, 2) for v in (1, 2)
                          for f in (0, 1)])
def test_serve_table_equals_the_reference_fwd_only(pp, vpp, prefetch):
    cfg, rc = tllama.reduced()
    rc = dataclasses.replace(rc, pp=pp, vpp=vpp, microbatches=4, unit=2,
                             gather_prefetch=prefetch)
    rt = Runtime(cfg, rc, "cpu", MeshShape(1, pp, 1))
    assert "serve_main" not in rt.plans       # built when a serve step asks
    got = rt.serve_plan().packed
    assert rt.plans["serve_main"].packed is got
    want = jplan.SchedulePlan.build(
        "fwd_only", JSP(P=pp, V=vpp, n_mb=4, unit=4),
        prefetch=prefetch).packed
    assert (got.T, got.Pe, got.V, got.U, got.n_mb, got.prefetch) == \
        (want.T, want.Pe, want.V, want.U, want.n_mb, want.prefetch)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.reduce_v < 0).all() and set(np.unique(got.kind)) <= {0, 1}


def test_serve_tiling_equals_the_reference():
    cfg, rc = tllama.reduced()
    n = 0
    for gb in (1, 2, 3, 4, 6, 8, 12, 16):
        for pods, data, G, mb in [(1, 1, 1, 1), (1, 2, 1, 2), (1, 2, 2, 2),
                                  (2, 2, 1, 1), (1, 1, 2, 4), (2, 1, 2, 3),
                                  (1, 4, 1, 2)]:
            shards = pods * data
            if gb % shards or gb < shards:
                continue
            rt = Runtime(cfg, dataclasses.replace(
                rc, pp=1, groups=G, microbatches=mb), "cpu",
                MeshShape(data, 1, G, pods))
            ref = types.SimpleNamespace(
                pods=pods, dsize=data, multi_pod=pods > 1, G=G,
                rc=types.SimpleNamespace(microbatches=mb))
            assert serve_tiling(rt, gb) == jpipeline.serve_tiling(
                ref, gb, seq_shard=False), (gb, pods, data, G, mb)
            n += 1
    assert n > 30


def _batch(paged):
    rng = np.random.RandomState(0)
    b = {"tokens": rng.randint(0, 256, (SLOTS, 4)).astype(np.int32),
         "pos": np.array([0, 4, 0, 9], np.int32),
         "slot_mask": np.array([True, True, False, True])}
    if paged:
        b["page_tables"] = np.arange(SLOTS * MAX_SEQ // PAGE,
                                     dtype=np.int32).reshape(SLOTS, -1)
    return b


def _both(mb, vpp, paged):
    """(serve_step's and the tick engine's) tokens, logits and caches on
    the same params and batch at one rank."""
    cfg, rc = tllama.reduced()
    rc = dataclasses.replace(rc, pp=1, vpp=vpp, microbatches=mb)
    rt = Runtime(cfg, rc, "cpu")
    params = init_all_params(cfg, rc, torch.Generator().manual_seed(0),
                             "cpu")
    ps = PAGE if paged else 0
    kw = dict(page_size=ps, n_pages=SLOTS * MAX_SEQ // PAGE) if paged \
        else {}
    rope = CS.rope_for(cfg, MAX_SEQ, "cpu")
    batch = _batch(paged)
    c1 = CS.init_serve_caches(cfg, rc, rt.geo, slots=SLOTS, max_seq=MAX_SEQ,
                              device="cpu", **kw)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    t1, l1, c1 = CS.serve_step(cfg, rc, rt.geo, params, c1, tb, rope=rope,
                               page_size=ps, want_logits=True)
    c2 = CS.init_serve_caches(cfg, rc, rt.geo, slots=SLOTS, max_seq=MAX_SEQ,
                              device="cpu", stages=vpp, **kw)
    step = make_serve_step(rt, ShapeConfig("serve", MAX_SEQ, SLOTS,
                                           "decode"),
                           prompt_len=4, max_seq=MAX_SEQ, page_size=ps,
                           want_logits=True, rope=rope)
    t2, l2, c2 = step(params, c2, batch)
    return (t1, l1, c1), (t2, l2, c2)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("vpp", [1, 2, 4])
def test_tick_engine_serve_body_equals_serve_step(paged, vpp):
    (t1, l1, c1), (t2, l2, c2) = _both(1, vpp, paged)
    assert t2.dtype == torch.int32 and l2.dtype == torch.float32
    assert torch.equal(t1, t2) and torch.equal(l1, l2)
    assert set(c1["main"]) == set(c2["main"])
    for k in c1["main"]:
        assert torch.equal(c1["main"][k], c2["main"][k]), k


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_tick_engine_serve_body_two_micro_batches(paged):
    (t1, l1, c1), (t2, l2, c2) = _both(2, 2, paged)
    assert torch.equal(t1, t2)
    assert float((l1 - l2).abs().max()) <= 1e-6 * float(l1.abs().max())
    for k in c1["main"]:
        assert torch.equal(c1["main"][k], c2["main"][k]), k


def test_degenerate_tiling_serves_the_one_micro_batch_tokens():
    """Two slot rows and four micro-batches (Btot 2 of 4): the port's
    tokens equal its one-micro-batch step's and the reference's at one
    micro-batch; the reference's own four-micro-batch step overwrites
    row 0's token with row 1's."""
    cfg, rc = tllama.reduced()
    batch = {"tokens": np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32),
             "pos": np.zeros(2, np.int32), "slot_mask": np.ones(2, bool)}
    js = jsession("llama3.2-1b", mode="serve", data=1, max_slots=2,
                  max_seq=16, overrides=dict(pp=1, microbatches=1))
    import jax
    jp = js.init_params(jax.random.PRNGKey(0))
    want = np.asarray(js.serve_step_batched(jp, js.init_caches(), batch)[0])
    from repro_torch.params import from_reference
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    got = []
    for mb in (1, 4):
        rc2 = dataclasses.replace(rc, pp=1, vpp=1, microbatches=mb)
        rt = Runtime(cfg, rc2, "cpu")
        caches = CS.init_serve_caches(cfg, rc2, rt.geo, slots=2, max_seq=16,
                                      device="cpu", stages=1)
        step = make_serve_step(rt, ShapeConfig("serve", 16, 2, "decode"),
                               prompt_len=4, max_seq=16)
        got.append(step(tp, caches, batch)[0].numpy())
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)
    js4 = jsession("llama3.2-1b", mode="serve", data=1, max_slots=2,
                   max_seq=16, overrides=dict(pp=1, microbatches=4))
    ref4 = np.asarray(js4.serve_step_batched(jp, js4.init_caches(),
                                             batch)[0])
    assert ref4[0] == ref4[1] == want[1] != want[0]


SPEC_CASES = [
    dict(mode="serve", max_seq=16, max_slots=3, data=2),
    dict(mode="serve", max_seq=16, max_slots=4, page_size=4, max_pages=7,
         data=2),
    dict(mode="serve", max_seq=16, max_slots=4, page_size=4, max_pages=10,
         data=2, overrides=dict(groups=2)),
    dict(mode="serve", max_seq=16, max_slots=2, page_size=4,
         overrides=dict(groups=4)),
    dict(mode="serve", max_seq=16, max_slots=6, pods=2, data=2),
]


@pytest.mark.parametrize("kw", SPEC_CASES)
def test_spec_serve_checks_raise_the_reference_messages(kw):
    with pytest.raises(Exception) as want:
        jsession("llama3.2-1b", **kw)
    with pytest.raises(SessionError) as got:
        tsession("llama3.2-1b", device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_mesh_serve_session_needs_a_process_group():
    for kw in (dict(data=2), dict(pods=2), dict(overrides=dict(groups=2)),
               dict(data=2, max_slots=4, page_size=4,
                    overrides=dict(groups=2))):
        with pytest.raises(SessionError, match="process group"):
            tsession("llama3.2-1b", mode="serve", device="cpu", max_seq=16,
                     **kw)
    # pp alone walks the stages on one rank, as before
    one = tsession("llama3.2-1b", mode="serve", device="cpu", max_seq=16,
                   overrides=dict(pp=2))
    assert one.mesh is None


def test_launch_serve_flags_without_a_spawn():
    w = tserve._world
    assert w(tserve._args(["--data", "2", "--pp", "2"])) == 4
    assert w(tserve._args(["--pods", "2", "--data", "2",
                           "--groups", "2"])) == 8
    assert w(tserve._args(["--pp", "2"])) == 1        # one rank, stacked
    assert w(tserve._args(["--pp", "2", "--backend", "gloo"])) == 1
    with pytest.raises(SystemExit, match="--pp alone stacks"):
        tserve.main(["--device", "cpu", "--pp", "2", "--backend", "gloo"])
    with pytest.raises(SystemExit, match="--backend gloo"):
        tserve.main(["--device", "cpu", "--backend", "nccl", "--data",
                     "2", "--pp", "2"])
    with pytest.raises(SystemExit, match="need --backend"):
        tserve.main(["--device", "cpu", "--data", "2"])
    with pytest.raises(Exception) as want:
        jsession("llama3.2-1b", mode="serve", max_seq=1, max_slots=3,
                 data=2)
    with pytest.raises(SystemExit) as got:
        tserve.main(["--device", "cpu", "--backend", "gloo", "--data", "2",
                     "--slots", "3"])
    assert str(got.value) == str(want.value)
    with pytest.raises(SystemExit, match="needs --page-size"):
        tserve._args(["--layouts", "contiguous,paged"])
    assert tserve._args(["--layouts", "contiguous,paged", "--page-size",
                         "16"]).layouts == ["contiguous", "paged"]
