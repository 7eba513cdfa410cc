"""repro_torch's checkpoints and fault-tolerance controller against the
JAX package, on the CPU.

* the format: one tree (a float32, a bfloat16 and a 0-d int32 leaf)
  saved by both packages gives byte-identical ``.npy`` files and equal
  manifests (but for ``time``); the port reads the reference's bfloat16
  leaf bit for bit (the reference cannot);
* the manager, mirroring the reference's tests (``tests/test_substrates.py``,
  ``tests/test_fault_tolerance.py``): keep-k GC, async save and
  ``wait``, ``verify``, and ``restore_latest`` falling back past a
  truncated leaf and a missing manifest;
* across packages, reduced gpt_paper (float32; pp 1, vpp 2, zeropp, four
  micro-batches in units of two, seq 16): the JAX session trains two
  steps and saves ``{"params", "opt"}`` with the reference's manager, the
  port restores it and takes step 3; then the port trains and saves, and
  the reference's ``TrainController.restore_latest`` + ``adopt_params``
  restore it for its step 3. The restored state equals the saved one bit
  for bit; step 3's loss agrees within 1e-5 relative and every gradient
  within 1e-4 of max |ref|, as ``tests/test_torch_gpt.py`` holds the
  step;
* the controller on reduced llama3.2-1b: a run with a failure injected
  at step 3 (checkpoints every 2 steps, saved asynchronously) equals an
  uninterrupted run bit for bit, with the reference controller's
  ``resume_steps``; ``max_failures`` re-raises; the failure path waits
  for the async save; ``describe()["fault_tolerance"]``;
* the entry points: ``launch/train.py --ckpt-dir --inject-failure-at``
  and ``launch/serve.py --ckpt`` (the same greedy streams as serving the
  trained params passed in directly).
"""

import ast
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.api import session as jsession  # noqa: E402
from repro.ckpt.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.runtime.fault_tolerance import (  # noqa: E402
    FaultToleranceConfig as JFTConfig,
)
from repro.runtime.fault_tolerance import (  # noqa: E402
    TrainController as JController,
)
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.ckpt.checkpoint import (  # noqa: E402
    CheckpointManager,
    flatten,
)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FaultToleranceConfig,
    TrainController,
)

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
GPT_OV = dict(pp=1, vpp=2, schedule="zeropp", microbatches=4, unit=2)
OPTIM = dict(lr=1e-2)
K = 2     # steps before the checkpoint


def _step_dir(d, step):
    return os.path.join(str(d), f"step_{step:09d}")


def _manifest(d, step):
    with open(os.path.join(_step_dir(d, step), "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


# --------------------------------------------------------------------------- #
# The format
# --------------------------------------------------------------------------- #


def test_leaf_files_are_byte_identical_to_the_reference(tmp_path):
    rng = np.random.RandomState(0)
    a = rng.randn(3, 5).astype(np.float32)
    b = (rng.randn(4, 6) * 3).astype(np.float32)
    jtree = {"a": jnp.asarray(a), "b": {"c": jnp.asarray(b, jnp.bfloat16)},
             "step": jnp.asarray(7, jnp.int32)}
    ttree = {"a": torch.from_numpy(a),
             "b": {"c": torch.from_numpy(b).to(torch.bfloat16)}, "step": 7}
    JManager(str(tmp_path / "j")).save(5, jtree, extra={"step": 5})
    CheckpointManager(str(tmp_path / "t")).save(5, ttree, extra={"step": 5})
    jm, tm = _manifest(tmp_path / "j", 5), _manifest(tmp_path / "t", 5)
    assert tm == jm
    assert jm["dtypes"] == {"a": "float32", "b/c": "bfloat16",
                            "step": "int32"}
    files = sorted(os.listdir(_step_dir(tmp_path / "j", 5)))
    assert files == sorted(os.listdir(_step_dir(tmp_path / "t", 5)))
    assert files == ["a.npy", "b__c.npy", "manifest.json", "step.npy"]
    for fn in files[:-2] + files[-1:]:
        with open(os.path.join(_step_dir(tmp_path / "j", 5), fn), "rb") as f:
            want = f.read()
        with open(os.path.join(_step_dir(tmp_path / "t", 5), fn), "rb") as f:
            assert f.read() == want, fn


def test_port_reads_the_references_bf16_leaf_bit_for_bit(tmp_path):
    b = (np.random.RandomState(1).randn(7, 3) * 5).astype(np.float32)
    jb = jnp.asarray(b, jnp.bfloat16)
    JManager(str(tmp_path)).save(1, {"w": jb, "step": jnp.asarray(
        3, jnp.int32)})
    with open(os.path.join(_step_dir(tmp_path, 1), "w.npy"), "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    got, manifest = CheckpointManager(str(tmp_path)).restore(1)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  np.asarray(jb).view(np.int16))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 3
    assert manifest["dtypes"]["w"] == "bfloat16"


# --------------------------------------------------------------------------- #
# The manager (mirrors the reference's tests)
# --------------------------------------------------------------------------- #


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (10, 20, 30):
        mgr.save(step, {"a": tree["a"] + step, "b": {"c": tree["b"]["c"]
                                                      + step}})
    assert mgr.list_steps() == [20, 30]  # keep-2 GC
    got, manifest = mgr.restore(30)
    np.testing.assert_allclose(got["a"].numpy(), tree["a"].numpy() + 30)
    assert manifest["step"] == 30
    assert mgr.verify(30)


def test_checkpoint_async_and_corruption_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.ones((8, 8))}
    mgr.save(1, tree, blocking=False)
    tree["w"] += 1     # the snapshot is the host's own copy
    mgr.save(2, tree, blocking=False)
    mgr.wait()
    assert set(mgr.list_steps()) == {1, 2}
    with open(os.path.join(_step_dir(tmp_path, 2), "w.npy"), "wb") as f:
        f.write(b"garbage")
    ctl = TrainController(str(tmp_path), FaultToleranceConfig())
    tree2, manifest = ctl.restore_latest()
    assert manifest["step"] == 1  # fell back past the corrupt step
    assert torch.equal(tree2["w"], torch.ones((8, 8)))


def test_restore_latest_falls_back_through_corruption_chain(tmp_path):
    ctl = TrainController(str(tmp_path), FaultToleranceConfig(keep=3))
    w = torch.arange(16.0).reshape(4, 4)
    for step in (2, 4, 6):
        ctl.mgr.save(step, {"w": w + step}, extra={"step": step})
    with open(os.path.join(_step_dir(tmp_path, 6), "w.npy"), "wb") as f:
        f.write(b"\x93NUMPY")
    os.remove(os.path.join(_step_dir(tmp_path, 4), "manifest.json"))
    got, manifest = ctl.restore_latest()
    assert manifest["extra"]["step"] == 2
    assert torch.equal(got["w"], w + 2)
    os.remove(os.path.join(_step_dir(tmp_path, 2), "manifest.json"))
    assert ctl.restore_latest() == (None, None)


# --------------------------------------------------------------------------- #
# Across packages: reduced gpt_paper
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def gpt():
    """The JAX session, its state after K steps and its step K + 1."""
    js = jsession("gpt_paper", mode="train", seq_len=16, data=1,
                  overrides=GPT_OV, optim=OPTIM)
    jp = js.init_params(jax.random.PRNGKey(0))
    p0 = jax.tree.map(np.asarray, jp)    # opt_step donates jp's buffers
    jo = js.init_opt_state(jp)
    stream = js.stream(seed=5)
    for k in range(K):
        g, _ = js.train_step(jp, stream.batch(k))
        jp, jo, _ = js.opt_step(jp, g, jo)
    jg, jm = js.train_step(jp, stream.batch(K))
    ts = tsession("gpt_paper", mode="train", seq_len=16, device="cpu",
                  overrides=GPT_OV, optim=OPTIM)
    return dict(js=js, p0=p0, jp=jp, jo=jo,
                jg=jax.tree.map(np.asarray, jg), jloss=float(jm["loss_sum"]),
                stream=stream, ts=ts)


def _close_step(tg, tloss, jg, jloss):
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss)
    jflat, tflat = flatten(jg), flatten(tg)
    assert set(jflat) == set(tflat)
    for k, w in jflat.items():
        w = np.asarray(w)
        err = float(np.abs(tflat[k].numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), k


def _equal_bits(t, a):
    a = np.asarray(a)
    assert tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.numpy(), a.astype(np.float32))


def test_jax_checkpoint_restores_in_the_port(gpt, tmp_path):
    JManager(str(tmp_path)).save(K, {"params": gpt["jp"], "opt": gpt["jo"]},
                                 extra={"step": K})
    ts = gpt["ts"]
    ctl = ts.checkpointing(str(tmp_path))
    tree, manifest = ctl.restore_latest()
    assert manifest["extra"] == {"step": K}
    st = ts.adopt_state(tree)
    assert st["opt"]["step"] == K == int(gpt["jo"]["step"])
    for name, want in (("params", gpt["jp"]),
                       ("master", gpt["jo"]["master"]),
                       ("m", gpt["jo"]["m"]), ("v", gpt["jo"]["v"])):
        got = st["params"] if name == "params" else st["opt"][name]
        wf = flatten(jax.tree.map(np.asarray, want))
        for k, t in flatten(got).items():
            _equal_bits(t, wf[k])
    tg, tm = ts.train_step(st["params"], gpt["stream"].batch(K))
    _close_step(tg, float(tm["loss_sum"]), gpt["jg"], gpt["jloss"])


def test_port_checkpoint_restores_in_the_reference(gpt, tmp_path):
    ts, js = gpt["ts"], gpt["js"]
    stream = gpt["stream"]
    ctl = ts.checkpointing(str(tmp_path), every=K, async_save=False)

    def build(restored, manifest):
        p = tparams.from_reference(gpt["p0"], device="cpu")

        def run_one(st, step):
            g, _ = ts.train_step(st["params"], stream.batch(step))
            p, o, _ = ts.opt_step(st["params"], g, st["opt"])
            return {"params": p, "opt": o}, {}

        return {"params": p, "opt": ts.init_opt_state(p)}, run_one, \
            lambda s: s

    state, _ = ctl.run(build, K)
    jctl = JController(str(tmp_path), JFTConfig())
    tree, manifest = jctl.restore_latest()
    assert manifest["extra"] == {"step": K}
    jp = js.adopt_params(tree["params"])
    jo = jax.tree.map(jnp.asarray, tree["opt"])
    assert int(jo["step"]) == K
    for k, t in flatten(state["params"]).items():
        _equal_bits(t, flatten(jax.tree.map(np.asarray, jp))[k])
    for k, t in flatten(state["opt"]["m"]).items():
        _equal_bits(t, flatten(jax.tree.map(np.asarray, jo["m"]))[k])
    jg, jm = js.train_step(jp, stream.batch(K))
    tg, tm = ts.train_step(state["params"], stream.batch(K))
    _close_step(tg, float(tm["loss_sum"]), jax.tree.map(np.asarray, jg),
                float(jm["loss_sum"]))


# --------------------------------------------------------------------------- #
# The controller
# --------------------------------------------------------------------------- #


def _train_build(sess, log):
    def build(restored, manifest):
        if restored is None:
            p = sess.init_params(torch.Generator().manual_seed(0))
            st = {"params": p, "opt": sess.init_opt_state(p)}
        else:
            st = sess.adopt_state(restored)
        stream = sess.stream(seed=2)

        def run_one(st, step):
            g, m = sess.train_step(st["params"], stream.batch(step))
            p, o, om = sess.opt_step(st["params"], g, st["opt"])
            log.append((step, float(m["loss_sum"]), float(om["grad_norm"])))
            return {"params": p, "opt": o}, {"loss": log[-1][1]}

        return st, run_one, lambda s: s

    return build


@pytest.fixture(scope="module")
def restarted(tmp_path_factory):
    """Reduced llama3.2-1b, 4 steps, checkpoints every 2 (async), a
    failure injected at step 3; and the same 4 steps uninterrupted."""
    d = str(tmp_path_factory.mktemp("restart"))
    sess = tsession("llama3.2-1b", mode="train", seq_len=16, device="cpu",
                    optim=dict(lr=1e-2, warmup=1, total=100))
    log = []
    ctl = sess.checkpointing(d, every=2, digest=True)
    state, hist = ctl.run(_train_build(sess, log), 4, inject_failure_at=3)
    plain_log = []
    plain, run_one, _ = _train_build(sess, plain_log)(None, None)
    for step in range(4):
        plain, _ = run_one(plain, step)
    return dict(dir=d, sess=sess, ctl=ctl, state=state, hist=hist, log=log,
                plain=plain, plain_log=plain_log)


def test_injected_failure_equals_uninterrupted_run(restarted):
    r = restarted
    ctl = r["ctl"]
    assert ctl.failures == 1 and ctl.resume_steps == [2]
    # the reference's controller, same schedule of saves and failure
    jctl = JController(os.path.join(r["dir"], "ref"), JFTConfig(
        ckpt_every=2, async_save=True))

    def jbuild(restored, manifest):
        x = jnp.asarray(restored["x"]) if restored else jnp.zeros(())
        return {"x": x}, lambda s, step: ({"x": s["x"] + 1}, {}), \
            lambda s: s

    jctl.run(jbuild, 4, inject_failure_at=3)
    assert jctl.resume_steps == ctl.resume_steps
    # steps 0, 1, 2, then step 2 again after the restart, then 3
    assert [s for s, _, _ in r["log"]] == [0, 1, 2, 2, 3]
    assert r["log"][2] == r["log"][3]
    assert r["log"][:3] + r["log"][4:] == r["plain_log"]
    assert r["state"]["opt"]["step"] == r["plain"]["opt"]["step"] == 4
    for k, t in flatten(r["state"]).items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, flatten(r["plain"])[k]), k
    # the restore read back what the save of step 2 wrote
    ev = {(e["op"], e["step"]): e for e in ctl.mgr.events}
    assert ev[("restore", 2)]["sha256"] == ev[("save", 2)]["sha256"]
    assert ev[("save", 2)]["bytes"] == ev[("restore", 2)]["bytes"] > 0
    assert sorted(ev) == [("restore", 2), ("save", 2), ("save", 4)]


def _counting_build(calls, fail_steps=(), fail_once=False):
    armed = set(fail_steps)

    def build(restored, manifest):
        calls["builds"] += 1
        state = {"x": restored["x"] if restored else torch.zeros(())}

        def run_one(state, step):
            if step in armed:
                if fail_once:
                    armed.discard(step)
                raise RuntimeError(f"boom at {step}")
            return {"x": state["x"] + 1.0}, {"x": float(state["x"])}

        return state, run_one, lambda s: s

    return build


def test_max_failures_exhaustion_reraises(tmp_path):
    ctl = TrainController(str(tmp_path), FaultToleranceConfig(
        ckpt_every=2, max_failures=3, async_save=False))
    calls = {"builds": 0}
    with pytest.raises(RuntimeError, match="boom at 3"):
        ctl.run(_counting_build(calls, fail_steps={3}), total_steps=6)
    assert ctl.failures == 3
    assert calls["builds"] == 3
    assert ctl.resume_steps == [2, 2]
    assert ctl.summary()["resume_steps"] == [2, 2]


def test_failure_path_waits_for_async_saves(tmp_path):
    ctl = TrainController(str(tmp_path), FaultToleranceConfig(
        ckpt_every=1, max_failures=3, async_save=True))
    calls = {"builds": 0}
    state, hist = ctl.run(_counting_build(calls, fail_steps={4},
                                          fail_once=True), total_steps=6)
    assert calls["builds"] == 2 and ctl.failures == 1
    assert ctl.resume_steps == [4]
    assert [s for s, _ in hist] == [0, 1, 2, 3, 4, 5]
    assert float(state["x"]) == 6.0


def test_describe_shows_the_attached_controller(restarted, tmp_path):
    sess = tsession("llama3.2-1b", mode="train", device="cpu")
    assert "fault_tolerance" not in sess.describe()
    ctl = sess.checkpointing(str(tmp_path), every=5, max_failures=2)
    assert ctl.attach(sess) is ctl
    ft = sess.describe()["fault_tolerance"]
    assert ft["failures"] == 0 and ft["max_failures"] == 2
    assert ft["ckpt_every"] == 5 and ft["ckpt_steps"] == []
    ft = restarted["ctl"].attach(sess).summary()
    assert ft["resume_steps"] == [2] and ft["ckpt_steps"] == [2, 4]


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #


def test_launch_train_with_injected_failure_prints_train_ok(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.main(["--device", "cpu", "--steps", "4", "--seq", "16",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                      "--inject-failure-at", "3", "--report",
                      str(tmp_path / "report.json")])
    text = out.getvalue()
    assert "TRAIN_OK steps=5" in text, text
    assert "failures=1 resume_steps=[2] straggler_flags=" in text, text
    assert "resumed at step 2" in text, text
    with open(tmp_path / "report.json") as f:
        rep = json.load(f)
    assert rep["fault_tolerance"]["resume_steps"] == [2]
    ops = [(e["op"], e["step"]) for e in rep["ckpt_events"]]
    assert ops == [("save", 2), ("restore", 2), ("save", 4)]
    assert all(e["bytes"] > 0 for e in rep["ckpt_events"])


def _streams(text):
    out = []
    for line in text.splitlines():
        if line.strip().startswith("req"):
            out.append(ast.literal_eval(line[line.index("["):]))
    return out


def test_launch_serve_from_a_train_checkpoint(restarted):
    """The controller's last checkpoint of reduced llama (trained at pp 1)
    served with ``--pp 1``: the same greedy streams as an engine over
    the trained params passed in directly."""
    argv = ["--device", "cpu", "--slots", "2", "--n-requests", "3",
            "--prompt", "6", "--gen", "4", "--pp", "1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(argv + ["--ckpt", restarted["dir"]])
    text = out.getvalue()
    assert "params restored from train checkpoint" in text and \
        "SERVE_OK" in text, text
    got = _streams(text)
    work = tserve.synth_requests(3, 6, 4, restarted["sess"].cfg.vocab)
    need = max(len(t) + g for t, g, _ in work) + 1
    sess = tsession("llama3.2-1b", device="cpu", max_slots=2, max_seq=need,
                    overrides=dict(pp=1))
    with sess.serve_engine(restarted["state"]["params"]) as eng:
        hs = [eng.submit(t, max_gen=g, stop=s) for t, g, s in work]
        want = [list(h.result(timeout=60)) for h in hs]
    assert got == want and len(want) == 3
