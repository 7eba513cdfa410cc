"""whisper-large-v3 in the port: the encoder-decoder against the JAX
package on the same inputs.

* the configs field for field (the published one and the reduced one),
  the two segments' geometry and ParamSpecs, the parameter counts;
* the stream's ``enc_tokens`` (the audio stub's frames) equal to the
  reference's ``SyntheticStream`` with ``np.array_equal``;
* one ``enc`` and one ``dec`` layer on the tape in mode ``bwd`` against
  the reference's ``apply_layer`` on the reference tape: y, the input
  cotangent, the memory's cotangent (the decoder's cross-attention reads
  the memory through two dense nodes), the immediate grads and the W
  stash's;
* ``reference_logits`` / ``reference_loss`` with ``enc_tokens``;
* one train step at pp 1 (V = 2 a segment: the encoder forward walk, the
  decoder's zeropp table, the encoder's stripped backward) against
  ``jax.value_and_grad(reference_loss)``: the loss and every leaf's
  gradient, ``embed.table``, ``head.w`` and both segments';
* a prefill and decode steps with a given ``enc_memory`` against the
  reference Session's serve steps (its ``make_serve_step`` at one
  device), the same steps through the port's tick-engine serve body at
  one rank, and the greedy stream against ``reference_logits`` re-run
  over the growing sequence;
* ``schedule="auto"`` selecting as the reference Session does;
* a slot reset zeroing the slot's rows of the memory;
* the train CLI on the reduced config;
* the refusals: paged caches, the engine (and the serve CLI through it),
  serving on a mesh, more than one pipeline group.

Params come from ``repro.models.model.init_all_params`` and cross in one
process (``params.from_reference``); inputs are numpy arrays from a seed.
Tolerances, all float32: the layers within 1e-5 of the largest
|reference| of each tensor; the loss within 1e-5 relative and every
gradient within 1e-4 of its largest |reference| (the other slices'
rule); logits within 1e-4 absolute (the serve rule of the other slices'
tests); the greedy streams exactly. The reduced config's head_dim 16 runs
the plain versions only; ``tests/test_torch_cuda.py`` holds the kernels
at whisper's shapes on a GPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, leaving the cores to the other test
# workers
torch.set_num_threads(1)

from repro.api import get_arch as jget_arch  # noqa: E402
from repro.api import session as jsession  # noqa: E402
from repro.core import tape as jtape  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticStream as JStream  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.common import rope_tables as jrope  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import whisper_large_v3 as twhisper  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.comm import MeshShape  # noqa: E402
from repro_torch.core import tape as ttape  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.common import ShapeConfig  # noqa: E402

ARCH = "whisper-large-v3"
RTOL = 1e-5
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
ATOL = 1e-4
SERVE = dict(max_slots=2, max_seq=16, overrides=dict(pp=1, microbatches=1))


def _fields(x):
    return dataclasses.asdict(x)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def test_configs_geometry_and_specs_equal_reference():
    """config() and reduced() field for field; both segments' geometry
    (the encoder not causal, one layer a stage, V = layers / pp) and
    ParamSpecs at pp 1 and 2; the io specs; the docstring's counts."""
    jmod = jget_arch(ARCH)
    assert _fields(twhisper.config()) == _fields(jmod.config())
    (jc, jr), (tc, tr) = jmod.reduced(), twhisper.reduced()
    assert _fields(tc) == _fields(jc) and _fields(tr) == _fields(jr)
    assert twhisper.one_card_config() == twhisper.config()
    assert twhisper.one_card_train_config() == twhisper.config()
    for full in (True, False):
        jcfg = jmod.config() if full else jc
        tcfg = twhisper.config() if full else tc
        for pp in (1, 2):
            jgeo = jmodel.build_geometry(jcfg, dataclasses.replace(jr, pp=pp))
            tgeo = tmodel.build_geometry(tcfg, dataclasses.replace(tr, pp=pp))
            assert [s.name for s in tgeo.segments] == ["enc", "dec"]
            for js, ts in zip(jgeo.segments, tgeo.segments, strict=True):
                assert _fields(ts) == _fields(js)
                assert tgeo.seg_stages(ts) == jgeo.seg_stages(js)
                assert {n: _fields(x) for n, x in tmodel.stage_specs(
                    tcfg, ts).items()} == {
                        n: _fields(x) for n, x in jmodel.stage_specs(
                            jcfg, js).items()}
        assert {n: _fields(x) for n, x in tmodel.io_specs(tcfg).items()} \
            == {n: _fields(x) for n, x in jmodel.io_specs(jcfg).items()}
    cfg = twhisper.config()
    geo = tmodel.build_geometry(cfg, twhisper.one_card_train_run())
    assert not geo.segments[0].causal and geo.segments[1].causal
    count = {s.name: sum(int(np.prod(x.shape)) for x in tmodel.stage_specs(
        cfg, s).values()) for s in geo.segments}
    io = sum(int(np.prod(x.shape)) for x in tmodel.io_specs(cfg).values())
    total = io + 32 * (count["enc"] + count["dec"])
    assert (count["enc"], count["dec"], io, total) == (
        19_665_920, 26_222_080, 132_779_520, 1_601_195_520)
    for n in (count["enc"], count["dec"], io, total):
        assert f"{n:,}" in twhisper.__doc__ + twhisper.one_card_config.__doc__
    assert cfg.vocab % 8 == 2     # head.w's rows: 4-byte aligned only


def test_stream_enc_tokens_equal_reference():
    """The session's stream and the reference's ``SyntheticStream`` of
    the same ``enc_dec`` config, two steps: tokens, labels and the frames
    equal bit for bit."""
    ts = tsession(ARCH, mode="train", seq_len=8, device="cpu",
                  overrides=dict(microbatches=2))
    jst = JStream(JDataConfig(seq_len=8, global_batch=2, vocab=256, seed=4,
                              kind="enc_dec", d_model=64, enc_ctx=16))
    for step in (0, 1):
        got, want = ts.stream(seed=4).batch(step), jst.batch(step)
        assert set(got) == set(want) == {"tokens", "labels", "enc_tokens"}
        assert got["enc_tokens"].shape == (2, 16, 64)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    d = ts.describe()["geometry"]
    assert (d["kind"], d["enc_ctx"]) == ("enc_dec", 16)


def _layer_params(kind: str, seed: int = 1) -> dict:
    cfg, rc = jget_arch(ARCH).reduced()
    jp = jmodel.init_all_params(cfg, dataclasses.replace(rc, pp=1),
                                jax.random.PRNGKey(seed))
    out = {n: np.asarray(a[0]) for n, a in jp["segments"][kind].items()}
    rng = np.random.RandomState(seed)
    for n in out:    # LayerNorm biases and scales away from 0 and 1
        if n.endswith((".bias", ".scale")):
            out[n] = out[n] + (0.3 * rng.randn(*out[n].shape)).astype(
                np.float32)
    return out


def _layer(tape, blocks, model, ctx, kind, x, mem, dy, dw_of):
    xv = tape.value(x)
    mv = tape.value(mem) if mem is not None else None
    ctx.enc_memory = mv
    y, _ = model.apply_layer(tape, ctx, kind, "L0", xv, 1.0)
    cot, ig, ws = tape.backward({y.idx: dy})
    dmem = cot.get(mv.idx) if mv is not None else None
    return y.val, cot[xv.idx], dmem, ig, dw_of(ws)


@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_tape_layers_equal_reference(kind):
    """One layer in mode bwd, float32: y, dx, the memory's cotangent
    (dec), the immediate grads (the LayerNorms') and every dense node's
    dW."""
    cfg, rc = jget_arch(ARCH).reduced()
    rc = dataclasses.replace(rc, pp=1)
    params = _layer_params(kind)
    rng = np.random.RandomState(3)
    s = 11 if kind == "dec" else 16
    x = rng.randn(2, s, 64).astype(np.float32)
    dy = rng.randn(2, s, 64).astype(np.float32)
    mem = rng.randn(2, 16, 64).astype(np.float32) if kind == "dec" else None
    causal = kind == "dec"

    def jfn(p, xx, mm, yy):
        ctx = jblocks.LayerCtx(cfg=cfg, rc=rc, rope={16: jrope(s, 16, 1e4)},
                               causal=causal)
        return _layer(jtape.Tape(p, mode="bwd"), jblocks, jmodel, ctx, kind,
                      xx, mm, yy, jtape.compute_dw)

    want = jax.jit(jfn)(params, x, mem, dy)
    tcfg, trc = twhisper.reduced()
    trc = dataclasses.replace(trc, pp=1)
    ctx = tblocks.LayerCtx(cfg=tcfg, rc=trc, rope=tmodel.rope_for(tcfg, s),
                           causal=causal)
    got = _layer(ttape.Tape({k: _t(v) for k, v in params.items()},
                            mode="bwd"), tblocks, tmodel, ctx, kind, _t(x),
                 _t(mem) if mem is not None else None, _t(dy),
                 ttape.compute_dw)
    (jy, jdx, jdm, jig, jdw), (ty, tdx, tdm, tig, tdw) = want, got
    assert _rel(ty, jy) <= RTOL and _rel(tdx, jdx) <= RTOL
    if kind == "dec":
        assert float(np.abs(jdm).max()) > 0
        assert _rel(tdm, jdm) <= RTOL
    else:
        assert tdm is None and jdm is None
    norms = ("ln1", "ln2") + (("ln3",) if kind == "dec" else ())
    assert set(tig) == set(jig) == {f"L0.{n}.{w}" for n in norms
                                    for w in ("scale", "bias")}
    mixes = ("mix",) + (("xattn",) if kind == "dec" else ())
    assert set(tdw) == set(jdw) == (
        {f"L0.{m}.w{w}" for m in mixes for w in "qkvo"}
        | {"L0.ffn.wi", "L0.ffn.wd"})
    for n in jig:
        assert _rel(tig[n], jig[n]) <= RTOL, n
    for n in jdw:
        assert _rel(tdw[n], jdw[n]) <= RTOL, n


def _ref_params(pp: int = 1, seed: int = 0):
    cfg, rc = jget_arch(ARCH).reduced()
    rc = dataclasses.replace(rc, pp=pp)
    jp = jax.tree.map(np.asarray, jmodel.init_all_params(
        cfg, rc, jax.random.PRNGKey(seed)))
    return cfg, rc, jp


def _inputs(b=2, s=8, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(b, s)).astype(np.int32),
            rng.randint(0, 256, size=(b, s)).astype(np.int32),
            (0.1 * rng.randn(b, 16, 64)).astype(np.float32))


def test_reference_logits_and_loss_equal_reference():
    cfg, rc, jp = _ref_params()
    tokens, labels, enc = _inputs()
    jl, _ = jmodel.reference_logits(cfg, rc, jp, tokens, enc_tokens=enc)
    # reference_loss of a dense model: the mean token cross-entropy of
    # these logits (computed here rather than by a second forward)
    lf = np.asarray(jl, np.float64).reshape(-1, jl.shape[-1])
    lse = np.log(np.exp(lf - lf.max(-1, keepdims=True)).sum(-1)) \
        + lf.max(-1)
    jloss = float((lse - lf[np.arange(lf.shape[0]),
                              labels.reshape(-1)]).mean())
    tcfg, trc = twhisper.reduced()
    trc = dataclasses.replace(trc, pp=1)
    tp = tparams.from_reference(jp, device="cpu")
    tl, _ = tmodel.reference_logits(tcfg, trc, tp, _t(tokens).long(), _t(enc))
    tloss = tmodel.reference_loss(tcfg, trc, tp, _t(tokens).long(),
                                  _t(labels).long(), _t(enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    # the memory is the encoder segment's output, which the logits read
    mem = tmodel.encode(tcfg, trc, tp, _t(enc))
    assert tuple(mem.shape) == (2, 16, 64)
    other, _ = tmodel.reference_logits(tcfg, trc, tp, _t(tokens).long(),
                                       _t(enc) * 2)
    assert float((other - tl).abs().max()) > 1e-3


def test_train_step_equals_reference_loss():
    """Reduced whisper at pp 1 (V = 2 a segment), two micro-batches in
    one unit under zeropp: the three walks' loss and every leaf's
    gradient against ``jax.value_and_grad(reference_loss)``."""
    cfg, rc, jp = _ref_params()
    ov = dict(pp=1, microbatches=2, unit=2, schedule="zeropp")
    ts = tsession(ARCH, mode="train", seq_len=8, device="cpu", overrides=ov)
    assert set(ts.rt.tables) == {"enc_fwd", "dec", "enc_bwd"}
    assert ts.rt.plans["enc_bwd"].name == "strip_fwd[zeropp]"
    batch = ts.stream(seed=3).batch(0)
    tokens, labels, enc = (np.asarray(batch[k]) for k in
                           ("tokens", "labels", "enc_tokens"))
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.reference_loss(cfg, rc, p, tokens, labels,
                                        enc_tokens=enc)))(jp)
    tp = tparams.from_reference(jp, device="cpu")
    grads, m = ts.train_step(tp, batch)
    got = float(m["loss_sum"])
    assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want))
    n = 0
    for path, w in _leaves(jax.tree.map(np.asarray, jgrads)):
        g = grads
        for k in path:
            g = g[k]
        assert float(np.abs(w).max()) > 0, path
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))
    assert {p[1] for p, _ in _leaves(grads) if p[0] == "segments"} == {
        "enc", "dec"}
    with pytest.raises(ValueError, match=r"\[2, 16, 64\]"):
        ts.train_step(tp, dict(batch, enc_tokens=enc[:, :8]))


def test_auto_schedule_selects_as_the_reference(monkeypatch, tmp_path):
    """``schedule="auto"`` selects for the decoder segment as the
    reference Session does; the encoder's backward table strips the
    winner's encoder table."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "j.json"))
    ov = dict(pp=1, microbatches=4, unit=2)
    ts = tsession(ARCH, mode="train", seq_len=8, device="cpu",
                  schedule="auto", overrides=ov)
    js = jsession(ARCH, mode="train", seq_len=8, data=1, schedule="auto",
                  overrides=ov)
    name = ts.plan_selection.selected.name
    assert name == js.plan_selection.selected.name
    assert ts.rt.plans["dec"] is ts.plan_selection.selected
    assert ts.rt.plans["enc_bwd"].name == f"strip_fwd[{name}]"


def _memory(cfg, rc, jp, enc):
    """The reference's encoder over the frames (the training encoder,
    as ``tests/spmd_case.py``'s serve case computes the memory)."""
    geo = jmodel.build_geometry(cfg, rc)
    seg = geo.segments[0]
    x = jnp.asarray(enc)
    for s in range(geo.seg_stages(seg)):
        idx = jmodel.storage_index(s % geo.pp, s // geo.pp, seg.vpp)
        t = jtape.Tape({n: a[idx] for n, a in jp["segments"]["enc"].items()},
                       mode="fwd")
        rope, _ = jmodel.make_rope_ctx(cfg, rc, x.shape[1])
        ctx = jblocks.LayerCtx(cfg=cfg, rc=rc, rope=rope, causal=False)
        x = jmodel.apply_stage(t, ctx, seg, t.value(x), s)[0].val
    return np.asarray(x)


def test_serve_prefill_and_decode_equal_reference():
    """A prefill of 6 tokens and 2 greedy decode steps over a given
    memory: the reference Session's tokens and the port's (one rank's
    serve step, and the tick-engine serve body at one rank) equal, the
    memory equal to the port's ``encode``, and the stream equal to the
    greedy continuation of ``reference_logits``."""
    js = jsession(ARCH, mode="serve", data=1, **SERVE)
    ts = tsession(ARCH, device="cpu", **SERVE)
    jp = js.init_params(jax.random.PRNGKey(0))
    hp = jax.tree.map(np.asarray, jp)
    tp = tparams.from_reference(hp, device="cpu")
    tokens, _, enc = _inputs(s=6)
    cfg, rc = js.cfg, js.rc
    mem = _memory(cfg, rc, hp, enc)
    tmem = tmodel.encode(ts.cfg, ts.rc, tp, _t(enc))
    np.testing.assert_allclose(tmem.numpy(), mem, atol=ATOL)
    rt = tpipe.Runtime(ts.cfg, ts.rc, "cpu")
    streams = []
    for step, sess, p, caches in (
            ("ref", js, jp, js.init_caches()),
            ("port", ts, tp, ts.init_caches()),
            ("engine", ts, tp, ts.init_caches())):
        if step == "ref":
            caches["enc_memory"] = jnp.asarray(mem)
        else:
            assert tuple(caches["enc_memory"].shape) == (2, 16, 64)
            caches["enc_memory"].copy_(_t(mem))
        run = sess.serve_prefill
        if step == "engine":
            fns = {}

            def run(p_, c_, b_):
                s = np.shape(b_["tokens"])[1]
                if s not in fns:
                    fns[s] = tpipe.make_serve_step(
                        rt, ShapeConfig("serve", 16, 2, "decode"),
                        prompt_len=s, max_seq=16)
                return fns[s](p_, c_, b_)
        tok, caches = run(p, caches, {"tokens": tokens, "pos": 0})
        out = [np.asarray(tok)]
        for i in range(2):
            tok, caches = run(p, caches, {
                "tokens": np.asarray(out[-1], np.int32)[:, None],
                "pos": 6 + i})
            out.append(np.asarray(tok))
        streams.append(np.stack(out, 1))
    np.testing.assert_array_equal(streams[1], streams[0])
    np.testing.assert_array_equal(streams[2], streams[0])
    seq = tokens
    for i in range(3):
        logits, _ = jmodel.reference_logits(cfg, rc, hp, seq, enc_tokens=enc)
        nxt = np.asarray(jnp.argmax(logits[:, -1].astype(jnp.float32), -1))
        seq = np.concatenate([seq, nxt[:, None].astype(np.int32)], 1)
    np.testing.assert_array_equal(streams[1], seq[:, 6:])


def test_slot_reset_zeroes_the_memory_rows():
    """Reclaiming a slot zeroes its rows of the memory too (the
    reference's ``reset_slot_caches``), and only its rows."""
    ts = tsession(ARCH, device="cpu", **SERVE)
    caches = ts.init_caches()
    for a in [caches["enc_memory"], *caches["dec"].values()]:
        a.fill_(1.0)
    ts.reset_slot_caches(caches, np.array([True, False]))
    for a, ax in [(caches["enc_memory"], 0), *((a, 1) for a in
                                               caches["dec"].values())]:
        assert not a.select(ax, 0).any() and bool((a.select(ax, 1) == 1)
                                                  .all())


def test_train_cli_trains_whisper(capsys):
    """``launch/train.py --arch whisper-large-v3`` trains the reduced
    config: the stream's frames reach the three walks (the plain flash
    attention forward and backward and the plain cross-entropy)."""
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                 "--seq", "8", "--microbatches", "2"])
    out = capsys.readouterr().out
    assert "TRAIN_OK steps=2" in out and "ref_flash_bwd" in out, out
    assert "whisper-smoke" in out, out


def test_refusals(capsys):
    """Paged caches, the engine (and the serve CLI, through the engine's
    own error, before any weights) and a serve session on a mesh."""
    with pytest.raises(SessionError, match="enc_memory has no page layout"):
        tsession(ARCH, device="cpu", max_slots=2, max_seq=16,
                 page_size=4).init_caches()
    ts = tsession(ARCH, device="cpu", **SERVE)
    with pytest.raises(NotImplementedError, match="serve_prefill"):
        ts.serve_engine(None)
    with pytest.raises(SystemExit, match="decoder-only serve path"):
        tserve.main(["--arch", ARCH, "--device", "cpu", "--slots", "2",
                     "--n-requests", "1", "--prompt", "4", "--gen", "2"])
    with pytest.raises(SessionError, match="6g"):
        tsession(ARCH, device="cpu", max_slots=2, max_seq=16, data=2)
    # one pipeline group, as the reference's
    cfg, rc = twhisper.reduced()
    with pytest.raises(ValueError, match="one pipeline group"):
        tpipe.Runtime(cfg, dataclasses.replace(rc, pp=1, groups=2), "cpu",
                      mesh=MeshShape(1, 1, 2))
