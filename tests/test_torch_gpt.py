"""repro_torch's GPT training slice (the paper's ``gpt_paper``) against the
JAX package, on the CPU.

* LayerNorm (``apply_norm``) and the GELU MLP (``apply_ffn``) on the
  port's tape vs the reference's forward and ``jax.vjp``;
* the final LayerNorm's explicit backward and the untied head's
  ``loss_and_dy`` vs ``repro/core/vocab.py``;
* the plain attention and its backward at head_dim 96 (gpt-1.5B's) vs
  ``repro/kernels/ref.py`` and ``jax.vjp``; the plain ``softmax_xent``
  over a ``[d, vocab]`` head vs the reference's and its Pallas kernel in
  interpret mode;
* the reduced gpt train step (pp 1, vpp 2, zeropp, four micro-batches in
  units of two, seq 16) vs the JAX ``make_train_step``, then one AdamW
  step (``head.w`` decays, the LayerNorm scales and biases do not); the
  single-device reference loss vs the JAX one and the step's;
* the serve Session's refusal and the training CLI.

Float32 inputs made from numpy seeds; params cross in one process
(``params.from_reference``). Tolerances: 1e-5 of the largest reference
value for single functions (sums of tens to hundreds of float32 terms
in another order); the train step's loss 1e-5 relative and every
gradient and AdamW tensor max |diff| <= GRAD_RTOL (1e-4) * max |ref|,
as ``tests/test_torch_train.py`` holds llama.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.api import session as jsession  # noqa: E402
from repro.configs import gpt_paper as jgpt  # noqa: E402
from repro.core import tape as jtape  # noqa: E402
from repro.core import vocab as jvocab  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_xent import (  # noqa: E402
    softmax_xent as pallas_xent,
)
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import gpt_paper as tgpt  # noqa: E402
from repro_torch.core import tape as ttape  # noqa: E402
from repro_torch.core import vocab as tvocab  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from torch_cases import qkv as _qkv  # noqa: E402

RTOL = 1e-5
GRAD_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _cfgs():
    jcfg, jrc = jgpt.reduced()
    tcfg, trc = tgpt.reduced()
    return jcfg, dataclasses.replace(jrc, pp=1), tcfg, dataclasses.replace(
        trc, pp=1)


# --------------------------------------------------------------------------- #
# Blocks on the tape
# --------------------------------------------------------------------------- #


def _tape_grads(params, build, x, dy):
    """Run ``build(tape, x_tval)`` on the port's bwd tape; return (y, dx,
    param grads) as numpy, the deferred dW GEMMs replayed (the W task)."""
    t = ttape.Tape({k: _t(a) for k, a in params.items()}, mode="bwd")
    xin = t.value(_t(x))
    out = build(t, xin)
    cots, igrads, stash = t.backward({out.idx: _t(dy)})
    grads = dict(igrads)
    grads.update(ttape.compute_dw(stash))
    return out.val.numpy(), cots[xin.idx].numpy(), {
        k: v.numpy() for k, v in grads.items()}


def test_layernorm_on_the_tape_matches_jax():
    """``apply_norm`` with LayerNorm (eps 1e-5, float32 statistics, scale
    and bias with immediate gradients) vs the reference's forward and
    ``jax.vjp`` of it."""
    jcfg, _, tcfg, _ = _cfgs()
    rng = np.random.RandomState(40)
    d = jcfg.d_model
    x = (rng.randn(2, 7, d) * 3 + 1).astype(np.float32)
    dy = rng.randn(2, 7, d).astype(np.float32)
    p = {"n.scale": (1 + 0.2 * rng.randn(d)).astype(np.float32),
         "n.bias": (0.3 * rng.randn(d)).astype(np.float32)}
    ty, tdx, tg = _tape_grads(
        p, lambda t, xv: tblocks.apply_norm(t, tcfg, "n", xv), x, dy)

    def fwd(scale, bias, xx):
        t = jtape.Tape({"n.scale": scale, "n.bias": bias}, mode="fwd")
        return jblocks.apply_norm(t, jcfg, "n", t.value(xx)).val

    jy, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (p["n.scale"],
                                                       p["n.bias"], x)))
    dscale, dbias, dx = vjp(jnp.asarray(dy))
    _close(ty, jy)
    _close(tdx, dx)
    assert set(tg) == {"n.scale", "n.bias"}
    _close(tg["n.scale"], dscale)
    _close(tg["n.bias"], dbias)


def test_gelu_mlp_on_the_tape_matches_jax():
    """``apply_ffn`` with the GELU MLP (``wi``, the tanh GELU as
    ``jax.nn.gelu``'s default, ``wd``; dW deferred to the W task) vs the
    reference's forward and ``jax.vjp`` of it."""
    jcfg, jrc, tcfg, trc = _cfgs()
    assert set(tblocks.ffn_specs(tcfg, "f")) == {"f.wi", "f.wd"}
    rng = np.random.RandomState(41)
    d, f = jcfg.d_model, jcfg.d_ff
    x = rng.randn(2, 5, d).astype(np.float32)
    dy = rng.randn(2, 5, d).astype(np.float32)
    p = {"f.wi": (rng.randn(d, f) / np.sqrt(d)).astype(np.float32),
         "f.wd": (rng.randn(f, d) / np.sqrt(f)).astype(np.float32)}
    tctx = tblocks.LayerCtx(cfg=tcfg, rc=trc, rope={})
    jctx = jblocks.LayerCtx(cfg=jcfg, rc=jrc, rope={})
    ty, tdx, tg = _tape_grads(
        p, lambda t, xv: tblocks.apply_ffn(t, tctx, "f", xv), x, dy)

    def fwd(wi, wd, xx):
        t = jtape.Tape({"f.wi": wi, "f.wd": wd}, mode="fwd")
        return jblocks.apply_ffn(t, jctx, "f", t.value(xx)).val

    jy, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (p["f.wi"],
                                                       p["f.wd"], x)))
    dwi, dwd, dx = vjp(jnp.asarray(dy))
    _close(ty, jy)
    _close(tdx, dx)
    _close(tg["f.wi"], dwi)
    _close(tg["f.wd"], dwd)


# --------------------------------------------------------------------------- #
# The loss head: final LayerNorm and the untied head
# --------------------------------------------------------------------------- #


def _io(rng, cfg):
    d, v = cfg.d_model, cfg.vocab
    return {"embed.table": (rng.randn(v, d) * 0.2).astype(np.float32),
            "final_norm.scale": (1 + 0.1 * rng.randn(d)).astype(np.float32),
            "final_norm.bias": (0.2 * rng.randn(d)).astype(np.float32),
            "head.w": (rng.randn(d, v) * 0.3).astype(np.float32)}


def test_final_layernorm_backward_matches_jax():
    """The final LayerNorm's forward and explicit backward (dh, and the
    scale and bias gradients) vs ``_final_norm_fwd`` / ``_final_norm_bwd``
    of the reference."""
    jcfg, _, tcfg, _ = _cfgs()
    rng = np.random.RandomState(42)
    io_ = _io(rng, jcfg)
    h = (rng.randn(19, jcfg.d_model) * 2 - 0.5).astype(np.float32)
    dy = rng.randn(19, jcfg.d_model).astype(np.float32)
    jhn, jres = jvocab._final_norm_fwd(
        jcfg, {k: jnp.asarray(a) for k, a in io_.items()}, jnp.asarray(h))
    jdh, jg = jvocab._final_norm_bwd(jcfg, jres, jnp.asarray(dy))
    thn, tres = tvocab._final_norm_fwd(
        tcfg, {k: _t(a) for k, a in io_.items()}, _t(h))
    tdh, tg = tvocab._final_norm_bwd(tcfg, tres, _t(dy))
    _close(thn, jhn)
    _close(tdh, jdh)
    assert set(tg) == set(jg) == {"final_norm.scale", "final_norm.bias"}
    for k in jg:
        _close(tg[k], jg[k])


def test_untied_loss_and_dy_matches_jax():
    """The trainer's loss head over the untied ``head.w`` [d, vocab] (final
    LayerNorm, K2's function over several vocab chunks, a mask) vs the
    JAX one-rank branch: the head's gradient goes to ``head.w``; nothing
    goes to ``embed.table``."""
    jcfg, jrc, tcfg, trc = _cfgs()
    trc = dataclasses.replace(trc, vocab_chunk=96)
    rng = np.random.RandomState(43)
    io_ = _io(rng, jcfg)
    n = 21
    h = rng.randn(n, jcfg.d_model).astype(np.float32)
    lab = rng.randint(0, jcfg.vocab, n).astype(np.int32)
    mask = (rng.rand(n) > 0.25).astype(np.float32)
    denom = 2.0 * n
    jl, jdh, jg = jvocab.loss_and_dy(
        jcfg, jrc, {k: jnp.asarray(a) for k, a in io_.items()},
        jnp.asarray(h), jnp.asarray(lab), denom, None, 1,
        mask=jnp.asarray(mask))
    tl, tdh, tg = tvocab.loss_and_dy(
        tcfg, trc, {k: _t(a) for k, a in io_.items()}, _t(h),
        torch.from_numpy(lab), denom, None, 1, mask=_t(mask))
    _close(tl, jl)
    _close(tdh, jdh)
    assert set(tg) == set(jg) == {"final_norm.scale", "final_norm.bias",
                                  "head.w"}
    for k in jg:
        _close(tg[k], jg[k])


# --------------------------------------------------------------------------- #
# Plain versions at the GPT shapes
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_head_dim_96_matches_jax(causal):
    """K1's and K1b's plain versions at gpt-1.5B's head width (96, MHA:
    h == g) vs ``ref.attention`` and ``jax.vjp`` of it; the scale is
    1/sqrt(96)."""
    b, s, h, e = 2, 13, 3, 96
    q, k, v = _qkv(44, b, s, h, h, e, s)
    do = np.random.RandomState(45).randn(b, s, h, e).astype(np.float32)
    kw = dict(causal=causal, q_offset=0)
    out, lse = tref.attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    jo, vjp = jax.vjp(lambda a, b_, c: jref.attention(a, b_, c, **kw),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(out, jo)
    got = tref.attention_bwd(_t(q), _t(k), _t(v), out, _t(do), lse, **kw)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        _close(g, w)
    # the differentiable op the tape calls, on a CPU tensor
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    o = ops.attention(qt, kt, vt, **kw)
    _close(o, jo)
    for g, w in zip(torch.autograd.grad(o, (qt, kt, vt), _t(do)),
                    vjp(jnp.asarray(do))):
        _close(g, w)


def test_plain_softmax_xent_untied_head_matches_jax():
    """K2's plain version over a contiguous ``[d, vocab]`` head (ragged
    rows and vocab over chunks of 128, a mask) vs ``ref.softmax_xent`` and
    the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(46)
    n, d, vocab = 29, 24, 264
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, vocab) * 0.5).astype(np.float32)
    lab = rng.randint(0, vocab, n).astype(np.int32)
    mask = (rng.rand(n) > 0.3).astype(np.float32)
    head = _t(w)
    assert head.is_contiguous()
    loss, (dh, dw) = tref.softmax_xent(_t(h), head, torch.from_numpy(lab),
                                       chunk=128, mask=_t(mask))
    assert dw.shape == (d, vocab)
    jm = jnp.asarray(mask)
    for jl, (jdh, jdw) in (
            jref.softmax_xent(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(lab), chunk=128, mask=jm),
            pallas_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab),
                        mask=jm, block_n=128, block_v=256, interpret=True)):
        _close(loss, jl)
        _close(dh, jdh)
        _close(dw, jdw)


# --------------------------------------------------------------------------- #
# The train step and AdamW vs the JAX pipeline
# --------------------------------------------------------------------------- #


def _node(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_gpt_train_step_matches_jax_pipeline():
    """Loss and every gradient of one step of reduced gpt (LayerNorm, GELU
    MLP, untied head), pp 1, vpp 2, zeropp, four micro-batches in units
    of two, seq 16: the port's eager tick engine vs the JAX
    ``make_train_step`` on one device. Then one AdamW step on the
    reference's grads in both packages (weight decay on ``head.w``, none
    on the LayerNorm scales and biases): params, master and moments."""
    ov = dict(pp=1, vpp=2, schedule="zeropp", microbatches=4, unit=2)
    js = jsession("gpt_paper", mode="train", seq_len=16, data=1,
                  overrides=ov)
    jp = js.init_params(jax.random.PRNGKey(0))
    batch = js.stream(seed=5).batch(0)
    jg, jm = js.train_step(jp, batch)

    ts = tsession("gpt_paper", mode="train", seq_len=16, device="cpu",
                  overrides=ov)
    assert ts.describe()["schedule"]["ticks"] == js.rt.tables["main"].T
    tp = tparams.from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    assert set(tp["io"]) == {"embed.table", "final_norm.scale",
                             "final_norm.bias", "head.w"}
    tg, tm = ts.train_step(tp, batch)
    jl = float(jm["loss_sum"])
    assert abs(float(tm["loss_sum"]) - jl) <= 1e-5 * abs(jl)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jflat) == sum(len(v) for v in tg["segments"].values()) + len(
        tg["io"])
    for path, g in jflat:
        node = _node(tg, path)
        assert node.dtype == torch.float32
        assert float(np.abs(np.asarray(g)).max()) > 0, path
        _close(node, g, GRAD_RTOL)

    # AdamW over the gpt tree, both fed the reference's grads (its first
    # step divides each grad by its own magnitude, so grads equal to 1e-6
    # would not give updates equal to 1e-4 where a grad is near zero)
    jcfg, tcfg = jadamw.AdamWConfig(lr=1e-2), tadamw.AdamWConfig(lr=1e-2)
    jp2, jst, jom = jadamw.apply_updates(jp, jg, jadamw.init_state(
        jp, jcfg), jcfg, 1.0)
    tp2, tst, tom = tadamw.apply_updates(
        tp, tparams.from_reference(jax.tree.map(np.asarray, jg),
                                   device="cpu"),
        tadamw.init_state(tp, tcfg), tcfg, 1.0)
    assert abs(float(tom["grad_norm"]) - float(jom["grad_norm"])) <= \
        1e-5 * float(jom["grad_norm"])
    for tree_t, tree_j in ((tp2, jp2), (tst["master"], jst["master"]),
                           (tst["m"], jst["m"]), (tst["v"], jst["v"])):
        for path, w in jax.tree_util.tree_flatten_with_path(tree_j)[0]:
            _close(_node(tree_t, path), w, GRAD_RTOL)


def test_gpt_reference_loss_matches_jax_and_train_step():
    """``reference_loss`` (stages looped in logical order; the final
    LayerNorm with its bias, logits over the untied head) equals the JAX
    one, and the tick engine's step loss equals it."""
    ov = dict(pp=1, vpp=2, microbatches=2)
    js = jsession("gpt_paper", mode="train", seq_len=8, data=1,
                  overrides=ov)
    jp = jax.tree.map(np.asarray, js.init_params(jax.random.PRNGKey(1)))
    batch = js.stream(seed=6).batch(0)
    want = float(jmodel.reference_loss(js.cfg, js.rc, jp, batch["tokens"],
                                       batch["labels"]))
    ts = tsession("gpt_paper", mode="train", seq_len=8, device="cpu",
                  overrides=ov)
    tp = tparams.from_reference(jp, device="cpu")
    got = float(tmodel.reference_loss(ts.cfg, ts.rc, tp,
                                      torch.from_numpy(batch["tokens"]),
                                      torch.from_numpy(batch["labels"])))
    assert abs(got - want) <= 1e-5 * abs(want)
    _, m = ts.train_step(tp, batch)
    assert abs(float(m["loss_sum"]) - want) <= 1e-5 * abs(want)


# --------------------------------------------------------------------------- #
# Session and CLI
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("reduced", [True, False])
def test_serve_session_refuses_gpt(reduced):
    """Serving gpt_paper (LayerNorm, the GELU MLP, head_dim 96) waits for
    its serve path and K3/K4 at 96: refused on every device, before any
    device work."""
    for device in ("cpu", "cuda"):
        with pytest.raises(SessionError, match="GPT serving"):
            tsession("gpt_paper", max_seq=64, reduced=reduced,
                     device=device)


def test_launch_train_gpt_cpu_prints_train_ok():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.main(["--arch", "gpt_paper", "--device", "cpu", "--steps",
                      "2", "--seq", "16"])
    text = out.getvalue()
    assert "gpt-smoke on cpu" in text, text
    assert "TRAIN_OK steps=2" in text, text
    assert "'ref_xent': 8" in text, text     # 4 micro-batches x 2 steps
