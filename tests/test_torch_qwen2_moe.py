"""qwen2-moe-a2.7b in the port: MoE shared experts on the tape and on the
serve path, against the JAX package on the same inputs.

* the serve path's ``moe_fwd`` against the reference's ``moe_fwd`` at
  ``n_shared`` 1 and 2 (the reduced config's shared FFN of 96, and 2 x
  d_ff_expert when ``d_ff_shared`` is 0);
* the tape's ``apply_moe`` in mode ``bwd`` (F, B and the W stash) against
  the reference block on the reference tape at ``n_shared`` 1 and 2:
  the output, the router's aux, the input cotangent and every dense
  node's dW, the shared banks' among them;
* one reduced train step (3 ``attn:moe`` layers, 8 experts top-2, one
  shared FFN) at one micro-batch against
  ``jax.value_and_grad(reference_loss)``: loss + router_aux_weight *
  aux_sum and every gradient;
* the reduced engine's greedy streams (contiguous and paged caches)
  equal to the reference engine's, with its step counts and capacity
  deferrals.

Params come from ``repro.models.model.init_all_params`` and cross in one
process (``params.from_reference``); inputs are numpy arrays from a seed.
Tolerances, all float32: the blocks within 1e-5 of the largest
|reference| of each tensor (the same products summed in another order);
the train step's loss within 1e-5 relative, every gradient within 1e-4
of its largest |reference|, as ``tests/test_torch_jamba_train.py`` holds
Jamba's step; the streams equal. The reduced config's head_dim 12 runs
the plain versions only.
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
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.core import tape as ttape  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
BLOCK_RTOL = 1e-5
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _tcfg(cfg):
    return tcommon.ModelConfig(**{
        f.name: (getattr(tcommon, type(v).__name__)(**dataclasses.asdict(v))
                 if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(cfg)
        for v in (getattr(cfg, f.name),)})


def _shared_cfg(n_shared):
    """The reduced config with ``n_shared`` shared experts: at 1 its own
    shared FFN of 96, at 2 the width the specs derive (2 x 64)."""
    cfg, rc = jget_arch(ARCH).reduced()
    mo = dataclasses.replace(cfg.moe, n_shared=n_shared,
                             d_ff_shared=96 if n_shared == 1 else 0)
    return dataclasses.replace(cfg, moe=mo), rc


def _layer_params(cfg, rc, seed=2):
    """Layer 0's params from the reference initialiser (numpy)."""
    jp = jmodel.init_all_params(cfg, rc, jax.random.PRNGKey(seed))
    return {n: np.asarray(a[0]) for n, a in jp["segments"]["main"].items()}


def _inputs(cfg):
    rng = np.random.RandomState(5)
    b, s = 2, 16
    return (rng.randn(b, s, cfg.d_model).astype(np.float32),
            rng.randn(b, s, cfg.d_model).astype(np.float32))


@pytest.mark.parametrize("n_shared", [1, 2])
def test_moe_fwd_with_shared_experts_equals_reference(n_shared):
    """The serve path: routed experts plus the shared SwiGLU FFN."""
    cfg, rc = _shared_cfg(n_shared)
    params = _layer_params(cfg, rc)
    assert params["L0.ffn.s_wg"].shape == (
        cfg.d_model, 96 if n_shared == 1 else 128)
    x, _ = _inputs(cfg)
    want = jblocks.moe_fwd(jblocks.LayerCtx(cfg=cfg, rc=rc, rope={}),
                           {k: jnp.asarray(v) for k, v in params.items()},
                           "L0.ffn", jnp.asarray(x))
    got = tblocks.moe_fwd(
        tblocks.LayerCtx(cfg=_tcfg(cfg),
                         rc=tcommon.RunConfig(**dataclasses.asdict(rc)),
                         rope={}),
        {k: torch.from_numpy(v.copy()) for k, v in params.items()},
        "L0.ffn", torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= BLOCK_RTOL


def _block(tape, blocks, ctx, arr, x, dy, dw_of):
    xv = tape.value(arr(x))
    y, aux = blocks.apply_moe(tape, ctx, "L0.ffn", xv)
    cot, ig, ws = tape.backward({y.idx: arr(dy),
                                 aux.idx: arr(np.asarray(0.3, np.float32))})
    return y.val, aux.val, cot[xv.idx], ig, dw_of(ws)


@pytest.mark.parametrize("n_shared", [1, 2])
def test_tape_moe_with_shared_experts_equals_reference(n_shared):
    """F and B (mode bwd) and W: y, aux, dx and the W stash's grads of
    the router, the expert banks and the shared banks."""
    cfg, rc = _shared_cfg(n_shared)
    params = _layer_params(cfg, rc)
    x, dy = _inputs(cfg)

    def jfn(p, xx, yy):
        return _block(jtape.Tape(p, mode="bwd"), jblocks,
                      jblocks.LayerCtx(cfg=cfg, rc=rc, rope={}),
                      jnp.asarray, xx, yy, jtape.compute_dw)

    jy, jaux, jdx, jig, jdw = jax.jit(jfn)(
        {k: jnp.asarray(v) for k, v in params.items()}, x, dy)
    moe = {k: torch.from_numpy(v.copy()) for k, v in params.items()
           if ".ffn." in k}
    ty, taux, tdx, tig, tdw = _block(
        ttape.Tape(moe, mode="bwd"), tblocks,
        tblocks.LayerCtx(cfg=_tcfg(cfg),
                         rc=tcommon.RunConfig(**dataclasses.asdict(rc)),
                         rope={}),
        torch.from_numpy, x, dy, ttape.compute_dw)
    assert _rel(ty.numpy(), jy) <= BLOCK_RTOL
    assert _rel(tdx.numpy(), jdx) <= BLOCK_RTOL
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert not tig and not jig
    assert set(tdw) == set(jdw) == {f"L0.ffn.{n}" for n in (
        "router", "e_wg", "e_wu", "e_wd", "s_wg", "s_wu", "s_wd")}
    for n in jdw:
        assert _rel(tdw[n].numpy(), jdw[n]) <= BLOCK_RTOL, n
    # the fwd-mode tape (the F task) computes the same output
    t = ttape.Tape(moe, mode="fwd")
    yf, _ = tblocks.apply_moe(
        t, tblocks.LayerCtx(cfg=_tcfg(cfg),
                            rc=tcommon.RunConfig(**dataclasses.asdict(rc)),
                            rope={}), "L0.ffn", t.value(torch.from_numpy(x)))
    assert torch.equal(yf.val, ty)


def test_train_step_equals_reference_loss():
    """Reduced qwen2-moe (3 attn:moe layers, a shared FFN each) at one
    micro-batch, pp 1: loss + router_aux_weight * aux_sum and every
    gradient against ``jax.value_and_grad(reference_loss)``."""
    cfg, rc = jget_arch(ARCH).reduced()
    assert cfg.moe.n_shared == 1 and cfg.moe.n_experts == 8
    ov = dict(pp=1, vpp=1, microbatches=1, unit=1, schedule="zeropp")
    rc = dataclasses.replace(rc, **ov)
    jp = jax.tree.map(np.asarray, jmodel.init_all_params(
        cfg, rc, jax.random.PRNGKey(0)))
    ts = tsession(ARCH, mode="train", seq_len=16, device="cpu",
                  overrides=ov)
    batch = ts.stream(seed=3).batch(0)
    tokens, labels = (np.asarray(batch[k]) for k in ("tokens", "labels"))
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.reference_loss(cfg, rc, p, tokens, labels)))(jp)
    tp = tparams.from_reference(jp, device="cpu")
    grads, m = ts.train_step(tp, batch)
    aux = float(m["aux_sum"])
    assert aux > 0
    got = float(m["loss_sum"]) + cfg.moe.router_aux_weight * aux
    assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want))
    n = 0
    for path, w in _leaves(jax.tree.map(np.asarray, jgrads)):
        g = grads
        for k in path:
            g = g[k]
        assert float(np.abs(w).max()) > 0, path
        assert _rel(g.numpy(), w) <= GRAD_RTOL, path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))
    assert {"L0.ffn.s_wg", "L0.ffn.s_wu", "L0.ffn.s_wd"} <= set(
        grads["segments"]["main"])


def test_pinned_routing_replays_the_recorded_picks():
    """``blocks.pinned_routing`` (the card's MoE comparisons): a replay on
    the recorded input reproduces the output bit for bit; on an input
    whose free routing flips picks, the replay keeps the recorded ids and
    slots, so the output moves by about the perturbation only; a replay
    of another shape is refused."""
    cfg, rc = _shared_cfg(1)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))            # drops picks too
    params = {k: torch.from_numpy(v.copy())
              for k, v in _layer_params(cfg, rc).items()}
    ctx = tblocks.LayerCtx(cfg=_tcfg(cfg),
                           rc=tcommon.RunConfig(**dataclasses.asdict(rc)),
                           rope={})
    x = torch.from_numpy(_inputs(cfg)[0])
    xp = x + 0.05 * torch.from_numpy(
        np.random.RandomState(9).randn(*x.shape).astype(np.float32))

    def run(v, picks=None):
        with tblocks.pinned_routing(picks) as got:
            y = tblocks.moe_fwd(ctx, params, "L0.ffn", v)
        return y, got

    y, picks = run(x)
    (ti, sl), = picks
    assert int((sl == tblocks._capacity(32, cfg.moe)).sum()) > 0
    y_free, (free,) = run(xp)
    assert not torch.equal(free[0], ti)           # the perturbation flips
    y_again, _ = run(x, picks)
    assert torch.equal(y_again, y)
    with tblocks.pinned_routing(picks) as got:
        y_pin = tblocks.moe_fwd(ctx, params, "L0.ffn", xp)
    assert got is picks
    pinned, free_d = ((a - y).abs().max() for a in (y_pin, y_free))
    assert pinned < 0.5 * free_d
    with pytest.raises(ValueError, match="routes"):
        run(x[:1], picks)
    with pytest.raises(ValueError, match="more routing calls"):
        with tblocks.pinned_routing(picks):
            for _ in range(2):
                tblocks.moe_fwd(ctx, params, "L0.ffn", x)


def _workload():
    """Six requests over four slots (reclaim), a shared prompt prefix."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 256, size=8).astype(np.int32)
    out = []
    for i, (p, g) in enumerate([(5, 4), (9, 6), (4, 3), (12, 5), (8, 2),
                                (13, 6)]):
        toks = rng.randint(0, 256, size=p).astype(np.int32)
        if i in (1, 3, 5):
            toks[:8] = prefix
        out.append((toks, g))
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_engine_streams_equal_reference(paged):
    """The reduced engine (shared experts on the serve path) in the
    contiguous and the paged layout against the reference engine."""
    kw = dict(max_slots=4, max_seq=32, overrides=dict(pp=1, microbatches=1))
    if paged:
        kw.update(page_size=4, prefill_chunk=4)
    js = jsession(ARCH, mode="serve", data=1, **kw)
    ts = tsession(ARCH, device="cpu", **kw)
    jparams = js.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_reference(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    res = []
    for sess, p in ((js, jparams), (ts, tp)):
        eng = sess.serve_engine(p)
        reqs = [eng.submit(t, max_gen=g) for t, g in _workload()]
        eng.run_until_idle()
        res.append(([r.result(timeout=5) for r in reqs], eng.stats))
    (want, jst), (got, tst) = res
    assert got == want
    assert [len(t) for t in got] == [g for _, g in _workload()]
    assert (tst.prefill_steps, tst.decode_steps, tst.capacity_deferrals) \
        == (jst.prefill_steps, jst.decode_steps, jst.capacity_deferrals)
