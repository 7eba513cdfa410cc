"""The xLSTM slice: repro_torch against repro on the same inputs.

* the plain scans: ``mlstm_chunkwise`` (a small chunk, ragged s, with and
  without a carried state, the state out), ``mlstm_step`` chained over a
  sequence against the chunkwise result, ``slstm_scan`` split into two
  calls with a carried state against one call, each against the
  reference's jnp scans; ``torch.autograd`` of the plain ``slstm_scan``
  and ``mlstm_chunkwise`` against ``jax.vjp`` of the reference's;
* K6b's reverse walk (``ref.slstm_scan_bwd``, the kernel's order of
  operations written in torch) against ``jax.vjp`` of the reference's
  ``slstm_scan``, over a few (s, state) cases, one where the 1e-6 clamp
  of the normaliser binds at step 0;
* the eight blocks with params carried across by ``from_reference``: the
  tape forms (``apply_mlstm``, ``apply_slstm``) in mode ``bwd`` against
  the reference blocks on the reference tape, and the cached forms
  (prefill, then decode under a slot mask) against the reference's, in
  float32, and both forms at bfloat16, whose dtype steps differ between
  them (the tape's ``silu(z)`` in the compute dtype, the cached prefill's
  in float32, cast);
* the reduced config (6 layers, 5 mLSTM and 1 sLSTM): one train step
  against ``jax.value_and_grad(reference_loss)``, the serve engine's
  greedy streams and logits against the reference engine's, the CLIs;
* the configs, specs, cache specs and the one-card cuts.

Params come from ``repro.models.model.init_all_params`` and cross in one
process; inputs are numpy arrays from a seed. Tolerances, float32: the
scans and the blocks within 1e-5 of the largest |reference| of each
tensor, or 1e-5 absolute plus relative (the same operations, the
einsums summed in another order); the mLSTM step chain against the
chunkwise form within 2e-4 (the reference's own test's: another
algebra); the K6b walk and the autograd grads within 1e-5 of the largest
|reference| of each tensor; the train step's loss within 1e-5 relative
and every gradient within 1e-4 of its largest |reference|; the engine's
logits within 1e-4 absolute and its streams exactly. The bfloat16 blocks
within 3 bf16 ulps (3 x 2^-8) of the largest |reference| of the tensor:
the two frameworks round bfloat16 at other places.
``tests/test_torch_cuda.py`` holds K6 and K6b to the plain versions on a
GPU.
"""

import contextlib
import dataclasses
import io

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
from repro.configs import xlstm_1p3b as jxlstm  # noqa: E402
from repro.core import tape as jtape  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import xlstm_1p3b as txlstm  # noqa: E402
from repro_torch.core import tape as ttape  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import slstm_scan as sl  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ARCH = "xlstm-1.3b"
TOL = dict(atol=1e-5, rtol=1e-5)
RTOL = 1e-5
STEP_ATOL = 2e-4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
ATOL = 1e-4
BF16_RTOL = 3 * 2.0 ** -8


def _t(x):
    return torch.from_numpy(np.array(x))


def _fields(obj):
    return dataclasses.asdict(obj)


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


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------- #
# The plain scans against the reference's
# --------------------------------------------------------------------------- #


def _mlstm_inputs(seed, b, s, h, e):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, e) for _ in range(3))
    ig = 0.5 * rng.randn(b, s, h)
    fg = rng.randn(b, s, h) + 2.0
    state = (rng.randn(b, h, e, e), np.abs(rng.randn(b, h, e)),
             rng.randn(b, h))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return [f32(a) for a in (q, k, v, ig, fg)], tuple(map(f32, state))


@pytest.mark.parametrize("s,chunk,carry,state_out", [
    (37, 16, True, True),      # ragged: the last chunk padded
    (37, 16, False, False),
    (32, 8, False, True),
    (5, 8, True, True),        # one part chunk
])
def test_mlstm_chunkwise_plain_matches_jax_ref(s, chunk, carry, state_out):
    (q, k, v, ig, fg), st = _mlstm_inputs(s + chunk, 2, s, 2, 8)
    kw = dict(chunk=chunk, return_state=state_out)
    want = jref.mlstm_chunkwise(
        *map(jnp.asarray, (q, k, v, ig, fg)),
        state=tuple(map(jnp.asarray, st)) if carry else None, **kw)
    before = ops.kernel_counters().get("mlstm_chunkwise", 0)
    got = ops.mlstm_chunkwise(*map(_t, (q, k, v, ig, fg)),
                              state=tuple(map(_t, st)) if carry else None,
                              **kw)
    assert ops.kernel_counters()["mlstm_chunkwise"] == before + 1
    if state_out:
        (want, wst), (got, gst) = want, got
        for g, w in zip(gst, wst):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlstm_step_chain_equals_chunkwise():
    """The decode step chained over 64 positions from a zero state equals
    the chunkwise form (the reference's own check, ``test_kernels.py``),
    port and reference step by step."""
    (q, k, v, ig, fg), _ = _mlstm_inputs(3, 1, 64, 2, 16)
    whole = tref.mlstm_chunkwise(*map(_t, (q, k, v, ig, fg)), chunk=16)
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    jst = (z(1, 2, 16, 16), z(1, 2, 16), z(1, 2))
    tst = tuple(map(_t, jst))
    ys = []
    for t in range(64):
        args = [a[:, t] for a in (q, k, v, ig, fg)]
        jst, jy = jref.mlstm_step(jst, *map(jnp.asarray, args))
        tst, ty = ops.mlstm_step(tst, *map(_t, args))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        ys.append(ty)
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), whole.numpy(),
                               atol=STEP_ATOL)


def _slstm_inputs(seed, b, s, h, e):
    rng = np.random.RandomState(seed)
    xg = rng.randn(b, s, h, 4, e).astype(np.float32)
    state = (rng.randn(b, h, e).astype(np.float32),
             np.abs(rng.randn(b, h, e)).astype(np.float32),
             rng.randn(b, h, e).astype(np.float32))
    return xg, state


def test_slstm_scan_split_equals_one_call():
    """Two calls with the state carried equal one call, port and
    reference, from a zero and from a given state."""
    xg, st = _slstm_inputs(4, 2, 23, 2, 8)
    for state in (None, st):
        jkw = dict(state=None if state is None
                   else tuple(map(jnp.asarray, state)))
        tkw = dict(state=None if state is None else tuple(map(_t, state)))
        wy, wst = jref.slstm_scan(jnp.asarray(xg), return_state=True, **jkw)
        y, fin = ops.slstm_scan(_t(xg), return_state=True, **tkw)
        y1, st1 = tref.slstm_scan(_t(xg[:, :9]), return_state=True, **tkw)
        y2, st2 = tref.slstm_scan(_t(xg[:, 9:]), state=st1,
                                  return_state=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0,
                                   atol=0)
        for g, g2, w in zip(fin, st2, wst):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
            torch.testing.assert_close(g2, g, rtol=0, atol=0)


def test_plain_scan_autograd_matches_jax_vjp():
    """``torch.autograd`` through the plain ``slstm_scan`` (from a given
    state, into the final state too) and ``mlstm_chunkwise`` (ragged,
    carried state) against ``jax.vjp`` of the reference's. The chunkwise
    backward passes through ``where(causal, exp(lw), 0)``: its grads are
    finite at these shapes."""
    xg, st = _slstm_inputs(5, 2, 13, 2, 8)
    rng = np.random.RandomState(6)
    dy = rng.randn(2, 13, 2, 8).astype(np.float32)
    dst = tuple(rng.randn(2, 2, 8).astype(np.float32) for _ in range(3))
    _, vjp = jax.vjp(lambda x, s: jref.slstm_scan(x, state=s,
                                                  return_state=True),
                     jnp.asarray(xg), tuple(map(jnp.asarray, st)))
    wx, wst = vjp((jnp.asarray(dy), tuple(map(jnp.asarray, dst))))
    ins = [_t(xg).requires_grad_(True)] + [
        _t(a).requires_grad_(True) for a in st]
    y, fin = tref.slstm_scan(ins[0], state=tuple(ins[1:]), return_state=True)
    grads = torch.autograd.grad([y, *fin], ins, [_t(dy), *map(_t, dst)])
    for g, w in zip(grads, (wx, *wst)):
        assert _rel(g.numpy(), w) <= RTOL

    (q, k, v, ig, fg), mst = _mlstm_inputs(7, 2, 21, 2, 8)
    dy = rng.randn(2, 21, 2, 8).astype(np.float32)
    args = (q, k, v, ig, fg)
    _, vjp = jax.vjp(lambda *a: jref.mlstm_chunkwise(
        *a[:5], chunk=8, state=a[5:]), *map(jnp.asarray, args + mst))
    want = vjp(jnp.asarray(dy))
    ins = [_t(a).requires_grad_(True) for a in args + mst]
    y = tref.mlstm_chunkwise(*ins[:5], chunk=8, state=tuple(ins[5:]))
    grads = torch.autograd.grad(y, ins, _t(dy))
    for g, w in zip(grads, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g.numpy(), w) <= RTOL


# --------------------------------------------------------------------------- #
# K6b's reverse walk, emulated on the CPU, against jax.vjp
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["short", "state", "long", "clamp"])
def test_k6b_walk_matches_jax_vjp(case):
    """The plain reverse walk in K6b's order (from the states K6 saves:
    ``slstm_walk(..., save_states=True)``) against ``jax.vjp`` of the
    reference scan: the gates' gradient and, from a given state, the
    initial state's. 'clamp': i far below log_sigmoid(f) from a zero
    state, so n' = exp(i - lf) < 1e-6 at step 0 and the clamp binds
    there (asserted): no gradient reaches n' through it."""
    s, carry = dict(short=(1, False), state=(17, True), long=(64, False),
                    clamp=(6, False))[case]
    xg, st = _slstm_inputs(20 + s, 2, s, 2, 8)
    if case == "clamp":
        xg[:, 0, :, 0] = -30.0          # i
        xg[:, 0, :, 1] = 1.0            # f: log_sigmoid(f) = -0.31
    rng = np.random.RandomState(8)
    dy = rng.randn(2, s, 2, 8).astype(np.float32)
    dst = tuple(rng.randn(2, 2, 8).astype(np.float32) for _ in range(3))
    jst = tuple(map(jnp.asarray, st)) if carry else None
    _, vjp = jax.vjp(lambda x, s_: jref.slstm_scan(x, state=s_,
                                                   return_state=True),
                     jnp.asarray(xg), jst)
    wx, wst = vjp((jnp.asarray(dy), tuple(map(jnp.asarray, dst))))
    tst = tuple(map(_t, st)) if carry else None
    y, _, states = tref.slstm_walk(_t(xg), tst, save_states=True)
    if case == "clamp":
        _, (_, n1, _), _ = tref.slstm_walk(_t(xg[:, :1]))
        assert bool((n1 < tref.SLSTM_N_MIN).all())
    got, d0 = sl.slstm_scan_bwd(_t(xg), _t(dy), states,
                                tuple(map(_t, dst)))
    assert got.dtype == torch.float32 and got.shape == xg.shape
    assert _rel(got.numpy(), wx) <= RTOL
    if carry:
        for g, w in zip(d0, wst):
            assert _rel(g.numpy(), w) <= RTOL


def test_slstm_train_op_takes_the_plain_walks_on_the_cpu():
    """The training path's differentiable sLSTM on CPU tensors: the
    plain forward (counted ``ref_slstm``) and, when a gradient is taken,
    the plain reverse walk (``ref_slstm_bwd``), equal to the autograd of
    the plain scan; without a gradient nothing is saved. Asking for the
    kernel on a CPU tensor raises."""
    xg, _ = _slstm_inputs(9, 2, 11, 2, 8)
    dy = _t(np.random.RandomState(9).randn(2, 11, 2, 8).astype(np.float32))
    x = _t(xg).requires_grad_(True)
    c = ops.kernel_counters()
    y = ops.slstm_scan_train(x)
    (g,) = torch.autograd.grad(y, x, dy)
    after = ops.kernel_counters()
    assert after["ref_slstm"] == c.get("ref_slstm", 0) + 1
    assert after["ref_slstm_bwd"] == c.get("ref_slstm_bwd", 0) + 1
    x2 = _t(xg).requires_grad_(True)
    (w,) = torch.autograd.grad(tref.slstm_scan(x2), x2, dy)
    assert _rel(g.numpy(), w.numpy()) <= RTOL
    with torch.no_grad():
        torch.testing.assert_close(ops.slstm_scan_train(x), y.detach(),
                                   rtol=0, atol=0)
    launches = dict(sl.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.slstm_scan_train(x, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.slstm_scan(x, impl="kernel")
    assert sl.LAUNCHES == launches


# --------------------------------------------------------------------------- #
# The blocks against the reference's blocks
# --------------------------------------------------------------------------- #


def _reduced(compute="float32"):
    cfg, rc = jget_arch(ARCH).reduced()
    rc = dataclasses.replace(rc, param_dtype=compute, compute_dtype=compute)
    return cfg, rc


def _tcfg(cfg):
    return tcommon.ModelConfig(**{
        f.name: (getattr(tcommon, type(v).__name__)(**dataclasses.asdict(v))
                 if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(cfg)
        for v in (getattr(cfg, f.name),)})


def _trc(rc):
    return tcommon.RunConfig(**dataclasses.asdict(rc))


def _layer_params(cfg, rc, seed):
    """The first stage's params from the reference initialiser (numpy,
    float32 bits of bf16 leaves), with the gate biases drawn too (their
    init is zeros) so that their gradients are tested on real values."""
    jp = jmodel.init_all_params(cfg, rc, jax.random.PRNGKey(seed))
    out = {n: np.asarray(jnp.asarray(a[0], jnp.float32))
           for n, a in jp["segments"]["main"].items()}
    rng = np.random.RandomState(seed)
    for n in out:
        if n.endswith("_bias"):
            out[n] = (0.5 * rng.randn(*out[n].shape)).astype(np.float32)
    return out


def _cast(params, conv, dtype):
    return {k: conv(v).astype(dtype) if dtype != "float32" else conv(v)
            for k, v in params.items()}


def _block(tape, blocks, ctx, which, x, dy, dw_of):
    xv = tape.value(x)
    apply = blocks.apply_mlstm if which == "mlstm" else blocks.apply_slstm
    y = apply(tape, ctx, f"{PFX[which]}.mix", xv)
    cot, ig, ws = tape.backward({y.idx: dy})
    return y.val, cot[xv.idx], ig, dw_of(ws)


# layer 0 is an mLSTM slot, layer 5 the sLSTM slot of the reduced config
PFX = {"mlstm": "L0", "slstm": "L5"}


def _run_tape_block(which, compute, seed=2):
    cfg, rc = _reduced(compute)
    params = _layer_params(cfg, rc, seed)
    rng = np.random.RandomState(5)
    b, s = 2, 21                        # ragged against the 128 chunk
    x = rng.randn(b, s, cfg.d_model).astype(np.float32)
    dy = rng.randn(b, s, cfg.d_model).astype(np.float32)
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bfloat16" else torch.float32

    def jfn(p, xx, yy):
        return _block(jtape.Tape(p, mode="bwd"), jblocks,
                      jblocks.LayerCtx(cfg=cfg, rc=rc, rope={}), which,
                      xx.astype(jdt), yy.astype(jdt), jtape.compute_dw)

    want = jax.jit(jfn)({k: jnp.asarray(v, jdt) for k, v in params.items()},
                        jnp.asarray(x), jnp.asarray(dy))
    tt = ttape.Tape({k: _t(v).to(tdt) for k, v in params.items()},
                    mode="bwd")
    got = _block(tt, tblocks, tblocks.LayerCtx(cfg=_tcfg(cfg), rc=_trc(rc),
                                               rope={}),
                 which, _t(x).to(tdt), _t(dy).to(tdt), ttape.compute_dw)
    return want, got


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_tape_blocks_equal_reference_blocks(which):
    """In mode bwd, float32: y, the input cotangent, the immediate grads
    (the mLSTM core's ``w_if`` and ``if_bias``, the sLSTM core's
    ``g_bias``) and the W stash's (every projection a dense node)."""
    (jy, jdx, jig, jdw), (ty, tdx, tig, tdw) = _run_tape_block(
        which, "float32")
    assert _rel(ty.numpy(), jy) <= RTOL
    assert _rel(tdx.numpy(), jdx) <= RTOL
    p = PFX[which]
    assert set(tig) == set(jig) == (
        {f"{p}.mix.w_if", f"{p}.mix.if_bias"} if which == "mlstm"
        else {f"{p}.mix.g_bias"})
    assert set(tdw) == set(jdw) == (
        {f"{p}.mix.{w}" for w in ("w_up", "wq", "wk", "wv", "w_out")}
        if which == "mlstm" else {f"{p}.mix.w_gates", f"{p}.mix.w_out"})
    for n in jig:
        assert _rel(tig[n].numpy(), jig[n]) <= RTOL, n
    for n in jdw:
        assert _rel(tdw[n].numpy(), jdw[n]) <= RTOL, n


@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_tape_blocks_bf16(which):
    """bfloat16 params and compute: the tape forms' y and input cotangent
    against the reference's, within 3 bf16 ulps of the largest |value|
    (the mLSTM core takes ``silu(z)`` in the compute dtype here)."""
    (jy, jdx, _, _), (ty, tdx, _, _) = _run_tape_block(which, "bfloat16")
    assert ty.dtype == torch.bfloat16
    assert _rel(ty.float().numpy(), _f32(jy)) <= BF16_RTOL
    assert _rel(tdx.float().numpy(), _f32(jdx)) <= BF16_RTOL


def _cached_case(which, compute, seed):
    """A prefill of 6 tokens then one decode step of one layer, rows 1 and
    2 masked in turn, from random incoming caches: (per step: reference
    y, port y, reference cache, port cache, the mask)."""
    cfg, rc = _reduced(compute)
    params = _layer_params(cfg, rc, seed)
    p = f"{PFX[which]}.mix"
    params = {k.replace(f"{PFX[which]}.mix", "mix"): v
              for k, v in params.items() if k.startswith(p)}
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bfloat16" else torch.float32
    jp = {n: jnp.asarray(a, jdt) for n, a in params.items()}
    tp = {n: _t(a).to(tdt) for n, a in params.items()}
    rng = np.random.RandomState(seed + 1)
    b = 3
    spec = tmodel.layer_cache_spec(_tcfg(cfg), _trc(rc), f"{which}:none", b,
                                   16)
    cache = {n: rng.randn(*shape).astype(np.float32)
             for n, (shape, _) in spec.items()}
    cache["n"] = np.abs(cache["n"])
    tcache = {n: _t(a) for n, a in cache.items()}
    ptrs = {n: a.data_ptr() for n, a in tcache.items()}
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    jfn = jblocks.mlstm_cached if which == "mlstm" else jblocks.slstm_cached
    tfn = tblocks.mlstm_cached if which == "mlstm" else tblocks.slstm_cached
    out = []
    for s, mask in ((6, np.array([True, False, True])),
                    (1, np.array([True, True, False]))):
        x = rng.randn(b, s, cfg.d_model).astype(np.float32)
        jctx = jblocks.LayerCtx(cfg=cfg, rc=rc, rope={},
                                slot_mask=jnp.asarray(mask))
        tctx = tblocks.LayerCtx(cfg=_tcfg(cfg), rc=_trc(rc), rope={},
                                slot_mask=torch.from_numpy(mask))
        jy, jnew = jfn(jctx, jp, "mix", jnp.asarray(x, jdt), jcache, 0)
        jcache = jblocks._slot_state(jctx, jcache, jnew)
        old = {n: a.clone() for n, a in tcache.items()}
        ty, tnew = tfn(tctx, tp, "mix", _t(x).to(tdt), tcache, 0)
        tcache = tblocks._slot_state(tctx, tcache, tnew)
        for n in cache:
            assert tcache[n].data_ptr() == ptrs[n]
            keep = torch.from_numpy(~mask)
            torch.testing.assert_close(tcache[n][keep], old[n][keep],
                                       rtol=0, atol=0)
        out.append((jy, ty, {n: _f32(a) for n, a in jcache.items()},
                    {n: a.clone() for n, a in tcache.items()}, mask))
    return out


@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_cached_blocks_prefill_then_decode_under_slot_mask(which):
    """float32: the prefill then the decode step against the reference's
    cached forms, y and the stored state; masked rows keep their state,
    written in place. The incoming caches are random: the mLSTM's prefill
    ignores them (it starts from zero, as the reference's), the sLSTM's
    starts from them: a prefill from zeros gives the mLSTM the same y and
    the sLSTM another."""
    for step, (jy, ty, jc, tc, _) in enumerate(_cached_case(which,
                                                            "float32", 3)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"step {step}")
        for n in jc:
            np.testing.assert_allclose(tc[n].numpy(), jc[n], **TOL,
                                       err_msg=f"{n}, step {step}")
    cfg, rc = _reduced()
    params = _layer_params(cfg, rc, 3)
    p = f"{PFX[which]}.mix"
    tp = {k.replace(p, "mix"): _t(v) for k, v in params.items()
          if k.startswith(p)}
    spec = tmodel.layer_cache_spec(_tcfg(cfg), _trc(rc), f"{which}:none", 2,
                                   16)
    rng = np.random.RandomState(4)
    x = _t(rng.randn(2, 6, cfg.d_model).astype(np.float32))
    ctx = tblocks.LayerCtx(cfg=_tcfg(cfg), rc=_trc(rc), rope={})
    fn = tblocks.mlstm_cached if which == "mlstm" else tblocks.slstm_cached
    ys = []
    for init in ("zeros", "random"):
        cache = {n: (torch.zeros(shape) if init == "zeros" else
                     _t(np.abs(rng.randn(*shape)).astype(np.float32)))
                 for n, (shape, _) in spec.items()}
        ys.append(fn(ctx, tp, "mix", x, cache, 0)[0])
    same = torch.equal(ys[0], ys[1])
    assert same == (which == "mlstm")


@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_cached_blocks_bf16(which):
    """bfloat16: the cached forms against the reference's, y within 3
    bf16 ulps of its largest |value| and the float32 state within 1e-3
    relative (the mLSTM prefill takes ``silu(z)`` in float32 and casts,
    its decode in the compute dtype)."""
    for step, (jy, ty, jc, tc, _) in enumerate(_cached_case(which,
                                                            "bfloat16", 6)):
        assert ty.dtype == torch.bfloat16
        assert _rel(ty.float().numpy(), _f32(jy)) <= BF16_RTOL, step
        for n in jc:
            assert tc[n].dtype == torch.float32
            assert _rel(tc[n].numpy(), jc[n]) <= 1e-3, (n, step)


# --------------------------------------------------------------------------- #
# Configs, specs, caches, the one-card cuts
# --------------------------------------------------------------------------- #


def test_xlstm_configs_specs_and_caches_equal_reference():
    assert _fields(txlstm.config()) == _fields(jxlstm.config())
    (tcfg, trc), (jcfg, jrc) = txlstm.reduced(), jxlstm.reduced()
    assert _fields(tcfg) == _fields(jcfg) and _fields(trc) == _fields(jrc)
    assert [tcfg.layer_kind(i) for i in range(6)] == \
        ["mlstm:none"] * 5 + ["slstm:none"]
    run = dict(pp=1, vpp=1, microbatches=1)
    for tc, jc in ((tcfg, jcfg), (txlstm.config(), jxlstm.config())):
        tgeo = tmodel.build_geometry(tc, tcommon.RunConfig(**run))
        jgeo = jmodel.build_geometry(jc, jcommon.RunConfig(**run))
        (ts,), (js,) = tgeo.segments, jgeo.segments
        assert _fields(ts) == _fields(js)
        tspec = tmodel.stage_specs(tc, ts)
        assert {n: _fields(s) for n, s in tspec.items()} == \
            {n: _fields(s) for n, s in jmodel.stage_specs(jc, js).items()}
        assert not any(".ln2." in n or ".ffn." in n for n in tspec)
        assert {n: _fields(s) for n, s in tmodel.io_specs(tc).items()} == \
            {n: _fields(s) for n, s in jmodel.io_specs(jc).items()}
        for kind in ("mlstm:none", "slstm:none"):
            want = jmodel.layer_cache_spec(jc, jrc, kind, 8, 2048)
            got = tmodel.layer_cache_spec(tc, trc, kind, 8, 2048)
            assert {n: (tuple(a.shape), str(a.dtype))
                    for n, a in want.items()} == \
                {n: (shape, str(dt).replace("torch.", ""))
                 for n, (shape, dt) in got.items()}
    full = txlstm.config()
    specs = lambda kind: tmodel.layer_slot_specs(full, kind, "L0")  # noqa
    count = lambda sp: sum(int(np.prod(s.shape)) for s in sp.values())  # noqa
    assert count(specs("mlstm:none")) == 75_532_296
    assert count(specs("slstm:none")) == 20_981_760
    assert count(tmodel.io_specs(full)) == 206_047_232
    assert 40 * 75_532_296 + 8 * 20_981_760 + 206_047_232 == 3_395_193_152
    assert f"{3_395_193_152:,}" in txlstm.one_card_run.__doc__
    assert f"{1_800_620_192:,}" in txlstm.one_card_train_config.__doc__
    # the reduced tree from the port's own initialiser follows the specs
    p = tparams.init_all_params(tcfg, trc, torch.Generator().manual_seed(0),
                                "cpu")
    (ts,) = tmodel.build_geometry(tcfg, trc).segments
    for n, sp in tmodel.stage_specs(tcfg, ts).items():
        assert tuple(p["segments"]["main"][n].shape) == (1, *sp.shape)
    assert bool((p["segments"]["main"]["L0.mix.if_bias"] == 0).all())


def test_one_card_cuts_and_refusals():
    """Serving builds all 48 layers at full width, training the 24-layer
    cut at vpp 2 (k = 12: two sLSTM periods a stage block); no params are
    made. Paged caches and chunked prefill cannot carry the recurrent
    state and are refused."""
    s = tsession(ARCH, reduced=False, max_slots=8, max_seq=16, device="cpu")
    assert (s.cfg.n_layers, s.describe()["n_params"]) == (48, 3_395_193_152)
    t = tsession(ARCH, mode="train", reduced=False, device="cpu")
    cfg, rc = t.cfg, t.rc
    assert _fields(cfg) == dict(_fields(txlstm.config()), n_layers=24)
    assert (rc.pp, rc.vpp, rc.microbatches, rc.unit, rc.schedule) == (
        1, 2, 4, 2, "zeropp")
    assert t.describe()["n_params"] == 1_800_620_192
    (seg,) = tmodel.build_geometry(cfg, rc).segments
    assert seg.k == 12 and seg.kinds.count("slstm:none") == 2
    assert (txlstm.TRAIN_SEQ, txlstm.TRAIN_BATCH) == (2048, 8)
    for kw, match in ((dict(page_size=4), "page_size"),
                      (dict(prefill_chunk=4), "prefill_chunk")):
        sess = tsession(ARCH, device="cpu", max_slots=2, max_seq=16, **kw)
        with pytest.raises(NotImplementedError, match=match):
            sess.serve_engine(None)
    with pytest.raises(SessionError, match="not static per slot"):
        tsession(ARCH, mode="train", reduced=False, device="cpu",
                 layers=10)


# --------------------------------------------------------------------------- #
# The reduced config: train step, serve engine, CLIs
# --------------------------------------------------------------------------- #


def test_train_step_equals_reference_loss():
    """Reduced xLSTM (5 mLSTM and 1 sLSTM layer, no FFN) at one
    micro-batch of two 40-token sequences (the chunk of 128 ragged): the
    loss and every gradient against
    ``jax.value_and_grad(reference_loss)``; the scans counted as run."""
    cfg, rc = jget_arch(ARCH).reduced()
    ov = dict(pp=1, vpp=1, microbatches=1, unit=1, schedule="zeropp")
    rc = dataclasses.replace(rc, **ov)
    jp = jax.tree.map(np.asarray, jmodel.init_all_params(
        cfg, rc, jax.random.PRNGKey(0)))
    ts = tsession(ARCH, mode="train", seq_len=40, global_batch=2,
                  device="cpu", overrides=ov)
    batch = ts.stream(seed=3).batch(0)
    tokens, labels = (np.asarray(batch[k]) for k in ("tokens", "labels"))
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.reference_loss(cfg, rc, p, tokens, labels)))(jp)
    tp = tparams.from_reference(jp, device="cpu")
    before = ops.kernel_counters()
    grads, m = ts.train_step(tp, batch)
    got = float(m["loss_sum"])
    assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want))
    n = 0
    for path, w in _leaves(jax.tree.map(np.asarray, jgrads)):
        g = _get(grads, path)
        assert g.dtype == torch.float32
        assert float(np.abs(w).max()) > 0, path
        assert _rel(g.numpy(), w) <= GRAD_RTOL, path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))
    after = ops.kernel_counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    # F and B's recompute over 5 mLSTM and 1 sLSTM layer, one backward
    assert delta == {"mlstm_chunkwise": 10, "ref_slstm": 2,
                     "ref_slstm_bwd": 1, "ref_xent": 1}
    ref = float(tmodel.reference_loss(ts.cfg, ts.rc, tp,
                                      torch.from_numpy(tokens),
                                      torch.from_numpy(labels)))
    assert abs(ref - float(want)) <= LOSS_RTOL * abs(float(want))


COMMON = dict(max_slots=4, max_seq=32, overrides=dict(pp=1, microbatches=1))


def _workload():
    """Six requests over four slots (reclaim), prompts of 5 or 9 tokens."""
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 256, size=p).astype(np.int32), g)
            for p, g in [(5, 4), (9, 6), (5, 3), (9, 5), (5, 2), (9, 6)]]


def _serve(sess, params):
    eng = sess.serve_engine(params)
    reqs = [eng.submit(t, max_gen=g) for t, g in _workload()]
    eng.run_until_idle()
    return [r.result(timeout=5) for r in reqs], eng.stats


def test_engine_streams_and_logits_equal_reference():
    js = jsession(ARCH, mode="serve", data=1, **COMMON)
    jparams = js.init_params(jax.random.PRNGKey(0))
    ts = tsession(ARCH, device="cpu", **COMMON)
    tp = tparams.from_reference(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    launches = dict(sl.LAUNCHES)
    want, jstats = _serve(js, jparams)
    got, tstats = _serve(ts, tp)
    assert got == want
    assert [len(t) for t in got] == [g for _, g in _workload()]
    assert (tstats.prefill_steps, tstats.decode_steps) == \
        (jstats.prefill_steps, jstats.decode_steps)
    counters = ts.describe()["kernels"]["counters"]
    steps = tstats.prefill_steps + tstats.decode_steps
    assert counters["mlstm_chunkwise"] == 5 * tstats.prefill_steps
    assert counters["mlstm_step"] == 5 * tstats.decode_steps
    assert counters["ref_slstm"] == steps
    assert not [k for k in counters if k.startswith("kernel_")]
    assert sl.LAUNCHES == launches

    # one batched prefill with full logits on fresh caches: staggered
    # per-slot positions, one masked slot
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(0, 256, size=(4, 5)).astype(np.int32),
             "pos": np.array([0, 4, 0, 9], np.int32),
             "slot_mask": np.array([True, True, False, True])}
    jtok, jlog, jc = js.serve_step_batched(jparams, js.init_caches(), batch,
                                           want_logits=True)
    ttok, tlog, tc = ts.serve_step_batched(tp, ts.init_caches(), batch,
                                           want_logits=True)
    np.testing.assert_allclose(np.asarray(tlog), np.asarray(jlog), atol=ATOL)
    np.testing.assert_array_equal(np.asarray(ttok), np.asarray(jtok))
    for name in ("L0.C", "L0.n", "L0.m", "L5.c", "L5.n", "L5.m"):
        np.testing.assert_allclose(tc["main"][name].numpy(),
                                   np.asarray(jc["main"][name]), **TOL,
                                   err_msg=name)


def test_cli_train_and_serve_at_device_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                     "--seq", "8", "--microbatches", "2"])
        tserve.main(["--arch", ARCH, "--device", "cpu", "--slots", "2",
                     "--n-requests", "3", "--prompt", "5", "--gen", "3"])
    out = buf.getvalue()
    assert "TRAIN_OK steps=2" in out and "ref_slstm_bwd" in out, out
    assert "SERVE_OK" in out and "mlstm_step" in out, out
    with pytest.raises(SystemExit, match="page_size"):
        tserve.main(["--arch", ARCH, "--device", "cpu", "--page-size", "4"])
