"""The Jamba training slice: repro_torch against repro on the same inputs.

* the plain selective-scan backward (``ref.selective_scan_bwd``) against
  ``jax.vjp`` of the reference's jnp scan, s a multiple of the chunk or
  not, d_state 4 and 16;
* the tape's ``apply_mamba`` and ``apply_moe`` in mode ``bwd`` against
  the reference blocks on the reference tape (``jax.vjp`` inside its
  prims): outputs, the input cotangent, the immediate grads, the W
  stash's grads and the router's aux, with a capacity small enough that
  picks drop, and ``apply_moe`` with one shared FFN;
* one reduced-Jamba train step at one micro-batch against
  ``jax.value_and_grad(reference_loss)`` (loss + weight * aux, every
  grad), and at two micro-batches, 4 layers, vpp 2 against the JAX
  ``make_train_step`` on one device (there the aux and the capacity are
  per micro-batch);
* the scheduler's ``MoECapacity`` admission bound against the
  reference's over a grid, the engine's default MoE policy, the train
  cut at full width, the CLI.

Params come from ``repro.models.model.init_all_params`` and cross in one
process (``params.from_reference``); inputs are numpy arrays from a seed.
Tolerances, all float32: the scan backward and the blocks within 1e-5 of
the largest |reference| of each tensor (the same products summed in
another order: the reference scans with ``associative_scan``, the port in
doubling steps and a written-out reverse walk); the train steps' loss
within 1e-5 relative, every gradient within 1e-4 of its largest
|reference|, as ``tests/test_torch_train.py`` holds llama's step.
``tests/test_torch_cuda.py`` holds K5b to the plain version on a GPU.
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
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.core import tape as jtape  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import jamba_v0p1_52b as tjamba  # noqa: E402
from repro_torch.core import tape as ttape  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

ARCH = "jamba-v0.1-52b"
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


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------- #
# (a) the plain scan backward against jax.vjp
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("s,n", [(16, 4), (13, 4), (16, 16), (21, 16)])
def test_scan_bwd_equals_jax_vjp(s, n):
    """s = 16 fills two chunks of 8; 13 and 21 end in a part chunk."""
    rng = np.random.RandomState(s + n)
    b, d, chunk = 2, 6, 8
    x, dy = rng.randn(b, s, d), rng.randn(b, s, d)
    dt = np.log1p(np.exp(rng.randn(b, s, d) - 1.0))
    A = -np.exp(0.5 * rng.randn(d, n))
    B, C, D = rng.randn(b, s, n), rng.randn(b, s, n), rng.randn(d)
    args = [a.astype(np.float32) for a in (x, dt, A, B, C, D)]
    want = jax.jit(lambda dy_, *a: jax.vjp(
        lambda *b_: jref.selective_scan(*b_, chunk=chunk), *a)[1](dy_))(
        dy.astype(np.float32), *args)
    got = tref.selective_scan_bwd(
        *(torch.from_numpy(a) for a in args),
        torch.from_numpy(dy.astype(np.float32)), chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= BLOCK_RTOL, name
    # the differentiable op takes the plain backward on the CPU (its own
    # chunk of 256)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    before = ops.kernel_counters().get("ref_scan_bwd", 0)
    y = ops.selective_scan_train(*ts)
    grads = torch.autograd.grad(y, ts, torch.from_numpy(dy.astype(
        np.float32)))
    assert ops.kernel_counters()["ref_scan_bwd"] == before + 1
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads,
                          want):
        assert _rel(g.numpy(), w) <= BLOCK_RTOL, name


# --------------------------------------------------------------------------- #
# (b) the tape blocks against the reference blocks
# --------------------------------------------------------------------------- #


def _layer_params(cfg, rc, seed):
    """One stage block's params from the reference initialiser (numpy)."""
    jp = jmodel.init_all_params(cfg, rc, jax.random.PRNGKey(seed))
    return {n: np.asarray(a[0])
            for n, a in jp["segments"]["main"].items()}


def _block(tape, blocks, ctx, which, arr, x, dy, aux_seed, dw_of):
    xv = tape.value(arr(x))
    if which == "mamba":
        y, aux = blocks.apply_mamba(tape, ctx, "L0.mix", xv), None
    else:
        y, aux = blocks.apply_moe(tape, ctx, "L1.ffn", xv)
    seeds = {y.idx: arr(dy)}
    if aux is not None:
        seeds[aux.idx] = arr(np.asarray(aux_seed, np.float32))
    cot, ig, ws = tape.backward(seeds)
    return (y.val, None if aux is None else aux.val, cot[xv.idx], ig,
            dw_of(ws))


def _run_block(which, cfg, rc, params, x, dy, aux_seed):
    """(reference, port) results of one block in mode bwd: (y, aux,
    input cotangent, immediate grads, W-stash grads); the reference's
    under ``jax.jit``."""
    def jfn(p, xx, yy):
        return _block(jtape.Tape(p, mode="bwd"), jblocks,
                      jblocks.LayerCtx(cfg=cfg, rc=rc, rope={}), which,
                      jnp.asarray, xx, yy, aux_seed, jtape.compute_dw)

    want = jax.jit(jfn)({k: jnp.asarray(v) for k, v in params.items()},
                        x, dy)
    tt = ttape.Tape({k: torch.from_numpy(v.copy())
                     for k, v in params.items()}, mode="bwd")
    got = _block(tt, tblocks, tblocks.LayerCtx(cfg=_tcfg(cfg), rc=_trc(rc),
                                               rope={}),
                 which, torch.from_numpy, x, dy, aux_seed, ttape.compute_dw)
    return want, got


def _tcfg(cfg):
    return tcommon.ModelConfig(**{
        f.name: (getattr(tcommon, type(v).__name__)(**dataclasses.asdict(v))
                 if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(cfg)
        for v in (getattr(cfg, f.name),)})


def _trc(rc):
    return tcommon.RunConfig(**dataclasses.asdict(rc))


@pytest.mark.parametrize("which,cf", [("mamba", None), ("moe", 8.0),
                                      ("moe", 0.5)])
def test_tape_blocks_equal_reference_blocks(which, cf):
    """Capacity factor 0.5 drops picks (asserted); 8.0, the reduced
    config's, drops none."""
    cfg, rc = jget_arch(ARCH).reduced()
    if cf is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    params = _layer_params(cfg, rc, seed=2)
    rng = np.random.RandomState(5)
    b, s = 2, 16
    x = rng.randn(b, s, cfg.d_model).astype(np.float32)
    dy = rng.randn(b, s, cfg.d_model).astype(np.float32)
    (jy, jaux, jdx, jig, jdw), (ty, taux, tdx, tig, tdw) = _run_block(
        which, cfg, rc, params, x, dy, aux_seed=0.3)
    assert _rel(ty.numpy(), jy) <= BLOCK_RTOL
    assert _rel(tdx.numpy(), jdx) <= BLOCK_RTOL
    if which == "moe":
        assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
        logits = (torch.from_numpy(x).reshape(b * s, -1)
                  @ torch.from_numpy(params["L1.ffn.router"].copy()))
        cap = tblocks._capacity(b * s, cfg.moe)
        _, _, slot = tblocks._route(logits, cfg.moe, cap)
        dropped = int((slot == cap).sum())
        assert (dropped > 0) == (cf < 1.0), dropped
    # the Mamba mixer's conv and SSM params are immediate; every MoE
    # param is a dense node's (the router, the expert banks)
    assert set(tig) == set(jig) and bool(tig) == (which == "mamba")
    assert set(tdw) == set(jdw) and tdw
    for n in jig:
        assert _rel(tig[n].numpy(), jig[n]) <= BLOCK_RTOL, n
    for n in jdw:
        assert _rel(tdw[n].numpy(), jdw[n]) <= BLOCK_RTOL, n


def test_tape_moe_refuses_shared_experts():
    """Shared experts train: reduced Jamba's MoE layer with one shared
    FFN (of 2 x d_ff_expert, the width the specs derive) on the tape in
    mode bwd against the reference block: y, aux, dx and every dW, the
    shared banks' among them."""
    cfg, rc = jget_arch(ARCH).reduced()
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_shared=1))
    params = _layer_params(cfg, rc, seed=2)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    dy = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    (jy, jaux, jdx, _, jdw), (ty, taux, tdx, _, tdw) = _run_block(
        "moe", cfg, rc, params, x, dy, aux_seed=0.3)
    assert _rel(ty.numpy(), jy) <= BLOCK_RTOL
    assert _rel(tdx.numpy(), jdx) <= BLOCK_RTOL
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert {"L1.ffn.s_wg", "L1.ffn.s_wu", "L1.ffn.s_wd"} <= set(tdw)
    assert set(tdw) == set(jdw)
    for n in jdw:
        assert _rel(tdw[n].numpy(), jdw[n]) <= BLOCK_RTOL, n


def test_counting_drops_counts_forward_routing_only():
    """``counting_drops`` sums the fwd-mode routing calls' picks and
    dropped picks (capacity factor 0.5 drops some); a bwd-mode tape (B's
    recompute) adds nothing."""
    cfg, rc = jget_arch(ARCH).reduced()
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    params = {k: torch.from_numpy(v.copy())
              for k, v in _layer_params(cfg, rc, seed=2).items()}
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, 16, cfg.d_model).astype(np.float32))
    ctx = tblocks.LayerCtx(cfg=_tcfg(cfg), rc=_trc(rc), rope={})
    cap = tblocks._capacity(32, cfg.moe)
    _, _, slot = tblocks._route(x.reshape(32, -1) @ params["L1.ffn.router"],
                                cfg.moe, cap)
    with tblocks.counting_drops() as box:
        for mode in ("fwd", "bwd", "fwd"):
            t = ttape.Tape(params, mode=mode)
            tblocks.apply_moe(t, ctx, "L1.ffn", t.value(x))
    assert box["picks"] == 2 * slot.numel()
    assert box["dropped"] == 2 * int((slot == cap).sum()) > 0


def test_tape_prim_zero_fills_a_missing_cotangent():
    """A two-output prim whose second output gets no cotangent: B takes
    zeros for it, as the reference's tape does."""
    t = ttape.Tape({}, mode="bwd")
    x = t.value(torch.tensor([1.0, 2.0]))
    a, b = t.prim(lambda v: (v * 3.0, v.sum() * 5.0), x, n_out=2)
    s = t.prim(lambda u, v: u + v, a, a)
    cot, _, _ = t.backward({s.idx: torch.ones(2)})
    assert torch.equal(cot[x.idx], torch.full((2,), 6.0))
    assert b.val.item() == 15.0


# --------------------------------------------------------------------------- #
# (c), (d) whole train steps
# --------------------------------------------------------------------------- #


def _check_grads(tgrads, jgrads):
    n = 0
    for path, w in _leaves(jax.tree.map(np.asarray, jgrads)):
        g = _get(tgrads, path)
        assert g.dtype == torch.float32
        assert float(np.abs(w).max()) > 0, path
        assert _rel(g.numpy(), w) <= GRAD_RTOL, path
        n += 1
    assert n == sum(1 for _ in _leaves(tgrads))


def test_train_step_one_microbatch_equals_reference_loss():
    """Reduced Jamba (8 layers: Mamba, attention and MoE) at one
    micro-batch: loss + router_aux_weight * aux_sum and every gradient
    against ``jax.value_and_grad(reference_loss)``."""
    cfg, rc = jget_arch(ARCH).reduced()
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
    _check_grads(grads, jgrads)
    # the last step in describe(); the scans of F and B's recompute over 7
    # Mamba layers, one backward each
    d = ts.describe()
    assert d["last_step"]["aux_sum"] == aux
    assert d["last_step"]["loss_sum"] == float(m["loss_sum"])
    counters = d["kernels"]["counters"]
    assert counters["ref_scan"] == 14 and counters["ref_scan_bwd"] == 7
    # the port's own single-device loss
    ref = float(tmodel.reference_loss(ts.cfg, ts.rc, tp,
                                      torch.from_numpy(tokens),
                                      torch.from_numpy(labels)))
    assert abs(ref - float(want)) <= LOSS_RTOL * abs(float(want))


def test_train_step_microbatched_equals_jax_pipeline():
    """4 layers (Mamba, dense and MoE FFNs), vpp 2, two micro-batches in
    one unit: loss, aux_sum and every gradient against the JAX
    ``make_train_step`` on one device (aux and capacity per
    micro-batch)."""
    ov = dict(pp=1, vpp=2, microbatches=2, unit=2, schedule="zeropp")
    # the reference session has no depth cut: build its runtime on the
    # session's one-device mesh (the 8-layer session at vpp 1)
    js = jsession(ARCH, mode="train", seq_len=16, data=1,
                  overrides=dict(ov, vpp=1))
    cfg = dataclasses.replace(js.cfg, n_layers=4)
    rc = dataclasses.replace(js.rc, vpp=2)
    rt = jpipeline.Runtime(cfg, rc, js.rt.mesh)
    jp = jmodel.init_all_params(cfg, rc, jax.random.PRNGKey(1))
    batch = js.stream(seed=4).batch(0)
    jg, jm = jax.jit(jpipeline.make_train_step(rt, js.shape_cfg))(jp, batch)
    ts = tsession(ARCH, mode="train", seq_len=16, device="cpu", layers=4,
                  overrides=ov)
    assert ts.describe()["schedule"]["ticks"] == rt.tables["main"].T
    tp = tparams.from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    tg, tm = ts.train_step(tp, batch)
    for k in ("loss_sum", "aux_sum"):
        want = float(jm[k])
        assert abs(float(tm[k]) - want) <= LOSS_RTOL * abs(want), k
    _check_grads(tg, jg)


def test_train_cut_at_full_width_and_cli():
    """The card's train cut (no params made): published widths, 2 layers,
    8 experts, vpp 1; the reduced config trains through the CLI."""
    s = tsession(ARCH, mode="train", reduced=False, device="cpu")
    cfg, rc = s.cfg, s.rc
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (
        2, 4096, 14336, 65536)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.moe.capacity_factor) == (8, 2, 14336, 1.25)
    assert (cfg.mamba.d_state, cfg.mamba.d_conv, cfg.mamba.expand) == (
        16, 4, 2) and not cfg.tie_embeddings
    assert (rc.pp, rc.vpp, rc.microbatches, rc.unit, rc.schedule) == (
        1, 1, 4, 2, "zeropp")
    assert s.describe()["n_params"] == 2_332_987_392
    assert (tjamba.TRAIN_SEQ, tjamba.TRAIN_BATCH) == (4096, 4)
    with pytest.raises(SessionError, match="not static per slot"):
        tsession(ARCH, mode="train", reduced=False, device="cpu",
                 overrides=dict(vpp=2))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                      "--seq", "8", "--microbatches", "2"])
    out = buf.getvalue()
    assert "TRAIN_OK steps=2" in out and "ref_scan_bwd" in out, out


# --------------------------------------------------------------------------- #
# MoECapacity
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("experts,top_k", [(4, 2), (8, 2), (16, 2), (8, 1),
                                           (64, 6)])
def test_moe_capacity_equals_reference(experts, top_k):
    """``fits`` and ``max_admissible`` over capacity factors, skews and
    slot counts, against the reference's ``MoECapacity``."""
    for cf in (0.5, 1.0, 1.25, 2.0):
        for skew in (0.0, 1.0, 1.5, 2.0, 3.0, 8.0):
            kw = dict(n_experts=experts, top_k=top_k, capacity_factor=cf,
                      skew=skew)
            j, t = jsched.MoECapacity(**kw), tsched.MoECapacity(**kw)
            assert [t.fits(n) for n in range(0, 130)] == \
                [j.fits(n) for n in range(0, 130)], kw
            for slots in (1, 2, 4, 8, 16, 64):
                assert t.max_admissible(slots) == j.max_admissible(slots)


def test_scheduler_defers_as_reference():
    """A tight bound (skew 8: at most one co-resident decode) over eight
    slots: the port's scheduler admits, defers and counts deferrals tick
    by tick as the reference's; the engines' default policy for a MoE
    model is the reference's."""
    from repro.serving.slots import SlotPool as JPool
    from repro_torch.serving.slots import SlotPool as TPool

    kw = dict(n_experts=4, top_k=2, capacity_factor=1.0, skew=8.0)
    runs = []
    for sched, Pool in ((jsched, JPool), (tsched, TPool)):
        s = sched.RequestScheduler(sched.SchedulerPolicy(
            max_prefills_per_tick=3,
            moe_capacity=sched.MoECapacity(**kw)))
        pool = Pool(8, 64)
        for i in range(6):
            s.submit(sched.Request(np.arange(3 + i, dtype=np.int32),
                                   max_gen=2))
        ticks = []
        for tick in range(8):
            admitted, rejected = s.admit(pool)
            ticks.append(([r.slot for r in admitted], len(rejected),
                          s.capacity_deferrals))
            if tick % 2 and pool.n_active:         # a request finishes
                pool.release(next(v.index for v in pool.slots
                                  if not v.free))
        runs.append(ticks)
    assert runs[0] == runs[1]
    assert runs[1][-1][2] > 0
    cfg, _ = jget_arch(ARCH).reduced()
    want = jsched.MoECapacity.from_moe_cfg(cfg.moe)
    got = tsched.MoECapacity.from_moe_cfg(_tcfg(cfg).moe)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
