"""The Jamba serving slice: repro_torch against repro on the same inputs.

The same numpy inputs go through the JAX package and the port: the
selective scan's plain version (against ``repro.kernels.ref`` and, where
it applies, the Pallas kernel in interpret mode), one SSM decode step,
the cached Mamba layer (prefill, then decode, under a slot mask), the
gathered MoE FFN (with capacity drops and ties), the configs and param
specs, and the reduced Jamba ``ServeEngine`` with the reference's params
carried across by ``params.from_reference`` in the same process.

Tolerances, all float32: the scan, the scan step and the Mamba layer
within 1e-5 absolute plus 1e-5 relative (the reference scans each chunk
with ``associative_scan``, the port in doubling steps: the same products
and sums in another order); the MoE FFN and the engine's logits within
1e-4 absolute (float32 matmuls summed in another order over 8 layers;
logits are O(1)); routing and greedy token streams exactly.
``tests/test_torch_cuda.py`` holds the CUDA kernels to these plain
versions on a GPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, leaving the cores to the other test
# workers (eight spinning OpenMP threads per worker oversubscribe them)
torch.set_num_threads(1)

from repro.api import session as jsession  # noqa: E402
from repro.configs import jamba_v0p1_52b as jjamba  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.selective_scan import (  # noqa: E402
    selective_scan as pallas_scan,
)
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import jamba_v0p1_52b as tjamba  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.params import from_reference, init_all_params  # noqa: E402

SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4
ARCH = "jamba-v0.1-52b"


def _t(x):
    return torch.from_numpy(np.array(x))


def _fields(obj):
    return dataclasses.asdict(obj)


# --------------------------------------------------------------------------- #
# Selective scan: the plain version and the decode step
# --------------------------------------------------------------------------- #


def _scan_inputs(seed, b, s, d, n):
    """Mamba-like values: dt = softplus(N(-1, 1)), A = -exp(N(0, 0.5))."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, d)
    dt = np.log1p(np.exp(rng.randn(b, s, d) - 1.0))
    A = -np.exp(0.5 * rng.randn(d, n))
    B, C = rng.randn(b, s, n), rng.randn(b, s, n)
    D, h0 = rng.randn(d), rng.randn(b, d, n)
    return [a.astype(np.float32) for a in (x, dt, A, B, C, D, h0)]


@pytest.mark.parametrize("s,chunk,with_h0,state", [
    (37, 16, True, True),      # s not a multiple of the chunk
    (37, 16, False, False),
    (32, 16, True, False),
    (32, 8, False, True),
])
def test_scan_plain_matches_jax_ref(s, chunk, with_h0, state):
    x, dt, A, B, C, D, h0 = _scan_inputs(1, 2, s, 24, 4)
    h0 = h0 if with_h0 else None
    kw = dict(chunk=chunk, return_state=state)
    want = jref.selective_scan(*map(jnp.asarray, (x, dt, A, B, C, D)),
                               h0=None if h0 is None else jnp.asarray(h0),
                               **kw)
    got = tref.selective_scan(*map(_t, (x, dt, A, B, C, D)),
                              h0=None if h0 is None else _t(h0), **kw)
    if state:
        (want, wh), (got, gh) = want, got
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **SCAN_TOL)
        assert gh.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    # the dispatch on CPU tensors: the plain version, counted as such
    before = ops.kernel_counters().get("ref_scan", 0)
    again = ops.selective_scan(*map(_t, (x, dt, A, B, C, D)),
                               h0=None if h0 is None else _t(h0), **kw)
    assert ops.kernel_counters()["ref_scan"] == before + 1
    torch.testing.assert_close(again[0] if state else again,
                               got, rtol=0, atol=0)


def test_scan_plain_matches_pallas_interpret():
    """Where the Pallas kernel applies (no h0, no state out): ragged s
    and d against its chunk and channel blocks."""
    x, dt, A, B, C, D, _ = _scan_inputs(2, 2, 21, 24, 4)
    want = pallas_scan(*map(jnp.asarray, (x, dt, A, B, C, D)), chunk=8,
                       block_d=16, interpret=True)
    got = tref.selective_scan(*map(_t, (x, dt, A, B, C, D)), chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


def test_scan_step_matches_jax_and_chains_to_the_scan():
    x, dt, A, B, C, D, h0 = _scan_inputs(3, 3, 5, 24, 4)
    jh, jy = jref.selective_scan_step(
        *map(jnp.asarray, (h0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)))
    th, ty = ops.selective_scan_step(
        *map(_t, (h0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    # five steps one at a time equal the chunked scan from the same h0
    h, ys = _t(h0), []
    for i in range(5):
        h, y = ops.selective_scan_step(h, _t(x[:, i]), _t(dt[:, i]), _t(A),
                                       _t(B[:, i]), _t(C[:, i]), _t(D))
        ys.append(y)
    y_all, h_all = tref.selective_scan(*map(_t, (x, dt, A, B, C, D)),
                                       chunk=4, h0=_t(h0), return_state=True)
    torch.testing.assert_close(torch.stack(ys, 1), y_all, **SCAN_TOL)
    torch.testing.assert_close(h, h_all, **SCAN_TOL)


# K5 on the card (csrc/selective_scan.cu) is held to the plain version at
# 1e-5 of the plain tensor's max |value| (chip_smoke.py SCAN_RTOL)
K5_RTOL = 1e-5


def _fma(a, b, c):
    """float32 fma: the float64 product of two float32 values is exact,
    so one rounding of the float64 sum to float32 gives it."""
    return (a.double() * b.double() + c.double()).float()


def _k5_emulate(x, dt, A, B, C, D, h0, lanes):
    """K5's order of operations in float32: A' = A log2(e) rounded once;
    each step dx = dt x once, then per state a = 2^(dt A'), h = fma(a, h,
    dx B); each of the ``lanes`` lanes sums h C over its N / lanes states
    (fma, in state order), the lanes' partials meet in xor-shuffle order
    (pairs of neighbours, then pairs of pairs) and y = fma(x, D, acc).
    exp2 is the correctly rounded one here; the card's ex2.approx is
    within 2 ulp of it."""
    b, s, d = x.shape
    n = A.shape[1]
    a2 = A * torch.tensor(np.log2(np.e), dtype=torch.float32)
    h = h0.clone() if h0 is not None else torch.zeros(b, d, n)
    ys = []
    for t in range(s):
        dv, xv = dt[:, t, :, None], x[:, t]
        dx = dt[:, t] * xv
        a = torch.exp2(dv * a2[None])
        h = _fma(a, h, dx[..., None] * B[:, t, None, :])
        prod = h * C[:, t, None, :]
        parts = []
        for j in range(lanes):
            lo, hi = j * n // lanes, (j + 1) * n // lanes
            acc = prod[..., lo]
            for k in range(lo + 1, hi):
                acc = _fma(h[..., k], C[:, t, None, k], acc)
            parts.append(acc)
        while len(parts) > 1:
            parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
        ys.append(_fma(xv, D[None], parts[0]))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("n", [8, 16])
def test_k5_order_of_operations_holds_the_card_rule(n):
    """The kernel's order of operations (states split over n / 4 lanes,
    A log2(e) formed once, dt x once a step) stays within half of the
    card's rule (1e-5 of max |plain|) of the port's plain version and of
    the JAX reference, on Mamba-like inputs with long memory (dt
    log-uniform in [1e-3, 1e-1], A = -(1..n) scaled) and an initial
    state."""
    rng = np.random.RandomState(40 + n)
    b, s, d = 2, 96, 16
    x = rng.randn(b, s, d)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(b, s, d)))
    A = -np.arange(1, n + 1)[None] * np.exp(0.1 * rng.randn(d, n))
    B, C = rng.randn(b, s, n), rng.randn(b, s, n)
    D, h0 = rng.randn(d), rng.randn(b, d, n)
    arrs = [a.astype(np.float32) for a in (x, dt, A, B, C, D, h0)]
    y, h = _k5_emulate(*map(_t, arrs), lanes=n // 4)
    want = tref.selective_scan(*map(_t, arrs[:6]), h0=_t(arrs[6]),
                               return_state=True)
    jwant = jref.selective_scan(*map(jnp.asarray, arrs[:6]),
                                h0=jnp.asarray(arrs[6]), return_state=True)
    for wy, wh in (want, tuple(map(_t, jwant))):
        for got, w in ((y, wy), (h, wh)):
            err = (got - w).abs().max().item()
            assert err <= 0.5 * K5_RTOL * w.abs().max().item(), err


def test_cpu_dispatch_runs_plain_versions_only():
    """CPU tensors never reach a kernel: the wrapper takes its plain
    version, and ``impl='kernel'`` on a CPU tensor raises."""
    x, dt, A, B, C, D, _ = _scan_inputs(4, 1, 6, 8, 4)
    args = list(map(_t, (x, dt, A, B, C, D)))
    before = dict(ss.LAUNCHES)
    torch.testing.assert_close(ss.selective_scan(*args),
                               tref.selective_scan(*args), rtol=0, atol=0)
    assert ss.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.selective_scan(*args, impl="kernel")


# --------------------------------------------------------------------------- #
# The cached Mamba layer and the gathered MoE FFN
# --------------------------------------------------------------------------- #


DM, NS = 32, 4           # d_model, d_state; di = 64, dt_rank = 2
RC = dict(pp=1, vpp=1, microbatches=1, param_dtype="float32",
          compute_dtype="float32")


def _cfgs(**kw):
    base = dict(name="tiny", n_layers=1, d_model=DM, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab=64, d_head=8)
    base.update(kw)
    jkw, tkw = dict(base), dict(base)
    if "mamba" in kw:
        jkw["mamba"] = jcommon.MambaCfg(**kw["mamba"])
        tkw["mamba"] = tcommon.MambaCfg(**kw["mamba"])
    if "moe" in kw:
        jkw["moe"] = jcommon.MoECfg(**kw["moe"])
        tkw["moe"] = tcommon.MoECfg(**kw["moe"])
    return jcommon.ModelConfig(**jkw), tcommon.ModelConfig(**tkw)


def _ctxs(jcfg, tcfg, mask):
    jctx = jblocks.LayerCtx(cfg=jcfg, rc=jcommon.RunConfig(**RC), rope={},
                            slot_mask=jnp.asarray(mask))
    tctx = tblocks.LayerCtx(cfg=tcfg, rc=tcommon.RunConfig(**RC), rope={},
                            slot_mask=torch.from_numpy(mask))
    return jctx, tctx


def _mamba_params(rng, cfg):
    specs = jblocks.mamba_specs(cfg, "mix")
    out = {n: (rng.randn(*sp.shape) / np.sqrt(sp.shape[0]))
           for n, sp in specs.items()}
    out["mix.A_log"] = np.log(rng.uniform(1, 8, size=specs["mix.A_log"].shape))
    out["mix.dt_bias"] = rng.uniform(-3, -1, size=specs["mix.dt_bias"].shape)
    return {n: a.astype(np.float32) for n, a in out.items()}


def test_mamba_cached_prefill_then_decode_under_slot_mask():
    """Prefill of 6 tokens (the scan, state out) then one decode step.
    The incoming caches are random: prefill ignores them (zero conv
    padding, h0 = 0), but masked rows must keep theirs through both
    steps; the port writes the new state into the leaves in place."""
    jcfg, tcfg = _cfgs(mamba=dict(d_state=NS, d_conv=4, expand=2))
    rng = np.random.RandomState(5)
    params = _mamba_params(rng, jcfg)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: _t(a) for n, a in params.items()}
    b, di = 3, 2 * DM
    cache = {"conv": rng.randn(b, 3, di).astype(np.float32),
             "h": rng.randn(b, di, NS).astype(np.float32)}
    tcache = {n: _t(a) for n, a in cache.items()}
    leaves = {n: a.data_ptr() for n, a in tcache.items()}
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    for step, (s, mask) in enumerate([(6, np.array([True, False, True])),
                                      (1, np.array([True, True, False]))]):
        x = rng.randn(b, s, DM).astype(np.float32)
        jctx, tctx = _ctxs(jcfg, tcfg, mask)
        jy, jnew = jblocks.mamba_cached(jctx, jp, "mix", jnp.asarray(x),
                                        jcache, 0)
        jcache = jblocks._slot_state(jctx, jcache, jnew)
        old = {n: a.clone() for n, a in tcache.items()}
        ty, tnew = tblocks.mamba_cached(tctx, tp, "mix", _t(x), tcache, 0)
        tcache = tblocks._slot_state(tctx, tcache, tnew)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL,
                                   err_msg=f"step {step}")
        for n in cache:
            assert tcache[n].data_ptr() == leaves[n]
            np.testing.assert_allclose(tcache[n].numpy(),
                                       np.asarray(jcache[n]), **SCAN_TOL,
                                       err_msg=f"{n}, step {step}")
            keep = torch.from_numpy(~mask)
            torch.testing.assert_close(tcache[n][keep], old[n][keep],
                                       rtol=0, atol=0)
    # a prefill shorter than the conv state is refused, not mis-shaped
    jctx, tctx = _ctxs(jcfg, tcfg, np.ones(b, bool))
    with pytest.raises(ValueError, match="conv state"):
        tblocks.mamba_cached(tctx, tp, "mix", torch.zeros(b, 2, DM),
                             tcache, 0)


@pytest.mark.parametrize("case", ["drops", "no_drops", "ties"])
def test_moe_fwd_matches_jax(case):
    """Gathered top-2 of 4 experts over 4 rows of 8 tokens, rows 0 and 2
    masked. 'drops': capacity factor 0.5 (capacity 16 for 64 picks), so
    hot experts drop picks and the masked rows, routed first, take
    capacity from the live rows; 'ties': a zero router gives every
    expert the same probability, and both take experts 0 and 1."""
    cf = 0.5 if case == "drops" else 8.0
    jcfg, tcfg = _cfgs(moe=dict(n_experts=4, top_k=2, d_ff_expert=32,
                                capacity_factor=cf))
    rng = np.random.RandomState(6)
    specs = jblocks.moe_specs(jcfg, "ffn")
    params = {n: (rng.randn(*sp.shape) / np.sqrt(sp.shape[-2])).astype(
        np.float32) for n, sp in specs.items()}
    if case == "ties":
        params["ffn.router"][:] = 0.0
    else:
        params["ffn.router"] *= 8.0        # skewed routing
    mask = np.array([False, True, False, True])
    x = rng.randn(4, 8, DM).astype(np.float32)
    jctx, tctx = _ctxs(jcfg, tcfg, mask)
    want = jblocks.moe_fwd(jctx, {n: jnp.asarray(a) for n, a in
                                  params.items()}, "ffn", jnp.asarray(x))
    tp = {n: _t(a) for n, a in params.items()}
    got = tblocks.moe_fwd(tctx, tp, "ffn", _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    cap = tblocks._capacity(32, tcfg.moe)
    logits = (_t(x).reshape(32, DM) @ tp["ffn.router"])
    _, topi, slot = tblocks._route(logits, tcfg.moe, cap)
    n_dropped = int((slot == cap).sum())
    assert (n_dropped > 0) == (case == "drops")
    if case == "ties":
        assert (topi == torch.tensor([0, 1])).all()
    if case == "drops":
        # the live rows lose picks to the masked rows routed before them:
        # alone (capacity 8 for their 32 picks) they come out otherwise
        live = tblocks.moe_fwd(tctx, tp, "ffn", _t(x[mask]))
        assert not torch.allclose(live, got[torch.from_numpy(mask)],
                                  atol=ATOL)


# --------------------------------------------------------------------------- #
# Configs, param specs, caches
# --------------------------------------------------------------------------- #


def test_jamba_configs_and_specs_equal_reference():
    assert _fields(tjamba.config()) == _fields(jjamba.config())
    (tcfg, trc), (jcfg, jrc) = tjamba.reduced(), jjamba.reduced()
    assert _fields(tcfg) == _fields(jcfg) and _fields(trc) == _fields(jrc)
    one = tjamba.one_card_config()
    assert _fields(one) == dict(_fields(tjamba.config()), n_layers=8)
    kinds = [one.layer_kind(i) for i in range(8)]
    assert kinds == ["mamba:dense", "mamba:moe", "mamba:dense", "mamba:moe",
                     "attn:dense", "mamba:moe", "mamba:dense", "mamba:moe"]
    run = dict(pp=1, vpp=1, microbatches=1)
    for tc, jc in ((tcfg, jcfg), (one, dataclasses.replace(
            jjamba.config(), n_layers=8))):
        tgeo = tmodel.build_geometry(tc, tcommon.RunConfig(**run))
        jgeo = jmodel.build_geometry(jc, jcommon.RunConfig(**run))
        (ts,), (js,) = tgeo.segments, jgeo.segments
        assert _fields(ts) == _fields(js)
        assert {n: _fields(s) for n, s in tmodel.stage_specs(tc, ts).items()
                } == {n: _fields(s)
                      for n, s in jmodel.stage_specs(jc, js).items()}
        assert {n: _fields(s) for n, s in tmodel.io_specs(tc).items()} == \
            {n: _fields(s) for n, s in jmodel.io_specs(jc).items()}
        assert "head.w" in tmodel.io_specs(tc)
        for kind in set(ts.kinds):
            want = jmodel.layer_cache_spec(jc, jrc, kind, 8, 2048)
            got = tmodel.layer_cache_spec(tc, trc, kind, 8, 2048)
            assert {n: (tuple(a.shape), str(a.dtype))
                    for n, a in want.items()} == \
                {n: (shape, str(dt).replace("torch.", ""))
                 for n, (shape, dt) in got.items()}
    n_params = sum(int(np.prod(s.shape))
                   for s in list(tmodel.stage_specs(one, ts).values())
                   + list(tmodel.io_specs(one).values()))
    assert n_params == 13_295_235_072     # 26.6 GB in bf16
    # the reduced tree from the port's own initialiser follows the specs
    p = init_all_params(tcfg, trc, torch.Generator().manual_seed(0), "cpu")
    for n, sp in tmodel.stage_specs(tcfg, ts).items():
        assert tuple(p["segments"]["main"][n].shape) == (1, *sp.shape)


def test_jamba_sessions_refuse_what_later_slices_bring():
    # Jamba trains since its training slice: the train spec validates
    t = tsession(ARCH, mode="train", device="cpu")
    assert t.spec.mode == "train" and t.cfg.moe is not None
    with pytest.raises(SessionError, match="expert-parallel MoE slice"):
        tsession(ARCH, max_seq=16, device="cpu",
                 overrides=dict(moe_mode="ep"))
    with pytest.raises(SessionError, match="expert-parallel MoE slice"):
        tsession(ARCH, max_seq=16, device="cpu",
                 overrides=dict(moe_stats=True))
    s = tsession(ARCH, reduced=False, max_seq=16, device="cpu")
    assert s.cfg.n_layers == 8 and s.cfg.d_model == 4096   # no params made
    # paged caches and chunked prefill cannot carry Mamba state
    for kw, match in ((dict(page_size=4), "page_size"),
                      (dict(prefill_chunk=4), "prefill_chunk")):
        sess = tsession(ARCH, device="cpu", max_slots=2, max_seq=16, **kw)
        with pytest.raises(NotImplementedError, match=match):
            sess.serve_engine(None)
        flag = "--page-size" if "page_size" in kw else "--prefill-chunk"
        with pytest.raises(SystemExit, match=match):
            tlaunch.main(["--arch", ARCH, "--device", "cpu", flag, "4"])


# --------------------------------------------------------------------------- #
# The reduced Jamba engine against the reference engine
# --------------------------------------------------------------------------- #


COMMON = dict(max_slots=4, max_seq=32, overrides=dict(pp=1, microbatches=1))


def _workload():
    """Six requests over four slots (reclaim), prompts of 5 or 9 tokens
    (two prefill widths, both past the conv state's 3)."""
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
    tparams = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    launches = (dict(ss.LAUNCHES), dict(pa.LAUNCHES))

    want, jstats = _serve(js, jparams)
    got, tstats = _serve(ts, tparams)
    assert got == want
    assert [len(t) for t in got] == [g for _, g in _workload()]
    assert (tstats.prefill_steps, tstats.decode_steps) == \
        (jstats.prefill_steps, jstats.decode_steps)
    assert tstats.capacity_deferrals == jstats.capacity_deferrals
    counters = ts.describe()["kernels"]["counters"]
    assert counters["ref_scan"] == 7 * tstats.prefill_steps
    assert counters["ref_attention"] == tstats.prefill_steps \
        + tstats.decode_steps
    assert not [k for k in counters if k.startswith("kernel_")]
    assert (dict(ss.LAUNCHES), dict(pa.LAUNCHES)) == launches

    # one batched prefill with full logits on fresh caches: staggered
    # per-slot positions, one masked slot
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(0, 256, size=(4, 5)).astype(np.int32),
             "pos": np.array([0, 4, 0, 9], np.int32),
             "slot_mask": np.array([True, True, False, True])}
    jtok, jlog, jc = js.serve_step_batched(jparams, js.init_caches(), batch,
                                           want_logits=True)
    ttok, tlog, tc = ts.serve_step_batched(tparams, ts.init_caches(), batch,
                                           want_logits=True)
    np.testing.assert_allclose(np.asarray(tlog), np.asarray(jlog), atol=ATOL)
    top2 = np.sort(np.asarray(jlog), axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * ATOL
    assert clear.sum() >= 3
    np.testing.assert_array_equal(np.asarray(ttok)[clear],
                                  np.asarray(jtok)[clear])
    for name in ("L0.conv", "L0.h", "L4.k"):     # a Mamba and the attention
        np.testing.assert_allclose(tc["main"][name].numpy(),
                                   np.asarray(jc["main"][name]),
                                   **SCAN_TOL, err_msg=name)
