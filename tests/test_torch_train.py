"""repro_torch's training slice against the JAX package, on the CPU.

* the tape's B + W split vs full torch autograd on one stage;
* the copied schedules: ``pack_table(generate(name, sp))`` array for array
  (or the same refusal) in both packages;
* ``Session(mode="train").train_step`` vs the JAX pipeline's
  ``make_train_step`` on one JAX device (pp = 1), same params and batch;
* the single-device reference loss (the plain oracle) vs the JAX one and
  vs the train step's loss;
* AdamW with the lr schedule vs ``repro.optim.adamw``;
* the training CLI.

Reduced llama3.2-1b in float32; params cross in one process
(``repro_torch.params.from_reference``: the reference's initialiser salts
its seeds per process). Tolerances: loss 1e-5 relative; every gradient
and optimizer tensor max |diff| <= 1e-4 * max |ref|.
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
from repro.core.executor import (  # noqa: E402
    validate_unit_stash_packed as jvalidate,
)
from repro.core.generators import SchedParams as JSP  # noqa: E402
from repro.core.generators import generate as jgenerate  # noqa: E402
from repro.core.plan import pack_table as jpack  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import llama3p2_1b as tllama  # noqa: E402
from repro_torch.core import tape as ttape  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    validate_unit_stash_packed as tvalidate,
)
from repro_torch.core.generators import SchedParams as TSP  # noqa: E402
from repro_torch.core.generators import generate as tgenerate  # noqa: E402
from repro_torch.core.plan import pack_table as tpack  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.common import apply_rope  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

GRAD_RTOL = 1e-4


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t):
    return t.detach().cpu().float().numpy()


# --------------------------------------------------------------------------- #
# Tape: B + W vs autograd
# --------------------------------------------------------------------------- #


def _plain_stage(cfg, rc, seg, params, x, rope):
    """The stage written with plain differentiable torch ops."""
    for j in range(len(seg.kinds)):
        p = f"L{j}"
        h = tblocks.norm_fwd(cfg, params, f"{p}.ln1", x)
        q = tblocks._dense(h, params[f"{p}.mix.wq"])
        k = tblocks._dense(h, params[f"{p}.mix.wk"])
        v = tblocks._dense(h, params[f"{p}.mix.wv"])
        cos, sin = rope[cfg.head_dim]
        o = tref.attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                           v, causal=True)
        x = x + tblocks._dense(o, params[f"{p}.mix.wo"], n_in=2)
        h2 = tblocks.norm_fwd(cfg, params, f"{p}.ln2", x)
        x = x + tblocks.ffn_fwd(None, params, f"{p}.ffn", h2)
    return x


@pytest.mark.parametrize("defer", [True, False])
def test_tape_split_backward_matches_autograd(defer):
    """B's input and immediate grads plus W's replayed dW GEMMs equal full
    autograd of the same stage (``defer=False``: every dW inside B, the
    fused baselines' semantics)."""
    cfg, rc = tllama.reduced()
    rc = dataclasses.replace(rc, pp=1, vpp=2)
    seg = tmodel.build_geometry(cfg, rc).segments[0]
    gen = torch.Generator().manual_seed(1)
    params = {n: a[0] for n, a in tparams.init_all_params(
        cfg, rc, gen, device="cpu")["segments"]["main"].items()}
    for n in params:                          # non-trivial norm scales
        if n.endswith("scale"):
            params[n] = params[n] + 0.1 * torch.randn(
                params[n].shape, generator=gen)
    b, s = 2, 8
    x = torch.randn(b, s, cfg.d_model, generator=gen)
    dy = torch.randn(b, s, cfg.d_model, generator=gen)
    rope = tmodel.rope_for(cfg, s)

    t = ttape.Tape(params, mode="bwd",
                   no_defer=frozenset() if defer else frozenset(params))
    ctx = tblocks.LayerCtx(cfg=cfg, rc=rc, rope=rope, causal=True)
    xin = t.value(x)
    out, _ = tmodel.apply_stage(t, ctx, seg, xin, 0)
    cots, igrads, stash = t.backward({out.idx: dy})
    assert bool(stash) == defer
    grads = dict(igrads)
    for n, g in ttape.compute_dw(stash).items():
        assert n not in grads
        grads[n] = g

    leaves = {n: a.clone().requires_grad_() for n, a in params.items()}
    xl = x.clone().requires_grad_()
    y = _plain_stage(cfg, rc, seg, leaves, xl, rope)
    assert _rel(_np(out.val), _np(y)) <= 1e-5
    want = torch.autograd.grad(y, [xl] + list(leaves.values()), dy)
    assert _rel(_np(cots[xin.idx]), _np(want[0])) <= GRAD_RTOL
    assert set(grads) == set(leaves)
    for n, w in zip(leaves, want[1:]):
        assert _rel(_np(grads[n]), _np(w)) <= GRAD_RTOL, n


# --------------------------------------------------------------------------- #
# Schedules: the packed tables of both packages
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("unit", [0, 2])
@pytest.mark.parametrize("P,V", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize(
    "name", ["zeropp", "gpipe", "1f1b", "bfs", "interleaved", "fwd_only"])
def test_packed_tables_equal_reference(name, P, V, unit):
    kw = dict(P=P, V=V, n_mb=4, unit=unit)
    try:
        want = jpack(jgenerate(name, JSP(**kw)), prefetch=1)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpack(tgenerate(name, TSP(**kw)), prefetch=1)
        assert str(got.value) == str(e)
        assert "cannot pack table at unit depth 2" in str(e)
        return
    got = tpack(tgenerate(name, TSP(**kw)), prefetch=1)
    for f in ("T", "Pe", "V", "U", "n_mb", "prefetch"):
        assert getattr(got, f) == getattr(want, f), f
    for f in got.FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("V", [1, 2])
def test_engine_refuses_packed_table_deeper_than_its_unit(V):
    """A packed zeropp table relabelled to unit depth 1 lets micro-batch
    u + 1 take u's stash slot too early: both engines refuse it."""
    kw = dict(P=1, V=V, n_mb=4, unit=2)
    jpt = jpack(jgenerate("zeropp", JSP(**kw)), prefetch=1)
    tpt = tpack(tgenerate("zeropp", TSP(**kw)), prefetch=1)
    jvalidate(jpt)
    tvalidate(tpt)
    jpt.U = tpt.U = 1
    with pytest.raises(ValueError) as want:
        jvalidate(jpt)
    with pytest.raises(ValueError) as got:
        tvalidate(tpt)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,match", [
    (dict(schedule="auto"), "auto slice"),
    (dict(schedule="autogen_gated"), "auto slice"),
    (dict(overrides=dict(moe_mode="ep")), "MoE slice"),
    # several ranks train since the multi-rank slice; one process without
    # a process group is refused (ids kept from before that slice)
    pytest.param(dict(overrides=dict(groups=2)), "process group",
                 id="kw3-multi-rank: next slice"),
    pytest.param(dict(overrides=dict(grad_compress="int8")), "item 1b",
                 id="kw4-multi-rank: next slice"),
    pytest.param(dict(overrides=dict(coalesce="none")), "item 1b",
                 id="kw5-multi-rank slice"),
    (dict(topology="gpu_cluster"), "multi-rank slice"),
    (dict(pods=2), "item 1b"),
])
def test_train_session_refuses_what_later_slices_bring(kw, match):
    with pytest.raises(SessionError, match=match):
        tsession("llama3.2-1b", mode="train", device="cpu", **kw)


def test_train_session_refuses_checkpoints():
    s = tsession("llama3.2-1b", mode="train", device="cpu")
    for call in (lambda: s.checkpointing("ckpt"),
                 lambda: s.restore_params("ckpt")):
        with pytest.raises(SessionError, match="checkpoint slice"):
            call()


# --------------------------------------------------------------------------- #
# The train step vs the JAX pipeline
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("schedule,vpp", [("zeropp", 1), ("zeropp", 2),
                                          ("1f1b", 1)])
def test_train_step_matches_jax_pipeline(schedule, vpp):
    """Loss and every gradient of one step, pp = 1, four micro-batches in
    units of two, seq 16: the port's eager tick engine vs the JAX
    ``make_train_step`` on one device."""
    ov = dict(pp=1, vpp=vpp, schedule=schedule, microbatches=4, unit=2)
    js = jsession("llama3.2-1b", mode="train", seq_len=16, data=1,
                  overrides=ov)
    jp = js.init_params(jax.random.PRNGKey(0))
    batch = js.stream(seed=3).batch(0)
    jg, jm = js.train_step(jp, batch)

    ts = tsession("llama3.2-1b", mode="train", seq_len=16, device="cpu",
                  overrides=ov)
    assert ts.describe()["schedule"]["ticks"] == js.rt.tables["main"].T
    tp = tparams.from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    np.testing.assert_array_equal(ts.stream(seed=3).batch(0)["tokens"],
                                  batch["tokens"])
    tg, tm = ts.train_step(tp, batch)
    jl = float(jm["loss_sum"])
    assert abs(float(tm["loss_sum"]) - jl) <= 1e-5 * abs(jl)
    assert float(tm["aux_sum"]) == float(jm["aux_sum"]) == 0.0
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jflat) == sum(len(v) for v in tg["segments"].values()) + len(
        tg["io"])
    for path, g in jflat:
        keys = [p.key for p in path]
        node = tg
        for k in keys:
            node = node[k]
        assert node.dtype == torch.float32
        assert _rel(_np(node), np.asarray(g)) <= GRAD_RTOL, keys


def test_reference_loss_matches_jax_and_train_step():
    """``reference_loss`` (stages looped in logical order on one device)
    equals the JAX one, and the tick engine's step loss equals it."""
    ov = dict(pp=1, vpp=2, microbatches=2)
    js = jsession("llama3.2-1b", mode="train", seq_len=8, data=1,
                  overrides=ov)
    jp = jax.tree.map(np.asarray, js.init_params(jax.random.PRNGKey(1)))
    batch = js.stream(seed=4).batch(0)
    want = float(jmodel.reference_loss(js.cfg, js.rc, jp, batch["tokens"],
                                       batch["labels"]))
    ts = tsession("llama3.2-1b", mode="train", seq_len=8, device="cpu",
                  overrides=ov)
    tp = tparams.from_reference(jp, device="cpu")
    got = float(tmodel.reference_loss(ts.cfg, ts.rc, tp,
                                      torch.from_numpy(batch["tokens"]),
                                      torch.from_numpy(batch["labels"])))
    assert abs(got - want) <= 1e-5 * abs(want)
    _, m = ts.train_step(tp, batch)
    assert abs(float(m["loss_sum"]) - want) <= 1e-5 * abs(want)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #


def test_adamw_with_schedule_matches_jax():
    """Three AdamW steps under warmup + cosine, clipping active, decay
    masked by name, bf16 moments: params, master and moments."""
    rng = np.random.RandomState(8)
    shapes = {"io": {"embed.table": (6, 4), "final_norm.scale": (4,)},
              "segments": {"main": {"L0.mix.wq": (2, 4, 3),
                                    "L0.ln1.scale": (2, 4)}}}
    params = jax.tree.map(lambda sh: rng.randn(*sh).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda a: (3 * rng.randn(*a.shape)).astype(
        np.float32), params) for _ in range(3)]
    jcfg = jadamw.AdamWConfig(lr=1e-2, moment_dtype="bfloat16")
    tcfg = tadamw.AdamWConfig(lr=1e-2, moment_dtype="bfloat16")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init_state(jp, jcfg)
    tp = tparams.from_reference(params, device="cpu")
    ts = tadamw.init_state(tp, tcfg)
    for g in grads:
        jscale = jadamw.lr_schedule(js["step"], base_lr=1.0, warmup=2,
                                    total=10)
        tscale = tadamw.lr_schedule(ts["step"], base_lr=1.0, warmup=2,
                                    total=10)
        assert abs(float(tscale) - float(jscale)) <= 1e-7
        jp, js, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                          js, jcfg, jscale)
        tp, ts, tm = tadamw.apply_updates(
            tp, tparams.from_reference(g, device="cpu"), ts, tcfg, tscale)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
    assert ts["step"] == int(js["step"]) == 3
    for tree_t, tree_j in ((tp, jp), (ts["master"], js["master"]),
                           (ts["m"], js["m"]), (ts["v"], js["v"])):
        for (path, w) in jax.tree_util.tree_flatten_with_path(tree_j)[0]:
            node = tree_t
            for p in path:
                node = node[p.key]
            assert _rel(_np(node), np.asarray(w, np.float32)) <= GRAD_RTOL


# --------------------------------------------------------------------------- #
# The training CLI
# --------------------------------------------------------------------------- #


def test_launch_train_cpu_prints_train_ok():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.main(["--device", "cpu", "--steps", "2", "--seq", "16"])
    text = out.getvalue()
    assert "TRAIN_OK steps=2" in text, text
    assert "'ref_xent': 8" in text, text     # 4 micro-batches x 2 steps
