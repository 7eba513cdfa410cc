"""repro_torch's training kernels' plain versions against the JAX package.

The same seeded numpy inputs go through the port's plain versions
(``repro_torch.kernels.ref``: attention with a static offset and its
log-sum-exp, the written-out attention backward, ``softmax_xent`` and its
two passes over vocabulary shards, combined; and
``core/vocab.loss_and_dy``) and through ``repro``'s jnp references, its
Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs them)
and ``jax.vjp``. ``tests/test_torch_cuda.py`` holds the CUDA kernels
(K1, K1b, K2) to these plain versions on a GPU.

Tolerance: float32 throughout; 1e-5 relative to the largest reference
value (sums of up to a few hundred terms in another order). The last
tests calibrate the bf16 kernels' tolerance on the CPU: an emulation of
their rounding (P and dS in bf16 for K1/K1b; h and dlog split into two
bf16 terms for K2) against the float32 plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import llama3p2_1b as jllama  # noqa: E402
from repro.core import vocab as jvocab  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as pallas_flash,
)
from repro.kernels.fused_xent import (  # noqa: E402
    softmax_xent as pallas_xent,
)
from repro_torch.configs import llama3p2_1b as tllama  # noqa: E402
from repro_torch.core import vocab as tvocab  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_cases import qkv as _qkv  # noqa: E402

RTOL = 1e-5


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


ATTN_CASES = [
    dict(causal=True, q_offset=0, g=2, ev=16),
    dict(causal=True, q_offset=5, g=2, ev=8),       # sq < sk window, ev != e
    dict(causal=False, q_offset=0, g=1, ev=16),     # bidirectional, MQA
    dict(causal=False, q_offset=5, g=4, ev=16),     # MHA
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_plain_forward_matches_jax(case):
    """Static-offset attention (K1's plain version) and the log-sum-exp
    residual vs ``ref.attention``; at offset 0 also vs the Pallas flash
    kernel in interpret mode."""
    b, sq, h, e = 2, 11, 4, 16
    sk = sq + case["q_offset"]
    q, k, v = _qkv(3, b, sq, h, case["g"], e, sk, case["ev"])
    kw = dict(causal=case["causal"], q_offset=case["q_offset"])
    out, lse = tref.attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **kw)
    _close(out, want)
    # the op the tape calls takes the same path on a CPU tensor
    _close(ops.attention(_t(q), _t(k), _t(v), **kw), want)
    # lse: log of the softmax denominator, from the naive scores
    s = np.einsum("bqhe,bkhe->bhqk", q / np.sqrt(e),
                  np.repeat(k, h // case["g"], axis=2))
    if case["causal"]:
        vis = np.arange(sk)[None] <= (case["q_offset"]
                                      + np.arange(sq))[:, None]
        s = np.where(vis, s, -np.inf)
    mx = s.max(-1)
    _close(lse, mx + np.log(np.exp(s - mx[..., None]).sum(-1)))
    if case["q_offset"] == 0:
        pal = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=case["causal"], interpret=True)
        _close(out, pal)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_plain_backward_matches_jax_vjp(case):
    """K1b's plain version (P recomputed from lse, D = rowsum(dO * O)) vs
    ``jax.vjp`` of ``ref.attention``."""
    b, sq, h, e = 2, 9, 4, 16
    sk = sq + case["q_offset"]
    q, k, v = _qkv(4, b, sq, h, case["g"], e, sk, case["ev"])
    do = np.random.RandomState(5).randn(b, sq, h, case["ev"]).astype(
        np.float32)
    kw = dict(causal=case["causal"], q_offset=case["q_offset"])
    out, lse = tref.attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    got = tref.attention_bwd(_t(q), _t(k), _t(v), out, _t(do), lse, **kw)
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention(a, b_, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        _close(g, w)
    # and through autograd on the differentiable op
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    o = ops.attention(qt, kt, vt, **kw)
    for g, w in zip(torch.autograd.grad(o, (qt, kt, vt), _t(do)),
                    vjp(jnp.asarray(do))):
        _close(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_plain_matches_jax(masked):
    """K2's plain version vs ``ref.softmax_xent`` and the Pallas kernel in
    interpret mode: ragged rows (37) and vocab (300 over chunks of 128)."""
    rng = np.random.RandomState(6)
    n, d, vocab = 37, 16, 300
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, vocab) * 0.5).astype(np.float32)
    lab = rng.randint(0, vocab, n).astype(np.int32)
    mask = (rng.rand(n) > 0.3).astype(np.float32) if masked else None
    loss, (dh, dw) = tref.softmax_xent(
        _t(h), _t(w), torch.from_numpy(lab), chunk=128,
        mask=None if mask is None else _t(mask))
    jm = None if mask is None else jnp.asarray(mask)
    for jl, (jdh, jdw) in (
            jref.softmax_xent(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(lab), chunk=128, mask=jm),
            pallas_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab),
                        mask=jm, interpret=True)):
        _close(loss, jl)
        _close(dh, jdh)
        _close(dw, jdw)


def test_loss_and_dy_matches_jax():
    """The trainer's loss head (final norm + K2's function + norm bwd)
    vs the JAX one-rank branch with its float32 [n, vocab] logits."""
    jcfg, jrc = jllama.reduced()
    tcfg, trc = tllama.reduced()
    trc = dataclasses.replace(trc, vocab_chunk=96)   # several chunks
    rng = np.random.RandomState(7)
    n = 24
    h = rng.randn(n, jcfg.d_model).astype(np.float32)
    lab = rng.randint(0, jcfg.vocab, n).astype(np.int32)
    io = {"embed.table": (rng.randn(jcfg.vocab, jcfg.d_model) * 0.2
                          ).astype(np.float32),
          "final_norm.scale": (1 + 0.1 * rng.randn(jcfg.d_model)
                               ).astype(np.float32)}
    denom = 3.0 * n
    jl, jdh, jg = jvocab.loss_and_dy(
        jcfg, jrc, {k: jnp.asarray(a) for k, a in io.items()},
        jnp.asarray(h), jnp.asarray(lab), denom, None, 1)
    tl, tdh, tg = tvocab.loss_and_dy(
        tcfg, trc, {k: _t(a) for k, a in io.items()}, _t(h),
        torch.from_numpy(lab), denom, None, 1)
    _close(tl, jl)
    _close(tdh, jdh)
    assert set(tg) == set(jg)
    for k in jg:
        _close(tg[k], jg[k])


def _shard_combine(h, w, lab, mask, denom, shards, chunk):
    """K2's plain passes over ``shards`` vocabulary shards: pass 1 per
    shard (labels local, -1 outside), lse and label logit combined with a
    max and a sum, pass 2 per shard with the combined lse; dh summed, dW
    concatenated."""
    vocab = w.shape[1]
    cuts = np.linspace(0, vocab, shards + 1).astype(int)
    parts = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        loc = torch.where((lab >= lo) & (lab < hi), lab - lo, -1)
        parts.append((w[:, lo:hi], loc) + tref.xent_stats(
            h, w[:, lo:hi], loc, chunk=chunk))
    lses = torch.stack([p[2] for p in parts])
    m = lses.max(0).values
    lse = m + torch.log(torch.exp(lses - m).sum(0))
    lab_logit = sum(p[3] for p in parts)
    loss = ((lse - lab_logit) * mask).sum() / denom
    grads = [tref.xent_grads(h, ws, loc, lse, mask / denom, chunk=chunk)
             for ws, loc, _, _ in parts]
    return loss, sum(g[0] for g in grads), torch.cat([g[1] for g in grads],
                                                     1)


@pytest.mark.parametrize("shards", [2, 3])
def test_xent_passes_over_vocab_shards_combine_to_softmax_xent(shards):
    """The sharded loss's arithmetic: ``xent_stats`` / ``xent_grads`` over
    2 and 3 vocabulary shards (a shard of 100 spans chunks of 64; labels
    of the other shards go in as -1), combined, equal the plain
    whole-vocab ``softmax_xent`` and the JAX one."""
    rng = np.random.RandomState(16)
    n, d, vocab = 37, 16, 300
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, vocab) * 0.5).astype(np.float32)
    lab = rng.randint(0, vocab, n).astype(np.int32)
    mask = (rng.rand(n) > 0.3).astype(np.float32)
    denom = float(mask.sum())       # the JAX function's own denominator
    got = _shard_combine(_t(h), _t(w), torch.from_numpy(lab).long(),
                         _t(mask), denom, shards, 64)
    loss, (dh, dw) = tref.softmax_xent(_t(h), _t(w), torch.from_numpy(lab),
                                       chunk=64, mask=_t(mask))
    jl, (jdh, jdw) = jref.softmax_xent(jnp.asarray(h), jnp.asarray(w),
                                       jnp.asarray(lab), chunk=64,
                                       mask=jnp.asarray(mask))
    for want in ((loss, dh, dw), (jl, jdh, jdw)):
        for g, w_ in zip(got, want):
            _close(g, w_ if not hasattr(w_, "detach") else w_.detach())


# ---- the bf16 tolerance of the tensor-core flash kernels ------------------ #
# The bf16 K1 and K1b round P (and dS) to bf16 before the products that
# consume them and accumulate in float32, as FlashAttention does; the
# plain versions keep float32 throughout. ``flash_attention.bf16_excess``
# holds out, dq, dk and dv to BF16_RTOL of the largest |plain| of each
# element's row (one position of one head), plus one bf16 ulp where the
# plain output is bf16. The emulation below repeats the kernels' rounding
# in plain torch; at this size it must stay within half that limit, and
# the probes the card checks reject must exceed it: kv heads rolled by
# one, the neighbouring head's lse, and two faults confined to the keys of
# the second half (V or K rolled over kv heads there), which leave every
# early row exactly as it was.

CAL = dict(b=1, s=256, h=8, g=2, e=64)


def _bf(x):
    return x.to(torch.bfloat16).float()


def _emulate(q, k, v, do, causal, q_offset):
    """(out, dq, dk, dv) with the kernels' rounding: inputs in bf16, S and
    dP from exact bf16 products summed in float32, P and dS rounded to
    bf16 before their products, float32 accumulation."""
    b, sq, h, e = q.shape
    sk, g = k.shape[1], k.shape[2]
    rep, scale = h // g, 1.0 / e ** 0.5
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhe,bkhe->bhqk", q, kr) * scale
    if causal:
        vis = (torch.arange(sk)[None] <= q_offset + torch.arange(sq)[:, None])
        s = torch.where(vis, s, float("-inf"))
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    out = torch.einsum("bhqk,bkhe->bqhe", _bf(p), vr)
    o_bf = _bf(out)                       # the kernel writes out in bf16
    dd = (do * o_bf).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhe,bkhe->bhqk", do, vr)
    ds = _bf(p * (dp - dd))
    dv = torch.einsum("bhqk,bqhe->bkhe", _bf(p), do)
    dq = torch.einsum("bhqk,bkhe->bqhe", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhe->bkhe", ds, q) * scale
    dk = dk.reshape(b, sk, g, rep, e).sum(3)
    dv = dv.reshape(b, sk, g, rep, e).sum(3)
    return out, dq, dk, dv


def _cal_inputs(q_offset):
    c = CAL
    q, k, v = (_bf(_t(a)) for a in _qkv(20, c["b"], c["s"], c["h"], c["g"],
                                         c["e"], c["s"] + q_offset))
    do = _bf(_t(np.random.RandomState(21).randn(c["b"], c["s"], c["h"],
                                                c["e"])))
    return q, k, v, do


def _probe(name, q, k, v, do, out, lse):
    """(bad, plain, early rows) for a probe: the outputs with the fault
    fed in, the unperturbed plain ones, and how many leading positions of
    each output the fault leaves untouched."""
    half = k.shape[1] // 2

    def late_rolled(x):
        x = x.clone()
        x[:, half:] = x[:, half:].roll(1, dims=2)
        return x

    if name == "kv_heads_rolled":
        return ((tref.attention(q, k.roll(1, dims=2), v),),
                (out,), (0,))
    if name == "late_v_rolled":
        return (tref.attention(q, k, late_rolled(v)),), (out,), (half,)
    plain = tref.attention_bwd(q, k, v, out, do, lse)
    if name == "neighbour_lse":
        return (tref.attention_bwd(q, k, v, out, do, lse.roll(1, dims=1)),
                plain, (0, 0, 0))
    return (tref.attention_bwd(q, late_rolled(k), v, out, do, lse), plain,
            (half, half, half))


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 64),
                                             (False, 0)])
def test_flash_bf16_tolerance_holds_the_kernels_rounding(causal, q_offset):
    """The emulated kernel rounding stays within half of the bf16 limit
    against the float32 plain versions: out (both sides in bf16, as the
    kernel and the plain version return it), and dq, dk, dv fed the same
    out."""
    q, k, v, do = _cal_inputs(q_offset)
    kw = dict(causal=causal, q_offset=q_offset)
    out, lse = tref.attention(q, k, v, return_lse=True, **kw)
    emu = _emulate(q, k, v, do, **kw)
    worst = fa.bf16_excess(emu[0].bfloat16(), out.bfloat16())
    assert worst <= 0.5, worst
    plain = tref.attention_bwd(q, k, v, _bf(emu[0]), do, lse, **kw)
    for a, w in zip(emu[1:], plain):
        worst = fa.bf16_excess(a, w)
        assert worst <= 0.5, worst


@pytest.mark.parametrize("probe", ["kv_heads_rolled", "neighbour_lse",
                                   "late_v_rolled", "late_k_rolled"])
def test_flash_bf16_tolerance_rejects_probes(probe):
    """The probes chip_smoke.py feeds the kernels exceed the bf16 limit.
    The forward probes (K's kv heads rolled by one; V rolled over kv heads
    at the keys of the second half) fail out; the backward probes (the
    neighbouring q head's lse; K rolled over kv heads at the keys of the
    second half) fail dq, dk and dv. The late probes leave every early
    row exactly as it was, so a fault in late tiles alone is seen."""
    q, k, v, do = _cal_inputs(0)
    out, lse = tref.attention(q, k, v, return_lse=True)
    bad, plain, early = _probe(probe, q, k, v, do, out, lse)
    for a, w, n in zip(bad, plain, early):
        assert fa.bf16_excess(a, w) > 1.0
        assert torch.equal(a[:, :n], w[:, :n])


# --------------------------------------------------------------------------- #
# K2's split rule, calibrated on the CPU
# --------------------------------------------------------------------------- #
# The bf16 cross-entropy kernel runs its products on the tensor cores but
# is held to the float32 plain version's rule (loss within 1e-5 relative;
# dh and dW within 1e-4 of the plain tensor's largest value). It splits h
# and dlog into bf16 terms hi = bf16(x), lo = bf16(x - hi), multiplies
# them with the bf16 table in exact bf16 products summed in float32, and
# leaves out lo * lo. The emulation repeats that in plain torch; it must
# stay within half of the rule, and the probes must exceed it: h rounded
# to bf16 (the kernel without its lo term), one bf16 pass (h and dlog
# rounded), and the head shifted by one vocab tile.

XENT_CAL = dict(n=256, d=256, vocab=4096)
XENT_RULE = {"loss": 1e-5, "dh": 1e-4, "dW": 1e-4}


def _split(x, terms):
    hi = _bf(x)
    return [hi, _bf(x - hi)][:terms]


def _emulate_xent(h, table, labels, mask, denom, terms=2):
    """(loss, dh, dW [d, vocab]) with the kernel's arithmetic: h and dlog
    as ``terms`` bf16 terms (2: hi and lo; 1: one bf16 pass), the bf16
    table, bf16 products summed in float32, lo * lo left out."""
    w = table.float()
    hs = _split(h, terms)
    logits = sum(x @ w.t() for x in hs)
    lse = torch.logsumexp(logits, 1)
    lab = labels.long()
    loss = ((lse - logits[torch.arange(len(lab)), lab]) * mask).sum() / denom
    onehot = torch.nn.functional.one_hot(lab, w.shape[0]).float()
    scale = (mask / denom)[:, None]
    dlog = (torch.exp(logits - lse[:, None]) - onehot) * scale
    ds = _split(dlog, terms)
    dh = sum(x @ w for x in ds)
    dw = sum(ds[i].t() @ hs[j] for i in range(terms) for j in range(terms)
             if i + j < 2)
    return loss, dh, dw.t()


def _xent_cal_inputs(seed):
    rng = np.random.RandomState(seed)
    c = XENT_CAL
    h = _t(rng.randn(c["n"], c["d"]))
    table = _t(0.02 * rng.randn(c["vocab"], c["d"])).to(torch.bfloat16)
    labels = torch.from_numpy(rng.randint(0, c["vocab"], size=c["n"]))
    mask = _t(rng.rand(c["n"]) > 0.125)
    return h, table, labels, mask, float(4 * c["n"])


def _xent_excess(got, h, table, labels, mask, denom):
    """Each output's max |diff| over its rule against the plain version."""
    loss, (dh, dw) = tref.softmax_xent(h, table.t(), labels, mask=mask,
                                       denom=denom)
    return {what: float((a - p).abs().max() / (XENT_RULE[what]
                                               * p.abs().max()))
            for what, a, p in zip(XENT_RULE, got, (loss, dh, dw))}


@pytest.mark.parametrize("seed", [30, 31])
def test_xent_split_rule_holds_the_kernels_arithmetic(seed):
    h, table, labels, mask, denom = _xent_cal_inputs(seed)
    emu = _emulate_xent(h, table, labels, mask, denom)
    worst = _xent_excess(emu, h, table, labels, mask, denom)
    assert max(worst.values()) <= 0.5, worst


@pytest.mark.parametrize("probe,fails", [
    ("h_rounded_to_bf16", ("dW",)),
    ("one_bf16_pass", ("dh", "dW")),
    ("head_shifted_one_tile", ("loss", "dW"))])
def test_xent_split_rule_rejects_probes(probe, fails):
    h, table, labels, mask, denom = _xent_cal_inputs(30)
    if probe == "h_rounded_to_bf16":
        emu = _emulate_xent(_bf(h), table, labels, mask, denom)
    elif probe == "one_bf16_pass":
        emu = _emulate_xent(h, table, labels, mask, denom, terms=1)
    else:
        emu = _emulate_xent(h, table.roll(128, 0), labels, mask, denom)
    worst = _xent_excess(emu, h, table, labels, mask, denom)
    assert all(worst[what] > 1.0 for what in fails), worst
