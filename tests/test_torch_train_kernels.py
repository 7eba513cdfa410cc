"""repro_torch's training kernels' plain versions against the JAX package.

The same seeded numpy inputs go through the port's plain versions
(``repro_torch.kernels.ref``: attention with a static offset and its
log-sum-exp, the written-out attention backward, ``softmax_xent``; and
``core/vocab.loss_and_dy``) and through ``repro``'s jnp references, its
Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs them)
and ``jax.vjp``. ``tests/test_torch_cuda.py`` holds the CUDA kernels
(K1, K1b, K2) to these plain versions on a GPU.

Tolerance: float32 throughout; 1e-5 relative to the largest reference
value (sums of up to a few hundred terms in another order).
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
