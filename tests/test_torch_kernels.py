"""repro_torch's serving attention against the JAX package's.

The same numpy inputs go through the port's plain versions
(``repro_torch.kernels.ref``) and through ``repro``'s jnp references and
its Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs
them). ``tests/test_torch_cuda.py`` holds the CUDA kernels themselves
to these plain versions on a GPU.

Tolerance: float32 throughout, 2e-5 absolute (two softmax
implementations summing in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, leaving the cores to the other test
# workers (eight spinning OpenMP threads per worker oversubscribe them)
torch.set_num_threads(1)

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    decode_attention as pallas_decode_attention,
    flash_attention_slotted as pallas_slotted,
    paged_attention as pallas_paged,
)
from repro_torch.kernels import ops, paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_cases import paged_case as _paged_case  # noqa: E402
from torch_cases import qkv as _qkv  # noqa: E402

ATOL = 2e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------- #
# Plain versions vs the JAX references
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", [
    dict(offset="rows", causal=True, g=2, ev=16),
    dict(offset="rows", causal=True, g=1, ev=8),     # MQA, ev != e
    dict(offset="scalar", causal=True, g=4, ev=16),  # MHA, decode-like
    dict(offset="zero", causal=False, g=2, ev=16),   # bidirectional
])
def test_attention_matches_jax_ref(case):
    """Blockwise streaming attention: staggered per-row offsets, GQA,
    ev != e, and a row whose offset sees no key (exact zeros)."""
    b, sq, h, e, S = 3, 5, 4, 16, 40
    q, k, v = _qkv(1, b, sq, h, case["g"], e, S, case["ev"])
    off = {"rows": np.array([-5, 7, 30], np.int32), "scalar": 17,
           "zero": 0}[case["offset"]]
    want = jref.attention(q, k, v, causal=case["causal"],
                          q_offset=jnp.asarray(off), block_k=16)
    got = tref.attention(_t(q), _t(k), _t(v), causal=case["causal"],
                         q_offset=_t(off) if case["offset"] == "rows"
                         else off, block_k=16)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    if case["offset"] == "rows":
        assert not got[0].any()   # offset -5: no key visible


def test_decode_attention_and_stats_match_jax_ref_and_pallas():
    """Window contract with stats: the port's plain version against the
    jnp reference and the Pallas decode kernel, cache_len 0 included."""
    b, h, g, e, S = 4, 4, 2, 16, 32
    q, k, v = _qkv(2, b, 1, h, g, e, S)
    cl = np.array([0, 1, 13, 32], np.int32)
    want, (mr, lr, accr) = jref.decode_attention(q, k, v, jnp.asarray(cl))
    got, (m, l, acc) = tref.decode_attention(_t(q), _t(k), _t(v), _t(cl))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    np.testing.assert_allclose(l.numpy(), _np(lr), rtol=1e-5)
    np.testing.assert_allclose(acc.numpy(), _np(accr), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(m.numpy(), _np(mr), rtol=1e-6)  # -inf too
    # the slotted kernel's window wrapper takes this plain version on the CPU
    got2, (m2, l2, acc2) = pa.decode_attention(_t(q), _t(k), _t(v), _t(cl))
    pk, (pm, pl, pacc) = pallas_decode_attention(q, k, v, jnp.asarray(cl),
                                                 block_k=8, interpret=True)
    np.testing.assert_allclose(got2.numpy(), _np(pk), atol=ATOL)
    np.testing.assert_allclose(l2.numpy(), _np(pl), rtol=1e-5)
    np.testing.assert_allclose(acc2.numpy(), _np(pacc), rtol=1e-5, atol=ATOL)
    seen = l2.numpy() > 0   # Pallas marks no-key rows with -1e30, not -inf
    np.testing.assert_allclose(m2.numpy()[seen], _np(pm)[seen], rtol=1e-6)


@pytest.mark.parametrize("window", [False, True])
def test_slotted_plain_matches_pallas(window):
    """K3's contract: staggered per-row pos, GQA, causal or window mode
    with stats, through the wrapper's CPU path (the plain versions)
    against the Pallas kernel in interpret mode."""
    b, sq, h, g, e, S = 3, 5, 4, 2, 16, 48
    q, k, v = _qkv(3, b, sq, h, g, e, S)
    pos = np.array([0, 9, 43], np.int32)
    want = pallas_slotted(q, k, v, pos=jnp.asarray(pos), window=window,
                          return_stats=window, block_k=16, interpret=True)
    got = (pa.decode_attention(_t(q), _t(k), _t(v), _t(pos)) if window
           else pa.flash_attention_slotted(_t(q), _t(k), _t(v), pos=_t(pos)))
    if window:
        want, (_, wl, wacc) = want
        got, (_, gl, gacc) = got
        np.testing.assert_allclose(gl.numpy(), _np(wl), rtol=1e-5)
        np.testing.assert_allclose(gacc.numpy(), _np(wacc), rtol=1e-5,
                                   atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_plain_matches_jax_ref_and_pallas(int8):
    """K4's contract: sentinel tail pages, a masked row (exact zeros),
    GQA, optional int8 pools with per-page x kv-head scales."""
    b, sq, h, g, e, ps, ppr, n_pages = 3, 4, 4, 2, 16, 4, 6, 14
    q, kp, vp, pt, pos, mask = _paged_case(4, b, sq, h, g, e, ps, ppr,
                                           n_pages)
    ks = vs = None
    if int8:
        ks = np.abs(kp).max(axis=(1, 3)) / 127.0
        vs = np.abs(vp).max(axis=(1, 3)) / 127.0
        kp = np.round(kp / ks[:, None, :, None]).astype(np.int8)
        vp = np.round(vp / vs[:, None, :, None]).astype(np.int8)
    kw = dict(page_tables=jnp.asarray(pt), pos=jnp.asarray(pos),
              slot_mask=jnp.asarray(mask))
    if int8:
        kw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = jref.paged_attention(q, kp, vp, block_k=8, **kw)
    want_pallas = pallas_paged(q, kp, vp, interpret=True, **kw)
    got = tref.paged_attention(
        _t(q), _t(kp), _t(vp), page_tables=_t(pt), pos=_t(pos),
        slot_mask=_t(mask), k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs), block_k=8)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _np(want_pallas), atol=ATOL)
    assert not got[~torch.from_numpy(mask)].any()


# --------------------------------------------------------------------------- #
# Dispatch on the CPU
# --------------------------------------------------------------------------- #


def test_cpu_dispatch_takes_plain_versions_and_launches_nothing():
    b, sq, h, g, e, S = 2, 3, 4, 2, 16, 24
    q, k, v = (_t(a) for a in _qkv(5, b, sq, h, g, e, S))
    pos = torch.tensor([2, 11], dtype=torch.int32)
    before = dict(pa.LAUNCHES)
    out = pa.flash_attention_slotted(q, k, v, pos=pos)
    torch.testing.assert_close(
        out, tref.attention(q, k, v, q_offset=pos), rtol=0, atol=0)
    torch.testing.assert_close(
        pa.decode_attention(q[:, :1], k, v, pos),
        tref.decode_attention(q[:, :1], k, v, pos), rtol=1e-5, atol=ATOL)
    counters = ops.kernel_counters()
    via_ops = ops.attention(q, k, v, q_offset=pos, block_k=8)
    torch.testing.assert_close(via_ops, out, rtol=0, atol=ATOL)
    assert ops.kernel_counters()["ref_attention"] == \
        counters.get("ref_attention", 0) + 1
    assert pa.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v, q_offset=pos, impl="kernel")
