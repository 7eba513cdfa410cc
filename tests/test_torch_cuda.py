"""repro_torch's CUDA kernels against their plain versions, on a GPU.

Every test here needs an NVIDIA GPU and skips without one (the kernels
have no CPU mode); the CPU suite holds the plain versions to the JAX
package in ``tests/test_torch_kernels.py``. Run on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``
(no jax needed).

Tolerances: 2e-5 absolute for float32 inputs (same float32 math, other
summation order); for bfloat16 outputs each element within one bf16 ulp
of the plain version's, |got - want| <= 2^-7 * (|want| + mean |want|)
(both round the same float32 value, up to summation order); stats 1e-4
relative. Float32 outputs of the training kernels (the flash backward's
dq, dk, dv; the fused cross-entropy's loss, dh, dW) sum hundreds to
thousands of float32 terms in another order: max |diff| <= 1e-4 * max
|plain| per tensor, and 1e-5 relative for the loss and the log-sum-exp;
the bf16-table K2 holds that rule on the tensor cores by splitting h and
dlog into two bf16 terms each (``tests/test_torch_train_kernels.py``
calibrates it on the CPU).
The bf16 flash kernels run their products on the tensor cores with P and
dS rounded to bf16, as FlashAttention does, so their out, dq, dk and dv
are held by ``flash_attention.bf16_excess``: each element within
``BF16_RTOL`` (1e-2) of the largest |plain| of its row (one position of
one head), plus one bf16 ulp for the bf16 out
(``tests/test_torch_train_kernels.py`` calibrates it on the CPU); their
log-sum-exp stays within 1e-5 relative. The serving kernels' bf16 paths
(bf16 q over a bf16 cache, causal or the window + stats contract; bf16 q
over bf16 or int8 pools) run the same way on the tensor cores with P
rounded to bf16, and their out is held by the same rule
(``tests/test_torch_serving_kernels.py`` calibrates it); the window
contract's acc by the same per-row rule, its m and l within 1e-4 of
their largest |plain| (``paged_attention.window_excess``). Their float32
and mixed-dtype cases keep the CUDA-core body and the float32 / one-ulp
rules above.
The selective scan (float32 in and out) walks the recurrence one step at
a time where the plain version scans each chunk in doubling steps: y and
the final state within 1e-5 of the plain tensor's max |value|; the
kernel chained over two halves with h0 repeats the same float32
operations, so it must equal the one-pass run bit for bit. Its backward
(K5b) walks chunks of 128 steps in parallel, carries the states and
cotangents across them through each chunk's decay, and sums dA, dD, dB
and dC over up to 4096 steps and hundreds of channels in another order:
every gradient within 1e-4 of the plain tensor's max |value|, and two
runs equal bit for bit (no float atomics).
The sLSTM kernels (K6, K6b) compute in float32 in the plain walks' order
of operations, one step at a time, with other exp / tanh / log1p
implementations: float32 outputs within 1e-5 of the plain tensor's max
|value|, bf16 outputs by the one-ulp rule above; chained runs and
repeated runs equal bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_xent as fx  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels import slstm_scan as sl  # noqa: E402
from torch_cases import late_rolled as _late_rolled  # noqa: E402
from torch_cases import odd_heads_nan as _odd_heads_nan  # noqa: E402
from torch_cases import paged_case as _paged_case  # noqa: E402
from torch_cases import qkv as _qkv  # noqa: E402

ATOL = 2e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    else:
        torch.testing.assert_close(got, want, rtol=2**-7,
                                   atol=2**-7 * want.abs().mean().item())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["causal", "decode", "window_stats"])
def test_slotted_kernel_matches_plain(cuda, dtype, mode):
    dt = getattr(torch, dtype)
    b, h, g, e, S = 3, 8, 2, 64, 200
    sq = 1 if mode == "decode" else 70
    q, k, v = (_t(a).to(cuda, dt) for a in _qkv(6, b, sq, h, g, e, S))
    pos = torch.tensor([0, 57, S - sq], dtype=torch.int32, device=cuda)
    window = mode == "window_stats"
    if window and dt == torch.bfloat16:     # the tensor-core body
        res = pa.window_excess(pa.decode_attention(q, k, v, pos),
                               tref.decode_attention(q, k, v, pos))
        assert max(res.values()) <= 1.0, res
        return
    if window:
        got = pa.decode_attention(q, k, v, pos)
        want = tref.decode_attention(q, k, v, pos)
        (got, (m, l, acc)), (want, (mw, lw, accw)) = got, want
        torch.testing.assert_close(l, lw, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(acc, accw, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(m, mw, rtol=1e-5, atol=1e-5)
    else:
        got = pa.flash_attention_slotted(q, k, v, pos=pos)
        want = tref.attention(q, k, v, q_offset=pos)
    if dt == torch.bfloat16:
        _bf16_close(got, want)              # the tensor-core body
    else:
        _close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["causal", "decode"])
def test_slotted_kernel_head_dim_128(cuda, dtype, mode):
    """K3 at jamba-v0.1-52b's head width (e = ev = 128, 4 q heads a kv
    head): both block heights of the float32 body (BM 16 at decode, 64
    for the prefill), and the bf16 tensor-core body with and without key
    splits."""
    dt = getattr(torch, dtype)
    b, h, g, e, S = 3, 8, 2, 128, 200
    sq = 1 if mode == "decode" else 70
    q, k, v = (_t(a).to(cuda, dt) for a in _qkv(11, b, sq, h, g, e, S))
    pos = torch.tensor([0, 57, S - sq], dtype=torch.int32, device=cuda)
    got = pa.flash_attention_slotted(q, k, v, pos=pos)
    want = tref.attention(q, k, v, q_offset=pos)
    if dt == torch.bfloat16:
        _bf16_close(got, want)
    else:
        _close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("e", [64, 128])
def test_slotted_bf16_decode_split_edges(cuda, e):
    """The bf16 tensor-core body at decode with the llama/Jamba kv-head
    layout (32 q heads over 8 kv heads) and 2048 keys, so the keys are
    split over blocks: positions at 0, on a split boundary (the last key
    of a tile and the first of the next), inside the last tile, and
    clamped at S; one wrapper call counts one launch. K with its kv heads
    rolled by one must fail the check."""
    b, h, g, S = 6, 32, 8, 2048
    q, k, v = (_t(a).to(cuda, torch.bfloat16)
               for a in _qkv(17, b, 1, h, g, e, S))
    ns = pa.splits(b, g, h // g, S, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert ns > 1
    # a row at position p sees (p + 64) // 64 tiles, split into ns
    # ranges of whole tiles: 1023 ends a tile, 1024 starts one (17 tiles,
    # so some splits get one tile more than others), 1279 ends the 20th
    pos = torch.tensor([0, 1023, 1024, 1279, S - 2, S + 5],
                       dtype=torch.int32, device=cuda)
    before = pa.LAUNCHES["slotted_attention"]
    got = pa.flash_attention_slotted(q, k, v, pos=pos)
    assert pa.LAUNCHES["slotted_attention"] == before + 1
    want = tref.attention(q, k, v, q_offset=pos)
    _bf16_close(got, want)
    bad = pa.flash_attention_slotted(q, k.roll(1, dims=2).contiguous(), v,
                                     pos=pos)
    assert fa.bf16_excess(bad, want) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("e", [64, 128])
@pytest.mark.parametrize("sq", [1, 16])
@pytest.mark.parametrize("split", [False, True])
def test_slotted_bf16_window_stats(cuda, e, sq, split, monkeypatch):
    """The window + stats contract on the tensor-core body, with one key
    split or several: every row sees the keys below its batch row's
    cache length (0, one key, a tile edge and the whole cache); m, l,
    acc and out held by ``window_excess``; a row with no key gives m =
    -inf and exact zeros; one wrapper call counts one launch. One extra
    key (cache_len + 1) must fail l, K rolled over kv heads and V rolled
    at the late keys must fail out."""
    b, h, g, S = 4, 32, 8, 1024
    q, k, v = (_t(a).to(cuda, torch.bfloat16)
               for a in _qkv(23, b, sq, h, g, e, S))
    if not split:
        monkeypatch.setattr(pa, "_BLOCKS_AN_SM", 0)
    ns = pa.splits(b, g, h // g * sq, S, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert (ns > 1) == split
    cl = torch.tensor([0, 1, 640, S], dtype=torch.int32, device=cuda)
    before = pa.LAUNCHES["slotted_attention"]
    got = pa.decode_attention(q, k, v, cl)
    assert pa.LAUNCHES["slotted_attention"] == before + 1
    want = tref.decode_attention(q, k, v, cl)
    res = pa.window_excess(got, want)
    assert max(res.values()) <= 1.0, res
    out, (m, l, acc) = got
    assert bool(torch.isneginf(m[0]).all())
    assert not l[0].any() and not acc[0].any() and not out[0].any()
    assert pa.window_excess(pa.decode_attention(q, k, v, cl + 1),
                            want)["l"] > 1.0
    assert pa.window_excess(pa.decode_attention(
        q, k.roll(1, dims=2).contiguous(), v, cl), want)["out"] > 1.0
    assert pa.window_excess(pa.decode_attention(q, k, _late_rolled(v), cl),
                            want)["out"] > 1.0


def _scan_case(seed, b, s, d, n, device):
    """Mamba-like inputs: dt log-uniform in [1e-3, 1e-1] and A = -(1..n)
    (S4D-real), so exp(dt A) spans short and long memory."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, d)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(b, s, d)))
    A = -np.arange(1, n + 1)[None] * np.exp(0.1 * rng.randn(d, n))
    B, C = rng.randn(b, s, n), rng.randn(b, s, n)
    D, h0 = rng.randn(d), rng.randn(b, d, n)
    return [_t(a.astype(np.float32)).to(device)
            for a in (x, dt, A, B, C, D, h0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 300, 1024])
@pytest.mark.parametrize("d", [200, 203])
def test_selective_scan_kernel_matches_plain(cuda, n, with_h0, s, d):
    """K5 at one step, with s not a multiple of the staged tile or the
    plain chunk, and over several tiles of the ring; d not a multiple of
    the block, and not of 4 (4-byte copies); then chained over two
    parts."""
    x, dt, A, B, C, D, h0 = _scan_case(12, 3, s, d, n, cuda)
    h0 = h0 if with_h0 else None
    before = ss.LAUNCHES["selective_scan"]
    y, h = ss.selective_scan(x, dt, A, B, C, D, h0=h0, return_state=True)
    assert ss.LAUNCHES["selective_scan"] == before + 1
    wy, wh = tref.selective_scan(x, dt, A, B, C, D, chunk=128, h0=h0,
                                 return_state=True)
    _rel_close(y, wy, 1e-5)
    _rel_close(h, wh, 1e-5)
    assert torch.equal(ss.selective_scan(x, dt, A, B, C, D, h0=h0), y)
    first, second = ([t[:, part].contiguous() for t in (x, dt, B, C)]
                     for part in (slice(0, s // 2), slice(s // 2, None)))
    y1, h1 = ss.selective_scan(first[0], first[1], A, first[2], first[3],
                               D, h0=h0, return_state=True)
    y2, h2 = ss.selective_scan(second[0], second[1], A, second[2],
                               second[3], D, h0=h1, return_state=True)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    # B and C swapped must fail the check (one step from a zero state
    # computes C . B dt x, the same with B and C swapped)
    if s > 1 or with_h0:
        bad = ss.selective_scan(x, dt, A, C, B, D, h0=h0)
        err = (bad - wy).abs().max().item()
        assert err > 1e-5 * wy.abs().max().item()
    with pytest.raises(ValueError, match="float32"):
        ss.selective_scan(x.double(), dt, A, B, C, D)


SCAN_BWD_RTOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n", [
    (3, s, d, n) for n in (4, 8, 16) for s in (1, 200, 1030)
    for d in (200, 203)] + [
    # the training length, one and two rows; one step past a chunk
    (1, 4096, 203, 16), (2, 4096, 203, 16), (3, 129, 203, 16),
    (3, 129, 200, 4)])
def test_selective_scan_bwd_kernel_matches_plain(cuda, b, s, d, n):
    """K5b at one step, within a chunk, one step past a 128-step chunk,
    over several chunks ending in a part tile and over the 32 chunks of
    the training length; d not a multiple of the block: every gradient
    within SCAN_BWD_RTOL of its max |plain| (sums over up to 4096 steps
    and 203 channels in another order, exp2 by MUFU, the chunks' entry
    states and carries through their decays), two runs equal bit for bit
    (no atomics), the autograd op's backward equal to it, and B and C
    swapped failing the check."""
    x, dt, A, B, C, D, _ = _scan_case(13, b, s, d, n, cuda)
    dy = torch.randn(x.shape, generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    before = ss.LAUNCHES["selective_scan_bwd"]
    got = ss.selective_scan_bwd(x, dt, A, B, C, D, dy)
    assert ss.LAUNCHES["selective_scan_bwd"] == before + 1
    want = tref.selective_scan_bwd(x, dt, A, B, C, D, dy, chunk=128)
    for g, w in zip(got, want):
        _rel_close(g, w, SCAN_BWD_RTOL)
    again = ss.selective_scan_bwd(x, dt, A, B, C, D, dy)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C, D)]
    y = ss.scan(*ins)
    assert torch.equal(y.detach(), ss.selective_scan(x, dt, A, B, C, D))
    grads = torch.autograd.grad(y, ins, dy)
    assert all(torch.equal(a, g) for a, g in zip(grads, got))
    if s > 1:
        bad = ss.selective_scan_bwd(x, dt, A, C, B, D, dy)
        assert any((b_ - w).abs().max().item()
                   > SCAN_BWD_RTOL * w.abs().max().item()
                   for b_, w in zip(bad, want))


def _int8_pools(kp, vp, cuda):
    ks = torch.from_numpy(np.abs(kp).max(axis=(1, 3)) / 127.0).to(cuda)
    vs = torch.from_numpy(np.abs(vp).max(axis=(1, 3)) / 127.0).to(cuda)
    kq = (_t(kp).to(cuda) / ks[:, None, :, None]).round().to(torch.int8)
    vq = (_t(vp).to(cuda) / vs[:, None, :, None]).round().to(torch.int8)
    return kq, vq, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8",
                                  "bf16_q_int8"])
def test_paged_kernel_matches_plain(cuda, pool):
    """float32 q (float32 or int8 pools) on the CUDA-core body; bf16 q
    over bf16 or int8 pools on the tensor-core body, held by the bf16
    rule."""
    b, sq, h, g, e, ps, ppr, n_pages = 4, 3, 8, 2, 64, 16, 12, 40
    q, kp, vp, pt, pos, mask = _paged_case(7, b, sq, h, g, e, ps, ppr,
                                           n_pages)
    bf = pool in ("bfloat16", "bf16_q_int8")
    qt = _t(q).to(cuda, torch.bfloat16 if bf else torch.float32)
    ks = vs = None
    if pool in ("int8", "bf16_q_int8"):
        kp, vp, ks, vs = _int8_pools(kp, vp, cuda)
    else:
        kp, vp = (_t(a).to(cuda, qt.dtype) for a in (kp, vp))
    kw = dict(page_tables=_t(pt).to(cuda), pos=_t(pos).to(cuda),
              slot_mask=_t(mask).to(cuda), k_scale=ks, v_scale=vs)
    got = pa.paged_attention(qt, kp, vp, **kw)
    want = tref.paged_attention(qt, kp, vp, **kw)
    if bf:
        _bf16_close(got, want)
    else:
        _close(got, want, qt.dtype)
    assert not got[~kw["slot_mask"]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("sq", [1, 40])
def test_paged_bf16_wrong_page_probe(cuda, pool, sq):
    """The bf16 tensor-core body over 320-key rows (decode: split keys;
    a 40-row chunk), a masked row exactly zero; then one live page-table
    entry of one row, past its first 64-key tile, pointed at a page of
    another row must fail the check (swapping two of a row's own visible
    pages would prove nothing: attention does not depend on key order).
    With int8 pools, V dequantised with K's scales or with the next kv
    head's scales must fail it too."""
    b, h, g, e, ps, ppr = 4, 8, 2, 64, 16, 20
    n_pages = b * ppr
    rng = np.random.RandomState(18)
    q = rng.randn(b, sq, h, e).astype(np.float32)
    kp = rng.randn(n_pages, ps, g, e).astype(np.float32)
    vp = rng.randn(n_pages, ps, g, e).astype(np.float32)
    pt = rng.permutation(n_pages).reshape(b, ppr).astype(np.int32)
    pos = np.array([0, 150, ppr * ps - sq, 200], np.int32)
    mask = np.array([True, True, True, False])
    ks = vs = None
    if pool == "int8":
        kp, vp, ks, vs = _int8_pools(kp, vp, cuda)
    else:
        kp, vp = (_t(a).to(cuda, torch.bfloat16) for a in (kp, vp))
    qt = _t(q).to(cuda, torch.bfloat16)
    ptt = _t(pt).to(cuda)
    kw = dict(pos=_t(pos).to(cuda), slot_mask=_t(mask).to(cuda),
              k_scale=ks, v_scale=vs)
    got = pa.paged_attention(qt, kp, vp, page_tables=ptt, **kw)
    want = tref.paged_attention(qt, kp, vp, page_tables=ptt, **kw)
    _bf16_close(got, want)
    assert not got[~kw["slot_mask"]].any()
    wrong = ptt.clone()
    wrong[2, 5] = ptt[1, 0]        # keys 80..95 of row 2 from row 1's page
    bad = pa.paged_attention(qt, kp, vp, page_tables=wrong, **kw)
    assert fa.bf16_excess(bad, want) > 1.0
    if pool == "int8":
        for v_bad in (ks, vs.roll(1, dims=1).contiguous()):
            bad = pa.paged_attention(qt, kp, vp, page_tables=ptt,
                                     **dict(kw, v_scale=v_bad))
            assert fa.bf16_excess(bad, want) > 1.0


# ---- the serving kernels at gpt-1.5B's and yi-9b's head widths --------- #


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["causal", "decode", "window_stats"])
def test_slotted_kernel_head_dim_96(cuda, dtype, mode):
    """K3 at gpt-1.5B's width and MHA (24 heads of 96): the float32 body,
    and the bf16 tensor-core body on 128-wide tiles with zero pad
    columns, causal or the window + stats contract, with and without key
    splits (decode splits, a 70-row chunk does not); K rolled over heads
    must fail the check."""
    dt = getattr(torch, dtype)
    b, h, g, e, S = 3, 24, 24, 96, 300
    sq = 70 if mode == "causal" else 1
    q, k, v = (_t(a).to(cuda, dt) for a in _qkv(31, b, sq, h, g, e, S))
    pos = torch.tensor([0, 131, S - sq], dtype=torch.int32, device=cuda)
    if mode == "window_stats":
        want = tref.decode_attention(q, k, v, pos)
        got = pa.decode_attention(q, k, v, pos)
        if dt == torch.bfloat16:
            res = pa.window_excess(got, want)
            assert max(res.values()) <= 1.0, res
            assert pa.window_excess(pa.decode_attention(
                q, k.roll(1, dims=2).contiguous(), v, pos),
                want)["out"] > 1.0
        else:
            (got, (m, l, acc)), (want, (mw, lw, accw)) = got, want
            torch.testing.assert_close(l, lw, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(acc, accw, rtol=1e-4, atol=1e-3)
            _close(got, want, dt)
        return
    got = pa.flash_attention_slotted(q, k, v, pos=pos)
    want = tref.attention(q, k, v, q_offset=pos)
    if dt == torch.bfloat16:
        _bf16_close(got, want)
        bad = pa.flash_attention_slotted(q, k.roll(1, dims=2).contiguous(),
                                         v, pos=pos)
        assert fa.bf16_excess(bad, want) > 1.0
    else:
        _close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("e,h,g", [(96, 24, 24), (128, 32, 4)])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8",
                                  "bf16_q_int8"])
@pytest.mark.parametrize("sq", [1, 40])
def test_paged_kernel_wide_heads(cuda, e, h, g, pool, sq):
    """K4 at gpt-1.5B's width (MHA, 96: the 128-wide body, int8 scales
    over the 96 real columns) and yi-9b's (GQA 8:1, 128), decode and a
    40-row chunk, every pool: float32 q on the CUDA-core body, bf16 q on
    the tensor-core body by the bf16 rule; a masked row exactly zero. One
    live page-table entry pointed at another row's page, and with int8
    pools V dequantised with K's scales or the next kv head's, must fail
    the rule."""
    b, ps, ppr = 4, 16, 20
    n_pages = b * ppr
    rng = np.random.RandomState(32)
    q = rng.randn(b, sq, h, e).astype(np.float32)
    kp = rng.randn(n_pages, ps, g, e).astype(np.float32)
    vp = rng.randn(n_pages, ps, g, e).astype(np.float32)
    pt = _t(rng.permutation(n_pages).reshape(b, ppr).astype(np.int32))
    pos = np.array([0, 150, ppr * ps - sq, 200], np.int32)
    mask = np.array([True, True, True, False])
    bf = pool in ("bfloat16", "bf16_q_int8")
    qt = _t(q).to(cuda, torch.bfloat16 if bf else torch.float32)
    ks = vs = None
    if "int8" in pool:
        kp, vp, ks, vs = _int8_pools(kp, vp, cuda)
    else:
        kp, vp = (_t(a).to(cuda, qt.dtype) for a in (kp, vp))
    pt = pt.to(cuda)
    kw = dict(pos=_t(pos).to(cuda), slot_mask=_t(mask).to(cuda),
              k_scale=ks, v_scale=vs)
    got = pa.paged_attention(qt, kp, vp, page_tables=pt, **kw)
    want = tref.paged_attention(qt, kp, vp, page_tables=pt, **kw)
    assert not got[~kw["slot_mask"]].any()
    if not bf:
        _close(got, want, qt.dtype)
        return
    _bf16_close(got, want)
    wrong = pt.clone()
    wrong[2, 5] = pt[1, 0]         # keys 80..95 of row 2 from row 1's page
    bad = pa.paged_attention(qt, kp, vp, page_tables=wrong, **kw)
    assert fa.bf16_excess(bad, want) > 1.0
    if ks is not None:
        for v_bad in (ks, vs.roll(1, dims=1).contiguous()):
            bad = pa.paged_attention(qt, kp, vp, page_tables=pt,
                                     **dict(kw, v_scale=v_bad))
            assert fa.bf16_excess(bad, want) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["slotted", "window", "paged"])
@pytest.mark.parametrize("sq", [1, 40])
def test_e96_kernels_never_read_the_next_heads_columns(cuda, kernel, sq):
    """q, K and V whose odd heads hold NaN in their first 32 columns (what
    a 128-wide read of an even head's 96-wide row would load as its pad
    columns): the even heads' outputs are finite and within the bf16
    rule of the plain version's."""
    b, h, g, e, S = 3, 24, 24, 96, 256
    q, k, v = (_odd_heads_nan(_t(a).to(cuda, torch.bfloat16))
               for a in _qkv(33, b, sq, h, g, e, S))
    pos = torch.tensor([0, 100, S - sq], dtype=torch.int32, device=cuda)
    if kernel == "paged":
        ps = 16
        kp, vp = (x.reshape(b * S // ps, ps, g, e).contiguous()
                  for x in (k, v))
        kw = dict(page_tables=torch.arange(
            b * S // ps, dtype=torch.int32, device=cuda).reshape(b, -1),
            pos=pos)
        got = pa.paged_attention(q, kp, vp, **kw)
        want = tref.paged_attention(q, kp, vp, **kw)
    elif kernel == "window":
        got = pa.decode_attention(q, k, v, pos + sq)[0]
        want = tref.decode_attention(q, k, v, pos + sq)[0]
    else:
        got = pa.flash_attention_slotted(q, k, v, pos=pos)
        want = tref.attention(q, k, v, q_offset=pos)
    got, want = got[:, :, ::2], want[:, :, ::2]
    assert bool(torch.isfinite(want).all())
    assert bool(torch.isfinite(got).all())
    _bf16_close(got, want)


@pytest.mark.cuda
def test_serving_kernels_refuse_head_dims_they_lack(cuda):
    """A head width without an instantiation (80) raises on the card; it
    does not fall back to the plain version."""
    q, k, v = (_t(a).to(cuda, torch.bfloat16) for a in _qkv(
        34, 2, 1, 4, 4, 80, 64))
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        pa.flash_attention_slotted(q, k, v, pos=pos)
    with pytest.raises(ValueError, match="head dims"):
        pa.paged_attention(q, k.reshape(8, 16, 4, 80), v.reshape(
            8, 16, 4, 80), page_tables=torch.arange(
                8, dtype=torch.int32, device=cuda).reshape(2, 4), pos=pos)


def _rel_close(got, want, rtol=1e-4):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= rtol * scale, (err, scale)


def _bf16_close(got, want):
    worst = fa.bf16_excess(got, want)
    assert worst <= 1.0, worst


FLASH_CASES = [
    dict(causal=True, q_offset=0, sq=150, sk=150),
    dict(causal=True, q_offset=37, sq=90, sk=127),   # sq < sk window
    dict(causal=False, q_offset=0, sq=70, sk=133),   # bidirectional
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, dtype, case):
    """K1 (out, lse) and K1b (dq, dk, dv) against their plain versions on
    the same inputs, the backward fed the same out and lse."""
    dt = getattr(torch, dtype)
    b, h, g, e = 2, 8, 2, 64
    q, k, v = (_t(a).to(cuda, dt) for a in _qkv(
        8, b, case["sq"], h, g, e, case["sk"]))
    kw = dict(causal=case["causal"], q_offset=case["q_offset"])
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = tref.attention(q, k, v, return_lse=True, **kw)
    if dt == torch.float32:
        _close(out, want, dt)
    else:
        _bf16_close(out, want)
    _rel_close(lse, want_lse, 1e-5)
    do = torch.randn(out.shape, generator=torch.Generator(
        device=cuda).manual_seed(9), device=cuda).to(dt)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    plain = tref.attention_bwd(q, k, v, out, do, lse, **kw)
    for a, w in zip(got, plain):
        assert a.dtype == torch.float32
        if dt == torch.float32:
            _rel_close(a, w)
        else:
            _bf16_close(a, w)
    # the differentiable op launches both kernels
    before = dict(fa.LAUNCHES)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o = fa.attention(qg, kg, vg, **kw)
    grads = torch.autograd.grad(o, (qg, kg, vg), do)
    assert fa.LAUNCHES["flash_attention_fwd"] == before[
        "flash_attention_fwd"] + 1
    assert fa.LAUNCHES["flash_attention_bwd"] == before[
        "flash_attention_bwd"] + 1
    for a, w in zip(grads, got):
        torch.testing.assert_close(a, w.to(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("q_offset", [0, 128])
def test_flash_kernels_tile_aligned_bf16(cuda, q_offset):
    """K1 and K1b in bf16 at tile-aligned sizes with the training path's
    heads (32 q heads over 8 kv heads): the tensor-core bodies against the
    plain versions. Faults must fail the same checks: K with its kv heads
    rolled by one and V rolled over kv heads at the keys of the second
    half (forward); the neighbouring head's lse and K rolled over kv heads
    at the keys of the second half (backward, each of dq, dk, dv)."""
    bf = torch.bfloat16
    b, s, h, g, e = 1, 512, 32, 8, 64
    q, k, v = (_t(a).to(cuda, bf) for a in _qkv(13, b, s, h, g, e, s))
    kw = dict(causal=True, q_offset=q_offset)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = tref.attention(q, k, v, return_lse=True, **kw)
    _bf16_close(out, want)
    _rel_close(lse, want_lse, 1e-5)
    for kk, vv in ((k.roll(1, dims=2).contiguous(), v),
                   (k, _late_rolled(v))):
        bad, _ = fa.flash_attention_fwd(q, kk, vv, **kw)
        assert fa.bf16_excess(bad, want) > 1.0
    do = torch.randn(out.shape, generator=torch.Generator(
        device=cuda).manual_seed(14), device=cuda).to(bf)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    plain = tref.attention_bwd(q, k, v, out, do, lse, **kw)
    for a, w in zip(got, plain):
        _bf16_close(a, w)
    for kk, ll in ((k, lse.roll(1, dims=1).contiguous()),
                   (_late_rolled(k), lse)):
        bad = fa.flash_attention_bwd(q, kk, v, out, do, ll, **kw)
        for a, w in zip(bad, plain):
            assert fa.bf16_excess(a, w) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("h,g", [(4, 4), (6, 2), (16, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_gqa_ratios_bf16(cuda, h, g, causal):
    """The bf16 K1 and K1b at other q-heads-per-kv-head ratios (1, 3 and
    8: a 64-row tile then starts mid-position for 3) and two batch rows,
    ragged sizes, against the plain versions."""
    bf = torch.bfloat16
    b, sq, sk, e = 2, 100, 141, 64
    q, k, v = (_t(a).to(cuda, bf) for a in _qkv(15, b, sq, h, g, e, sk))
    kw = dict(causal=causal, q_offset=sk - sq if causal else 0)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = tref.attention(q, k, v, return_lse=True, **kw)
    _bf16_close(out, want)
    _rel_close(lse, want_lse, 1e-5)
    do = torch.randn(out.shape, generator=torch.Generator(
        device=cuda).manual_seed(16), device=cuda).to(bf)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    plain = tref.attention_bwd(q, k, v, out, do, lse, **kw)
    for a, w in zip(got, plain):
        _bf16_close(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("e,h,g,s", [(96, 24, 24, 256), (96, 6, 2, 141),
                                     (128, 8, 2, 200)])
def test_flash_kernels_wide_heads_bf16(cuda, e, h, g, s):
    """K1 and K1b in bf16 at head dims 96 (gpt-1.5B's MHA, run through the
    128-wide tensor-core bodies with zero pad columns) and 128, causal,
    against the plain versions; a ragged size and GQA for the padded
    width. The same probes as at 64 must fail: K with its kv heads rolled
    by one and V rolled over kv heads at the keys of the second half
    (forward); the neighbouring head's lse and K rolled over kv heads at
    the keys of the second half (backward, each of dq, dk, dv). With
    g == h a roll over kv heads is a roll over heads."""
    bf = torch.bfloat16
    b = 2
    q, k, v = (_t(a).to(cuda, bf) for a in _qkv(17, b, s, h, g, e, s))
    kw = dict(causal=True, q_offset=0)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = tref.attention(q, k, v, return_lse=True, **kw)
    assert out.shape == (b, s, h, e)
    _bf16_close(out, want)
    _rel_close(lse, want_lse, 1e-5)
    for kk, vv in ((k.roll(1, dims=2).contiguous(), v),
                   (k, _late_rolled(v))):
        bad, _ = fa.flash_attention_fwd(q, kk, vv, **kw)
        assert fa.bf16_excess(bad, want) > 1.0
    do = torch.randn(out.shape, generator=torch.Generator(
        device=cuda).manual_seed(18), device=cuda).to(bf)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    plain = tref.attention_bwd(q, k, v, out, do, lse, **kw)
    for a, w in zip(got, plain):
        _bf16_close(a, w)
    for kk, ll in ((k, lse.roll(1, dims=1).contiguous()),
                   (_late_rolled(k), lse)):
        bad = fa.flash_attention_bwd(q, kk, v, out, do, ll, **kw)
        for a, w in zip(bad, plain):
            assert fa.bf16_excess(a, w) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_float32_head_dim_96(cuda, causal):
    """A float32 caller at head dim 96 runs the CUDA-core bodies (no
    raise), within the float32 rules: out 2e-5 absolute, lse 1e-5
    relative, dq, dk, dv 1e-4 of the plain tensor's max |value|."""
    b, sq, h, g, e = 2, 70, 6, 3, 96
    q, k, v = (_t(a).to(cuda) for a in _qkv(19, b, sq, h, g, e, sq))
    kw = dict(causal=causal, q_offset=0)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = tref.attention(q, k, v, return_lse=True, **kw)
    _close(out, want, torch.float32)
    _rel_close(lse, want_lse, 1e-5)
    do = torch.randn(out.shape, generator=torch.Generator(
        device=cuda).manual_seed(20), device=cuda)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    for a, w in zip(got, tref.attention_bwd(q, k, v, out, do, lse, **kw)):
        _rel_close(a, w)


@pytest.mark.cuda
def test_flash_kernels_refuse_head_dims_they_lack(cuda):
    """A head width without an instantiation raises on the card; it does
    not fall back to the plain version."""
    q, k, v = (_t(a).to(cuda, torch.bfloat16) for a in _qkv(
        21, 1, 64, 4, 4, 80, 64))
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd(q, k, v, causal=True)


def _xent_case(cuda, n, w_dtype):
    gen = torch.Generator(device=cuda).manual_seed(10)
    d, vocab = 136, 1000
    h = torch.randn((n, d), generator=gen, device=cuda)
    table = (0.3 * torch.randn((vocab, d), generator=gen, device=cuda)).to(
        getattr(torch, w_dtype))
    lab = torch.randint(0, vocab, (n,), generator=gen, device=cuda)
    mask = (torch.rand((n,), generator=gen, device=cuda) > 0.25).float()
    return h, table, lab, dict(chunk=256, mask=mask, denom=float(n))


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype,n", [("float32", 300), ("bfloat16", 300),
                                       ("bfloat16", 64)])
def test_fused_xent_kernel_matches_plain(cuda, w_dtype, n):
    """K2: ragged rows (300, or 64: one partial row tile), d = 136 (a
    ragged k tile of the bf16 tensor-core body) and vocab 1000 over chunks
    of 256 (a ragged vocab tile), a mask that zeroes rows, the head a
    transposed view of a [vocab, d] table; a table shifted by one vocab
    tile must fail the check."""
    h, table, lab, kw = _xent_case(cuda, n, w_dtype)
    loss, (dh, dw) = fx.softmax_xent(h, table.t(), lab, **kw)
    wl, (wdh, wdw) = tref.softmax_xent(h, table.t(), lab, **kw)
    _rel_close(loss.reshape(1), wl.reshape(1), 1e-5)
    _rel_close(dh, wdh)
    _rel_close(dw, wdw)
    assert dw.shape == (h.shape[1], table.shape[0])
    assert dw.t().is_contiguous()
    bad, _ = fx.softmax_xent(h, table.roll(128, 0).t(), lab, **kw)
    assert abs(bad.item() - wl.item()) > 1e-5 * abs(wl.item())


@pytest.mark.cuda
def test_fused_xent_bf16_computes_the_lo_term(cuda):
    """The bf16 body splits h into two bf16 terms: fed h rounded to bf16
    (no lo term), its dW must fail the check against the plain version of
    the float32 h."""
    h, table, lab, kw = _xent_case(cuda, 300, "bfloat16")
    _, (_, wdw) = tref.softmax_xent(h, table.t(), lab, **kw)
    _, (_, dw) = fx.softmax_xent(h.bfloat16().float(), table.t(), lab, **kw)
    err = (dw - wdw).abs().max().item()
    assert err > 1e-4 * wdw.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype,n", [("float32", 300), ("bfloat16", 300),
                                       ("bfloat16", 64)])
def test_fused_xent_kernel_untied_head(cuda, w_dtype, n):
    """K2 over an untied head read in place as a contiguous [d, vocab]
    matrix (gpt-1.5B's head.w): the same ragged rows, d and vocab as the
    table case, under the same float32 rule (loss 1e-5 relative, dh and
    dW 1e-4 of the plain tensor's max |value|); dW comes back contiguous
    [d, vocab]. Probe: the same bytes read as the transposed view of a
    [vocab, d] table must fail the check."""
    h, table, lab, kw = _xent_case(cuda, n, w_dtype)
    head = table.t().contiguous()                  # [d, vocab]
    loss, (dh, dw) = fx.softmax_xent(h, head, lab, **kw)
    wl, (wdh, wdw) = tref.softmax_xent(h, head, lab, **kw)
    _rel_close(loss.reshape(1), wl.reshape(1), 1e-5)
    _rel_close(dh, wdh)
    _rel_close(dw, wdw)
    assert dw.shape == head.shape and dw.is_contiguous()
    bad, (_, bdw) = fx.softmax_xent(
        h, head.reshape(head.shape[1], head.shape[0]).t(), lab, **kw)
    assert abs(bad.item() - wl.item()) > 1e-5 * abs(wl.item())
    assert (bdw - wdw).abs().max().item() > 1e-4 * wdw.abs().max().item()
    # a head layout no kernel reads raises; it does not fall back
    with pytest.raises(ValueError, match="w_head"):
        fx.softmax_xent(h, head[:, : head.shape[1] - 4], lab, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["table", "head"])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_fused_xent_over_vocab_shards(cuda, w_dtype, layout):
    """K2's two passes apart over two vocabulary shards of 512 (each its
    own contiguous tensor: [512, d] table rows or a [d, 512] head block),
    labels local to the shard and -1 elsewhere: each shard's pass 1
    against its plain version (rows of the other shard get label logit 0
    exactly); the shards' statistics combined with a max and a sum
    against the whole-vocab kernel's loss; pass 2 with the combined lse
    against the whole-vocab dh (the sum over shards) and dW (the
    concatenation), by K2's float32 rule. Probe: labels not shifted to
    the second shard must fail it."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    n, d, vocab, vloc = 300, 136, 1024, 512
    h = torch.randn((n, d), generator=gen, device=cuda)
    table = (0.3 * torch.randn((vocab, d), generator=gen, device=cuda)).to(
        getattr(torch, w_dtype))
    lab = torch.randint(0, vocab, (n,), generator=gen, device=cuda)
    mask = (torch.rand((n,), generator=gen, device=cuda) > 0.25).float()
    denom = float(n)

    def shard(r):
        rows = table[r * vloc:(r + 1) * vloc].contiguous()
        return rows.t() if layout == "table" else rows.t().contiguous()

    def local(r, shift=True):
        inw = (lab >= r * vloc) & (lab < (r + 1) * vloc)
        return torch.where(inw, lab - r * vloc if shift else lab, -1)

    stats = []
    for r in range(2):
        got = fx.xent_stats(h, shard(r), local(r), chunk=256)
        want = tref.xent_stats(h, shard(r), local(r), chunk=256)
        _rel_close(got[0], want[0], 1e-5)
        _rel_close(got[1], want[1], 1e-5)
        assert bool((got[1][local(r) < 0] == 0).all())
        stats.append(got)
    lses = torch.stack([s_[0] for s_ in stats])
    m = lses.max(0).values
    lse = m + torch.log(torch.exp(lses - m).sum(0))
    labl = stats[0][1] + stats[1][1]
    loss = ((lse - labl) * mask).sum() / denom
    w_full = table.t() if layout == "table" else table.t().contiguous()
    wl, (wdh, wdw) = fx.softmax_xent(h, w_full, lab, chunk=256, mask=mask,
                                     denom=denom)
    _rel_close(loss.reshape(1), wl.reshape(1), 1e-5)
    parts = [fx.xent_grads(h, shard(r), local(r), lse, mask / denom,
                           chunk=256) for r in range(2)]
    _rel_close(parts[0][0] + parts[1][0], wdh)
    _rel_close(torch.cat([p[1] for p in parts], 1), wdw)
    bad = fx.xent_stats(h, shard(1), local(1, shift=False), chunk=256)
    assert (bad[1] - stats[1][1]).abs().max().item() > \
        1e-5 * stats[1][1].abs().max().item()


SLSTM_RTOL = 1e-5


def _slstm_case(seed, b, s, h, e, dtype, device):
    """Gates N(0, 1) in ``dtype``; a state with n > 0; dy and the final
    state's cotangent N(0, 1)."""
    rng = np.random.RandomState(seed)
    xg = _t(rng.randn(b, s, h, 4, e).astype(np.float32)).to(device)
    st = tuple(_t(a.astype(np.float32)).to(device) for a in (
        rng.randn(b, h, e), np.abs(rng.randn(b, h, e)), rng.randn(b, h, e)))
    dy = _t(rng.randn(b, s, h, e).astype(np.float32)).to(device)
    dst = tuple(_t(rng.randn(b, h, e).astype(np.float32)).to(device)
                for _ in range(3))
    return xg.to(dtype), st, dy.to(dtype), dst


def _slstm_close(got, want, dtype):
    """float32 within SLSTM_RTOL of max |plain|; a bf16 output each
    element within one bf16 ulp of the plain version's, which rounds the
    same float32 value (the two compute in float32 in the same order,
    with other exp / tanh / log1p implementations)."""
    if dtype == torch.float32:
        _rel_close(got, want, SLSTM_RTOL)
    else:
        _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 7, 300])
@pytest.mark.parametrize("e,with_state", [(512, True), (512, False),
                                          (40, True)])
def test_slstm_scan_kernel_matches_plain(cuda, dtype, s, e, with_state):
    """K6 against the plain walk: y, the final state and the saved states
    (float32) within SLSTM_RTOL of max |plain|, y by the dtype's rule; at
    one step (a decode step), within a register tile and over many; e
    not a multiple of the block. Chained over two parts it repeats the
    same float32 operations, so it equals the one-pass run bit for bit;
    the gates' i and f swapped must fail the check (where they matter: a
    state or more than one step)."""
    xg, st, _, _ = _slstm_case(30 + s, 2, s, 4, e, dtype, cuda)
    st = st if with_state else None
    before = sl.LAUNCHES["slstm_scan"]
    y, fin, states = sl.slstm_scan(xg, state=st, return_state=True,
                                   save_states=True)
    assert sl.LAUNCHES["slstm_scan"] == before + 1
    wy, wfin, wstates = tref.slstm_walk(xg, st, save_states=True)
    assert y.dtype == dtype and fin[0].dtype == torch.float32
    _slstm_close(y, wy, dtype)
    for g, w in zip(fin, wfin):
        _rel_close(g, w, SLSTM_RTOL)
    _rel_close(states, wstates, SLSTM_RTOL)
    assert torch.equal(sl.slstm_scan(xg, state=st), y)
    half = s // 2
    y1, st1 = sl.slstm_scan(xg[:, :half].contiguous(), state=st,
                            return_state=True)
    y2, st2 = sl.slstm_scan(xg[:, half:].contiguous(), state=st1,
                            return_state=True)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert all(torch.equal(a, b_) for a, b_ in zip(st2, fin))
    # one step from a zero state gives y = sigmoid(o) tanh(z) whatever i
    # and f are, so the probe needs a state or a second step
    if s > 1 or with_state:
        bad = sl.slstm_scan(xg[:, :, :, [1, 0, 2, 3]].contiguous(),
                            state=st)
        assert (bad.float() - wy.float()).abs().max().item() > \
            4 * 2**-7 * wy.float().abs().max().item()
    with pytest.raises(ValueError, match="dtype"):
        sl.slstm_scan(xg.double())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,e,with_state", [
    (2, 1, 512, True), (2, 5, 40, False), (2, 300, 512, True),
    (2, 2048, 512, False), (1, 2048, 512, True)])
def test_slstm_scan_bwd_kernel_matches_plain(cuda, dtype, b, s, e,
                                             with_state):
    """K6b against the plain reverse walk (``ref.slstm_scan_bwd``, the
    same order of operations) from the states K6 saved: dgates by the
    dtype's rule, the initial state's cotangent within SLSTM_RTOL of the
    largest |plain| of the three (from a zero state dm's true value is 0
    and both read rounding noise); at the training length of 2048. Two
    runs equal bit for bit (no atomics); the training op's autograd equal
    to it; the saved states rolled by a step must fail the check."""
    xg, st, dy, dst = _slstm_case(40 + s, b, s, 4, e, dtype, cuda)
    st = st if with_state else None
    _, states = sl.slstm_scan(xg, state=st, save_states=True)
    before = sl.LAUNCHES["slstm_scan_bwd"]
    dg, d0 = sl.slstm_scan_bwd(xg, dy, states, dst)
    assert sl.LAUNCHES["slstm_scan_bwd"] == before + 1
    wdg, wd0 = tref.slstm_scan_bwd(xg, dy, states, dst)
    assert dg.dtype == dtype
    _slstm_close(dg, wdg, dtype)
    scale = max(w.abs().max().item() for w in wd0)
    for g, w in zip(d0, wd0):
        assert (g - w).abs().max().item() <= SLSTM_RTOL * scale
    again, _ = sl.slstm_scan_bwd(xg, dy, states, dst)
    assert torch.equal(again, dg)
    x = xg.clone().requires_grad_(True)
    y = ops.slstm_scan_train(x)
    (g,) = torch.autograd.grad(y, x, dy)
    want, _ = sl.slstm_scan_bwd(xg, dy, sl.slstm_scan(
        xg, save_states=True)[1])
    assert torch.equal(g, want)
    if s > 1:
        bad, _ = sl.slstm_scan_bwd(xg, dy, states.roll(1, dims=2)
                                   .contiguous(), dst)
        assert (bad.float() - wdg.float()).abs().max().item() > \
            4 * 2**-7 * wdg.float().abs().max().item()
