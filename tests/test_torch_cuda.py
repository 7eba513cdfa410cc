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
|plain| per tensor, and 1e-5 relative for the loss and the log-sum-exp.
The bf16 flash kernels run their products on the tensor cores with P and
dS rounded to bf16, as FlashAttention does, so their out, dq, dk and dv
are held by ``flash_attention.bf16_excess``: each element within
``BF16_RTOL`` (1e-2) of the largest |plain| of its row (one position of
one head), plus one bf16 ulp for the bf16 out
(``tests/test_torch_train_kernels.py`` calibrates it on the CPU); their
log-sum-exp stays within 1e-5 relative.
The selective scan (float32 in and out) walks the recurrence one step at
a time where the plain version scans each chunk in doubling steps: y and
the final state within 1e-5 of the plain tensor's max |value|; the
kernel chained over two halves with h0 repeats the same float32
operations, so it must equal the one-pass run bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_xent as fx  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
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
    _close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["causal", "decode"])
def test_slotted_kernel_head_dim_128(cuda, dtype, mode):
    """K3 at jamba-v0.1-52b's head width (e = ev = 128, 4 q heads a kv
    head): both block heights (BM 16 at decode, 64 for the prefill)."""
    dt = getattr(torch, dtype)
    b, h, g, e, S = 3, 8, 2, 128, 200
    sq = 1 if mode == "decode" else 70
    q, k, v = (_t(a).to(cuda, dt) for a in _qkv(11, b, sq, h, g, e, S))
    pos = torch.tensor([0, 57, S - sq], dtype=torch.int32, device=cuda)
    got = pa.flash_attention_slotted(q, k, v, pos=pos)
    _close(got, tref.attention(q, k, v, q_offset=pos), dt)


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
@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_kernel_matches_plain(cuda, n, with_h0):
    """K5 with s not a multiple of the staged tile or the plain chunk and
    d not a multiple of the block; then chained over two halves."""
    x, dt, A, B, C, D, h0 = _scan_case(12, 3, 300, 200, n, cuda)
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
                     for part in (slice(0, 150), slice(150, None)))
    y1, h1 = ss.selective_scan(first[0], first[1], A, first[2], first[3],
                               D, h0=h0, return_state=True)
    y2, h2 = ss.selective_scan(second[0], second[1], A, second[2],
                               second[3], D, h0=h1, return_state=True)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    # B and C swapped must fail the check
    bad = ss.selective_scan(x, dt, A, C, B, D, h0=h0)
    err = (bad - wy).abs().max().item()
    assert err > 1e-5 * wy.abs().max().item()
    with pytest.raises(ValueError, match="float32"):
        ss.selective_scan(x.double(), dt, A, B, C, D)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_paged_kernel_matches_plain(cuda, pool):
    b, sq, h, g, e, ps, ppr, n_pages = 4, 3, 8, 2, 64, 16, 12, 40
    q, kp, vp, pt, pos, mask = _paged_case(7, b, sq, h, g, e, ps, ppr,
                                           n_pages)
    qt = _t(q).to(cuda, torch.bfloat16 if pool == "bfloat16"
                  else torch.float32)
    ks = vs = None
    if pool == "int8":
        ks = torch.from_numpy(np.abs(kp).max(axis=(1, 3)) / 127.0).to(cuda)
        vs = torch.from_numpy(np.abs(vp).max(axis=(1, 3)) / 127.0).to(cuda)
        kp = (_t(kp).to(cuda) / ks[:, None, :, None]).round().to(torch.int8)
        vp = (_t(vp).to(cuda) / vs[:, None, :, None]).round().to(torch.int8)
    else:
        kp, vp = (_t(a).to(cuda, qt.dtype) for a in (kp, vp))
    kw = dict(page_tables=_t(pt).to(cuda), pos=_t(pos).to(cuda),
              slot_mask=_t(mask).to(cuda), k_scale=ks, v_scale=vs)
    got = pa.paged_attention(qt, kp, vp, **kw)
    want = tref.paged_attention(qt, kp, vp, **kw)
    _close(got, want, qt.dtype)
    assert not got[~kw["slot_mask"]].any()


def _rel_close(got, want, rtol=1e-4):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= rtol * scale, (err, scale)


def _bf16_close(got, want):
    worst = fa.bf16_excess(got, want)
    assert worst <= 1.0, worst


def _late_rolled(x):
    """x with its kv heads rolled by one at the keys of the second half."""
    x = x.clone()
    half = x.shape[1] // 2
    x[:, half:] = x[:, half:].roll(1, dims=2)
    return x


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
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_fused_xent_kernel_matches_plain(cuda, w_dtype):
    """K2: ragged rows (300) and vocab (1000 over chunks of 256), a mask
    that zeroes rows, the head a transposed view of a [vocab, d] table;
    a table shifted by one vocab tile must fail the check."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    n, d, vocab = 300, 136, 1000
    h = torch.randn((n, d), generator=gen, device=cuda)
    table = (0.3 * torch.randn((vocab, d), generator=gen, device=cuda)).to(
        getattr(torch, w_dtype))
    lab = torch.randint(0, vocab, (n,), generator=gen, device=cuda)
    mask = (torch.rand((n,), generator=gen, device=cuda) > 0.25).float()
    kw = dict(chunk=256, mask=mask, denom=float(n))
    loss, (dh, dw) = fx.softmax_xent(h, table.t(), lab, **kw)
    wl, (wdh, wdw) = tref.softmax_xent(h, table.t(), lab, **kw)
    _rel_close(loss.reshape(1), wl.reshape(1), 1e-5)
    _rel_close(dh, wdh)
    _rel_close(dw, wdw)
    assert dw.shape == (d, vocab) and dw.t().is_contiguous()
    bad, _ = fx.softmax_xent(h, table.roll(128, 0).t(), lab, **kw)
    assert abs(bad.item() - wl.item()) > 1e-5 * abs(wl.item())
