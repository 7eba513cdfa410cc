"""The bf16 tolerance of the serving attention kernels' tensor-core body,
calibrated on the CPU.

The bf16 paths of K3 (``flash_attention_slotted``: bf16 q over a bf16
cache) and K4 (``paged_attention``: bf16 q over bf16 or int8 pools) run
S = Q K^T and O += P V on the tensor cores (``csrc/attention_tc.cuh``):
exact bf16 products summed in float32, an online softmax over 64-key
tiles, P rounded to bf16 before P V. int8 pools are converted to bf16
exactly, K's scales multiply S's columns and V's scales P's columns
before P is rounded, and l sums the unscaled P. Their out is held to the
plain versions (``kernels/ref.py``, float32 throughout) by
``flash_attention.bf16_excess``: 1e-2 of the largest |plain| of the
element's row plus one bf16 ulp. The emulation below repeats the
kernel's rounding in plain torch; at these sizes it must stay within
half of that limit, and the faults ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` feed the kernels must exceed it.

At decode the kernels split a row's keys over several blocks, each
writing float32 (m, l, unnormalised acc) that a second kernel combines in
fixed order; the last tests emulate that combine and hold it to
``ref.decode_attention``'s stats within 1e-5 relative. The plain versions
are held to the JAX package in ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_cases import late_rolled as _late_rolled  # noqa: E402
from torch_cases import paged_case as _paged_case  # noqa: E402
from torch_cases import qkv as _qkv  # noqa: E402

TILE = 64  # keys a tile of the tensor-core body


def _bf(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float()


def _emulate(q, k, v, pos, ks=None, vs=None):
    """The tensor-core body's out (float32, before its bf16 rounding):
    q [b, sq, h, e], k, v [b, S, g, e] as float32 holding bf16 (or int8)
    values, per-row causal offsets pos [b]; ks, vs [b, S, g] per-key
    scales of int8 keys and values, or None."""
    b, sq, h, e = q.shape
    S, g = k.shape[1], k.shape[2]
    rep, scale = h // g, 1.0 / e ** 0.5
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhe,bkhe->bhqk", q, kr)
    if ks is not None:
        s = s * ks.repeat_interleave(rep, dim=2).permute(0, 2, 1)[:, :, None]
    s = s * scale
    vis = (torch.arange(S)[None, None, :]
           <= (pos[:, None] + torch.arange(sq)[None, :])[:, :, None])
    s = torch.where(vis[:, None], s, float("-inf"))
    vsh = (None if vs is None else
           vs.repeat_interleave(rep, dim=2).permute(0, 2, 1)[:, :, None])
    m = torch.full((b, h, sq), float("-inf"))
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, e))
    for t0 in range(0, S, TILE):
        st = s[..., t0:t0 + TILE]
        mn = torch.maximum(m, st.amax(-1))
        ms = torch.where(torch.isfinite(mn), mn, 0.0)
        p = torch.exp(st - ms[..., None])
        corr = torch.exp(m - ms)
        l = l * corr + p.sum(-1)
        if vsh is not None:
            p = p * vsh[..., t0:t0 + TILE]
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhe->bhqe", p.bfloat16().float(), vr[:, t0:t0 + TILE])
        m = mn
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


def _page_cols(scale, pt, ps):
    """Per-key scales [b, ppr * ps, g] of page-pool scales [n_pages, g]."""
    return scale[pt.long()].repeat_interleave(ps, dim=1)


def _quantise(kp, vp):
    ks = np.abs(kp).max(axis=(1, 3)) / 127.0
    vs = np.abs(vp).max(axis=(1, 3)) / 127.0
    kq = np.round(kp / ks[:, None, :, None]).astype(np.int8)
    vq = np.round(vp / vs[:, None, :, None]).astype(np.int8)
    return (torch.from_numpy(kq), torch.from_numpy(vq),
            torch.from_numpy(ks.astype(np.float32)),
            torch.from_numpy(vs.astype(np.float32)))


# per-row offsets: position 0, a middle row, and a row whose chunk runs
# past the cache (pos + sq > S: its last rows see every key)
SLOTTED_CASES = [
    dict(e=64, S=256, sq=40, pos=(0, 100, 230)),
    dict(e=64, S=256, sq=1, pos=(0, 127, 255)),      # decode
    dict(e=128, S=192, sq=24, pos=(0, 70, 180)),     # Jamba's head width
]


def _slotted_inputs(case, seed=30):
    b, h, g = 3, 8, 2
    q, k, v = (_bf(a) for a in _qkv(seed, b, case["sq"], h, g, case["e"],
                                     case["S"]))
    return q, k, v, torch.tensor(case["pos"], dtype=torch.int32)


@pytest.mark.parametrize("case", SLOTTED_CASES)
def test_slotted_bf16_tolerance_holds_the_kernels_rounding(case):
    """K3's tensor-core rounding stays within half of the bf16 limit
    against the plain version (both outputs in bf16)."""
    q, k, v, pos = _slotted_inputs(case)
    want = tref.attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                          q_offset=pos)
    emu = _emulate(q, k, v, pos).bfloat16()
    worst = fa.bf16_excess(emu, want)
    assert worst <= 0.5, worst


@pytest.mark.parametrize("probe", ["kv_heads_rolled", "late_v_rolled"])
def test_slotted_bf16_tolerance_rejects_probes(probe):
    """K with its kv heads rolled by one, and V rolled over kv heads at the
    keys of the second half only (rows that see no such key stay exact),
    exceed the bf16 limit."""
    q, k, v, pos = (x.bfloat16() if x.is_floating_point() else x
                    for x in _slotted_inputs(SLOTTED_CASES[0]))
    want = tref.attention(q, k, v, q_offset=pos)
    if probe == "kv_heads_rolled":
        bad = tref.attention(q, k.roll(1, dims=2), v, q_offset=pos)
    else:
        bad = tref.attention(q, k, _late_rolled(v), q_offset=pos)
        assert torch.equal(bad[0], want[0])    # row 0 sees keys < 40 only
    assert fa.bf16_excess(bad, want) > 1.0


def _paged_inputs(int8, sq=24):
    """bf16 q over page pools (ps 16, 16 pages a row): per-row offsets at
    0, one row whose chunk runs past the row's keys, and one masked row
    with a stale table."""
    b, h, g, e, ps, ppr, n_pages = 3, 8, 2, 64, 16, 16, 40
    q, kp, vp, pt, _, _ = _paged_case(31, b, sq, h, g, e, ps, ppr, n_pages)
    pos = torch.tensor([0, ppr * ps - sq + 7, 90], dtype=torch.int32)
    mask = torch.tensor([True, True, False])
    pt = torch.from_numpy(pt)
    pt[2] = pt[0]
    q = _bf(q)
    if int8:
        kp, vp, ks, vs = _quantise(kp, vp)
    else:
        kp, vp = _bf(kp), _bf(vp)
        ks = vs = None
    return q, kp, vp, ks, vs, pt, pos, mask, ps


@pytest.mark.parametrize("int8", [False, True])
def test_paged_bf16_tolerance_holds_the_kernels_rounding(int8):
    """K4's tensor-core rounding (int8: exact conversion, K's scales on
    S's columns, V's on P's columns) stays within half of the bf16 limit
    against the plain version; the masked row is exactly zero."""
    q, kp, vp, ks, vs, pt, pos, mask, ps = _paged_inputs(int8)
    kw = dict(page_tables=pt, pos=pos, k_scale=ks, v_scale=vs,
              slot_mask=mask)
    pool = (lambda x: x) if int8 else (lambda x: x.bfloat16())
    want = tref.paged_attention(q.bfloat16(), pool(kp), pool(vp), **kw)
    k = tref.paged_gather(kp.float(), pt)
    v = tref.paged_gather(vp.float(), pt)
    off = torch.where(mask, pos, -q.shape[1])
    cols = (dict(ks=_page_cols(ks, pt, ps), vs=_page_cols(vs, pt, ps))
            if int8 else {})
    emu = _emulate(q, k, v, off, **cols).bfloat16()
    worst = fa.bf16_excess(emu, want)
    assert worst <= 0.5, worst
    assert not emu[~mask].any()


@pytest.mark.parametrize("probe", ["v_with_k_scales", "v_next_head_scales",
                                   "wrong_page"])
def test_paged_bf16_tolerance_rejects_probes(probe):
    """V dequantised with K's scales or with the next kv head's scales
    (int8 pools), and one live page-table entry of one row, past its
    first 64-key tile, pointed at a page of another row, exceed the bf16
    limit."""
    q, kp, vp, ks, vs, pt, pos, mask, _ = _paged_inputs(
        probe != "wrong_page")
    q = q.bfloat16()
    if probe == "wrong_page":
        kp, vp = kp.bfloat16(), vp.bfloat16()
    kw = dict(page_tables=pt, pos=pos, k_scale=ks, v_scale=vs,
              slot_mask=mask)
    want = tref.paged_attention(q, kp, vp, **kw)
    if probe == "wrong_page":
        # keys 80..95 of row 1 from a page of row 0 that row 1 lacks
        wrong = pt.clone()
        wrong[1, 5] = next(p for p in pt[0] if p not in pt[1])
        kw["page_tables"] = wrong
    else:
        kw["v_scale"] = (ks if probe == "v_with_k_scales"
                         else vs.roll(1, dims=1))
    assert fa.bf16_excess(tref.paged_attention(q, kp, vp, **kw), want) > 1.0


# ---- key splits at decode ------------------------------------------------ #


def _stats(q, k, v, valid):
    """(m, l, acc) of ``ref.decode_attention`` over the keys where valid
    [b, S] is set (a split's range)."""
    b, sq, h, e = q.shape
    rep = h // k.shape[2]
    s = torch.einsum("bqhe,bkhe->bhqk", q.float() / e ** 0.5,
                     k.repeat_interleave(rep, dim=2).float())
    s = torch.where(valid[:, None, None], s, float("-inf"))
    m = s.amax(-1)
    ms = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - ms[..., None]), 0.0)
    acc = torch.einsum("bhqk,bkhe->bhqe", p,
                       v.repeat_interleave(rep, dim=2).float())
    return m, p.sum(-1), acc


def _split_combine(q, k, v, cache_len, ns):
    """The key-split decode: row b's T = ceil(cache_len / 64) tiles split
    into ns ranges [z T / ns, (z + 1) T / ns) of whole tiles, each range's
    (m, l, acc), merged in split order as the combine kernel does."""
    S = k.shape[1]
    n_tiles = (cache_len + TILE - 1) // TILE
    kpos = torch.arange(S)[None]
    parts = []
    for z in range(ns):
        lo = z * n_tiles // ns * TILE
        hi = torch.minimum((z + 1) * n_tiles // ns * TILE, cache_len)
        parts.append(_stats(q, k, v, (kpos >= lo[:, None])
                            & (kpos < hi[:, None])))
    m = torch.stack([p[0] for p in parts]).amax(0)
    ms = torch.where(torch.isfinite(m), m, 0.0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mz, lz, az in parts:                   # fixed split order
        w = torch.exp(mz - ms)                 # 0 for an empty split
        l = l + lz * w
        acc = acc + az * w[..., None]
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3), (m, l, acc), parts


@pytest.mark.parametrize("ns", [3, 5])
def test_key_split_combine_equals_decode_attention(ns):
    """Combined splits equal ``ref.decode_attention``'s (m, l, acc) and
    out within 1e-5 relative, with no NaN, including rows whose splits
    see no key (cache_len 0, and 1 key over ns splits) and a split
    boundary inside the row's keys."""
    b, h, g, e, S = 4, 8, 2, 64, 256
    q, k, v = (torch.from_numpy(a) for a in _qkv(32, b, 1, h, g, e, S))
    cl = torch.tensor([0, 1, 130, 256])
    out, (m, l, acc), parts = _split_combine(q, k, v, cl, ns)
    want, (wm, wl, wacc) = tref.decode_attention(q, k, v, cl)
    assert any(bool((p[1] == 0).any()) for p in parts)   # an empty split
    for x in (out, m, l, acc):
        assert not torch.isnan(x).any()
    assert torch.equal(m, wm)                  # -inf where no key
    for x, w in ((l, wl), (acc, wacc), (out, want)):
        err = (x - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item(), err
    assert not out[0].any()


def test_splits_fill_two_waves():
    """The wrapper splits the keys only when the grid holds under two
    blocks an SM: the decode shape (b 8, g 8, 4 q heads a kv head, 2048
    keys) on 132 SMs takes 5 splits, a 512-row prefill chunk 1; the
    splits never outnumber a row's 64-key tiles."""
    assert pa.splits(8, 8, 4, 2048, 132) == 5
    assert pa.splits(8, 8, 4 * 512, 2048, 132) == 1
    assert pa.splits(1, 1, 4, 100, 132) == 2
    assert pa.splits(3, 2, 4 * 70, 200, 132) == 4
