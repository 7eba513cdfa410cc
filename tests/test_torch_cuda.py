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
relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
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
