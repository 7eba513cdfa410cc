"""Seeded numpy inputs and fault helpers shared by the repro_torch
attention tests (no jax here: the GPU tests that use them run where jax
is not installed)."""

import numpy as np


def qkv(seed, b, sq, h, g, e, S, ev=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, e).astype(np.float32)
    k = rng.randn(b, S, g, e).astype(np.float32)
    v = rng.randn(b, S, g, ev or e).astype(np.float32)
    return q, k, v


def paged_case(seed, b, sq, h, g, e, ps, ppr, n_pages, ev=None):
    """Pools, staggered pos, sentinel tails (entries past each row's live
    window point at page 0, which another row may own) and one masked
    row with a stale table."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, e).astype(np.float32)
    kp = rng.randn(n_pages, ps, g, e).astype(np.float32)
    vp = rng.randn(n_pages, ps, g, ev or e).astype(np.float32)
    pt = rng.randint(0, n_pages, size=(b, ppr)).astype(np.int32)
    pos = rng.randint(0, ppr * ps - sq + 1, size=b).astype(np.int32)
    live = (pos + sq + ps - 1) // ps
    pt = np.where(np.arange(ppr)[None] < live[:, None], pt, 0)
    mask = np.ones(b, bool)
    mask[1] = False
    return q, kp, vp, pt.astype(np.int32), pos, mask


def late_rolled(x):
    """x [b, s, kv heads, e] (a torch tensor) with its kv heads rolled by
    one at the keys of the second half: a fault of late tiles only."""
    x = x.clone()
    half = x.shape[1] // 2
    x[:, half:] = x[:, half:].roll(1, dims=2)
    return x


def odd_heads_nan(x, cols=32):
    """x [..., heads, e] (a torch tensor) with the first ``cols`` columns
    of every odd head set to NaN: the values a kernel reading 128
    columns from an even head's 96-wide row would run into."""
    x = x.clone()
    x[..., 1::2, :cols] = float("nan")
    return x
