"""The algebra of K5b, the selective-scan backward kernel, in plain
torch, against ``jax.vjp`` of the reference's jnp scan
(``repro/kernels/ref.py`` ``selective_scan``).

``csrc/selective_scan_bwd.cu`` cuts the sequence into chunks of CK steps
that run in parallel. With a_t = exp(dt_t A), pi_t the product of a from
the chunk's first step through t, and chunk k's steps t0 .. t1 - 1:

1. each chunk walks forward from a zero state: its local end state hl_k,
   its decay P_k = pi_{t1-1}, and gh_k = sum_t pi_t C_t dy_t, the
   cotangent it sends into the chunk before it when its own carry is 0;
2. across the chunks: the entry states H_0 = 0, H_{k+1} = P_k H_k + hl_k
   and the carries c_{K-1} = 0, c_{k-1} = gh_k + P_k c_k;
3. each chunk walks forward again from H_k, keeping the state before
   every T-step tile, then walks the tiles back from the carry c_k,
   reusing each tile's recomputed a_t: dx and ddt a step, dA and dD a
   chunk, dB and dC summed over the channels; the chunks' dA and dD are
   summed in chunk order.

``chunked_scan_bwd`` below repeats those steps in the kernel's order of
float32 operations (exp2 of dt A log2(e), dt x once a step), vectorised
over (b, d, n) only. Inputs are Mamba-like with long memory (dt
log-uniform in [1e-3, 1e-1], A = -(1..n) scaled), so the carries and the
entry states matter. Tolerance: each gradient within 1e-5 of the JAX
gradient's max |value| (both float32; the reference solves each chunk in
log space, the kernel one step at a time).
"""

import functools
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402

RTOL = 1e-5
LOG2E = 1.4426950408889634


def chunked_scan_bwd(x, dt, A, B, C, D, dy, *, ck, tile):
    """(dx, ddt, dA, dB, dC, dD) by K5b's decomposition: x, dt, dy [b, s,
    d], A [d, n], B, C [b, s, n], D [d], float32."""
    b, s, d = x.shape
    nck = -(-s // ck)
    a2 = A * LOG2E

    def step(t):
        """a_t [b, d, n] and dt_t x_t B_t, the update's input term."""
        dv = dt[:, t, :, None]
        a = torch.exp2(dv * a2)
        u = (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        return a, u

    def steps(k):
        return range(k * ck, min(s, (k + 1) * ck))

    # 1. the chunks from a zero state
    hl, pd, gh = [], [], []
    for k in range(nck):
        h = torch.zeros(b, d, A.shape[1])
        pi, g = torch.ones_like(h), torch.zeros_like(h)
        for t in steps(k):
            a, u = step(t)
            h = a * h + u
            pi = pi * a
            g = g + pi * (C[:, t, None, :] * dy[:, t, :, None])
        hl.append(h), pd.append(pi), gh.append(g)
    # 2. entry states forward, carries backward
    H, ent = torch.zeros_like(hl[0]), []
    for k in range(nck):
        ent.append(H)
        H = pd[k] * H + hl[k]
    G, car = torch.zeros_like(gh[0]), [None] * nck
    for k in reversed(range(nck)):
        car[k] = G
        G = pd[k] * G + gh[k]
    # 3. each chunk's reverse walk from its entry state and carry
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA_k, dD_k = [], []
    for k in range(nck):
        ts = list(steps(k))
        tiles = [ts[i:i + tile] for i in range(0, len(ts), tile)]
        h, subs = ent[k], []
        for tl in tiles:
            subs.append(h)
            for t in tl:
                a, u = step(t)
                h = a * h + u
        G, dA, dD = car[k], torch.zeros_like(A), torch.zeros(d)
        for tl, h0 in reversed(list(zip(tiles, subs))):
            hist, av = [h0], []
            for t in tl:
                a, u = step(t)
                hist.append(a * hist[-1] + u)
                av.append(a)
            for i in reversed(range(len(tl))):
                t, a = tl[i], av[i]
                dyv = dy[:, t, :, None]
                g = C[:, t, None, :] * dyv + G
                w = g * a * hist[i]
                sgB = (g * B[:, t, None, :]).sum(-1)
                dx[:, t] = dt[:, t] * sgB + D * dy[:, t]
                ddt[:, t] = x[:, t] * sgB + (w * A).sum(-1)
                dA = dA + (dt[:, t, :, None] * w).sum(0)
                dD = dD + (dy[:, t] * x[:, t]).sum(0)
                dB[:, t] = (g * (dt[:, t] * x[:, t])[..., None]).sum(1)
                dC[:, t] = (dyv * hist[i + 1]).sum(1)
                G = a * g
        dA_k.append(dA), dD_k.append(dD)
    return dx, ddt, sum(dA_k), dB, dC, sum(dD_k)


def _inputs(seed, b, s, d, n):
    rng = np.random.RandomState(seed)
    x, dy = rng.randn(b, s, d), rng.randn(b, s, d)
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), size=(b, s, d)))
    A = -np.arange(1, n + 1)[None] * np.exp(0.1 * rng.randn(d, n))
    B, C, D = rng.randn(b, s, n), rng.randn(b, s, n), rng.randn(d)
    return [a.astype(np.float32) for a in (x, dt, A, B, C, D, dy)]


@functools.cache
def _case(s, n):
    """Inputs with b 2, d 6 and the JAX gradients (one compile a shape)."""
    *args, dy = _inputs(s * 10 + n, 2, s, 6, n)
    want = jax.jit(lambda dy_, *a: jax.vjp(
        lambda *b_: jref.selective_scan(*b_, chunk=16), *a)[1](dy_))(
        dy, *args)
    return args, dy, [np.asarray(w, np.float64) for w in want]


@pytest.mark.parametrize("s,n,ck,tile", [
    (1, 4, 8, 4),       # one step: one chunk, one part tile
    (37, 16, 8, 4),     # 5 chunks, the last of 5 steps (a part tile)
    (37, 16, 16, 8),    # 3 chunks, the last of 5 steps
    (48, 8, 16, 8),     # chunks that divide s
])
def test_k5b_decomposition_equals_jax_vjp(s, n, ck, tile):
    args, dy, want = _case(s, n)
    got = chunked_scan_bwd(*map(torch.from_numpy, args),
                           torch.from_numpy(dy), ck=ck, tile=tile)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = np.abs(g.numpy().astype(np.float64) - w).max()
        assert err <= RTOL * np.abs(w).max(), (name, err / np.abs(w).max())
