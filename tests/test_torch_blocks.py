"""repro_torch's cached attention layer against ``repro.models.blocks``.

One attention layer, the same numpy params, inputs and caches through
``repro.models.blocks.attn_cached`` (jnp reference or Pallas in interpret
mode) and ``repro_torch.models.blocks.attn_cached``, in the three cache
layouts: per-slot positions, one scalar position, and paged pools (fp32
and int8). The awkward cases are the ones the serve engine produces:
a masked row whose ``pos + s`` runs past the cache end (JAX clamps the
slice start; the port must too), and masked rows with stale page tables
that alias other rows' pages (JAX drops their scatter).

Tolerance: float32, 2e-5 absolute on outputs and float caches. int8
pools written from the layer's own K/V projections may differ by one
quantisation step where a value the two libraries compute an ulp apart
sits on a rounding midpoint; fed identical values, ``_paged_scatter``
must agree byte for byte and its scales exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, leaving the cores to the other test
# workers (eight spinning OpenMP threads per worker oversubscribe them)
torch.set_num_threads(1)

from repro.models import blocks as jblocks  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.models.common import RunConfig as JRunConfig  # noqa: E402
from repro.models.common import rope_tables as jrope  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models.common import ModelConfig, RunConfig  # noqa: E402
from repro_torch.models.common import rope_tables  # noqa: E402

ATOL = 2e-5
D, H, G, E = 32, 4, 2, 16
CFG = dict(name="tiny", n_layers=1, d_model=D, n_heads=H, n_kv_heads=G,
           d_ff=64, vocab=64, d_head=E)
RC = dict(pp=1, vpp=1, microbatches=1, param_dtype="float32",
          compute_dtype="float32")


def _params(rng):
    shapes = {"wq": (D, H, E), "wk": (D, G, E), "wv": (D, G, E),
              "wo": (H, E, D)}
    return {f"mix.{n}": (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


def _run(impl, S, x, cache, pos, *, slot_mask=None, page_tables=None,
         page_size=0, seed=0):
    """attn_cached in both packages; returns ((y, cache) jax, (y, cache)
    torch) as numpy."""
    params = _params(np.random.RandomState(seed))
    jctx = jblocks.LayerCtx(
        cfg=JModelConfig(**CFG), rc=JRunConfig(**RC, kernel_impl=impl),
        rope={E: jrope(S, E, 10_000.0)},
        slot_mask=None if slot_mask is None else jnp.asarray(slot_mask),
        page_tables=None if page_tables is None else jnp.asarray(page_tables),
        page_size=page_size)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jpos = jnp.asarray(pos) if np.ndim(pos) else pos
    jy, jc = jblocks.attn_cached(jctx, jp, "mix", jnp.asarray(x),
                                 {n: jnp.asarray(a) for n, a in cache.items()},
                                 jpos)
    tctx = tblocks.LayerCtx(
        cfg=ModelConfig(**CFG), rc=RunConfig(**RC),
        rope={E: rope_tables(S, E, 10_000.0)},
        slot_mask=None if slot_mask is None else torch.from_numpy(slot_mask),
        page_tables=(None if page_tables is None
                     else torch.from_numpy(page_tables)),
        page_size=page_size)
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tpos = torch.from_numpy(pos) if np.ndim(pos) else pos
    ty, tc = tblocks.attn_cached(tctx, tp, "mix", torch.from_numpy(x),
                                 tcache, tpos)
    for n in tc:   # the port writes into the leaves it was handed
        assert tc[n].data_ptr() == tcache[n].data_ptr()
    return ((np.asarray(jy), {n: np.asarray(a) for n, a in jc.items()}),
            (ty.numpy(), {n: a.numpy() for n, a in tc.items()}))


def _close(a, b):
    (jy, jc), (ty, tc) = a, b
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    assert set(jc) == set(tc)
    for n in jc:
        if jc[n].dtype == np.int8:
            step = np.abs(tc[n].astype(np.int16) - jc[n].astype(np.int16))
            assert step.max() <= 1, n
        else:
            np.testing.assert_allclose(tc[n], jc[n], atol=ATOL, err_msg=n)


@pytest.mark.parametrize("impl", [None, "pallas"])
def test_attn_cached_slot_vector_with_masked_overrun(impl):
    """Per-slot pos: a co-admitted prefill of width 4 writes rows 0 and 2;
    masked row 1 sits at pos 14 of a 16-long cache (pos + s = 18 > S) and
    row 3 at pos 0 — both must come back untouched."""
    rng = np.random.RandomState(1)
    b, s, S = 4, 4, 16
    x = rng.randn(b, s, D).astype(np.float32)
    cache = {n: rng.randn(b, S, G, E).astype(np.float32) for n in "kv"}
    pos = np.array([3, 14, 12, 0], np.int32)
    mask = np.array([True, False, True, False])
    out = _run(impl, S, x, cache, pos, slot_mask=mask)
    _close(*out)
    tc = out[1][1]
    for n in "kv":
        np.testing.assert_array_equal(tc[n][~mask], cache[n][~mask])


def test_attn_cached_scalar_pos_clamps_like_dynamic_update_slice():
    """Scalar pos (serve_prefill/decode): every row writes [pos, pos+s);
    a start past S - s is clamped as jax.lax.dynamic_update_slice does."""
    rng = np.random.RandomState(2)
    b, s, S = 2, 3, 12
    x = rng.randn(b, s, D).astype(np.float32)
    cache = {n: rng.randn(b, S, G, E).astype(np.float32) for n in "kv"}
    for pos in (5, 11):
        _close(*_run(None, S, x, cache, pos))


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_attn_cached_paged_with_stale_tables(kv):
    """Paged pools: rows 0/2 write through their page tables (row 2 into
    a page that already holds tokens, so an int8 scale can grow and force
    a requantisation of that page); masked row 1 has a stale table that
    aliases row 0's pages and must not write."""
    rng = np.random.RandomState(3)
    b, s, ps, ppr, n_pages = 3, 3, 4, 4, 12
    S = ppr * ps
    x = (rng.randn(b, s, D) * 2.0).astype(np.float32)
    pt = np.array([[3, 7, 0, 0],      # sentinel tail
                   [3, 7, 5, 0],      # stale: aliases row 0's pages
                   [1, 9, 2, 11]], np.int32)
    pos = np.array([2, 6, 5], np.int32)
    mask = np.array([True, False, True])
    if kv == "fp32":
        cache = {n: rng.randn(n_pages, ps, G, E).astype(np.float32)
                 for n in "kv"}
    else:
        cache = {}
        for n in "kv":
            f = rng.randn(n_pages, ps, G, E).astype(np.float32) * 0.3
            sc = (np.abs(f).max(axis=(1, 3)) / 127.0).astype(np.float32)
            cache[n] = np.round(f / sc[:, None, :, None]).astype(np.int8)
            cache[f"{n}_scale"] = sc
    out = _run(None, S, x, cache, pos, slot_mask=mask, page_tables=pt,
               page_size=ps)
    _close(*out)
    if kv == "int8":   # the write grew some scales (requantised pages)
        assert (out[1][1]["k_scale"] > cache["k_scale"]).any()


def test_paged_scatter_int8_matches_reference_bytes():
    """``_paged_scatter`` alone on an int8 pool: only the touched pages
    change, untouched pages keep their bytes (ratio exactly 1.0)."""
    rng = np.random.RandomState(4)
    b, s, ps, ppr, n_pages = 2, 5, 4, 3, 8
    new = (rng.randn(b, s, G, E) * 3).astype(np.float32)
    pool = rng.randint(-127, 128, size=(n_pages, ps, G, E)).astype(np.int8)
    scale = (rng.rand(n_pages, G) * 0.01).astype(np.float32)
    pt = np.array([[2, 5, 0], [6, 1, 4]], np.int32)
    pos = np.array([1, 3], np.int32)
    jctx = dataclasses.replace(
        jblocks.LayerCtx(cfg=JModelConfig(**CFG), rc=JRunConfig(**RC),
                         rope={}),
        page_tables=jnp.asarray(pt), page_size=ps)
    jpool, jsc = jblocks._paged_scatter(jctx, jnp.asarray(pool),
                                        jnp.asarray(new), jnp.asarray(pos),
                                        jnp.asarray(scale))
    tctx = tblocks.LayerCtx(cfg=ModelConfig(**CFG), rc=RunConfig(**RC),
                            rope={}, page_tables=torch.from_numpy(pt),
                            page_size=ps)
    tpool, tsc = tblocks._paged_scatter(
        tctx, torch.from_numpy(pool.copy()), torch.from_numpy(new),
        torch.from_numpy(pos), torch.from_numpy(scale.copy()))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    untouched = np.setdiff1d(np.arange(n_pages), [2, 5, 6, 1])
    np.testing.assert_array_equal(tpool.numpy()[untouched], pool[untouched])
