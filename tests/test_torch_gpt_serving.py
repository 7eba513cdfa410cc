"""The port's GPT serving slice (the paper's ``gpt_paper``) against the JAX
package, on the CPU.

* ``blocks.norm_fwd`` (LayerNorm: eps 1e-5, its bias, float32 statistics
  cast back) and ``blocks.ffn_fwd`` (the GELU MLP, tanh approximation)
  vs the reference's ``norm_fwd`` and ``ffn_fwd``, in float32 and in
  bf16 (RMSNorm and SwiGLU too, the same functions' other branches);
* reduced gpt_paper (LayerNorm, the GELU MLP, an untied head, MHA) with
  ``overrides=dict(pp=1, microbatches=1)``, 4 slots, ``max_seq`` 32 and
  six staggered requests (slot reclaim, chunked prefill of width 4, a
  shared prompt prefix): the port's ``ServeEngine`` greedy streams equal
  the reference engine's in the contiguous, paged and paged-int8
  layouts, and one batched prefill step with ``want_logits`` returns
  the same logits;
* the serving CLI on reduced gpt_paper prints ``SERVE_OK``.

Params cross in one process (``params.from_reference``). Tolerances:
single functions within 1e-5 of the largest reference value in float32
(sums of tens of float32 terms in another order) and within one bf16
ulp of it in bf16; prefill logits within 1e-4 absolute (2e-3 with int8
pages, where a K/V value the two libraries compute an ulp apart can
round to the neighbouring int8 step), as ``tests/test_torch_serving.py``
holds llama.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, leaving the cores to the other test
# workers
torch.set_num_threads(1)

from repro.api import session as jsession  # noqa: E402
from repro.configs import gpt_paper as jgpt  # noqa: E402
from repro.configs import llama3p2_1b as jllama  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402

ARCH = "gpt_paper"
LAYOUTS = {
    "contiguous": {},
    "paged": dict(page_size=4),
    "paged_int8": dict(page_size=4, kv_cache_dtype="int8"),
}
COMMON = dict(max_slots=4, max_seq=32, prefill_chunk=4,
              overrides=dict(pp=1, microbatches=1))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _limit(want, dtype):
    """1e-5 of the largest |reference| in float32, one bf16 ulp of it in
    bf16."""
    scale = float(np.abs(want).max())
    return scale * (1e-5 if dtype == "float32" else 2.0 ** -7)


def _pair(rng, shape, jdt, tdt, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norm_fwd_equals_reference(norm, dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = jgpt.reduced()[0] if norm == "layernorm" else jllama.reduced()[0]
    rng = np.random.default_rng(10)
    jx, tx = _pair(rng, (3, 5, cfg.d_model), jdt, tdt, 2.0)
    js, ts = _pair(rng, (cfg.d_model,), jdt, tdt)
    jb, tb = _pair(rng, (cfg.d_model,), jdt, tdt)
    jp, tp = {"n.scale": js}, {"n.scale": ts}
    if norm == "layernorm":
        jp["n.bias"], tp["n.bias"] = jb, tb
    want = np.asarray(jblocks.norm_fwd(cfg, jp, "n", jx), np.float32)
    got = tblocks.norm_fwd(cfg, tp, "n", tx)
    assert got.dtype == tdt
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= _limit(want, dtype), err


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ["gelu_mlp", "swiglu"])
def test_ffn_fwd_equals_reference(act, dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = jgpt.reduced()[0] if act == "gelu_mlp" else jllama.reduced()[0]
    d, f = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(11)
    jx, tx = _pair(rng, (3, 5, d), jdt, tdt)
    names = (("wi", (d, f)), ("wd", (f, d))) if act == "gelu_mlp" else (
        ("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d)))
    jp, tp = {}, {}
    for n, shape in names:
        jp[f"f.{n}"], tp[f"f.{n}"] = _pair(rng, shape, jdt, tdt,
                                           shape[0] ** -0.5)
    ctx = types.SimpleNamespace(cfg=cfg)
    want = np.asarray(jblocks.ffn_fwd(ctx, jp, "f", jx), np.float32)
    got = tblocks.ffn_fwd(ctx, tp, "f", tx)
    assert got.dtype == tdt
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= _limit(want, dtype), err


def _workload():
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 256, size=8).astype(np.int32)
    out = []
    # prompt lengths that leave chunks of width 4 or 1 only (fewer distinct
    # step shapes for the reference to compile)
    for i, (p, g) in enumerate([(5, 4), (9, 6), (4, 3), (12, 5), (8, 2),
                                (13, 6)]):
        toks = rng.randint(0, 256, size=p).astype(np.int32)
        if i in (1, 3, 5):          # shared prompt prefix (radix hits)
            toks[:8] = prefix
        out.append((toks, g))
    return out


def _serve(sess, params):
    eng = sess.serve_engine(params)
    reqs = [eng.submit(t, max_gen=g) for t, g in _workload()]
    eng.run_until_idle()
    return [r.result(timeout=5) for r in reqs], eng.stats


@pytest.fixture(scope="module")
def reference_params():
    sess = jsession(ARCH, mode="serve", data=1, **COMMON)
    params = sess.init_params(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gpt_engine_streams_and_logits_equal_reference(layout,
                                                       reference_params):
    jparams, host = reference_params
    kw = dict(COMMON, **LAYOUTS[layout])
    js = jsession(ARCH, mode="serve", data=1, **kw)
    ts = tsession(ARCH, device="cpu", **kw)
    assert ts.cfg.norm == "layernorm" and ts.cfg.act == "gelu_mlp"
    tparams = from_reference(host, device="cpu")
    assert {"final_norm.bias", "head.w"} <= set(tparams["io"])

    want, jstats = _serve(js, jparams)
    got, tstats = _serve(ts, tparams)
    assert got == want
    assert [len(t) for t in got] == [g for _, g in _workload()]
    assert (tstats.prefill_steps, tstats.decode_steps) == \
        (jstats.prefill_steps, jstats.decode_steps)
    assert tstats.prefix_hits == jstats.prefix_hits
    counters = ts.describe()["kernels"]["counters"]
    assert counters.get("ref_paged" if "page_size" in kw
                        else "ref_attention", 0) > 0

    # one batched prefill with full logits, on fresh caches: staggered
    # per-slot positions, one masked slot
    n = js.max_slots
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(0, 256, size=(n, 4)).astype(np.int32),
             "pos": np.array([0, 4, 0, 9], np.int32),
             "slot_mask": np.array([True, True, False, True])}
    if "page_size" in kw:
        pt = np.arange(n * js.pages_per_slot, dtype=np.int32)
        batch["page_tables"] = pt.reshape(n, js.pages_per_slot)
    jtok, jlog, _ = js.serve_step_batched(jparams, js.init_caches(), batch,
                                          want_logits=True)
    ttok, tlog, _ = ts.serve_step_batched(tparams, ts.init_caches(), batch,
                                          want_logits=True)
    atol = 2e-3 if kw.get("kv_cache_dtype") == "int8" else 1e-4
    np.testing.assert_allclose(np.asarray(tlog), np.asarray(jlog), atol=atol)
    # greedy tokens agree wherever the top two logits are further apart
    # than the two implementations may differ
    top2 = np.sort(np.asarray(jlog), axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * atol
    assert clear.sum() >= n - 1
    np.testing.assert_array_equal(np.asarray(ttok)[clear],
                                  np.asarray(jtok)[clear])


def test_launch_serve_gpt_cpu_prints_serve_ok(capsys):
    """The serving CLI on reduced gpt_paper (paged int8 pages, chunked
    prefill) on the CPU: every request finishes through the plain
    paged version."""
    from repro_torch.launch import serve as tlaunch

    tlaunch.main(["--arch", "gpt_paper", "--device", "cpu", "--slots", "4",
                  "--n-requests", "6", "--prompt", "12", "--gen", "6",
                  "--page-size", "4", "--kv-cache-dtype", "int8",
                  "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "serving gpt-smoke on cpu" in out
    assert "'ref_paged'" in out and out.rstrip().endswith("SERVE_OK")
