"""The serving slice as a whole: repro_torch's ServeEngine against repro's.

Reduced llama3.2-1b with ``overrides=dict(pp=1, microbatches=1)`` on one
CPU device, 4 slots, six staggered requests (slot reclaim, chunked
prefill of width 4, a shared prompt prefix). The reference's params cross
over through ``params.from_reference`` in the same process. For the
contiguous, paged and paged-int8 cache layouts the port's greedy token
streams must equal the reference engine's, and one batched prefill step
with ``want_logits`` must return the same logits.

Tolerance: float32 logits within 1e-4 absolute (four layers of float32
matmuls summed in different orders; logits are O(1)); 2e-3 with int8
pages, where a K/V value the two libraries compute an ulp apart can round
to the neighbouring int8 step (one step is 1/127 of a page's amax).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, leaving the cores to the other test
# workers (eight spinning OpenMP threads per worker oversubscribe them)
torch.set_num_threads(1)

from repro.api import session as jsession  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402

LAYOUTS = {
    "contiguous": {},
    "paged": dict(page_size=4),
    "paged_int8": dict(page_size=4, kv_cache_dtype="int8"),
}
COMMON = dict(max_slots=4, max_seq=32, prefill_chunk=4,
              overrides=dict(pp=1, microbatches=1))


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
    sess = jsession("llama3.2-1b", mode="serve", data=1, **COMMON)
    params = sess.init_params(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_streams_and_logits_equal_reference(layout, reference_params):
    jparams, host = reference_params
    kw = dict(COMMON, **LAYOUTS[layout])
    js = jsession("llama3.2-1b", mode="serve", data=1, **kw)
    ts = tsession("llama3.2-1b", device="cpu", **kw)
    tparams = from_reference(host, device="cpu")

    want, jstats = _serve(js, jparams)
    got, tstats = _serve(ts, tparams)
    assert got == want
    assert [len(t) for t in got] == [g for _, g in _workload()]
    assert (tstats.prefill_steps, tstats.decode_steps) == \
        (jstats.prefill_steps, jstats.decode_steps)
    assert tstats.prefix_hits == jstats.prefix_hits
    if layout != "contiguous":
        assert tstats.prefix_hits > 0
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


def test_stage_walk_and_scalar_path_agree_with_engine(reference_params):
    """The port alone: params restacked for pp=2 (two stages of two
    layers) serve the same tokens as pp=1, and the scalar-pos
    serve_prefill/serve_decode path reproduces the engine's stream."""
    _, host = reference_params
    one = tsession("llama3.2-1b", device="cpu", **COMMON)
    p1 = from_reference(host, device="cpu")
    seg = p1["segments"]["main"]
    p2 = {"io": p1["io"], "segments": {"main": {}}}
    for n, a in seg.items():   # layer 2s+j of pp=2 is L{j} of stage s
        j, rest = n.split(".", 1)
        j = int(j[1:])
        if j < 2:
            p2["segments"]["main"][n] = torch.stack(
                [a[0], seg[f"L{j + 2}.{rest}"][0]])
    two = tsession("llama3.2-1b", device="cpu",
                   **dict(COMMON, overrides=dict(pp=2, microbatches=1)))
    toks1, _ = _serve(one, p1)
    toks2, _ = _serve(two, p2)
    assert toks1 == toks2

    prompt, g = _workload()[1]     # in every slot row: rows must agree
    rows = one.max_slots
    caches = one.init_caches()
    out, caches = one.serve_prefill(
        p1, caches, {"tokens": np.tile(prompt, (rows, 1))})
    stream = [out.tolist()]
    for t in range(g - 1):
        out, caches = one.serve_decode(p1, caches, {
            "tokens": np.array(stream[-1], np.int32)[:, None],
            "pos": np.int32(len(prompt) + t)})
        stream.append(out.tolist())
    assert [[s[r] for s in stream] for r in range(rows)] == [toks1[1]] * rows
