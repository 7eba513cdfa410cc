"""The reference's three llama-class dense decoders in the port: yi-9b,
minitron-4b and phi4-mini-3.8b (GQA, RMSNorm, SwiGLU, RoPE, an untied
head), on the CPU against the JAX package.

* the paged engine: reduced config with ``overrides=dict(pp=1,
  microbatches=1)`` (yi-9b keeps its vpp 3), 4 slots, ``max_seq`` 32,
  page size 4, six staggered requests with chunked prefill and a shared
  prefix: the port's ``ServeEngine`` greedy streams equal the reference
  engine's, and so do its step counts and prefix hits;
* one train step of the reduced config at pp 1 (the reference's vpp:
  3 for yi-9b, 2 for the others; zeropp, two micro-batches in one unit,
  seq 16) against ``jax.value_and_grad`` of the reference's
  ``reference_loss`` on the same params and batch. The JAX tick engine
  leaves ``reference_loss`` at vpp > 2, so the step is held to the
  single-device loss, not to the JAX pipeline.

Configs and ParamSpecs field for field are in
``tests/test_torch_configs.py``. Params cross in one process
(``params.from_reference``). Tolerances: the streams are equal; the loss
within 1e-5 relative and every gradient max |diff| <= 1e-4 * max |ref|
(float32 sums in another order), as ``tests/test_torch_slots.py`` holds
llama's vpp 4 step. minitron-4b and phi4-mini reduce to head_dim 12, so
they run the plain versions only (the kernels take 64, 96 and 128).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, leaving the cores to the other test
# workers
torch.set_num_threads(1)

from repro.api import get_arch as jget_arch  # noqa: E402
from repro.api import session as jsession  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402

ARCHS = ["yi-9b", "minitron-4b", "phi4-mini-3.8b"]
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
SERVE = dict(max_slots=4, max_seq=32, prefill_chunk=4, page_size=4,
             overrides=dict(pp=1, microbatches=1))


def _workload():
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 256, size=8).astype(np.int32)
    out = []
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


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_streams_equal_reference(arch):
    js = jsession(arch, mode="serve", data=1, **SERVE)
    ts = tsession(arch, device="cpu", **SERVE)
    assert (ts.cfg.norm, ts.cfg.act, ts.cfg.tie_embeddings) == (
        "rmsnorm", "swiglu", False)
    jparams = js.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_reference(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    want, jstats = _serve(js, jparams)
    got, tstats = _serve(ts, tp)
    assert got == want
    assert [len(t) for t in got] == [g for _, g in _workload()]
    assert (tstats.prefill_steps, tstats.decode_steps,
            tstats.prefix_hits) == (jstats.prefill_steps,
                                    jstats.decode_steps, jstats.prefix_hits)
    assert tstats.prefix_hits > 0
    assert ts.describe()["kernels"]["counters"].get("ref_paged", 0) > 0


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference_loss_and_grads(arch):
    cfg, rc = jget_arch(arch).reduced()
    ov = dict(pp=1, vpp=rc.vpp, microbatches=2, unit=2, schedule="zeropp")
    rc = dataclasses.replace(rc, **ov)
    jp = jax.tree.map(np.asarray, jmodel.init_all_params(
        cfg, rc, jax.random.PRNGKey(0)))
    ts = tsession(arch, mode="train", seq_len=16, device="cpu",
                  overrides=ov)
    batch = ts.stream(seed=3).batch(0)
    tokens, labels = (np.asarray(batch[k]) for k in ("tokens", "labels"))
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.reference_loss(cfg, rc, p, tokens, labels)))(jp)
    want = float(want)
    tp = tparams.from_reference(jp, device="cpu")
    grads, m = ts.train_step(tp, batch)
    got = float(m["loss_sum"])
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    n = 0
    for path, w in _leaves(jax.tree.map(np.asarray, jgrads)):
        g = grads
        for k in path:
            g = g[k]
        assert float(np.abs(w).max()) > 0, path
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))
