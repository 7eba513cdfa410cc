"""phi-3-vision-4.2b in the port: the vision stub's float patch embeddings
in place of token ids, against the JAX package on the same inputs.

* the session's stream (``kind="vision"``) equal to the reference's
  ``SyntheticStream`` with ``np.array_equal``: the token draws first,
  then the patches, so labels and patches match bit for bit;
* one reduced train step (4 ``attn:dense`` layers, pp 1, vpp 2, zeropp,
  two micro-batches in one unit) on a float-embedding batch against
  ``jax.value_and_grad(reference_loss)``: the loss and every gradient,
  ``embed.table``'s exactly zero on both sides (a float batch never
  reads the table), and no embedding lookup or drop counted;
* a float-embedding prefill of every slot (with its logits), then greedy
  decode steps of the sampled ids through the table, equal to the
  reference Session's serve steps; the reduced engine's token-id streams
  equal to the reference engine's.

Params come from ``repro.models.model.init_all_params`` and cross in one
process (``params.from_reference``); inputs are numpy arrays from a seed.
Tolerances, all float32: the loss within 1e-5 relative, every nonzero
gradient within 1e-4 of its largest |reference| (as
``tests/test_torch_jamba_train.py`` holds Jamba's step); prefill logits
within 1e-4 absolute (``tests/test_torch_jamba.py``'s serve rule); the
streams equal. The reduced config's head_dim 16 runs the plain versions
only.
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

ARCH = "phi-3-vision-4.2b"
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
ATOL = 1e-4
SERVE = dict(max_slots=4, max_seq=32, overrides=dict(pp=1, microbatches=1))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_stream_vision_batches_equal_reference():
    """Both sessions' streams at the same shape and seed, two steps."""
    ov = dict(pp=1, microbatches=2)
    js = jsession(ARCH, mode="train", seq_len=16, data=1, overrides=ov)
    ts = tsession(ARCH, mode="train", seq_len=16, device="cpu",
                  overrides=ov)
    for step in (0, 1):
        want, got = js.stream(seed=4).batch(step), ts.stream(seed=4).batch(
            step)
        assert set(got) == set(want) == {"tokens", "labels"}
        assert got["tokens"].dtype == np.float32
        assert got["tokens"].shape == (2, 16, ts.cfg.d_model)
        for k in want:
            assert np.array_equal(got[k], np.asarray(want[k])), k


def test_train_step_equals_reference_loss():
    """Reduced phi3-vision (4 layers, vpp 2, two micro-batches) on a
    float-embedding batch: loss and every gradient against
    ``jax.value_and_grad(reference_loss)``; the table's are zero."""
    cfg, rc = jget_arch(ARCH).reduced()
    assert cfg.frontend == "vision"
    ov = dict(pp=1, vpp=rc.vpp, microbatches=2, unit=2, schedule="zeropp")
    rc = dataclasses.replace(rc, **ov)
    jp = jax.tree.map(np.asarray, jmodel.init_all_params(
        cfg, rc, jax.random.PRNGKey(0)))
    ts = tsession(ARCH, mode="train", seq_len=16, device="cpu",
                  overrides=ov)
    batch = ts.stream(seed=3).batch(0)
    tokens, labels = (np.asarray(batch[k]) for k in ("tokens", "labels"))
    assert tokens.shape == (2, 16, cfg.d_model)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.reference_loss(cfg, rc, p, tokens, labels)))(jp)
    tp = tparams.from_reference(jp, device="cpu")
    grads, m = ts.train_step(tp, batch)
    got = float(m["loss_sum"])
    assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want))
    assert m["emb_dropped"] == 0
    n = 0
    for path, w in _leaves(jax.tree.map(np.asarray, jgrads)):
        g = grads
        for k in path:
            g = g[k]
        if path == ("io", "embed.table"):
            assert not np.any(w) and not torch.any(g)
        else:
            assert float(np.abs(w).max()) > 0, path
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_RTOL * float(np.abs(w).max()), path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))
    # an id batch of the wrong rank is refused with the shape it needs
    with pytest.raises(ValueError, match=r"\[2, 16, 64\]"):
        ts.train_step(tp, dict(batch, tokens=tokens[..., 0]))


def _sessions():
    js = jsession(ARCH, mode="serve", data=1, **SERVE)
    ts = tsession(ARCH, device="cpu", **SERVE)
    jparams = js.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_reference(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return (js, jparams), (ts, tp)


def test_float_prefill_then_greedy_decode_equals_reference():
    """Every slot prefills 8 float patch embeddings (with logits), then
    decodes 5 greedy ids through the table, in both packages."""
    rng = np.random.RandomState(7)
    emb = (rng.standard_normal((4, 8, 64)) * 0.1).astype(np.float32)
    streams, logits = [], []
    for sess, p in _sessions():
        caches = sess.init_caches()
        tok, lg, caches = sess.serve_step_batched(
            p, caches, {"tokens": emb, "pos": np.zeros(4, np.int32)},
            want_logits=True)
        logits.append(np.asarray(lg))
        out = [np.asarray(tok)]
        for i in range(5):
            tok, caches = sess.serve_step_batched(
                p, caches, {"tokens": np.asarray(tok, np.int32)[:, None],
                            "pos": np.full(4, 8 + i, np.int32)})
            out.append(np.asarray(tok))
        streams.append(np.stack(out, 1))
    np.testing.assert_allclose(logits[1], logits[0], atol=ATOL)
    np.testing.assert_array_equal(streams[1], streams[0])
    assert streams[0].shape == (4, 6)


def _workload():
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 256, size=p).astype(np.int32), g)
            for p, g in [(5, 4), (9, 6), (4, 3), (12, 5), (8, 2), (13, 6)]]


def test_engine_streams_equal_reference():
    """The engine takes token-id prompts, as the reference's does."""
    res = []
    for sess, p in _sessions():
        eng = sess.serve_engine(p)
        reqs = [eng.submit(t, max_gen=g) for t, g in _workload()]
        eng.run_until_idle()
        res.append(([r.result(timeout=5) for r in reqs], eng.stats))
    (want, jst), (got, tst) = res
    assert got == want
    assert (tst.prefill_steps, tst.decode_steps) == (jst.prefill_steps,
                                                     jst.decode_steps)
