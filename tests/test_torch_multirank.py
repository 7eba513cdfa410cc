"""repro_torch on a mesh of ranks against the JAX package, on the CPU.

One spawn of four single-threaded gloo processes
(``tests/torch_multirank_worker.py``) runs, in order:

* reduced llama3.2-1b at data 2 x pp 2 (tied table, vocabulary-sharded);
* reduced llama3.2-1b at pp 2 x groups 2 (cross-group butterfly);
* reduced gpt_paper at data 2 x pp 2 (untied, vocabulary-sharded
  ``head.w``; LayerNorm, GELU MLP, vpp 2);
* the sharded embedding lookup and grad at data 4, on ids that overflow
  the all-to-all's capacity.

The train cases use zeropp, 4 micro-batches in units of 2, seq 16 (as the
reference's ``case_train_equiv``), float32, params and batch drawn with
numpy. Each is held:

* loss and every re-assembled gradient (``params.unshard``) against
  ``jax.value_and_grad(reference_loss)`` on the same params (drawn with
  numpy in the reference's layout) and batch:
  loss 1e-5 relative, each gradient max |diff| <= 1e-4 * max |ref|
  (measured: loss 1.6e-7, gradients at most 1.1e-6);
* against the port's one-rank step on the same model (pp = 1, vpp = 2,
  the layers re-stacked by ``params.relayout``): loss and each gradient
  within 1e-5 (measured: at most 6.3e-7);
* ``emb_dropped`` against the reference's capacity rule (``cap = max(8,
  ceil(2 n / dsize))`` per micro-batch and destination);
* one AdamW step: the re-assembled params and ``grad_norm`` against
  ``repro.optim.adamw.apply_updates`` on the full tree, fed the same
  re-assembled grads (norm 1e-5 relative, params 1e-4 of max |ref|).

The launcher: the four-rank CPU CLI prints ``TRAIN_OK`` with a falling
loss; a rank that fails makes it exit non-zero; ``nccl`` with ranks
sharing a device is refused, naming ``--backend gloo``.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.configs import gpt_paper as tgpt  # noqa: E402
from repro_torch.configs import llama3p2_1b as tllama  # noqa: E402
from repro_torch.core.comm import MeshShape  # noqa: E402
from repro_torch.core.pipeline import Runtime  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

import torch_multirank_worker as worker  # noqa: E402

WORLD, SEQ, MB, UNIT = 4, 16, 4, 2
GRAD_RTOL, STEP_RTOL, LOSS_RTOL = 1e-4, 1e-5, 1e-5
OPTIM = dict(lr=1e-2)
TRAIN = {   # name: (arch, data, pp, groups)
    "llama_d2_pp2": ("llama3.2-1b", 2, 2, 1),
    "llama_pp2_g2": ("llama3.2-1b", 1, 2, 2),
    "gpt_d2_pp2": ("gpt_paper", 2, 2, 1),
}
EMBED = dict(name="embed_d4", kind="embed", data=4, vocab=256, d=8,
             b=2, s=16)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t):
    return t.detach().cpu().float().numpy()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _numpy_params(cfg, rc, rng):
    """A full tree in the reference's layout (names and [P·V] stacking of
    the port's specs), drawn with numpy under the reference's rules
    (``spec.scale / sqrt(fan_in)`` normals), with the ones and zeros of
    norm scales and biases moved off by 0.05-scale noise."""
    def draw(spec, lead=()):
        shape = lead + spec.shape
        if spec.init in ("ones", "zeros"):
            return ((spec.init == "ones") + 0.05 * rng.randn(*shape)
                    ).astype(np.float32)
        std = spec.scale / np.sqrt(max(spec.shape[0], 1))
        return (std * rng.randn(*shape)).astype(np.float32)

    geo = tmodel.build_geometry(cfg, rc)
    return {"io": {n: draw(sp) for n, sp in
                   sorted(tmodel.io_specs(cfg).items())},
            "segments": {seg.name: {
                n: draw(sp, (geo.seg_stages(seg),)) for n, sp in
                sorted(tmodel.stage_specs(cfg, seg).items())}
                for seg in geo.segments}}


def _train_case(name):
    arch, data, pp, groups = TRAIN[name]
    cfg, rc = tllama.reduced() if arch.startswith("llama") \
        else tgpt.reduced()
    rc = dataclasses.replace(rc, pp=pp, groups=groups, schedule="zeropp",
                             microbatches=MB, unit=UNIT)
    gb = data * groups * MB
    rng = np.random.RandomState(7)
    batch = {k: rng.randint(0, cfg.vocab, (gb, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    ov = dict(pp=pp, groups=groups, vpp=rc.vpp, schedule="zeropp",
              microbatches=MB, unit=UNIT)
    return cfg, rc, dict(name=name, kind="train", arch=arch, data=data,
                         seq=SEQ, overrides=ov, optim=OPTIM,
                         params=_numpy_params(cfg, rc, rng), batch=batch)


def _embed_case():
    c = dict(EMBED)
    rng = np.random.RandomState(11)
    D, vocab = c["data"], c["vocab"]
    vloc = vocab // D
    # ranks 0 and 1 send every row to shard 0 (past its capacity); 2 and
    # 3 spread theirs over the shards
    ids = [rng.randint(0, vloc, (c["b"], c["s"])) for _ in range(2)] + [
        rng.randint(0, vocab, (c["b"], c["s"])) for _ in range(2)]
    c["ids"] = [torch.from_numpy(i.astype(np.int64)) for i in ids]
    c["dx"] = [torch.from_numpy(rng.randn(c["b"], c["s"], c["d"]).astype(
        np.float32)) for _ in range(D)]
    c["table"] = torch.from_numpy(rng.randn(vocab, c["d"]).astype(
        np.float32))
    return c


def _rule_embed_grad(ids, dx, vocab, D):
    """The reference's capacity rule (``repro/core/vocab.py`` embed_grad)
    in numpy: each rank's rows go to their shard's owner in order, at most
    ``cap`` a destination; returns (full table grad, dropped per rank)."""
    vloc = vocab // D
    acc = np.zeros((vocab, dx[0].shape[-1]), np.float64)
    dropped = []
    for r in range(D):
        idf = ids[r].reshape(-1)
        n = idf.size
        cap = max(8, -(-2 * n // D))
        seen = np.zeros(D, int)
        drop = 0
        for i, tok in enumerate(idf):
            dst = tok // vloc
            if seen[dst] < cap:
                acc[tok] += dx[r].reshape(n, -1)[i]
            else:
                drop += 1
            seen[dst] += 1
        dropped.append(drop)
    return acc, dropped


def _spawn(cases, tmp):
    import torch.multiprocessing as mp

    path = os.path.join(tmp, "cases.pt")
    torch.save(cases, path)
    return mp.start_processes(worker.main,
                              args=(WORLD, tlaunch._free_port(), path, tmp),
                              nprocs=WORLD, join=False,
                              start_method="spawn")


def _one_rank(cfg, rc, case):
    """The port's one-rank step on the same model: pp = 1, vpp = 2 (both
    packages' engines leave reference_loss at pp = 1, vpp = 4; ROADMAP.md
    queue 3), the layers re-stacked."""
    rc1 = dataclasses.replace(rc, pp=1, vpp=2, groups=1)
    ov = dict(case["overrides"], pp=1, groups=1, vpp=2)
    gb = case["batch"]["tokens"].shape[0]
    ts = tsession(case["arch"], mode="train", seq_len=SEQ, device="cpu",
                  global_batch=gb, overrides=ov, optim=OPTIM)
    full = tparams.from_reference(case["params"], device="cpu")
    g, m = ts.train_step(tparams.relayout(full, cfg, rc, rc1), case["batch"])
    return rc1, g, m


def _jax_configs(arch, rc):
    """The reference's (ModelConfig, RunConfig) of a case's model: its
    stage layout (pp, vpp) is all ``reference_loss`` reads."""
    jcfg, jrc = jmodel.get_arch(arch).reduced()
    return jcfg, dataclasses.replace(jrc, pp=rc.pp, vpp=rc.vpp)


@functools.lru_cache(maxsize=None)
def _jax_loss(cfg, rc):
    return jax.jit(jax.value_and_grad(
        lambda p, t, lab: jmodel.reference_loss(cfg, rc, p, t, lab)))


_jax_adamw = jax.jit(jadamw.apply_updates, static_argnums=3)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("multirank"))
    built = {n: _train_case(n) for n in TRAIN}
    ctx = _spawn([c for _, _, c in built.values()] + [_embed_case()], tmp)
    out = {}
    # the reference and the one-rank steps while the ranks run
    for name, (cfg, rc, case) in built.items():
        b = case["batch"]
        jcfg, jrc = _jax_configs(TRAIN[name][0], rc)
        loss, grads = _jax_loss(jcfg, jrc)(case["params"], b["tokens"],
                                           b["labels"])
        out[name] = dict(cfg=cfg, rc=rc, case=case, ref_loss=float(loss),
                         ref_grads=jax.tree.map(np.asarray, grads),
                         one_rank=_one_rank(cfg, rc, case))
    while not ctx.join():
        pass
    for name in list(TRAIN) + [EMBED["name"]]:
        ranks = [torch.load(os.path.join(tmp, f"{name}.{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
        out.setdefault(name, {})["ranks"] = ranks
    return out


def _rt(r):
    arch, data, pp, groups = TRAIN[r["case"]["name"]]
    return Runtime(r["cfg"], r["rc"], "cpu", MeshShape(data, pp, groups))


@pytest.mark.parametrize("name", list(TRAIN))
def test_multirank_step_matches_jax_value_and_grad(results, name):
    r = results[name]
    ranks = r["ranks"]
    for got in ranks:   # the loss is summed over the mesh: every rank's
        assert abs(got["loss"] - r["ref_loss"]) <= \
            LOSS_RTOL * abs(r["ref_loss"])
        assert got["aux"] == 0.0
    grads = tparams.unshard(_rt(r), [g["grads"] for g in ranks])
    n = 0
    for path, want in _leaves(r["ref_grads"]):
        got = _get(grads, path)
        assert got.dtype == torch.float32
        assert _rel(_np(got), want) <= GRAD_RTOL, path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))


@pytest.mark.parametrize("name", list(TRAIN))
def test_multirank_step_matches_one_rank_step(results, name):
    r = results[name]
    rc1, g1, m1 = r["one_rank"]
    grads = tparams.relayout(
        tparams.unshard(_rt(r), [g["grads"] for g in r["ranks"]]),
        r["cfg"], r["rc"], rc1)
    loss = r["ranks"][0]["loss"]
    assert abs(loss - float(m1["loss_sum"])) <= STEP_RTOL * abs(loss)
    for path, want in _leaves(g1):
        assert _rel(_np(_get(grads, path)), _np(want)) <= STEP_RTOL, path


@pytest.mark.parametrize("name", list(TRAIN))
def test_multirank_emb_dropped_follows_the_capacity_rule(results, name):
    """Every micro-batch of n = mbs * seq ids at data D drops what its
    destinations' capacity max(8, ceil(2 n / D)) cannot hold: none at
    data <= 2 (cap >= n)."""
    r = results[name]
    arch, data, pp, groups = TRAIN[name]
    toks = r["case"]["batch"]["tokens"]
    vloc = r["cfg"].vocab // data if data > 1 else None
    mbs = toks.shape[0] // (data * groups * MB)
    want = 0
    if vloc is not None:   # each micro-batch: mbs consecutive rows
        for u in toks.reshape(-1, mbs * SEQ):
            cap = max(8, -(-2 * u.size // data))
            counts = np.bincount(u // vloc, minlength=data)
            want += int(np.maximum(counts - cap, 0).sum())
    assert all(g["emb_dropped"] == want for g in r["ranks"])


@pytest.mark.parametrize("name", list(TRAIN))
def test_multirank_adamw_matches_reference_on_the_full_tree(results, name):
    r = results[name]
    rt = _rt(r)
    ranks = r["ranks"]
    grads = tparams.unshard(rt, [g["grads"] for g in ranks])
    got = tparams.unshard(rt, [g["params"] for g in ranks])
    jcfg = jadamw.AdamWConfig(**OPTIM)
    jp = jax.tree.map(jnp.asarray, r["case"]["params"])
    jg = jax.tree.map(lambda t: jnp.asarray(_np(t)), grads)
    want, _, jm = _jax_adamw(jp, jg, jadamw.init_state(jp, jcfg), jcfg)
    norm = float(jm["grad_norm"])
    for g in ranks:
        assert abs(g["grad_norm"] - norm) <= STEP_RTOL * norm
    for path, w in _leaves(jax.tree.map(np.asarray, want)):
        assert _rel(_np(_get(got, path)), w) <= GRAD_RTOL, path


def test_multirank_embed_grad_drops_by_the_reference_rule(results):
    c = _embed_case()
    ranks = results[EMBED["name"]]["ranks"]
    D, vocab = c["data"], c["vocab"]
    ids = [i.numpy() for i in c["ids"]]
    dx = [x.numpy() for x in c["dx"]]
    want, dropped = _rule_embed_grad(ids, dx, vocab, D)
    assert dropped[:2] == [16, 16] and dropped[2:] == [0, 0]
    assert [g["dropped"] for g in ranks] == dropped
    got = torch.cat([g["acc"] for g in ranks]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for r, g in enumerate(ranks):
        np.testing.assert_array_equal(g["emb"].numpy(),
                                      c["table"].numpy()[ids[r]])


# --------------------------------------------------------------------------- #
# The launcher
# --------------------------------------------------------------------------- #


def test_launch_train_four_ranks_cpu_prints_train_ok(capfd):
    tlaunch.main(["--device", "cpu", "--backend", "gloo", "--data", "2",
                  "--pp", "2", "--steps", "3"])
    text = capfd.readouterr().out
    assert "4 ranks (data 2 x groups 1 x pp 2), backend gloo" in text, text
    assert "TRAIN_OK steps=3" in text, text
    losses = [float(line.split()[3]) for line in text.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and losses[-1] < losses[0], losses


def test_launch_train_exits_nonzero_when_a_rank_fails(capfd):
    # every rank's session refuses an architecture it does not know
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--device", "cpu", "--backend", "gloo", "--data",
                      "2", "--steps", "1", "--arch", "no-such-arch"])
    assert e.value.code == 1
    assert "a rank failed" in capfd.readouterr().err


def test_launch_train_refuses_nccl_ranks_sharing_a_device():
    with pytest.raises(SystemExit, match="--backend gloo"):
        tlaunch.main(["--device", "cpu", "--backend", "nccl", "--data",
                      "2", "--steps", "1"])
    with pytest.raises(SystemExit, match="--backend gloo"):
        tlaunch.main(["--device", "cpu", "--data", "2", "--steps", "1"])


def test_multirank_session_needs_a_process_group():
    with pytest.raises(SessionError, match="process group"):
        tsession("llama3.2-1b", mode="train", device="cpu", data=2)
    with pytest.raises(SessionError, match="process group"):
        tsession("llama3.2-1b", mode="train", device="cpu",
                 overrides=dict(pp=2))
