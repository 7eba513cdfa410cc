"""repro_torch on a mesh of ranks against the JAX package, on the CPU.

One spawn of four single-threaded gloo processes
(``tests/torch_multirank_worker.py``) runs, in order:

* reduced llama3.2-1b at data 2 x pp 2 (tied table, vocabulary-sharded);
* reduced llama3.2-1b at pp 2 x groups 2 (cross-group butterfly);
* reduced gpt_paper at data 2 x pp 2 (untied, vocabulary-sharded
  ``head.w``; LayerNorm, GELU MLP, vpp 2);
* reduced llama3.2-1b at pods 2 x data 2 (pp 1, vpp 2: the pods
  replicate the parameters and all-reduce the gradients);
* variants of the llama data 2 x pp 2 case on its params and batch:
  per-tensor collectives (``coalesce="none"``), ``grad_compress="int8"``
  flat and per-tensor, ``gather_prefetch`` 0 and 2 (the base case runs
  1), and the §4 schedules: ``schedule="auto"`` under the ``a800``
  preset, ``"autogen_gated"`` and ``"auto_profiled"`` with
  ``profile_top_k=2``;
* the sharded embedding lookup and grad at data 4, on ids that overflow
  the all-to-all's capacity;
* the int8 reduces with error feedback, flat and per tensor, at data 4;
* reduced Jamba (Mamba, attention and gathered-MoE layers) at data 2 x
  groups 2, one sequence a micro-batch: loss + router_aux_weight * the
  mean aux, aux_sum and every gradient against ``jax.value_and_grad`` of
  the reference's loss over one-sequence micro-batches
  (``reference_logits`` per sequence: the router's capacity and aux are
  per micro-batch), with the train cases' tolerances;
* checkpoints on the mesh: the llama data 2 x pp 2 and pods 2 x data 2
  cases run two steps under the fault-tolerance controller, saving after
  each step, with a failure injected before the second: every rank
  restores on the same mesh and its state equals two uninterrupted steps
  bit for bit; the step-2 files hold the global leaves
  (``params.unshard`` of the ranks' parts, params and optimizer state),
  and the two pods' restored replicas are equal.

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
  re-assembled grads (norm 1e-5 relative, params 1e-4 of max |ref|);
  at pods 2, the two pods' grads and updated params bit for bit.

The variants: per-tensor collectives and every prefetch distance give
grads equal bit for bit to the base case's (each data-axis sum has two
terms, which commute exactly; gathers are exact); int8 grads are finite
and within 2% of the float32 run's global max |g| (the reference's
``flat_int8`` rule, ``tests/spmd_case.py``). The int8 reduces equal the
JAX package's ``reduce_scatter_flat_int8`` / ``reduce_scatter_grad_int8``
under ``jax.vmap(..., axis_name="data")`` on the same per-rank inputs,
bit for bit: shards and new error buffers.

The §4 variants: under ``auto`` and ``autogen_gated`` the loss and
re-assembled gradients against ``jax.value_and_grad(reference_loss)``
with the rules above; every rank runs the same schedule with the same
table (sha256) — under ``auto`` the reference Session's selection at the
same data 2 x pp 2 — and under ``auto_profiled`` every rank reports the
same winner and the same measured times (each the maximum over the
ranks).

Serving on the mesh (the same spawn): reduced llama3.2-1b at data 2 x
pp 2 (vpp 2, contiguous cache) and at pods 2 x data 2 (pp 1, vpp 2,
paged with prefix sharing), and reduced Jamba at data 2 x groups 2
(contiguous), each through the engine over staggered requests (slot
reclaim; chunked prefill for llama), every rank submitting the same and
ticking with ``run_until_idle``. Held:

* the greedy streams equal the reference engine's on one device (the
  same params, re-stacked for pp 1) with ``==``, on every rank;
* llama at data 2 x pp 2: one batched prefill's logits (staggered
  positions, a masked slot) within 1e-5 of the reference's max |logit|
  in float32 (measured: at most a few ulps); a sampled request
  (temperature 0.8, seed 3) equal to the port's one-rank engine's
  stream; the serve launcher's report logits (every row's prefill and
  decode step) within 1e-5 of the one-rank port's; the scalar-pos ``serve_prefill`` / ``serve_decode`` path
  equal to the engine's stream in every row; a rank submitting another
  prompt makes every rank's engine raise ``SessionError`` at that tick
  (lockstep), and the background thread and an unseeded sampled
  request are refused; a default serve session (its config's pp 2
  alone) built under the group stays on one rank and serves the stream
  of one built without a group;
* the same llama case with ``serve_resident`` (stage rows whole on each
  rank): streams, the batched prefill's logits and the report logits
  equal the case without the knob bit for bit, no FSDP gather on any
  rank, and the logits within 1e-5 of the reference engine's with the
  knob; the serve launcher's rank body (``launch/serve.py serve``) at
  data 2 x pp 2 serving ``contiguous`` then ``contiguous+resident``: the
  same streams, no gather in the resident layout;
* llama paged at pods 2 x data 2: the prefix hits and every
  cross-partition page copy (global ids) equal what the reference's
  engine and ``repro.serving.paging.PagedSlotPool`` decide at shards=4
  on the same requests (a stub session with no device under it);
* the vocabulary-sharded ``greedy_sample`` at data 4 against the
  reference's under ``jax.vmap(axis_name="data")``, with two equal
  table rows in shards 0 and 2: both take the higher shard's row, where
  ``argmax`` over the full row takes the first.

The launcher: the four-rank CPU CLI prints ``TRAIN_OK`` with a falling
loss; a rank that fails makes it exit non-zero; ``nccl`` with ranks
sharing a device is refused, naming ``--backend gloo``; ``--pods``
multiplies the world size.
"""

import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.api import session as jsession  # noqa: E402
from repro.core import fsdp as jfsdp  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.core import vocab as jvocab  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError  # noqa: E402
from repro_torch.api import session as tsession  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import gpt_paper as tgpt  # noqa: E402
from repro_torch.configs import jamba_v0p1_52b as tjamba  # noqa: E402
from repro_torch.configs import llama3p2_1b as tllama  # noqa: E402
from repro_torch.configs import qwen2_moe_a2p7b as tqwen  # noqa: E402
from repro_torch.core.comm import MeshShape  # noqa: E402
from repro_torch.core.pipeline import Runtime  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

import torch_multirank_worker as worker  # noqa: E402

WORLD, SEQ, MB, UNIT = 4, 16, 4, 2
GRAD_RTOL, STEP_RTOL, LOSS_RTOL = 1e-4, 1e-5, 1e-5
OPTIM = dict(lr=1e-2)
TRAIN = {   # name: (arch, data, pp, groups, pods, RunConfig overrides)
    "llama_d2_pp2": ("llama3.2-1b", 2, 2, 1, 1, {}),
    "llama_pp2_g2": ("llama3.2-1b", 1, 2, 2, 1, {}),
    "gpt_d2_pp2": ("gpt_paper", 2, 2, 1, 1, {}),
    "llama_q2_d2": ("llama3.2-1b", 2, 1, 1, 2, dict(vpp=2)),
}
# variants of a TRAIN case on its params and batch: (base, overrides)
VARIANT = {
    "none": ("llama_d2_pp2", dict(coalesce="none")),
    "int8": ("llama_d2_pp2", dict(grad_compress="int8")),
    "int8_none": ("llama_d2_pp2", dict(grad_compress="int8",
                                       coalesce="none")),
    "prefetch0": ("llama_d2_pp2", dict(gather_prefetch=0)),
    "prefetch2": ("llama_d2_pp2", dict(gather_prefetch=2)),
}
# the §4 schedules on the llama data 2 x pp 2 case: (base, overrides,
# SessionSpec knobs)
AUTO = {
    "auto": ("llama_d2_pp2", dict(schedule="auto"),
             dict(cost_preset="a800")),
    "autogen_gated": ("llama_d2_pp2", dict(schedule="autogen_gated"), {}),
    "auto_profiled": ("llama_d2_pp2", dict(schedule="auto_profiled"),
                      dict(profile_top_k=2)),
}
# checkpoint cases on a TRAIN case's session, params and batches: two
# steps under the controller, a failure injected before the second
CKPT = {"ckpt_d2_pp2": "llama_d2_pp2", "ckpt_q2_d2": "llama_q2_d2"}
# serving on the mesh: name -> (arch, data, pods, RunConfig overrides,
# SessionSpec knobs); four slots, float32
SERVE = {
    "serve_d2_pp2": ("llama3.2-1b", 2, 1,
                     dict(pp=2, vpp=2, microbatches=2),
                     dict(max_slots=4, max_seq=32, prefill_chunk=4)),
    # the same case with serve_resident: stage rows whole on each rank
    "serve_d2_pp2_resident": ("llama3.2-1b", 2, 1,
                              dict(pp=2, vpp=2, microbatches=2,
                                   serve_resident=True),
                              dict(max_slots=4, max_seq=32,
                                   prefill_chunk=4)),
    "serve_q2_d2_paged": ("llama3.2-1b", 2, 2,
                          dict(pp=1, vpp=2, microbatches=1),
                          dict(max_slots=4, max_seq=32, prefill_chunk=4,
                               page_size=4)),
    "serve_jamba_d2_g2": ("jamba-v0.1-52b", 2, 1,
                          dict(pp=1, groups=2, microbatches=1),
                          dict(max_slots=4, max_seq=32)),
}
SERVE_LOGIT_RTOL = 1e-5
# a default reduced-llama serve session (its config's pp 2, no other
# axis), built by every rank under the spawn's process group and in this
# process without one
DEFAULT_SERVE = dict(spec=dict(max_slots=2, max_seq=16), seed=5,
                     prompt=np.arange(3, 9, dtype=np.int32), max_gen=4)
TIE = dict(name="tie_d4", kind="tie", data=4, vocab=256, rows=(10, 140))
# the serve launcher's rank body at data 2 x pp 2 over the same requests
# in a gathered and a resident layout (each cuts the params its own way)
SERVE_CLI = dict(name="serve_cli_d2_pp2", kind="serve_cli")
# reduced Jamba (Mamba, attention and MoE layers) trained on data 2 x
# groups 2 (pp 1: its 8 layers do not split into static stage slots),
# four micro-batches of one sequence a rank: held to the reference's
# single-device forward run per sequence, which is what the pipeline's
# micro-batches see (the router's capacity and aux are per micro-batch)
JAMBA = dict(name="jamba_d2_g2", arch="jamba-v0.1-52b", data=2, groups=2)
# reduced qwen2-moe (3 attn:moe layers, padded to 4, each with a shared
# FFN in the flat slab) trained on data 2 x pp 2, four micro-batches of
# one sequence a rank: held, as the Jamba case is, to the reference's
# forward run per sequence at the case's stage layout
QWEN = dict(name="qwen_d2_pp2", arch="qwen2-moe-a2.7b", data=2, pp=2)
# the int8 rule of the reference's flat_int8 case: max |int8 - float32|
# over every gradient, over the float32 run's global max |g|
INT8_RULE = 0.02
EMBED = dict(name="embed_d4", kind="embed", data=4, vocab=256, d=8,
             b=2, s=16)
INT8 = dict(name="int8_d4", kind="int8", data=4,
            # a: ld 0; b: ld 1 (its dim 0 does not divide 4); c: replicated
            shapes={"a": ((8, 6), 0), "b": ((3, 8), 1), "c": ((6, 5), 0)})


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
    arch, data, pp, groups, pods, extra = TRAIN[name]
    cfg, rc = tllama.reduced() if arch.startswith("llama") \
        else tgpt.reduced()
    rc = dataclasses.replace(rc, pp=pp, groups=groups, schedule="zeropp",
                             microbatches=MB, unit=UNIT, **extra)
    gb = pods * data * groups * MB
    rng = np.random.RandomState(7)
    batch = {k: rng.randint(0, cfg.vocab, (gb, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    ov = dict(pp=pp, groups=groups, vpp=rc.vpp, schedule="zeropp",
              microbatches=MB, unit=UNIT)
    return cfg, rc, dict(name=name, kind="train", arch=arch, data=data,
                         pods=pods, seq=SEQ, overrides=ov, optim=OPTIM,
                         params=_numpy_params(cfg, rc, rng), batch=batch)


def _jamba_case():
    cfg, rc = tjamba.reduced()
    rc = dataclasses.replace(rc, pp=1, groups=JAMBA["groups"],
                             schedule="zeropp", microbatches=MB, unit=UNIT)
    gb = JAMBA["data"] * JAMBA["groups"] * MB
    rng = np.random.RandomState(9)
    batch = {k: rng.randint(0, cfg.vocab, (gb, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    ov = dict(pp=1, groups=JAMBA["groups"], vpp=1, schedule="zeropp",
              microbatches=MB, unit=UNIT)
    return cfg, rc, dict(name=JAMBA["name"], kind="train",
                         arch=JAMBA["arch"], data=JAMBA["data"], pods=1,
                         seq=SEQ, overrides=ov, optim=OPTIM,
                         params=_numpy_params(cfg, rc, rng), batch=batch)


def _qwen_case():
    """The qwen data 2 x pp 2 case: (cfg, rc, case)."""
    cfg, rc = tqwen.reduced()
    rc = dataclasses.replace(rc, pp=QWEN["pp"], vpp=1, schedule="zeropp",
                             microbatches=MB, unit=UNIT)
    gb = QWEN["data"] * MB
    rng = np.random.RandomState(13)
    batch = {k: rng.randint(0, cfg.vocab, (gb, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    ov = dict(pp=QWEN["pp"], vpp=1, schedule="zeropp", microbatches=MB,
              unit=UNIT)
    case = dict(name=QWEN["name"], kind="train", arch=QWEN["arch"],
                data=QWEN["data"], pods=1, seq=SEQ, overrides=ov,
                optim=OPTIM, params=_numpy_params(cfg, rc, rng),
                batch=batch)
    return cfg, rc, case


def _jax_per_sequence(case, rc):
    """The reference's loss over one-sequence micro-batches: the mean
    token cross-entropy of ``reference_logits`` run on each sequence
    alone, plus router_aux_weight times the mean of their aux; with its
    gradients and the aux sum. ``rc`` gives the stage layout the case's
    params are stacked in."""
    jcfg, jrc = _jax_configs(case["arch"], rc)
    w = jcfg.moe.router_aux_weight

    def loss(p, tokens, labels):
        logits, aux = jax.vmap(lambda t: jmodel.reference_logits(
            jcfg, jrc, p, t[None]))(tokens)
        lf = logits.reshape(-1, logits.shape[-1]).astype(jnp.float32)
        lse = jax.scipy.special.logsumexp(lf, axis=-1)
        lab = jnp.take_along_axis(lf, labels.reshape(-1)[:, None], 1)[:, 0]
        return (lse - lab).mean() + w * aux.mean(), aux.sum()

    (val, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        case["params"], case["batch"]["tokens"], case["batch"]["labels"])
    return float(val), float(aux), jax.tree.map(np.asarray, grads)


def _variant_case(name, base):
    src, ov = VARIANT[name]
    return dict(base, name=name, overrides=dict(base["overrides"], **ov))


def _auto_case(name, base):
    src, ov, spec = AUTO[name]
    return dict(base, name=name, overrides=dict(base["overrides"], **ov),
                spec=spec)


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


def _int8_case():
    """Per-rank gradients and non-zero feedback buffers drawn with numpy
    (the buffers at a tenth of the gradients' scale, as after a reduce),
    as float32 tensors; each rank's rows [D, ...]."""
    c = dict(INT8)
    rng = np.random.RandomState(13)
    D = c["data"]
    c["specs"] = {n: tcommon.ParamSpec(sh, fsdp_dim=fd)
                  for n, (sh, fd) in c["shapes"].items()}
    c["flat"] = ["a", "b"]

    def draw(shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(D, *shape)).astype(
            np.float32))

    c["grads"] = {n: draw(sh) for n, (sh, _) in c["shapes"].items()}
    c["err"] = {n: draw(sh, 0.1) for n, (sh, _) in c["shapes"].items()}
    full = sum(int(np.prod(c["shapes"][n][0])) for n in c["flat"])
    c["flat_err"] = draw((full,), 0.1)
    return c


def _serve_work(arch, sampled):
    """Staggered requests drawn with numpy: llama's six of
    ``tests/test_torch_serving.py`` (chunks of width 4 and 1, three
    sharing an 8-token prefix) and, where asked, a sampled one with a
    seed; Jamba's five with prompts of 6 tokens (no chunking: one
    prefill width for the reference to compile)."""
    rng = np.random.RandomState(0)
    if arch.startswith("jamba"):
        return [(rng.randint(0, 256, size=6).astype(np.int32),
                 dict(max_gen=g)) for g in (3, 4, 2, 5, 3)]
    prefix = rng.randint(0, 256, size=8).astype(np.int32)
    out = []
    for i, (p, g) in enumerate([(5, 4), (9, 6), (4, 3), (12, 5), (8, 2),
                                (13, 6)]):
        toks = rng.randint(0, 256, size=p).astype(np.int32)
        if i in (1, 3, 5):
            toks[:8] = prefix
        out.append((toks, dict(max_gen=g)))
    if sampled:
        out.append((rng.randint(0, 256, size=8).astype(np.int32),
                    dict(max_gen=5, temperature=0.8, seed=3)))
    return out


def _serve_case(name):
    """The case the ranks run, and the one-device layout (pp 1, vpp 1)
    of its params for the reference."""
    arch, data, pods, ov, spec = SERVE[name]
    llama = arch.startswith("llama")
    cfg, rc = tllama.reduced() if llama else tjamba.reduced()
    rc = dataclasses.replace(rc, **ov)
    params = _numpy_params(cfg, rc, np.random.RandomState(17))
    one = dataclasses.replace(rc, pp=1, vpp=1, groups=1)
    flat = params if (rc.pp, rc.vpp) == (1, 1) else tparams.to_host(
        tparams.relayout(tparams.from_reference(params, device="cpu"),
                         cfg, rc, one))
    case = dict(name=name, kind="serve", arch=arch, data=data, pods=pods,
                overrides=ov, spec=spec, params=params,
                work=_serve_work(arch,
                                 sampled=name.startswith("serve_d2_pp2")))
    if name.startswith("serve_d2_pp2"):
        rng = np.random.RandomState(1)
        case["first"] = {
            "tokens": rng.randint(0, 256, size=(4, 4)).astype(np.int32),
            "pos": np.array([0, 4, 0, 9], np.int32),
            "slot_mask": np.array([True, True, False, True])}
    if name == "serve_d2_pp2":
        case["scalar"] = case["work"][1][0], case["work"][1][1]["max_gen"]
        case["lockstep"] = True
        case["default"] = DEFAULT_SERVE
    return case, flat


def _jax_serve(case, flat):
    """The reference engine on one device over the case's requests, the
    same params at pp 1; with the case's ``first`` batch, its logits."""
    arch, _, _, ov, spec = SERVE[case["name"]]
    js = jsession(arch, mode="serve", data=1, **spec,
                  overrides=dict(ov, pp=1, vpp=1, groups=1))
    jp = jax.tree.map(jnp.asarray, flat)
    eng = js.serve_engine(jp)
    reqs = [eng.submit(t, **kw) for t, kw in case["work"]]
    eng.run_until_idle()
    out = dict(streams=[r.result(timeout=5) for r in reqs],
               stats=eng.stats)
    if "first" in case:
        _, logits, _ = js.serve_step_batched(jp, js.init_caches(),
                                             case["first"], want_logits=True)
        out["first_logits"] = np.asarray(logits)
    return out


def _port_one_rank(case, flat):
    """The port's one-rank engine over the case's requests, and the serve
    launcher's report logits (every row's prefill and decode)."""
    arch, _, _, ov, spec = SERVE[case["name"]]
    ts = tsession(arch, device="cpu", **spec,
                  overrides=dict(ov, pp=1, vpp=1, groups=1))
    params = tparams.from_reference(flat, device="cpu")
    eng = ts.serve_engine(params)
    reqs = [eng.submit(t, **kw) for t, kw in case["work"]]
    eng.run_until_idle()
    return dict(streams=[r.result(timeout=5) for r in reqs],
                report_logits=tserve.first_logits(
                    ts, params, [t for t, _ in case["work"]]))


class _StubSession:
    """What the reference's ServeEngine reads of a session, with no device
    under it: the paged case's pool geometry (pods 2 x data 2, one
    group), steps that return zeros, page copies logged. The engine's and
    the pool's admission decisions depend on the prompts and budgets
    only, never on the tokens, so they are the reference's decisions for
    the mesh."""

    def __init__(self, spec, pods, data):
        self.spec = types.SimpleNamespace(
            mode="serve", prefill_chunk=spec["prefill_chunk"],
            prefix_sharing="on", pods=pods)
        self.cfg = types.SimpleNamespace(encdec=None, moe=None)
        self.rc = types.SimpleNamespace(moe_stats=False)
        self.geo = types.SimpleNamespace(segments=[types.SimpleNamespace(
            kinds=("attn:dense",))])
        self.rt = types.SimpleNamespace(G=1)
        self.paged, self.page_size = True, spec["page_size"]
        self.max_slots, self.pods_size, self.data_size = \
            spec["max_slots"], pods, data
        self.pages_per_slot = spec["max_seq"] // spec["page_size"]
        self.n_pages = self.max_slots * self.pages_per_slot
        self.max_seq = spec["max_seq"]
        self.copies = []

    def _max_seq(self):
        return self.max_seq

    def check_slot_sharding(self):
        pass

    def sampling_unsupported_reason(self):
        return "a stub"

    def init_caches(self, abstract=False):
        return {}

    def reset_slot_caches(self, caches, mask):
        return caches

    def reset_pages(self, caches, mask):
        return caches

    def copy_pages(self, caches, src, dst):
        self.copies.append(sorted(set(zip(np.asarray(src).tolist(),
                                          np.asarray(dst).tolist()))))
        return caches

    def serve_step_batched(self, params, caches, batch, want_logits=False):
        return np.zeros(self.max_slots, np.int32), caches


def _jax_paging(case):
    """The reference engine's page decisions at shards = pods x data."""
    from repro.serving import ServeEngine
    arch, data, pods, ov, spec = SERVE[case["name"]]
    stub = _StubSession(spec, pods, data)
    eng = ServeEngine(stub, None)
    assert eng.pool.pool.shards == pods * data
    for t, kw in case["work"]:
        eng.submit(t, **kw)
    eng.run_until_idle()
    return dict(copies=stub.copies, prefix_hits=eng.stats.prefix_hits,
                prefix_hit_tokens=eng.stats.prefix_hit_tokens)


def _tie_case():
    """Rows of h near one vector u, and a table whose rows 10 (shard 0)
    and 140 (shard 2) both hold 4u: every row's two largest logits tie
    across two shards."""
    c = dict(TIE)
    rng = np.random.RandomState(23)
    cfg = tllama.reduced()[0]
    d = cfg.d_model
    u = rng.randn(d).astype(np.float32)
    table = 0.01 * rng.randn(c["vocab"], d).astype(np.float32)
    for r in c["rows"]:
        table[r] = 4 * u
    h = (u + 0.05 * rng.randn(c["data"], 2, d)).astype(np.float32)
    c.update(cfg=cfg, table=torch.from_numpy(table),
             scale=torch.ones(d), h=torch.from_numpy(h))
    return c


def _jax_tie(c):
    """The reference's greedy_sample over the shards under
    ``jax.vmap(axis_name="data")``: [data, rows] tokens."""
    D, vloc = c["data"], c["vocab"] // c["data"]
    jcfg = jmodel.get_arch("llama3.2-1b").reduced()[0]
    tables = jnp.asarray(c["table"].numpy().reshape(D, vloc, -1))
    scale = jnp.asarray(c["scale"].numpy())
    fn = jax.vmap(lambda t, h: jvocab.greedy_sample(
        jcfg, None, {"embed.table": t, "final_norm.scale": scale}, h, vloc),
        axis_name="data")
    return np.asarray(fn(tables, jnp.asarray(c["h"].numpy())))


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
    """The port's one-rank step on the same model: pp = 1, vpp = 2, the
    layers re-stacked. (At vpp 4 the port's step also equals
    reference_loss since its tables gather evicted stage blocks again,
    ``tests/test_torch_slots.py``; the JAX engine's does not.)"""
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
    variants = [_variant_case(n, built[b][2])
                for n, (b, _) in VARIANT.items()]
    autos = [_auto_case(n, built[b][2]) for n, (b, _, _) in AUTO.items()]
    ckpts = [dict(built[b][2], name=n, kind="ckpt",
                  dir=os.path.join(tmp, n)) for n, b in CKPT.items()]
    int8 = _int8_case()
    serves = {n: _serve_case(n) for n in SERVE}
    tie = _tie_case()
    jcfg, jrc, jamba = _jamba_case()
    qcfg, qrc, qwen = _qwen_case()
    cli = dict(SERVE_CLI, report=os.path.join(tmp, "serve_cli.json"))
    cli["argv"] = ["--device", "cpu", "--data", "2", "--pp", "2",
                   "--slots", "4", "--n-requests", "3", "--prompt", "6",
                   "--gen", "3", "--layouts",
                   "contiguous,contiguous+resident", "--report",
                   cli["report"]]
    ctx = _spawn([c for _, _, c in built.values()] + variants + autos
                 + [_embed_case(), int8] + ckpts
                 + [c for c, _ in serves.values()] + [tie, jamba, qwen, cli],
                 tmp)
    out = {INT8["name"]: {"ref": _jax_int8(int8)},
           TIE["name"]: {"ref": _jax_tie(tie)},
           JAMBA["name"]: dict(cfg=jcfg, rc=jrc, case=jamba,
                               ref=_jax_per_sequence(jamba, jrc)),
           QWEN["name"]: dict(cfg=qcfg, rc=qrc,
                              ref=_jax_per_sequence(qwen, qrc))}
    # the reference engines (and the port's one rank) while the ranks run
    for name, (case, flat) in serves.items():
        out[name] = dict(case=case, ref=_jax_serve(case, flat))
    out["serve_d2_pp2"]["one_rank"] = _port_one_rank(*serves["serve_d2_pp2"])
    out["serve_q2_d2_paged"]["paging"] = _jax_paging(
        serves["serve_q2_d2_paged"][0])
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
    for name in list(TRAIN) + list(VARIANT) + list(AUTO) + [
            EMBED["name"], INT8["name"]] + list(CKPT) + list(SERVE) + [
            TIE["name"], JAMBA["name"], QWEN["name"], SERVE_CLI["name"]]:
        ranks = [torch.load(os.path.join(tmp, f"{name}.{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
        out.setdefault(name, {})["ranks"] = ranks
    for c in ckpts:
        out[c["name"]]["dir"] = c["dir"]
    out[SERVE_CLI["name"]]["report"] = cli["report"]
    return out


def _rt(r):
    arch, data, pp, groups, pods, _ = TRAIN[r["case"]["name"]]
    return Runtime(r["cfg"], r["rc"], "cpu",
                   MeshShape(data, pp, groups, pods))


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
    arch, data, pp, groups, pods, _ = TRAIN[name]
    toks = r["case"]["batch"]["tokens"]
    vloc = r["cfg"].vocab // data if data > 1 else None
    mbs = toks.shape[0] // (pods * data * groups * MB)
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


def test_multirank_jamba_matches_per_sequence_reference(results):
    """Reduced Jamba on data 2 x groups 2: every rank's loss_sum plus
    router_aux_weight times aux_sum over the 16 global micro-batches, the
    aux_sum, and the unsharded gradients against the reference's loss
    over one-sequence micro-batches (``_jax_per_sequence``); the global
    grad norm equal on every rank."""
    r = results[JAMBA["name"]]
    want, want_aux, ref_grads = r["ref"]
    w = r["cfg"].moe.router_aux_weight
    n_mb = JAMBA["data"] * JAMBA["groups"] * MB
    ranks = r["ranks"]
    for got in ranks:
        assert abs(got["aux"] - want_aux) <= LOSS_RTOL * abs(want_aux)
        loss = got["loss"] + w * got["aux"] / n_mb
        assert abs(loss - want) <= LOSS_RTOL * abs(want)
    assert len({g["grad_norm"] for g in ranks}) == 1
    rt = Runtime(r["cfg"], r["rc"], "cpu",
                 MeshShape(JAMBA["data"], 1, JAMBA["groups"], 1))
    grads = tparams.unshard(rt, [g["grads"] for g in ranks])
    n = 0
    for path, ref in _leaves(ref_grads):
        got = _get(grads, path)
        assert got.dtype == torch.float32
        assert _rel(_np(got), ref) <= GRAD_RTOL, path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))


def test_multirank_qwen_shared_experts_match_per_sequence_reference(
        results):
    """Reduced qwen2-moe on data 2 x pp 2 (the shared FFN's s_wg / s_wu /
    s_wd gathered and reduced through the flat slab like the other stage
    tensors): every rank's loss_sum plus router_aux_weight times aux_sum
    over the 8 global micro-batches, the aux_sum, and the unsharded
    gradients against the reference's loss over one-sequence
    micro-batches (``_jax_per_sequence``), at STEP_RTOL; the global grad
    norm equal on every rank."""
    r = results[QWEN["name"]]
    want, want_aux, ref_grads = r["ref"]
    w = r["cfg"].moe.router_aux_weight
    n_mb = QWEN["data"] * MB
    ranks = r["ranks"]
    assert want_aux > 0
    for got in ranks:
        assert abs(got["aux"] - want_aux) <= STEP_RTOL * want_aux
        loss = got["loss"] + w * got["aux"] / n_mb
        assert abs(loss - want) <= STEP_RTOL * abs(want)
    assert len({g["grad_norm"] for g in ranks}) == 1
    rt = Runtime(r["cfg"], r["rc"], "cpu", MeshShape(QWEN["data"],
                                                     QWEN["pp"], 1, 1))
    assert {"L0.ffn.s_wg", "L0.ffn.s_wu", "L0.ffn.s_wd"} <= \
        set(rt.gatherable["main"])
    grads = tparams.unshard(rt, [g["grads"] for g in ranks])
    n = 0
    for path, ref in _leaves(ref_grads):
        got = _get(grads, path)
        assert got.dtype == torch.float32
        assert _rel(_np(got), ref) <= STEP_RTOL, path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))


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


def _pod_peer(rank: int, r) -> int:
    """The rank of the same (d, g, p) in pod 1."""
    arch, data, pp, groups, pods, _ = TRAIN[r["case"]["name"]]
    return rank + data * pp * groups


def test_multirank_pods_hold_bit_identical_replicas(results):
    """At pods 2 x data 2 the two pods' grads (summed across the pods)
    and their params after the AdamW step are equal bit for bit, and
    every rank reads the same global grad norm."""
    r = results["llama_q2_d2"]
    ranks = r["ranks"]
    assert [g["ranks"] for g in ranks] == [(0, 0, 0), (1, 0, 0)] * 2
    n = 0
    for rank in (0, 1):
        a, b = ranks[rank], ranks[_pod_peer(rank, r)]
        for key in ("grads", "params"):
            for path, t in _leaves(a[key]):
                assert torch.equal(t, _get(b[key], path)), (rank, key,
                                                            path)
                n += 1
    assert n > 0
    assert len({g["grad_norm"] for g in ranks}) == 1


def _bit_equal(a, b) -> list:
    """Paths of the leaves of two grad trees that differ in any bit."""
    return [path for path, t in _leaves(a)
            if not torch.equal(t, _get(b, path))]


@pytest.mark.parametrize("name", ["none", "prefetch0", "prefetch2"])
def test_multirank_variant_grads_bit_identical_to_flat(results, name):
    """Per-tensor collectives and prefetch distances 0 and 2 against the
    flat, prefetch-1 base run on the same params and batch: every rank's
    grads, loss and grad norm equal bit for bit."""
    base = results[VARIANT[name][0]]["ranks"]
    got = results[name]["ranks"]
    for a, b in zip(got, base):
        assert _bit_equal(a["grads"], b["grads"]) == []
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])


@pytest.mark.parametrize("name", ["int8", "int8_none"])
def test_multirank_int8_grads_within_the_reference_rule(results, name):
    """int8 reduces with error feedback (4 micro-batches in units of 2:
    the second unit's reduce carries the first's error), flat and per
    tensor: every grad finite and within 2% of the float32 run's global
    max |g|; the loss (computed before any reduce) equal bit for bit."""
    base = results[VARIANT[name][0]]["ranks"]
    got = results[name]["ranks"]
    gmax = max(float(t.abs().max()) for b in base
               for _, t in _leaves(b["grads"]))
    worst = 0.0
    for a, b in zip(got, base):
        assert a["loss"] == b["loss"]
        for path, t in _leaves(a["grads"]):
            assert torch.isfinite(t).all(), path
            worst = max(worst, float((t - _get(b["grads"], path)).abs()
                                     .max()) / gmax)
    assert 0.0 < worst < INT8_RULE, worst


@pytest.mark.parametrize("name", ["auto", "autogen_gated"])
def test_multirank_auto_step_matches_jax_value_and_grad(results, name):
    """The §4 schedules on the llama data 2 x pp 2 case: every rank runs
    the same plan, and the loss and re-assembled gradients equal
    ``jax.value_and_grad(reference_loss)`` as the base case's do."""
    base = results[AUTO[name][0]]
    ranks = results[name]["ranks"]
    assert len({(g["schedule"], g["table"]) for g in ranks}) == 1
    for got in ranks:
        assert abs(got["loss"] - base["ref_loss"]) <= \
            LOSS_RTOL * abs(base["ref_loss"])
    grads = tparams.unshard(_rt(base), [g["grads"] for g in ranks])
    n = 0
    for path, want in _leaves(base["ref_grads"]):
        assert _rel(_np(_get(grads, path)), want) <= GRAD_RTOL, path
        n += 1
    assert n == sum(1 for _ in _leaves(grads))
    if name == "autogen_gated":
        assert ranks[0]["schedule"] == "autogen_gated"
        return
    # the reference Session's selection at the same mesh and shape
    js = jsession("llama3.2-1b", mode="train", seq_len=SEQ, data=2,
                  schedule="auto", cost_preset="a800",
                  overrides=dict(pp=2, microbatches=MB, unit=UNIT,
                                 vpp=base["rc"].vpp))
    jd = js.describe()["schedule"]
    assert ranks[0]["describe"]["auto"]["selected"] == \
        ranks[0]["schedule"] == jd["auto"]["selected"]
    for g in ranks:
        d = g["describe"]
        assert d["auto"]["candidates"] == jd["auto"]["candidates"]
        for k in ("makespan", "bubble_ratio", "peak_mem", "stash_depth",
                  "collectives"):
            assert d[k] == jd[k], k


def test_multirank_auto_profiled_agrees_on_every_rank(results):
    """``auto_profiled`` with ``profile_top_k=2``: every rank measures the
    same two survivors, reads the same times (the maximum over the
    ranks) and trains the same winner."""
    ranks = results["auto_profiled"]["ranks"]
    autos = [g["describe"]["auto"] for g in ranks]
    assert len({(g["schedule"], g["table"]) for g in ranks}) == 1
    measured = autos[0]["measured"]
    assert len(measured) == 2
    assert all(a["measured"] == measured for a in autos)
    assert ranks[0]["schedule"] == min(measured, key=measured.get)
    assert all(a["provenance"]["selection"] == "search+measured"
               for a in autos)
    assert all(a["profile"]["survivors"] == list(measured)
               for a in autos)
    assert all(g["describe"]["cache"]["measure_calls"] == 2 for g in ranks)


def _jax_int8(c):
    """The JAX package's int8 reduces on the case's per-rank inputs,
    under ``jax.vmap(axis_name="data")``: ({"flat": shards, "flat_err",
    "tensor", "tensor_err"}, each [D, ...])."""
    D = c["data"]
    jspecs = {n: jcommon.ParamSpec(sh, fsdp_dim=fd)
              for n, (sh, fd) in c["shapes"].items()}
    jfl = jfsdp.build_flat_layout(jspecs, c["flat"], D, False)
    host = {n: jnp.asarray(g.numpy()) for n, g in c["grads"].items()}
    red, err = jax.vmap(
        lambda g, e: jfsdp.reduce_scatter_flat_int8(g, e, jfl),
        axis_name="data")({n: host[n] for n in c["flat"]},
                          jnp.asarray(c["flat_err"].numpy()))
    out = {"flat": red, "flat_err": err, "tensor": {}, "tensor_err": {}}
    for n, sp in jspecs.items():
        out["tensor"][n], out["tensor_err"][n] = jax.vmap(
            lambda g, e, sp=sp: jfsdp.reduce_scatter_grad_int8(
                g, e, sp, D, False), axis_name="data")(
            host[n], jnp.asarray(c["err"][n].numpy()))
    return jax.tree.map(np.asarray, out)


def test_multirank_int8_reduces_equal_the_reference(results):
    """The port's int8 reduces over four gloo ranks against the JAX
    package's, run under ``jax.vmap(axis_name="data")`` on the same
    per-rank inputs: reduced shards and new feedback buffers bit for
    bit, flat (a ld = 0 and a ld = 1 tensor) and per tensor (those two
    and a replicated one, summed whole)."""
    r = results[INT8["name"]]
    want = r["ref"]
    for rank, got in enumerate(r["ranks"]):
        np.testing.assert_array_equal(got["flat_err"].numpy(),
                                      want["flat_err"][rank])
        for n in want["flat"]:
            np.testing.assert_array_equal(got["flat"][n].numpy(),
                                          want["flat"][n][rank], err_msg=n)
        for n in want["tensor"]:
            np.testing.assert_array_equal(got["tensor"][n].numpy(),
                                          want["tensor"][n][rank],
                                          err_msg=n)
            np.testing.assert_array_equal(got["tensor_err"][n].numpy(),
                                          want["tensor_err"][n][rank],
                                          err_msg=n)


# --------------------------------------------------------------------------- #
# Checkpoints on the mesh
# --------------------------------------------------------------------------- #


def _state_leaves(st):
    for part in ("params", "master", "m", "v"):
        for path, t in _leaves(st[part]):
            yield (part,) + path, t


@pytest.mark.parametrize("name", list(CKPT))
def test_multirank_restart_equals_uninterrupted_steps(results, name):
    """Every rank saves after step 1, fails before step 2, restores step
    1's checkpoint on the same mesh and takes step 2: its params, master
    weights, moments and losses equal two uninterrupted steps bit for
    bit."""
    for got in results[name]["ranks"]:
        assert got["resume_steps"] == [1]
        assert got["ckpt_steps"] == [1, 2]
        assert got["events"] == ["save", "restore", "save"]
        assert got["losses"] == got["plain_losses"]
        assert got["state"]["step"] == got["plain"]["step"] == 2
        bad = [p for p, t in _state_leaves(got["state"])
               if not torch.equal(t, _get(got["plain"], p))]
        assert bad == []


@pytest.mark.parametrize("name", list(CKPT))
def test_multirank_checkpoint_files_are_the_unsharded_parts(results,
                                                            name):
    """The last checkpoint's global files (read without a layout) equal
    ``params.unshard`` of the ranks' parts, for the params and for the
    optimizer's master weights and moments; at pods 2 the two pods'
    restored replicas are equal bit for bit."""
    base = results[CKPT[name]]
    ranks = results[name]["ranks"]
    rt = _rt(base)
    tree, manifest = CheckpointManager(results[name]["dir"]).restore(2)
    assert manifest["extra"] == {"step": 2}
    assert int(tree["opt"]["step"]) == 2
    for part in ("params", "master", "m", "v"):
        want = tparams.unshard(rt, [g["state"][part] for g in ranks])
        got = tree["params"] if part == "params" else tree["opt"][part]
        n = 0
        for path, t in _leaves(want):
            assert torch.equal(_get(got, path), t), (part, path)
            n += 1
        assert n == sum(1 for _ in _leaves(got))
    arch, data, pp, groups, pods, _ = TRAIN[CKPT[name]]
    for rank in range(WORLD // pods):
        for peer in range(rank + WORLD // pods, WORLD, WORLD // pods):
            a, b = ranks[rank]["state"], ranks[peer]["state"]
            assert all(torch.equal(t, _get(b, p))
                       for p, t in _state_leaves(a)), (rank, peer)


# --------------------------------------------------------------------------- #
# Serving on the mesh
# --------------------------------------------------------------------------- #


def _greedy(work):
    return [i for i, (_, kw) in enumerate(work)
            if kw.get("temperature", 0) == 0]


@pytest.mark.parametrize("name", list(SERVE))
def test_multirank_serve_streams_equal_the_reference_engine(results, name):
    """Every rank's greedy streams equal the reference engine's on one
    device with ``==``, and the ranks ran the plain versions."""
    r = results[name]
    work, want = r["case"]["work"], r["ref"]["streams"]
    assert [g["ranks"] for g in r["ranks"]] == [
        MeshShape(SERVE[name][1], r["case"]["overrides"].get("pp", 1),
                  r["case"]["overrides"].get("groups", 1),
                  SERVE[name][2]).coords(k) for k in range(WORLD)]
    for got in r["ranks"]:
        assert [got["streams"][i] for i in _greedy(work)] == \
            [want[i] for i in _greedy(work)]
        assert [len(t) for t in got["streams"]] == \
            [kw["max_gen"] for _, kw in work]
        assert got["counters"].get(
            "ref_paged" if "page_size" in SERVE[name][4]
            else "ref_attention", 0) > 0


def test_multirank_serve_logits_sampling_and_scalar_path(results):
    """llama at data 2 x pp 2: one batched prefill's logits within 1e-5
    of the reference's max |logit| (float32) on every rank; the sampled
    request equal to the port's one-rank engine; the scalar-pos path
    equal to the engine's stream in every row; the serve launcher's
    report logits (every row's prefill and decode step) within 1e-5 of
    the one-rank port's."""
    r = results["serve_d2_pp2"]
    ref = r["ref"]["first_logits"]
    k = len(r["case"]["work"]) - 1          # the sampled request
    for got in r["ranks"]:
        lg = got["first_logits"].numpy()
        assert lg.shape == ref.shape == (4, 256)
        assert _rel(lg, ref) <= SERVE_LOGIT_RTOL
        assert got["streams"][k] == r["one_rank"]["streams"][k]
        assert got["scalar"] == [r["ref"]["streams"][1]] * 4
        one = r["one_rank"]["report_logits"]
        assert got["report_logits"].shape == one.shape == (2, 4, 256)
        assert _rel(got["report_logits"], one) <= SERVE_LOGIT_RTOL
    assert r["one_rank"]["streams"][:k] == r["ref"]["streams"][:k]


def test_multirank_resident_serve_equals_the_gathered_one(results):
    """llama at data 2 x pp 2 with serve_resident: every rank's streams,
    its batched prefill's logits and the launcher's report logits (every
    row's prefill and decode step) equal the same case without the knob
    bit for bit, with no FSDP gather on any rank (the case without it
    gathers); the logits within 1e-5 of the reference engine's with the
    knob (float32)."""
    r, base = results["serve_d2_pp2_resident"], results["serve_d2_pp2"]
    ref = r["ref"]["first_logits"]
    assert r["ref"]["streams"] == base["ref"]["streams"]
    for got, want in zip(r["ranks"], base["ranks"]):
        assert got["gathers"] == 0 < want["gathers"]
        assert got["streams"] == want["streams"]
        assert torch.equal(got["first_logits"], want["first_logits"])
        assert np.array_equal(got["report_logits"], want["report_logits"])
        assert _rel(got["first_logits"].numpy(), ref) <= SERVE_LOGIT_RTOL


def test_multirank_serve_launcher_serves_a_resident_layout(results):
    """The launcher's ranks serve ``contiguous+resident`` after
    ``contiguous`` from their own cut of the same params: the same
    streams, no FSDP gather on any rank in the resident layout."""
    with open(results[SERVE_CLI["name"]]["report"]) as f:
        rep = json.load(f)
    lay = rep["layouts"]
    assert rep["world"] == WORLD and len(lay["contiguous"]["streams"]) == 3
    assert lay["contiguous+resident"]["streams"] == \
        lay["contiguous"]["streams"]
    for r in rep["ranks"]:
        counts = r["counts"]
        assert counts["contiguous+resident"]["gathers"] == 0 < \
            counts["contiguous"]["gathers"]


def test_multirank_serve_engines_keep_lockstep(results):
    """A rank that submits another prompt makes every rank's engine raise
    at that tick; the background thread and a sampled request without a
    seed are refused on a mesh."""
    for got in results["serve_d2_pp2"]["ranks"]:
        assert "left lockstep at serve" in got["lockstep"]
        assert "lockstep" in got["thread"]
        assert "needs a seed" in got["unseeded"]


def test_multirank_default_serve_session_stays_on_one_rank(results):
    """A default reduced-llama serve session (pp 2 alone) built under the
    spawn's process group walks its stages on one rank, as it does with
    no group: no mesh on any rank, and the same stream (==) as this
    process's session of the same seed."""
    d = DEFAULT_SERVE
    ts = tsession("llama3.2-1b", mode="serve", device="cpu", **d["spec"])
    assert ts.mesh is None and ts.rc.pp == 2
    eng = ts.serve_engine(ts.init_params(
        torch.Generator().manual_seed(d["seed"])))
    req = eng.submit(d["prompt"], max_gen=d["max_gen"])
    eng.run_until_idle()
    want = req.result(timeout=1)
    assert len(want) == d["max_gen"]
    for got in results["serve_d2_pp2"]["ranks"]:
        assert got["default"] == dict(mesh=None, pp=2, stream=want)


def test_multirank_paged_serve_copies_equal_the_reference_pool(results):
    """pods 2 x data 2, paged with prefix sharing: the prefix hits and
    the cross-partition page copies (global ids, in order) equal the
    reference engine's at shards=4, and some copy crosses shards."""
    r = results["serve_q2_d2_paged"]
    want = r["paging"]
    assert want["copies"] and want["prefix_hits"] > 0
    n_loc = 32 // 4
    assert any(s // n_loc != d // n_loc for c in want["copies"]
               for s, d in c)
    for got in r["ranks"]:
        assert got["copies"] == want["copies"]
        assert got["stats"]["prefix_hits"] == want["prefix_hits"]
        assert got["stats"]["prefix_hit_tokens"] == \
            want["prefix_hit_tokens"]


def test_multirank_greedy_sample_ties_as_the_reference(results):
    """Two equal table rows in shards 0 and 2: the port's sharded
    ``greedy_sample`` equals the reference's under ``jax.vmap`` (the
    higher shard's row), where ``argmax`` over the full row would take
    the first."""
    c = _tie_case()
    want = results[TIE["name"]]["ref"]
    lo, hi = c["rows"]
    vloc = c["vocab"] // c["data"]
    full = np.concatenate([g["logits"].numpy()
                           for g in results[TIE["name"]]["ranks"]], axis=1)
    assert (full[:, lo] == full[:, hi]).all()
    assert (full.argmax(-1) == lo).all()
    for rank, got in enumerate(results[TIE["name"]]["ranks"]):
        assert got["tok"].dtype == torch.int32
        np.testing.assert_array_equal(got["tok"].numpy(), want[rank])
        assert (got["tok"].numpy() == hi).all()
    assert vloc * 2 <= hi < vloc * 3


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
    # --pods multiplies the world: pods x data x groups x pp ranks
    with pytest.raises(SystemExit, match="8 ranks on 0 cpu"):
        tlaunch.main(["--device", "cpu", "--backend", "nccl", "--pods",
                      "2", "--data", "2", "--pp", "2", "--steps", "1"])
    assert tlaunch._world(tlaunch._args(["--pods", "2", "--data", "2"])) \
        == 4


def test_multirank_session_needs_a_process_group():
    with pytest.raises(SessionError, match="process group"):
        tsession("llama3.2-1b", mode="train", device="cpu", data=2)
    with pytest.raises(SessionError, match="process group"):
        tsession("llama3.2-1b", mode="train", device="cpu",
                 overrides=dict(pp=2))
