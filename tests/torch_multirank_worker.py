"""Rank processes for tests/test_torch_multirank.py (torch only: no jax,
so that each spawned rank starts quickly).

``main(rank, world, port, case_file, out_dir)`` joins a gloo process group
of ``world`` CPU ranks and runs the cases of ``case_file`` (a
``torch.save``d list) in order; each rank writes its results to
``out_dir/<case>.<rank>.pt``.

* ``train``: a train Session on the case's mesh (with the case's
  ``spec`` knobs: ``schedule="auto"`` and its selection knobs), this
  rank's part of the full reference tree (``params.shard_for_rank``), one
  ``train_step`` on the global batch, then one ``opt_step``; it saves
  this rank's grads, the metrics, ``grad_norm``, the params after the
  update, the schedule the session runs with a sha256 of its table, and
  ``describe()["schedule"]``.
* ``embed``: the vocabulary-sharded ``embed_lookup`` and ``embed_grad``
  on this rank's ids over a data axis of every rank.
* ``int8``: the int8 reduces with error feedback over a data axis of
  every rank: ``reduce_scatter_flat_int8_async`` on this rank's
  gradients and flat feedback buffer, and
  ``reduce_scatter_grad_int8_async`` on each tensor; it saves the
  reduced shards and the new feedback buffers.
* ``ckpt``: a train case's session run for two steps under the
  fault-tolerance controller (a checkpoint after each step in the
  case's directory, a failure injected before the second), then the
  same two steps uninterrupted; it saves both states, the losses and
  the controller's resume steps.
* ``serve``: a serve Session on the case's mesh, this rank's part of the
  full reference tree, and the engine over the case's requests (every
  rank submits the same, then ticks them with ``run_until_idle``); it
  saves the streams, the engine's stats, its FSDP gathers and the page
  copies it made (global ids), and optionally the logits of one batched
  prefill with ``want_logits`` on fresh caches, the scalar-pos ``serve_prefill`` /
  ``serve_decode`` stream of one prompt in every row, and what a
  lockstep fault raises (rank 0 submits another prompt), what the
  background thread and an unseeded sampled request raise, and the
  stream of a default serve session (pp alone) built under the group.
* ``tie``: the vocabulary-sharded ``greedy_sample`` over a data axis of
  every rank, on this rank's rows and table shard.
* ``serve_cli``: the serve launcher's per-rank ``serve`` on the case's
  command line under this process group (its report goes where the
  command line says).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().clone()


def _train(case, rank):
    from repro_torch import params as tparams
    from repro_torch.api import session

    from repro_torch.core.plan import table_digest

    sess = session(case["arch"], mode="train", seq_len=case["seq"],
                   device="cpu", data=case["data"], pods=case["pods"],
                   overrides=case["overrides"], optim=case["optim"],
                   **case.get("spec", {}))
    full = tparams.from_reference(case["params"], device="cpu")
    p = tparams.shard_for_rank(sess.rt, full, sess.mesh.rank)
    grads, m = sess.train_step(p, case["batch"])
    out = {"grads": _host(grads), "loss": float(m["loss_sum"]),
           "aux": float(m["aux_sum"]), "emb_dropped": m["emb_dropped"],
           "ranks": (sess.mesh.d_rank, sess.mesh.g_rank, sess.mesh.p_rank),
           "schedule": sess.rc.schedule,
           "table": table_digest(sess.rt.plans["main"].table),
           "describe": sess.describe()["schedule"]}
    opt = sess.init_opt_state(p)
    p, opt, om = sess.opt_step(p, grads, opt)
    out["grad_norm"] = float(om["grad_norm"])
    out["params"] = _host(p)
    return out


def _ckpt(case, rank):
    """Two steps under the fault-tolerance controller, checkpointing after
    each, with a failure injected before step 2 (index 1): every rank
    restores step 1's checkpoint and takes step 2 again; then the same two
    steps uninterrupted from the same params."""
    from repro_torch import params as tparams
    from repro_torch.api import session

    sess = session(case["arch"], mode="train", seq_len=case["seq"],
                   device="cpu", data=case["data"], pods=case["pods"],
                   overrides=case["overrides"], optim=case["optim"])
    full = tparams.from_reference(case["params"], device="cpu")
    stream = sess.stream(seed=1)

    def build(losses):
        def fn(restored, manifest):
            if restored is None:
                p = tparams.shard_for_rank(sess.rt, full, sess.mesh.rank)
                st = {"params": p, "opt": sess.init_opt_state(p)}
            else:
                st = sess.adopt_state(restored)

            def run_one(st, step):
                g, m = sess.train_step(st["params"], stream.batch(step))
                p, o, _ = sess.opt_step(st["params"], g, st["opt"])
                losses.append(float(m["loss_sum"]))
                return {"params": p, "opt": o}, {}

            return st, run_one, lambda s: s
        return fn

    ctl = sess.checkpointing(case["dir"], every=1)
    losses, plain_losses = [], []
    state, _ = ctl.run(build(losses), 2, inject_failure_at=1)
    plain, run_one, _ = build(plain_losses)(None, None)
    for step in range(2):
        plain, _ = run_one(plain, step)

    def host(st):
        o = st["opt"]
        return {"params": _host(st["params"]), "step": o["step"],
                "master": _host(o["master"]), "m": _host(o["m"]),
                "v": _host(o["v"])}

    return {"state": host(state), "plain": host(plain), "losses": losses,
            "plain_losses": plain_losses, "resume_steps": ctl.resume_steps,
            "ckpt_steps": ctl.mgr.list_steps(),
            "events": [e["op"] for e in ctl.mgr.events]}


def _embed(case, rank):
    from repro_torch.core import vocab as Vb
    from repro_torch.core.comm import Mesh

    mesh = Mesh(case["data"], 1, 1, "cpu")
    comm = mesh.data_comm
    vocab, vloc = case["vocab"], case["vocab"] // case["data"]
    ids = case["ids"][rank]
    table = case["table"][rank * vloc:(rank + 1) * vloc]
    emb = Vb.embed_lookup(table, ids, vloc, torch.float32, comm)
    acc = torch.zeros((vloc, table.shape[1]), dtype=torch.float32)
    acc, dropped = Vb.embed_grad(ids, case["dx"][rank], vloc, vocab, acc,
                                 comm)
    return {"emb": emb, "acc": acc, "dropped": dropped}


def _int8(case, rank):
    from repro_torch.core import fsdp
    from repro_torch.core.comm import Mesh

    comm = Mesh(case["data"], 1, 1, "cpu").data_comm
    specs = case["specs"]
    grads = {n: g[rank] for n, g in case["grads"].items()}
    fl = fsdp.build_flat_layout(specs, case["flat"], comm.size)
    pend, flat_err = fsdp.reduce_scatter_flat_int8_async(
        {n: grads[n] for n in case["flat"]}, case["flat_err"][rank], fl,
        comm)
    out = {"flat": pend.wait(), "flat_err": flat_err, "tensor": {},
           "tensor_err": {}}
    for n, g in grads.items():
        pend, err = fsdp.reduce_scatter_grad_int8_async(
            g, case["err"][n][rank], fsdp.local_dim(specs[n], comm.size),
            comm)
        out["tensor"][n], out["tensor_err"][n] = pend.wait(), err
    return out


def _serve(case, rank):
    import numpy as np

    from repro_torch import params as tparams
    from repro_torch.api import SessionError, session
    from repro_torch.core import executor
    from repro_torch.launch.serve import first_logits

    sess = session(case["arch"], mode="serve", device="cpu",
                   data=case["data"], pods=case["pods"],
                   overrides=case["overrides"], **case["spec"])
    full = tparams.from_reference(case["params"], device="cpu")
    params = tparams.shard_for_rank(sess.rt, full, sess.mesh.rank)
    out = {"ranks": (sess.mesh.d_rank, sess.mesh.g_rank, sess.mesh.p_rank),
           "copies": []}
    copy = sess.copy_pages

    def logged(caches, src, dst):
        out["copies"].append(sorted(set(zip(np.asarray(src).tolist(),
                                            np.asarray(dst).tolist()))))
        return copy(caches, src, dst)

    sess.copy_pages = logged
    eng = sess.serve_engine(params)
    try:
        eng.start()
    except SessionError as e:
        out["thread"] = str(e)
    try:
        eng.submit(case["work"][0][0], temperature=0.5)
    except SessionError as e:
        out["unseeded"] = str(e)
    executor.reset_coll_time()
    reqs = [eng.submit(t, **kw) for t, kw in case["work"]]
    eng.run_until_idle()
    out["streams"] = [r.result(timeout=1) for r in reqs]
    out["gathers"] = executor.COLL_TIME["gathers"]
    st = eng.stats
    out["stats"] = dict(prefill_steps=st.prefill_steps,
                        decode_steps=st.decode_steps,
                        prefix_hits=st.prefix_hits,
                        prefix_hit_tokens=st.prefix_hit_tokens)
    out["counters"] = sess.describe()["kernels"]["counters"]
    if "first" in case:
        _, logits, _ = sess.serve_step_batched(
            params, sess.init_caches(), case["first"], want_logits=True)
        out["first_logits"] = logits
        # the serve launcher's report: every row's prefill and decode
        out["report_logits"] = first_logits(sess, params,
                                            [t for t, _ in case["work"]])
    if "scalar" in case:
        prompt, g = case["scalar"]
        rows = sess.max_slots
        caches = sess.init_caches()
        tok, caches = sess.serve_prefill(
            params, caches, {"tokens": np.tile(prompt, (rows, 1))})
        stream = [tok.tolist()]
        for t in range(g - 1):
            tok, caches = sess.serve_decode(params, caches, {
                "tokens": np.array(stream[-1], np.int32)[:, None],
                "pos": np.int32(len(prompt) + t)})
            stream.append(tok.tolist())
        out["scalar"] = [[s_[r] for s_ in stream] for r in range(rows)]
    if "default" in case:
        # a default serve session (reduced llama: pp 2, nothing else)
        # built under this process group: pp alone walks its stages on
        # one rank, whatever group exists
        d = case["default"]
        one = session(case["arch"], mode="serve", device="cpu", **d["spec"])
        e1 = one.serve_engine(one.init_params(
            torch.Generator().manual_seed(d["seed"])))
        r1 = e1.submit(d["prompt"], max_gen=d["max_gen"])
        e1.run_until_idle()
        out["default"] = dict(mesh=one.mesh, pp=one.rc.pp,
                              stream=r1.result(timeout=1))
    if case.get("lockstep"):
        eng = sess.serve_engine(params)
        prompt, kw = case["work"][0]
        eng.submit(prompt if rank else prompt[::-1].copy(), **kw)
        try:
            eng.run_until_idle()
        except SessionError as e:
            out["lockstep"] = str(e)
    return out


def _serve_cli(case, rank):
    from repro_torch.launch import serve as tserve

    tserve.serve(tserve._args(case["argv"]), rank)
    return {}


def _tie(case, rank):
    from repro_torch.core import vocab as Vb
    from repro_torch.core.comm import Mesh

    comm = Mesh(case["data"], 1, 1, "cpu").data_comm
    vloc = case["vocab"] // case["data"]
    io = {"embed.table": case["table"][rank * vloc:(rank + 1) * vloc],
          "final_norm.scale": case["scale"]}
    h = case["h"][rank]
    return {"tok": Vb.greedy_sample(case["cfg"], None, io, h, vloc, comm),
            "logits": Vb.serve_logits(case["cfg"], None, io, h, vloc, comm)}


def main(rank, world, port, case_file, out_dir):
    torch.set_num_threads(1)
    # the schedule="auto" cases' persisted plan cache (rank 0 writes it)
    os.environ["REPRO_TORCH_PLAN_CACHE"] = os.path.join(out_dir,
                                                        "plans.json")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        for case in torch.load(case_file, weights_only=False):
            fn = {"train": _train, "embed": _embed, "int8": _int8,
                  "ckpt": _ckpt, "serve": _serve, "tie": _tie,
                  "serve_cli": _serve_cli}[case["kind"]]
            torch.save(fn(case, rank),
                       os.path.join(out_dir, f"{case['name']}.{rank}.pt"))
    finally:
        dist.destroy_process_group()
