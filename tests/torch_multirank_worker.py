"""Rank processes for tests/test_torch_multirank.py (torch only: no jax,
so that each spawned rank starts quickly).

``main(rank, world, port, case_file, out_dir)`` joins a gloo process group
of ``world`` CPU ranks and runs the cases of ``case_file`` (a
``torch.save``d list) in order; each rank writes its results to
``out_dir/<case>.<rank>.pt``.

* ``train``: a train Session on the case's mesh, this rank's part of the
  full reference tree (``params.shard_for_rank``), one ``train_step`` on
  the global batch, then one ``opt_step``; it saves this rank's grads,
  the metrics, ``grad_norm`` and the params after the update.
* ``embed``: the vocabulary-sharded ``embed_lookup`` and ``embed_grad``
  on this rank's ids over a data axis of every rank.
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

    sess = session(case["arch"], mode="train", seq_len=case["seq"],
                   device="cpu", data=case["data"],
                   overrides=case["overrides"], optim=case["optim"])
    full = tparams.from_reference(case["params"], device="cpu")
    p = tparams.shard_for_rank(sess.rt, full, sess.mesh.rank)
    grads, m = sess.train_step(p, case["batch"])
    out = {"grads": _host(grads), "loss": float(m["loss_sum"]),
           "aux": float(m["aux_sum"]), "emb_dropped": m["emb_dropped"],
           "ranks": (sess.mesh.d_rank, sess.mesh.g_rank, sess.mesh.p_rank)}
    opt = sess.init_opt_state(p)
    p, opt, om = sess.opt_step(p, grads, opt)
    out["grad_norm"] = float(om["grad_norm"])
    out["params"] = _host(p)
    return out


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


def main(rank, world, port, case_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        for case in torch.load(case_file, weights_only=False):
            fn = {"train": _train, "embed": _embed}[case["kind"]]
            torch.save(fn(case, rank),
                       os.path.join(out_dir, f"{case['name']}.{rank}.pt"))
    finally:
        dist.destroy_process_group()
