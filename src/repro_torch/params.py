"""Parameter trees of the port: initialiser, the bridge to the reference,
and the cut of a tree into the ranks' parts.

A full tree is ``{"io": {name: tensor}, "segments": {"main":
{"L{j}.<...>": [P·V, ...]}}}`` with the reference's names and stage
stacking (row ``storage_index(p, v, V) = p * V + v`` holds logical stage
``v * P + p``), so ``from_reference`` is a name-for-name copy of
``repro``'s tree. One rank of a pods x data x (groups x pp) mesh holds
its part (:func:`shard_for_rank`): the V stage rows of its stage rank p
(every pipeline group and every pod holds the same rows), each tensor cut along its fsdp dim
into the data rank's shard where the data axis divides it (whole under
``serve_resident``), and the
embedding table / untied head cut into the data rank's vocabulary shard.
:func:`unshard` re-assembles the full tree (group 0's copy), as the
reference's tests do.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.common import (
    init_param,
    init_params,
    torch_dtype,
)


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.array(a)   # a writable copy: jax hands out read-only views
    if a.dtype.name == "bfloat16":    # ml_dtypes bfloat16: same bits
        a = a.view(np.int16)
        t = torch.from_numpy(a).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_reference(host_tree, device="cuda", dtype=None):
    """The reference's param tree (numpy arrays, e.g. ``np.asarray`` of
    each jax leaf; bfloat16 arrays keep their bits) as the port's tree of
    tensors on ``device``, cast to ``dtype`` if given."""
    return _map(host_tree, lambda a: _tensor(a, device, dtype))


def to_host(tree):
    """The port's tree as numpy arrays; bfloat16 leaves come out as
    float32 (exact), since numpy has no bfloat16 of its own."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _map(tree, host)


def init_all_params(cfg, rc, generator: torch.Generator | None = None,
                    device="cuda"):
    """Full parameter tree drawn from ``generator`` (seed 0 on ``device``
    when None) under the reference's ``ParamSpec`` rules. The draws are
    torch's, so the values differ from the reference's initialiser; carry
    reference params across with :func:`from_reference` instead."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = torch_dtype(rc.param_dtype)
    geo = M.build_geometry(cfg, rc)
    io = init_params(M.io_specs(cfg), dtype, generator, device)
    segments = {}
    for seg in geo.segments:
        specs = M.stage_specs(cfg, seg)
        S = geo.seg_stages(seg)
        stacked = {n: torch.empty((S,) + sp.shape, dtype=dtype,
                                  device=device) for n, sp in specs.items()}
        # each draw goes straight into its stack: besides the tree, one
        # tensor's float32 draw and its cast are alive at a time (3.8 GB
        # and 1.9 GB for a full-width Jamba expert stack)
        for s in range(S):
            for n in sorted(specs):
                stacked[n][s] = init_param(specs[n], dtype, generator,
                                           device)
        segments[seg.name] = stacked
    return {"io": io, "segments": segments}


def _stage_rows(rt, p: int) -> list[int]:
    V = rt.rc.vpp
    return [M.storage_index(p, v, V) for v in range(V)]


def shard_for_rank(rt, full, rank: int):
    """``rank``'s part of a full tree, as tensors of their own (the full
    tree can be freed). ``rt`` is a Runtime (its ``shape`` gives the
    mesh)."""
    d, _, p = rt.shape.coords(rank)
    D, vloc = rt.dsize, rt.vloc
    io = {}
    for n, a in full["io"].items():
        if rt.io_sharded(n):
            a = a.narrow(rt.io_specs[n].fsdp_dim, d * vloc, vloc)
        io[n] = a.contiguous().clone()
    segs = {}
    for sname, st in full["segments"].items():
        rows = _stage_rows(rt, p)
        out = {}
        for n, a in st.items():
            a = a[rows]
            ld = rt.local_dim(sname, n)
            if ld is not None and D > 1:
                k = a.shape[ld + 1] // D
                a = a.narrow(ld + 1, d * k, k)
            out[n] = a.contiguous().clone()
        segs[sname] = out
    return {"io": io, "segments": segs}


def unshard(rt, trees):
    """The full tree from every rank's part (``trees[rank]``): pod 0's
    and group 0's copy, data shards concatenated; the inverse of :func:`shard_for_rank`
    for params, and the global gradient for grads."""
    sh, D = rt.shape, rt.dsize
    io = {}
    for n in trees[0]["io"]:
        if rt.io_sharded(n):
            io[n] = torch.cat([trees[sh.rank_of(d, 0, 0)]["io"][n]
                               for d in range(D)], rt.io_specs[n].fsdp_dim)
        else:
            io[n] = trees[0]["io"][n]
    segs = {}
    for sname in trees[0]["segments"]:
        out = {}
        for n in trees[0]["segments"][sname]:
            ld = rt.local_dim(sname, n)
            full = [None] * (rt.Pe * rt.rc.vpp)
            for p in range(rt.Pe):
                parts = [trees[sh.rank_of(d, 0, p)]["segments"][sname][n]
                         for d in range(D if ld is not None else 1)]
                blk = torch.cat(parts, ld + 1) if len(parts) > 1 \
                    else parts[0]
                for v, row in enumerate(_stage_rows(rt, p)):
                    full[row] = blk[v]
            out[n] = torch.stack(full)
        segs[sname] = out
    return {"io": io, "segments": segs}


def relayout(tree, cfg, src, dst):
    """A full tree laid out for RunConfig ``src`` (its pp, vpp) re-stacked
    for ``dst``: the same layers, each moved to its stage and slot under
    ``dst`` (layer j sits in logical stage j // k, slot L{j % k}, at row
    ``storage_index``). Used to hold a mesh's step to the one-rank step of
    the same model."""
    def layers(rc):
        seg = M.build_geometry(cfg, rc).segments[0]
        if seg.k * rc.pp * rc.vpp != cfg.n_layers:
            raise ValueError(f"{cfg.n_layers} layers do not fill pp="
                             f"{rc.pp} x vpp={rc.vpp} stages evenly")
        return seg.k, rc.pp, rc.vpp

    (k0, p0, v0), (k1, p1, v1) = layers(src), layers(dst)
    out = {}
    for n, a in tree["segments"]["main"].items():
        slot, rest = n.split(".", 1)
        if slot != "L0":
            continue      # every slot's names repeat L0's
        for j in range(cfg.n_layers):
            s0, s1 = j // k0, j // k1
            row0 = M.storage_index(s0 % p0, s0 // p0, v0)
            row1 = M.storage_index(s1 % p1, s1 // p1, v1)
            name1 = f"L{j % k1}.{rest}"
            if name1 not in out:
                out[name1] = [None] * (p1 * v1)
            out[name1][row1] = tree["segments"]["main"][
                f"L{j % k0}.{rest}"][row0]
    return {"io": dict(tree["io"]),
            "segments": {"main": {n: torch.stack(r)
                                  for n, r in out.items()}}}
