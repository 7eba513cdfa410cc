"""Parameter trees of the port: initialiser and the bridge to the reference.

A tree is ``{"io": {name: tensor}, "segments": {"main": {"L{j}.<...>":
[P·V, ...]}}}`` with the reference's names and stage stacking, so
``from_reference`` is a name-for-name copy of ``repro``'s tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.common import init_params, torch_dtype


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
        for s in range(S):
            for n, t in init_params(specs, dtype, generator, device).items():
                stacked[n][s] = t
        segments[seg.name] = stacked
    return {"io": io, "segments": segments}
