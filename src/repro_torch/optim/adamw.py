"""AdamW over the port's parameter trees.

The port's copy of ``repro/optim/adamw.py``: float32 master weights,
moments in ``moment_dtype``, global-norm clipping, decoupled weight decay
skipped for names that contain a ``no_decay`` token, and the warmup +
cosine ``lr_schedule``. Plain element-wise torch in the reference's order
of operations (``torch.optim.AdamW`` orders its update differently).

Unlike the reference, :func:`apply_updates` updates the state and the
parameters in place (each leaf is rewritten once, so the step never holds
two copies of the master weights and moments); it returns the same trees.

On a mesh of ranks each rank holds its shards; the update is elementwise
on them, and the clipping norm is that of the GLOBAL gradient: each rank
sums the squares of the leaves it owns (``owned``: every element of the
global gradient counted once — see ``Runtime.owns``) and ``all_reduce``
sums those over the mesh.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import torch_dtype


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    # parameters whose name contains any of these skip weight decay
    no_decay: tuple = ("norm", "bias", "scale", "A_log", "Dd", "dt_bias")


def _leaves(tree, path=""):
    """(keystr path, tensor) pairs in sorted-key order; the path string is
    the reference's ``jax.tree_util.keystr`` (``['io']['embed.table']``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}['{k}']")
    else:
        yield path, tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def init_state(params, cfg: AdamWConfig):
    mdt = torch_dtype(cfg.moment_dtype)
    return {
        "step": 0,
        "master": _map(params, lambda p: p.detach().float().clone()),
        "m": _map(params, lambda p: torch.zeros(p.shape, dtype=mdt,
                                                device=p.device)),
        "v": _map(params, lambda p: torch.zeros(p.shape, dtype=mdt,
                                                device=p.device)),
    }


def global_norm(grads, owned=None, all_reduce=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient element. ``owned``
    {keystr path: bool} keeps a rank's leaves that count (all when None);
    ``all_reduce`` sums the partial over the mesh."""
    total = None
    for path, g in _leaves(grads):
        if owned is not None and not owned[path]:
            continue
        s = (g.float() ** 2).sum()
        total = s if total is None else total + s
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=next(_leaves(grads))[1].device)
    if all_reduce is not None:
        total = all_reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, lr_scale=1.0,
                  owned=None, all_reduce=None):
    """One AdamW step. Returns (params, state, metrics), updated in place.
    ``owned`` and ``all_reduce`` make ``grad_norm`` the global norm over a
    mesh (:func:`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, owned, all_reduce)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                           1.0)
    f32 = dict(dtype=torch.float32, device=gnorm.device)
    stp = torch.tensor(step, **f32)
    b1c = 1.0 - torch.tensor(cfg.b1, **f32) ** stp
    b2c = 1.0 - torch.tensor(cfg.b2, **f32) ** stp
    lr = torch.as_tensor(lr_scale, **f32) * cfg.lr
    mdt = torch_dtype(cfg.moment_dtype)
    trees = [dict(_leaves(t)) for t in (params, grads, state["master"],
                                        state["m"], state["v"])]
    for path, p in trees[0].items():
        g, master, m, v = (t[path] for t in trees[1:])
        gf = g.float() * clip
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if not any(tok in path for tok in cfg.no_decay):
            delta = delta + cfg.weight_decay * master
        master -= lr * delta
        m.copy_(m2.to(mdt))
        v.copy_(v2.to(mdt))
        p.copy_(master.to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def lr_schedule(step, *, base_lr, warmup=100, total=10_000,
                min_ratio=0.1) -> torch.Tensor:
    """Linear warmup + cosine decay (a float32 multiplier for base_lr)."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp_max(s / max(warmup, 1), 1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
