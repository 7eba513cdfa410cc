"""Stage-level mini-autodiff with the ZeroPP F / B(dx) / W(dW) split.

The port's copy of ``repro/core/tape.py``. The backward pass of every
parameterised GEMM separates into

  * **B** — the input gradient ``dx = dy · Wᵀ``, on the pipeline's
    critical path, and
  * **W** — the weight gradient ``dW = xᵀ · dy``, which has no
    inter-stage dependency and fills pipeline bubbles.

Every parameterised contraction is a ``dense`` node: B replays its dX and
*stashes* ``(x, dy)``; :func:`compute_dw` replays the dW GEMM later.
Everything else (norms, rotary, the attention core, the selective scan,
routing, element-wise glue) is a ``prim`` whose backward comes from
``torch.autograd.grad`` over the function applied to detached inputs: its
parameters (norm scales, the conv and SSM parameters) receive immediate
gradients in B. A prim may have several outputs (``n_out``: the conv's
two halves, the router's weights and auxiliary loss); in B an output
that received no cotangent gets zeros, as in the reference.

Modes: ``"fwd"`` (the F task) computes under ``torch.no_grad``; ``"bwd"``
computes *and* records, then :meth:`Tape.backward` walks the records in
reverse. Each ``prim`` runs under ``torch.enable_grad`` on inputs
detached with ``requires_grad``, so its autograd graph is local to the
node and freed when its cotangents are taken.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

__all__ = ["Tape", "TVal", "WStash", "compute_dw", "dw_zeros_like"]


@dataclasses.dataclass
class TVal:
    """A tape-tracked value (single tensor)."""

    idx: int
    val: torch.Tensor

    @property
    def shape(self):
        return self.val.shape

    @property
    def dtype(self):
        return self.val.dtype


def _derive_specs(spec: str) -> tuple[str, str]:
    """From a forward einsum ``"x,w->y"`` derive the dx and dW specs."""
    lhs, out = spec.split("->")
    x_s, w_s = lhs.split(",")
    return f"{out},{w_s}->{x_s}", f"{x_s},{out}->{w_s}"


@dataclasses.dataclass
class _DenseRec:
    out_idx: int
    in_idx: int
    pname: str
    spec: str
    x_saved: torch.Tensor
    w_ref: torch.Tensor


@dataclasses.dataclass
class _GenericRec:
    out_idxs: tuple[int, ...]
    in_idxs: tuple[int, ...]
    pnames: tuple[str, ...]
    inputs: tuple[torch.Tensor, ...]    # detached leaves (params, xs)
    outputs: tuple[torch.Tensor, ...]   # the results, with a local graph


@dataclasses.dataclass
class WStash:
    """Everything needed to replay dW = einsum(dw_spec, x, dy)."""

    pname: str
    dw_spec: str
    x: torch.Tensor
    dy: torch.Tensor


class Tape:
    """One stage execution context (see the module docstring)."""

    def __init__(self, params: dict[str, torch.Tensor], mode: str = "fwd",
                 no_defer: frozenset[str] | set[str] = frozenset()):
        if mode not in ("fwd", "bwd"):
            raise ValueError(f"mode must be 'fwd' or 'bwd', got {mode!r}")
        self.params = params
        self.mode = mode
        self.no_defer = no_defer  # dense params whose dW is computed in B
        self._n = 0
        self._records: list[Any] = []

    def value(self, arr: torch.Tensor) -> TVal:
        """Wrap an externally produced tensor as a tape input."""
        self._n += 1
        return TVal(self._n, arr)

    def dense(self, x: TVal, pname: str, spec: str) -> TVal:
        """y = einsum(spec, x, params[pname]) — a deferred-dW contraction."""
        w = self.params[pname]
        with torch.no_grad():
            y = torch.einsum(spec, x.val, w)
        out = self.value(y)
        if self.mode == "bwd":
            self._records.append(
                _DenseRec(out.idx, x.idx, pname, spec, x.val, w))
        return out

    def prim(self, fn: Callable, *xs: TVal, pnames: Sequence[str] = (),
             n_out: int = 1):
        """Apply ``fn(*param_values, *x_values)``; its backward comes from
        ``torch.autograd.grad``. Parameters in ``pnames`` receive
        immediate gradients in B. With ``n_out`` > 1, ``fn`` returns that
        many tensors and so does the call (a tuple of TVals)."""
        pvals = tuple(self.params[p] for p in pnames)
        xvals = tuple(x.val for x in xs)
        if self.mode == "bwd":
            inputs = tuple(a.detach().requires_grad_(True)
                           for a in pvals + xvals)
            with torch.enable_grad():
                outs = fn(*inputs)
        else:
            inputs = ()
            with torch.no_grad():
                outs = fn(*pvals, *xvals)
        outs_t = (outs,) if n_out == 1 else tuple(outs)
        out_vals = tuple(self.value(o.detach()) for o in outs_t)
        if self.mode == "bwd":
            self._records.append(_GenericRec(
                tuple(o.idx for o in out_vals), tuple(x.idx for x in xs),
                tuple(pnames), inputs, outs_t))
        return out_vals[0] if n_out == 1 else out_vals

    def add(self, a: TVal, b: TVal) -> TVal:
        """``a + b`` as a prim."""
        return self.prim(lambda x, y: x + y, a, b)

    def elementwise(self, fn: Callable, x: TVal) -> TVal:
        """``fn`` applied to one value (an activation), as a prim."""
        return self.prim(fn, x)

    def backward(self, seeds: dict[int, torch.Tensor]
                 ) -> tuple[dict[int, torch.Tensor], dict[str, torch.Tensor],
                            list[WStash]]:
        """Reverse-walk the tape.

        seeds: {TVal.idx: cotangent} for the stage outputs. Returns (input
        cotangents by idx, immediate param grads, W-stash). The records
        are consumed: a tape runs backward once.
        """
        if self.mode != "bwd":
            raise ValueError("backward() needs a tape in mode='bwd'")
        cot: dict[int, torch.Tensor] = dict(seeds)
        igrads: dict[str, torch.Tensor] = {}
        wstash: list[WStash] = []

        def _acc(d: dict, k, v):
            if v is None:
                return
            d[k] = d[k] + v if k in d else v

        records, self._records = self._records, []
        with torch.no_grad():
            while records:
                rec = records.pop()
                if isinstance(rec, _DenseRec):
                    dy = cot.pop(rec.out_idx, None)
                    if dy is None:
                        continue
                    dx_spec, dw_spec = _derive_specs(rec.spec)
                    _acc(cot, rec.in_idx, torch.einsum(dx_spec, dy, rec.w_ref))
                    if rec.pname in self.no_defer:
                        _acc(igrads, rec.pname,
                             torch.einsum(dw_spec, rec.x_saved, dy))
                    else:
                        wstash.append(
                            WStash(rec.pname, dw_spec, rec.x_saved, dy))
                    continue
                dys = [cot.pop(i, None) for i in rec.out_idxs]
                # outputs that depend on no input (constants, integer
                # routing results) have no backward; the others take zeros
                # where no cotangent arrived
                live = [(o, torch.zeros_like(o) if d is None
                         else d.to(o.dtype))
                        for o, d in zip(rec.outputs, dys) if o.requires_grad]
                if all(d is None for d in dys) or not live:
                    continue
                with torch.enable_grad():
                    grads = torch.autograd.grad(
                        [o for o, _ in live], rec.inputs,
                        [d for _, d in live], allow_unused=True)
                np_ = len(rec.pnames)
                for p, g in zip(rec.pnames, grads[:np_]):
                    _acc(igrads, p, g)
                for i, g in zip(rec.in_idxs, grads[np_:]):
                    _acc(cot, i, g)
        return cot, igrads, wstash


def compute_dw(wstash: Sequence[WStash]) -> dict[str, torch.Tensor]:
    """The W task: replay only the dW GEMMs from the stash."""
    grads: dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for s in wstash:
            g = torch.einsum(s.dw_spec, s.x, s.dy)
            grads[s.pname] = grads[s.pname] + g if s.pname in grads else g
    return grads


def dw_zeros_like(params: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
    return {k: torch.zeros_like(v) for k, v in params.items()}
