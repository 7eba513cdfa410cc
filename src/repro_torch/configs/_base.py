"""Shared helpers for the port's architecture config modules.

Each config module exports:
  config()        -> ModelConfig (exact published hyper-parameters)
  reduced()       -> (ModelConfig, RunConfig) tiny same-family smoke config,
                     equal to the reference's ``reduced()``
  one_card_run()  -> RunConfig for serving the published width on one GPU
                     (where the port serves the architecture)
  one_card_train_run() -> RunConfig for training it on one GPU (where
                     the port trains the architecture)
  one_card_config() -> ModelConfig cut to what one GPU holds, where the
                     published model does not fit (its docstring names
                     the cut); ``config()`` otherwise

The reference's ``production_run(shape)`` lays a model over a 256-chip
mesh; the port runs on one card (pp = data = 1), so it has no counterpart
here yet.
"""

from __future__ import annotations

from repro_torch.models.common import RunConfig


def one_card(**kw) -> RunConfig:
    """One rank holds every stage: no pipeline, no data axis, bf16."""
    return RunConfig(pp=1, vpp=1, microbatches=1, param_dtype="bfloat16",
                     compute_dtype="bfloat16", **kw)


def one_card_train(**kw) -> RunConfig:
    """Training on one rank: the ZeroPP table with the stage blocks
    interleaved (vpp = 2), four micro-batches in units of two; bf16
    params and compute, float32 master weights and moments."""
    base = dict(pp=1, vpp=2, microbatches=4, unit=2, schedule="zeropp",
                param_dtype="bfloat16", compute_dtype="bfloat16",
                opt_moment_dtype="float32")
    base.update(kw)
    return RunConfig(**base)
