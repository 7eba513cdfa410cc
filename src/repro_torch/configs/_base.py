"""Shared helpers for the port's architecture config modules.

Each config module exports:
  config()        -> ModelConfig (exact published hyper-parameters)
  reduced()       -> (ModelConfig, RunConfig) tiny same-family smoke config,
                     equal to the reference's ``reduced()``
  one_card_run()  -> RunConfig for the published width on one GPU

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
