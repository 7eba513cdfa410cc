"""Fault-tolerance controller: checkpoint/restart and the straggler
watchdog.

The port's copy of ``repro/runtime/fault_tolerance.py``. It handles (a)
a failed step, by restarting from the last verified checkpoint, (b)
stragglers, flagged by a step-time EMA watchdog, and (c) corrupt or
partial checkpoints, by manifest verification and falling back to the
previous step. It is launcher-level Python around the train step, which
stays failure-oblivious.

On a mesh of ranks every rank runs its own controller over the same
directory, with the session's :class:`repro_torch.ckpt.checkpoint.
MeshLayout` (saves collective, restores per rank). An injected failure
is raised before the step on every rank at the same step, as the
reference raises it on its one host, so all ranks restore together.
Restarts stay on the same mesh: the reference's launcher halves the data
axis on each failure (elastic re-mesh), which waits for the elasticity
slice (ROADMAP.md queue 1 item 8).

Before ``build`` runs again the failed attempt's state and step function
are released, then ``gc.collect()`` and ``torch.cuda.empty_cache()``: a
second copy of a large model's state would not fit its card.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import time
from typing import Callable

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class FaultToleranceConfig:
    ckpt_every: int = 50
    keep: int = 3
    max_failures: int = 3
    # straggler watchdog: flag a step slower than ema * factor
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    async_save: bool = True


class StragglerWatchdog:
    """Step-time EMA; on real clusters the flagged rank is reported to the
    scheduler for eviction. Here it surfaces flags and counters."""

    def __init__(self, cfg: FaultToleranceConfig):
        self.cfg = cfg
        self.ema: float | None = None
        self.flags = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.cfg.straggler_factor * \
            self.ema
        self.ema = dt if self.ema is None else (
            self.cfg.ema_decay * self.ema + (1 - self.cfg.ema_decay) * dt
        )
        if slow:
            self.flags += 1
            log.warning("straggler: step took %.3fs (ema %.3fs)", dt,
                        self.ema)
        return slow


class TrainController:
    """Restart-from-checkpoint training loop.

    ``build`` is called after every (re)start: it receives the restored
    tree (or None) and its manifest and returns (state, step_fn,
    save_tree_fn). ``layout`` and ``digest`` go to the
    :class:`CheckpointManager`.
    """

    def __init__(self, ckpt_dir: str, cfg: FaultToleranceConfig,
                 layout=None, digest: bool = False):
        self.cfg = cfg
        self.mgr = CheckpointManager(ckpt_dir, keep=cfg.keep, layout=layout,
                                     digest=digest)
        self.watchdog = StragglerWatchdog(cfg)
        self.failures = 0
        self.resume_steps: list[int] = []   # step each restart resumed at

    def attach(self, session) -> "TrainController":
        """Surface this controller in ``session.describe()
        ["fault_tolerance"]``."""
        session._fault_tolerance = self
        return self

    def summary(self) -> dict:
        """Counters for metrics / ``describe()["fault_tolerance"]``."""
        return {
            "failures": self.failures,
            "max_failures": self.cfg.max_failures,
            "straggler_flags": self.watchdog.flags,
            "straggler_ema_s": self.watchdog.ema,
            "resume_steps": list(self.resume_steps),
            "ckpt_every": self.cfg.ckpt_every,
            "ckpt_steps": self.mgr.list_steps(),
        }

    def restore_latest(self):
        step = self.mgr.latest_step()
        while step is not None:
            if self.mgr.verify(step):
                return self.mgr.restore(step)
            log.warning("checkpoint step %d corrupt; trying previous", step)
            steps = [s for s in self.mgr.list_steps() if s < step]
            step = steps[-1] if steps else None
        return None, None

    def run(self, build: Callable, total_steps: int,
            inject_failure_at: int | None = None):
        """build(restored_tree, manifest) -> (state, run_one_step,
        tree_of(state)); run_one_step(state, step) -> (state, metrics).
        Exceptions trigger restore + rebuild up to max_failures."""
        history = []
        while True:
            tree, manifest = self.restore_latest()
            start = (manifest or {}).get("extra", {}).get("step", 0)
            if self.failures:
                self.resume_steps.append(start)
            state, run_one, tree_of = build(tree, manifest)
            del tree
            step = start
            try:
                while step < total_steps:
                    t0 = time.time()
                    if inject_failure_at is not None and \
                            step == inject_failure_at:
                        inject_failure_at = None
                        raise RuntimeError("injected node failure")
                    state, metrics = run_one(state, step)
                    self.watchdog.observe(time.time() - t0)
                    history.append((step, metrics))
                    step += 1
                    if step % self.cfg.ckpt_every == 0 or \
                            step == total_steps:
                        self.mgr.save(step, tree_of(state),
                                      extra={"step": step},
                                      blocking=not self.cfg.async_save)
                self.mgr.wait()
                return state, history
            except Exception as e:  # noqa: BLE001 — restart on anything
                self.failures += 1
                log.error("step %d failed (%s); restart %d/%d", step, e,
                          self.failures, self.cfg.max_failures)
                if self.failures >= self.cfg.max_failures:
                    raise
                self.mgr.wait()
            # the failed attempt's state and step function go before the
            # next build allocates its own
            state = run_one = tree_of = None
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
