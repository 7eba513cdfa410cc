"""Temperature / top-p sampling with per-request seeded generators.

The serve step keeps greedy argmax *in-graph* (bitwise parity with the
recorded goldens and the contiguous path is non-negotiable), so sampled
requests take a different route: the step optionally returns the drain
rank's full next-token logits and the engine samples host-side, one
seeded ``numpy`` Generator per request. Determinism contract: the same
(prompt, temperature, top_p, seed) produces the same token sequence
across engine restarts — the generator is private to the request and
advances exactly once per emitted token, so batch composition, admission
order and slot placement cannot perturb it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs. ``temperature == 0`` means greedy
    (the in-graph argmax token is used and no rng state advances)."""

    temperature: float = 0.0
    top_p: float = 1.0
    seed: int | None = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if not 0 < self.top_p <= 1:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0


def make_rng(params: SamplingParams) -> np.random.Generator:
    """One generator per request; an explicit seed pins the stream."""
    return np.random.default_rng(params.seed)


def sample_token(logits: np.ndarray, params: SamplingParams,
                 rng: np.random.Generator) -> int:
    """Draw one token from ``logits`` [vocab] (host-side, float64).

    Temperature scales the logits; top-p keeps the smallest
    probability-sorted prefix whose mass reaches ``top_p`` (always
    including the token that crosses the threshold) and renormalizes.
    """
    if params.greedy:
        return int(np.argmax(logits))
    z = np.asarray(logits, np.float64) / params.temperature
    z -= z.max()
    p = np.exp(z)
    p /= p.sum()
    if params.top_p < 1.0:
        order = np.argsort(-p, kind="stable")
        csum = np.cumsum(p[order])
        k = int(np.searchsorted(csum, params.top_p)) + 1
        keep = order[:k]
        q = np.zeros_like(p)
        q[keep] = p[keep]
        p = q / q.sum()
    return int(rng.choice(p.size, p=p))
