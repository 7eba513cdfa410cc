"""Request queue + admission policy for the continuous-batching engine.

The scheduler owns *which* work runs each tick; the engine owns *how*.
FIFO admission keeps the correctness story simple (and matches the
paper's framing of serving as a pure batching problem); the policy knobs
bound how much prefill work may delay in-flight decodes per tick, and
``mode="static"`` degrades admission to classic static batching (admit a
full batch only when the pool is empty) — the baseline the benchmark
compares against.

A copy of ``repro.serving.scheduler``, with the MoE capacity-aware
admission bound (``MoECapacity``; the dispatch capacity is the model
blocks' ``_capacity``).
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
from typing import Any, Sequence

import numpy as np

from repro_torch.serving.slots import WAIT_PREFIX, SlotPool

_ids = itertools.count()


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request plus its in-flight state.

    ``eq=False``: requests compare (and hash) by identity. The generated
    ``__eq__`` would compare the numpy ``prompt`` field element-wise and
    ``req in queue`` / ``queue.remove(req)`` would raise "truth value of
    an array is ambiguous" as soon as two requests are queued — a request
    handle is a unique in-flight object, never a value.
    """

    prompt: np.ndarray              # int32 [prompt_len]
    max_gen: int = 16               # generated-token budget (incl. first)
    stop: Sequence[int] = ()        # stop-token ids (emitted, then done)
    # non-greedy decoding (repro_torch.serving.sampling): temperature 0 keeps
    # the in-graph greedy argmax; a seed pins the sampled stream across
    # engine restarts.
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int | None = None
    id: int = dataclasses.field(default_factory=lambda: next(_ids))

    # in-flight state (engine-owned)
    slot: int | None = None
    tokens: list = dataclasses.field(default_factory=list)  # generated
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    error: BaseException | None = None
    _stream: "queue.SimpleQueue[Any]" = dataclasses.field(
        default_factory=queue.SimpleQueue)

    def __post_init__(self):
        from repro_torch.serving.sampling import SamplingParams, make_rng

        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_gen < 1:
            raise ValueError(f"max_gen must be >= 1, got {self.max_gen}")
        self.stop = tuple(int(t) for t in self.stop)
        self.sampling = SamplingParams(temperature=self.temperature,
                                       top_p=self.top_p, seed=self.seed)
        self._rng = None if self.sampling.greedy \
            else make_rng(self.sampling)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    def result(self, timeout: float | None = None) -> list:
        """Block until finished; returns the generated tokens."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still running")
        if self.error is not None:
            raise self.error
        return list(self.tokens)


@dataclasses.dataclass(frozen=True)
class MoECapacity:
    """Capacity-aware MoE admission bound.

    Every co-resident slot routes its decode token through the MoE
    layers; the dispatch buffer holds ``capacity(tokens)`` tokens per
    expert and silently *drops* assignments beyond it. Uniform routing
    always fits (the capacity formula covers ``top_k/E`` load plus the
    capacity factor), but real routing is skewed — a hot expert drawing
    ``skew``× the uniform share overflows once enough slots decode
    together. This bound projects the hot-expert load of the would-be
    co-resident batch and defers admission past the largest batch whose
    projection still fits, trading occupancy for zero projected drops.
    """

    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # assumed hot-expert load as a multiple of the uniform share;
    # 0 disables the bound (admit regardless of projected load)
    skew: float = 2.0

    @classmethod
    def from_moe_cfg(cls, mo, skew: float = 2.0) -> "MoECapacity":
        return cls(n_experts=mo.n_experts, top_k=mo.top_k,
                   capacity_factor=mo.capacity_factor, skew=skew)

    def fits(self, n_tokens: int) -> bool:
        """Does a co-batch of ``n_tokens`` decode tokens fit the
        projected hot expert within its dispatch capacity?"""
        if self.skew <= 0 or n_tokens <= 0:
            return True
        from repro_torch.models.blocks import _capacity

        cap = _capacity(n_tokens, self)
        hot = n_tokens * self.top_k / self.n_experts * self.skew
        return hot <= cap

    def max_admissible(self, n_slots: int) -> int:
        """Largest co-batch (<= n_slots) the bound admits."""
        n = 0
        while n < n_slots and self.fits(n + 1):
            n += 1
        return n


@dataclasses.dataclass
class SchedulerPolicy:
    # max new requests prefills per engine tick: bounds how long in-flight
    # decodes stall behind prompt processing (prefill/decode interleave)
    max_prefills_per_tick: int = 2
    # "continuous": refill any free slot each tick;
    # "static": admit only when the pool is completely idle (baseline)
    mode: str = "continuous"
    # MoE capacity-aware admission: defer admissions whose projected
    # co-resident hot-expert load would overflow the dispatch capacity.
    # None disables (dense models / unbounded admission).
    moe_capacity: MoECapacity | None = None

    def __post_init__(self):
        if self.mode not in ("continuous", "static"):
            raise ValueError(
                f"unknown admission mode {self.mode!r}; pick "
                "'continuous' or 'static'")
        if self.max_prefills_per_tick < 1:
            raise ValueError("max_prefills_per_tick must be >= 1")


class RequestScheduler:
    """Thread-safe FIFO queue with slot-pool admission."""

    def __init__(self, policy: SchedulerPolicy | None = None):
        self.policy = policy or SchedulerPolicy()
        self._lock = threading.Lock()
        self._queue: list[Request] = []
        # admissions deferred (kept queued) by the MoE capacity bound
        self.capacity_deferrals = 0

    def submit(self, req: Request) -> Request:
        with self._lock:
            self._queue.append(req)
        return req

    @property
    def n_queued(self) -> int:
        with self._lock:
            return len(self._queue)

    def remove(self, req: Request) -> bool:
        """Pull a still-queued request back out (e.g. failed submit)."""
        with self._lock:
            if req in self._queue:
                self._queue.remove(req)
                return True
            return False

    def drain(self) -> list[Request]:
        """Empty the queue, returning what was waiting (engine failure)."""
        with self._lock:
            out, self._queue = self._queue, []
            return out

    def admit(self, pool: SlotPool,
              ) -> tuple[list[Request], list[tuple[Request, Exception]]]:
        """Move queued requests into free slots (FIFO), per the policy.

        Returns ``(admitted, rejected)``: admitted requests have
        ``req.slot`` assigned (the engine still resets + prefills them);
        rejected ones raised a ``ValueError`` from the pool — an
        impossible request (e.g. an over-long prompt that slipped past
        submit-time validation, or a page span no partition can ever
        hold). Rejection must not tear down the tick: the engine fails
        that single request and admission of its queue neighbours
        continues — an exception escaping here would kill the daemon
        driver and strand every in-flight request.

        A pool may also answer ``WAIT_PREFIX`` for a request that should
        wait on an in-flight same-prefix prefill: that request keeps its
        queue position but admission continues past it, so a deferred
        head never blocks unrelated neighbours behind it (None still
        means out-of-capacity and stops admission for the tick).

        With ``policy.moe_capacity`` set, admission additionally stops —
        FIFO order preserved — once the projected co-resident decode
        batch (active slots + already-admitted + the candidate) would
        overflow the projected hot expert's dispatch capacity; each such
        stop bumps ``capacity_deferrals``. Deferred requests re-try on
        the next tick as slots free up. The first request into an idle
        pool is always admitted — an over-tight bound degrades to serial
        serving, it never livelocks.
        """
        admitted: list[Request] = []
        rejected: list[tuple[Request, Exception]] = []
        with self._lock:
            if self.policy.mode == "static" and pool.n_active > 0:
                return admitted, rejected
            limit = (self.policy.max_prefills_per_tick
                     if self.policy.mode == "continuous"
                     else pool.n_slots)
            cap = self.policy.moe_capacity
            i = 0
            while i < len(self._queue) and len(admitted) < limit:
                req = self._queue[i]
                # the bound trades occupancy for projected drops, never
                # liveness: the first request into an idle pool always
                # admits, else an over-tight bound would livelock.
                # (n_active already counts this tick's admissions —
                # try_admit claims the slot immediately.)
                co = pool.n_active
                if cap is not None and co > 0 and not cap.fits(co + 1):
                    self.capacity_deferrals += 1
                    break
                try:
                    s = pool.try_admit(req)
                except ValueError as e:
                    self._queue.pop(i)
                    rejected.append((req, e))
                    continue
                if s is WAIT_PREFIX:
                    i += 1
                    continue
                if s is None:
                    break
                self._queue.pop(i)
                req.slot = s.index
                admitted.append(req)
        return admitted, rejected
