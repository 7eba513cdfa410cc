"""SlotPool: per-slot views over the monolithic serve caches.

``init_serve_caches`` allocates one ``[M·V, batch, max_seq, ...]`` tree;
the jitted step wants exactly that layout, so "per-slot caches" cannot be
physically separate buffers. Instead each batch row is a *slot* with its
own host-side position/length state, and the pool materializes the
``pos``/``slot_mask`` vectors that ``Session.serve_step_batched`` needs
each tick. Reclaiming a slot is O(1) bookkeeping here plus one masked
zeroing of its cache rows (``Session.reset_slot_caches``) — the jitted
step function is never rebuilt.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class _WaitPrefix:
    """``try_admit`` verdict distinct from None: this request should
    wait for an in-flight same-prefix prefill (its shared pages are
    about to be cached), but the pool itself has capacity — the
    scheduler may admit queue neighbours past it instead of stalling
    admission for the tick."""

    def __repr__(self) -> str:
        return "WAIT_PREFIX"


WAIT_PREFIX = _WaitPrefix()


@dataclasses.dataclass
class SlotView:
    """One cache row: independent position/length state for one request."""

    index: int
    pos: int = 0                    # next cache position to be written
    request_id: int | None = None   # owning request (None = free)

    @property
    def free(self) -> bool:
        return self.request_id is None


class SlotPool:
    """Fixed pool of ``n_slots`` cache rows with alloc/free bookkeeping."""

    def __init__(self, n_slots: int, max_seq: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.slots = [SlotView(i) for i in range(n_slots)]
        # lifetime counters for occupancy reporting
        self.ticks = 0
        self.busy_slot_ticks = 0

    # ------------------------------------------------------------------ #
    def validate_prompt(self, prompt_len: int) -> None:
        """The single authority on prompt-vs-cache sizing (the engine
        calls this at submit time, alloc at admission time)."""
        if prompt_len >= self.max_seq:
            raise ValueError(
                f"prompt of {prompt_len} tokens cannot decode inside a "
                f"max_seq={self.max_seq} cache (need >= prompt_len + 1)")

    def alloc(self, request_id: int, prompt_len: int) -> SlotView | None:
        """Claim the lowest free slot for ``request_id`` (None when
        full); rejects prompts the cache cannot hold."""
        self.validate_prompt(prompt_len)
        for s in self.slots:
            if s.free:
                s.request_id = request_id
                s.pos = 0
                return s
        return None

    def try_admit(self, req) -> SlotView | None:
        """Admission entry point shared with the paged pool: claim a
        slot for ``req`` (None when full; ValueError when the request
        can never fit — the scheduler rejects it without dequeuing its
        neighbours)."""
        return self.alloc(req.id, req.prompt_len)

    def release(self, index: int) -> None:
        s = self.slots[index]
        s.request_id = None
        s.pos = 0

    # ------------------------------------------------------------------ #
    @property
    def n_active(self) -> int:
        return sum(not s.free for s in self.slots)

    @property
    def n_free(self) -> int:
        return self.n_slots - self.n_active

    def active(self) -> list[SlotView]:
        return [s for s in self.slots if not s.free]

    # ---- vectors for serve_step_batched ------------------------------ #
    def pos_vector(self) -> np.ndarray:
        """int32 [n_slots]: each slot's next write position (free -> 0)."""
        return np.array([s.pos for s in self.slots], np.int32)

    def active_mask(self) -> np.ndarray:
        """bool [n_slots]: slots owned by an in-flight request."""
        return np.array([not s.free for s in self.slots], bool)

    def mask_for(self, indices) -> np.ndarray:
        """bool [n_slots]: one-hot-ish mask over ``indices``."""
        m = np.zeros(self.n_slots, bool)
        m[list(indices)] = True
        return m

    # ---- occupancy accounting ---------------------------------------- #
    def observe_tick(self) -> None:
        """Record one decode tick's occupancy (for the benchmark)."""
        self.ticks += 1
        self.busy_slot_ticks += self.n_active

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots busy per observed decode tick."""
        if self.ticks == 0:
            return 0.0
        return self.busy_slot_ticks / (self.ticks * self.n_slots)
