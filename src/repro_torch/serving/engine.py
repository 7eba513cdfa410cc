"""ServeEngine: the continuous-batching driver over a serve Session.

One engine owns the params, the slotted caches and the jitted step
functions (one decode step, one prefill step per distinct chunk width —
``prefill_chunk`` bounds the compile count for ragged workloads).
``submit()`` is thread-safe and non-blocking; tokens can be consumed per
request via ``stream()``/``Request.result()`` while the driver loop —
``start()`` for the async background thread, or ``step()``/
``run_until_idle()`` for deterministic manual ticking — interleaves
prefills and batched decodes per the scheduler policy.

Each tick:
  1. free slots are refilled from the FIFO queue (admission policy);
  2. each admitted request's slot rows are zeroed
     (``Session.reset_slot_caches``) and its prompt is prefilled —
     writes masked to its slot, so in-flight neighbours are untouched;
  3. one batched decode step advances every active slot at its own
     position (the per-slot ``pos`` vector), and finished requests
     (stop token, ``max_gen``, or cache-full) release their slots.

Because every cache position a request reads was written by that same
request (prefill covers [0, prompt) and each decode writes its position
before attending), a reclaimed slot never leaks state between requests —
engine output is token-identical to independent sequential serving.

Paged sessions (``page_size=`` on the spec) swap the :class:`SlotPool`
for a :class:`PagedSlotPool`: requests carry page tables instead of
whole cache rows, the radix index shares prompt-prefix pages across
requests (prefill resumes at the first uncached token), and each tick
first zeroes the newly allocated pages, then runs the admitted
requests' cross-partition page copies in admission order, then
prefills. Greedy output stays token-identical to the contiguous path.
Sampled requests (``temperature > 0``) pull the drain rank's full
logits and draw host-side with a per-request seeded generator.

On a mesh session every rank runs its own engine, and the engines must
run in lockstep: every rank submits the same requests in the same order
and ticks them with ``step()`` / ``run_until_idle()``; the session checks
each serve step, slot reset, page reset and page copy against every
other rank's and raises on any difference (the engine then fails every
request). So a mesh session refuses the background thread, whose ticks
would admit by the threads' timing, and a sampled request without a
``seed``, whose draws would differ by rank.

A copy of ``repro.serving.engine`` for ``repro_torch`` sessions. It takes
numpy batches to the session and reads back host tensors, exactly as the
reference engine does with jax sessions. A MoE model's engine defaults
to the reference's capacity-aware admission (``MoECapacity``). Left out
until their slices: expert-load stats (ROADMAP.md queue 1 item 7) and the
elastic ``park_all``/``resubmit``/``reshard`` path with the router hooks
(item 8).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, Sequence

import numpy as np

from repro_torch.api.spec import SessionError
from repro_torch.serving.paging import PagedSlotPool
from repro_torch.serving.sampling import sample_token
from repro_torch.serving.scheduler import (
    MoECapacity,
    Request,
    RequestScheduler,
    SchedulerPolicy,
)
from repro_torch.serving.slots import SlotPool

_DONE = object()  # per-request stream sentinel

# prefill chunking re-runs the step with a carried cache; recurrent-state
# kinds recompute their state from scratch per call, so chunking is only
# sound for position-indexed (attention-family) caches.
_CHUNKABLE_MIXES = ("attn", "mla", "dec")


def check_layout(session, prefill_chunk: int | None = None) -> None:
    """Refuse an encoder-decoder (continuous batching drives the
    decoder-only serve path, as the reference's engine does) and what
    recurrent-state layers cannot carry: paged caches and chunked prefill
    (a Mamba prefill starts from zero state, so a second chunk would drop
    the first one's). Raises ``NotImplementedError``; callers may run it
    before building params."""
    if session.cfg.encdec is not None:
        raise NotImplementedError(
            "continuous batching drives the decoder-only serve path; "
            "enc-dec architectures still use serve_prefill/"
            "serve_decode")
    kinds = session.geo.segments[-1].kinds
    if not any(k.split(":")[0] not in _CHUNKABLE_MIXES for k in kinds):
        return
    if session.paged:
        raise NotImplementedError(
            "paged KV covers position-indexed (attention-family) "
            f"caches; segment kinds {kinds} keep per-slot "
            "recurrent state — drop page_size for this "
            "architecture")
    if prefill_chunk is not None:
        raise NotImplementedError(
            "prefill_chunk needs position-indexed caches; segment "
            f"kinds {kinds} include recurrent state that does "
            "not carry across prefill chunks")


@dataclasses.dataclass
class EngineStats:
    prefill_steps: int = 0
    decode_steps: int = 0
    generated_tokens: int = 0
    finished_requests: int = 0
    occupancy: float = 0.0          # mean busy-slot fraction per decode
    rejected_requests: int = 0      # failed at admission (impossible fit)
    prefill_tokens: int = 0         # prompt tokens actually computed
    # paged-KV counters (zero on contiguous pools)
    prefix_hits: int = 0            # admissions that reused prefix pages
    prefix_hit_tokens: int = 0      # prompt tokens skipped via the radix
    evictions: int = 0              # prefix pages LRU-evicted
    pages_in_use: int = 0           # live pages right now
    peak_pages_in_use: int = 0      # high-water mark
    # MoE capacity-aware admission (zero on dense models)
    capacity_deferrals: int = 0     # admissions deferred by the MoE bound


class ServeEngine:
    """Continuous batching over ``Session.serve_step_batched``."""

    def __init__(self, session, params, *, policy: SchedulerPolicy
                 | None = None, prefill_chunk: int | None = None):
        if session.spec.mode != "serve":
            raise ValueError(
                f"ServeEngine needs a serve-mode session (got mode="
                f"{session.spec.mode!r}); build one with "
                "session(arch, mode='serve', max_slots=..., max_seq=...)")
        self.session = session
        self.params = params
        self._paged = bool(session.paged)
        self.prefill_chunk = (prefill_chunk
                              if prefill_chunk is not None
                              else session.spec.prefill_chunk)
        check_layout(session, self.prefill_chunk)
        self.pool: SlotPool | PagedSlotPool = self._build_pool()
        moe_cfg = getattr(session.cfg, "moe", None)
        if policy is None and moe_cfg is not None:
            # MoE serving defaults to capacity-aware admission: defer
            # admissions whose projected co-resident hot-expert load
            # would overflow the dispatch capacity (pass an explicit
            # policy — moe_capacity=None — to admit unbounded).
            policy = SchedulerPolicy(
                moe_capacity=MoECapacity.from_moe_cfg(moe_cfg))
        self.scheduler = RequestScheduler(policy)
        session.check_slot_sharding()  # fail before allocating caches
        # host-side sampling needs the serve step's full-logits return,
        # which some layouts cannot provide; probe once so submit() can
        # reject temperature>0 up front instead of NotImplementedError
        # escaping mid-tick and killing every in-flight request.
        probe = getattr(session, "sampling_unsupported_reason", None)
        self._no_sampling = probe() if probe is not None else None
        self.caches = session.init_caches()
        self.stats = EngineStats()
        session._engine_stats = self.stats   # describe()["serving"]
        self._by_slot: dict[int, Request] = {}
        self._lock = threading.RLock()      # one tick at a time
        self._wake = threading.Event()      # submit() -> driver loop
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._failure: BaseException | None = None
        self._closed = False

    def _build_pool(self) -> "SlotPool | PagedSlotPool":
        """The slot (or paged-slot) pool for the session (pool
        partitioning follows the session's data and group axes)."""
        session = self.session
        if self._paged:
            pods = getattr(session, "pods_size", None) \
                or (session.spec.pods or 1)
            return PagedSlotPool(
                session.max_slots, session._max_seq(),
                page_size=session.page_size, n_pages=session.n_pages,
                shards=pods * session.data_size, groups=session.rt.G,
                sharing=session.spec.prefix_sharing == "on")
        return SlotPool(session.max_slots, session._max_seq())

    # ------------------------------------------------------------------ #
    # Submission / consumption (any thread)
    # ------------------------------------------------------------------ #

    def submit(self, prompt, *, max_gen: int = 16,
               stop: Sequence[int] = (), temperature: float = 0.0,
               top_p: float = 1.0, seed: int | None = None) -> Request:
        """Enqueue a generation request; returns its handle immediately.

        ``temperature == 0`` (default) decodes greedily in-graph;
        ``temperature > 0`` samples host-side from the full logits, with
        ``top_p`` nucleus truncation and an optional per-request ``seed``
        that pins the sampled stream across engine restarts.
        """
        if self._closed:
            raise RuntimeError("engine closed; no further submissions")
        if self._failure is not None:
            raise RuntimeError("engine failed; no further submissions") \
                from self._failure
        if temperature > 0 and seed is None \
                and getattr(self.session, "mesh", None) is not None:
            raise SessionError(
                "a sampled request (temperature > 0) on a mesh session "
                "needs a seed: every rank draws its tokens, and the draws "
                "must agree")
        req = Request(prompt=np.asarray(prompt, np.int32),
                      max_gen=max_gen, stop=stop, temperature=temperature,
                      top_p=top_p, seed=seed)
        self.pool.validate_prompt(req.prompt_len)  # reject before queuing
        if not req.sampling.greedy and self._no_sampling is not None:
            raise NotImplementedError(
                f"sampling (temperature>0) is unavailable on this "
                f"session: {self._no_sampling} — submit greedy "
                "(temperature=0) requests, or rebuild the session on a "
                "layout that can return logits")
        self.scheduler.submit(req)
        if self._failure is not None or self._closed:
            # the engine died or closed while we enqueued: the final
            # drain may have run before our append landed, so pull the
            # request back out and fail it loudly instead of letting it
            # hang in a dead engine's queue.
            self.scheduler.remove(req)
            _fail_request(req,
                          self._failure or RuntimeError("engine closed"))
            raise RuntimeError("engine stopped; no further submissions") \
                from self._failure
        self._wake.set()
        return req

    def stream(self, req: Request, timeout: float | None = None,
               ) -> Iterator[int]:
        """Yield ``req``'s tokens as they are decoded; returns on finish.

        Blocks between tokens by default (first-token latency includes
        jit compiles, which can be long on full-size archs); pass
        ``timeout`` seconds to raise TimeoutError on a stalled driver
        instead.
        """
        import queue as _queue

        while True:
            try:
                item = req._stream.get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(
                    f"request {req.id}: no token within {timeout}s — is "
                    "the engine driver running (start()/step())?") \
                    from None
            if item is _DONE:
                if req.error is not None:
                    raise req.error
                return
            yield item

    # ------------------------------------------------------------------ #
    # Driving (one driver at a time: background thread OR manual ticks)
    # ------------------------------------------------------------------ #

    def step(self) -> bool:
        """One engine tick. Returns True if any work ran."""
        with self._lock:
            try:
                admitted, rejected = self.scheduler.admit(self.pool)
                for req, err in rejected:
                    # an impossible request fails alone; its queue
                    # neighbours were already admitted past it.
                    self.stats.rejected_requests += 1
                    _fail_request(req, err)
                if admitted:
                    if self._paged:
                        self._apply_page_plans(admitted)
                    else:
                        reset = self.pool.mask_for(
                            [r.slot for r in admitted])
                        self.caches = self.session.reset_slot_caches(
                            self.caches, reset)
                    for req in admitted:
                        self._by_slot[req.slot] = req
                    self._prefill_admitted(admitted)
                active = self.pool.active()
                if active:
                    self._decode_tick()
                self.stats.capacity_deferrals = \
                    self.scheduler.capacity_deferrals
                if self._paged:
                    self.stats.prefix_hits = self.pool.prefix_hits
                    self.stats.prefix_hit_tokens = \
                        self.pool.prefix_hit_tokens
                    self.stats.evictions = self.pool.evictions
                    self.stats.pages_in_use = self.pool.pages_in_use
                    self.stats.peak_pages_in_use = \
                        self.pool.pool.peak_in_use
                return bool(admitted or rejected or active)
            except BaseException as e:  # noqa: BLE001 — fail all waiters
                self._fail(e)
                raise

    def run_until_idle(self, max_ticks: int = 100_000) -> EngineStats:
        """Tick until the queue and every slot are empty (sync driver)."""
        for _ in range(max_ticks):
            if not self.step() and self.scheduler.n_queued == 0:
                break
        else:
            e = RuntimeError(f"not idle after {max_ticks} ticks")
            with self._lock:
                self._fail(e)  # unblock waiters like every error path
            raise e
        return self.stats

    def start(self) -> "ServeEngine":
        """Run the driver loop in a daemon thread (async driver). Refused
        on a mesh session: its ranks' engines tick in lockstep, which a
        thread's timing cannot keep."""
        if getattr(self.session, "mesh", None) is not None:
            raise SessionError(
                "a mesh session's engines must tick in lockstep: every "
                "rank admits the same requests at the same tick, which a "
                "background thread's timing cannot guarantee; drive the "
                "engine with step() / run_until_idle() on every rank")
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-serve-engine")
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop the driver. Requests still queued or in flight are failed
        (their waiters unblock with the close error) rather than left
        hanging in a dead engine."""
        self._closed = True
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError(
                    "engine driver still running after 60s (a long "
                    "compile?); close() aborted — retry once the tick "
                    "finishes")
            self._thread = None
        with self._lock:
            if self._by_slot or self.scheduler.n_queued:
                self._fail(RuntimeError(
                    "engine closed with requests outstanding"))

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                did = self.step()
            except BaseException:  # noqa: BLE001 — recorded by step()
                return
            if not did and self.scheduler.n_queued == 0:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    # ------------------------------------------------------------------ #
    # Tick internals
    # ------------------------------------------------------------------ #

    def _step_batched(self, batch, want_logits: bool = False):
        """One slot-aware step; asserts the output covers every slot
        (a compacted output would silently misalign slot indexing)."""
        if self._paged:
            batch = dict(batch,
                         page_tables=self.pool.page_table_matrix())
        if want_logits:
            res = self.session.serve_step_batched(
                self.params, self.caches, batch, want_logits=True)
        else:
            res = self.session.serve_step_batched(
                self.params, self.caches, batch)
        if want_logits:
            out, logits, caches = res
        else:
            out, caches = res
            logits = None
        if out.shape[0] != self.pool.n_slots:
            raise RuntimeError(
                f"serve step returned {out.shape[0]} tokens for "
                f"{self.pool.n_slots} slots — the step tiling does not "
                "cover the slot pool (check_slot_sharding should have "
                "caught this)")
        return out, logits, caches

    def _apply_page_plans(self, reqs: list[Request]) -> None:
        """Device work for the admitted requests' page plans: zero every
        fresh page (the paged analogue of the slot-row reset — copy
        destinations get overwritten right after), then run each
        request's cross-partition page copies *in admission order*: a
        later request's copy source may itself be an earlier request's
        just-registered destination."""
        fresh = np.zeros(self.session.n_pages, bool)
        for req in reqs:
            al = self.pool.slots[req.slot].alloc
            for gid in al.fresh:
                fresh[gid] = True
        if fresh.any():
            self.caches = self.session.reset_pages(self.caches, fresh)
        w = self.pool.pages_per_req  # fixed width: one compile
        for req in reqs:
            al = self.pool.slots[req.slot].alloc
            if not al.copies:
                continue
            # pad by repeating the first pair — duplicate writes then
            # carry identical values, so the scatter stays well-defined
            src = np.full(w, al.copies[0][0], np.int32)
            dst = np.full(w, al.copies[0][1], np.int32)
            for i, (s_, d_) in enumerate(al.copies):
                src[i], dst[i] = s_, d_
            self.caches = self.session.copy_pages(self.caches, src, dst)
            # the sources' bytes are duplicated now: drop the admission
            # pins so the radix may evict them under page pressure again
            self.pool.copies_done(req.slot)

    def _prefill_admitted(self, reqs: list[Request]) -> None:
        """Prefill the admitted requests' prompts into their slots.

        Co-admitted chunks of equal width share one pipeline pass (the
        pos/mask vectors are already per-row), so K same-length prompts
        — or K chunk-aligned long prompts under ``prefill_chunk`` — cost
        one step, not K. A request's first token is sampled by the step
        that covers its prompt's last position. Paged requests whose
        prompt prefix came out of the radix start at their first
        uncached token instead of 0.
        """
        n = self.pool.n_slots

        def start_off(r):
            if self._paged:
                return self.pool.slots[r.slot].alloc.start_pos
            return 0

        pending = [(r, start_off(r)) for r in reqs]
        while pending:
            by_width: dict[int, list] = {}
            for r, off in pending:
                c = min(self.prefill_chunk or r.prompt_len,
                        r.prompt_len - off)
                by_width.setdefault(c, []).append((r, off))
            pending = []
            for c, group in sorted(by_width.items()):
                toks = np.zeros((n, c), np.int32)
                pos = self.pool.pos_vector()
                mask = np.zeros(n, bool)
                want = False
                for r, off in group:
                    toks[r.slot] = r.prompt[off:off + c]
                    pos[r.slot] = off
                    mask[r.slot] = True
                    if off + c >= r.prompt_len and not r.sampling.greedy:
                        want = True  # first token sampled this step
                out, logits, self.caches = self._step_batched(
                    {"tokens": toks, "pos": pos, "slot_mask": mask},
                    want)
                self.stats.prefill_steps += 1
                self.stats.prefill_tokens += c * len(group)
                out_np = logits_np = None
                for r, off in group:
                    if off + c >= r.prompt_len:
                        self.pool.slots[r.slot].pos = r.prompt_len
                        if self._paged:
                            # fully-prompt-covered pages turn shareable
                            self.pool.note_prefilled(r.slot, r.prompt)
                        if out_np is None:
                            out_np = np.asarray(out)
                        if logits_np is None and logits is not None:
                            logits_np = np.asarray(logits)
                        self._emit(r, self._pick_token(
                            r, out_np, logits, logits_np))
                    else:
                        pending.append((r, off + c))

    def _pick_token(self, req: Request, out_np, logits,
                    logits_np) -> int:
        """The next token for ``req``: the in-graph greedy argmax, or a
        host-side draw from its row of the returned logits."""
        if req.sampling.greedy:
            return int(out_np[req.slot])
        if logits_np is None:
            logits_np = np.asarray(logits)
        return sample_token(logits_np[req.slot], req.sampling, req._rng)

    def _decode_tick(self) -> None:
        """One batched decode step over every active slot.

        Finished requests are skipped defensively: a request that
        completed between the ``active`` snapshot and the emit (or whose
        slot was released out-of-band) must not receive another token or
        advance a slot that may already belong to a new request.
        """
        n = self.pool.n_slots
        active = self.pool.active()
        toks = np.zeros((n, 1), np.int32)
        want = False
        for s in active:
            req = self._by_slot.get(s.index)
            if req is None or req.done.is_set():
                continue
            toks[s.index, 0] = req.tokens[-1]
            if not req.sampling.greedy:
                want = True
        batch = {"tokens": toks, "pos": self.pool.pos_vector(),
                 "slot_mask": self.pool.active_mask()}
        out, logits, self.caches = self._step_batched(batch, want)
        self.pool.observe_tick()
        self.stats.decode_steps += 1
        self.stats.occupancy = self.pool.occupancy
        out_np = np.asarray(out)
        logits_np = np.asarray(logits) if logits is not None else None
        for s in active:
            req = self._by_slot.get(s.index)
            if req is None or req.done.is_set():
                continue
            s.pos += 1
            self._emit(req, self._pick_token(req, out_np, logits,
                                             logits_np))

    def _emit(self, req: Request, tok: int) -> None:
        if req.done.is_set() or req.slot is None:
            # late emit on a finished request: its slot may already hold
            # a different in-flight request — reading (or finishing)
            # through self.pool.slots[req.slot] would corrupt that one.
            return
        req.tokens.append(tok)
        req._stream.put(tok)
        self.stats.generated_tokens += 1
        slot = self.pool.slots[req.slot]
        if (len(req.tokens) >= req.max_gen or tok in req.stop
                or slot.pos >= self.pool.max_seq):
            self._finish(req)

    def _finish(self, req: Request) -> None:
        if req.slot is not None:
            self._by_slot.pop(req.slot, None)
            self.pool.release(req.slot)
            # the slot is free for reallocation from here on: drop the
            # request's pointer so no late _emit/_decode_tick can read a
            # reallocated slot's state through it.
            req.slot = None
        self.stats.finished_requests += 1
        req.done.set()
        req._stream.put(_DONE)
        self._wake.set()

    def _fail(self, e: BaseException) -> None:
        self._failure = e
        for req in list(self._by_slot.values()):
            _fail_request(req, e)
        self._by_slot.clear()
        for req in self.scheduler.drain():
            _fail_request(req, e)


def _fail_request(req: Request, e: BaseException) -> None:
    """Tear down one request's waiters with ``e``."""
    req.error = e
    req.slot = None   # engine is dead: never dereference pool state again
    req.done.set()
    req._stream.put(_DONE)
