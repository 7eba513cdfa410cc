"""Paged KV cache: fixed-size ref-counted pages under the slot pool.

``init_serve_caches(page_size=...)`` lays the attention caches out as
``[M·V, n_pages, page_size, ...]`` instead of one contiguous
``(max_seq)`` row per slot; each request carries an int32 page *table*
(``max_seq // page_size`` entries, local page ids) and the cached
attention path gathers/scatters K/V through it. Cache memory then scales
with tokens actually written — and, with the radix index sharing prefix
pages across requests, with *unique* tokens.

Two host classes live here:

* :class:`PagePool` — the page arena bookkeeping: a free list and a
  refcount per page, partitioned over the pods×data shards (the device
  page axis is sharded exactly like the old batch axis, so a slot row
  can only gather pages of its own shard — every allocation is pinned to
  the partition of the slot it serves).
* :class:`PagedSlotPool` — the engine-facing pool: SlotPool-compatible
  surface (slots, pos/mask vectors, occupancy) plus paged admission:
  radix prefix match → shared-page refs (or cross-partition copies) →
  up-front reservation of the request's worst-case page span → the
  :class:`PageAllocation` the engine turns into device work (copies,
  resets, prefill from the first uncached token).

Greedy paged decoding stays token-identical to the contiguous path:
gathered pages hold the same values at the same positions, fresh pages
are zeroed like reclaimed slot rows, and anything a sentinel table entry
drags in sits beyond the causal mask (exact ``-inf`` before softmax).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.serving.slots import WAIT_PREFIX, SlotView


class PagePool:
    """Free-list + refcount bookkeeping for ``n_pages`` fixed-size pages.

    Pages split evenly over ``shards * groups`` allocation partitions:
    ``shards`` is the device sharding of the page axis (pods×data — a
    slot row can only *gather* pages of its own shard) and ``groups``
    subdivides each shard per FSDP group — cache leaves are sharded over
    the stage axis, so a page's bytes exist only in the replica of the
    group that wrote them; sharing across groups would read unwritten
    memory. Page ids are *global*; partition ``p`` owns
    ``[p*n_loc, (p+1)*n_loc)``. Device page tables hold *shard-local*
    ids (``gid % (n_pages // shards)``)."""

    def __init__(self, n_pages: int, page_size: int, shards: int = 1,
                 groups: int = 1):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        parts = shards * groups
        if n_pages < parts or n_pages % parts != 0:
            raise ValueError(
                f"n_pages ({n_pages}) must divide evenly over the "
                f"{parts} cache partitions ({shards} pods×data shards "
                f"x {groups} groups)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.shards = shards
        self.groups = groups
        self.partitions = parts
        self.n_loc = n_pages // parts
        self.dev_pages = n_pages // shards
        self._refs = np.zeros(n_pages, np.int64)
        # lowest-id-first allocation keeps runs deterministic
        self._free = [list(range(p * self.n_loc, (p + 1) * self.n_loc))
                      for p in range(parts)]
        for f in self._free:
            heapq.heapify(f)
        self.peak_in_use = 0

    # ------------------------------------------------------------------ #
    def partition_of(self, gid: int) -> int:
        return gid // self.n_loc

    def group_of(self, partition: int) -> int:
        """Which FSDP group wrote (and may read) this partition's pages."""
        return partition % self.groups

    def local_id(self, gid: int) -> int:
        return gid % self.dev_pages

    def free_in(self, partition: int) -> int:
        return len(self._free[partition])

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - sum(len(f) for f in self._free)

    def refcount(self, gid: int) -> int:
        return int(self._refs[gid])

    # ------------------------------------------------------------------ #
    def alloc(self, partition: int, k: int) -> list[int] | None:
        """Claim ``k`` free pages in ``partition`` (refcount 1 each), or
        None if the free list is short (caller evicts / defers)."""
        free = self._free[partition]
        if len(free) < k:
            return None
        out = [heapq.heappop(free) for _ in range(k)]
        for gid in out:
            self._refs[gid] = 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return out

    def ref(self, gid: int) -> None:
        if self._refs[gid] < 1:
            raise ValueError(f"page {gid} is free; cannot add a reference")
        self._refs[gid] += 1

    def unref(self, gid: int) -> bool:
        """Drop one reference; returns True when the page went free."""
        if self._refs[gid] < 1:
            raise ValueError(f"page {gid} is already free")
        self._refs[gid] -= 1
        if self._refs[gid] == 0:
            heapq.heappush(self._free[self.partition_of(gid)], gid)
            return True
        return False


@dataclasses.dataclass
class PageAllocation:
    """One admitted request's page plan (host side of the tick work)."""

    start_pos: int                  # prefill resumes here (shared prefix)
    table: np.ndarray               # int32 [pages_per_req], LOCAL page ids
    pages: list[int]                # global ids this request holds refs on
    fresh: list[int]                # newly allocated -> device reset
    copies: list[tuple[int, int]]   # (src_gid, dst_gid) device page copies
    src_refs: list[int]             # copy sources pinned until the engine
    #                                 executes the copies (copies_done)
    n_shared: int                   # prefix pages satisfied from the radix
    n_prompt_pages: int             # pages fully covered by the prompt
    pending_key: tuple | None       # co-admission dedup key (held until
    #                                 the radix insert or release)


@dataclasses.dataclass
class PagedSlotView(SlotView):
    """A slot row plus its page allocation."""

    alloc: PageAllocation | None = None


class PagedSlotPool:
    """SlotPool-compatible pool that admits by free *pages*, not slots.

    Slot rows still exist (the jitted step is a fixed ``[n_slots]``
    batch) but carry no cache memory of their own; admission needs a free
    row in some partition AND enough free pages there — after counting
    the radix prefix hit and, if the free list is short, LRU-evicting
    unreferenced prefix pages. A prompt whose worst-case page span
    (``ceil(min(prompt+max_gen, max_seq)/page_size)``) exceeds one
    partition's pool can never run and raises; a merely-busy pool defers
    (returns None) like a full SlotPool, and a request whose prefix is
    being prefilled by an in-flight neighbour answers
    :data:`~repro_torch.serving.slots.WAIT_PREFIX` so the scheduler can admit
    unrelated requests past it.
    """

    def __init__(self, n_slots: int, max_seq: int, *, page_size: int,
                 n_pages: int, shards: int = 1, groups: int = 1,
                 sharing: bool = True):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_seq % page_size != 0:
            raise ValueError(
                f"page_size ({page_size}) must divide max_seq "
                f"({max_seq}) so page tables have a fixed width")
        parts = shards * groups
        if n_slots % parts != 0:
            raise ValueError(
                f"n_slots ({n_slots}) must divide evenly over the "
                f"{parts} cache partitions")
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_req = max_seq // page_size
        self.part_rows = n_slots // parts
        self.pool = PagePool(n_pages, page_size, shards, groups)
        if self.pool.n_loc < self.pages_per_req:
            raise ValueError(
                f"max_pages ({n_pages}) gives {self.pool.n_loc} pages per "
                f"partition, below the {self.pages_per_req} a single "
                f"max_seq={max_seq} request may need — raise max_pages")
        self.sharing = sharing
        if sharing:
            from repro_torch.serving.radix import RadixIndex
            self.radix: "RadixIndex | None" = RadixIndex(page_size,
                                                         self.pool)
        else:
            self.radix = None
        self.slots = [PagedSlotView(i) for i in range(n_slots)]
        self._pending_keys: set[tuple] = set()
        # lifetime counters (occupancy mirrors SlotPool; the rest feed
        # the engine's paged stats)
        self.ticks = 0
        self.busy_slot_ticks = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0

    # ---- SlotPool-compatible surface --------------------------------- #
    def validate_prompt(self, prompt_len: int) -> None:
        if prompt_len >= self.max_seq:
            raise ValueError(
                f"prompt of {prompt_len} tokens cannot decode inside a "
                f"max_seq={self.max_seq} cache (need >= prompt_len + 1)")

    def release(self, index: int) -> None:
        s = self.slots[index]
        if s.alloc is not None:
            for gid in s.alloc.pages:
                self.pool.unref(gid)
            for gid in s.alloc.src_refs:  # copies never executed
                self.pool.unref(gid)
            self._pending_keys.discard(s.alloc.pending_key)
            s.alloc = None
        s.request_id = None
        s.pos = 0

    @property
    def n_active(self) -> int:
        return sum(not s.free for s in self.slots)

    @property
    def n_free(self) -> int:
        return self.n_slots - self.n_active

    def active(self) -> list[PagedSlotView]:
        return [s for s in self.slots if not s.free]

    def pos_vector(self) -> np.ndarray:
        return np.array([s.pos for s in self.slots], np.int32)

    def active_mask(self) -> np.ndarray:
        return np.array([not s.free for s in self.slots], bool)

    def mask_for(self, indices) -> np.ndarray:
        m = np.zeros(self.n_slots, bool)
        m[list(indices)] = True
        return m

    def observe_tick(self) -> None:
        self.ticks += 1
        self.busy_slot_ticks += self.n_active

    @property
    def occupancy(self) -> float:
        if self.ticks == 0:
            return 0.0
        return self.busy_slot_ticks / (self.ticks * self.n_slots)

    # ---- paged admission --------------------------------------------- #
    def partition_of_slot(self, index: int) -> int:
        return index // self.part_rows

    def page_table_matrix(self) -> np.ndarray:
        """int32 [n_slots, pages_per_req] of LOCAL page ids (free rows /
        unreserved tail entries hold 0 — gather-safe, causally masked)."""
        out = np.zeros((self.n_slots, self.pages_per_req), np.int32)
        for s in self.slots:
            if s.alloc is not None:
                out[s.index] = s.alloc.table
        return out

    def pages_needed(self, prompt_len: int, max_gen: int) -> int:
        horizon = min(prompt_len + max_gen, self.max_seq)
        return -(-horizon // self.page_size)

    def _page_keys(self, prompt: np.ndarray, n: int) -> tuple:
        """The first ``n`` full prompt pages as a tuple of token tuples."""
        ps = self.page_size
        return tuple(tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
                     for i in range(n))

    def try_admit(self, req):
        """Admit one request: pick the free slot whose partition caches
        the most of its prefix, reserve its worst-case page span (evicting
        if needed), and return the view. Returns None to defer on
        capacity (admission stops for the tick), or :data:`WAIT_PREFIX`
        when a same-prefix prefill is in flight (queue neighbours may be
        admitted past this request). Raises ValueError for requests that
        can never fit."""
        self.validate_prompt(req.prompt_len)
        L = req.prompt_len
        need_total = self.pages_needed(L, req.max_gen)
        free_slots = [s for s in self.slots if s.free]
        if not free_slots:
            return None
        max_match = (L - 1) // self.page_size
        chain = (self.radix.match(req.prompt, max_match)
                 if self.radix is not None else [])
        if self.radix is not None and max_match > len(chain) \
                and self._pending_keys:
            # defer only if some in-flight prefill covers MORE of this
            # prompt than the radix already does: admitting now would
            # re-prefill pages that request is about to cache. Keyed on
            # the full matched extent (not just the first page), so a
            # request that merely shares a page-one prefix — or whose
            # chain already covers the overlap — admits immediately.
            mine = self._page_keys(req.prompt, max_match)
            for pend in self._pending_keys:
                common = 0
                for a, b in zip(mine, pend):
                    if a != b:
                        break
                    common += 1
                if common > len(chain):
                    return WAIT_PREFIX

        def local_hits(part: int) -> int:
            return sum(part in nd.pages for nd in chain)

        slot = max(free_slots,
                   key=lambda s: (local_hits(self.partition_of_slot(
                       s.index)), -s.index))
        part = self.partition_of_slot(slot.index)
        grp = self.pool.group_of(part)
        # sharing stops at the first prefix page with no usable source: a
        # page serves this slot if it is cached locally or copyable from
        # a same-group partition — other groups' stage replicas never
        # wrote its bytes, so their registrations are unreadable here.
        usable = []
        for nd in chain:
            if part in nd.pages or any(
                    self.pool.group_of(p2) == grp for p2 in nd.pages):
                usable.append(nd)
            else:
                break
        chain = usable

        # 1) ref the locally-cached prefix pages first: a live reference
        #    pins them against the eviction pass below.
        held: list[int] = []
        local_pages: list[int | None] = []
        for nd in chain:
            gid = nd.pages.get(part)
            if gid is not None:
                self.pool.ref(gid)
                held.append(gid)
            local_pages.append(gid)
        n_copies = sum(g is None for g in local_pages)
        n_fresh = (need_total - len(chain)) + n_copies

        def rollback():
            for gid in held:
                self.pool.unref(gid)

        if need_total > self.pool.n_loc:
            rollback()
            raise ValueError(
                f"request needs {need_total} pages "
                f"(prompt {L} + max_gen {req.max_gen} at page_size "
                f"{self.page_size}) but a partition holds only "
                f"{self.pool.n_loc} — raise max_pages or shrink the "
                "request")
        short = n_fresh - self.pool.free_in(part)
        if short > 0:
            if self.radix is not None:
                self.radix.evict(part, short)
            if n_fresh > self.pool.free_in(part):
                rollback()
                return None  # page pressure: stay queued
        fresh = self.pool.alloc(part, n_fresh)
        assert fresh is not None
        held.extend(fresh)
        fresh_iter = iter(fresh)

        # 2) cross-partition prefix hits: a local page + a device copy
        #    instead of a recompute; register the copy so the next
        #    request in this partition shares it for free. The SOURCE is
        #    ref-pinned until the engine has executed the copy: a later
        #    admission landing in the source's partition could otherwise
        #    evict a trie-only source and re-allocate it as a fresh page
        #    — fresh pages are zeroed before any copy runs, so the copy
        #    (and, through the registered destination, every future
        #    sharer) would silently read zeros.
        copies: list[tuple[int, int]] = []
        src_refs: list[int] = []
        for i, nd in enumerate(chain):
            if local_pages[i] is None:
                src = nd.pages[min(p2 for p2 in nd.pages
                                   if self.pool.group_of(p2) == grp)]
                self.pool.ref(src)
                src_refs.append(src)
                dst = next(fresh_iter)
                copies.append((src, dst))
                self.radix.register(nd, part, dst)
                local_pages[i] = dst

        table = np.zeros(self.pages_per_req, np.int32)
        pages = list(local_pages)
        for j in range(len(chain), need_total):
            pages.append(next(fresh_iter))
        for j, gid in enumerate(pages):
            table[j] = self.pool.local_id(gid)

        start_pos = len(chain) * self.page_size
        n_prompt_pages = L // self.page_size
        pending = None
        if self.radix is not None and n_prompt_pages > len(chain):
            pending = self._page_keys(req.prompt, n_prompt_pages)
            self._pending_keys.add(pending)
        if chain:
            self.prefix_hits += 1
            self.prefix_hit_tokens += start_pos

        slot.request_id = req.id
        slot.pos = 0
        # ``pages`` is page-index ordered (the radix insert reads
        # ``pages[i]`` for prompt page i); it covers the same one-ref-each
        # set as ``held``: locally-shared refs plus every fresh alloc.
        slot.alloc = PageAllocation(
            start_pos=start_pos, table=table, pages=pages, fresh=fresh,
            copies=copies, src_refs=src_refs, n_shared=len(chain),
            n_prompt_pages=n_prompt_pages, pending_key=pending)
        return slot

    def copies_done(self, index: int) -> None:
        """The engine executed slot ``index``'s page copies: drop the
        admission-time pins on the copy sources (from here on they live
        through the radix / their other-partition holders)."""
        al = self.slots[index].alloc
        if al is None:
            return
        for gid in al.src_refs:
            self.pool.unref(gid)
        al.src_refs = []

    def note_prefilled(self, index: int, prompt: np.ndarray) -> None:
        """The request in slot ``index`` finished its prefill: its fully-
        prompt-covered pages become shareable (radix insert) and any
        co-admission hold on its prefix key is lifted."""
        s = self.slots[index]
        al = s.alloc
        if al is None:
            return
        if self.radix is not None and al.n_prompt_pages > al.n_shared:
            part = self.partition_of_slot(index)
            self.radix.insert(prompt, al.n_prompt_pages, part,
                              al.pages, skip=al.n_shared)
        self._pending_keys.discard(al.pending_key)
        al.pending_key = None

    # ---- reporting --------------------------------------------------- #
    @property
    def pages_in_use(self) -> int:
        return self.pool.pages_in_use

    @property
    def evictions(self) -> int:
        return self.radix.evictions if self.radix is not None else 0
