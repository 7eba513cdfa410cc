"""RadixIndex: token-prefix trie mapping prefixes to shared page chains.

Each trie node is exactly one *full* page of ``page_size`` tokens, keyed
by its token tuple; a root-to-node path therefore spells out a prompt
prefix, and the node records where that prefix page's K/V bytes live —
per cache *partition* (the serve cache pages are sharded over the
pods×data axes, and a slot row can only gather pages local to its own
shard), so ``node.pages`` maps ``partition -> global page id``.

A prefix cached in one partition is still a hit for a request landing in
another: admission allocates a local page and schedules a device
page-copy (``Session.copy_pages``) instead of recomputing the prefill —
and registers the local copy here so the next request in that partition
shares it for free.

The trie holds one PagePool reference per registered (node, partition)
page; requests hold their own. A page whose only remaining reference is
the trie's is *evictable*: :meth:`evict` walks the partition leaf-first
(a node's page is never dropped while a descendant still caches that
partition — the chain must stay hole-free per partition) in LRU order of
``last_used``.

Copy-on-write divergence needs no machinery here: only *full* pages
wholly covered by a prompt are ever inserted, a request's own pages
(partial prompt tail + decoded tokens) stay private to it, and a match
is capped by the caller below the prompt's last token — so shared pages
are read-only by construction and divergence simply means the walk stops
at the longest common full-page prefix.
"""

from __future__ import annotations

import itertools

import numpy as np

from repro_torch.serving.paging import PagePool

_clock = itertools.count(1)


class RadixNode:
    """One full page of tokens; pages[partition] -> global page id."""

    __slots__ = ("key", "parent", "children", "pages", "last_used")

    def __init__(self, key: tuple, parent: "RadixNode | None"):
        self.key = key
        self.parent = parent
        self.children: dict[tuple, RadixNode] = {}
        self.pages: dict[int, int] = {}
        self.last_used = next(_clock)

    def touch(self) -> None:
        self.last_used = next(_clock)


class RadixIndex:
    """Prefix trie over full pages, with per-partition LRU eviction."""

    def __init__(self, page_size: int, pool: PagePool):
        self.page_size = page_size
        self.pool = pool
        self.root = RadixNode((), None)
        self.evictions = 0

    # ------------------------------------------------------------------ #
    def _key(self, prompt: np.ndarray, i: int) -> tuple:
        ps = self.page_size
        return tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])

    def match(self, prompt: np.ndarray, max_pages: int) -> list[RadixNode]:
        """Longest cached full-page prefix of ``prompt``, at most
        ``max_pages`` nodes. Stops at the first node whose page bytes are
        gone from every partition (evicted mid-chain elsewhere leaves a
        structural node with no content — unusable from there on)."""
        out: list[RadixNode] = []
        node = self.root
        for i in range(max_pages):
            child = node.children.get(self._key(prompt, i))
            if child is None or not child.pages:
                break
            child.touch()
            out.append(child)
            node = child
        return out

    def register(self, node: RadixNode, partition: int, page: int) -> bool:
        """Record ``page`` as ``node``'s bytes in ``partition`` (no-op if
        that partition is already cached); takes the trie's pool ref."""
        if partition in node.pages:
            return False
        self.pool.ref(page)
        node.pages[partition] = page
        node.touch()
        return True

    def insert(self, prompt: np.ndarray, n_pages: int, partition: int,
               pages: list[int], skip: int = 0) -> int:
        """Walk/create nodes for prompt pages ``[skip, n_pages)`` and
        register ``pages[i]`` for each; returns how many were newly
        registered. ``skip`` covers pages the request already shared."""
        node = self.root
        new = 0
        for i in range(n_pages):
            key = self._key(prompt, i)
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, node)
                node.children[key] = child
            if i >= skip:
                new += self.register(child, partition, pages[i])
            else:
                child.touch()
            node = child
        return new

    # ------------------------------------------------------------------ #
    def _evictable(self, partition: int) -> list[RadixNode]:
        """Nodes whose ``partition`` page may be dropped *now*: the trie
        holds the only reference and no descendant caches that partition
        (leaf-first keeps every partition's chain hole-free)."""
        out = []

        def walk(node: RadixNode) -> bool:
            """Returns True if the subtree holds any ``partition`` page."""
            below = False
            for ch in node.children.values():
                below |= walk(ch)
            gid = node.pages.get(partition)
            if gid is None:
                return below
            if not below and self.pool.refcount(gid) == 1:
                out.append(node)
            return True

        for ch in self.root.children.values():
            walk(ch)
        return out

    def _drop(self, node: RadixNode, partition: int) -> None:
        gid = node.pages.pop(partition)
        self.pool.unref(gid)
        self.evictions += 1
        while node is not None and node.parent is not None \
                and not node.pages and not node.children:
            node.parent.children.pop(node.key, None)
            node = node.parent

    def evict(self, partition: int, need: int) -> int:
        """Free at least ``need`` pages in ``partition`` (LRU leaf-first);
        returns how many were actually freed."""
        freed = 0
        while freed < need:
            cands = self._evictable(partition)
            if not cands:
                break
            victim = min(cands, key=lambda n: n.last_used)
            self._drop(victim, partition)
            freed += 1
        return freed

    # ------------------------------------------------------------------ #
    @property
    def n_nodes(self) -> int:
        def count(node):
            return 1 + sum(count(c) for c in node.children.values())
        return count(self.root) - 1
