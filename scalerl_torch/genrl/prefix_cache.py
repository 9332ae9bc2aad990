"""Shared-prefix KV cache over the paged pool (page granularity).

A copy of ``scalerl_tpu/genrl/prefix_cache.py`` over the port's paging and
telemetry modules.

Sequence RL's dominant workload is *group sampling*: n completions per
prompt (the GRPO shape), where (n-1)/n of all prefill FLOPs recompute an
identical prefix — and across rounds the same prompts come back.  Because
the KV cache is block-paged, a computed prefix is reusable as a *page
chain*: a full page of prompt K/V is immutable once written (decode writes
land strictly after the prompt), so any later sequence with the same token
prefix can map the SAME physical pages into its table — sharing is purely
a page-table fact, the attention kernels never know.

:class:`PrefixCache` is the host-side index of those chains:

- **keyed by rolling hash of prompt-token blocks** — node key =
  ``crc32(block_tokens, parent_key)``, so a chain's k-th key commits to
  the whole k-page prefix; stored block bytes are compared on lookup, so
  a hash collision degrades to a miss, never to wrong tokens;
- **refcount-aware LRU eviction** — the cache holds one
  :meth:`~scalerl_torch.genrl.paging.PageAllocator.share` ref per cached
  page; only *leaf* nodes whose page has no other holder (refcount 1 =
  cache-only, no live lane) are evictable, oldest-use first.  Eviction
  runs on demand through the allocator's reclaim hook, so cached chains
  never backpressure admission;
- **flushed on every param push** — cached K/V was computed under the
  generation that wrote it; reusing it under fresh params would break the
  temperature-0 token-identity contract, so a ``push_params`` drops the
  whole index (live lanes keep their shared pages until harvest via their
  own refs).

Telemetry: ``genrl.prefix_hits`` / ``prefix_misses`` (per lookup),
``genrl.prefix_evictions`` (nodes dropped by LRU reclaim or flush), and
``genrl.pages_shared`` (every CoW share taken on behalf of a lane).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np

from scalerl_torch.genrl.paging import PageAllocator
from scalerl_torch.runtime import telemetry

# holder label the cache registers on every page it keeps alive
CACHE_HOLDER = "prefix-cache"

_ROOT_KEY = 0x9E3779B9  # chain root sentinel (any fixed nonzero seed)


class _Node:
    """One cached full-page block: ``page`` holds the K/V of ``block``
    (page_size tokens) whose chain prefix hashes to ``parent``."""

    __slots__ = ("key", "parent", "page", "block", "children", "last_use")

    def __init__(
        self, key: int, parent: int, page: int, block: bytes, tick: int
    ) -> None:
        self.key = key
        self.parent = parent
        self.page = page
        self.block = block
        self.children = 0
        self.last_use = tick


class PrefixCache:
    """Page-granularity prompt-prefix index over a :class:`PageAllocator`.

    Single-threaded by design (driven from the continuous engine's one
    host loop).  ``lookup`` never hands out a page without the caller
    immediately taking its own ``share`` ref — the engine does both under
    one admission pass, so reclaim (which only fires inside ``alloc``)
    can never race a matched-but-unshared chain.
    """

    def __init__(self, allocator: PageAllocator, page_size: int) -> None:
        self.allocator = allocator
        self.page_size = page_size
        self._nodes: Dict[int, _Node] = {}
        self._tick = 0
        reg = telemetry.get_registry()
        self._hits = reg.counter("genrl.prefix_hits")
        self._misses = reg.counter("genrl.prefix_misses")
        self._evictions = reg.counter("genrl.prefix_evictions")

    # -- hashing -------------------------------------------------------
    @staticmethod
    def _block_key(parent: int, block: bytes) -> int:
        # rolling hash: fold the parent chain key into this block's crc so
        # equal blocks under different prefixes never collide by design
        return zlib.crc32(block, parent & 0xFFFFFFFF)

    # -- the read path -------------------------------------------------
    def lookup(self, tokens: np.ndarray, max_tokens: int) -> List[int]:
        """Longest cached chain of FULL pages covering
        ``tokens[:max_tokens]``; returns the backing page ids in chain
        order.  Callers pass ``max_tokens = prompt_len - 1`` so the
        uncached tail always has at least one token — the tail prefill is
        what produces the lane's first decode logits.
        """
        ps = self.page_size
        pages: List[int] = []
        parent = _ROOT_KEY
        n_blocks = max(min(len(tokens), max_tokens), 0) // ps
        arr = np.asarray(tokens, np.int32)
        for b in range(n_blocks):
            block = arr[b * ps : (b + 1) * ps].tobytes()
            key = self._block_key(parent, block)
            node = self._nodes.get(key)
            if node is None or node.block != block:
                break
            self._tick += 1
            node.last_use = self._tick
            pages.append(node.page)
            parent = key
        if pages:
            self._hits.inc()
        else:
            self._misses.inc()
        return pages

    # -- the write path ------------------------------------------------
    def insert(self, tokens: np.ndarray, n_tokens: int, pages: List[int]) -> int:
        """Register the chain of full-page blocks of ``tokens[:n_tokens]``
        backed by ``pages`` (the admitting lane's table prefix, in order).
        Each newly-registered page gains one cache-held ref; blocks
        already cached keep their existing backing page (the lane's
        recomputed twin stays lane-private).  Returns pages newly cached.
        """
        ps = self.page_size
        parent = _ROOT_KEY
        added = 0
        arr = np.asarray(tokens, np.int32)
        for b in range(min(n_tokens // ps, len(pages))):
            block = arr[b * ps : (b + 1) * ps].tobytes()
            key = self._block_key(parent, block)
            node = self._nodes.get(key)
            if node is not None:
                if node.block != block:
                    break  # hash collision with a live chain: stop here
                self._tick += 1
                node.last_use = self._tick
                parent = key
                continue
            self.allocator.share([pages[b]], holder=CACHE_HOLDER)
            self._tick += 1
            node = _Node(key, parent, pages[b], block, self._tick)
            self._nodes[key] = node
            pnode = self._nodes.get(parent)
            if pnode is not None:
                pnode.children += 1
            added += 1
            parent = key
        return added

    # -- eviction ------------------------------------------------------
    def _evictable(self, node: _Node) -> bool:
        # leaf-only + cache-only: an interior node keeps its children's
        # chain prefix valid, and a refcount > 1 page is mapped into a
        # live lane's table right now
        return node.children == 0 and self.allocator.refcount(node.page) == 1

    def evict(self, n_pages: int) -> int:
        """LRU-evict up to ``n_pages`` cache-only chain leaves back to the
        free list (the allocator's reclaim hook).  Chains referenced by
        live lanes are never touched."""
        freed = 0
        while freed < n_pages:
            victim: Optional[_Node] = None
            for node in self._nodes.values():
                if self._evictable(node) and (
                    victim is None or node.last_use < victim.last_use
                ):
                    victim = node
            if victim is None:
                break
            self._drop(victim)
            freed += 1
        return freed

    def _drop(self, node: _Node) -> None:
        self.allocator.free([node.page], holder=CACHE_HOLDER)
        del self._nodes[node.key]
        pnode = self._nodes.get(node.parent)
        if pnode is not None:
            pnode.children -= 1
        self._evictions.inc()

    def flush(self) -> int:
        """Invalidate the whole index (param push: cached K/V belongs to
        the old generation).  The cache's refs drop immediately; pages
        still mapped by live lanes stay alive until those lanes free."""
        dropped = len(self._nodes)
        for node in self._nodes.values():
            self.allocator.free([node.page], holder=CACHE_HOLDER)
        self._nodes.clear()
        if dropped:
            self._evictions.inc(dropped)
        return dropped

    # -- telemetry -----------------------------------------------------
    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    @property
    def hits(self) -> int:
        return int(self._hits.value)

    @property
    def misses(self) -> int:
        return int(self._misses.value)

    def stats(self) -> Dict[str, int]:
        return {
            "cached_pages": len(self._nodes),
            "hits": int(self._hits.value),
            "misses": int(self._misses.value),
            "evictions": int(self._evictions.value),
        }
