"""Cross-request KV reuse: a page-granularity prefix cache.

Counterpart of ``deeplearning4j_tpu/serving/prefix_cache.py``, the same
host-side index (it never touches device memory) without the telemetry
counters and flight-recorder events of the JAX package.

Real serving traffic is dominated by SHARED PREFIXES — one system
prompt in front of millions of user turns, few-shot preambles,
multi-turn conversations replaying their own history — yet a plain
engine re-prefills every one of those tokens from position 0. The
prefill work is exactly the memory-bound K/V materialization the paged
cache exists to avoid repeating, so this module indexes the pool's
COMMITTED pages by the tokens that produced them:

- **Key = chained page hash.** A full page (``page_size`` token ids)
  hashes together with its PARENT page's digest
  (``blake2b(parent_digest || token_bytes)``), so a digest names an
  entire prefix ``[0, (depth+1)*page_size)`` — equal digests mean
  equal full prefixes, and the digest chain IS a radix tree over
  prompts with page-sized edges. Nodes store their token ids, so a
  hash collision is detected (token compare) rather than served.
- **Sharing is refcounted, never copied.** A lookup hit maps the
  cached pages straight into the new slot's page table and bumps their
  refcount (``PagePool.share``) — N slots attend through the SAME
  device pages. Cached-only pages sit at refcount 1 (the cache's own
  reference).
- **Copy-on-write on mid-page divergence.** When a prompt agrees with
  a cached child page for ``m`` of its ``page_size`` tokens and then
  diverges, the hit still covers those ``m`` positions: the engine
  copies THAT ONE page (``kv_pages.copy_page``) into a private page,
  maps the copy, and prefills only from the divergence point. Causal
  attention makes the first ``m`` positions' K/V depend only on the
  agreed tokens, so the copied prefix is exact.
- **LRU leaf eviction, readers protected.** Under page pressure the
  admission path evicts least-recently-used LEAF nodes whose page has
  no reader besides the cache (refcount 1). A page mapped into a live
  slot (refcount > 1) is never reclaimed; evicting leaves first keeps
  every remaining node's chain intact.

The cache is HOST-side bookkeeping only: it never touches device
memory itself (the engine dispatches the copy/prefill programs) and is
guarded by one lock — the scheduler thread mutates it, while
``submit()`` reads a hit hint for the page-budget check.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


#: parent digest of depth-0 pages (the radix root)
_ROOT = b"root"


def page_digest(parent: bytes, tokens: np.ndarray) -> bytes:
    """Chained rolling hash of one full page: digest of the parent
    prefix folded with this page's token ids. Equal digests name equal
    full prefixes (verified by token compare on hit)."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


class _Node:
    __slots__ = ("digest", "parent", "depth", "page", "tokens", "tick")

    def __init__(self, digest: bytes, parent: bytes, depth: int,
                 page: int, tokens: np.ndarray, tick: int):
        self.digest = digest
        self.parent = parent
        self.depth = depth          # page index within the prefix
        self.page = page
        self.tokens = tokens        # the page_size token ids (host copy)
        self.tick = tick            # LRU clock


class PrefixHit:
    """One lookup result. ``pages`` are the matched FULL pages in
    position order; ``cow_src``/``cow_tokens`` describe a mid-page
    partial match (copy that page, keep its first ``cow_tokens``
    positions). ``tokens`` is the total reusable position count. All
    referenced pages have been ref'd for the caller (``release`` undoes
    that if admission fails)."""

    def __init__(self, pages: List[int], cow_src: Optional[int],
                 cow_tokens: int, page_size: int):
        self.pages = pages
        self.cow_src = cow_src
        self.cow_tokens = int(cow_tokens)
        self.tokens = len(pages) * page_size + self.cow_tokens

    def release(self, pool) -> None:
        held = list(self.pages)
        if self.cow_src is not None:
            held.append(self.cow_src)
        if held:
            pool.free(held)


class PrefixCache:
    """Radix/hash index over committed prompt pages (module doc)."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._nodes: Dict[bytes, _Node] = {}
        #: parent digest -> child digests (radix fan-out)
        self._children: Dict[bytes, Set[bytes]] = {}
        self._lock = threading.Lock()
        self._tick = itertools.count()
        self.hits = 0
        self.misses = 0
        self.hit_tokens_total = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------ stats
    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "cached_pages": len(self._nodes),
                "hits": self.hits,
                "misses": self.misses,
                "hit_tokens_total": self.hit_tokens_total,
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages,
            }

    # ----------------------------------------------------------- lookup
    def _walk(self, prompt: np.ndarray) -> Tuple[List[_Node], bytes]:
        """Longest chain of cached FULL pages matching ``prompt``.
        Returns (matched nodes in order, digest of the matched prefix).
        Caller holds the lock."""
        ps = self.page_size
        matched: List[_Node] = []
        parent = _ROOT
        for d in range(int(prompt.size) // ps):
            seg = prompt[d * ps:(d + 1) * ps]
            dig = page_digest(parent, seg)
            node = self._nodes.get(dig)
            if node is None or not np.array_equal(node.tokens, seg):
                break               # miss, or a detected hash collision
            matched.append(node)
            parent = dig
        return matched, parent

    def hit_tokens_hint(self, prompt: np.ndarray) -> int:
        """Read-only count of currently-reusable FULL-page tokens —
        the submit()-time page-budget hint. Takes no references and
        moves no LRU clocks; admission re-resolves."""
        prompt = np.asarray(prompt, np.int32)
        with self._lock:
            matched, _ = self._walk(prompt)
        return len(matched) * self.page_size

    def lookup_acquire(self, prompt: np.ndarray, pool) -> PrefixHit:
        """Resolve the longest cached prefix of ``prompt`` and take one
        reference per matched page (full pages AND the mid-page
        copy-on-write source, if any) so eviction cannot reclaim them
        before the engine maps/copies them. The hit is capped at
        ``len(prompt) - 1`` tokens — the engine must still compute the
        last prompt position's logits to sample the first token."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        t0 = int(prompt.size)
        with self._lock:
            matched, parent = self._walk(prompt)
            # cap: leave >= 1 prompt token for the suffix prefill
            max_full = (t0 - 1) // ps
            matched = matched[:max_full]
            parent = matched[-1].digest if matched else _ROOT
            full_tokens = len(matched) * ps
            # mid-page divergence: does any child of the matched prefix
            # agree with the NEXT prompt tokens for m >= 1 positions?
            cow_node, cow_m = None, 0
            rest = prompt[full_tokens:min(t0 - 1, full_tokens + ps)]
            if rest.size:
                for child_dig in self._children.get(parent, ()):
                    child = self._nodes.get(child_dig)
                    if child is None:
                        continue
                    m = int(np.argmin(np.concatenate(
                        [np.equal(child.tokens[:rest.size], rest),
                         [False]])))
                    if m > cow_m:
                        cow_node, cow_m = child, m
            tick = next(self._tick)
            for n in matched:
                n.tick = tick
            if cow_node is not None:
                cow_node.tick = tick
            pages = [n.page for n in matched]
            held = pages + ([cow_node.page] if cow_node else [])
            if held:
                pool.share(held)
            hit = PrefixHit(pages,
                            cow_node.page if cow_node else None,
                            cow_m, ps)
        return hit

    def record_session(self, hit_tokens: int) -> None:
        """Count a sticky-session resume in the cache's own hit
        totals, so ``prefix_stats()`` describes ALL cross-request
        reuse."""
        with self._lock:
            self.hits += 1
            self.hit_tokens_total += int(hit_tokens)

    def record(self, hit: PrefixHit) -> None:
        """Count one ADMITTED lookup (the engine calls this once per
        admission, not per head-of-line retry, so the hit/miss
        counters measure served traffic)."""
        with self._lock:
            if hit.tokens:
                self.hits += 1
                self.hit_tokens_total += hit.tokens
            else:
                self.misses += 1

    # ----------------------------------------------------------- insert
    def insert(self, prompt: np.ndarray, table_pages: List[int],
               pool) -> int:
        """Index every FULL page of ``prompt`` (``table_pages[d]``
        holds positions ``[d*ps, (d+1)*ps)``). Already-cached depths
        are skipped; new nodes take one cache reference on their page.
        Returns the number of pages newly inserted."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        added = 0
        with self._lock:
            parent = _ROOT
            tick = next(self._tick)
            for d in range(int(prompt.size) // ps):
                seg = prompt[d * ps:(d + 1) * ps]
                dig = page_digest(parent, seg)
                node = self._nodes.get(dig)
                if node is None or not np.array_equal(node.tokens, seg):
                    if node is not None:
                        # hash collision: keep the resident entry
                        break
                    if d >= len(table_pages):
                        break
                    node = _Node(dig, parent, d, int(table_pages[d]),
                                 seg.copy(), tick)
                    pool.share([node.page])
                    self._nodes[dig] = node
                    self._children.setdefault(parent, set()).add(dig)
                    added += 1
                else:
                    node.tick = tick
                parent = dig
            self.inserted_pages += added
        return added

    # --------------------------------------------------------- eviction
    def evict(self, pool, n_pages: int) -> int:
        """Free up to ``n_pages`` cached pages: least-recently-used
        LEAF nodes first, and ONLY pages whose sole reference is the
        cache's own (refcount 1) — a page mapped by a live slot or
        pinned by a session is never reclaimed. Returns pages freed."""
        freed = 0
        with self._lock:
            # one LRU sort per PASS, evicting every eligible leaf it
            # meets; a further pass only runs when an eviction turned
            # a parent into a fresh leaf (sorting the whole index per
            # freed page would stall the scheduler between bursts)
            while freed < n_pages:
                progress = False
                for node in sorted(self._nodes.values(),
                                   key=lambda n: n.tick):
                    if freed >= n_pages:
                        break
                    if self._children.get(node.digest):
                        continue            # not a leaf
                    if pool.refcount(node.page) != 1:
                        continue            # live readers
                    self._drop(node, pool)
                    freed += 1
                    self.evicted_pages += 1
                    progress = True
                if not progress:
                    break
        return freed

    def _drop(self, node: _Node, pool) -> None:
        """Remove one node and release the cache's page reference.
        Caller holds the lock."""
        del self._nodes[node.digest]
        sibs = self._children.get(node.parent)
        if sibs is not None:
            sibs.discard(node.digest)
            if not sibs:
                del self._children[node.parent]
        self._children.pop(node.digest, None)
        pool.free([node.page])

    def clear(self, pool) -> int:
        """Drop every node and release every cache reference (engine
        shutdown — the drain contract: with no slots and no sessions
        left, the pool returns to fully free)."""
        with self._lock:
            nodes = list(self._nodes.values())
            self._nodes.clear()
            self._children.clear()
            if nodes:
                pool.free([n.page for n in nodes])
        return len(nodes)


__all__ = ["PrefixCache", "PrefixHit", "page_digest"]
