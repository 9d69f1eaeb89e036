"""Paged KV cache: fixed-size page pool + per-slot page tables.

Counterpart of ``deeplearning4j_tpu/serving/kv_pages.py``, float pools
only (the fp8 pools with scale planes are not ported yet).

- The KV tree is ``{"k", "v"}``, pools of shape
  ``[L, n_pages, H, page_size, hd]`` allocated once on the engine's
  device. Page 0 is the NULL page: it absorbs the writes of inactive
  slots and of the padded tail of a prefill commit, and is never read
  through a valid attention position.
- Row ``j`` of a slot's page table names the page holding absolute
  positions ``[j * page_size, (j + 1) * page_size)``; unallocated tail
  entries point at the null page and are masked by the position check.
- :class:`PagePool` is the host-side allocator: free list, reference
  counts, validation of every free.

Where the JAX package threads the pools functionally through its jitted
programs and donates the old buffers, the port updates them IN PLACE
(``index_put_`` through advanced-index assignment): the tree's tensors
are the pool for the engine's whole life. :func:`commit_prefill` and
:func:`append_token` still return the tree, so call sites read like the
JAX ones.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence

import torch


class PagePool:
    """Host-side refcounting page allocator over the device-resident
    K/V pools.

    ``n_pages`` INCLUDES the reserved null page 0, so the usable
    capacity is ``n_pages - 1`` pages. ``alloc`` returns None when the
    request cannot be satisfied — the scheduler keeps the request
    queued (head-of-line) until eviction frees pages. The free list and
    the reference counts are guarded by a lock.
    """

    def __init__(self, n_layers: int, n_heads: int, page_size: int,
                 head_dim: int, n_pages: int,
                 dtype: torch.dtype = torch.bfloat16, device="cpu"):
        if page_size < 1 or n_pages < 2:
            raise ValueError(
                f"need page_size >= 1 and n_pages >= 2 (one null page "
                f"+ one usable), got {page_size}/{n_pages}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"float32 or bfloat16 pools only, got {dtype}")
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        shape = (n_layers, n_pages, n_heads, page_size, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        # LIFO free list: recently freed pages are re-used first
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        #: page -> live reference count; absent means the page is free
        self._refs: Dict[int, int] = {}
        self._high_water = 0
        self._lock = threading.Lock()

    def tree(self) -> Dict[str, torch.Tensor]:
        return {"k": self.k, "v": self.v}

    # ------------------------------------------------------- accounting
    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def allocated(self) -> int:
        return self.capacity - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def high_water(self) -> int:
        return self._high_water

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 when free)."""
        with self._lock:
            return self._refs.get(int(page), 0)

    def shared_pages(self) -> int:
        """Pages with more than one reader."""
        with self._lock:
            return sum(1 for r in self._refs.values() if r > 1)

    def bytes_per_page(self) -> int:
        # k + v, all layers, one page
        return 2 * (self.k.numel() // self.n_pages) * self.k.element_size()

    # ------------------------------------------------------- allocation
    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages at refcount 1 each, or None if the pool can't
        satisfy it (caller keeps the request queued)."""
        with self._lock:
            if n > len(self._free):
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            self._high_water = max(self._high_water, self.allocated)
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one reference per listed page (a page listed twice gains
        two). Sharing a free page is a use-after-free and raises."""
        with self._lock:
            for p in pages:
                self._check_range(p)
                if int(p) not in self._refs:
                    raise ValueError(
                        f"cannot share free page {int(p)} (not "
                        "currently allocated)")
            for p in pages:
                self._refs[int(p)] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per listed page; a page whose last
        reference drops returns to the free list.

        The whole call is validated BEFORE any mutation: out-of-range
        or null-page indices, frees of already-free pages, and
        duplicates within one call that exceed the page's live count
        all raise with the free list untouched."""
        with self._lock:
            demand = collections.Counter()
            for p in pages:
                self._check_range(p)
                demand[int(p)] += 1
            for p, n in demand.items():
                have = self._refs.get(p, 0)
                if have == 0:
                    raise ValueError(f"double free of page {p} "
                                     "(already on the free list)")
                if n > have:
                    raise ValueError(
                        f"over-free of page {p}: {n} frees in one call "
                        f"but only {have} live reference(s)")
            for p, n in demand.items():
                left = self._refs[p] - n
                if left == 0:
                    del self._refs[p]
                    self._free.append(p)
                else:
                    self._refs[p] = left

    def _check_range(self, p) -> None:
        if not isinstance(p, int) and not hasattr(p, "__index__"):
            raise ValueError(f"page index {p!r} is not an integer")
        p = int(p)
        if not 0 < p < self.n_pages:
            raise ValueError(f"page {p} outside pool (null page 0 "
                             "is never allocated or freed)")


# ------------------------------------------------------ in-place writes
def commit_prefill(kv, ks, vs, page_row, page_size: int):
    """Scatter one prompt's prefill K/V into its pages, in place.

    ``ks``/``vs``: ``[L, 1, H, B, hd]`` from the parallel-prefill
    forward over the padded prompt (bucket width ``B``, a multiple of
    ``page_size``). ``page_row``: ``[B // page_size]`` page ids — real
    pages for chunks the slot owns, null page 0 for the padded tail
    (what lands there is never read)."""
    L, _, H, B, hd = ks.shape
    pb = B // page_size
    page_row = torch.as_tensor(page_row, dtype=torch.long,
                               device=kv["k"].device)
    for name, x in (("k", ks), ("v", vs)):
        pages = x[:, 0].reshape(L, H, pb, page_size, hd).transpose(1, 2)
        kv[name][:, page_row] = pages.to(kv[name].dtype)
    return kv


def append_token(kv, layer: int, page_idx, offset, k, v):
    """Write one DECODE position's K/V per lane, in place: lane ``s``
    lands at ``(layer, page_idx[s], :, offset[s])``. Inactive slots'
    ``page_idx`` must already point at the null page."""
    kv["k"][layer, page_idx, :, offset] = k.to(kv["k"].dtype)
    kv["v"][layer, page_idx, :, offset] = v.to(kv["v"].dtype)
    return kv


def pages_needed(total_positions: int, page_size: int) -> int:
    return -(-int(total_positions) // int(page_size))


__all__ = ["PagePool", "commit_prefill", "append_token", "pages_needed"]
