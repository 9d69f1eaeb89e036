"""Paged KV cache: fixed-size page pool + per-slot page tables.

Counterpart of ``deeplearning4j_tpu/serving/kv_pages.py`` (all of it
but the fleet's ``handoff_commit``).

- The KV tree is ``{"k", "v"}``, pools of shape
  ``[L, n_pages, H, page_size, hd]`` allocated once on the engine's
  device, plus, when the pool is fp8 (``kv_dtype="fp8_e4m3"``),
  ``"k_scale"``/``"v_scale"`` planes ``[L, n_pages, H]`` of f32
  per-page-per-head scales. Page 0 is the NULL page: it absorbs the
  writes of inactive slots and of the padded tail of a prefill commit,
  and is never read through a valid attention position.
- Row ``j`` of a slot's page table names the page holding absolute
  positions ``[j * page_size, (j + 1) * page_size)``; unallocated tail
  entries point at the null page and are masked by the position check.
- :class:`PagePool` is the host-side allocator: free list, reference
  counts (a page may be mapped read-only into several slots' tables by
  the prefix cache and sticky sessions), validation of every free.

fp8 scales follow a page's life: minted at commit from the exact
absmax over the page's REAL positions, frozen once the page holds
entries (a decode append mints only at offset 0, so earlier entries are
never re-scaled under their feet; later outliers clip at ±448), carried
by :func:`copy_page`, and reclaimed with the page. Scale planes start
at ones, so the zero-filled pools dequantize to zero.

Where the JAX package threads the pools functionally through its jitted
programs and donates the old buffers, the port updates them IN PLACE:
the tree's tensors are the pool for the engine's whole life. The write
functions still return the tree, so call sites read like the JAX ones.
fp8 pools are gathered and scattered through ``uint8`` views of the
same storage, since not every indexing op has a ``float8_e4m3fn``
kernel; the bytes are the same either way.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn import precision


class PagePool:
    """Host-side refcounting page allocator over the device-resident
    K/V pools.

    ``n_pages`` INCLUDES the reserved null page 0, so the usable
    capacity is ``n_pages - 1`` pages. ``alloc`` returns None when the
    request cannot be satisfied — the scheduler keeps the request
    queued (head-of-line) until eviction frees pages. ``dtype`` is the
    engine's compute dtype; ``kv_dtype="fp8_e4m3"`` stores the pages as
    ``float8_e4m3fn`` with f32 scale planes beside them. The free list
    and the reference counts are guarded by a lock.
    """

    def __init__(self, n_layers: int, n_heads: int, page_size: int,
                 head_dim: int, n_pages: int,
                 dtype: torch.dtype = torch.bfloat16, device="cpu",
                 kv_dtype: Optional[str] = None):
        if page_size < 1 or n_pages < 2:
            raise ValueError(
                f"need page_size >= 1 and n_pages >= 2 (one null page "
                f"+ one usable), got {page_size}/{n_pages}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"float32 or bfloat16 pools only, got {dtype}")
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.kv_dtype = precision.resolve_kv_dtype(kv_dtype)
        #: the pool's storage format, as the JAX pool labels it
        self.dtype_label = self.kv_dtype or str(dtype).split(".")[-1]
        store = precision.fp8_kv_dtype() if self.kv_dtype else dtype
        shape = (n_layers, n_pages, n_heads, page_size, head_dim)
        self.k = torch.zeros(shape, dtype=store, device=device)
        self.v = torch.zeros(shape, dtype=store, device=device)
        self.k_scale = self.v_scale = None
        if self.kv_dtype:
            sshape = (n_layers, n_pages, n_heads)
            self.k_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=device)
            self.v_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=device)
        # LIFO free list: recently freed pages are re-used first
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        #: page -> live reference count; absent means the page is free
        self._refs: Dict[int, int] = {}
        self._high_water = 0
        self._lock = threading.Lock()

    def tree(self) -> Dict[str, torch.Tensor]:
        """``{"k", "v"}``, plus ``"k_scale"``/``"v_scale"`` when fp8."""
        kv = {"k": self.k, "v": self.v}
        if self.k_scale is not None:
            kv["k_scale"] = self.k_scale
            kv["v_scale"] = self.v_scale
        return kv

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
        # k + v (+ the scale planes), all layers, one page
        total = 2 * (self.k.numel() // self.n_pages) * self.k.element_size()
        if self.k_scale is not None:
            total += 2 * (self.k_scale.numel() // self.n_pages) \
                * self.k_scale.element_size()
        return total

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
def _is_fp8(kv) -> bool:
    return "k_scale" in kv


def _raw(x: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor's storage as bytes; any other tensor as it is."""
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def _segment_amax(x, seg, n_seg: int):
    """Per-segment max of ``x`` ``[B, ...]`` (>= 0) over ``seg`` ``[B]``:
    ``[n_seg, ...]``, 0 for empty segments. The JAX side's
    ``segment_max`` gives -inf there; both mint the floor scale from it
    and only segments with a real lane are ever used."""
    out = torch.zeros((n_seg,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    idx = seg.long().reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce(0, idx, x, "amax", include_self=True)


def _segment_any(flag, seg, n_seg: int):
    """Per-segment OR of the boolean ``flag`` ``[B]``."""
    hits = torch.zeros((n_seg,), dtype=torch.float32, device=flag.device)
    return hits.index_add_(0, seg.long(), flag.to(torch.float32)) > 0


def commit_prefill(kv, ks, vs, page_row, page_size: int, n_valid=None):
    """Scatter one prompt's prefill K/V into its pages, in place.

    ``ks``/``vs``: ``[L, 1, H, B, hd]`` from the parallel-prefill
    forward over the padded prompt (bucket width ``B``, a multiple of
    ``page_size``). ``page_row``: ``[B // page_size]`` page ids — real
    pages for chunks the slot owns, null page 0 for the padded tail
    (what lands there is never read).

    fp8 pools also mint each page's per-head scale from the exact
    absmax — over the real positions only when ``n_valid`` (the true
    prompt length) is given, so padded-tail garbage cannot inflate a
    page's scale — and write it beside the quantized page."""
    L, _, H, B, hd = ks.shape
    pb = B // page_size
    page_row = torch.as_tensor(page_row, dtype=torch.long,
                               device=kv["k"].device)
    ck, cv = (x[:, 0].reshape(L, H, pb, page_size, hd).transpose(1, 2)
              for x in (ks, vs))                  # [L, pb, H, ps, hd]
    if not _is_fp8(kv):
        kv["k"][:, page_row] = ck.to(kv["k"].dtype)
        kv["v"][:, page_row] = cv.to(kv["v"].dtype)
        return kv
    mask = None
    if n_valid is not None:
        flat = (torch.arange(pb, device=ck.device)[:, None] * page_size
                + torch.arange(page_size, device=ck.device)[None, :])
        mask = (flat < int(n_valid))[None, :, None, :, None]
    for name, c in (("k", ck), ("v", cv)):
        a = c.to(torch.float32).abs()
        if mask is not None:
            a = torch.where(mask, a, torch.zeros((), device=a.device))
        sc = precision.fp8_scale(a.amax(dim=(3, 4)))      # [L, pb, H]
        _raw(kv[name])[:, page_row] = _raw(
            precision.quantize_fp8(c, sc[..., None, None]))
        kv[name + "_scale"][:, page_row] = sc
    return kv


def append_token(kv, layer: int, page_idx, offset, k, v):
    """Write one DECODE position's K/V per lane, in place: lane ``s``
    lands at ``(layer, page_idx[s], :, offset[s])``. Inactive slots'
    ``page_idx`` must already point at the null page.

    fp8 scale rule (frozen at page start): a lane writing offset 0
    mints the page's scale from its own absmax; every later offset
    reuses the stored scale."""
    page_idx = page_idx.long()
    offset = offset.long()
    if not _is_fp8(kv):
        kv["k"][layer, page_idx, :, offset] = k.to(kv["k"].dtype)
        kv["v"][layer, page_idx, :, offset] = v.to(kv["v"].dtype)
        return kv
    fresh = (offset == 0)[:, None]
    for name, x in (("k", k), ("v", v)):
        scales = kv[name + "_scale"]
        xf = x.to(torch.float32)                          # [S, H, hd]
        cand = precision.fp8_scale(xf.abs().amax(dim=-1))  # [S, H]
        sc = torch.where(fresh, cand, scales[layer, page_idx])
        _raw(kv[name])[layer, page_idx, :, offset] = _raw(
            precision.quantize_fp8(xf, sc[..., None]))
        scales[layer, page_idx] = sc
    return kv


def append_suffix(kv, layer: int, page_idx, offset, k, v, *,
                  chunk=None, real=None, table=None):
    """Write a PREFIX-PREFILL suffix's K/V: one lane per suffix
    position (``[B]`` indices, ``[B, H, hd]`` values), consecutive
    positions, padded lanes pointing at the null page. The same as
    :func:`append_token` for float pools.

    fp8 pools need page-granular scales over lanes that SHARE pages:
    ``chunk`` (``[B]``, the lane's table row, or ``P`` for padded
    lanes), ``real`` (``[B]``, lane < true prompt length) and ``table``
    (``[P]``, the slot's page table) drive the rule of
    :func:`append_spec`, which writes them as a batch of one slot: a
    page whose offset-0 lane is in this batch mints a fresh scale over
    every lane it receives; a page entered mid-way (the resume boundary
    page) keeps its stored scale."""
    if not _is_fp8(kv):
        return append_token(kv, layer, page_idx, offset, k, v)
    return append_spec(kv, layer, page_idx[None], offset[None], k[None],
                       v[None], chunk=chunk[None], real=real[None],
                       tables=table[None])


def append_spec(kv, layer: int, page_idx, offset, k, v, *,
                chunk=None, real=None, tables=None):
    """Write one VERIFY dispatch's K/V: ``W = k_drafts + 1`` lanes per
    slot at consecutive positions (``[S, W]`` indices, ``[S, W, H, hd]``
    values), padded and inactive lanes pointing at the null page. The
    multi-slot sibling of :func:`append_suffix`.

    Lanes past the accepted prefix wrote K/V that the position rollback
    (:func:`spec_rewind`) makes invisible, and the next dispatch
    overwrites those cells. fp8: ``chunk`` (``[S, W]``, the lane's table
    row, or ``P`` for padded lanes), ``real`` and ``tables`` (``[S, P]``)
    drive a per-(slot, page) absmax; a page whose offset-0 lane is real
    here mints a fresh scale (so a rollback onto offset 0 re-mints it),
    others keep theirs. A page listed by several slots (prefix sharing)
    is read-only for all of them, so its rows re-write the stored
    scale."""
    page_idx = page_idx.long()
    offset = offset.long()
    if not _is_fp8(kv):
        kv["k"][layer, page_idx, :, offset] = k.to(kv["k"].dtype)
        kv["v"][layer, page_idx, :, offset] = v.to(kv["v"].dtype)
        return kv
    tables = tables.long()
    S, W = real.shape
    P = tables.shape[1]
    # per-(slot, page) segments: slot s's row c -> s * (P + 1) + c,
    # padded lanes -> the slot's trash segment s * (P + 1) + P
    segf = (torch.arange(S, device=real.device)[:, None] * (P + 1)
            + chunk.long()).reshape(-1)
    started = _segment_any((real & (offset == 0)).reshape(-1), segf,
                           S * (P + 1)).reshape(S, P + 1)[:, :P]  # [S, P]
    lane_row = torch.clamp(chunk.long(), max=P - 1)
    for name, x in (("k", k), ("v", v)):
        scales = kv[name + "_scale"]
        xf = x.to(torch.float32)                        # [S, W, H, hd]
        H = xf.shape[2]
        am = torch.where(real[..., None], xf.abs().amax(dim=-1),
                         torch.zeros((), device=xf.device))  # [S, W, H]
        am_pg = _segment_amax(am.reshape(S * W, H), segf, S * (P + 1)) \
            .reshape(S, P + 1, H)[:, :P]
        sc_pg = torch.where(started[..., None], precision.fp8_scale(am_pg),
                            scales[layer, tables])      # [S, P, H]
        sc = torch.gather(sc_pg, 1, lane_row[..., None].expand(S, W, H))
        sc = torch.where(real[..., None], sc,
                         torch.ones((), device=xf.device))
        _raw(kv[name])[layer, page_idx, :, offset] = _raw(
            precision.quantize_fp8(xf, sc[..., None]))
        scales[layer, tables] = sc_pg
    return kv


def spec_rewind(pos, n_acc):
    """Post-verify position rollback: the committed extent after a
    verify dispatch accepted ``n_acc[s]`` tokens per slot. K/V past it
    stays in place, invisible to attention, until overwritten."""
    return pos + n_acc


def gather_pages(pool, layer: int, tables) -> torch.Tensor:
    """Each slot's pages in page-major layout ``[S, P, H, ps, hd]``."""
    out = _raw(pool)[layer][tables.long()]
    return out.view(pool.dtype) if out.dtype != pool.dtype else out


def copy_page(kv, src: int, dst: int):
    """Copy-on-write step: duplicate page ``src`` into ``dst`` across
    every layer of the tree, scale rows included, in place. The caller
    then swaps its table entry to ``dst`` and drops its reference on
    ``src``."""
    for name, t in kv.items():
        _raw(t)[:, int(dst)] = _raw(t)[:, int(src)]
    return kv


def pages_needed(total_positions: int, page_size: int) -> int:
    return -(-int(total_positions) // int(page_size))


__all__ = ["PagePool", "commit_prefill", "append_token", "append_suffix",
           "append_spec", "spec_rewind", "gather_pages", "copy_page",
           "pages_needed"]
