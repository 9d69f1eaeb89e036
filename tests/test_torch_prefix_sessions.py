"""PyTorch port, cross-request KV reuse bookkeeping:
``deeplearning4j_tpu_torch/serving/prefix_cache.py`` and ``sessions.py``
against the JAX package's (host-side both). A scripted sequence of
inserts, lookups, evictions, pins, resumes and clears must give the
same hits, pages and reference counts on both sides, each over its own
page pool."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import kv_pages as jkv
from deeplearning4j_tpu.serving import prefix_cache as jpc
from deeplearning4j_tpu.serving import sessions as jss
from deeplearning4j_tpu_torch.serving import kv_pages as tkv
from deeplearning4j_tpu_torch.serving import prefix_cache as tpc
from deeplearning4j_tpu_torch.serving import sessions as tss

PS = 4


def _sides(n_pages=24):
    return ((jpc, jss, jkv.PagePool(1, 1, PS, 4, n_pages,
                                    dtype=jnp.float32)),
            (tpc, tss, tkv.PagePool(1, 1, PS, 4, n_pages,
                                    dtype=torch.float32)))


def _refs(pool):
    return {p: pool.refcount(p) for p in range(1, pool.n_pages)
            if pool.refcount(p)}


def test_page_digest_bytes_match_jax():
    rng = np.random.default_rng(0)
    parent = b"root"
    for _ in range(5):
        toks = rng.integers(0, 50000, (PS,)).astype(np.int64)
        a = tpc.page_digest(parent, toks)
        assert a == jpc.page_digest(parent, toks) and len(a) == 16
        parent = a


def _prefix_script(pc_mod, pool):
    """Inserts, lookups (full hit, CoW partial, miss), eviction under
    readers, clear; returns every observable along the way."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 9, (10,)).astype(np.int32)
    a = np.concatenate([shared, [1, 2, 3]]).astype(np.int32)
    b = np.concatenate([shared[:9], [7, 7]]).astype(np.int32)
    c = rng.integers(0, 9, (9,)).astype(np.int32)
    cache = pc_mod.PrefixCache(PS)
    log = []
    rows_a = pool.alloc(4)
    log.append(("insert a", cache.insert(a, rows_a, pool), _refs(pool)))
    hit = cache.lookup_acquire(b, pool)
    cache.record(hit)
    log.append(("hit b", hit.pages, hit.cow_src, hit.cow_tokens,
                hit.tokens, _refs(pool), cache.hit_tokens_hint(b)))
    rows_c = pool.alloc(3)
    cache.insert(c, rows_c, pool)
    miss = cache.lookup_acquire(np.array([8, 8, 8, 8, 8], np.int32), pool)
    cache.record(miss)
    log.append(("miss", miss.pages, miss.cow_src, miss.tokens))
    # the slot of a finishes; b's hit still reads a's first two pages
    pool.free(rows_a)
    pool.free(rows_c)
    log.append(("evict", cache.evict(pool, 10), _refs(pool),
                cache.cached_pages))
    hit.release(pool)
    log.append(("evict after release", cache.evict(pool, 1), _refs(pool),
                cache.cached_pages))
    log.append(("clear", cache.clear(pool), _refs(pool), pool.allocated))
    log.append(("stats", cache.stats()))
    return log


def test_prefix_cache_script_matches_jax():
    (jm, _, jp), (tm, _, tp) = _sides()
    assert _prefix_script(tm, tp) == _prefix_script(jm, jp)


def _session_script(ss_mod, pool):
    store = ss_mod.SessionStore(capacity=2, ttl=100.0)
    log = []
    h1 = np.arange(7, dtype=np.int32)
    p1 = pool.alloc(2)
    store.pin("a", p1, h1, pool)
    store.pin("b", pool.alloc(1), np.arange(3, dtype=np.int32), pool)
    ext = np.concatenate([h1, [9, 9]]).astype(np.int32)
    log.append(("match", store.match_pos("a", ext),
                store.match_pos("a", ext[::-1].copy()),
                store.match_pos("zz", ext), store.pages_hint("a"),
                store.peek("a")))
    # a third pin evicts the least recently used ("a")
    store.pin("c", pool.alloc(1), np.arange(2, dtype=np.int32), pool)
    log.append(("capacity", len(store), store.peek("a"), _refs(pool)))
    s = store.take("b")
    log.append(("take", s.pages, s.pos, s.turns, len(store)))
    pool.free(s.pages)
    log.append(("release", store.release("c", pool), store.release("c", pool),
                _refs(pool)))
    store.pin("d", pool.alloc(2), np.arange(5, dtype=np.int32), pool,
              turns=3)
    log.append(("evict_oldest", store.evict_oldest(pool),
                store.evict_oldest(pool), _refs(pool)))
    store.pin("e", pool.alloc(1), np.arange(2, dtype=np.int32), pool)
    log.append(("expire", store.expire(pool, now=1e12), len(store),
                store.pinned_pages(), pool.allocated))
    log.append(("stats", store.stats()))
    return log


def test_session_store_script_matches_jax():
    (_, js, jp), (_, ts, tp) = _sides()
    got, want = _session_script(ts, tp), _session_script(js, jp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g, w)


def test_session_store_validates_capacity():
    with pytest.raises(ValueError, match="capacity"):
        tss.SessionStore(capacity=0, ttl=1.0)
