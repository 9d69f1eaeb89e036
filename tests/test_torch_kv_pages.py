"""PyTorch port, KV pages: ``deeplearning4j_tpu_torch/serving/kv_pages.py``
against ``deeplearning4j_tpu/serving/kv_pages.py`` (float pools).

The allocator must hand out the same pages in the same order and
refuse the same bad frees; the in-place writes must leave the pools
equal to what the JAX functions return (exactly: they are copies),
except on the null page 0, which absorbs duplicate writes of padding
and inactive lanes in an unspecified order on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import kv_pages as jkv
from deeplearning4j_tpu_torch.serving import kv_pages as tkv


def _pools(L=2, n_pages=6, H=2, ps=4, hd=8):
    return (jkv.PagePool(L, H, ps, hd, n_pages, dtype=jnp.float32),
            tkv.PagePool(L, H, ps, hd, n_pages, dtype=torch.float32))


def test_alloc_order_and_accounting_match_jax():
    jp, tp = _pools()
    for n in (2, 1, 2):
        assert tp.alloc(n) == jp.alloc(n)
    assert tp.alloc(1) is None and jp.alloc(1) is None
    assert (tp.allocated, tp.free_pages, tp.capacity, tp.high_water) \
        == (jp.allocated, jp.free_pages, jp.capacity, jp.high_water) \
        == (5, 0, 5, 5)
    for pool in (jp, tp):
        pool.free([3, 1])
    assert tp.alloc(2) == jp.alloc(2)
    assert tp.bytes_per_page() == jp.bytes_per_page() == 2 * 2 * 2 * 4 * 8 * 4


def test_refcounts_share_and_free():
    _, pool = _pools()
    a, b = pool.alloc(2)
    pool.share([a, a])
    assert pool.refcount(a) == 3 and pool.shared_pages() == 1
    pool.free([a])
    assert pool.refcount(a) == 2 and pool.allocated == 2
    pool.free([a, a, b])
    assert pool.allocated == 0 and pool.refcount(a) == 0


@pytest.mark.parametrize("pages, match", [
    ([0], "null page 0"),
    ([6], "outside pool"),
    (["x"], "not an integer"),
    ([2], "double free"),
    ([1, 1], "over-free"),
])
def test_bad_frees_raise_and_leave_the_pool_untouched(pages, match):
    jp, tp = _pools()
    for pool in (jp, tp):
        pool.alloc(1)                      # page 1 live, page 2 free
        free_before = list(pool._free)
        with pytest.raises(ValueError, match=match):
            pool.free(pages)
        assert pool._free == free_before and pool.refcount(1) == 1


def test_share_of_free_page_raises():
    _, pool = _pools()
    with pytest.raises(ValueError, match="cannot share free page"):
        pool.share([3])


def test_pool_arguments_are_validated():
    with pytest.raises(ValueError, match="n_pages >= 2"):
        tkv.PagePool(1, 1, 4, 8, 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tkv.PagePool(1, 1, 4, 8, 3, dtype=torch.int8)


def test_commit_prefill_matches_jax():
    rng = np.random.default_rng(0)
    L, H, ps, hd, B = 2, 2, 4, 8, 12
    jp, tp = _pools(L=L, H=H, ps=ps, hd=hd)
    ks = rng.standard_normal((L, 1, H, B, hd)).astype(np.float32)
    vs = rng.standard_normal((L, 1, H, B, hd)).astype(np.float32)
    page_row = np.array([4, 2, 0], np.int32)     # padded tail -> null page
    want = jkv.commit_prefill(jp.tree(), jnp.asarray(ks), jnp.asarray(vs),
                              jnp.asarray(page_row), ps)
    kv = tp.tree()
    got = tkv.commit_prefill(kv, torch.from_numpy(ks), torch.from_numpy(vs),
                             page_row, ps)
    assert got["k"] is tp.k              # in place: the pool itself
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name][:, 1:].numpy(),
                                      np.asarray(want[name])[:, 1:])


def test_append_token_matches_jax():
    rng = np.random.default_rng(1)
    L, H, ps, hd = 2, 2, 4, 8
    jp, tp = _pools(L=L, H=H, ps=ps, hd=hd)
    page_idx = np.array([3, 0, 5, 0], np.int32)  # lanes 1, 3 inactive
    offset = np.array([2, 0, 0, 0], np.int32)
    k = rng.standard_normal((4, H, hd)).astype(np.float32)
    v = rng.standard_normal((4, H, hd)).astype(np.float32)
    want = jkv.append_token(jp.tree(), 1, jnp.asarray(page_idx),
                            jnp.asarray(offset), jnp.asarray(k),
                            jnp.asarray(v))
    got = tkv.append_token(tp.tree(), 1, torch.from_numpy(page_idx).long(),
                           torch.from_numpy(offset).long(),
                           torch.from_numpy(k), torch.from_numpy(v))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name][:, 1:].numpy(),
                                      np.asarray(want[name])[:, 1:])
    np.testing.assert_array_equal(tp.k[1, 3, :, 2].numpy(), k[0])


def test_append_token_casts_to_the_pool_dtype():
    pool = tkv.PagePool(1, 2, 4, 8, 3, dtype=torch.bfloat16)
    x = torch.randn(1, 2, 8)
    tkv.append_token(pool.tree(), 0, torch.tensor([1]), torch.tensor([3]),
                     x, x)
    assert torch.equal(pool.k[0, 1, :, 3], x[0].to(torch.bfloat16))


@pytest.mark.parametrize("total", [1, 15, 16, 17, 512])
def test_pages_needed_matches_jax(total):
    assert tkv.pages_needed(total, 16) == jkv.pages_needed(total, 16)
