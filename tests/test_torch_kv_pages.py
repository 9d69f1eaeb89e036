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


# ------------------------------------------------------------ fp8 pools
def _fp8_pools(L=1, n_pages=6, H=2, ps=4, hd=8):
    return (jkv.PagePool(L, H, ps, hd, n_pages, dtype=jnp.float32,
                         kv_dtype="fp8_e4m3"),
            tkv.PagePool(L, H, ps, hd, n_pages, dtype=torch.float32,
                         kv_dtype="fp8_e4m3"))


def _assert_fp8_tree_equal(got, want, skip_null=True):
    """Pool bytes and scale planes bit-equal, page 0 aside (it takes the
    duplicate writes of padded and inactive lanes in an unspecified
    order on both sides)."""
    lo = 1 if skip_null else 0
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            got[name].view(torch.uint8)[:, lo:].numpy(),
            np.asarray(want[name]).view(np.uint8)[:, lo:],
            err_msg=f"{name} bytes")
        np.testing.assert_array_equal(
            got[name + "_scale"][:, lo:].numpy(),
            np.asarray(want[name + "_scale"])[:, lo:],
            err_msg=f"{name}_scale")


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t.to(dtype) if dtype is not None else t


def test_fp8_pool_layout_and_bytes_match_jax():
    jp, tp = _fp8_pools(L=2, H=4, ps=8, hd=16, n_pages=4)
    assert set(tp.tree()) == set(jp.tree()) \
        == {"k", "v", "k_scale", "v_scale"}
    assert tp.k.dtype == torch.float8_e4m3fn
    assert tp.k_scale.shape == (2, 4, 4) and bool((tp.k_scale == 1).all())
    assert tp.bytes_per_page() == jp.bytes_per_page() \
        == 2 * 2 * 4 * 8 * 16 + 2 * 2 * 4 * 4
    assert tp.dtype_label == jp.dtype_label == "fp8_e4m3"
    bf = tkv.PagePool(2, 4, 8, 16, 4, dtype=torch.bfloat16)
    assert bf.dtype_label == "bfloat16"
    assert bf.bytes_per_page() / tp.bytes_per_page() >= 1.8
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.PagePool(1, 2, 4, 4, 3, kv_dtype="int4")


@pytest.mark.parametrize("n_valid", [None, 5, 8])
def test_fp8_commit_prefill_matches_jax(n_valid):
    """The padded tail (here 1e3) must not reach a page's scale when
    ``n_valid`` is given; pool bytes and scales equal JAX's."""
    L, H, ps, hd, B = 1, 2, 4, 8, 8
    rng = np.random.default_rng(0)
    ks = rng.standard_normal((L, 1, H, B, hd)).astype(np.float32) * 3
    vs = rng.standard_normal((L, 1, H, B, hd)).astype(np.float32)
    ks[:, :, :, 5:] = 1e3
    row = np.array([3, 1], np.int32)
    jp, tp = _fp8_pools()
    nv = None if n_valid is None else jnp.asarray(n_valid, jnp.int32)
    want = jkv.commit_prefill(jp.tree(), jnp.asarray(ks), jnp.asarray(vs),
                              jnp.asarray(row), ps, n_valid=nv)
    got = tkv.commit_prefill(tp.tree(), _t(ks), _t(vs), row, ps,
                             n_valid=n_valid)
    assert got["k"] is tp.k and got["k_scale"] is tp.k_scale
    _assert_fp8_tree_equal(got, want)
    if n_valid == 5:      # the 1e3 tail clipped, not in the scale
        assert float(tp.k_scale[0, 1].max()) < 1e3 / 448


def test_fp8_append_token_freezes_the_scale_after_offset_0():
    jp, tp = _fp8_pools()
    jkv_, tkv_ = jp.tree(), tp.tree()
    page = np.array([1, 4, 0], np.int32)        # lane 2 inactive
    for off, val in ((0, 2.0), (1, 400.0), (2, -7.0)):
        offset = np.array([off, off, 0], np.int32)
        rng = np.random.default_rng(off)
        k = (rng.standard_normal((3, 2, 8)) * val).astype(np.float32)
        v = np.full((3, 2, 8), val, np.float32)
        jkv_ = jkv.append_token(jkv_, 0, jnp.asarray(page),
                                jnp.asarray(offset), jnp.asarray(k),
                                jnp.asarray(v))
        tkv_ = tkv.append_token(tkv_, 0, _t(page), _t(offset), _t(k), _t(v))
        _assert_fp8_tree_equal(tkv_, jkv_)
        if off == 0:
            minted = tp.k_scale[0, 1].clone()
    # the outlier at offset 1 clipped under the frozen scale
    assert torch.equal(tp.k_scale[0, 1], minted)


def _suffix_case(table, pos, B, P, ps, seed):
    rng = np.random.default_rng(seed)
    real = np.arange(B) < pos.size
    padded = np.concatenate([pos, np.zeros(B - pos.size, int)])
    chunk = np.where(real, padded // ps, P)
    page = np.where(real, table[np.minimum(padded // ps, P - 1)], 0)
    off = np.where(real, padded % ps, 0)
    ks = (rng.standard_normal((B, 2, 8)) * 5).astype(np.float32)
    vs = rng.standard_normal((B, 2, 8)).astype(np.float32)
    return (page.astype(np.int32), off.astype(np.int32), ks, vs,
            chunk.astype(np.int32), real)


def test_fp8_append_suffix_matches_jax():
    """A boundary page entered mid-way keeps its frozen scale, a fresh
    page mints the exact amax over its lanes, padded lanes change
    nothing (tests/test_paged_attention.py's case)."""
    jp, tp = _fp8_pools()
    jkv_, tkv_ = jp.tree(), tp.tree()
    pre = np.full((1, 2, 8), 2.0, np.float32)
    for off in (0, 1):
        jkv_ = jkv.append_token(jkv_, 0, jnp.asarray([2], jnp.int32),
                                jnp.asarray([off], jnp.int32),
                                jnp.asarray(pre), jnp.asarray(pre))
        tkv_ = tkv.append_token(tkv_, 0, torch.tensor([2]),
                                torch.tensor([off]), _t(pre), _t(pre))
    boundary = tp.k_scale[0, 2].clone()
    table = np.array([1, 2, 3], np.int32)
    page, off, ks, vs, chunk, real = _suffix_case(
        table, np.arange(6, 10), 8, 3, 4, seed=1)
    jkv_ = jkv.append_suffix(
        jkv_, 0, jnp.asarray(page), jnp.asarray(off), jnp.asarray(ks),
        jnp.asarray(vs), chunk=jnp.asarray(chunk), real=jnp.asarray(real),
        table=jnp.asarray(table))
    tkv_ = tkv.append_suffix(
        tkv_, 0, _t(page), _t(off), _t(ks), _t(vs), chunk=_t(chunk),
        real=_t(real), table=_t(table))
    _assert_fp8_tree_equal(tkv_, jkv_)
    assert torch.equal(tp.k_scale[0, 2], boundary)
    assert bool((tp.k_scale[0, 1] == 1).all())


def test_fp8_append_spec_matches_jax_with_remint():
    """Two verify dispatches over two slots and a shared read-only page:
    the second dispatch rolls slot 0 back onto offset 0 of its page, so
    that page re-mints its scale from the new lanes, while slot 1
    enters its page mid-way and keeps the stored scale."""
    S, W, P, ps = 3, 3, 3, 4
    jp, tp = _fp8_pools(n_pages=8)
    jkv_, tkv_ = jp.tree(), tp.tree()
    tables = np.array([[1, 2, 0], [1, 3, 4], [0, 0, 0]], np.int32)
    rng = np.random.default_rng(3)
    for pos, n_draft, active in (([4, 5, 0], [2, 2, 0], [1, 1, 0]),
                                 ([4, 7, 0], [2, 1, 0], [1, 1, 0])):
        pos, n_draft = np.array(pos), np.array(n_draft)
        active = np.array(active, bool)
        posw = pos[:, None] + np.arange(W)[None, :]
        real = (np.arange(W)[None, :] <= n_draft[:, None]) & active[:, None]
        chunk = np.minimum(posw // ps, P - 1)
        page = np.where(real, np.take_along_axis(tables, chunk, 1), 0)
        off = posw % ps
        seg = np.where(real, chunk, P)
        k = (rng.standard_normal((S, W, 2, 8)) * 4).astype(np.float32)
        v = rng.standard_normal((S, W, 2, 8)).astype(np.float32)
        args = [x.astype(np.int32) for x in (page, off)]
        jkv_ = jkv.append_spec(
            jkv_, 0, *map(jnp.asarray, args), jnp.asarray(k),
            jnp.asarray(v), chunk=jnp.asarray(seg.astype(np.int32)),
            real=jnp.asarray(real), tables=jnp.asarray(tables))
        tkv_ = tkv.append_spec(
            tkv_, 0, *map(_t, args), _t(k), _t(v),
            chunk=_t(seg.astype(np.int32)), real=_t(real),
            tables=_t(tables))
        _assert_fp8_tree_equal(tkv_, jkv_)


def test_fp8_copy_page_carries_scales():
    jp, tp = _fp8_pools()
    k0 = np.full((1, 2, 8), 3.0, np.float32)
    jkv_ = jkv.append_token(jp.tree(), 0, jnp.asarray([1], jnp.int32),
                            jnp.asarray([0], jnp.int32), jnp.asarray(k0),
                            jnp.asarray(k0))
    tkv_ = tkv.append_token(tp.tree(), 0, torch.tensor([1]),
                            torch.tensor([0]), _t(k0), _t(k0))
    jkv_ = jkv.copy_page(jkv_, jnp.asarray(1), jnp.asarray(4))
    tkv_ = tkv.copy_page(tkv_, 1, 4)
    _assert_fp8_tree_equal(tkv_, jkv_, skip_null=False)
    assert torch.equal(tp.k_scale[:, 4], tp.k_scale[:, 1])
    assert torch.equal(tp.k.view(torch.uint8)[:, 4],
                       tp.k.view(torch.uint8)[:, 1])


def test_gather_pages_and_spec_rewind_match_jax():
    jp, tp = _fp8_pools()
    rng = np.random.default_rng(4)
    ks = rng.standard_normal((1, 1, 2, 8, 8)).astype(np.float32)
    jkv_ = jkv.commit_prefill(jp.tree(), jnp.asarray(ks), jnp.asarray(ks),
                              jnp.asarray([2, 5], jnp.int32), 4)
    tkv.commit_prefill(tp.tree(), _t(ks), _t(ks), np.array([2, 5]), 4)
    tables = np.array([[2, 5], [5, 0]], np.int32)
    got = tkv.gather_pages(tp.k, 0, _t(tables))
    want = jkv.gather_pages(jkv_["k"], 0, jnp.asarray(tables))
    assert got.dtype == torch.float8_e4m3fn and got.shape == (2, 2, 2, 4, 8)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  np.asarray(want).view(np.uint8))
    pos, n = np.array([3, 9]), np.array([1, 4])
    assert tkv.spec_rewind(_t(pos), _t(n)).tolist() \
        == np.asarray(jkv.spec_rewind(jnp.asarray(pos),
                                      jnp.asarray(n))).tolist()
