"""PyTorch port, paged attention: ``deeplearning4j_tpu_torch/ops/
paged_attention.py`` against the JAX op (``ops/paged_attention_pallas.py``)
on the same numpy inputs at f32.

The port's plain reference is held against the JAX package's XLA
reference (``mode="xla"``) and against the Pallas kernel run through the
Pallas interpreter (``mode="interpret"``), which is how the JAX
package's own tests run it on the CPU. Tolerance: 1e-5 absolute and
relative — the same formula in f32, only the summation order differs
(the kernel's online softmax reduces page by page).

fp8 trees (``float8_e4m3fn`` pools with f32 scale planes, quantized by
the JAX package's own helpers) and query widths past one 32-row tile
are held the same way.

The CUDA kernel itself runs only on the card: its test carries the
``cuda`` marker and skips without one. JAX is imported inside the tests
that compare with it, so the card's tests run where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_paged_attention.py``.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.ops import paged_attention as pa

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, Q, P, N=3, H=2, hd=8, ps=4, L=2):
    """Pools, queries, tables and qbase with: a shared page (row 1 reads
    row 0's first page), a null-page tail (row 2, P > 1), and qbase at 0
    (row 1) and at full context (row 0)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + N * P
    k = rng.standard_normal((L, n_pages, H, ps, hd)).astype(np.float32)
    v = rng.standard_normal((L, n_pages, H, ps, hd)).astype(np.float32)
    q = rng.standard_normal((N, H, Q, hd)).astype(np.float32)
    tables = (1 + np.arange(N * P).reshape(N, P)).astype(np.int32)
    tables[1, 0] = tables[0, 0]
    real = max(1, P - 1)
    tables[2, real:] = 0
    qbase = np.array([P * ps - Q, 0, max(0, real * ps - Q - 1)], np.int32)
    return q, k, v, tables, qbase


def _torch_args(q, k, v, tables, qbase):
    return (torch.from_numpy(q), {"k": torch.from_numpy(k),
                                  "v": torch.from_numpy(v)},
            torch.from_numpy(tables), torch.from_numpy(qbase))


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("Q", [1, 3])
def test_reference_matches_jax(Q, P, mode):
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.paged_attention_pallas import (
        paged_attention as jax_paged_attention)

    q, k, v, tables, qbase = _case(10 * Q + P, Q, P)
    layer = 1
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, layer,
        jnp.asarray(tables), jnp.asarray(qbase), mode=mode))
    tq, tkv, tt, tb = _torch_args(q, k, v, tables, qbase)
    got = pa.paged_attention_reference(tq, tkv, layer, tt, tb)
    assert got.dtype == torch.float32 and got.shape == (3, 2, Q, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mask_value_is_finfo_min_not_inf():
    """Trap: masked logits take ``finfo(dtype).min``, as in the JAX
    reference. A row whose every key is masked (qbase -1) then softmaxes
    to uniform weights, the mean of V; ``-inf`` would give NaN."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.paged_attention_pallas import (
        paged_attention as jax_paged_attention)

    q, k, v, tables, qbase = _case(5, 1, 2)
    qbase[:] = -1
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, 0,
        jnp.asarray(tables), jnp.asarray(qbase), mode="xla"))
    tq, tkv, tt, tb = _torch_args(q, k, v, tables, qbase)
    got = pa.paged_attention_reference(tq, tkv, 0, tt, tb).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got[0, :, 0], v[0, tables[0]].transpose(1, 0, 2, 3)
        .reshape(2, -1, 8).mean(axis=1), **TOL)


def test_cpu_dispatch_takes_reference_and_launches_nothing():
    q, k, v, tables, qbase = _case(0, 2, 3)
    args = _torch_args(q, k, v, tables, qbase)
    before = pa.launches
    got = pa.paged_attention(args[0], args[1], 0, args[2], args[3])
    want = pa.paged_attention_reference(args[0], args[1], 0, args[2], args[3])
    assert torch.equal(got, want)
    assert pa.launches == before


def test_first_position_only_returns_that_value():
    """qbase 0, Q 1: every key but flat position 0 is masked, so the
    context is exactly v at (first page, offset 0)."""
    q, k, v, tables, qbase = _case(3, 1, 3)
    tq, tkv, tt, tb = _torch_args(q, k, v, tables, qbase)
    out = pa.paged_attention_reference(tq, tkv, 0, tt, tb)
    np.testing.assert_allclose(out[1, :, 0].numpy(),
                               v[0, tables[1, 0], :, 0], atol=1e-6)


def test_fp8_tree_raises():
    """An fp8 tree the kernel cannot take is refused before any launch:
    pools that are not float8_e4m3fn, a missing or misshapen scale
    plane, CPU tensors."""
    q, k, v, tables, qbase = _case(0, 1, 1)
    tq, tkv, tt, tb = _torch_args(q, k, v, tables, qbase)
    ones = torch.ones(k.shape[:3])
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        pa._check_kernel_args(tq, tkv["k"], tkv["v"], 0, tt, tb, ones, ones)
    k8, v8 = (tkv[n].to(torch.float8_e4m3fn) for n in ("k", "v"))
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        pa._check_kernel_args(tq, k8, v8, 0, tt, tb, ones, None)
    with pytest.raises(ValueError, match="k_scale must be float32"):
        pa._check_kernel_args(tq, k8, v8, 0, tt, tb, ones[:, :1], ones)
    before = pa.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_attention_kernel(tq, {"k": k8, "v": v8, "k_scale": ones,
                                       "v_scale": ones}, 0, tt, tb)
    assert pa.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the kernel wrapper raises; it never computes the
    result another way."""
    tq, tkv, tt, tb = _torch_args(*_case(0, 1, 1))
    before = pa.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_attention_kernel(tq, tkv, 0, tt, tb)
    assert pa.launches == before


@pytest.mark.parametrize("bad, match", [
    (dict(q_dtype=torch.float16), "float32 or bfloat16"),
    (dict(pool_dtype=torch.bfloat16), "must match"),
    (dict(tables_dtype=torch.int64), "int32"),
    (dict(hd=48), "multiple of 32"),
    (dict(Q=0), "query rows"),
    (dict(layer=2), "outside the pool"),
    (dict(qbase_len=3), "qbase"),
    (dict(q_noncontig=True, Q=2), "contiguous"),
    (dict(Q=pa._MAX_Q + 1), "query rows"),
])
def test_kernel_argument_checks(bad, match):
    hd, Q = bad.get("hd", 32), bad.get("Q", 1)
    if Q > pa._MAX_Q:
        # a broadcast view: the width check comes before the layout one
        q = torch.zeros(()).expand(2, 2, Q, hd)
    else:
        q = torch.zeros(2, 2, Q, hd, dtype=bad.get("q_dtype", torch.float32))
    if bad.get("q_noncontig"):
        q = torch.zeros(2, 2, hd, Q).transpose(2, 3)
    k = torch.zeros(2, 3, 2, 4, hd, dtype=bad.get("pool_dtype", q.dtype))
    tables = torch.zeros(2, 2, dtype=bad.get("tables_dtype", torch.int32))
    qbase = torch.zeros(bad.get("qbase_len", 2), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError), match=match):
        pa._check_kernel_args(q, k, k.clone(), bad.get("layer", 0), tables,
                              qbase)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises instead of leaving a half-made
    library."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build(["paged_attention"])
    assert not any(p.suffix == ".so" for p in tmp_path.rglob("*"))


def test_library_path_follows_source_and_flags(monkeypatch):
    a = native.library_path("paged_attention")
    assert a.startswith(native.BUILD_DIR) and a.endswith(".so")
    monkeypatch.setattr(native, "NVCC_FLAGS", native.NVCC_FLAGS + ("-G",))
    assert native.library_path("paged_attention") != a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Q", [1, 4])
def test_cuda_kernel_matches_reference(Q, dtype, tol):
    """On the card: kernel vs the plain version on the same inputs; bf16
    pools are held against the reference run at f32 on the bf16-rounded
    inputs (tolerance 2e-2, the bf16 output rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, tables, qbase = _case(7, Q, 5, N=3, H=4, hd=64, ps=16)
    tq, tkv, tt, tb = (x.cuda() if torch.is_tensor(x)
                       else {n: t.cuda() for n, t in x.items()}
                       for x in _torch_args(q, k, v, tables, qbase))
    lq = tq.to(dtype)
    lkv = {n: t.to(dtype) for n, t in tkv.items()}
    before = pa.launches
    got = pa.paged_attention(lq, lkv, 1, tt, tb)
    torch.cuda.synchronize()
    assert pa.launches == before + 1 and got.dtype == dtype
    want = pa.paged_attention_reference(
        lq.float(), {n: t.float() for n, t in lkv.items()}, 1, tt, tb)
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


# ------------------------------------------------ fp8 trees and wide Q
def _fp8_tree(k, v):
    """Quantize float pools per page and head with the JAX package's
    helpers: (JAX tree, torch tree with the same bytes and scales)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn import precision as jprec

    jtree, ttree = {}, {}
    for name, x in (("k", k), ("v", v)):
        sc = jprec.fp8_scale(jnp.asarray(np.abs(x).max(axis=(3, 4))))
        qx = jprec.quantize_fp8(jnp.asarray(x), sc[..., None, None])
        jtree[name], jtree[name + "_scale"] = qx, sc
        ttree[name] = torch.from_numpy(
            np.asarray(qx).view(np.uint8).copy()).view(torch.float8_e4m3fn)
        ttree[name + "_scale"] = torch.from_numpy(np.asarray(sc).copy())
    return jtree, ttree


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("Q", [1, 3])
def test_fp8_reference_matches_jax(Q, mode):
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.paged_attention_pallas import (
        paged_attention as jax_paged_attention)

    q, k, v, tables, qbase = _case(40 + Q, Q, 3)
    k *= 30.0                        # a range well past the e4m3 max
    jtree, ttree = _fp8_tree(k, v)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jtree, 1, jnp.asarray(tables), jnp.asarray(qbase),
        mode=mode))
    tq, _, tt, tb = _torch_args(q, k, v, tables, qbase)
    got = pa.paged_attention_reference(tq, ttree, 1, tt, tb)
    assert got.dtype == torch.float32 and got.shape == (3, 2, Q, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert pa.paged_attention(tq, ttree, 1, tt, tb).equal(got)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("Q", [33, 64])
def test_wide_query_reference_matches_jax(Q, mode):
    """Query widths past one 32-row tile, as the prefix-prefill program
    gives the kernel (N=1 with qbase mid-page, plus two more rows)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.paged_attention_pallas import (
        paged_attention as jax_paged_attention)

    q, k, v, tables, qbase = _case(50 + Q, Q, 20)
    qbase = np.array([2, 0, 6], np.int32)
    tables[2, 20 - 1:] = 0
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, 0,
        jnp.asarray(tables), jnp.asarray(qbase), mode=mode))
    tq, tkv, tt, tb = _torch_args(q, k, v, tables, qbase)
    got = pa.paged_attention_reference(tq, tkv, 0, tt, tb)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _cuda_tree(k, v, kind):
    if kind == "fp8":
        return {n: t.cuda() for n, t in _fp8_tree(k, v)[1].items()}
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
    return {"k": torch.from_numpy(k).to(dtype).cuda(),
            "v": torch.from_numpy(v).to(dtype).cuda()}


def _f32_tree(tree):
    """The same values at f32: fp8 pages dequantized in f32 (what the
    kernel computes on), float pools widened."""
    if "k_scale" in tree:
        return {n: (tree[n].float() * tree[n + "_scale"][..., None, None])
                for n in ("k", "v")}
    return {n: t.float() for n, t in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind, qdtype, tol", [
    ("fp8", torch.float32, 1e-5), ("fp8", torch.bfloat16, 2e-2),
    ("f32", torch.float32, 1e-5), ("bf16", torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Q, qbase", [(1, None), (5, None), (33, 7),
                                      (64, 16), (512, 0)])
def test_cuda_kernel_fp8_and_wide_queries(Q, qbase, kind, qdtype, tol):
    """On the card: the fp8 branch (f32 and bf16 queries) and query
    widths of one tile, 33, 64 and 512 rows (N=1 at qbase mid-page and
    page-aligned, as the prefix-prefill program runs) against the plain
    version at f32 on the same dequantized values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    P = (Q + 31) // 16 + 2
    N = 3 if qbase is None else 1
    q, k, v, tables, qb = _case(60 + Q, Q, P, N=3, H=4, hd=64, ps=16)
    # K past the e4m3 range (fp8 scales well above the floor), logits of
    # unit scale as in serving
    k *= 20.0
    q /= 20.0
    if qbase is not None:
        q, tables, qb = q[:1], tables[:1], np.array([qbase], np.int32)
    tree = _cuda_tree(k, v, kind)
    tq = torch.from_numpy(q).to(qdtype).cuda()
    tt, tb = torch.from_numpy(tables).cuda(), torch.from_numpy(qb).cuda()
    before, multi = pa.launches, pa.multi_row_launches
    got = pa.paged_attention(tq, tree, 1, tt, tb)
    torch.cuda.synchronize()
    assert pa.launches == before + 1 and got.dtype == qdtype
    assert pa.multi_row_launches == multi + int(Q > 1)
    assert got.shape == (N, 4, Q, 64)
    want = pa.paged_attention_reference(tq.float(), _f32_tree(tree), 1, tt,
                                        tb)
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


# ------------------------------------------------- the launch plan (CPU)
@pytest.mark.parametrize("args, want", [
    # decode N=8 H=12 Q=1 hd=64 ps=16 P=32 on 132 SMs: 96 one-row blocks
    # of 8 warps
    ((8, 12, 1, 32, 16, 64, 2, 132), (1, 1, 8)),
    ((8, 12, 1, 32, 16, 64, 1, 132), (1, 1, 8)),        # fp8 pools
    ((8, 12, 1, 32, 16, 64, 4, 132), (1, 1, 6)),        # f32 pools
    ((8, 12, 5, 32, 16, 64, 2, 132), (8, 1, 8)),        # verify k=4
    # prefix: 192 tiles > 132 SMs, so two blocks per SM: 5 warps
    ((1, 12, 128, 32, 16, 64, 2, 132), (8, 16, 5)),
    ((1, 12, 512, 32, 16, 64, 2, 132), (8, 64, 5)),
    ((1, 1, 1, 3, 16, 64, 2, 132), (1, 1, 8)),          # few pages
    ((8, 12, 1, 32, 16, 256, 2, 132), (1, 1, 3)),       # wide heads
    ((8, 12, 9, 32, 16, 256, 4, 132), (8, 2, 1)),       # f32, widest
    ((8, 12, 9, 32, 16, 96, 1, 132), (8, 2, 3)),        # fp8, 8-row tiles
])
def test_launch_plan(args, want):
    """Tiles of 1 row at Q=1, else 8; as many warps, up to 8, as fit an
    SM's shared memory beside the block's head (half of it where there
    are more blocks than SMs), at least one; the block's bytes are those
    of that many warps and fit."""
    plan = pa.launch_plan(*args)
    assert (plan.rows, plan.tiles, plan.warps) == want
    N, H, Q, P, ps, hd, kvb, sms = args
    budget = pa.SMEM_PER_SM // (1 if N * H * plan.tiles <= sms else 2) - 1024
    per_warp = (2 * (2 * 32 * (hd * kvb + 16) + 256) + 32 * plan.rows * 4
                + (2 * 32 * (hd + 8) * 2 if kvb == 1 and plan.rows == 8
                   else 0))
    head = -(-(plan.rows * hd * 4 + P * 4) // 16) * 16
    assert plan.smem == head + plan.warps * per_warp
    assert plan.smem == pa.block_smem(plan.rows, hd, kvb, P, plan.warps)
    assert plan.smem <= pa.SMEM_PER_SM - 1024
    assert plan.warps == 8 or plan.warps == 1 or \
        plan.smem + per_warp > budget


def test_launch_plan_takes_a_budget_and_refuses_what_does_not_fit():
    """Half an SM's shared memory plans fewer warps; a page table that
    leaves no room for one warp, or a grid past a C int, raises."""
    full = pa.launch_plan(8, 12, 1, 32, 16, 64, 2, 132)
    half = pa.launch_plan(8, 12, 1, 32, 16, 64, 2, 132,
                          smem_per_sm=pa.SMEM_PER_SM // 2)
    assert half.warps < full.warps and half.smem < pa.SMEM_PER_SM // 2
    with pytest.raises(ValueError, match="shared memory"):
        pa.launch_plan(1, 1, 1, 60000, 16, 64, 2, 132)
    with pytest.raises(ValueError, match="grid"):
        pa.launch_plan(2 ** 16, 2 ** 8, 2 ** 17, 32, 16, 64, 2, 132)


def test_pack_ints_in_the_c_entry_order():
    """The packed ints in the order the C entry reads them: is_bf16,
    is_fp8, N, H, Q, hd, ps, P, n_pages, rows, warps, device."""
    q = torch.zeros(3, 2, 5, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 7, 2, 16, 64, dtype=torch.bfloat16)
    tables = torch.zeros(3, 4, dtype=torch.int32)
    plan = pa.launch_plan(3, 2, 5, 4, 16, 64, 2, 132)
    ints = pa.pack_ints(q, k, tables, plan, 1, False)
    assert list(ints) == [1, 0, 3, 2, 5, 64, 16, 4, 7, 8, plan.warps, 1]
    src = open(native._source("paged_attention")).read()
    names = ("is_bf16", "is_fp8", "N", "H", "Q", "hd", "ps", "P", "n_pages",
             "rows", "warps", "device")
    for i, name in enumerate(names):
        assert f"{name} = ints[{i}]" in src, name


def test_attention_probe_edits_find_their_anchors():
    """``tools/attention_probe.py``'s cycles mode measures an edited copy
    of the kernel source: every text substitution must still find its
    anchor, once."""
    from deeplearning4j_tpu_torch.tools import attention_probe

    src = open(native._source("paged_attention")).read()
    for old, new in attention_probe.CYCLES:
        assert src.count(old) == 1, old
        src = src.replace(old, new)


# --------------------------------------------------------- on the card
def _card_case(seed, Q, P, kind, qdtype, qbase=None, hd=64):
    """_case's three rows at H=4, ps=16, or with ``qbase`` given, its
    first row alone from that position."""
    q, k, v, tables, qb = _case(seed, Q, P, H=4, hd=hd, ps=16)
    k *= 20.0
    q /= 20.0
    if qbase is not None:
        q, tables = q[:1], tables[:1]
        qb = np.array(qbase, np.int32)
    tree = _cuda_tree(k, v, kind)
    return (torch.from_numpy(q).to(qdtype).cuda(), tree,
            torch.from_numpy(tables).cuda(), torch.from_numpy(qb).cuda())


CARD_KINDS = [("bf16", torch.bfloat16, 2e-2), ("fp8", torch.bfloat16, 2e-2),
              ("fp8", torch.float32, 1e-5), ("f32", torch.float32, 1e-5)]


def _fits(q, tree, tt, warps):
    """Whether ``warps`` warps' rings fit one block's shared memory."""
    rows = 1 if q.shape[2] == 1 else 8
    return pa.block_smem(rows, q.shape[3], tree["k"].element_size(),
                         tt.shape[1], warps) <= pa.SMEM_PER_SM - 1024


def _at_warps(q, tree, tt, tb, layer, warps):
    """One launch at a given warp count, with the wrapper's plan
    otherwise."""
    N, H, Q, hd = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = pa.launch_plan(N, H, Q, tt.shape[1], tree["k"].shape[3], hd,
                          tree["k"].element_size(), sms)
    ints = pa.pack_ints(q, tree["k"], tt, plan._replace(warps=warps), 0,
                        "k_scale" in tree)
    return pa.launch(q, tree, layer, tt, tb, 0, ints)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, qdtype, tol", CARD_KINDS)
@pytest.mark.parametrize("Q", [1, 5, 33])
def test_cuda_kernel_every_warp_count(Q, kind, qdtype, tol):
    """The kernel against the plain version at f32 on the same
    (dequantized) values at every warp count a block takes (1-8 where
    their rings fit, 1-6 for f32 pools: warps with no chunk among them),
    with a shared page, a null-page tail, qbase 0 and full context; two
    calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, tree, tt, tb = _card_case(90 + Q, Q, 6, kind, qdtype)
    want = pa.paged_attention_reference(q.float(), _f32_tree(tree), 1, tt, tb)
    counts = [w for w in range(1, 9) if _fits(q, tree, tt, w)]
    assert counts[-1] >= 6
    for warps in counts:
        got = _at_warps(q, tree, tt, tb, 1, warps)
        again = _at_warps(q, tree, tt, tb, 1, warps)
        torch.cuda.synchronize()
        assert got.dtype == qdtype and torch.equal(got, again), warps
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, qdtype, tol", CARD_KINDS)
@pytest.mark.parametrize("warps", [2, 3, "most"])
def test_cuda_warps_masked_for_early_rows(warps, kind, qdtype, tol):
    """N=1, Q=9 from qbase 30 over 3 pages of 16: rows 0-1 (positions 30
    and 31) see the first 32-key chunk only, rows 2-7 the second too, so
    the warp that takes the second chunk has l = 0 for the tile's first
    rows and must weigh exactly 0 there; row 8 is a second tile. "most":
    as many warps as fit (8, or 6 for f32 pools)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, tree, tt, tb = _card_case(7, 9, 3, kind, qdtype, qbase=[30])
    if warps == "most":
        warps = max(w for w in range(1, 9) if _fits(q, tree, tt, w))
    want = pa.paged_attention_reference(q.float(), _f32_tree(tree), 0, tt, tb)
    got = _at_warps(q, tree, tt, tb, 0, warps)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, qdtype, tol", CARD_KINDS)
@pytest.mark.parametrize("hd", [32, 96, 160, 256])
@pytest.mark.parametrize("Q", [1, 9])
def test_cuda_kernel_every_pool_and_head_width(Q, hd, kind, qdtype, tol):
    """Every pool kind (f32 at 1e-5) at head widths the serving shape does
    not use, single rows and 8-row tiles (the tensor cores under bf16
    queries up to 128, the CUDA cores past it), through the wrapper: one
    launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, tree, tt, tb = _card_case(11 + hd + Q, Q, 5, kind, qdtype, hd=hd)
    want = pa.paged_attention_reference(q.float(), _f32_tree(tree), 1, tt, tb)
    before = pa.launches
    got = pa.paged_attention_kernel(q, tree, 1, tt, tb)
    torch.cuda.synchronize()
    assert pa.launches == before + 1 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_calls_in_a_row_stay_right():
    """Many calls of several shapes and pool kinds in a row on one stream
    (plans cached, packed arguments reused): each still matches the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(_card_case(s, Q, 6, kind, dt), tol)
             for s, (Q, (kind, dt, tol)) in enumerate(
                 ((1, CARD_KINDS[0]), (5, CARD_KINDS[1]),
                  (33, CARD_KINDS[3]), (1, CARD_KINDS[2])))]
    wants = [pa.paged_attention_reference(q.float(), _f32_tree(t), 1, tt, tb)
             for (q, t, tt, tb), _ in cases]
    for _ in range(5):
        for ((q, t, tt, tb), tol), want in zip(cases, wants):
            got = pa.paged_attention_kernel(q, t, 1, tt, tb)
            torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
