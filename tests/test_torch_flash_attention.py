"""PyTorch port, flash attention: ``deeplearning4j_tpu_torch/ops/
flash_attention.py`` against ``deeplearning4j_tpu/ops/flash_attention.py``
on the same numpy inputs at f32.

The port's ``blockwise_attention`` and ``xla_attention`` are held against
the JAX functions of the same names, and against the Pallas kernel run
through the Pallas interpreter (``pallas_flash_forward(...,
interpret=True)``), which is how the JAX package's own tests run it on
the CPU. Gradients are held against ``jax.vjp`` of ``blockwise_attention``,
which is the JAX kernel's backward. Tolerance: 1e-5 absolute and relative
— the same formulas in f32, only the summation order differs.

The CUDA kernels run only on the card: their tests carry the ``cuda``
marker and skip without one. JAX is imported inside the tests that
compare with it, so the card's tests run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.
On the card each kernel is held against the plain version on the same
inputs: f32 within 2e-5 (forward) and 1e-4 of max |grad| (backward),
bf16 within 2e-2 of the f32 plain version on the bf16-rounded inputs.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, T, N=2, H=2, hd=8, mask="none", Tq=None):
    """q [N,H,Tq,hd], k/v [N,H,T,hd] and a key mask: none, padded (row 0
    keeps its first 60 % of keys, row 1 all), or full (row 0 padded, row
    1 with every key masked)."""
    rng = np.random.default_rng(seed)
    Tq = T if Tq is None else Tq
    q = rng.standard_normal((N, H, Tq, hd)).astype(np.float32)
    k = rng.standard_normal((N, H, T, hd)).astype(np.float32)
    v = rng.standard_normal((N, H, T, hd)).astype(np.float32)
    m = None
    if mask != "none":
        m = np.ones((N, T), np.float32)
        m[0, int(0.6 * T):] = 0.0
        if mask == "full":
            m[1] = 0.0
    return q, k, v, m


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    import jax.numpy as jnp

    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["none", "padded", "full"])
@pytest.mark.parametrize("T, block_k", [(16, 256), (13, 256), (13, 4)])
def test_blockwise_matches_jax(T, block_k, mask, causal):
    from deeplearning4j_tpu.ops.flash_attention import blockwise_attention

    q, k, v, m = _case(T + block_k, T, mask=mask)
    want = np.asarray(blockwise_attention(*_j(q, k, v, m), causal=causal,
                                          block_k=block_k))
    got = fa.blockwise_attention(*_t(q, k, v, m), causal=causal,
                                 block_k=block_k)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["none", "padded", "full"])
def test_xla_attention_matches_jax(mask, causal):
    from deeplearning4j_tpu.ops.flash_attention import _xla_attention

    q, k, v, m = _case(3, 12, mask=mask, Tq=9)
    want = np.asarray(_xla_attention(*_j(q, k, v, m), causal))
    got = fa.xla_attention(*_t(q, k, v, m), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["padded", "full"])
def test_blockwise_matches_pallas_interpreter(mask, causal):
    """The Pallas kernel at T=128 with 64-row blocks, through the
    interpreter, against the port's blockwise with one block per 64 keys
    (no padding, so even the fully masked row agrees)."""
    from deeplearning4j_tpu.ops.flash_attention import pallas_flash_forward

    q, k, v, m = _case(11, 128, hd=32, mask=mask)
    want = np.asarray(pallas_flash_forward(*_j(q, k, v, m), causal=causal,
                                           block_q=64, block_k=64,
                                           interpret=True))
    got = fa.blockwise_attention(*_t(q, k, v, m), causal=causal, block_k=64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["none", "padded", "full"])
def test_gradients_match_jax_vjp(mask, causal):
    import jax

    from deeplearning4j_tpu.ops.flash_attention import blockwise_attention

    q, k, v, m = _case(5, 13, mask=mask)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    jm = _j(m)[0]
    _, vjp = jax.vjp(lambda a, b, c: blockwise_attention(
        a, b, c, jm, causal=causal, block_k=8), *_j(q, k, v))
    want = vjp(_j(g)[0])
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    out = fa.blockwise_attention(tq, tk, tv, _t(m)[0], causal=causal,
                                 block_k=8)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_fully_masked_row_is_minus_1e30_not_inf():
    """Trap: masked scores are -1e30, so a row whose every key is masked
    is finite and weighs its keys evenly. With no padding (the kernel and
    the Pallas kernel, or blockwise with block_k dividing Tk) that is the
    mean of v; blockwise's padded keys take part too, so at T=128 and the
    default block_k=256 it is sum(v) / 256, as in JAX."""
    from deeplearning4j_tpu.ops.flash_attention import blockwise_attention

    q, k, v, m = _case(2, 128, mask="full")
    tq, tk, tv, tm = _t(q, k, v, m)
    mean_v = v[1].mean(axis=1)
    exact = fa.blockwise_attention(tq, tk, tv, tm, block_k=128).numpy()
    assert np.isfinite(exact).all()
    np.testing.assert_allclose(exact[1], np.broadcast_to(
        mean_v[:, None], exact[1].shape), **TOL)
    np.testing.assert_allclose(fa.xla_attention(tq, tk, tv, tm).numpy()[1],
                               exact[1], **TOL)
    padded = fa.blockwise_attention(tq, tk, tv, tm).numpy()
    np.testing.assert_allclose(padded[1], exact[1] * 128 / 256, **TOL)
    np.testing.assert_allclose(
        padded, np.asarray(blockwise_attention(*_j(q, k, v, m))), **TOL)


def test_cpu_dispatch_takes_blockwise_and_launches_nothing():
    q, k, v, m = _case(0, 13, mask="padded")
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    before = (fa.fwd_launches, fa.bwd_launches)
    got = fa.attention(tq, tk, tv, _t(m)[0])
    got.sum().backward()
    want = fa.blockwise_attention(tq, tk, tv, _t(m)[0])
    assert torch.equal(got, want)
    assert tq.grad is not None and torch.isfinite(tq.grad).all()
    assert (fa.fwd_launches, fa.bwd_launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """On CPU tensors the kernel wrappers raise; they never compute the
    result another way."""
    tq, tk, tv, _ = _t(*_case(0, 8, hd=32))
    before = (fa.fwd_launches, fa.bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_fwd(tq, tk, tv)
    stats = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd(tq, tk, tv, tq, tq, stats)
    assert (fa.fwd_launches, fa.bwd_launches) == before


@pytest.mark.parametrize("bad, match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(k_dtype=torch.bfloat16), "must match"),
    (dict(hd=48), "multiple of 32"),
    (dict(hd=160), "multiple of 32"),
    (dict(k_heads=3), "N, H or hd"),
    (dict(mask_dtype=torch.int32), "key mask"),
    (dict(mask_len=5), "key mask"),
    (dict(noncontig=True), "contiguous"),
    (dict(misaligned=True), "16-byte"),
])
def test_kernel_argument_checks(bad, match):
    hd = bad.get("hd", 32)
    dt = bad.get("dtype", torch.float32)
    q = torch.zeros(2, 2, 8, hd, dtype=dt)
    if bad.get("noncontig"):
        q = torch.zeros(2, 8, 2, hd).transpose(1, 2)
    if bad.get("misaligned"):
        q = torch.zeros(1 + q.numel())[1:].view(q.shape)
    k = torch.zeros(2, bad.get("k_heads", 2), 6, hd,
                    dtype=bad.get("k_dtype", dt))
    mask = torch.ones(2, bad.get("mask_len", 6),
                      dtype=bad.get("mask_dtype", torch.float32))
    with pytest.raises((TypeError, ValueError), match=match):
        fa._check_kernel_args(q, k, k.clone(), mask)


# ------------------------------------------------------------- on the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _plain(q, k, v, m, causal):
    """The kernel's plain version: blockwise with one block spanning the
    keys, so a fully masked row means the same thing (mean of v)."""
    return fa.blockwise_attention(q.float(), k.float(), v.float(), m,
                                  causal=causal, block_k=k.shape[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["none", "full"])
@pytest.mark.parametrize("T", [128, 77])
def test_cuda_forward_matches_plain(T, mask, causal, dtype, tol):
    _cuda()
    q, k, v, m = (None if x is None else x.cuda()
                  for x in _t(*_case(T, T, N=3, H=4, hd=64, mask=mask)))
    lq, lk, lv = (x.to(dtype) for x in (q, k, v))
    before = fa.fwd_launches
    out, stats = fa.flash_attention_fwd(lq, lk, lv, m, causal)
    torch.cuda.synchronize()
    assert fa.fwd_launches == before + 1 and out.dtype == dtype
    assert stats.shape == (2, 12, T)
    want = _plain(lq, lk, lv, m, causal)
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 96, 128])
def test_cuda_forward_other_head_dims(hd):
    _cuda()
    q, k, v, m = (x.cuda() for x in _t(*_case(hd, 50, hd=hd, mask="padded",
                                                Tq=70)))
    out, _ = fa.flash_attention_fwd(q, k, v, m, False)
    torch.testing.assert_close(out, _plain(q, k, v, m, False), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 77])
def test_cuda_backward_matches_autograd(T, causal):
    """dq, dk, dv through the autograd Function (forward and backward
    kernels) against autograd through the plain version, f32, within
    1e-4 of each gradient's largest magnitude."""
    _cuda()
    q, k, v, m = (x.cuda() for x in _t(*_case(T + 1, T, N=3, H=4, hd=64,
                                                mask="full")))
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    before = (fa.fwd_launches, fa.bwd_launches)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa.attention(*a, m, causal), a, g)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_plain(*b, m, causal), b, g)
    for x, y in zip(got, want):
        tol = 1e-4 * float(y.abs().max())
        torch.testing.assert_close(x, y, atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_backward_bf16_is_close():
    _cuda()
    q, k, v = (x.cuda().bfloat16()
               for x in _t(*_case(9, 128, N=2, H=3, hd=64)[:3]))
    g = torch.randn(q.shape, device="cuda").bfloat16()
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa.attention(*a), a, g)
    b = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_plain(*b, None, False), b, g.float())
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16
        tol = 2e-2 * float(y.abs().max())
        torch.testing.assert_close(x.float(), y, atol=tol, rtol=0)
