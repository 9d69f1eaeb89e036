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
bf16 within 2e-2 of the f32 plain version on the bf16-rounded inputs
(forward) and within 2e-2 of max |grad| (backward). bf16 runs the
tensor-core kernels at every head dim, at lengths inside one tile (1,
16), with a ragged tile (77, 200) or two whole tiles (128), Tq != Tk,
and every mask; two backward calls on the same inputs are bit-equal.
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
    (dict(dtype=torch.float64), "float32, bfloat16 or float16"),
    (dict(k_dtype=torch.bfloat16), "must match"),
    (dict(hd=257), "head_dim 1 to 256"),
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


@pytest.mark.parametrize("dtype, hd, tile, kernel_dtype", [
    (torch.bfloat16, 64, 64, torch.bfloat16),
    (torch.bfloat16, 16, 32, torch.bfloat16),
    (torch.float32, 48, 64, torch.float32),
    (torch.float16, 64, 64, torch.float32),
    (torch.bfloat16, 160, 256, torch.float32),
    (torch.float32, 256, 256, torch.float32),
])
def test_kernel_layout(dtype, hd, tile, kernel_dtype):
    """The tile and dtype the kernels run a call at (C9, C10): the head
    dim padded to the next of 32, 64, 96, 128 (256 on the f32 route), bf16
    on the tensor cores up to 128, everything else at f32."""
    assert fa.kernel_layout(dtype, hd) == (tile, kernel_dtype)
    q = torch.zeros(2, 2, 8, hd, dtype=dtype)
    # every check passes but the device's
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._check_kernel_args(q, q.clone(), q.clone(), None)
    padded = fa._to_kernel(torch.ones(2, 3, hd, dtype=dtype), tile,
                           kernel_dtype)
    assert padded.shape == (2, 3, tile) and padded.dtype == kernel_dtype
    assert float(padded[..., hd:].abs().sum()) == 0.0
    assert float(padded[..., :hd].sum()) == 6 * hd


#: head dims and dtypes the kernels are not built for, which the JAX
#: kernel takes (C9: f16; C10: head dims other than 32, 64, 96, 128)
WIDE_CASES = [(torch.float16, 32), (torch.float32, 48), (torch.float32, 160),
              (torch.float16, 16)]


@pytest.mark.parametrize("dtype, hd", WIDE_CASES,
                         ids=[f"{str(d)[6:]}-hd{h}" for d, h in WIDE_CASES])
def test_any_head_dim_and_f16_match_jax(dtype, hd):
    """The port's attention at these head dims and dtypes against the JAX
    kernel through the interpreter (forward) and ``jax.vjp`` of its
    backward (``blockwise_attention``): f32 within 1e-5, f16 within 2e-3
    (values) and 2e-3 of max |grad| (f16 roundings at other points)."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.flash_attention import (
        blockwise_attention, pallas_flash_forward)

    jdt = jnp.float16 if dtype == torch.float16 else jnp.float32
    tol = 1e-5 if dtype == torch.float32 else 2e-3
    q, k, v, m = _case(hd, 128, hd=hd, mask="padded")
    g = np.random.default_rng(hd).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = pallas_flash_forward(jq, jk, jv, jnp.asarray(m), interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: blockwise_attention(
        a, b, c, jnp.asarray(m)), jq, jk, jv)
    jgrads = vjp(jnp.asarray(g).astype(jdt))
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in (q, k, v)]
    out = fa.attention(*leaves, torch.from_numpy(m))
    assert out.dtype == dtype
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(dtype))
    for a, b in zip(got, jgrads):
        b = np.asarray(b, np.float32)
        assert a.dtype == dtype
        assert float(np.abs(a.float().numpy() - b).max()) \
            <= tol * float(np.abs(b).max())


def test_tiny_config_flash_matches_jax():
    """``TransformerEncoder(tiny_config(), attn_impl="flash")`` (head dim
    16, C10) on the CPU against the JAX encoder from the same parameters:
    the MLM loss within 1e-4 relative and every gradient within 1e-5
    absolute plus 1e-4 relative."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.models.transformer import (
        TransformerEncoder as JaxEncoder, tiny_config as jax_tiny)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerEncoder, tiny_config)
    from deeplearning4j_tpu_torch.params import FlatParams, params_from_jax

    jcfg, tcfg = jax_tiny(), tiny_config()
    jcfg.dropout = tcfg.dropout = 0.0
    assert tcfg.head_dim == 16
    jm = JaxEncoder(jcfg, attn_impl="flash")
    tm = TransformerEncoder(tcfg, attn_impl="flash")
    params = jax.device_get(jm.init_params(jax.random.key(3)))
    ids, labels, mask_pos = _mlm_batch(tcfg.vocab_size, 3, 24, seed=5)
    jargs = [jnp.asarray(a) for a in (ids, labels, mask_pos)]
    jl, jg = jax.value_and_grad(lambda p: jm.mlm_loss(
        p, *jargs, train=False))(params)
    flat = FlatParams(params_from_jax(params, device="cpu"))
    loss = tm.mlm_loss(flat.tree, *(torch.from_numpy(a) for a in
                                    (ids, labels, mask_pos)), train=False)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    flat.gather_grads(loss)
    want = jax.tree_util.tree_leaves(jg)
    assert len(want) == len(flat.leaves)
    off = 0
    for leaf, w in zip(flat.leaves, want):
        got = flat.grad[off:off + leaf.numel()].view(leaf.shape).numpy()
        off += leaf.numel()
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5, rtol=1e-4)


def _mlm_batch(vocab, n, t, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, t)).astype(np.int32)
    labels = rng.integers(0, vocab, (n, t)).astype(np.int32)
    mask_pos = (rng.random((n, t)) < 0.25).astype(np.float32)
    mask_pos[:, 0] = 1.0
    return ids, labels, mask_pos


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


#: absolute floor of the bf16 gradient tolerance: where a gradient is 0 in
#: exact arithmetic (one key and no mask: dS = P (dP - D) with dP = D) both
#: sides hold only f32 round-off of order 1e-7, and 2e-2 of that is no scale
GRAD_FLOOR = 1e-5


def _bf16_grads(q, k, v, m, causal, g):
    """(out, dq, dk, dv) of the bf16 kernels and of the f32 plain version
    on the bf16-rounded inputs."""
    a = [t.bfloat16().requires_grad_(True) for t in (q, k, v)]
    out = fa.attention(*a, m, causal)
    got = torch.autograd.grad(out, a, g.bfloat16())
    b = [t.bfloat16().float().requires_grad_(True) for t in (q, k, v)]
    ref = _plain(*b, m, causal)
    want = torch.autograd.grad(ref, b, g.bfloat16().float())
    return (out, *got), (ref.detach(), *want)


def _check_bf16(got, want):
    out, ref = got[0], want[0]
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    for x, y in zip(got[1:], want[1:]):
        assert x.dtype == torch.bfloat16 and x.shape == y.shape
        tol = max(2e-2 * float(y.abs().max()), GRAD_FLOOR)
        torch.testing.assert_close(x.float(), y, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["none", "padded", "full"])
@pytest.mark.parametrize("T", [1, 16, 77, 128, 200])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
def test_cuda_bf16_tensor_core_kernels_match_plain(hd, T, mask, causal):
    """The bf16 (tensor-core) forward and backward against the f32 plain
    version: forward within 2e-2, each gradient within 2e-2 of its max
    |grad|."""
    _cuda()
    q, k, v, m = (None if x is None else x.cuda()
                  for x in _t(*_case(hd + T, T, N=2, H=3, hd=hd, mask=mask)))
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(T))
    _check_bf16(*_bf16_grads(q, k, v, m, causal, g))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq, Tk", [(50, 77), (200, 64), (1, 130), (130, 1)])
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_bf16_tq_differs_from_tk(hd, Tq, Tk, causal):
    """Tq != Tk keeps causal as row >= key with no offset, in the kernels'
    tile skip too."""
    _cuda()
    q, k, v, m = (x.cuda() for x in _t(*_case(Tq + Tk, Tk, N=2, H=2, hd=hd,
                                                mask="full", Tq=Tq)))
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(Tq))
    _check_bf16(*_bf16_grads(q, k, v, m, causal, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_is_bit_equal_across_calls(dtype):
    """No atomics: two backward calls on the same inputs give the same
    bits."""
    _cuda()
    q, k, v, m = (x.cuda().to(dtype) if x.dim() == 4 else x.cuda()
                  for x in _t(*_case(4, 200, N=3, H=4, hd=64,
                                     mask="padded")))
    out, stats = fa.flash_attention_fwd(q, k, v, m, True)
    dout = torch.randn_like(q.float()).to(dtype)
    first = fa.flash_attention_bwd(q, k, v, out, dout, stats, m, True)
    again = fa.flash_attention_bwd(q, k, v, out, dout, stats, m, True)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_bf16_fully_masked_row_through_the_backward(causal):
    """A row whose every key is masked: its output is the mean of v over
    the Tk keys, its stats hold m = -1e30 and l = Tk, its dq is exactly 0
    (every dS is masked), and dv carries its dout / Tk to every key."""
    _cuda()
    q, k, v, m = (x.cuda() for x in _t(*_case(8, 77, N=2, H=2, hd=64,
                                                mask="full")))
    bq, bk, bv = (x.bfloat16() for x in (q, k, v))
    out, stats = fa.flash_attention_fwd(bq, bk, bv, m, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out[1].float(), bv[1].float().mean(dim=1, keepdim=True).expand(
            2, 77, 64), atol=2e-2, rtol=2e-2)
    st = stats.view(2, 2, 2, 77)[:, 1]
    assert bool((st[0] == -1e30).all())
    torch.testing.assert_close(st[1], torch.full_like(st[1], 77.0))
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    got, want = _bf16_grads(q, k, v, m, causal, g)
    assert bool((got[1][1] == 0).all())
    _check_bf16(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, hd", WIDE_CASES + [(torch.bfloat16, 16),
                                                    (torch.bfloat16, 160)],
                         ids=[f"{str(d)[6:]}-hd{h}" for d, h in WIDE_CASES
                              + [(torch.bfloat16, 16),
                                 (torch.bfloat16, 160)]])
def test_cuda_any_head_dim_and_f16(dtype, hd, causal):
    """C9 and C10 on the card: f16, and head dims the kernels are not built
    for (16, 48 and 160: zero-padded to 32, 64 and 256), forward and
    backward through the autograd Function against autograd through the
    f32 plain version on the same rounded inputs; f32 within 2e-5 (values)
    and 1e-4 of max |grad|, f16 and bf16 within their rounding (2e-3 and
    2e-2, of max |grad| for gradients). Outputs and gradients keep the
    inputs' dtype and head dim."""
    _cuda()
    q, k, v, m = (x.cuda() for x in _t(*_case(hd, 77, N=2, H=3, hd=hd,
                                                mask="padded", Tq=50)))
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(hd))
    a = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
    before = (fa.fwd_launches, fa.bwd_launches)
    out = fa.attention(*a, m, causal)
    got = torch.autograd.grad(out, a, g.to(dtype))
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    b = [t.to(dtype).float().requires_grad_(True) for t in (q, k, v)]
    ref = _plain(*b, m, causal)
    want = torch.autograd.grad(ref, b, g.to(dtype).float())
    tol = {torch.float32: (2e-5, 1e-4), torch.float16: (2e-3, 2e-3),
           torch.bfloat16: (2e-2, 2e-2)}[dtype]
    assert out.dtype == dtype and out.shape == q.shape
    assert float((out.detach().float() - ref.detach()).abs().max()) \
        <= tol[0]
    for x, y in zip(got, want):
        assert x.dtype == dtype and x.shape == y.shape
        assert float((x.float() - y).abs().max()) \
            <= tol[1] * float(y.abs().max())


@pytest.mark.cuda
def test_cuda_tiny_config_flash_trains():
    """``TransformerEncoder(tiny_config(), attn_impl="flash")`` (head dim
    16) trains on the card: three Adam steps through the kernels against
    the same steps on the CPU (the plain versions) from one numpy tree,
    losses within 1e-4 relative, parameters within 2e-5."""
    _cuda()
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerEncoder, init_params_numpy, tiny_config)
    from deeplearning4j_tpu_torch.params import FlatParams, params_from_jax

    cfg = tiny_config()
    cfg.dropout = 0.0
    tree = init_params_numpy(cfg, seed=4)
    batch = _mlm_batch(cfg.vocab_size, 4, 32, seed=6)
    runs = []
    for dev in ("cuda", "cpu"):
        model = TransformerEncoder(cfg, attn_impl="flash")
        flat = FlatParams(params_from_jax(tree, device=dev))
        upd = Adam(1e-3)
        opt = upd.init_state(flat.master)
        step = model.make_train_step(upd)
        args = [torch.from_numpy(a).to(dev) for a in batch]
        before = fa.fwd_launches
        losses = [float(step(flat, opt, i, *args)) for i in range(3)]
        launched = fa.fwd_launches - before
        runs.append((losses, flat.master.cpu(), launched))
    (lc, pc, launched), (lh, ph, none) = runs
    assert launched == 3 * cfg.n_layers and none == 0
    for a, b in zip(lc, lh):
        assert abs(a - b) <= 1e-4 * abs(b)
    assert float((pc - ph).abs().max()) <= 2e-5
