"""PyTorch port, residual-block tail (B3 ``bn_relu_residual``):
``deeplearning4j_tpu_torch/ops/residual_tail.py`` against
``deeplearning4j_tpu/ops/residual_tail_pallas.py`` on the same numpy
inputs.

The JAX side runs as its own tests run it: ``_ref_formula``,
``bn_relu_residual`` (the formula off the TPU, under its custom VJP) and
the Pallas body through the interpreter (``_tail_kernel(...,
interpret=True)``). The port's side runs its plain version (the CPU
path). Tolerances at f32: 1e-6 against the formula (the same operations
in the same order), 1e-5 against the interpreted kernel and for
gradients (sums over rows in another order); bf16 within one bf16
rounding; x and res in different dtypes (either order) within 1e-6 of the
JAX values, in x's dtype.

The CUDA kernel runs only on the card: its tests carry the ``cuda``
marker, skip without one and import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_residual_tail.py``.
There it is held against the plain version on the same inputs: f32
within 1e-5 (the same order of operations; rsqrt rounded apart), bf16
(and a bf16 x with an f32 res) within one bf16 step of the plain
version's bf16 output (at the join shapes and by name: within one bf16
rounding, 2^-8 of the largest value, of the plain version at f32 on the
same values), gradients through its autograd Function within 1e-5 of
max |grad| of the plain formula's.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ndarray import Nd4j
from deeplearning4j_tpu_torch.ops import residual_tail as rt
from deeplearning4j_tpu_torch.ops.registry import get_op


def _inputs(seed=0, n=2, h=4, w=4, c=128):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, c).astype(np.float32)
    r = rs.randn(n, h, w, c).astype(np.float32)
    mean = (rs.randn(c) * 0.1).astype(np.float32)
    var = (rs.rand(c) + 0.5).astype(np.float32)
    gamma = (rs.rand(c) + 0.5).astype(np.float32)
    beta = (rs.randn(c) * 0.1).astype(np.float32)
    return x, r, mean, var, gamma, beta


def _t(arrays, dtype=None, **kw):
    out = [torch.from_numpy(a).to(**kw) for a in arrays]
    if dtype is not None:
        out[0], out[1] = out[0].to(dtype), out[1].to(dtype)
    return out


#: (x, res) dtypes of the mixed calls
MIXES = [(torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
MIX_IDS = ["x-bf16-res-f32", "x-f32-res-bf16"]


#: (x, res) dtype pairs holding f16 (C9)
F16_MIXES = [(torch.float16, torch.float16), (torch.float16, torch.float32),
             (torch.float32, torch.float16)]
F16_IDS = ["f16", "x-f16-res-f32", "x-f32-res-f16"]


def _mixed(arrays, mix, **kw):
    out = _t(arrays, **kw)
    out[0], out[1] = out[0].to(mix[0]), out[1].to(mix[1])
    return out


class TestForward:
    def test_matches_composed_ops(self):
        from deeplearning4j_tpu.ops.residual_tail_pallas import (
            _ref_formula, bn_relu_residual)

        args = _inputs()
        got = rt.bn_relu_residual(*_t(args)).numpy()
        np.testing.assert_allclose(got, np.asarray(_ref_formula(*args, 1e-5)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(bn_relu_residual(*args)),
                                   rtol=1e-6, atol=1e-6)

    def test_kernel_interpret_matches(self):
        """The Pallas body itself (interpreted), not the off-TPU formula."""
        from deeplearning4j_tpu.ops.residual_tail_pallas import _tail_kernel

        x, r, mean, var, gamma, beta = _inputs(seed=1)
        c = x.shape[-1]
        want = _tail_kernel(x.reshape(-1, c), r.reshape(-1, c), mean, var,
                            gamma, beta, 1e-5, interpret=True)
        got = rt.bn_relu_residual(*_t((x, r, mean, var, gamma, beta)))
        np.testing.assert_allclose(got.numpy().reshape(-1, c),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_bf16_io(self):
        import jax.numpy as jnp

        from deeplearning4j_tpu.ops.residual_tail_pallas import (
            bn_relu_residual)

        args = _inputs(seed=2)
        got = rt.bn_relu_residual(*_t(args, torch.bfloat16))
        assert got.dtype == torch.bfloat16
        jargs = [jnp.asarray(a, jnp.bfloat16) if i < 2 else jnp.asarray(a)
                 for i, a in enumerate(args)]
        want = np.asarray(bn_relu_residual(*jargs), np.float32)
        gotf = got.float().numpy()
        # the same f32 value rounded once to bf16 on both sides
        np.testing.assert_allclose(gotf, want,
                                   atol=2 ** -8 * float(np.abs(want).max()))

    @pytest.mark.parametrize("mix", MIXES, ids=MIX_IDS)
    def test_mixed_dtypes_match_jax(self, mix):
        """x and res in different dtypes: each is widened to f32 before
        the arithmetic and the result takes x's dtype, as ``_ref_formula``,
        the off-TPU ``bn_relu_residual`` and the Pallas body (interpreted)
        compute it."""
        import jax.numpy as jnp

        from deeplearning4j_tpu.ops.residual_tail_pallas import (
            _ref_formula, _tail_kernel, bn_relu_residual)

        jt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
        args = _inputs(seed=11)
        c = args[0].shape[-1]
        jx = jnp.asarray(args[0]).astype(jt[mix[0]])
        jr = jnp.asarray(args[1]).astype(jt[mix[1]])
        got = rt.bn_relu_residual(*_mixed(args, mix))
        assert got.dtype == mix[0]
        gotf = got.float().numpy()
        for want in (_ref_formula(jx, jr, *args[2:], 1e-5),
                     bn_relu_residual(jx, jr, *args[2:]),
                     _tail_kernel(jx.reshape(-1, c), jr.reshape(-1, c),
                                  *args[2:], 1e-5,
                                  interpret=True).reshape(jx.shape)):
            assert want.dtype == jt[mix[0]]
            np.testing.assert_allclose(gotf, np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("mix", F16_MIXES, ids=F16_IDS)
    def test_f16_matches_jax(self, mix):
        """f16 x or res (C9): widened to f32 for the arithmetic, the result
        in x's dtype, as ``_ref_formula``, the off-TPU ``bn_relu_residual``
        and the Pallas body (interpreted) compute it: within one rounding
        of x's dtype (2^-10 of the largest value at f16, 1e-6 at f32)."""
        import jax.numpy as jnp

        from deeplearning4j_tpu.ops.residual_tail_pallas import (
            _ref_formula, _tail_kernel, bn_relu_residual)

        jt = {torch.float32: jnp.float32, torch.float16: jnp.float16}
        args = _inputs(seed=13)
        c = args[0].shape[-1]
        jx = jnp.asarray(args[0]).astype(jt[mix[0]])
        jr = jnp.asarray(args[1]).astype(jt[mix[1]])
        got = get_op("bn_relu_residual")(*_mixed(args, mix))
        assert got.dtype == mix[0]
        gotf = got.float().numpy()
        for want in (_ref_formula(jx, jr, *args[2:], 1e-5),
                     bn_relu_residual(jx, jr, *args[2:]),
                     _tail_kernel(jx.reshape(-1, c), jr.reshape(-1, c),
                                  *args[2:], 1e-5,
                                  interpret=True).reshape(jx.shape)):
            assert want.dtype == jt[mix[0]]
            want = np.asarray(want, np.float32)
            tol = 1e-6 if mix[0] == torch.float32 else \
                2 ** -10 * float(np.abs(want).max())
            np.testing.assert_allclose(gotf, want, rtol=0, atol=tol)

    def test_eps_is_passed_through(self):
        from deeplearning4j_tpu.ops.residual_tail_pallas import _ref_formula

        args = _inputs(seed=6, c=8)
        got = rt.bn_relu_residual(*_t(args), eps=0.5).numpy()
        np.testing.assert_allclose(got, np.asarray(_ref_formula(*args, 0.5)),
                                   rtol=1e-6, atol=1e-6)


class TestGradients:
    def test_grads_match_autodiff_of_composition(self):
        """All six gradients, through the port's autograd Function, against
        ``jax.grad`` through the reference's custom VJP."""
        import jax
        import jax.numpy as jnp

        from deeplearning4j_tpu.ops.residual_tail_pallas import (
            bn_relu_residual)

        args = _inputs(seed=3)
        want = jax.grad(lambda *a: jnp.sum(bn_relu_residual(*a) ** 2),
                        argnums=tuple(range(6)))(*args)
        leaves = [t.requires_grad_(True) for t in _t(args)]
        (rt.bn_relu_residual(*leaves) ** 2).sum().backward()
        for leaf, w in zip(leaves, want):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)

    def test_batch_stats_chain_flows(self):
        """mean and var computed from x (training-mode BN): the Function
        does not cut the statistics' chain."""
        import jax
        import jax.numpy as jnp

        from deeplearning4j_tpu.ops.residual_tail_pallas import (
            bn_relu_residual)

        x, r, _, _, gamma, beta = _inputs(seed=4)

        def full(x_):
            mean = jnp.mean(x_, (0, 1, 2))
            var = jnp.var(x_, (0, 1, 2))
            return jnp.sum(bn_relu_residual(x_, r, mean, var, gamma,
                                            beta) ** 2)

        want = jax.grad(full)(x)
        xt = torch.from_numpy(x).requires_grad_(True)
        mean = xt.mean((0, 1, 2))
        var = xt.var((0, 1, 2), correction=0)
        out = rt.bn_relu_residual(xt, *_t((r,)), mean, var,
                                  *_t((gamma, beta)))
        (out ** 2).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


class TestRegistryDispatch:
    def test_op_registry_name(self):
        from deeplearning4j_tpu.ops.registry import get_op as jax_get_op

        args = _inputs(seed=5)
        want = np.asarray(jax_get_op("bn_relu_residual")(*args))
        got = get_op("bn_relu_residual")(*_t(args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        via = Nd4j.exec("bn_relu_residual",
                        *(Nd4j.create(a, device="cpu") for a in args))
        np.testing.assert_array_equal(via.numpy(), got)

    def test_cpu_path_launches_nothing(self):
        before = rt.launches
        rt.bn_relu_residual(*_t(_inputs(seed=7, c=4)))
        assert rt.launches == before

    def test_kernel_wrapper_refuses_what_it_does_not_take(self):
        args = _t(_inputs(seed=8, c=4))
        with pytest.raises(ValueError, match="CUDA"):
            rt.residual_tail_kernel(*args)
        # mixed f32 / bf16 x and res, and f16, pass the dtype check
        # (refused for the device here); f64 does not
        with pytest.raises(ValueError, match="CUDA"):
            rt.residual_tail_kernel(*_mixed(_inputs(seed=8, c=4), MIXES[0]))
        with pytest.raises(ValueError, match="CUDA"):
            rt.residual_tail_kernel(*_mixed(_inputs(seed=8, c=4),
                                            (torch.float32, torch.float16)))
        with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
            rt.residual_tail_kernel(*_mixed(_inputs(seed=8, c=4),
                                            (torch.float32, torch.float64)))
        with pytest.raises(ValueError, match="cpu or cuda"):
            rt.bn_relu_residual(*(a.to("meta") for a in args))


# ---------------------------------------------------------------- on the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


CARD_SHAPES = [(2, 4, 4, 128), (2, 3, 5, 3), (1, 7, 7, 2048), (4, 14, 14, 1024),
               (1, 1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(shape, dtype):
    _need_card()
    n, h, w, c = shape
    args = _t(_inputs(seed=c, n=n, h=h, w=w, c=c), dtype, device="cuda")
    before = rt.launches
    got = rt.residual_tail_kernel(*args)
    want = rt.residual_tail_reference(*args)
    torch.cuda.synchronize()
    assert rt.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    tol = 1e-5 if dtype == torch.float32 else \
        2 ** -8 * float(want.float().abs().max())
    assert err <= tol, f"{err:.3e} > {tol:.3e}"


@pytest.mark.cuda
def test_cuda_unaligned_views_take_the_element_path():
    """x and res one element into their storage (not 16-byte aligned, and
    C = 128 is a multiple of the vector width): same values."""
    _need_card()
    x, r, mean, var, gamma, beta = _t(_inputs(seed=9), device="cuda")
    xs = torch.cat([torch.zeros(1, device="cuda"), x.reshape(-1)])[1:]
    rs = torch.cat([torch.zeros(1, device="cuda"), r.reshape(-1)])[1:]
    got = rt.residual_tail_kernel(xs.view(x.shape), rs.view(r.shape), mean,
                                  var, gamma, beta)
    want = rt.residual_tail_reference(x, r, mean, var, gamma, beta)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_autograd_matches_plain_formula():
    """Six gradients through the kernel's autograd Function on the card
    equal autograd of the plain formula on the same inputs."""
    _need_card()
    args = _t(_inputs(seed=10), device="cuda")
    a = [t.clone().requires_grad_(True) for t in args]
    b = [t.clone().requires_grad_(True) for t in args]
    before = rt.launches
    (rt.bn_relu_residual(*a) ** 2).sum().backward()
    assert rt.launches == before + 1
    (rt.residual_tail_reference(*b) ** 2).sum().backward()
    for ga, gb in zip(a, b):
        scale = float(gb.grad.abs().max())
        assert float((ga.grad - gb.grad).abs().max()) <= 1e-5 * scale


#: the four residual joins of ResNet-50 (H, W, C) at batch 8, and ragged C
#: (not a multiple of the 8- or 4-channel groups: the scalar kernel)
JOIN_SHAPES = [(8, 56, 56, 256), (8, 28, 28, 512), (8, 14, 14, 1024),
               (8, 7, 7, 2048), (8, 7, 7, 2050), (3, 5, 5, 12)]
ALL_DTYPES = [(torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16)] + MIXES
ALL_IDS = ["f32", "bf16"] + MIX_IDS


@pytest.mark.cuda
@pytest.mark.parametrize("shape", JOIN_SHAPES)
@pytest.mark.parametrize("mix", ALL_DTYPES, ids=ALL_IDS)
def test_cuda_kernel_at_the_joins(shape, mix):
    """The kernel at the four join shapes and at ragged C, in f32, bf16
    and both mixes, against the plain version at f32 on the same values:
    f32 x within 1e-5, bf16 x within one bf16 rounding (2^-8 of the
    largest output); the output in x's dtype. Two calls are bit-equal."""
    _need_card()
    n, h, w, c = shape
    args = _mixed(_inputs(seed=c + h, n=n, h=h, w=w, c=c), mix,
                  device="cuda")
    before = rt.launches
    got = rt.residual_tail_kernel(*args)
    again = rt.residual_tail_kernel(*args)
    want = rt.residual_tail_reference(args[0].float(), args[1].float(),
                                      *args[2:])
    torch.cuda.synchronize()
    assert rt.launches == before + 2
    assert got.dtype == mix[0] and got.shape == want.shape
    assert torch.equal(got, again)
    err = float((got.float() - want).abs().max())
    tol = 1e-5 if mix[0] == torch.float32 else \
        2 ** -8 * float(want.abs().max())
    assert err <= tol, f"{err:.3e} > {tol:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("mix", MIXES, ids=MIX_IDS)
def test_cuda_mixed_dtypes_by_name(mix):
    """``bn_relu_residual`` by name on the card takes x and res in
    different dtypes (the plain version and the JAX package take them)
    and launches the kernel: the output in x's dtype, as the plain
    version's."""
    _need_card()
    args = _mixed(_inputs(seed=12), mix, device="cuda")
    before = rt.launches
    got = Nd4j.exec("bn_relu_residual", *args)
    want = rt.residual_tail_reference(*args)
    want32 = rt.residual_tail_reference(args[0].float(), args[1].float(),
                                        *args[2:])
    torch.cuda.synchronize()
    assert rt.launches == before + 1
    assert got.dtype == want.dtype == mix[0]
    tol = 1e-5 if mix[0] == torch.float32 else \
        2 ** -8 * float(want32.abs().max())
    assert float((got.float() - want32).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("mix", F16_MIXES, ids=F16_IDS)
def test_cuda_f16_by_name(mix):
    """f16 x or res by name on the card (C9): the kernel's f32 instance
    over widened copies, the output in x's dtype, within one rounding of
    it (2^-10 of the largest value at f16, 1e-5 at f32) of the plain
    version at f32 on the same values; one launch."""
    _need_card()
    args = _mixed(_inputs(seed=14), mix, device="cuda")
    before = rt.launches
    got = Nd4j.exec("bn_relu_residual", *args)
    want32 = rt.residual_tail_reference(args[0].float(), args[1].float(),
                                        *args[2:])
    torch.cuda.synchronize()
    assert rt.launches == before + 1
    assert got.dtype == mix[0]
    tol = 1e-5 if mix[0] == torch.float32 else \
        2 ** -10 * float(want32.abs().max())
    assert float((got.float() - want32).abs().max()) <= tol
