"""PyTorch port, conv + BN-stats ops (B4a ``conv1x1_bn_stats``, B4b
``conv3x3_bn_stats``): ``deeplearning4j_tpu_torch/ops/conv_bn_stats.py``
against ``deeplearning4j_tpu/ops/conv_pallas.py`` on the same numpy
inputs.

The JAX side runs as its own tests run it off the TPU: the Pallas bodies
through the interpreter (``interpret=True``, and the registered ops,
which pick interpret mode off the TPU). The port's side runs its plain
versions (the CPU path). Tolerances at f32: 1e-5 for y and the means
(different summation orders over at most a few hundred products), 1e-4
relative for the single-pass variances (``E[acc^2] - E[acc]^2`` loses
digits to cancellation where the mean is large against the spread).

The CUDA kernel runs only on the card: its tests carry the ``cuda``
marker, skip without one and import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_conv_bn_stats.py``.
There the kernel is held against the plain version at f32 (TF32 off) on
the same inputs: y within 2e-5 of max |y| (up to 4,608 f32 products per
output, summed in another order), means within 1e-5 of max |y|, variances
within 1e-4 of max E[y^2]; bf16 inputs against the plain version's f32
product of the same bf16 values, y within one bf16 rounding (2^-8 of
max |y|), the statistics as at f32 (both come from f32 accumulators).
Those tolerances hold every route: the tensor-core route (``"tc"``) at
every ResNet-50 stride-1 conv class and at ragged row counts, the first
bf16 design (``"wmma"``) at the odd shapes it still takes, and the f32
route, which also takes mixed bf16 / f32 inputs.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ndarray import Nd4j
from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
from deeplearning4j_tpu_torch.ops.registry import get_op


def _case(shape, cout, seed, k=1, scale=0.2, mean_shift=0.0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) + mean_shift).astype(np.float32)
    cin = shape[-1]
    wshape = (cin, cout) if k == 1 else (3, 3, cin, cout)
    w = (rs.randn(*wshape) * scale).astype(np.float32)
    return x, w


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _port(fn, x, w, **kw):
    y, m, v = fn(torch.from_numpy(x), torch.from_numpy(w), **kw)
    assert m.dtype == torch.float32 and v.dtype == torch.float32
    return y.numpy(), m.numpy(), v.numpy()


# --------------------------------------------------------- plain vs JAX (CPU)
def test_conv1x1_matches_jax_interpret():
    from deeplearning4j_tpu.ops.conv_pallas import conv1x1_bn_stats

    x, w = _case((2, 8, 8, 16), 32, seed=1)
    want = conv1x1_bn_stats(x, w, bm=32, bn=16, interpret=True)
    got = _port(cb.conv1x1_bn_stats, x, w, bm=32, bn=16)
    assert got[0].shape == (2, 8, 8, 32)
    _close(got[0], want[0], 1e-5, what="y")
    _close(got[1], want[1], 1e-5, what="mean")
    _close(got[2], want[2], 1e-5, 1e-4, what="var")


def test_nondivisible_rows_pick_exact_blocks():
    """rows = 2*7*7 = 98: the reference falls back to a divisor block, the
    port masks its ragged tile; both give the stats of all 98 rows."""
    from deeplearning4j_tpu.ops.conv_pallas import conv1x1_bn_stats

    x, w = _case((2, 7, 7, 8), 24, seed=2)
    want = conv1x1_bn_stats(x, w, bm=64, bn=16, interpret=True)
    got = _port(cb.conv1x1_bn_stats, x, w, bm=64, bn=16)
    ref = np.einsum("nhwc,cd->nhwd", x.astype(np.float64), w)
    _close(got[1], ref.mean((0, 1, 2)), 1e-5, what="mean vs f64")
    for a, b, tol in zip(got, want, (1e-5, 1e-5, 1e-5)):
        _close(a, b, tol, 1e-4)


@pytest.mark.parametrize("bm, bn", [(512, 256), (64, 16), (7, 5)])
def test_block_caps_change_nothing(bm, bn):
    x, w = _case((2, 7, 7, 8), 24, seed=3)
    base = _port(cb.conv1x1_bn_stats, x, w)
    got = _port(cb.conv1x1_bn_stats, x, w, bm=bm, bn=bn)
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)


def test_conv1x1_takes_rows_by_cin():
    from deeplearning4j_tpu.ops.conv_pallas import conv1x1_bn_stats

    x, w = _case((50, 12), 20, seed=4)
    want = conv1x1_bn_stats(x, w, bm=16, bn=8, interpret=True)
    got = _port(cb.conv1x1_bn_stats, x, w)
    assert got[0].shape == (50, 20)
    for a, b in zip(got, want):
        _close(a, b, 1e-5, 1e-4)


def test_conv3x3_matches_jax_interpret():
    from deeplearning4j_tpu.ops.conv_pallas import conv3x3_bn_stats

    x, w = _case((3, 8, 8, 4), 8, seed=5, k=3)
    want = conv3x3_bn_stats(x, w, interpret=True)
    got = _port(cb.conv3x3_bn_stats, x, w)
    assert got[0].shape == (3, 8, 8, 8)
    _close(got[0], want[0], 1e-5, what="y")
    _close(got[1], want[1], 1e-5, what="mean")
    _close(got[2], want[2], 1e-5, 1e-4, what="var")


def test_image_isolation():
    """Image i's conv does not see image i+1's rows."""
    rs = np.random.RandomState(6)
    x1 = rs.randn(1, 4, 4, 2).astype(np.float32)
    x2 = rs.randn(1, 4, 4, 2).astype(np.float32)
    w = (rs.randn(3, 3, 2, 4) * 0.3).astype(np.float32)
    pair = _port(cb.conv3x3_bn_stats, np.concatenate([x1, x2]), w)[0]
    solo = _port(cb.conv3x3_bn_stats, x1, w)[0]
    _close(pair[0], solo[0], 1e-6)


@pytest.mark.parametrize("name, k", [("conv1x1_bn_stats", 1),
                                     ("conv3x3_bn_stats", 3)])
def test_registry_names_match_jax(name, k):
    from deeplearning4j_tpu.ops.registry import get_op as jax_get_op

    x, w = _case((1, 4, 4, 8), 8, seed=7, k=k)
    want = jax_get_op(name)(x, w)
    got = get_op(name)(torch.from_numpy(x), torch.from_numpy(w))
    via_exec = Nd4j.exec(name, Nd4j.create(x, device="cpu"),
                         Nd4j.create(w, device="cpu"))
    for a, b, c in zip(got, want, via_exec):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b, 1e-5, 1e-4)
        np.testing.assert_array_equal(a.numpy(), c.numpy())


@pytest.mark.parametrize("shape, raises", [
    ((1, 224, 224, 64), True),     # stem-scale image: outside
    ((1, 112, 112, 256), True),
    ((1, 56, 56, 64), False),      # the ResNet-50 3x3 shapes: inside
    ((1, 7, 7, 512), False)])
def test_vmem_envelope_guard(shape, raises):
    """The reference's guard, the same ValueError for the same shapes."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.conv_pallas import conv3x3_bn_stats

    cin = shape[-1]
    xj = jnp.zeros(shape, jnp.bfloat16)
    wj = jnp.zeros((3, 3, cin, cin), jnp.bfloat16)
    x = torch.zeros(shape, dtype=torch.bfloat16)
    w = torch.zeros((3, 3, cin, cin), dtype=torch.bfloat16)
    if raises:
        with pytest.raises(ValueError, match="envelope") as want:
            conv3x3_bn_stats(xj, wj, interpret=True)
        with pytest.raises(ValueError, match="envelope") as got:
            cb.conv3x3_bn_stats(x, w)
        assert str(got.value) == str(want.value)
    else:
        cb.check_envelope(x, w)


@pytest.mark.parametrize("k", [1, 3])
def test_bf16_io_stats_from_the_f32_accumulator(k):
    """bf16 x and w: y in bf16, the statistics from the f32 product (not
    from bf16 y), as the reference's kernels take them."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops import conv_pallas as jcp

    x, w = _case((2, 6, 6, 16), 16, seed=8, k=k)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    fn = cb.conv1x1_bn_stats if k == 1 else cb.conv3x3_bn_stats
    y, m, v = fn(xb, wb)
    assert y.dtype == torch.bfloat16
    jfn = jcp.conv1x1_bn_stats if k == 1 else jcp.conv3x3_bn_stats
    jy, jm, jv = jfn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                     interpret=True)
    yf = y.float().numpy()
    scale = float(np.abs(yf).max())
    _close(yf, np.asarray(jy, np.float32), 2 ** -8 * scale, what="y")
    _close(m.numpy(), jm, 1e-5, what="mean")
    _close(v.numpy(), jv, 1e-5, 1e-4, what="var")
    # the f32 product of the same bf16 values, not the bf16 y
    ref = fn(xb.float(), wb.float())
    _close(m.numpy(), ref[1].numpy(), 1e-6)
    _close(v.numpy(), ref[2].numpy(), 1e-6, 1e-6)


def test_single_pass_variance_is_clamped_like_the_reference():
    """A channel with a large mean and a tiny spread: E[y^2] - E[y]^2
    cancels, can fall below zero, and is clamped at 0 in both."""
    from deeplearning4j_tpu.ops.conv_pallas import conv1x1_bn_stats

    rs = np.random.RandomState(9)
    x = (1000.0 + 1e-3 * rs.randn(4, 4, 4, 8)).astype(np.float32)
    w = np.full((8, 4), 0.125, np.float32)
    want = conv1x1_bn_stats(x, w, interpret=True)
    got = _port(cb.conv1x1_bn_stats, x, w)
    assert (got[2] >= 0).all()
    _close(got[1], want[1], 1e-5, 1e-6)
    _close(got[2], want[2], 1e-1)       # both are cancellation noise of 1e6


@pytest.mark.parametrize("k", [1, 3])
def test_gradient_through_the_op_raises_as_in_the_reference(k):
    """The reference is forward-only (interpret-mode ``pallas_call`` has no
    transpose): both packages refuse a gradient through the op, and the
    port names the op."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.registry import get_op as jax_get_op

    name = "conv1x1_bn_stats" if k == 1 else "conv3x3_bn_stats"
    x, w = _case((1, 4, 4, 4), 4, seed=10, k=k)
    with pytest.raises(Exception):
        jax.grad(lambda w_: jnp.sum(jax_get_op(name)(x, w_)[0]))(
            jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    y, m, v = get_op(name)(torch.from_numpy(x), wt)
    with pytest.raises(RuntimeError, match=f"{name} is forward-only"):
        (y.sum() + m.sum() + v.sum()).backward()
    assert wt.grad is None


def test_cpu_path_launches_nothing():
    before = (cb.launches_1x1, cb.launches_3x3)
    x, w = _case((1, 4, 4, 4), 4, seed=11, k=3)
    cb.conv3x3_bn_stats(torch.from_numpy(x), torch.from_numpy(w))
    cb.conv1x1_bn_stats(torch.from_numpy(x), torch.from_numpy(w[0, 0]))
    assert (cb.launches_1x1, cb.launches_3x3) == before


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    x, w = _case((1, 4, 4, 4), 4, seed=12)
    with pytest.raises(ValueError, match="CUDA"):
        cb.conv_bn_stats_kernel(torch.from_numpy(x), torch.from_numpy(w), 1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cb.conv1x1_bn_stats(torch.zeros(2, 4, device="meta"),
                            torch.zeros(4, 4, device="meta"))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("xdt, wdt", [("bfloat16", "float32"),
                                      ("float32", "bfloat16")])
def test_mixed_dtypes_match_jax_interpret(k, xdt, wdt):
    """x and w of different dtypes: the reference multiplies at f32
    (``preferred_element_type=f32`` over the promoted operands) and casts y
    to x's dtype; the port's plain version does the same."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops import conv_pallas as jcp

    x, w = _case((2, 6, 6, 16), 8, seed=16, k=k)
    xt = torch.from_numpy(x).to(getattr(torch, xdt))
    wt = torch.from_numpy(w).to(getattr(torch, wdt))
    fn = cb.conv1x1_bn_stats if k == 1 else cb.conv3x3_bn_stats
    y, m, v = fn(xt, wt)
    assert y.dtype == xt.dtype
    jfn = jcp.conv1x1_bn_stats if k == 1 else jcp.conv3x3_bn_stats
    jy, jm, jv = jfn(jnp.asarray(xt.float().numpy(), getattr(jnp, xdt)),
                     jnp.asarray(wt.float().numpy(), getattr(jnp, wdt)),
                     interpret=True)
    assert str(jy.dtype) == xdt
    yf = y.float().numpy()
    scale = float(np.abs(yf).max())
    tol = 2 ** -8 * scale if xdt == "bfloat16" else 1e-5
    _close(yf, np.asarray(jy, np.float32), tol, what="y")
    _close(m.numpy(), jm, 1e-5, what="mean")
    _close(v.numpy(), jv, 1e-5, 1e-4, what="var")


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("xdt, wdt", [("float16", "float16"),
                                      ("float16", "float32")])
def test_f16_matches_jax_interpret(k, xdt, wdt):
    """f16 (C9): the reference's f32 product of the f16 values, y cast to
    x's dtype; the port's plain version the same: y within one f16
    rounding (2^-10 of max |y|), the f32 statistics as at f32."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops import conv_pallas as jcp

    x, w = _case((2, 6, 6, 16), 8, seed=26, k=k)
    xt = torch.from_numpy(x).to(getattr(torch, xdt))
    wt = torch.from_numpy(w).to(getattr(torch, wdt))
    y, m, v = get_op("conv1x1_bn_stats" if k == 1 else "conv3x3_bn_stats")(
        xt, wt)
    assert y.dtype == xt.dtype
    jfn = jcp.conv1x1_bn_stats if k == 1 else jcp.conv3x3_bn_stats
    jy, jm, jv = jfn(jnp.asarray(xt.float().numpy(), getattr(jnp, xdt)),
                     jnp.asarray(wt.float().numpy(), getattr(jnp, wdt)),
                     interpret=True)
    assert str(jy.dtype) == xdt
    yf = y.float().numpy()
    _close(yf, np.asarray(jy, np.float32), 2 ** -10 * float(np.abs(yf).max()),
           what="y")
    _close(m.numpy(), jm, 1e-5, what="mean")
    _close(v.numpy(), jv, 1e-5, 1e-4, what="var")


def _bf16(shape):
    return torch.empty(shape, dtype=torch.bfloat16)


#: (x shape, w shape, taps, the route the kernel takes)
ROUTE_CASES = [
    ((2, 56, 56, 64), (64, 256), 1, "tc"),
    ((130, 16), (16, 72), 1, "tc"),           # K and Cout not tile multiples
    ((2, 7, 7, 8), (8, 24), 1, "tc"),
    ((2, 14, 14, 64), (3, 3, 64, 64), 9, "tc"),
    ((2, 7, 7, 8), (3, 3, 8, 8), 9, "wmma"),   # Cin not a multiple of 64
    ((1, 4, 4, 72), (3, 3, 72, 8), 9, "wmma"),
    ((3, 5, 5, 3), (3, 5), 1, "wmma"),         # Cin not a multiple of 8
    ((2, 7, 7, 64), (64, 5), 1, "wmma"),       # Cout not a multiple of 8
]


@pytest.mark.parametrize("xs, ws, taps, route", ROUTE_CASES)
def test_kernel_route_by_shape(xs, ws, taps, route):
    assert cb.kernel_route(_bf16(xs), _bf16(ws), taps) == route


@pytest.mark.parametrize("xdt, wdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.float16, torch.float16)])
def test_kernel_route_f32_and_mixed_dtypes(xdt, wdt):
    x = torch.empty((2, 56, 56, 64), dtype=xdt)
    w = torch.empty((64, 256), dtype=wdt)
    assert cb.kernel_route(x, w, 1) == "f32"


def test_kernel_route_needs_16_byte_alignment():
    """A view that starts 2 bytes into its storage keeps the first bf16
    design (16-byte copies need aligned rows)."""
    base = _bf16(2 * 7 * 7 * 64 + 1)
    x = base[1:].view(2, 7, 7, 64)
    w = _bf16((64, 64))
    assert x.data_ptr() % 16 != 0
    assert cb.kernel_route(x, w, 1) == "wmma"
    assert cb.kernel_route(x.clone(), w, 1) == "tc"


#: every stride-1 conv class of ResNet-50's bottleneck stacks (the
#: benches' shapes, chip_smoke.py CONV_SHAPES), at N=2
RESNET_CLASSES = [
    (1, 56, 64, 64), (1, 56, 64, 256), (1, 56, 256, 64), (1, 28, 512, 128),
    (1, 28, 128, 512), (1, 14, 1024, 256), (1, 14, 256, 1024),
    (1, 7, 2048, 512), (1, 7, 512, 2048),
    (3, 56, 64, 64), (3, 28, 128, 128), (3, 14, 256, 256), (3, 7, 512, 512)]


def _resnet_tensors(k, hw, cin, cout, n=2):
    xs = (n, hw, hw, cin)
    ws = (cin, cout) if k == 1 else (3, 3, cin, cout)
    return xs, ws


@pytest.mark.parametrize("k, hw, cin, cout", RESNET_CLASSES)
def test_resnet_classes_take_the_tensor_core_route(k, hw, cin, cout):
    xs, ws = _resnet_tensors(k, hw, cin, cout)
    assert cb.kernel_route(_bf16(xs), _bf16(ws), 1 if k == 1 else 9) == "tc"


# ---------------------------------------------------------------- on the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _card_check(x, w, k, dtype, route=None):
    xc = torch.from_numpy(x).cuda().to(dtype)
    wc = torch.from_numpy(w).cuda().to(dtype)
    taps = 1 if k == 1 else 9
    y, m, v = cb.conv_bn_stats_kernel(xc, wc, taps, route=route)
    ref = (cb.conv1x1_bn_stats_reference if k == 1
           else cb.conv3x3_bn_stats_reference)
    ry, rm, rv = ref(xc.float(), wc.float())
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == ry.shape
    assert bool(torch.isfinite(y).all())
    ymax = float(ry.abs().max())
    ytol = 2e-5 if dtype == torch.float32 else 2 ** -8
    assert float((y.float() - ry).abs().max()) <= ytol * ymax
    assert float((m - rm).abs().max()) <= 1e-5 * ymax
    assert float((v - rv).abs().max()) <= 1e-4 * float((rv + rm * rm).max())


CARD_1X1 = [((2, 7, 7, 8), 24), ((3, 5, 5, 3), 5), ((2, 14, 14, 64), 256),
            ((1, 7, 7, 512), 128), ((130, 16), 72)]
CARD_3X3 = [((2, 7, 7, 8), 8), ((3, 5, 6, 3), 5), ((2, 14, 14, 64), 64),
            ((1, 7, 7, 256), 256), ((1, 4, 4, 2), 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, cout", CARD_1X1)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv1x1_matches_plain(shape, cout, dtype):
    _need_card()
    _card_check(*_case(shape, cout, seed=cout), 1, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, cout", CARD_3X3)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv3x3_matches_plain(shape, cout, dtype):
    _need_card()
    _card_check(*_case(shape, cout, seed=cout, k=3), 3, dtype)


@pytest.mark.cuda
def test_cuda_ragged_rows_and_launch_counts():
    """rows = 98 (a ragged last tile of 34 rows) through the registered ops:
    each call launches once, and the stats are those of all 98 rows."""
    _need_card()
    x, w = _case((2, 7, 7, 8), 24, seed=13)
    before = (cb.launches_1x1, cb.launches_3x3)
    y, m, v = Nd4j.exec("conv1x1_bn_stats", torch.from_numpy(x).cuda(),
                        torch.from_numpy(w).cuda(), bm=64, bn=16)
    x3, w3 = _case((2, 7, 7, 8), 8, seed=14, k=3)
    Nd4j.exec("conv3x3_bn_stats", torch.from_numpy(x3).cuda(),
              torch.from_numpy(w3).cuda())
    assert (cb.launches_1x1, cb.launches_3x3) == (before[0] + 1,
                                                  before[1] + 1)
    ref = np.einsum("nhwc,cd->nhwd", x.astype(np.float64), w)
    np.testing.assert_allclose(m.cpu().numpy(), ref.mean((0, 1, 2)),
                               atol=1e-5)
    np.testing.assert_allclose(v.cpu().numpy(), ref.var((0, 1, 2)),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_envelope_guard_raises_before_launching():
    _need_card()
    before = cb.launches_3x3
    x = torch.zeros((1, 224, 224, 64), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((3, 3, 64, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="envelope"):
        cb.conv3x3_bn_stats(x, w)
    assert cb.launches_3x3 == before


@pytest.mark.cuda
def test_cuda_gradient_through_the_kernel_raises():
    _need_card()
    x, w = _case((1, 4, 4, 8), 8, seed=15)
    wt = torch.from_numpy(w).cuda().requires_grad_(True)
    y, _, _ = cb.conv1x1_bn_stats(torch.from_numpy(x).cuda(), wt)
    with pytest.raises(RuntimeError, match="forward-only"):
        y.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("k, hw, cin, cout", RESNET_CLASSES)
def test_cuda_resnet_classes_on_the_tensor_core_route(k, hw, cin, cout):
    """Every ResNet-50 stride-1 conv class at N=2 through the tensor-core
    route, against the f32 plain version on the same bf16 values."""
    _need_card()
    xs, ws = _resnet_tensors(k, hw, cin, cout)
    x, w = _case(xs, cout, seed=cin + cout + hw, k=k,
                 scale=float(np.sqrt(2.0 / (cin * (1 if k == 1 else 9)))))
    x = np.maximum(x, 0)
    assert cb.kernel_route(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(w).to(torch.bfloat16),
                           1 if k == 1 else 9) == "tc"
    _card_check(x, w, k, torch.bfloat16, route="tc")


@pytest.mark.cuda
@pytest.mark.parametrize("shape, cout, k", [
    ((2, 7, 7, 64), 256, 1),       # 98 rows: one ragged 128-row tile
    ((12545, 64), 64, 1),          # 98 tiles and one row
    ((2, 7, 7, 64), 64, 3),
    ((5, 13, 193, 64), 64, 3),     # 12,545 rows of 193-pixel image rows
    ((1, 3, 5, 128), 136, 3)])     # an image smaller than a tile, Cout 136
def test_cuda_ragged_rows_on_the_tensor_core_route(shape, cout, k):
    _need_card()
    x, w = _case(shape, cout, seed=17, k=k, scale=0.1)
    _card_check(x, w, k, torch.bfloat16, route="tc")


@pytest.mark.cuda
@pytest.mark.parametrize("shape, cout, k", [
    ((2, 7, 7, 8), 8, 3), ((3, 5, 6, 3), 5, 3), ((3, 5, 5, 3), 5, 1),
    ((2, 7, 7, 64), 5, 1)])
def test_cuda_odd_shapes_keep_the_first_bf16_design(shape, cout, k):
    """Shapes the tensor-core route does not take go to the first bf16
    design, by shape, and it still matches the plain version."""
    _need_card()
    x, w = _case(shape, cout, seed=18, k=k)
    xb = torch.from_numpy(x).cuda().to(torch.bfloat16)
    wb = torch.from_numpy(w).cuda().to(torch.bfloat16)
    taps = 1 if k == 1 else 9
    assert cb.kernel_route(xb, wb, taps) == "wmma"
    _card_check(x, w, k, torch.bfloat16)
    with pytest.raises(RuntimeError, match="tc route"):
        cb.conv_bn_stats_kernel(xb, wb, taps, route="tc")


@pytest.mark.cuda
@pytest.mark.parametrize("k, shape, cout", [(1, (4, 56, 56, 64), 256),
                                            (3, (4, 28, 28, 128), 128)])
def test_cuda_two_calls_are_bit_equal(k, shape, cout):
    """No atomics: the persistent schedule and every sum's order depend on
    the shape and the card only."""
    _need_card()
    x, w = _case(shape, cout, seed=19, k=k, scale=0.1)
    xb = torch.from_numpy(x).cuda().to(torch.bfloat16)
    wb = torch.from_numpy(w).cuda().to(torch.bfloat16)
    taps = 1 if k == 1 else 9
    first = cb.conv_bn_stats_kernel(xb, wb, taps, route="tc")
    again = cb.conv_bn_stats_kernel(xb, wb, taps, route="tc")
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_scratch_size_comes_from_the_kernel_source():
    """The partial buffer is sized by ``dl4j_conv_bn_stats_scratch``:
    [2, row tiles of 64, Cout] on the first designs, [2, G, Cout] on the
    tensor-core route with 1 <= G <= the 128-row tiles."""
    _need_card()
    rows, cout = 802816, 256
    for route in ("f32", "wmma"):
        assert cb.scratch_floats(rows, 1, 1, 64, cout, 1, route) \
            == 2 * (rows // 64) * cout
    n = cb.scratch_floats(rows, 1, 1, 64, cout, 1, "tc")
    assert n % (2 * cout) == 0 and 2 * cout <= n <= 2 * (rows // 128) * cout
    n3 = cb.scratch_floats(98, 7, 7, 64, 64, 9, "tc")
    assert n3 == 2 * 1 * 64          # one 128-row tile: one walker
    with pytest.raises(RuntimeError, match="refused"):
        cb.scratch_floats(0, 7, 7, 64, 64, 9, "tc")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("xdt, wdt", [(torch.bfloat16, torch.float32),
                                      (torch.float32, torch.bfloat16)])
def test_cuda_mixed_dtypes_are_computed_at_f32(k, xdt, wdt):
    """bf16 x with f32 w (and the other way round): the f32 product cast to
    x's dtype, as the reference and the CPU path compute it."""
    _need_card()
    x, w = _case((2, 6, 6, 16), 24, seed=20, k=k)
    before = (cb.launches_1x1, cb.launches_3x3)
    fn = cb.conv1x1_bn_stats if k == 1 else cb.conv3x3_bn_stats
    xc = torch.from_numpy(x).cuda().to(xdt)
    wc = torch.from_numpy(w).cuda().to(wdt)
    y, m, v = fn(xc, wc)
    ry, rm, rv = fn(xc.cpu(), wc.cpu())
    torch.cuda.synchronize()
    assert y.dtype == xdt and m.dtype == torch.float32
    launched = (cb.launches_1x1 - before[0], cb.launches_3x3 - before[1])
    assert launched == ((1, 0) if k == 1 else (0, 1))
    ymax = float(ry.float().abs().max())
    ytol = 2 ** -8 if xdt == torch.bfloat16 else 2e-5
    assert float((y.cpu().float() - ry.float()).abs().max()) <= ytol * ymax
    assert float((m.cpu() - rm).abs().max()) <= 1e-5 * ymax
    assert float((v.cpu() - rv).abs().max()) \
        <= 1e-4 * float((rv + rm * rm).max())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("xdt, wdt", [(torch.float16, torch.float16),
                                      (torch.float16, torch.bfloat16)])
def test_cuda_f16_is_computed_at_f32(k, xdt, wdt):
    """f16 by name on the card (C9): the f32 route over widened copies, y
    cast to x's dtype, against the CPU path on the same values: y within
    one f16 rounding (2^-10 of max |y|), the statistics as at f32."""
    _need_card()
    x, w = _case((2, 6, 6, 64), 32, seed=27, k=k)
    before = (cb.launches_1x1, cb.launches_3x3)
    name = "conv1x1_bn_stats" if k == 1 else "conv3x3_bn_stats"
    xc = torch.from_numpy(x).cuda().to(xdt)
    wc = torch.from_numpy(w).cuda().to(wdt)
    y, m, v = Nd4j.exec(name, xc, wc)
    ry, rm, rv = get_op(name)(xc.cpu(), wc.cpu())
    torch.cuda.synchronize()
    assert y.dtype == xdt and m.dtype == torch.float32
    launched = (cb.launches_1x1 - before[0], cb.launches_3x3 - before[1])
    assert launched == ((1, 0) if k == 1 else (0, 1))
    ymax = float(ry.float().abs().max())
    assert float((y.cpu().float() - ry.float()).abs().max()) \
        <= 2 ** -10 * ymax
    assert float((m.cpu() - rm).abs().max()) <= 1e-5 * ymax
    assert float((v.cpu() - rv).abs().max()) \
        <= 1e-4 * float((rv + rm * rm).max())


def _probe_copies():
    from deeplearning4j_tpu_torch.tools import conv_probe

    return [("split", conv_probe.SPLIT)] + list(conv_probe.VARIANTS.items())


@pytest.mark.parametrize("name, subs", _probe_copies(),
                         ids=[n for n, _ in _probe_copies()])
def test_conv_probe_edits_find_their_anchors(name, subs):
    """``tools/conv_probe.py`` measures edited copies of the kernel source:
    every text substitution must still find its anchor, once."""
    from deeplearning4j_tpu_torch.ops import native

    src = open(native._source("conv_bn_stats")).read()
    for old, new in subs:
        assert old in src, f"{name}: {old!r}"
        src = src.replace(old, new)
