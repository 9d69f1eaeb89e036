"""PyTorch port, image ops and layers: ``deeplearning4j_tpu_torch``'s
``ops.nn`` convolution, pools and training batch norm, the image layers,
``Nesterovs`` and ``zoo.LeNet`` through ``MultiLayerNetwork``, against the
JAX package's on the same numpy inputs (the JAX network's weights carried
across through its ModelSerializer zip, never re-initialised).

Tolerances, each beside its assert:

- f32 convolutions, pools and layers: 1e-5 of max(1, max |out|) (sums of
  up to 7 x 7 x 3 products in another order);
- bf16 convolutions: two bf16 roundings of the largest output, 2^-6 of
  max |y| (both frameworks round an f32 accumulation to bf16, and the
  bias add rounds again, where XLA may keep the excess precision);
- batch norm at f32: y within 4 f32 ulps of max |x * scale| (y is the
  difference of two terms that large); the statistics within 1e-6 of
  max(1, max |stat|); gradients within 2e-6 x (1 + |mean| / spread) of
  max |grad| (each rounding of a term as large as the mean is amplified
  by mean / spread in the result);
- batch norm at bf16: y and the statistics within one bf16 rounding
  (2^-8 relative); gradients within 4 bf16 rounding units (2^-8) of the
  sums they come from (max |dx| at f32 for x; sum |dy * xhat| for gamma;
  sum |dy| for beta): each framework rounds the bf16 sums at other points;
- LeNet's losses 1e-5 relative and parameters 1e-5 absolute after three
  Adam steps (epsilon 1e-4: see the test) or Nesterovs steps; Nesterovs'
  updates and state 1e-6 of max(1, max |value|).

The cuda-marked tests at the end hold the card (cuDNN and the library's
pools, TF32 off) against the CPU at f32 on the same inputs and import no
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_cnn.py``.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer, DenseLayer, InputType, MultiLayerConfiguration,
    NeuralNetConfiguration, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.ndarray import Nd4j
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.registry import get_op
from deeplearning4j_tpu_torch.params import mln_params_from_numpy
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
from deeplearning4j_tpu_torch.zoo import LeNet

F32_TOL, BF16_CONV_TOL = 1e-5, 2.0 ** -6
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, want, tol, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _jax_bf16(a):
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.bfloat16)


def _torch(a, dtype):
    """The same values on the torch side: bf16 by the f32 values of the
    JAX bf16 array, so both hold the same bits."""
    return torch.from_numpy(_f32(a)).to(dtype)


# ------------------------------------------------------------ conv2d (CPU)
CONV_PADDINGS = {"SAME": "SAME", "VALID": "VALID", "sym1": 1,
                 "pairs": ((1, 2), (0, 1))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("pad", list(CONV_PADDINGS))
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_conv2d_matches_jax(k, stride, pad, size, bias, dtype):
    from deeplearning4j_tpu.ops import nn as jn

    rs = np.random.RandomState(k * 100 + stride * 10 + size)
    x = rs.randn(2, size, size + 1, 3).astype(np.float32)
    w = (rs.randn(k, k, 3, 4) / k).astype(np.float32)
    b = rs.randn(4).astype(np.float32) if bias else None
    padding = CONV_PADDINGS[pad]
    if dtype == "bfloat16":
        jx, jw = _jax_bf16(x), _jax_bf16(w)
        jb = _jax_bf16(b) if bias else None
    else:
        jx, jw, jb = x, w, b
    want = jn.conv2d(jx, jw, jb, strides=stride, padding=padding)
    td = getattr(torch, dtype)
    got = get_op("conv2d")(_torch(jx, td), _torch(jw, td),
                           None if b is None else _torch(jb, td),
                           strides=stride, padding=padding)
    assert got.dtype == td
    _close(got, want, F32_TOL if dtype == "float32" else BF16_CONV_TOL,
           "conv2d")


def test_grouped_dilated_conv_matches_jax():
    from deeplearning4j_tpu.ops import nn as jn

    rs = np.random.RandomState(3)
    x = rs.randn(2, 9, 9, 4).astype(np.float32)
    w = rs.randn(3, 3, 2, 6).astype(np.float32)
    want = jn.conv2d(x, w, strides=2, padding="SAME", dilation=2, groups=2)
    got = get_op("conv2d")(torch.from_numpy(x), torch.from_numpy(w),
                           strides=2, padding="SAME", dilation=2, groups=2)
    _close(got, want, F32_TOL, "grouped dilated conv2d")


# ---------------------------------------------------------------- pools
@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("pad", ["SAME", "VALID", 1], ids=str)
@pytest.mark.parametrize("ks", [(2, 2), (3, 2), (3, 1)], ids=str)
@pytest.mark.parametrize("op", ["maxpool2d", "avgpool2d", "sumpool2d",
                                "pnormpool2d"])
def test_pool_matches_jax(op, ks, pad, size):
    from deeplearning4j_tpu.ops import nn as jn

    k, s = ks
    x = np.random.RandomState(size + k).randn(2, size, size + 1,
                                              3).astype(np.float32)
    want = getattr(jn, op)(x, k, s, pad)
    got = get_op(op)(torch.from_numpy(x), k, s, pad)
    _close(got, want, F32_TOL, op)


#: integer pools by name (C8): op, padding
INT_POOLS = [(op, pad) for op in ("maxpool2d", "avgpool2d", "sumpool2d",
                                  "pnormpool2d")
             for pad in ("SAME", "VALID")]


@pytest.mark.parametrize("op, pad", INT_POOLS,
                         ids=[f"{o}-{p}" for o, p in INT_POOLS])
def test_int_pools_match_jax(op, pad):
    """int32 NHWC input (C8): the result dtype is the JAX op's (int32 for
    max and sum pools, float32 for average and p-norm); integer results
    equal JAX's exactly (the sums are exact), float32 ones within one
    f32 rounding (2^-23 relative: XLA may take a division by a constant
    as a product with its reciprocal, and ``** 0.5`` as a square root)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops import nn as jn

    x = np.random.RandomState(3).randint(-50, 50, (2, 7, 8, 3)).astype(
        np.int32)
    want = getattr(jn, op)(jnp.asarray(x), 3, 2, pad)
    got = Nd4j.exec(op, torch.from_numpy(x), 3, 2, pad)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if got.is_floating_point():
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2.0 ** -23, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int_global_avg_pool_matches_jax():
    """int32 (C8): a float32 mean, within one f32 rounding of JAX's (XLA
    divides by the count as a product with its reciprocal)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops import nn as jn

    x = np.random.RandomState(4).randint(-50, 50, (3, 4, 5, 6)).astype(
        np.int32)
    want = jn.global_avg_pool(jnp.asarray(x))
    got = get_op("global_avg_pool")(torch.from_numpy(x))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.0 ** -23,
                               atol=0)


def test_stem_pads_match_jax():
    """The stem's 7x7/2 conv and 3x3/2 max pool at the tests' 32 x 32
    input pad (2, 3) and (0, 1): odd totals, the odd pixel high."""
    from deeplearning4j_tpu_torch.ops.nn import _same_pads

    assert _same_pads((32, 32), (7, 7), (2, 2)) == [(2, 3), (2, 3)]
    assert _same_pads((16, 16), (3, 3), (2, 2)) == [(0, 1), (0, 1)]
    assert _same_pads((224, 224), (7, 7), (2, 2)) == [(2, 3), (2, 3)]
    assert _same_pads((112, 112), (3, 3), (2, 2)) == [(0, 1), (0, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_avg_pool_matches_jax(dtype):
    from deeplearning4j_tpu.ops import nn as jn

    x = np.random.RandomState(5).randn(3, 4, 5, 6).astype(np.float32)
    jx = _jax_bf16(x) if dtype == "bfloat16" else x
    want = jn.global_avg_pool(jx)
    got = get_op("global_avg_pool")(_torch(jx, getattr(torch, dtype)))
    _close(got, want, F32_TOL if dtype == "float32" else 2.0 ** -8,
           "global_avg_pool")


# ---------------------------------------------------------- batch norm
#: (shape, mean, spread, dtype, gradients compared)
BN_CASES = {
    "nhwc": ((4, 5, 5, 6), 0.0, 1.0, "float32", True),
    "large_mean": ((4, 5, 5, 6), 1000.0, 1.0, "float32", True),
    "dense": ((16, 7), 3.0, 2.0, "float32", True),
    "bf16": ((4, 5, 5, 6), 0.0, 1.0, "bfloat16", True),
    # at bf16 a mean of 50 against a spread of 1 leaves the gradients to
    # bf16 rounding in either framework (x is held to 0.25); forward only
    "bf16_large_mean": ((4, 5, 5, 6), 50.0, 1.0, "bfloat16", False),
}


@pytest.mark.parametrize("case", list(BN_CASES))
def test_batch_norm_train_matches_jax(case):
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.ops import nn as jn

    shape, mean, spread, dtype, grads = BN_CASES[case]
    rs = np.random.RandomState(7)
    c = shape[-1]
    x = (rs.randn(*shape) * spread + mean).astype(np.float32)
    g = (rs.rand(c) + 0.5).astype(np.float32)
    b = rs.randn(c).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jd) for a in (x, g, b)]
    targs = [_torch(a, td).requires_grad_(True) for a in jargs]
    want = jn.batch_norm_train(*jargs)
    got = get_op("batch_norm_train")(*targs)
    assert [t.dtype for t in got] == [td] * 3

    xs = _f32(jargs[0])
    axes = tuple(range(len(shape) - 1))
    scale = np.abs(_f32(jargs[1])) / np.sqrt(xs.var(axes) + 1e-5)
    if dtype == "float32":
        y_tol = 4 * 2.0 ** -23 * float(np.abs(xs * scale).max())
        assert float(np.abs(_f32(got[0]) - _f32(want[0])).max()) <= y_tol
        _close(got[1], want[1], 1e-6, "mean")
        _close(got[2], want[2], 1e-6, "var")
    else:
        for t, w, what in zip(got, want, ("y", "mean", "var")):
            err = np.abs(_f32(t) - _f32(w))
            assert np.all(err <= 2.0 ** -8 * np.abs(_f32(w))
                          + 1e-30), what
    if not grads:
        return

    def loss(*a):
        return jnp.sum(jn.batch_norm_train(*a)[0].astype(jnp.float32) * r)

    jg = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    (got[0].float() * torch.from_numpy(r)).sum().backward()
    tg = [t.grad for t in targs]
    if dtype == "float32":
        tol = 2e-6 * (1 + abs(mean) / spread)
        for t, w, what in zip(tg, jg, ("dx", "dgamma", "dbeta")):
            err = float(np.abs(_f32(t) - _f32(w)).max())
            assert err <= tol * float(np.abs(_f32(w)).max()), (what, err)
    else:
        f32 = jax.grad(loss, argnums=(0, 1, 2))(
            *[a.astype(jnp.float32) for a in jargs])
        xhat = (xs - xs.mean(axes)) / xs.std(axes)
        sums = (float(np.abs(_f32(f32[0])).max()),
                float(np.abs(r * xhat).sum(axes).max()),
                float(np.abs(r).sum(axes).max()))
        for t, w, s, what in zip(tg, jg, sums, ("dx", "dgamma", "dbeta")):
            err = float(np.abs(_f32(t) - _f32(w)).max())
            assert err <= 4 * 2.0 ** -8 * s, (what, err, s)


# ---------------------------------------------------------------- layers
def _layer_pair(jlayer):
    """The port's layer from the JAX layer's JSON."""
    from deeplearning4j_tpu.common import serde as jserde
    return jlayer, serde.from_json(jserde.to_json(jlayer))


def _layer_cases():
    from deeplearning4j_tpu.nn.conf import layers as jl

    return {
        "conv_same": lambda: jl.ConvolutionLayer(
            n_in=3, n_out=5, kernel_size=(3, 3), stride=(2, 2),
            convolution_mode="Same", activation="relu"),
        "conv_truncate": lambda: jl.ConvolutionLayer(
            n_in=3, n_out=4, kernel_size=(3, 2), padding=(1, 0),
            activation="identity", has_bias=False, weight_init="relu"),
        "pool_max_same": lambda: jl.SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode="Same"),
        "pool_avg_pad": lambda: jl.SubsamplingLayer(
            pooling_type="avg", kernel_size=(3, 3), stride=(1, 1),
            padding=(1, 1)),
        "pool_sum": lambda: jl.SubsamplingLayer(pooling_type="sum"),
        "pool_pnorm": lambda: jl.SubsamplingLayer(pooling_type="pnorm",
                                                  pnorm=3),
        "zero_pad": lambda: jl.ZeroPaddingLayer(pad=(1, 2)),
        "global_avg": lambda: jl.GlobalPoolingLayer(pooling_type="avg"),
        "global_max": lambda: jl.GlobalPoolingLayer(pooling_type="max"),
        "global_sum": lambda: jl.GlobalPoolingLayer(pooling_type="sum"),
        "global_pnorm": lambda: jl.GlobalPoolingLayer(pooling_type="pnorm"),
        "batch_norm_relu": lambda: jl.BatchNormalization(activation="relu"),
        "batch_norm": lambda: jl.BatchNormalization(decay=0.7, eps=1e-3),
        "activation": lambda: jl.ActivationLayer(activation="relu"),
    }


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("case", ["conv_same", "conv_truncate",
                                  "pool_max_same", "pool_avg_pad",
                                  "pool_sum", "pool_pnorm", "zero_pad",
                                  "global_avg", "global_max", "global_sum",
                                  "global_pnorm", "batch_norm_relu",
                                  "batch_norm", "activation"])
def test_layer_apply_matches_jax(case, train):
    import jax
    from deeplearning4j_tpu.nn.conf import InputType as JaxInputType

    jlayer, layer = _layer_pair(_layer_cases()[case]())
    assert type(layer).__name__ == type(jlayer).__name__
    it = JaxInputType.convolutional(7, 8, 3)
    jp = jlayer.init_params(jax.random.key(0), it, np.float32)
    js = jlayer.init_state(it, np.float32)
    rs = np.random.RandomState(11)
    if js:      # a running state that has moved, so inference uses it
        js = {"mean": rs.randn(3).astype(np.float32),
              "var": (rs.rand(3) + 0.5).astype(np.float32)}
    x = (rs.randn(4, 7, 8, 3) + 0.5).astype(np.float32)
    to_t = lambda tree: {k: torch.from_numpy(np.array(v))
                         for k, v in tree.items()}
    want, wstate = jlayer.apply(jp, js, x, train, None)
    got, gstate = layer.apply(to_t(jp), to_t(js), torch.from_numpy(x),
                              train, None)
    _close(got, want, F32_TOL, case)
    assert tuple(layer.output_type(InputType.convolutional(7, 8, 3))
                 .example_shape()) == tuple(got.shape[1:])
    assert sorted(gstate) == sorted(wstate)
    for k in wstate:
        _close(gstate[k], wstate[k], F32_TOL, f"{case} state {k}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_batch_norm_layer_matches_jax_bit_for_bit(seed):
    """A training step of a bf16 ``BatchNormalization`` on the same bf16
    input, parameters and running state: the output and the new running
    state equal JAX's bit for bit. JAX takes the decay (a Python float)
    beside a bf16 array as a bf16 value; kept at f32 instead, a third of
    the 64 channels' new state differs by one bf16 ulp."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.conf import layers as jl

    jlayer, layer = _layer_pair(jl.BatchNormalization(activation="relu"))
    rs = np.random.RandomState(seed)
    c = 64
    x = _jax_bf16(rs.randn(8, 5, 5, c) * 2 + 3)
    jp = {"gamma": _jax_bf16(rs.rand(c) + 0.5), "beta": _jax_bf16(rs.randn(c))}
    js = {"mean": _jax_bf16(rs.randn(c)), "var": _jax_bf16(rs.rand(c) + 0.5)}
    to_t = lambda tree: {k: _torch(v, torch.bfloat16) for k, v in
                         tree.items()}
    want, wstate = jlayer.apply(jp, js, x, True, None)
    got, gstate = layer.apply(to_t(jp), to_t(js), _torch(x, torch.bfloat16),
                              True, None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    for k in ("mean", "var"):
        assert gstate[k].dtype == torch.bfloat16 and wstate[k].dtype \
            == jnp.bfloat16
        np.testing.assert_array_equal(_f32(gstate[k]), _f32(wstate[k]), k)


def _set_fused(jax_on: bool, port_on: bool):
    """Set ``FUSED_BN_RELU_BWD`` in the JAX package and the port; returns
    the pair it replaced."""
    from deeplearning4j_tpu.ops import nn as jn
    from deeplearning4j_tpu_torch.ops import nn as tn

    prev = (jn.FUSED_BN_RELU_BWD, tn.FUSED_BN_RELU_BWD)
    jn.FUSED_BN_RELU_BWD, tn.FUSED_BN_RELU_BWD = jax_on, port_on
    return prev


def test_fused_bn_relu_layer_matches_jax(monkeypatch):
    """``BatchNormalization(activation="relu")`` with
    ``FUSED_BN_RELU_BWD`` on in both packages takes
    ``batch_norm_relu_train`` in both; the output, the running state and
    the gradients of ``sum(out * r)`` for x, gamma and beta follow JAX's
    within the batch norm's f32 tolerances (module docstring; mean 0.5,
    spread 1)."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.ops import nn as jn
    from deeplearning4j_tpu_torch.ops import nn as tn

    calls = []
    for mod, tag in ((jn, "jax"), (tn, "port")):
        fn = mod.batch_norm_relu_train
        monkeypatch.setattr(mod, "batch_norm_relu_train",
                            lambda *a, _f=fn, _t=tag, **k: calls.append(_t)
                            or _f(*a, **k))
    prev = _set_fused(True, True)
    try:
        jlayer, layer = _layer_pair(jl.BatchNormalization(activation="relu"))
        rs = np.random.RandomState(8)
        c = 6
        x = (rs.randn(4, 5, 5, c) + 0.5).astype(np.float32)
        r = rs.randn(4, 5, 5, c).astype(np.float32)
        jp = {"gamma": (rs.rand(c) + 0.5).astype(np.float32),
              "beta": rs.randn(c).astype(np.float32)}
        js = {"mean": rs.randn(c).astype(np.float32),
              "var": (rs.rand(c) + 0.5).astype(np.float32)}

        def jloss(x, p):
            out, state = jlayer.apply(p, js, x, True, None)
            return jnp.sum(out * r), (out, state)

        (_, (want, wstate)), (jgx, jgp) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(x, jp)
        tx = torch.from_numpy(x).requires_grad_(True)
        tp = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in jp.items()}
        got, gstate = layer.apply(tp, {k: torch.from_numpy(v) for k, v in
                                       js.items()}, tx, True, None)
        (got * torch.from_numpy(r)).sum().backward()
    finally:
        _set_fused(*prev)
    assert calls == ["jax", "port"]
    _close(got, want, F32_TOL, "out")
    for k in wstate:
        _close(gstate[k], wstate[k], 1e-6, f"state {k}")
    for t, w, what in ((tx.grad, jgx, "dx"), (tp["gamma"].grad,
                                               jgp["gamma"], "dgamma"),
                       (tp["beta"].grad, jgp["beta"], "dbeta")):
        err = float(np.abs(_f32(t) - _f32(w)).max())
        assert err <= 2e-6 * 1.5 * float(np.abs(_f32(w)).max()), (what, err)


def test_masked_global_pooling_names_its_roadmap_item():
    """Masked global pooling is ported now: each pooling type over the
    real steps of a sequence (a row with an interior gap, a row of one
    step) equals the JAX layer's ``apply_masked``."""
    from deeplearning4j_tpu.nn.conf import GlobalPoolingLayer as JGlobal
    from deeplearning4j_tpu_torch.nn.conf import GlobalPoolingLayer

    rs = np.random.RandomState(4)
    x = rs.randn(3, 5, 4).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 0, 1, 1, 0], [1, 0, 0, 0, 0]],
                    np.float32)
    for pt in ("max", "avg", "sum", "pnorm"):
        want, _ = JGlobal(pooling_type=pt).apply_masked({}, {}, x, mask,
                                                        False, None)
        got, _ = GlobalPoolingLayer(pooling_type=pt).apply_masked(
            {}, {}, torch.from_numpy(x), torch.from_numpy(mask), False, None)
        _close(got, want, 1e-6, pt)


# -------------------------------------------------------------- updater
def test_nesterovs_matches_jax_over_five_steps():
    from deeplearning4j_tpu.learning import Nesterovs as JaxNesterovs
    from deeplearning4j_tpu.learning.updaters import (
        apply_updater as jax_apply)
    from deeplearning4j_tpu_torch.learning.updaters import apply_updater

    rs = np.random.RandomState(2)
    params = {"W": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(4).astype(np.float32)}
    ju, tu = JaxNesterovs(0.05, 0.9), Nesterovs(0.05, 0.9)
    assert serde.from_json(
        __import__("deeplearning4j_tpu.common.serde",
                   fromlist=["to_json"]).to_json(ju)) == tu
    jstate = ju.init_state(params)
    tstate = tu.init_state({k: torch.from_numpy(v)
                            for k, v in params.items()})
    for step in range(5):
        grads = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        jup, jstate = jax_apply(ju, jstate, grads, params, step)
        tup, tstate = apply_updater(
            tu, tstate, {k: torch.from_numpy(v) for k, v in grads.items()},
            {k: torch.from_numpy(v) for k, v in params.items()}, step)
        for k in params:
            _close(tup[k], jup[k], 1e-6, f"update {k} step {step}")
            _close(tstate["v"][k], jstate["v"][k], 1e-6, f"v {k}")


# ----------------------------------------------------------------- LeNet
def _lenet_batch(n=6, hw=12, classes=3, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, hw, hw, 1).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)]


def test_lenet_conf_matches_jax():
    from deeplearning4j_tpu.zoo.lenet import LeNet as JaxLeNet

    conf = LeNet().conf()
    assert conf.to_json() == JaxLeNet().conf().to_json()
    assert conf.preprocessors == {4: "flatten"}
    net = LeNet().init(device="cpu")
    # 5x5x1x20 + 20, 5x5x20x50 + 50, 7*7*50 x 500 + 500, 500 x 10 + 10
    assert net.numParams() == 520 + 25050 + 1225500 + 5010


@pytest.mark.parametrize("updater", ["adam", "nesterovs"])
def test_lenet_trajectory_from_a_jax_zip(tmp_path, updater):
    """LeNet(num_classes=3, in_shape=(12, 12, 1)) written by the JAX
    ModelSerializer, restored by the port; three steps on one batch on
    each side. Adam keeps LeNet's default rate (1e-3) with epsilon 1e-4:
    an Adam update moves by up to lr / epsilon times its gradient's
    rounding difference, 1e5 at the default 1e-8, where a dense weight's
    gradient cancels to ~1e-8 (an input that ReLU and pooling leave near
    zero); at 1e-4 that factor is 10, so 1e-5 holds every parameter."""
    import jax
    from deeplearning4j_tpu.learning import Adam as JaxAdam
    from deeplearning4j_tpu.learning import Nesterovs as JaxNesterovs
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer
    from deeplearning4j_tpu.zoo.lenet import LeNet as JaxLeNet

    upd = (JaxAdam(1e-3, epsilon=1e-4) if updater == "adam"
           else JaxNesterovs(0.01, 0.9))
    jnet = JaxLeNet(num_classes=3, in_shape=(12, 12, 1), updater=upd).init()
    path = os.path.join(tmp_path, "lenet.zip")
    JaxSerializer.writeModel(jnet, path, save_updater=True)
    net = ModelSerializer.restoreMultiLayerNetwork(path, load_updater=True,
                                                   device="cpu")
    assert net.conf.preprocessors == {4: "flatten"}
    x, y = _lenet_batch()
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        lj, lt = float(jnet.score()), net.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    for i, (p, q) in enumerate(zip(net.params_list,
                                   jax.device_get(jnet.params_list))):
        assert sorted(p) == sorted(q)
        for k in q:
            np.testing.assert_allclose(_f32(p[k]), np.asarray(q[k]),
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"layer {i} {k}")
    _close(net.output(x), np.asarray(jnet.output(x).jax), F32_TOL, "output")


def test_flat_image_input_reshapes_like_jax():
    """``InputType.convolutionalFlat`` input: a ``to_conv`` preprocessor
    before the conv, a ``flatten`` before the dense head; the same tags,
    JSON and training as the JAX network."""
    import jax
    from deeplearning4j_tpu.learning import Sgd as JaxSgd
    from deeplearning4j_tpu.nn.conf import (
        ConvolutionLayer as JConv, InputType as JIt, NeuralNetConfiguration
        as JNNC, OutputLayer as JOut, SubsamplingLayer as JSub)
    from deeplearning4j_tpu.nn.multilayer.network import (
        MultiLayerNetwork as JaxMLN)
    from deeplearning4j_tpu_torch.learning.updaters import Sgd

    def build(nnc, conv, sub, out, it, sgd):
        return (nnc.builder().seed(5).updater(sgd(0.1)).list()
                .layer(conv(n_out=4, kernel_size=(3, 3), activation="relu"))
                .layer(sub(pooling_type="avg"))
                .layer(out(n_out=2, activation="softmax", loss="mcxent"))
                .setInputType(it.convolutionalFlat(6, 6, 2)).build())

    conf = build(NeuralNetConfiguration, ConvolutionLayer, SubsamplingLayer,
                 OutputLayer, InputType, Sgd)
    jconf = build(JNNC, JConv, JSub, JOut, JIt, JaxSgd)
    assert conf.to_json() == jconf.to_json()
    assert conf.preprocessors == {0: "to_conv:6,6,2", 2: "flatten"}
    jnet = JaxMLN(jconf).init()
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.params_list = mln_params_from_numpy(jax.device_get(jnet.params_list),
                                            device="cpu")
    rs = np.random.RandomState(4)
    x = rs.randn(5, 72).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 5)]
    for _ in range(2):
        jnet.fit(x, y)
        net.fit(x, y)
        assert abs(net.score() - float(jnet.score())) <= LOSS_RTOL * abs(
            float(jnet.score()))
    _close(net.output(x), np.asarray(jnet.output(x).jax), F32_TOL, "output")


def test_image_layer_on_dense_input_is_refused():
    with pytest.raises(ValueError, match="image input"):
        (NeuralNetConfiguration.builder().list()
         .layer(ConvolutionLayer(n_out=2))
         .setInputType(InputType.feedForward(4)).build())


def test_lenet_conf_round_trips_through_json():
    conf = LeNet(num_classes=3, in_shape=(12, 12, 1)).conf()
    back = MultiLayerConfiguration.from_json(conf.to_json())
    assert back == conf and back.layers[0].kernel_size == (5, 5)
    assert isinstance(back.layers[4], DenseLayer) and back.layers[4].n_in \
        == 3 * 3 * 50


# ------------------------------------------------------- on the card only
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    # full f32 on the card: cuDNN would take TF32 for f32 convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _card_vs_cpu(fn, arrays, device, tol):
    """``fn`` forward and backward (of sum(out * r)) on the card and on
    the CPU from the same arrays: outputs and gradients within ``tol`` of
    max(1, max |value|)."""
    res = []
    for dev in (device, "cpu"):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True)
              for a in arrays]
        out = fn(*ts)
        r = torch.from_numpy(np.random.RandomState(9).randn(
            *out.shape).astype(np.float32)).to(dev)
        (out * r).sum().backward()
        res.append([out] + [t.grad for t in ts])
    for i, (a, b) in enumerate(zip(*res)):
        _close(a, b, tol, f"value {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("pad", ["SAME", "VALID"])
@pytest.mark.parametrize("k,s", [(1, 2), (3, 1), (7, 2)])
def test_conv2d_card_matches_cpu(card, k, s, pad):
    rs = np.random.RandomState(k)
    x = rs.randn(4, 32, 32, 16).astype(np.float32)
    w = (rs.randn(k, k, 16, 32) / k).astype(np.float32)
    _card_vs_cpu(lambda x, w: get_op("conv2d")(x, w, strides=s,
                                               padding=pad), (x, w), card,
                 F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", ["SAME", "VALID"])
@pytest.mark.parametrize("op", ["maxpool2d", "avgpool2d", "sumpool2d",
                                "pnormpool2d"])
def test_pool_card_matches_cpu(card, op, pad):
    x = np.random.RandomState(1).randn(4, 17, 16, 8).astype(np.float32)
    _card_vs_cpu(lambda x: get_op(op)(x, 3, 2, pad), (x,), card, F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mean", [0.0, 100.0])
def test_batch_norm_train_card_matches_cpu(card, mean):
    rs = np.random.RandomState(2)
    x = (rs.randn(8, 14, 14, 32) + mean).astype(np.float32)
    g = (rs.rand(32) + 0.5).astype(np.float32)
    b = rs.randn(32).astype(np.float32)
    _card_vs_cpu(lambda x, g, b: get_op("batch_norm_train")(x, g, b)[0],
                 (x, g, b), card, 1e-4 * (1 + mean))


@pytest.mark.cuda
def test_cut_resnet_card_matches_cpu(card):
    """The cut ResNet of tests/test_torch_graph.py (built by the port's
    own builder), three Nesterovs steps on the card against the CPU from
    one numpy tree: losses 1e-5 relative, parameters and BN running state
    1e-5 absolute."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.params import cg_params_from_numpy
    from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

    conf = cut_resnet_conf()
    tree = {n: {k: v.numpy() for k, v in p.items()} for n, p in
            ComputationGraph(conf, device="cpu").init().params_map.items()}
    rs = np.random.RandomState(0)
    x = rs.randn(6, 32, 32, 3).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 6)]
    runs = []
    for dev in (card, "cpu"):
        g = ComputationGraph(conf, device=dev).init()
        g.params_map = cg_params_from_numpy(conf.nodes, tree, device=dev)
        losses = []
        for _ in range(3):
            g.fit(x, y)
            losses.append(g.score())
        runs.append((losses, g))
    (lc, gc), (lh, gh) = runs
    for a, b in zip(lc, lh):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (lc, lh)
    for tree_c, tree_h in ((gc.params_map, gh.params_map),
                           (gc.states_map, gh.states_map)):
        for n in tree_h:
            for k in tree_h[n]:
                _close(tree_c[n][k], tree_h[n][k], 1e-5, f"{n}/{k}")


@pytest.mark.cuda
@pytest.mark.parametrize("op, pad", INT_POOLS,
                         ids=[f"{o}-{p}" for o, p in INT_POOLS])
def test_int_pools_card_matches_cpu(card, op, pad):
    """int32 pools on the card (C8): the CPU's dtype and values (integer
    results exactly, float32 ones within one f32 rounding)."""
    x = torch.from_numpy(np.random.RandomState(6).randint(
        -50, 50, (4, 17, 16, 8)).astype(np.int32))
    got = get_op(op)(x.to(card), 3, 2, pad).cpu()
    want = get_op(op)(x, 3, 2, pad)
    assert got.dtype == want.dtype
    if want.is_floating_point():
        torch.testing.assert_close(got, want, rtol=2.0 ** -23, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_bn_relu_layer_card_matches_cpu(card):
    """The fused layer on the card runs the batch-norm kernels (one
    statistics, one apply and one backward launch) and matches the CPU
    at f32: output, running state and gradients within 1e-5 of max(1,
    |value|)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.ops import batch_norm as bn
    from deeplearning4j_tpu_torch.ops import nn as tn

    rs = np.random.RandomState(9)
    c = 32
    arrays = [(rs.randn(8, 14, 14, c) + 0.5).astype(np.float32),
              (rs.rand(c) + 0.5).astype(np.float32),
              rs.randn(c).astype(np.float32)]
    r = rs.randn(8, 14, 14, c).astype(np.float32)
    layer = BatchNormalization(activation="relu")
    prev = tn.FUSED_BN_RELU_BWD
    tn.FUSED_BN_RELU_BWD = True
    res = []
    try:
        for dev in (card, "cpu"):
            x, g, b = (torch.from_numpy(a).to(dev).requires_grad_(True)
                       for a in arrays)
            state = {"mean": torch.zeros(c, device=dev),
                     "var": torch.ones(c, device=dev)}
            before = (bn.stats_launches, bn.apply_launches, bn.bwd_launches)
            out, st = layer.apply({"gamma": g, "beta": b}, state, x, True,
                                  None)
            (out * torch.from_numpy(r).to(dev)).sum().backward()
            launched = tuple(a - p for a, p in zip(
                (bn.stats_launches, bn.apply_launches, bn.bwd_launches),
                before))
            assert launched == ((1, 1, 1) if dev == card else (0, 0, 0))
            res.append([out, st["mean"], st["var"], x.grad, g.grad, b.grad])
    finally:
        tn.FUSED_BN_RELU_BWD = prev
    for i, (a, w) in enumerate(zip(*res)):
        _close(a, w, 1e-5, f"value {i}")
