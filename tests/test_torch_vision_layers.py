"""PyTorch port, the image ops and layers of the vision zoo: ``ops/nn.py``
``depthwise_conv2d``, ``separable_conv2d`` and ``upsampling2d``,
``ops/shape.py`` ``space_to_depth`` / ``depth_to_space``, and the layers
``SeparableConvolution2D``, ``Upsampling2D`` (``nn/conf/layers.py``),
``DepthwiseConvolution2D`` and ``SpaceToDepthLayer``
(``nn/conf/layers_extra.py``), against the JAX package's on the same
numpy inputs and weights at f32: values and the gradients of a weighted
sum with respect to the input and every weight, over strides 1 and 2,
SAME and Truncate padding, depth multipliers 1 and 2 and odd sizes; the
layers' ``output_type`` against JAX's and the shapes they give; their
parameter names and shapes; the JAX configuration JSON read in.

Tolerances: convolutions 1e-5 of max(1, max |value|) (sums of up to 5 x
5 x 6 products in another order); the layout ops bit for bit, values and
gradients (permutations); the upsampling's values bit for bit (copies)
and its gradient, a sum of up to nine terms in another order, within
1e-5.

The cuda-marked tests at the end hold the card (cuDNN, TF32 off)
against the CPU at f32 and import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_vision_layers.py``.
"""

import numpy as np
import pytest
import torch

try:  # the JAX package is the CPU tests' reference; the card's machine
    #   has none, and runs only this file's cuda tests
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.conf import InputType as JIT
    from deeplearning4j_tpu.nn.conf import layers as jlayers
    from deeplearning4j_tpu.nn.conf import layers_extra as jextra
    from deeplearning4j_tpu.ops import nn as jnn
    from deeplearning4j_tpu.ops import shape as jshape
except ModuleNotFoundError:
    jax = None

from deeplearning4j_tpu_torch.nn.conf import (
    DepthwiseConvolution2D, InputType, MultiLayerConfiguration,
    SeparableConvolution2D, SpaceToDepthLayer, Upsampling2D)
from deeplearning4j_tpu_torch.ops import nn as tnn
from deeplearning4j_tpu_torch.ops import shape as tshape

TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _pair(fn, jfn, arrays, tol=TOL):
    """``fn`` (torch) and ``jfn`` (JAX) on the same arrays: the values and
    the gradients of ``sum(out * r)`` with respect to every array."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    r = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)), ts)

    def f(*a):
        o = jfn(*a)
        return jnp.sum(o * r), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(arrays))), has_aux=True))(
        *[jnp.asarray(a) for a in arrays])
    _close(out, jout, tol, "value")
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        _close(g, jg, tol, f"gradient {i}")


# ------------------------------------------------------------------- ops
#: (input H, W, C, kernel, stride, padding, multiplier, dilation)
DW_CASES = [(9, 9, 4, 3, 1, "SAME", 1, 1), (9, 7, 4, 3, 2, "SAME", 2, 1),
            (10, 10, 3, 3, 2, "SAME", 1, 1), (11, 11, 5, 5, 2, "SAME", 2, 1),
            (8, 9, 4, 3, 1, "VALID", 2, 1), (9, 9, 3, 3, 2, 1, 1, 1),
            (12, 12, 4, 3, 1, "SAME", 1, 2), (7, 7, 6, 1, 2, "SAME", 2, 1)]


def _dw_arrays(h, w, c, k, mult, bias, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, h, w, c).astype(np.float32)
    dw = (rs.randn(k, k, c, mult) / k).astype(np.float32)
    b = rs.randn(c * mult).astype(np.float32) if bias else None
    return x, dw, b


@pytest.mark.parametrize("case", DW_CASES, ids=[str(c) for c in DW_CASES])
def test_depthwise_conv2d_matches_jax(case):
    h, w, c, k, s, pad, mult, d = case
    x, dw, b = _dw_arrays(h, w, c, k, mult, bias=True)
    _pair(lambda x, dw, b: tnn.depthwise_conv2d(x, dw, b, s, pad, d),
          lambda x, dw, b: jnn.depthwise_conv2d(x, dw, b, s, pad, d),
          [x, dw, b])


def test_depthwise_channel_order_is_c_times_mult_plus_m():
    """Output channel ``c * mult + m`` is input channel ``c`` under
    multiplier ``m`` (XLA's feature grouping)."""
    x = np.zeros((1, 3, 3, 2), np.float32)
    x[0, 1, 1] = [1.0, 10.0]
    dw = np.zeros((1, 1, 2, 3), np.float32)
    dw[0, 0, 0] = [1, 2, 3]
    dw[0, 0, 1] = [4, 5, 6]
    out = tnn.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(dw))
    assert out[0, 1, 1].tolist() == [1.0, 2.0, 3.0, 40.0, 50.0, 60.0]


@pytest.mark.parametrize("case", DW_CASES[:6], ids=[str(c)
                                                    for c in DW_CASES[:6]])
def test_separable_conv2d_matches_jax(case):
    h, w, c, k, s, pad, mult, d = case
    x, dw, b = _dw_arrays(h, w, c, k, mult, bias=True, seed=1)
    pw = np.random.RandomState(2).randn(1, 1, c * mult, 5).astype(
        np.float32) / c
    b = np.random.RandomState(3).randn(5).astype(np.float32)
    _pair(lambda x, dw, pw, b: tnn.separable_conv2d(x, dw, pw, b, s, pad, d),
          lambda x, dw, pw, b: jnn.separable_conv2d(x, dw, pw, b, s, pad, d),
          [x, dw, pw, b])


@pytest.mark.parametrize("scale", [2, 3, (2, 3)])
def test_upsampling2d_matches_jax(scale):
    x = np.random.RandomState(4).randn(2, 3, 5, 4).astype(np.float32)
    _pair(lambda x: tnn.upsampling2d(x, scale),
          lambda x: jnn.upsampling2d(x, scale), [x])
    np.testing.assert_array_equal(
        tnn.upsampling2d(torch.from_numpy(x), scale).numpy(),
        np.asarray(jnn.upsampling2d(jnp.asarray(x), scale)))


@pytest.mark.parametrize("b, hw, c", [(2, 6, 3), (2, 26, 64), (3, 9, 2)])
def test_space_and_depth_match_jax(b, hw, c):
    x = np.random.RandomState(5).randn(2, hw, hw + b, c).astype(np.float32)
    _pair(lambda x: tshape.space_to_depth(x, b),
          lambda x: jshape.space_to_depth(x, b), [x], tol=0.0)
    y = np.random.RandomState(6).randn(2, 3, 4, c * b * b).astype(np.float32)
    _pair(lambda y: tshape.depth_to_space(y, b),
          lambda y: jshape.depth_to_space(y, b), [y], tol=0.0)
    back = tshape.depth_to_space(tshape.space_to_depth(torch.from_numpy(x),
                                                       b), b)
    assert torch.equal(back, torch.from_numpy(x))


# ---------------------------------------------------------------- layers
def _layers(kind, **kw):
    """The port's and the JAX package's layer of one class, same fields."""
    jmod = jextra if kind in ("DepthwiseConvolution2D",
                              "SpaceToDepthLayer") else jlayers
    port = {"SeparableConvolution2D": SeparableConvolution2D,
            "DepthwiseConvolution2D": DepthwiseConvolution2D,
            "Upsampling2D": Upsampling2D,
            "SpaceToDepthLayer": SpaceToDepthLayer}[kind]
    return port(**kw), getattr(jmod, kind)(**kw)


LAYER_CASES = [
    ("SeparableConvolution2D", dict(n_in=4, n_out=6, kernel_size=(3, 3),
                                    stride=(2, 2), convolution_mode="Same",
                                    depth_multiplier=2, activation="relu"),
     (9, 9, 4)),
    ("SeparableConvolution2D", dict(n_in=3, n_out=5, kernel_size=(5, 5),
                                    stride=(1, 1), convolution_mode="Truncate",
                                    padding=(1, 1), has_bias=False),
     (11, 10, 3)),
    ("SeparableConvolution2D", dict(n_in=3, n_out=4, kernel_size=(3, 3),
                                    stride=(2, 2), convolution_mode="Truncate",
                                    activation="leakyrelu"), (10, 9, 3)),
    ("DepthwiseConvolution2D", dict(n_in=4, kernel_size=(3, 3),
                                    stride=(2, 2), convolution_mode="Same",
                                    depth_multiplier=2), (9, 8, 4)),
    ("DepthwiseConvolution2D", dict(n_in=3, kernel_size=(3, 3),
                                    convolution_mode="Truncate",
                                    padding=(1, 1), activation="tanh"),
     (7, 7, 3)),
    ("Upsampling2D", dict(size=2), (3, 5, 4)),
    ("Upsampling2D", dict(size=3), (4, 4, 2)),
    ("SpaceToDepthLayer", dict(block_size=2), (6, 8, 3)),
]


@pytest.mark.parametrize("kind, kw, shape", LAYER_CASES,
                         ids=[f"{k}-{i}" for i, (k, _, _) in
                              enumerate(LAYER_CASES)])
def test_layer_matches_jax(kind, kw, shape):
    layer, jlayer = _layers(kind, **kw)
    h, w, c = shape
    it, jit = InputType.convolutional(h, w, c), JIT.convolutional(h, w, c)
    jp = jax.device_get(jlayer.init_params(jax.random.key(0), jit,
                                           jnp.float32))
    p = layer.init_params(torch.Generator().manual_seed(0), it,
                          torch.float32, "cpu")
    assert sorted(p) == sorted(jp)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    names = sorted(jp)
    rs = np.random.RandomState(7)
    x = rs.randn(2, h, w, c).astype(np.float32)
    arrays = [x] + [rs.randn(*np.shape(jp[k])).astype(np.float32)
                    for k in names]

    def port(x, *ps):
        return layer.apply(dict(zip(names, ps)), {}, x, False, None)[0]

    def ref(x, *ps):
        return jlayer.apply(dict(zip(names, ps)), {}, x, False, None)[0]

    _pair(port, ref, arrays)
    out_t, jout_t = layer.output_type(it), jlayer.output_type(jit)
    assert (out_t.height, out_t.width, out_t.channels) == \
        (jout_t.height, jout_t.width, jout_t.channels)
    y = port(torch.from_numpy(x), *[torch.from_numpy(a)
                                    for a in arrays[1:]])
    assert tuple(y.shape) == (2, out_t.height, out_t.width, out_t.channels)


@pytest.mark.parametrize("kind", ["SeparableConvolution2D",
                                  "DepthwiseConvolution2D", "Upsampling2D",
                                  "SpaceToDepthLayer"])
def test_json_written_by_jax_reads_in(kind):
    """A JAX network holding the layer reads into the port with the same
    JSON, and ``n_in`` inferred alike."""
    from deeplearning4j_tpu.nn.conf import (
        ConvolutionLayer as JConv, NeuralNetConfiguration as JNNC,
        OutputLayer as JOut)

    extra = {"SeparableConvolution2D": dict(n_out=6, kernel_size=(3, 3),
                                            depth_multiplier=2,
                                            convolution_mode="Same"),
             "DepthwiseConvolution2D": dict(kernel_size=(3, 3),
                                            depth_multiplier=3),
             "Upsampling2D": dict(size=2),
             "SpaceToDepthLayer": dict(block_size=2)}[kind]
    jmod = jextra if kind in ("DepthwiseConvolution2D",
                              "SpaceToDepthLayer") else jlayers
    jconf = (JNNC.builder().seed(3).list()
             .layer(JConv(n_out=4, kernel_size=(3, 3), activation="relu"))
             .layer(getattr(jmod, kind)(**extra))
             .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
             .setInputType(JIT.convolutional(10, 10, 2)).build())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert type(conf.layers[1]).__name__ == kind
    assert conf.to_json() == jconf.to_json()


def test_builder_takes_the_new_image_layers():
    """Upsampling2D and SpaceToDepthLayer are image layers to the builder:
    a flat image before one gets the ``to_conv`` preprocessor."""
    from deeplearning4j_tpu_torch.nn.conf import (NeuralNetConfiguration,
                                                  OutputLayer)

    for layer in (Upsampling2D(size=2), SpaceToDepthLayer(block_size=2)):
        conf = (NeuralNetConfiguration.builder().list().layer(layer)
                .layer(OutputLayer(n_out=2))
                .setInputType(InputType.convolutionalFlat(4, 4, 1)).build())
        assert conf.preprocessors[0] == "to_conv:4,4,1"


# ---------------------------------------------------------------- the card
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
    the CPU from the same arrays."""
    res = []
    for dev in (device, "cpu"):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True)
              for a in arrays]
        out = fn(*ts)
        r = torch.from_numpy(np.random.RandomState(9).randn(
            *out.shape).astype(np.float32)).to(dev)
        grads = torch.autograd.grad(torch.sum(out * r), ts)
        res.append([out] + list(grads))
    for i, (a, b) in enumerate(zip(*res)):
        _close(a, b.detach().cpu().numpy(), tol, f"value {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CASES, ids=[str(c) for c in DW_CASES])
def test_cuda_depthwise_and_separable_match_the_cpu(card, case):
    h, w, c, k, s, pad, mult, d = case
    x, dw, b = _dw_arrays(h, w, c, k, mult, bias=True)
    pw = np.random.RandomState(2).randn(1, 1, c * mult, 5).astype(
        np.float32) / c
    _card_vs_cpu(lambda x, dw, b: tnn.depthwise_conv2d(x, dw, b, s, pad, d),
                 [x, dw, b], card, TOL)
    _card_vs_cpu(lambda x, dw, pw: tnn.separable_conv2d(x, dw, pw, None, s,
                                                        pad, d),
                 [x, dw, pw], card, TOL)


@pytest.mark.cuda
def test_cuda_depthwise_at_xception_width_matches_the_cpu(card):
    """The grouped convolution at Xception's middle-flow width (728
    channels, 19 x 19) and a bf16 pass: f32 within 1e-5, bf16 within two
    bf16 roundings of the largest output."""
    rs = np.random.RandomState(8)
    x = rs.randn(2, 19, 19, 728).astype(np.float32)
    dw = (rs.randn(3, 3, 728, 1) / 3).astype(np.float32)
    _card_vs_cpu(lambda x, dw: tnn.depthwise_conv2d(x, dw), [x, dw], card,
                 TOL)
    got = tnn.depthwise_conv2d(torch.from_numpy(x).to(card, torch.bfloat16),
                               torch.from_numpy(dw).to(card, torch.bfloat16))
    want = tnn.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(dw))
    _close(got.float(), want.numpy(), 2.0 ** -7, "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["upsampling2d", "space_to_depth",
                                "depth_to_space"])
def test_cuda_layout_ops_match_the_cpu(card, op):
    x = np.random.RandomState(4).randn(2, 6, 8, 12).astype(np.float32)
    fn = {"upsampling2d": lambda x: tnn.upsampling2d(x, 2),
          "space_to_depth": lambda x: tshape.space_to_depth(x, 2),
          "depth_to_space": lambda x: tshape.depth_to_space(x, 2)}[op]
    # permutations are exact both ways; the upsampling's gradient sums
    # four terms in the card's order
    _card_vs_cpu(fn, [x], card, TOL if op == "upsampling2d" else 0.0)
    out = fn(torch.from_numpy(x).to(card)).cpu()
    assert torch.equal(out, fn(torch.from_numpy(x)))
