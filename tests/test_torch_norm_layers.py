"""PyTorch port, the layers this slice adds (``nn/conf/layers.py``):
``LayerNormalization`` and ``LocalResponseNormalization`` (through
``ops/nn.py`` ``layer_norm`` and ``local_response_normalization``),
``DropoutLayer`` and ``FlattenLayer``, and ``zoo.AlexNet``, against the
JAX package's on the same numpy inputs and weights at f32.

Tolerances: layer values and gradients 1e-6 absolute plus 1e-5 relative
(f32 formulas whose reductions and powers round in another order);
AlexNet's trajectory (input cut to 67x67x3, dropout rate 0, three
Nesterovs steps at lr 1e-4 from the JAX weights; at the zoo's 1e-2 the
random-label loss grows to 240 by the third step, and at 1e-3 it falls to
0.17, where relative differences say nothing): losses 1e-5 relative,
parameters 2e-5 absolute, outputs 2e-5 absolute (the bounds that hold
LeNet and the cut ResNet: convolutions and 4096-wide products summed in
another order). The dropout layer's draws are the distribution of
``jax.random.bernoulli``, not its bits: its test holds the kept share
and the scale.
"""

import numpy as np
import pytest
import torch

try:  # the JAX package is the CPU tests' reference; the card's machine
    #   has none, and runs only this file's cuda tests
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.conf import (
        ConvolutionLayer as JConv, DenseLayer as JDense, InputType as JIT,
        NeuralNetConfiguration as JNNC, OutputLayer as JOut)
    from deeplearning4j_tpu.nn.conf import layers as jlayers
    from deeplearning4j_tpu.nn.conf.builder import (
        MultiLayerConfiguration as JMLC)
    from deeplearning4j_tpu.nn.multilayer.network import (
        MultiLayerNetwork as JMLN)
    from deeplearning4j_tpu.zoo.alexnet import AlexNet as JAlexNet
except ModuleNotFoundError:
    jax = None

from deeplearning4j_tpu_torch.learning import Nesterovs
from deeplearning4j_tpu_torch.nn.conf import (
    DropoutLayer, FlattenLayer, InputType, LayerNormalization,
    LocalResponseNormalization, MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.params import mln_params_from_numpy
from deeplearning4j_tpu_torch.zoo import AlexNet

ATOL, RTOL = 1e-6, 1e-5
ALEX_LOSS_RTOL, ALEX_PARAM_ATOL, ALEX_OUT_ATOL = 1e-5, 2e-5, 2e-5
ALEX_SHAPE = (67, 67, 3)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _layer_pair(layer, jlayer, x, params):
    """Value and gradients (of a weighted sum, with respect to the input
    and each parameter) of one layer in both packages."""
    w = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    y, _ = layer.apply(pt, {}, xt, False, None)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)),
                                [xt] + list(pt.values()))

    def f(a, p):
        out, _ = jlayer.apply(p, {}, a, False, None)
        return jnp.sum(out * w), out

    (_, jy), jg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    _close(y.detach().numpy(), jy)
    _close(grads[0].numpy(), jg[0])
    for (k, g) in zip(pt, grads[1:]):
        _close(g.numpy(), jg[1][k])


@pytest.mark.parametrize("shape", [(5, 12), (3, 4, 12), (2, 3, 3, 12)])
def test_layer_normalization_matches_jax(shape):
    rs = np.random.RandomState(1)
    x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
    params = {"gamma": rs.randn(12).astype(np.float32),
              "beta": rs.randn(12).astype(np.float32)}
    _layer_pair(LayerNormalization(eps=1e-5),
                jlayers.LayerNormalization(eps=1e-5), x, params)


@pytest.mark.parametrize("n, k, alpha, beta", [(5, 2.0, 1e-4, 0.75),
                                                (3, 1.0, 0.5, 0.5),
                                                (7, 2.0, 1e-2, 0.75)])
def test_local_response_normalization_matches_jax(n, k, alpha, beta):
    x = (np.random.RandomState(2).randn(2, 5, 5, 12) * 4).astype(np.float32)
    kw = dict(n=n, k=k, alpha=alpha, beta=beta)
    _layer_pair(LocalResponseNormalization(**kw),
                jlayers.LocalResponseNormalization(**kw), x, {})


def test_layer_normalization_params_match_jax_init():
    it = InputType.feedForward(7)
    p = LayerNormalization().init_params(None, it, torch.float32, "cpu")
    jp = jlayers.LayerNormalization().init_params(jax.random.key(0),
                                                  JIT.feedForward(7),
                                                  jnp.float32)
    assert sorted(p) == sorted(jp) == ["beta", "gamma"]
    for key in p:
        np.testing.assert_array_equal(p[key].numpy(), np.asarray(jp[key]))


def test_dropout_layer_keeps_the_share_and_scales():
    x = torch.ones(200, 100)
    layer = DropoutLayer(rate=0.3)
    out, _ = layer.apply({}, {}, x, False, torch.Generator())
    assert torch.equal(out, x)                       # inference: identity
    out, _ = layer.apply({}, {}, x, True, None)
    assert torch.equal(out, x)                       # no generator
    out, _ = layer.apply({}, {}, x, True,
                         torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    np.testing.assert_allclose(out[kept].numpy(), 1 / 0.7, rtol=1e-6)
    out, _ = DropoutLayer(rate=0.0).apply({}, {}, x, True,
                                          torch.Generator())
    assert torch.equal(out, x)


def test_flatten_layer_matches_jax():
    x = np.random.RandomState(3).randn(2, 3, 4, 5).astype(np.float32)
    out, _ = FlattenLayer().apply({}, {}, torch.from_numpy(x), False, None)
    jout, _ = jlayers.FlattenLayer().apply({}, {}, jnp.asarray(x), False,
                                           None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert FlattenLayer().output_type(InputType.convolutional(3, 4, 5)) \
        == InputType.feedForward(60)
    with pytest.raises(ValueError, match="fixed timeseries"):
        FlattenLayer().output_type(InputType.recurrent(4))


@pytest.mark.parametrize("layer", ["DropoutLayer", "FlattenLayer",
                                   "LayerNormalization",
                                   "LocalResponseNormalization"])
def test_json_written_by_jax_reads_in(layer):
    """A JAX configuration holding the layer reads into the port under the
    same JSON names and fields, and back."""
    extra = {"DropoutLayer": dict(rate=0.25), "FlattenLayer": {},
             "LayerNormalization": dict(eps=1e-3),
             "LocalResponseNormalization": dict(n=3, k=1.5, alpha=1e-3,
                                                beta=0.5)}[layer]
    b = (JNNC.builder().seed(3).list()
         .layer(JConv(n_out=6, kernel_size=(3, 3), activation="relu")))
    b = b.layer(getattr(jlayers, layer)(**extra))
    if layer != "FlattenLayer":
        b = b.layer(JDense(n_out=5, activation="relu"))
    jconf = (b.layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
             .setInputType(JIT.convolutional(8, 8, 2)).build())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert type(conf.layers[1]).__name__ == layer
    assert conf.to_json() == jconf.to_json()
    assert JMLC.from_json(conf.to_json()) == jconf
    jnet = JMLN(jconf).init()
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.params_list = mln_params_from_numpy(jax.device_get(jnet.params_list),
                                            device="cpu")
    x = np.random.RandomState(4).randn(3, 8, 8, 2).astype(np.float32)
    _close(net.output(x).numpy(), jnet.output(x).jax)


@pytest.mark.parametrize("policy", ["mixed_bfloat16", "mixed_float16"])
def test_the_norms_are_f32_islands(policy):
    conf = AlexNet(num_classes=10, in_shape=ALEX_SHAPE).conf()
    conf.precision = policy
    net = MultiLayerNetwork(conf, device="cpu").init()
    jconf = JMLC.from_json(conf.to_json())
    jnet = JMLN(jconf).init()
    kinds = [type(l).__name__ for l in conf.layers]
    for i, kind in enumerate(kinds):
        want = torch.float32 if kind in ("LocalResponseNormalization",
                                         "OutputLayer") \
            else getattr(torch, policy[len("mixed_"):])
        assert net._compute_dtypes[i] == want, (i, kind)
        assert jnet._compute_dtypes[i].name == str(want).split(".")[1]


# ------------------------------------------------------------------ AlexNet
def test_alexnet_conf_json_and_parameters_match_jax():
    conf, jconf = AlexNet().conf(), JAlexNet().conf()
    assert conf.to_json() == jconf.to_json()
    assert [type(l).__name__ for l in conf.layers].count(
        "LocalResponseNormalization") == 2
    assert MultiLayerConfiguration.from_json(jconf.to_json()).to_json() == \
        jconf.to_json()
    net = MultiLayerNetwork(conf, device="cpu").init()
    jnet = JMLN(jconf).init()
    assert net.numParams() == jnet.numParams() == 62_378_344
    assert [sorted(p) for p in net.params_list] == \
        [sorted(p) for p in jax.device_get(jnet.params_list)]
    assert [tuple(v.shape) for p in net.params_list for v in p.values()] \
        == [tuple(np.shape(p[k])) for p in jax.device_get(jnet.params_list)
            for k in p]


def _no_dropout(conf):
    for layer in conf.layers:
        if type(layer).__name__ == "DropoutLayer":
            layer.rate = 0.0
    return conf


def test_reduced_alexnet_trajectory_matches_jax():
    conf = _no_dropout(AlexNet(num_classes=10, in_shape=ALEX_SHAPE,
                               updater=Nesterovs(1e-4, 0.9)).conf())
    jnet = JMLN(JMLC.from_json(conf.to_json())).init()
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.params_list = mln_params_from_numpy(jax.device_get(jnet.params_list),
                                            device="cpu")
    rs = np.random.RandomState(5)
    x = rs.randn(4, *ALEX_SHAPE).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 4)]
    _close(net.output(x).numpy(), jnet.output(x).jax, atol=ALEX_OUT_ATOL,
           rtol=0)
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        lj = float(jnet.score())
        assert abs(net.score() - lj) <= ALEX_LOSS_RTOL * abs(lj)
    assert net.getIterationCount() == jnet.getIterationCount() == 3
    want = jax.device_get(jnet.params_list)
    for i, (p, q) in enumerate(zip(net.params_list, want)):
        for k in p:
            _close(p[k].numpy(), q[k], atol=ALEX_PARAM_ATOL, rtol=0)
    _close(net.output(x).numpy(), jnet.output(x).jax, atol=ALEX_OUT_ATOL,
           rtol=0)


def test_alexnet_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zoo = AlexNet(num_classes=10, in_shape=ALEX_SHAPE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init()
    assert zoo.init(device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------- the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["LayerNormalization",
                                   "LocalResponseNormalization"])
def test_cuda_norm_layer_matches_the_cpu(layer):
    _needs_card()
    rs = np.random.RandomState(6)
    x = (rs.randn(8, 13, 13, 96) * 4).astype(np.float32)
    lay = (LayerNormalization() if layer == "LayerNormalization"
           else LocalResponseNormalization())
    params = ({"gamma": rs.randn(96).astype(np.float32),
               "beta": rs.randn(96).astype(np.float32)}
              if layer == "LayerNormalization" else {})
    w = rs.randn(*x.shape).astype(np.float32)
    out = []
    for dev in ("cuda", "cpu"):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        p = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        y, _ = lay.apply(p, {}, xt, False, None)
        (g,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(w).to(dev)),
                                   xt)
        out.append((y.detach().cpu().numpy(), g.cpu().numpy()))
    _close(out[0][0], out[1][0], atol=1e-5)
    _close(out[0][1], out[1][1], atol=1e-5)


@pytest.mark.cuda
def test_cuda_reduced_alexnet_mixed_bf16_matches_the_cpu():
    """The reduced AlexNet under mixed_bfloat16, dropout off, three
    Nesterovs steps on the card and on the CPU from the same weights: f32
    masters, f32 outputs, the LRN layers on f32, and the card within the
    mixed policies' tolerances of the CPU (each side rounds each op to
    bf16; an f32-level difference moves an activation by one bf16 step
    where it crosses a rounding boundary)."""
    _needs_card()
    from deeplearning4j_tpu_torch.ops import nn as nnops

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seen, plain = set(), nnops.local_response_normalization

    def lrn(a, *args, **kw):
        seen.add(a.dtype)
        return plain(a, *args, **kw)

    nnops.local_response_normalization = lrn
    try:
        conf = _no_dropout(AlexNet(num_classes=10, in_shape=ALEX_SHAPE,
                                   updater=Nesterovs(1e-4, 0.9)).conf())
        conf.precision = "mixed_bfloat16"
        cpu = MultiLayerNetwork(conf, device="cpu").init()
        card = MultiLayerNetwork(conf, device="cuda").init()
        card.params_list = [{k: v.to("cuda") for k, v in p.items()}
                            for p in cpu.params_list]
        rs = np.random.RandomState(5)
        x = rs.randn(4, *ALEX_SHAPE).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 4)]
        for _ in range(3):
            card.fit(x, y)
            cpu.fit(x, y)
            assert abs(card.score() - cpu.score()) <= 1e-2 * cpu.score()
        assert seen == {torch.float32}
        assert {t.dtype for p in card.params_list
                for t in p.values()} == {torch.float32}
        out = card.output(x)
        assert out.dtype == torch.float32
        _close(out.cpu().numpy(), cpu.output(x).numpy(), atol=5e-2, rtol=0)
    finally:
        nnops.local_response_normalization = plain
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
