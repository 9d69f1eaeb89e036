"""PyTorch port, transfer learning (``nn/transferlearning.py``, the frozen
paths of both networks and ``summary``) against the JAX package.

Each case builds a JAX network, trains it a little, writes it with the JAX
ModelSerializer and restores it in the port; both sides then run the same
surgery. The built configurations' JSON equals JAX's; the kept layers hold
the source's weights; re-initialised and added layers take JAX's weights
(carried across, never re-seeded: threefry draws cannot match a torch
generator), and the fine-tune follows JAX's trajectory over three steps:
losses within 1e-5 relative, parameters within 1e-4 absolute, outputs
within 1e-5. Frozen parameters stay bit-identical, the source network is
bit-identical after the fine-tune (the transferred network shares its
tensors and never writes into them), a frozen layer whose input needs no
gradient records no autograd graph, and ``torch.autograd.grad`` is never
handed a frozen parameter. ``summary()`` is JAX's text character for
character.
"""

import math
import os

import numpy as np
import pytest
import torch

try:  # the JAX package is the CPU tests' reference
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.learning import NoOp as JNoOp
    from deeplearning4j_tpu.learning import Nesterovs as JNesterovs
    from deeplearning4j_tpu.learning import Sgd as JSgd
    from deeplearning4j_tpu.nn.conf import InputType as JInputType
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraphConfiguration as JCGC)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn import transferlearning as jtl
    from deeplearning4j_tpu.util import ModelSerializer as JSerializer
    JAX_INIT_MODULES = (jl,)
except ModuleNotFoundError:
    jax = None

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn import transferlearning as tl
from deeplearning4j_tpu_torch.nn.conf import (DenseLayer,
                                              MultiLayerConfiguration,
                                              OutputLayer)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.params import (cg_params_from_numpy,
                                             mln_params_from_numpy)
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

OUT_ATOL, LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def numpy_weights(monkeypatch):
    """The JAX layers' ``init_weights`` drawing Glorot normal weights from
    numpy: the JAX package's own draws compile once per weight shape on
    the CPU, and the weights go across to the port, so how they were drawn
    does not matter to the comparison."""
    if jax is None:
        return
    rs = np.random.RandomState(11)

    def init_weights(scheme, key, shape, fan_in, fan_out, dtype=None,
                     gain=1.0):
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return jnp.asarray(rs.standard_normal(shape) * std,
                           dtype or jnp.float32)

    for mod in JAX_INIT_MODULES:
        monkeypatch.setattr(mod, "init_weights", init_weights)


def _np(t):
    return t.detach().float().cpu().numpy()


def _data(n=16, classes=3, seed=0, shape=(5,)):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, *shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)]
    return x, y


def _restored(jnet, tmp_path, name="src"):
    path = os.path.join(tmp_path, f"{name}.zip")
    JSerializer.writeModel(jnet, path)
    return ModelSerializer.restore(path, device="cpu")


def _snapshot(tree):
    return {(str(a), b): _np(v).copy() for a, p in tree.items()
            for b, v in p.items()}


def _tree(net):
    return (net.params_map if hasattr(net, "params_map")
            else dict(enumerate(net.params_list)))


def _jtree(jnet):
    return jax.device_get(jnet.params_map if hasattr(jnet, "params_map")
                          else dict(enumerate(jnet.params_list)))


def _same_bits(before, tree):
    now = _snapshot(tree)
    assert now.keys() == before.keys()
    for k, v in before.items():
        assert np.array_equal(now[k], v), k


def _close_trees(jtree, tree, keys=None):
    for key, p in jtree.items():
        if keys is not None and key not in keys:
            continue
        for k, v in p.items():
            err = float(np.abs(_np(tree[key][k]) - np.asarray(v)).max())
            assert err <= PARAM_ATOL, (key, k, err)


def _carry(jnet, net):
    """JAX's parameters (the re-initialised ones included) into ``net``."""
    if hasattr(net, "params_map"):
        net.params_map = cg_params_from_numpy(
            net.conf.nodes, jax.device_get(jnet.params_map), device="cpu")
    else:
        net.params_list = mln_params_from_numpy(
            jax.device_get(jnet.params_list), device="cpu")


def _follow(jnet, net, xs, y, steps=3):
    for _ in range(steps):
        jnet.fit(xs, y)
        net.fit(xs, y)
        lj, lt = float(jnet.score()), net.score()
        assert np.isfinite(lt) and abs(lt - lj) <= LOSS_RTOL * abs(lj), \
            (lt, lj)
    _close_trees(_jtree(jnet), _tree(net))


def _single(out):
    out = out[0] if isinstance(out, (list, tuple)) else out
    if torch.is_tensor(out):
        return _np(out)
    return np.asarray(out.jax if hasattr(out, "jax") else out)


# ---------------------------------------------------------------- the MLN
def _jax_base(seed=0, image=False):
    """A trained JAX MLN: an image stem (conv, pool) when ``image``, two
    dense layers and a 3-class head, three Sgd steps."""
    b = JNNC.builder().seed(seed).updater(JSgd(0.1)).list()
    if image:
        b.layer(jl.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    activation="relu"))
        b.layer(jl.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
    b.layer(jl.DenseLayer(n_out=12, activation="relu"))
    b.layer(jl.DenseLayer(n_out=8, activation="tanh"))
    b.layer(jl.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
    it = (JInputType.convolutional(6, 6, 2) if image
          else JInputType.feedForward(5))
    jnet = JMLN(b.setInputType(it).build()).init()
    x, y = _data(shape=(6, 6, 2) if image else (5,))
    for _ in range(3):
        jnet.fit(x, y)
    return jnet, x


SURGERIES = ["edit_last_layer", "n_out_replace", "remove_two"]


def _surgery(builder, kind, mod, out_layer):
    b = builder.fineTuneConfiguration(mod.FineTuneConfiguration(
        updater=(JNesterovs if mod is jtl else Nesterovs)(0.05, 0.9),
        seed=12345))
    if kind == "edit_last_layer":     # EditLastLayerOthersFrozen
        return (b.setFeatureExtractor(3).removeOutputLayer()
                .addLayer(out_layer(n_in=8, n_out=2, activation="softmax",
                                    loss="mcxent")).build())
    if kind == "n_out_replace":
        return b.setFeatureExtractor(2).nOutReplace(3, 6, "xavier").build()
    return (b.setFeatureExtractor(1).removeLayersFromOutput(2)
            .addLayer(out_layer(n_in=12, n_out=2, activation="softmax",
                                loss="mcxent")).build())


@pytest.mark.parametrize("kind", SURGERIES)
def test_mln_surgery_follows_jax(tmp_path, kind):
    jsrc, x = _jax_base(image=True)
    src = _restored(jsrc, tmp_path)
    before = _snapshot(_tree(src))
    jnet = _surgery(jtl.TransferLearning.Builder(jsrc), kind, jtl,
                    jl.OutputLayer)
    net = _surgery(tl.TransferLearning.Builder(src), kind, tl, OutputLayer)
    assert net.conf.to_json() == jnet.conf.to_json()
    assert net.device == src.device
    n_classes = 3 if kind == "n_out_replace" else 2
    # kept layers share the source's weights; shapes and n_in
    jp = jax.device_get(jnet.params_list)
    assert len(net.params_list) == len(jp)
    for i, p in enumerate(net.params_list):
        assert {k: tuple(v.shape) for k, v in p.items()} == \
            {k: tuple(v.shape) for k, v in jp[i].items()}, i
    for i in range(3):
        for k, v in src.params_list[i].items():
            assert net.params_list[i][k] is v
    if kind == "n_out_replace":
        assert net.conf.layers[4].n_in == 6
        assert tuple(net.params_list[3]["W"].shape) == (12, 6)
    frozen = [i for i, l in enumerate(net.conf.layers)
              if isinstance(l, tl.FrozenLayer)]
    assert frozen == [i for i, l in enumerate(jnet.conf.layers)
                      if isinstance(l, jtl.FrozenLayer)]
    # the frozen prefix's output equals the source's features
    k = max(frozen) + 1
    feats = src.feedForward(x)[k]
    np.testing.assert_array_equal(_np(net.feedForward(x)[k]), _np(feats))
    _carry(jnet, net)
    want = _single(jnet.output(x))
    assert _single(net.output(x)).shape == (x.shape[0], n_classes)
    np.testing.assert_allclose(_single(net.output(x)), want, atol=OUT_ATOL)
    frozen_before = {i: _snapshot({i: net.params_list[i]}) for i in frozen}
    _, y = _data(classes=n_classes, seed=1)
    _follow(jnet, net, x, y)
    for i in frozen:
        _same_bits(frozen_before[i], {i: net.params_list[i]})
    _same_bits(before, _tree(src))


def test_frozen_prefix_costs_forward_only(monkeypatch):
    """A step hands ``torch.autograd.grad`` only the unfrozen leaves, runs
    no updater over a frozen layer, and the frozen prefix's output carries
    no ``grad_fn``."""
    src = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jax_base()[0].conf.to_json()), device="cpu").init()
    net = (tl.TransferLearning.Builder(src).setFeatureExtractor(1)
           .build())
    outs, handed = [], []
    real_apply, real_grad = tl.FrozenLayer.apply, torch.autograd.grad

    def apply(self, *a, **kw):
        out = real_apply(self, *a, **kw)
        outs.append(out[0])
        return out

    def grad(outputs, inputs, *a, **kw):
        handed.append(len(list(inputs)))
        return real_grad(outputs, inputs, *a, **kw)

    monkeypatch.setattr(tl.FrozenLayer, "apply", apply)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    x, y = _data()
    net.fit(x, y)
    assert len(outs) == 2 and all(o.grad_fn is None and not o.requires_grad
                                  for o in outs)
    assert handed == [2]          # the head's W and b
    assert net.opt_states[0] is not None


def test_frozen_layer_with_backprop_passes_the_gradient(tmp_path):
    """The WGAN recipe (``examples/wgan.py``): a generator under frozen
    critic layers trains through them; the critic stays bit-identical and
    the step follows JAX's."""
    frozen = jtl.FrozenLayerWithBackprop
    jnet = JMLN(
        JNNC.builder().seed(2).updater(JSgd(0.05)).list()
        .layer(jl.DenseLayer(n_out=6, activation="relu"))
        .layer(jl.DenseLayer(n_out=2, activation="identity"))
        .layer(frozen(layer=jl.DenseLayer(n_out=5, activation="leakyrelu")))
        .layer(frozen(layer=jl.DenseLayer(n_out=5, activation="leakyrelu")))
        .layer(jl.OutputLayer(n_out=1, activation="identity",
                              loss="wasserstein", updater=JNoOp()))
        .setInputType(JInputType.feedForward(4)).build()).init()
    net = _restored(jnet, tmp_path, "gan")
    assert isinstance(net.conf.layers[2], tl.FrozenLayerWithBackprop)
    assert net.conf.to_json() == jnet.conf.to_json()
    x = np.random.RandomState(3).randn(16, 4).astype(np.float32)
    y = -np.ones((16, 1), np.float32)
    critic = _snapshot({i: net.params_list[i] for i in (2, 3, 4)})
    gen = _snapshot({i: net.params_list[i] for i in (0, 1)})
    _follow(jnet, net, x, y)
    _same_bits(critic, {i: net.params_list[i] for i in (2, 3, 4)})
    moved = _snapshot({i: net.params_list[i] for i in (0, 1)})
    assert any(not np.array_equal(moved[k], gen[k]) for k in gen)
    # the input gradient through the frozen layers, as JAX gives it
    xt = torch.from_numpy(x).requires_grad_(True)
    a = xt
    for i, layer in enumerate(net.conf.layers):
        a, _ = layer.apply(net.params_list[i], net.states_list[i], a, False,
                           None)
    (g,) = torch.autograd.grad(a.sum(), xt)
    assert float(g.abs().max()) > 0.0


def test_helper_featurize_and_fit_follow_jax(tmp_path):
    jsrc, x = _jax_base(image=True)
    src = _restored(jsrc, tmp_path)
    jnet = _surgery(jtl.TransferLearning.Builder(jsrc), "edit_last_layer",
                    jtl, jl.OutputLayer)
    net = _surgery(tl.TransferLearning.Builder(src), "edit_last_layer", tl,
                   OutputLayer)
    _carry(jnet, net)
    jh, h = jtl.TransferLearningHelper(jnet), tl.TransferLearningHelper(net)
    assert h.frozen_up_to == jh.frozen_up_to == 3
    _, y = _data(classes=2, seed=1)
    jf, f = jh.featurize(JDataSet(x, y)), h.featurize(DataSet(x, y))
    assert f.features.grad_fn is None
    np.testing.assert_allclose(_np(f.features), np.asarray(jf.features),
                               atol=OUT_ATOL)
    frozen = _snapshot({i: net.params_list[i] for i in range(4)})
    for _ in range(3):
        jh.fitFeaturized(jf)
        h.fitFeaturized(f)
    _close_trees(_jtree(jnet), _tree(net))
    tail = h.unfrozenMLN()
    for j, p in enumerate(tail.params_list):
        for k, v in p.items():
            assert torch.equal(net.params_list[4 + j][k], v)
    _same_bits(frozen, {i: net.params_list[i] for i in range(4)})


def test_mln_json_and_summary_equal_jax(tmp_path):
    jsrc, _ = _jax_base(image=True)
    src = _restored(jsrc, tmp_path)
    jnet = _surgery(jtl.TransferLearning.Builder(jsrc), "edit_last_layer",
                    jtl, jl.OutputLayer)
    net = _surgery(tl.TransferLearning.Builder(src), "edit_last_layer", tl,
                   OutputLayer)
    assert '"@class": "FrozenLayer"' in net.conf.to_json()
    assert net.conf.to_json() == jnet.conf.to_json()
    assert MultiLayerConfiguration.from_json(
        jnet.conf.to_json()).to_json() == jnet.conf.to_json()
    assert src.summary() == jsrc.summary()
    assert net.summary() == jnet.summary()
    assert "FrozenLayer" in net.summary()
    # a JAX zip holding frozen layers restores
    again = _restored(jnet, tmp_path, "frozen")
    assert again.conf.to_json() == jnet.conf.to_json()
    _close_trees(_jtree(jnet), _tree(again))


def test_mln_error_cases_match_jax():
    jsrc, _ = _jax_base()
    src = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jsrc.conf.to_json()), device="cpu").init()
    for mod, s, cls in ((jtl, jsrc, JMLN), (tl, src, MultiLayerNetwork)):
        with pytest.raises(ValueError, match="removed every layer"):
            mod.TransferLearning.Builder(s).removeLayersFromOutput(3).build()
        kw = {} if cls is JMLN else {"device": "cpu"}
        with pytest.raises(ValueError, match="init"):
            mod.TransferLearning.Builder(cls(s.conf, **kw))
        with pytest.raises(ValueError, match="no frozen layers"):
            mod.TransferLearningHelper(s)


# -------------------------------------------------------------- the graph
def _jax_graph(bn=False):
    """A trained JAX graph: dense "fe1" (or a conv + batch-norm stem when
    ``bn``), dense "fe2", head "out"."""
    b = (JCGC.graphBuilder().seed(1).updater(JSgd(0.1)).addInputs("in"))
    if bn:
        b.addLayer("conv", jl.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                               convolution_mode="Same"),
                   "in")
        b.addLayer("bn", jl.BatchNormalization(activation="relu"), "conv")
        b.addLayer("pool", jl.GlobalPoolingLayer(pooling_type="avg"), "bn")
        b.addLayer("fe2", jl.DenseLayer(n_out=8, activation="relu"), "pool")
        b.setInputTypes(JInputType.convolutional(5, 5, 3))
    else:
        b.addLayer("fe1", jl.DenseLayer(n_out=10, activation="relu"), "in")
        b.addLayer("fe2", jl.DenseLayer(n_out=8, activation="relu"), "fe1")
        b.setInputTypes(JInputType.feedForward(5))
    b.addLayer("out", jl.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"), "fe2")
    jg = JCG(b.setOutputs("out").build()).init()
    x, y = _data(shape=(5, 5, 3) if bn else (5,))
    for _ in range(3):
        jg.fit([x], [y])
    return jg, x


GRAPH_SURGERIES = ["freeze_replace_head", "n_out_replace", "keep_connections",
                   "frozen_batch_norm"]


def _graph_surgery(builder, kind, mod):
    b = builder.fineTuneConfiguration(mod.FineTuneConfiguration(
        updater=(JNesterovs if mod is jtl else Nesterovs)(0.05, 0.9)))
    dense = jl.DenseLayer if mod is jtl else DenseLayer
    out = jl.OutputLayer if mod is jtl else OutputLayer
    if kind == "freeze_replace_head":
        return (b.setFeatureExtractor("fe2").removeVertexAndConnections("out")
                .addLayer("new_out", out(n_in=8, n_out=2,
                                         activation="softmax",
                                         loss="mcxent"), "fe2")
                .setOutputs("new_out").build())
    if kind == "n_out_replace":
        return b.setFeatureExtractor("fe1").nOutReplace("fe2", 6).build()
    if kind == "keep_connections":
        return (b.removeVertexKeepConnections("fe2")
                .addLayer("fe2", dense(n_in=10, n_out=8, activation="tanh"),
                          "fe1").setOutputs("out").build())
    return (b.setFeatureExtractor("pool").nOutReplace("out", 2, "xavier")
            .build())


@pytest.mark.parametrize("kind", GRAPH_SURGERIES)
def test_graph_surgery_follows_jax(tmp_path, kind):
    bn = kind == "frozen_batch_norm"
    jsrc, x = _jax_graph(bn=bn)
    src = _restored(jsrc, tmp_path)
    before = _snapshot(src.params_map)
    states_before = _snapshot(src.states_map)
    jg = _graph_surgery(jtl.TransferLearning.GraphBuilder(jsrc), kind, jtl)
    g = _graph_surgery(tl.TransferLearning.GraphBuilder(src), kind, tl)
    assert g.conf.to_json() == jg.conf.to_json()
    assert g.summary() == jg.summary()
    jp = jax.device_get(jg.params_map)
    assert {n: {k: tuple(v.shape) for k, v in p.items()}
            for n, p in g.params_map.items()} == \
        {n: {k: tuple(v.shape) for k, v in p.items()} for n, p in jp.items()}
    frozen = [n.name for n in g.conf.nodes
              if type(n.vertex).__name__ == "FrozenVertex"]
    _carry(jg, g)
    np.testing.assert_allclose(_single(g.output(x)), _single(jg.output(x)),
                               atol=OUT_ATOL)
    fz = _snapshot({n: g.params_map[n] for n in frozen})
    fz_states = _snapshot({n: g.states_map[n] for n in frozen})
    n_out = {"freeze_replace_head": 2, "frozen_batch_norm": 2}.get(kind, 3)
    _, y = _data(classes=n_out, seed=2)
    _follow(jg, g, [x], [y])
    _same_bits(fz, {n: g.params_map[n] for n in frozen})
    _same_bits(fz_states, {n: g.states_map[n] for n in frozen})
    if bn:
        assert "bn" in frozen and "conv" in frozen
    _same_bits(before, src.params_map)
    _same_bits(states_before, src.states_map)


def test_graph_builder_requires_init_as_jax():
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraphConfiguration)

    jsrc, _ = _jax_graph()
    conf = ComputationGraphConfiguration.from_json(jsrc.conf.to_json())
    for mod, g in ((jtl, JCG(jsrc.conf)),
                   (tl, ComputationGraph(conf, device="cpu"))):
        with pytest.raises(ValueError, match="init"):
            mod.TransferLearning.GraphBuilder(g)
