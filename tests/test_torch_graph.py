"""PyTorch port, ``ComputationGraph``: ``deeplearning4j_tpu_torch``'s graph
configuration, vertices, ``ComputationGraph`` and ``zoo.ResNet50`` against
the JAX package's on the same numpy inputs at f32, the JAX graph's weights
carried across through its ModelSerializer zip or
``params.cg_params_from_numpy``, never re-initialised.

The cut ResNet: input 32 x 32 x 3, the stem at 8 channels and its pool,
one projection block (filters 8, 8, 32, stride 2), one identity block,
global average pooling and a 4-class head, ``l2(1e-4)`` and
``Nesterovs(0.05, 0.9)``: the JAX graph is built by the JAX
``GraphBuilder`` with the JAX ``ResNet50`` block builders.

Tolerances: losses 1e-5 relative; parameters, batch-norm running state,
updater state and outputs 1e-5 of max(1, max |value|) after three steps
(sums in another order; Nesterovs moves each parameter by lr times its
gradient, so parity this close shows the same gradients); vertex outputs
1e-6. bf16: one step from the same bf16 weights, held as
``test_bf16_cut_resnet_from_a_jax_zip`` derives its bounds.
"""

import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning.updaters import Nesterovs, Sgd
from deeplearning4j_tpu_torch.nn.conf import (
    BatchNormalization, ConvolutionLayer, DenseLayer, GlobalPoolingLayer,
    InputType, OutputLayer)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, ElementWiseVertex,
    MergeVertex)
from deeplearning4j_tpu_torch.params import cg_params_from_numpy
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
from deeplearning4j_tpu_torch.zoo import ResNet50
from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

LOSS_RTOL, TOL = 1e-5, 1e-5


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


def _close_trees(got, want, tol, what):
    """Two trees of the same keys (nested dicts), leaf by leaf."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
        for k in want:
            _close_trees(got[k], want[k], tol, f"{what}/{k}")
    else:
        _close(got, want, tol, what)


def _jax_cut_resnet(dtype="float32"):
    """The cut ResNet, built by the JAX package."""
    from deeplearning4j_tpu.learning import Nesterovs as JaxNesterovs
    from deeplearning4j_tpu.nn.conf import (
        GlobalPoolingLayer as JGlobal, InputType as JIt, OutputLayer as JOut,
        SubsamplingLayer as JSub)
    from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration \
        as JCGC
    from deeplearning4j_tpu.zoo.resnet50 import ResNet50 as JaxResNet50

    z = JaxResNet50()
    b = (JCGC.graphBuilder().seed(3).updater(JaxNesterovs(0.05, 0.9))
         .weightInit("relu").l2(1e-4).dataType(dtype).addInputs("input")
         .setInputTypes(JIt.convolutional(32, 32, 3)))
    x = z._conv_bn(b, "stem", "input", 8, (7, 7), (2, 2))
    b.addLayer("stem_pool", JSub(kernel_size=(3, 3), stride=(2, 2),
                                 convolution_mode="Same"), x)
    x = z._bottleneck(b, "res2a", "stem_pool", (8, 8, 32), (2, 2), True)
    x = z._bottleneck(b, "res2b", x, (8, 8, 32), (1, 1), False)
    b.addLayer("avg_pool", JGlobal(pooling_type="avg"), x)
    b.addLayer("fc", JOut(n_out=4, activation="softmax", loss="mcxent"),
               "avg_pool")
    return b.setOutputs("fc").build()


def _batch(n=6, hw=32, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, hw, hw, 3).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)]


def _trajectory(g, jg, xs, ys, steps=3):
    for _ in range(steps):
        jg.fit(xs, ys)
        g.fit(xs, ys)
        lj, lt = float(jg.score()), g.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    assert g.getIterationCount() == jg.getIterationCount() == steps


def _assert_same_graph_state(g, jg, opt=True):
    import jax

    _close_trees(g.params_map, jax.device_get(jg.params_map), TOL, "params")
    _close_trees(g.states_map, jax.device_get(jg.states_map), TOL, "state")
    if opt:
        _close_trees(g.opt_states, jax.device_get(jg.opt_states), TOL,
                     "updater")


# -------------------------------------------------------------- vertices
@pytest.mark.parametrize("op", ["Add", "Subtract", "Product", "Average",
                                "Max", "Min"])
def test_elementwise_vertex_matches_jax(op):
    from deeplearning4j_tpu.nn.graph import ElementWiseVertex as JEw

    rs = np.random.RandomState(1)
    xs = [rs.randn(3, 4, 5).astype(np.float32) for _ in range(3)]
    want, _ = JEw(op=op).apply({}, {}, xs, False, None)
    got, _ = ElementWiseVertex(op=op).apply(
        {}, {}, [torch.from_numpy(x) for x in xs], False, None)
    _close(got, want, 1e-6, op)


def test_merge_vertex_matches_jax():
    from deeplearning4j_tpu.nn.conf import InputType as JIt
    from deeplearning4j_tpu.nn.graph import MergeVertex as JMerge

    rs = np.random.RandomState(2)
    xs = [rs.randn(2, 3, 3, c).astype(np.float32) for c in (2, 5)]
    want, _ = JMerge().apply({}, {}, xs, False, None)
    got, _ = MergeVertex().apply({}, {}, [torch.from_numpy(x) for x in xs],
                                 False, None)
    _close(got, want, 1e-6, "merge")
    assert MergeVertex().output_type(
        [InputType.convolutional(3, 3, 2), InputType.convolutional(3, 3, 5)]
    ) == InputType.convolutional(3, 3, 7)
    assert JMerge().output_type([JIt.convolutional(3, 3, 2),
                                 JIt.convolutional(3, 3, 5)]).channels == 7


def test_unported_vertex_names_its_roadmap_item():
    """Every vertex of the JAX package is ported now: a JAX graph naming
    each of the fourteen that were stand-ins reads back through the
    port's JSON to the same configuration, and the port builds and runs
    it (shapes equal to the JAX graph's outputs)."""
    import jax
    from deeplearning4j_tpu.nn.conf import InputType as JIt
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration \
        as JCGC
    from deeplearning4j_tpu.nn.graph import vertices as jv
    from deeplearning4j_tpu_torch.nn.graph import vertices

    b = (JCGC.graphBuilder().addInputs("seq", "img", "vec")
         .setInputTypes(JIt.recurrent(4, 6), JIt.convolutional(5, 5, 2),
                        JIt.feedForward(4)))
    b.addVertex("scale", jv.ScaleVertex(scale=2.0), "vec")
    b.addVertex("l2n", jv.L2NormalizeVertex(), "scale")
    b.addVertex("subset", jv.SubsetVertex(frm=1, to=2), "l2n")
    b.addVertex("last", jv.LastTimeStepVertex(), "seq")
    b.addVertex("dup", jv.DuplicateToTimeSeriesVertex(), "last", "seq")
    b.addVertex("rev", jv.ReverseTimeSeriesVertex(), "dup")
    b.addVertex("stack", jv.StackVertex(), "vec", "last")
    b.addVertex("unstack", jv.UnstackVertex(from_index=1, stack_size=2),
                "stack")
    b.addVertex("shift", jv.ShiftVertex(shift=0.5), "unstack")
    b.addVertex("reshape", jv.ReshapeVertex(shape=[2, 2]), "shift")
    b.addVertex("l2", jv.L2Vertex(), "vec", "shift")
    b.addVertex("frozen", jv.FrozenVertex(vertex=jv.ScaleVertex(scale=3.0)),
                "l2")
    b.addVertex("pool", jv.PoolHelperVertex(), "img")
    b.addVertex("att", jv.DotProductAttentionVertex(), "rev", "seq", "seq")
    outs = ("subset", "reshape", "frozen", "pool", "att")
    jconf = b.setOutputs(*outs).build()
    names = {type(n.vertex).__name__ for n in jconf.nodes}
    assert len(names) == 14, sorted(names)
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert conf.to_json() == jconf.to_json()
    for name in names:
        assert type(getattr(vertices, name)) is type
    rs = np.random.RandomState(9)
    xs = [rs.randn(3, 6, 4).astype(np.float32),
          rs.randn(3, 5, 5, 2).astype(np.float32),
          rs.randn(3, 4).astype(np.float32)]
    want = JCG(jconf).init().output(*xs)
    got = ComputationGraph(conf, device="cpu").init().output(*xs)
    for g, w, o in zip(got, want, outs):
        _close(g, np.asarray(jax.device_get(w.jax)), 1e-6, o)


# ---------------------------------------------------------- configuration
def test_cut_resnet_conf_matches_jax():
    jconf = _jax_cut_resnet()
    conf = cut_resnet_conf()
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    assert [n.name for n in conf.nodes] == [n.name for n in jconf.nodes]
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert back == conf


def test_resnet50_conf_matches_jax_at_full_width():
    from deeplearning4j_tpu.zoo.resnet50 import ResNet50 as JaxResNet50

    assert json.loads(ResNet50().conf().to_json()) == json.loads(
        JaxResNet50().conf().to_json())


def test_resnet50_shapes_and_size_match_jax_at_full_width():
    import jax
    from deeplearning4j_tpu.zoo.resnet50 import ResNet50 as JaxResNet50

    jg = JaxResNet50(num_classes=1000).init()
    g = ResNet50(num_classes=1000).init(device="cpu")
    want = {n: {k: tuple(v.shape) for k, v in p.items()}
            for n, p in jax.device_get(jg.params_map).items()}
    got = {n: {k: tuple(v.shape) for k, v in p.items()}
           for n, p in g.params_map.items()}
    assert got == want
    assert {n: sorted(s) for n, s in g.states_map.items()} == {
        n: sorted(s) for n, s in jg.states_map.items()}
    assert g.numParams() == jg.numParams()
    assert 25_000_000 < g.numParams() < 26_500_000, g.numParams()
    assert g.conf.nodes[-1].vertex.layer.n_in == 2048


def test_flatten_vertex_between_conv_and_dense_matches_jax():
    """A dense layer on image input gets a ``-flatten`` preprocessor
    vertex, as the JAX builder places it; the graph trains alike."""
    import jax
    from deeplearning4j_tpu.learning import Sgd as JaxSgd
    from deeplearning4j_tpu.nn.conf import (
        ConvolutionLayer as JConv, DenseLayer as JDense, InputType as JIt,
        OutputLayer as JOut)
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraph as JCG, ComputationGraphConfiguration as JCGC)

    def build(cgc, conv, dense, out, it, sgd):
        return (cgc.graphBuilder().seed(1).updater(sgd(0.1)).addInputs("in")
                .setInputTypes(it.convolutional(5, 5, 2))
                .addLayer("conv", conv(n_out=3, kernel_size=(2, 2),
                                       activation="relu"), "in")
                .addLayer("dense", dense(n_out=6, activation="tanh"), "conv")
                .addLayer("out", out(n_out=2, activation="softmax",
                                     loss="mcxent"), "dense")
                .setOutputs("out").build())

    conf = build(ComputationGraphConfiguration, ConvolutionLayer, DenseLayer,
                 OutputLayer, InputType, Sgd)
    jconf = build(JCGC, JConv, JDense, JOut, JIt, JaxSgd)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    assert [n.name for n in conf.nodes] == ["conv", "dense-flatten", "dense",
                                            "out"]
    assert conf.nodes[2].vertex.layer.n_in == 4 * 4 * 3
    jg = JCG(jconf).init()
    g = ComputationGraph(conf, device="cpu").init()
    g.params_map = cg_params_from_numpy(conf.nodes,
                                        jax.device_get(jg.params_map),
                                        device="cpu")
    rs = np.random.RandomState(3)
    x = rs.randn(4, 5, 5, 2).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
    _trajectory(g, jg, x, y, steps=2)
    _assert_same_graph_state(g, jg)


# ------------------------------------------------------------- training
def test_cut_resnet_trajectory_from_a_jax_zip(tmp_path):
    """The cut ResNet written by the JAX ModelSerializer, restored by the
    port: three steps follow the JAX loss, parameters, BN running state
    and updater state; then ``output`` in inference mode."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer

    jg = JCG(_jax_cut_resnet()).init()
    x, y = _batch()
    jg.fit(x, y)    # a moved BN state and a non-zero velocity go across
    path = os.path.join(tmp_path, "resnet.zip")
    JaxSerializer.writeModel(jg, path, save_updater=True)
    g = ModelSerializer.restoreComputationGraph(path, device="cpu")
    assert g.getIterationCount() == 1
    _assert_same_graph_state(g, jg)
    x2, y2 = _batch(seed=1)
    for _ in range(3):
        jg.fit(x2, y2)
        g.fit(x2, y2)
        lj, lt = float(jg.score()), g.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    _assert_same_graph_state(g, jg)
    out = g.output(x)
    assert isinstance(out, list) and len(out) == 1
    _close(out[0], np.asarray(jg.output(x)[0].jax), TOL, "output")
    _close(g.outputSingle(x), out[0], 0.0, "outputSingle")


def test_cut_resnet_trajectory_with_the_fused_bn_relu(tmp_path, monkeypatch):
    """``FUSED_BN_RELU_BWD`` on in both packages (set before the JAX graph
    is built, since its step reads it at trace time): the cut ResNet from
    a JAX zip follows the JAX loss, parameters, BN running state and
    updater state over three steps at f32, every BN layer with a ReLU
    through ``batch_norm_relu_train`` on both sides."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.ops import nn as jn
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer
    from deeplearning4j_tpu_torch.ops import nn as tn

    calls = {"jax": 0, "port": 0}
    for mod, tag in ((jn, "jax"), (tn, "port")):
        fn = mod.batch_norm_relu_train

        def spy(*a, _f=fn, _t=tag, **k):
            calls[_t] += 1
            return _f(*a, **k)

        monkeypatch.setattr(mod, "batch_norm_relu_train", spy)
    prev = (jn.FUSED_BN_RELU_BWD, tn.FUSED_BN_RELU_BWD)
    jn.FUSED_BN_RELU_BWD = tn.FUSED_BN_RELU_BWD = True
    try:
        jg = JCG(_jax_cut_resnet()).init()
        x, y = _batch(seed=3)
        jg.fit(x, y)
        path = os.path.join(tmp_path, "resnet.zip")
        JaxSerializer.writeModel(jg, path, save_updater=True)
        g = ModelSerializer.restoreComputationGraph(path, device="cpu")
        _assert_same_graph_state(g, jg)
        x2, y2 = _batch(seed=4)
        for _ in range(3):
            jg.fit(x2, y2)
            g.fit(x2, y2)
            lj, lt = float(jg.score()), g.score()
            assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
        _assert_same_graph_state(g, jg)
    finally:
        jn.FUSED_BN_RELU_BWD, tn.FUSED_BN_RELU_BWD = prev
    # the stem and two convs of each of the two blocks end in a ReLU: the
    # port's three steps call the fused op 5 times each; JAX traced it
    assert calls["port"] == 3 * 5 and calls["jax"] > 0


def test_cut_resnet_trajectory_through_cg_params_from_numpy():
    import jax
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG

    jconf = _jax_cut_resnet()
    jg = JCG(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    g = ComputationGraph(conf, device="cpu").init()
    for attr in ("params_map", "states_map", "opt_states"):
        setattr(g, attr, cg_params_from_numpy(
            conf.nodes, jax.device_get(getattr(jg, attr)), device="cpu"))
    x, y = _batch(seed=2)
    _trajectory(g, jg, x, y)
    _assert_same_graph_state(g, jg)
    _close(g.params(), np.asarray(jg.params().jax), TOL, "params()")
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet

    want = float(jg.score(JaxDataSet(x, y)))
    assert abs(g.score(DataSet(x, y)) - want) <= LOSS_RTOL * abs(want)


def test_cg_params_from_numpy_checks_the_node_names():
    conf = cut_resnet_conf()
    tree = {n.name: {} for n in conf.nodes}
    assert list(cg_params_from_numpy(conf.nodes, tree, device="cpu")) == [
        n.name for n in conf.nodes]
    with pytest.raises(KeyError, match="stem_conv"):
        cg_params_from_numpy(conf.nodes, {k: v for k, v in tree.items()
                                          if k != "stem_conv"}, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        cg_params_from_numpy(conf.nodes, {**tree, "extra": {}}, device="cpu")


@pytest.mark.parametrize("mode", ["ClipL2PerLayer", "RenormalizeL2PerLayer",
                                  "ClipElementWiseAbsoluteValue"])
def test_two_inputs_two_outputs_l1_and_clipping_match_jax(mode):
    """Two inputs merged, a batch-norm branch, two loss heads (summed),
    l1 on the weights and each gradient normalisation."""
    import jax
    from deeplearning4j_tpu.learning import Sgd as JaxSgd
    from deeplearning4j_tpu.nn.conf import (
        BatchNormalization as JBn, DenseLayer as JDense, InputType as JIt,
        OutputLayer as JOut)
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraph as JCG, ComputationGraphConfiguration as JCGC,
        ElementWiseVertex as JEw, MergeVertex as JMerge)

    def build(cgc, dense, bn, out, merge, ew, it, sgd):
        return (cgc.graphBuilder().seed(4).updater(sgd(0.5)).l1(1e-3)
                .gradientNormalization(mode, 0.05)
                .addInputs("a", "b")
                .setInputTypes(it.feedForward(3), it.feedForward(4))
                .addVertex("m", merge(), "a", "b")
                .addLayer("h", dense(n_out=5, activation="relu"), "m")
                .addLayer("bn", bn(), "h")
                .addLayer("g", dense(n_out=5, activation="tanh"), "m")
                .addVertex("sum", ew(op="Product"), "bn", "g")
                .addLayer("o1", out(n_out=2, activation="softmax",
                                    loss="mcxent"), "sum")
                .addLayer("o2", out(n_out=1, activation="identity",
                                    loss="mse"), "g")
                .setOutputs("o1", "o2").build())

    conf = build(ComputationGraphConfiguration, DenseLayer,
                 BatchNormalization, OutputLayer, MergeVertex,
                 ElementWiseVertex, InputType, Sgd)
    jconf = build(JCGC, JDense, JBn, JOut, JMerge, JEw, JIt, JaxSgd)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    jg = JCG(jconf).init()
    g = ComputationGraph(conf, device="cpu").init()
    g.params_map = cg_params_from_numpy(conf.nodes,
                                        jax.device_get(jg.params_map),
                                        device="cpu")
    rs = np.random.RandomState(5)
    xs = [rs.randn(8, 3).astype(np.float32), rs.randn(8, 4).astype(
        np.float32)]
    ys = [np.eye(2, dtype=np.float32)[rs.randint(0, 2, 8)],
          rs.randn(8, 1).astype(np.float32)]
    _trajectory(g, jg, xs, ys)
    _assert_same_graph_state(g, jg, opt=False)
    for got, want in zip(g.output(*xs), jg.output(*xs)):
        _close(got, np.asarray(want.jax), TOL, "output")


def _bf16_ulp(a) -> np.ndarray:
    """The spacing of bf16 values at |a| (8 significant bits)."""
    a = np.maximum(np.abs(_f32(a)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def test_bf16_cut_resnet_from_a_jax_zip(tmp_path):
    """A bf16 graph that has taken one JAX step (a non-zero velocity and a
    moved BN state), written by the JAX ModelSerializer: parameters and
    BN state restore in bf16, bit for bit, through the zip and through
    ``cg_params_from_numpy`` alike. Then one more step on both, held to
    JAX's:

    - the loss within 2e-2 relative (bf16 activations rounded at other
      points; reading 3.5e-3);
    - the velocity (f32) within lr x max |grad| of each tensor, the
      gradient being JAX's ``(mu * v0 - v1) / lr``: both frameworks' bf16
      backward rounds at other points, and through the batch norms the
      gradients of the cut ResNet differ by up to 0.63 of that (the
      stem's beta, a cancelling sum; the other tensors up to 0.25);
    - each parameter within ulp(p) + ulp(u) + (1 + mu) |v1 - v1'|
      + 2^-20 |u|: the update u = mu * v0 - (1 + mu) * v1 differs by
      (1 + mu) times the velocities' difference, and each framework
      rounds u to bf16 and p - u to bf16, half an ulp each (reading:
      0.996 of the bound);
    - each BN running value within 2 bf16 ulps plus 0.05 of the tensor's
      largest batch term max |s1 - d * s0| (the batch statistics are
      taken over bf16 activations that differ as the gradients do;
      reading 0.29 of the bound). The EMA's own rounding is held bit for
      bit by ``test_bf16_batch_norm_layer_matches_jax_bit_for_bit`` in
      tests/test_torch_cnn.py.

    Parameters and BN state stay bf16 and the velocity f32."""
    import jax
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer

    jg = JCG(_jax_cut_resnet("bfloat16")).init()
    jg.fit(*_batch())
    path = os.path.join(tmp_path, "resnet16.zip")
    JaxSerializer.writeModel(jg, path, save_updater=True)
    g = ModelSerializer.restoreComputationGraph(path, device="cpu")
    for attr in ("params_map", "states_map"):
        want = jax.device_get(getattr(jg, attr))
        bridged = cg_params_from_numpy(g.conf.nodes, want, device="cpu")
        for n, p in getattr(g, attr).items():
            for k, v in p.items():
                assert v.dtype == bridged[n][k].dtype == torch.bfloat16
                np.testing.assert_array_equal(_f32(v), _f32(want[n][k]))
                assert torch.equal(v.view(torch.int16),
                                   bridged[n][k].view(torch.int16))
    v0 = jax.device_get(jg.opt_states)
    s0 = jax.device_get(jg.states_map)
    x, y = _batch(seed=3)
    jg.fit(x, y)
    g.fit(x, y)
    lj, lt = float(jg.score()), g.score()
    assert np.isfinite(lt) and abs(lt - lj) <= 2e-2 * abs(lj), (lt, lj)
    assert {v.dtype for p in g.params_map.values() for v in p.values()} \
        == {torch.bfloat16}
    assert {v.dtype for s in g.states_map.values() for v in s.values()} \
        == {torch.bfloat16}
    assert {v.dtype for s in g.opt_states.values()
            for v in s["v"].values()} == {torch.float32}

    lr, mu, d = 0.05, 0.9, 0.9
    jp, jv = jax.device_get(jg.params_map), jax.device_get(jg.opt_states)
    for n, p in jp.items():
        for k in p:
            what = f"{n}/{k}"
            vz, vj = _f32(v0[n]["v"][k]), _f32(jv[n]["v"][k])
            vt = _f32(g.opt_states[n]["v"][k])
            dv = np.abs(vt - vj)
            lr_grad = float(np.abs(mu * vz - vj).max())
            assert dv.max() <= lr_grad, (what, dv.max(), lr_grad)
            u = np.maximum(np.abs(mu * vz - (1 + mu) * vj),
                           np.abs(mu * vz - (1 + mu) * vt))
            pj, pt = _f32(p[k]), _f32(g.params_map[n][k])
            bound = (_bf16_ulp(np.maximum(np.abs(pj), np.abs(pt)))
                     + _bf16_ulp(u) + (1 + mu) * dv + 2.0 ** -20 * u)
            worst = float((np.abs(pt - pj) / bound).max())
            assert worst <= 1.0, (what, worst)
    js = jax.device_get(jg.states_map)
    for n, s in js.items():
        for k in s:
            sj, st = _f32(s[k]), _f32(g.states_map[n][k])
            batch_term = float(np.abs(sj - d * _f32(s0[n][k])).max())
            bound = 2 * _bf16_ulp(sj) + 0.05 * batch_term
            worst = float((np.abs(st - sj) / bound).max())
            assert worst <= 1.0, (f"{n}/{k}", worst)


def test_restore_dispatches_on_the_model_type(tmp_path):
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer
    from deeplearning4j_tpu.zoo.lenet import LeNet as JaxLeNet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    gpath, npath = (os.path.join(tmp_path, f) for f in ("g.zip", "n.zip"))
    JaxSerializer.writeModel(JCG(_jax_cut_resnet()).init(), gpath)
    JaxSerializer.writeModel(JaxLeNet(in_shape=(12, 12, 1)).init(), npath)
    assert isinstance(ModelSerializer.restore(gpath, device="cpu"),
                      ComputationGraph)
    assert isinstance(ModelSerializer.restore(npath, device="cpu"),
                      MultiLayerNetwork)


def test_set_params_round_trips():
    g = ComputationGraph(cut_resnet_conf(), device="cpu").init()
    flat = g.params()
    assert flat.numel() == g.numParams()
    g.setParams(torch.zeros_like(flat))
    assert float(g.params().abs().sum()) == 0.0
    g.setParams(flat.numpy())
    assert torch.equal(g.params(), flat)


def test_unported_parts_raise_with_their_roadmap_item():
    g = ComputationGraph(cut_resnet_conf(), device="cpu").init()
    x, y = _batch(n=2)
    # rnnTimeStep, backpropGradient and features masks are ported: they
    # run in tests/test_torch_rnn_features.py and
    # tests/test_torch_external_errors.py
    for call, item in ((lambda: g.setHealthMonitor(object()), "A9"),
                       (lambda: g.fit(x, y, fault_tolerance=object()), "A9"),
                       (lambda: g.fit(x, y, auto_resume=object()), "A9")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    # pretraining is ported (tests/test_torch_pretrain.py): a graph
    # without a pretrainable vertex pretrains nothing, as JAX's does
    before = g.params()
    assert g.pretrain(x) is g and torch.equal(g.params(), before)
    with pytest.raises(ValueError, match="not pretrainable"):
        g.pretrainLayer("fc", x)
    # iterators are ported: a plain Python iterator is no DataSetIterator
    with pytest.raises(TypeError, match="DataSet"):
        g.fit(iter([DataSet(x, y)]))
    with pytest.raises(RuntimeError, match="init"):
        ComputationGraph(cut_resnet_conf(), device="cpu").output(x)
    with pytest.raises(ValueError, match="setInputTypes"):
        ComputationGraph(ComputationGraphConfiguration.graphBuilder()
                         .addInputs("i").addLayer("o", OutputLayer(
                             n_in=2, n_out=2), "i").setOutputs("o").build(),
                         device="cpu").init()


def test_global_pooling_and_nesterovs_come_from_json():
    conf = ComputationGraphConfiguration.from_json(cut_resnet_conf().to_json())
    by_name = {n.name: n.vertex for n in conf.nodes}
    assert isinstance(by_name["avg_pool"].layer, GlobalPoolingLayer)
    assert by_name["stem_conv"].layer.kernel_size == (7, 7)
    assert conf.updater == Nesterovs(0.05, 0.9)
