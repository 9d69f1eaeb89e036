"""PyTorch port, the recurrent family of layers and the recurrent graph's
features: ``Bidirectional`` in its four modes and with
``return_sequences=False``, ``SimpleRnn``, the ``LastTimeStep`` wrapper,
``EmbeddingLayer`` and ``EmbeddingSequenceLayer``, the loss layers
(``LossLayer``, ``CnnLossLayer``, ``RnnLossLayer``), masked global pooling
on both networks, features masks on the graph, and
``ComputationGraph.rnnTimeStep`` with its state accessors; each against
the JAX package on the same numpy inputs, the JAX networks' weights
carried across by numpy trees or the JAX zip (nested trees both ways).

Tolerances: layer outputs and losses within 1e-6 of max(1, max |value|)
at f32; training steps: losses within 1e-5 relative, parameters within
rtol 1e-5 / atol 1e-6 after three steps; stepping against the full
sequence within 1e-5 (JAX's own test tolerance for it).

The cuda-marked tests at the end hold the card against the CPU and
import no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_rnn_features.py``.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import (
    LSTM, Bidirectional, CnnLossLayer, EmbeddingLayer, EmbeddingSequenceLayer,
    InputType, LossLayer, MultiLayerConfiguration, RnnLossLayer, SimpleRnn)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.params import (cg_params_from_numpy,
                                             mln_params_from_numpy,
                                             tree_leaves)
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

TOL, LOSS_RTOL, RTOL, ATOL, STEP_TOL = 1e-6, 1e-5, 1e-5, 1e-6, 1e-5


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    if hasattr(a, "jax"):
        a = a.jax
    return np.asarray(a).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _trees(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
        for k in want:
            _trees(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _trees(g, w, f"{what}/{i}")
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


def _host(tree):
    import jax

    return jax.device_get(tree)


def _pkg(jax_side: bool):
    """The layer framework of one package, as a namespace of names."""
    import types

    if jax_side:
        from deeplearning4j_tpu import learning as L
        from deeplearning4j_tpu.nn import conf as C
        from deeplearning4j_tpu.nn import graph as G
        from deeplearning4j_tpu.nn.conf import layers as Ly
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as M
    else:
        from deeplearning4j_tpu_torch import learning as L
        from deeplearning4j_tpu_torch.nn import conf as C
        from deeplearning4j_tpu_torch.nn import graph as G
        from deeplearning4j_tpu_torch.nn.conf import layers as Ly
        from deeplearning4j_tpu_torch.nn.multilayer import (
            MultiLayerNetwork as M)
    return types.SimpleNamespace(L=L, C=C, G=G, Ly=Ly, MLN=M)


def _mln_conf(p, make_layer, n_out=3, seed=7, updater=None, head="rnn",
              n_in=4, t=-1):
    """JAX's ``tests/test_rnn_features.py::_rnn_net`` in either package:
    one recurrent layer (``make_layer(p)``) and a head."""
    head_layer = (p.Ly.RnnOutputLayer(n_out=n_out, activation="softmax",
                                      loss="mcxent") if head == "rnn" else
                  p.Ly.OutputLayer(n_out=n_out, activation="softmax",
                                   loss="mcxent"))
    lb = (p.C.NeuralNetConfiguration.builder().seed(seed)
          .updater(updater(p) if updater else p.L.Sgd(0.1)).list()
          .layer(make_layer(p)).layer(head_layer)
          .setInputType(p.C.InputType.recurrent(n_in, t)))
    return lb.build()


def _twins(make_layer, **kw):
    """The JAX network and the port's from its JSON with JAX's weights."""
    jp, tp = _pkg(True), _pkg(False)
    jconf = _mln_conf(jp, make_layer, **kw)
    conf = _mln_conf(tp, make_layer, **kw)
    assert conf.to_json() == jconf.to_json()
    jnet = jp.MLN(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    net.params_list = mln_params_from_numpy(_host(jnet.params_list),
                                            device="cpu")
    return jnet, net


def _seq(n=3, t=6, f=4, seed=0):
    return np.random.RandomState(seed).randn(n, t, f).astype(np.float32)


# ---------------------------------------------------------- Bidirectional
@pytest.mark.parametrize("mode", ["CONCAT", "ADD", "MUL", "AVERAGE"])
def test_bidirectional_modes_match_jax(mode):
    """Each merge mode: the JSON (the wrapped LSTM given the network's
    defaults), the parameter tree ``{"fw", "bw"}``, the forward output and
    three SGD steps."""
    jnet, net = _twins(lambda p: p.Ly.Bidirectional(
        layer=p.Ly.LSTM(n_out=5), mode=mode))
    assert sorted(net.params_list[0]) == ["bw", "fw"]
    assert net.params_list[1]["W"].shape[0] == (10 if mode == "CONCAT"
                                                 else 5)
    x = _seq(seed=1)
    _close(net.output(x), jnet.output(x), TOL, mode)
    y = np.eye(3, dtype=np.float32)[np.random.RandomState(2).randint(
        0, 3, (3, 6))]
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        assert abs(net.score() - float(jnet.score())) <= LOSS_RTOL * abs(
            float(jnet.score()))
    _trees(net.params_list, _host(jnet.params_list), mode)


def test_bidirectional_without_sequences_matches_jax():
    """``return_sequences=False``: the forward direction's last step
    beside the backward direction's output at input step 0."""
    jnet, net = _twins(lambda p: p.Ly.Bidirectional(
        layer=p.Ly.LSTM(n_out=5), return_sequences=False), head="ff")
    x = _seq(seed=3)
    _close(net.output(x), jnet.output(x), TOL, "last steps")
    assert tuple(net.output(x).shape) == (3, 3)


def test_bidirectional_forward_half_is_the_plain_lstm():
    bi = Bidirectional(layer=LSTM(n_in=4, n_out=5))
    params = bi.init_params(torch.Generator().manual_seed(0),
                            InputType.recurrent(4), torch.float32, "cpu")
    x = torch.from_numpy(_seq(seed=4))
    y, _ = bi.apply(params, {}, x, False, None)
    yf, _ = bi.layer.apply(params["fw"], {}, x, False, None)
    _close(y[..., :5], yf, 0.0, "forward half")


def test_bidirectional_json_round_trips_with_jax():
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMLC

    conf = _mln_conf(_pkg(False), lambda p: p.Ly.Bidirectional(
        layer=p.Ly.LSTM(n_out=5), mode="ADD"))
    js = conf.to_json()
    back = MultiLayerConfiguration.from_json(js)
    assert isinstance(back.layers[0], Bidirectional)
    assert back.layers[0].mode == "ADD" and back.layers[0].layer.n_out == 5
    assert back.layers[0].layer.n_in == 4
    assert JMLC.from_json(js).to_json() == js


def test_bidirectional_refuses_stepping():
    """``rnnTimeStep`` raises ``NotImplementedError`` and truncated BPTT a
    ``ValueError`` naming Bidirectional, as in the JAX package."""
    _, net = _twins(lambda p: p.Ly.Bidirectional(layer=p.Ly.LSTM(n_out=5)))
    with pytest.raises(NotImplementedError, match="full sequence"):
        net.rnnTimeStep(np.zeros((2, 4), np.float32))
    conf = _mln_conf(_pkg(False), lambda p: p.Ly.Bidirectional(
        layer=p.Ly.LSTM(n_out=5)))
    conf.tbptt_fwd_length = conf.tbptt_back_length = 4
    net = MultiLayerNetwork(conf, device="cpu").init()
    y = np.eye(3, dtype=np.float32)[np.zeros((2, 12), int)]
    with pytest.raises(ValueError, match="Bidirectional"):
        net.fit(_seq(n=2, t=12), y)


# ------------------------------------------------- SimpleRnn, LastTimeStep
def test_simple_rnn_matches_jax_and_steps_like_the_full_sequence():
    jnet, net = _twins(lambda p: p.Ly.SimpleRnn(n_out=5))
    x = _seq(n=2, t=5, seed=5)
    full = net.output(x)
    _close(full, jnet.output(x), TOL, "simple rnn")
    steps = torch.stack([net.rnnTimeStep(x[:, t]) for t in range(5)], 1)
    _close(steps, full, STEP_TOL, "stepping")
    assert tuple(net.rnnGetPreviousState(0).shape) == (2, 5)
    y = np.eye(3, dtype=np.float32)[np.random.RandomState(6).randint(
        0, 3, (2, 5))]
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
    _trees(net.params_list, _host(jnet.params_list), "simple rnn steps")


def test_simple_rnn_under_truncated_bptt_matches_jax():
    """A ``SimpleRnn`` carry (``h`` alone, not an LSTM's pair) crosses
    tBPTT segments: 12 steps in segments of 4, three updates, as JAX."""
    def conf(p):
        lb = (p.C.NeuralNetConfiguration.builder().seed(8)
              .updater(p.L.Sgd(0.1)).list()
              .layer(p.Ly.SimpleRnn(n_out=5))
              .layer(p.Ly.RnnOutputLayer(n_out=3, activation="softmax",
                                         loss="mcxent"))
              .setInputType(p.C.InputType.recurrent(4)))
        return lb.tBPTTLength(4).build()

    jp = _pkg(True)
    jnet = jp.MLN(conf(jp)).init()
    net = MultiLayerNetwork(conf(_pkg(False)), device="cpu").init()
    net.params_list = mln_params_from_numpy(_host(jnet.params_list),
                                            device="cpu")
    x = _seq(n=2, t=12, seed=9)
    y = np.eye(3, dtype=np.float32)[np.random.RandomState(9).randint(
        0, 3, (2, 12))]
    jnet.fit(x, y)
    net.fit(x, y)
    assert net.getIterationCount() == jnet.getIterationCount() == 3
    assert abs(net.score() - float(jnet.score())) <= LOSS_RTOL * abs(
        float(jnet.score()))
    _trees(net.params_list, _host(jnet.params_list), "tBPTT params")


def test_simple_rnn_op_matches_jax():
    from deeplearning4j_tpu.ops.nn import simple_rnn_layer as jrnn
    from deeplearning4j_tpu_torch.ops.nn import simple_rnn_layer

    rs = np.random.RandomState(7)
    x, w, rw, b, h0 = (rs.randn(*s).astype(np.float32) for s in
                       ((3, 6, 4), (4, 5), (5, 5), (5,), (3, 5)))
    jys, jh = jrnn(x, w, rw, b, h0=h0)
    ys, h = simple_rnn_layer(*(torch.from_numpy(a) for a in (x, w, rw, b)),
                             h0=torch.from_numpy(h0))
    _close(ys, jys, TOL, "ys")
    _close(h, jh, TOL, "hT")


def test_simple_rnn_infers_its_input_type_without_one():
    """The MLN takes a first ``SimpleRnn`` with ``n_in`` as a recurrent
    input, as the JAX network does."""
    from deeplearning4j_tpu_torch.learning import Sgd
    from deeplearning4j_tpu_torch.nn.conf import (NeuralNetConfiguration,
                                                  RnnOutputLayer)

    conf = (NeuralNetConfiguration.builder().updater(Sgd(0.1)).list()
            .layer(SimpleRnn(n_in=4, n_out=5))
            .layer(RnnOutputLayer(n_in=5, n_out=2)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert tuple(net.output(_seq(n=2, t=3)).shape) == (2, 3, 2)


def test_last_time_step_wrapper_matches_jax():
    """``LastTimeStep(LSTM)``: ``n_in`` found inside the wrapper, the last
    step emitted, stepping through the wrapped layer's carry."""
    jnet, net = _twins(lambda p: p.Ly.LastTimeStep(
        underlying=p.Ly.LSTM(n_out=5)), head="ff")
    assert net.conf.layers[0].underlying.n_in == 4
    assert net.conf.layers[0].is_recurrent
    x = _seq(seed=8)
    _close(net.output(x), jnet.output(x), TOL, "last step")
    a = net.rnnTimeStep(x[:, :3])
    b = net.rnnTimeStep(x[:, 3:])
    _close(b, net.output(x), STEP_TOL, "last step through two chunks")
    assert tuple(a.shape) == (3, 3)


# -------------------------------------------------------------- embeddings
def test_embedding_layers_match_jax():
    """Float ids cast to int32; ``EmbeddingLayer`` drops a trailing axis
    of one, ``EmbeddingSequenceLayer`` keeps ``[N, 1]`` a sequence and
    makes ``[N]`` one; an activation after the lookup."""
    from deeplearning4j_tpu.nn.conf import layers as jl

    w = np.random.RandomState(9).randn(11, 4).astype(np.float32)
    ids2 = np.random.RandomState(10).randint(0, 11, (3, 5)).astype(
        np.float32)
    cases = (("EmbeddingLayer", {}, ids2[..., None]),
             ("EmbeddingLayer", {}, ids2[:, 0]),
             ("EmbeddingLayer", {"activation": "tanh"}, ids2),
             ("EmbeddingSequenceLayer", {}, ids2),
             ("EmbeddingSequenceLayer", {}, ids2[:, :1]),
             ("EmbeddingSequenceLayer", {"activation": "tanh"}, ids2[:, 0]))
    for name, kw, ids in cases:
        want, _ = getattr(jl, name)(n_in=11, n_out=4, **kw).apply(
            {"W": w}, {}, ids, False, None)
        layer = EmbeddingLayer if name == "EmbeddingLayer" else \
            EmbeddingSequenceLayer
        got, _ = layer(n_in=11, n_out=4, **kw).apply(
            {"W": torch.from_numpy(w)}, {}, torch.from_numpy(ids), False,
            None)
        _close(got, want, TOL, f"{name} {ids.shape}")
    it = EmbeddingSequenceLayer(n_in=11, n_out=4, input_length=5)
    assert it.output_type(InputType.feedForward(0)) == InputType.recurrent(
        4, 5)


def test_embedding_sequence_graph_trains_like_jax(tmp_path):
    """``EmbeddingSequenceLayer`` -> ``LSTM`` -> ``RnnOutputLayer`` in a
    graph, three Adam steps from a JAX zip (the embedding's gradient
    scattered to the rows the ids read)."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer

    def conf(p):
        b = (p.G.ComputationGraphConfiguration.graphBuilder().seed(4)
             .updater(p.L.Adam(1e-2)).addInputs("ids")
             .setInputTypes(p.C.InputType.recurrent(1, 7)))
        b.addLayer("embed", p.Ly.EmbeddingSequenceLayer(n_in=13, n_out=6),
                   "ids")
        b.addLayer("lstm", p.Ly.LSTM(n_out=8), "embed")
        b.addLayer("out", p.Ly.RnnOutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "lstm")
        return b.setOutputs("out").build()

    assert conf(_pkg(False)).to_json() == conf(_pkg(True)).to_json()
    jg = JCG(conf(_pkg(True))).init()
    path = os.path.join(tmp_path, "emb.zip")
    JaxSerializer.writeModel(jg, path, save_updater=True)
    g = ModelSerializer.restoreComputationGraph(path, device="cpu")
    rs = np.random.RandomState(11)
    ids = rs.randint(0, 13, (4, 7)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (4, 7))]
    for _ in range(3):
        jg.fit(ids, y)
        g.fit(ids, y)
        assert abs(g.score() - float(jg.score())) <= LOSS_RTOL * abs(
            float(jg.score()))
    _trees(g.params_map, _host(jg.params_map), "params")


# ------------------------------------------------------------- loss layers
@pytest.mark.parametrize("name, shape, loss, act", [
    ("LossLayer", (5, 3), "mse", None),
    ("LossLayer", (5, 3), "mcxent", "softmax"),
    ("CnnLossLayer", (2, 3, 3, 4), "xent", "sigmoid"),
    ("RnnLossLayer", (3, 4, 5), "mcxent", "softmax"),
    ("RnnLossLayer", (3, 4, 5), "mse", "identity")])
def test_loss_layers_match_jax(name, shape, loss, act):
    """Loss value (with a mask on the per-timestep head), the forward
    activation and the gradient of the loss into the activations."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.conf import layers as jl

    rs = np.random.RandomState(12)
    x = rs.randn(*shape).astype(np.float32)
    if loss == "mse":
        y = rs.randn(*shape).astype(np.float32)
    else:
        y = (rs.rand(*shape) > 0.5).astype(np.float32) if loss == "xent" \
            else np.eye(shape[-1], dtype=np.float32)[rs.randint(
                0, shape[-1], shape[:-1])]
    mask = ((rs.rand(*shape[:2]) > 0.3).astype(np.float32)
            if name == "RnnLossLayer" else None)
    kw = {"loss": loss, "activation": act} if act else {"loss": loss}
    jlayer = getattr(jl, name)(**kw)
    layer = {"LossLayer": LossLayer, "CnnLossLayer": CnnLossLayer,
             "RnnLossLayer": RnnLossLayer}[name](**kw)
    assert serde.to_json(layer) == __import__(
        "deeplearning4j_tpu.common.serde", fromlist=["to_json"]).to_json(
        jlayer)
    want, jg = jax.value_and_grad(lambda a: jlayer.loss_value(
        {}, {}, a, jnp.asarray(y), mask))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = layer.loss_value({}, {}, tx, torch.from_numpy(y),
                           None if mask is None else torch.from_numpy(mask))
    got.backward()
    _close(got, want, TOL, "loss")
    _close(tx.grad, jg, TOL, "d activations")
    _close(layer.apply({}, {}, tx, False, None)[0],
           jlayer.apply({}, {}, x, False, None)[0], TOL, "forward")


def test_loss_layer_head_of_a_network_trains_like_jax():
    """Dense -> LossLayer (MCXENT on a softmax) in an MLN: three SGD steps
    equal the JAX network's."""
    def conf(p):
        return (p.C.NeuralNetConfiguration.builder().seed(5)
                .updater(p.L.Sgd(0.2)).list()
                .layer(p.Ly.DenseLayer(n_out=3, activation="identity"))
                .layer(p.Ly.LossLayer(loss="mcxent", activation="softmax"))
                .setInputType(p.C.InputType.feedForward(4)).build())

    jp = _pkg(True)
    jnet = jp.MLN(conf(jp)).init()
    net = MultiLayerNetwork(conf(_pkg(False)), device="cpu").init()
    net.params_list = mln_params_from_numpy(_host(jnet.params_list),
                                            device="cpu")
    rs = np.random.RandomState(13)
    x = rs.randn(6, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 6)]
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
    _trees(net.params_list, _host(jnet.params_list), "params")


# ----------------------------------------------------------- masked pooling
def test_masked_pooling_on_the_mln_matches_jax():
    """LSTM -> masked GlobalPooling(MAX) -> OutputLayer through ``fit`` with
    a features mask (padded steps zeroed at the input, pooled over the
    real ones), three steps; ``output(features_mask=)``."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet

    def conf(p):
        return (p.C.NeuralNetConfiguration.builder().seed(6)
                .updater(p.L.Adam(1e-2)).list()
                .layer(p.Ly.LSTM(n_out=6))
                .layer(p.Ly.GlobalPoolingLayer(pooling_type="max"))
                .layer(p.Ly.OutputLayer(n_out=2, activation="softmax",
                                        loss="mcxent"))
                .setInputType(p.C.InputType.recurrent(4, 8)).build())

    jp = _pkg(True)
    jnet = jp.MLN(conf(jp)).init()
    net = MultiLayerNetwork(conf(_pkg(False)), device="cpu").init()
    net.params_list = mln_params_from_numpy(_host(jnet.params_list),
                                            device="cpu")
    rs = np.random.RandomState(14)
    x = rs.randn(5, 8, 4).astype(np.float32)
    lens = rs.randint(2, 9, 5)
    m = (np.arange(8)[None] < lens[:, None]).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 5)]
    for _ in range(3):
        jnet.fit(JDataSet(x, y, features_mask=m))
        net.fit(DataSet(x, y, features_mask=m))
        assert abs(net.score() - float(jnet.score())) <= LOSS_RTOL * abs(
            float(jnet.score()))
    _trees(net.params_list, _host(jnet.params_list), "params")
    _close(net.output(x, features_mask=m),
           jnet.output(x, features_mask=m), TOL, "masked output")
    assert float((net.output(x) - net.output(x, features_mask=m))
                 .abs().max()) > 1e-4


def _bi_graph_conf(p, vocab=9, width=6, t=10, pooling="avg"):
    """EmbeddingLayer on [N, T, 1] ids -> Bidirectional(LSTM, CONCAT) ->
    masked global pooling -> OutputLayer(2): chip_smoke's phase 18 (d)
    at a small size. Adam's epsilon 1e-4: a gradient that cancels to near
    zero (summed pooling) would turn a 1e-9 rounding difference into an
    lr-sized step at 1e-8."""
    b = (p.G.ComputationGraphConfiguration.graphBuilder().seed(8)
         .updater(p.L.Adam(1e-2, epsilon=1e-4)).addInputs("ids")
         .setInputTypes(p.C.InputType.recurrent(1, t)))
    b.addLayer("embed", p.Ly.EmbeddingLayer(n_in=vocab, n_out=width), "ids")
    b.addLayer("bilstm", p.Ly.Bidirectional(layer=p.Ly.LSTM(n_out=width),
                                            mode="CONCAT"), "embed")
    b.addLayer("pool", p.Ly.GlobalPoolingLayer(pooling_type=pooling),
               "bilstm")
    b.addLayer("out", p.Ly.OutputLayer(n_out=2, activation="softmax",
                                       loss="mcxent"), "pool")
    return b.setOutputs("out").build()


def _bi_batch(n=6, t=10, vocab=9, seed=15):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (n, t, 1)).astype(np.float32)
    lens = rs.randint(3, t + 1, n)
    m = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    return ids, m, np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)]


@pytest.mark.parametrize("pooling", ["avg", "max", "sum", "pnorm"])
def test_bidirectional_graph_with_masked_pooling_from_a_jax_zip(
        tmp_path, pooling):
    """The nested ``{"fw", "bw"}`` trees cross the zip both ways: a JAX
    graph's zip restores in the port, trains three steps with a features
    mask to JAX's losses and parameters, and the port's zip restores in
    the JAX package with the same outputs."""
    from deeplearning4j_tpu.datasets.multi_dataset import (
        MultiDataSet as JMulti)
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer
    from deeplearning4j_tpu_torch.datasets import MultiDataSet

    assert _bi_graph_conf(_pkg(False), pooling=pooling).to_json() == \
        _bi_graph_conf(_pkg(True), pooling=pooling).to_json()
    jg = JCG(_bi_graph_conf(_pkg(True), pooling=pooling)).init()
    path = os.path.join(tmp_path, "bi.zip")
    JaxSerializer.writeModel(jg, path, save_updater=True)
    g = ModelSerializer.restoreComputationGraph(path, device="cpu")
    ids, m, y = _bi_batch()
    for _ in range(3):
        jg.fit(JMulti([ids], [y], features_mask_arrays=[m]))
        g.fit(MultiDataSet([ids], [y], features_mask_arrays=[m]))
        assert abs(g.score() - float(jg.score())) <= LOSS_RTOL * abs(
            float(jg.score()))
    _trees(g.params_map, _host(jg.params_map), "params")
    _trees(g.opt_states, _host(jg.opt_states), "updater")
    _close(g.output(ids, feature_masks=[m])[0],
           jg.output(ids, feature_masks=[m])[0], TOL, "output")
    back = os.path.join(tmp_path, "port.zip")
    ModelSerializer.writeModel(g, back, save_updater=True)
    jb = JaxSerializer.restoreComputationGraph(back, load_updater=True)
    _close(g.output(ids, feature_masks=[m])[0],
           jb.output(ids, feature_masks=[m])[0], TOL, "restored in JAX")


def test_graph_features_mask_errors_match_jax():
    """A wrong number of masks raises ``ValueError``, masks on two inputs
    ``NotImplementedError``, a mask not ``[N, T]`` of a sequence input
    ``NotImplementedError``; JAX raises the same."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG

    def conf(p):
        b = (p.G.ComputationGraphConfiguration.graphBuilder().seed(1)
             .addInputs("a", "b")
             .setInputTypes(p.C.InputType.recurrent(3, 5),
                            p.C.InputType.recurrent(3, 5)))
        b.addVertex("m", p.G.MergeVertex(), "a", "b")
        b.addLayer("out", p.Ly.RnnOutputLayer(n_out=2, loss="mse",
                                              activation="identity"), "m")
        return b.setOutputs("out").build()

    jg = JCG(conf(_pkg(True))).init()
    g = ComputationGraph(conf(_pkg(False)), device="cpu").init()
    x = np.zeros((2, 5, 3), np.float32)
    m = np.ones((2, 5), np.float32)
    for masks, err in (([m], ValueError), ([m, m], NotImplementedError),
                       ([np.ones((2, 4)), None], NotImplementedError)):
        with pytest.raises(err) as je:
            jg.output(x, x, feature_masks=masks)
        with pytest.raises(err) as te:
            g.output(x, x, feature_masks=masks)
        assert type(te.value) is type(je.value)


# ------------------------------------------------------ graph rnnTimeStep
def _step_graph(p):
    """JAX's ``TestGraphRnnTimeStep._net`` in either package."""
    b = (p.G.ComputationGraphConfiguration.graphBuilder().seed(9)
         .addInputs("in").setInputTypes(p.C.InputType.recurrent(4)))
    b.addLayer("lstm", p.Ly.LSTM(n_out=5), "in")
    b.addLayer("out", p.Ly.RnnOutputLayer(n_out=3, activation="identity",
                                          loss="mse"), "lstm")
    return b.setOutputs("out").build()


def _graph_twins(build):
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG

    jg = JCG(build(_pkg(True))).init()
    g = ComputationGraph(build(_pkg(False)), device="cpu").init()
    g.params_map = cg_params_from_numpy(g.conf.nodes, _host(jg.params_map),
                                        device="cpu")
    return jg, g


def test_graph_rnn_time_step_matches_the_full_sequence():
    jg, g = _graph_twins(_step_graph)
    x = np.random.RandomState(3).randn(2, 5, 4).astype(np.float32)
    full = g.output(x)[0]
    _close(full, jg.output(x)[0], TOL, "output")
    steps = torch.stack([g.rnnTimeStep(x[:, t])[0] for t in range(5)], 1)
    _close(steps, full, STEP_TOL, "single steps")
    g.rnnClearPreviousState()
    chunks = torch.cat([g.rnnTimeStep(x[:, :2])[0],
                        g.rnnTimeStep(x[:, 2:])[0]], 1)
    _close(chunks, full, STEP_TOL, "two chunks")
    h, c = g.rnnGetPreviousState("lstm")
    assert tuple(h.shape) == tuple(c.shape) == (2, 5)


def test_graph_rnn_time_step_clear_and_batch_change():
    jg, g = _graph_twins(_step_graph)
    x = np.random.RandomState(5).randn(2, 4).astype(np.float32)
    assert g.rnnGetPreviousState("lstm") is None
    first = g.rnnTimeStep(x)[0]
    _close(first, jg.rnnTimeStep(x)[0], TOL, "first step")
    second = g.rnnTimeStep(x)[0]
    _close(second, jg.rnnTimeStep(x)[0], TOL, "second step")
    assert float((first - second).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="batch size changed"):
        g.rnnTimeStep(np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="expected 1 inputs"):
        g.rnnTimeStep(x, x)
    g.rnnClearPreviousState()
    _close(g.rnnTimeStep(x)[0], first, 0.0, "after clear")
    assert g.rnnGetPreviousState("out") is None


def test_seq2seq_rnn_time_step_advances_both_lstms_as_jax():
    """On the two-input encoder-decoder every recurrent vertex advances,
    the encoder included: the port's single steps equal the JAX graph's
    single steps (not ``output()`` over the sequence, where the decoder
    sees the encoder's last step)."""
    from deeplearning4j_tpu.models.seq2seq import Seq2SeqLSTM as JS2S
    from deeplearning4j_tpu_torch.models import Seq2SeqLSTM

    jg = JS2S(5, 5, hidden=8, t_in=4, t_out=4).init()
    g = Seq2SeqLSTM(5, 5, hidden=8, t_in=4, t_out=4).init(device="cpu")
    g.params_map = cg_params_from_numpy(g.conf.nodes, _host(jg.params_map),
                                        device="cpu")
    rs = np.random.RandomState(6)
    e, d = (rs.randn(2, 4, 5).astype(np.float32) for _ in range(2))
    for t in range(4):
        _close(g.rnnTimeStep(e[:, t], d[:, t])[0],
               jg.rnnTimeStep(e[:, t], d[:, t])[0], TOL, f"step {t}")
    assert set(g._rnn_carries) == {"encoder", "decoder"}
    g.rnnClearPreviousState()
    _close(g.rnnTimeStep(e, d)[0], g.output(e, d)[0], STEP_TOL,
           "one call over the sequence")


# ---------------------------------------------------------------- the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bidirectional_graph_on_the_card_matches_the_cpu(dtype):
    """Phase 18 (d) small: B5 2 + 2 launches a step (the backward
    direction on the flipped input), card against CPU; bf16 within 2e-2
    of the loss."""
    _need_card()
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        conf = _bi_graph_conf(_pkg(False), width=64, t=30)
        conf.dtype = "float32" if dtype == torch.float32 else "bfloat16"
        cpu = ComputationGraph(conf, device="cpu").init()
        card = ComputationGraph(conf, device="cuda").init()
        card.params_map = {n: {k: (v.cuda() if torch.is_tensor(v) else
                                   {kk: vv.cuda() for kk, vv in v.items()})
                               for k, v in p.items()}
                           for n, p in cpu.params_map.items()}
        ids, m, y = _bi_batch(n=8, t=30)
        before = lr.fwd_launches, lr.bwd_launches
        for _ in range(3):
            for g in (cpu, card):
                g.fit(MultiDataSet([ids], [y], features_mask_arrays=[m]))
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            assert abs(card.score() - cpu.score()) <= tol * abs(cpu.score())
        assert (lr.fwd_launches - before[0],
                lr.bwd_launches - before[1]) == (6, 6)
        if dtype == torch.float32:
            for a, b in zip(tree_leaves(card.params_map),
                            tree_leaves(cpu.params_map)):
                np.testing.assert_allclose(_f32(a), _f32(b), atol=2e-5,
                                           rtol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_graph_rnn_time_step_on_the_card_matches_the_cpu():
    _need_card()
    from deeplearning4j_tpu_torch.models import Seq2SeqLSTM

    cpu = Seq2SeqLSTM(5, 5, hidden=64, t_in=4, t_out=4).init(device="cpu")
    card = Seq2SeqLSTM(5, 5, hidden=64, t_in=4, t_out=4).init()
    card.params_map = {n: {k: v.cuda() for k, v in p.items()}
                       for n, p in cpu.params_map.items()}
    rs = np.random.RandomState(6)
    e, d = (rs.randn(2, 4, 5).astype(np.float32) for _ in range(2))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t in range(4):
            _close(card.rnnTimeStep(e[:, t], d[:, t])[0],
                   cpu.rnnTimeStep(e[:, t], d[:, t])[0], 1e-5, f"step {t}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
