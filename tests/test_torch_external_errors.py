"""PyTorch port, external errors: ``MultiLayerNetwork.backpropGradient``
and ``feedForward`` and ``ComputationGraph.backpropGradient`` against the
JAX package's on the same numpy inputs and weights (dropout off): the
parameter gradients in the ``params_list`` / ``params_map`` layout and
the epsilons at the inputs, in inference mode and in training mode
(batch statistics), through dense layers, a batch norm, an LSTM (B5's
plain versions on the CPU) and the seq2seq graph; then the shape and
count errors, after which the dropout generator is where it was.

Tolerances: gradients and epsilons within rtol 1e-5 / atol 1e-6 (the JAX
tests' own for this seam); activations within 1e-6 of max(1, max |a|).

The cuda-marked test at the end holds the card against the CPU and
imports no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_external_errors.py``.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.params import (cg_params_from_numpy,
                                             mln_params_from_numpy)

RTOL, ATOL, TOL = 1e-5, 1e-6, 1e-6


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    if hasattr(a, "jax"):
        a = a.jax
    return np.asarray(a).astype(np.float32)


def _trees(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
        for k in want:
            _trees(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _trees(g, w, f"{what}/{i}")
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


def _host(tree):
    import jax

    return jax.device_get(tree)


def _pkg(jax_side):
    import types

    if jax_side:
        from deeplearning4j_tpu import learning as L
        from deeplearning4j_tpu.nn import conf as C
        from deeplearning4j_tpu.nn import graph as G
        from deeplearning4j_tpu.nn.conf import layers as Ly
    else:
        from deeplearning4j_tpu_torch import learning as L
        from deeplearning4j_tpu_torch.nn import conf as C
        from deeplearning4j_tpu_torch.nn import graph as G
        from deeplearning4j_tpu_torch.nn.conf import layers as Ly
    return types.SimpleNamespace(L=L, C=C, G=G, Ly=Ly)


def _dense_conf(p, bn=False, seed=1):
    """JAX's ``tests/test_external_errors.py::_net``, with a batch norm
    between the layers where ``bn``."""
    lb = (p.C.NeuralNetConfiguration.builder().seed(seed)
          .updater(p.L.Sgd(learning_rate=0.1)).list()
          .layer(p.Ly.DenseLayer(n_in=4, n_out=8, activation="tanh")))
    if bn:
        lb = lb.layer(p.Ly.BatchNormalization())
    return (lb.layer(p.Ly.OutputLayer(n_in=8, n_out=3, loss="mse",
                                      activation="identity"))
            .setInputType(p.C.InputType.feedForward(4)).build())


def _lstm_conf(p):
    return (p.C.NeuralNetConfiguration.builder().seed(3)
            .updater(p.L.Sgd(0.1)).list()
            .layer(p.Ly.LSTM(n_out=6))
            .layer(p.Ly.RnnOutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .setInputType(p.C.InputType.recurrent(4)).build())


def _mln_twins(build):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    jnet = JMLN(build(_pkg(True))).init()
    net = MultiLayerNetwork(build(_pkg(False)), device="cpu").init()
    net.params_list = mln_params_from_numpy(_host(jnet.params_list),
                                            device="cpu")
    net.states_list = mln_params_from_numpy(_host(jnet.states_list),
                                            device="cpu")
    return jnet, net


# ------------------------------------------------------------ the network
@pytest.mark.parametrize("case, train", [("dense", False), ("dense", True),
                                         ("bn", True), ("bn", False),
                                         ("lstm", False), ("lstm", True)])
def test_mln_backprop_gradient_matches_jax(case, train):
    """Gradients and the input's epsilon of a caller-owned loss ``sum(out
    * W)`` (``dL/d out = W``): ``train`` runs the forward as training does
    (the batch norm on batch statistics)."""
    build = {"dense": _dense_conf, "bn": lambda p: _dense_conf(p, bn=True),
             "lstm": _lstm_conf}[case]
    jnet, net = _mln_twins(build)
    rng = np.random.default_rng(0)
    shape = (5, 7, 4) if case == "lstm" else (5, 4)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[:-1] + (3,)).astype(np.float32)
    jg, jeps = jnet.backpropGradient(x, w, train=train)
    g, eps = net.backpropGradient(x, w, train=train)
    _trees(g, _host(jg), f"{case} grads")
    np.testing.assert_allclose(_f32(eps), _f32(jeps), rtol=RTOL, atol=ATOL)
    assert tuple(eps.shape) == x.shape


def test_mln_feed_forward_matches_jax():
    jnet, net = _mln_twins(lambda p: _dense_conf(p, bn=True))
    x = np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32)
    got, want = net.feedForward(x), jnet.feedForward(x)
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=TOL, atol=TOL,
                                   err_msg=f"activation {i}")
    assert torch.equal(got[-1], net.output(x))


def test_mln_external_loss_descends():
    """JAX's ``test_epsilon_shape_and_descent``: gradient descent on an
    external quadratic loss through ``backpropGradient`` cuts it by 5x."""
    _, net = _mln_twins(lambda p: _dense_conf(p, seed=2))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    target = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))

    def loss():
        out = net.output(x)
        return float(((out - target) ** 2).mean()), out

    l0, out = loss()
    for _ in range(60):
        grads, eps = net.backpropGradient(x, 2.0 * (out - target)
                                          / out.numel(), train=False)
        assert tuple(eps.shape) == x.shape
        net.params_list = [{k: p[k] - 0.5 * g[k] for k in p}
                           for p, g in zip(net.params_list, grads)]
        _, out = loss()
    assert loss()[0] < 0.2 * l0


def test_mln_shape_error_matches_jax_and_keeps_the_generator():
    """A wrong error shape raises ``ValueError`` ("must match") in both
    packages; the port's dropout generator is left where it was, as JAX
    restores its key."""
    jnet, net = _mln_twins(_dense_conf)
    x = np.zeros((2, 4), np.float32)
    bad = np.zeros((2, 7), np.float32)
    with pytest.raises(ValueError, match="must match"):
        jnet.backpropGradient(x, bad)
    state = net._generator.get_state()
    with pytest.raises(ValueError, match="must match"):
        net.backpropGradient(x, bad, train=True)
    assert torch.equal(net._generator.get_state(), state)


# -------------------------------------------------------------- the graph
def _two_inputs(p):
    """JAX's ``test_two_input_graph_epsilons`` graph."""
    return (p.G.ComputationGraphConfiguration.graphBuilder().seed(3)
            .addInputs("a", "b")
            .setInputTypes(p.C.InputType.feedForward(3),
                           p.C.InputType.feedForward(2))
            .addLayer("da", p.Ly.DenseLayer(n_out=6, activation="tanh"), "a")
            .addLayer("db", p.Ly.DenseLayer(n_out=6, activation="tanh"), "b")
            .addVertex("m", p.G.MergeVertex(), "da", "db")
            .addLayer("out", p.Ly.OutputLayer(n_out=2, loss="mse",
                                              activation="identity"), "m")
            .setOutputs("out").build())


def _two_outputs(p):
    """Two outputs, a batch norm on one branch."""
    return (p.G.ComputationGraphConfiguration.graphBuilder().seed(4)
            .addInputs("x").setInputTypes(p.C.InputType.feedForward(3))
            .addLayer("h", p.Ly.DenseLayer(n_out=5, activation="relu"), "x")
            .addLayer("bn", p.Ly.BatchNormalization(), "h")
            .addLayer("o1", p.Ly.OutputLayer(n_out=2, loss="mse",
                                             activation="identity"), "bn")
            .addLayer("o2", p.Ly.OutputLayer(n_out=4, loss="mcxent",
                                             activation="softmax"), "h")
            .setOutputs("o1", "o2").build())


def _graph_twins(build):
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG

    jg = JCG(build(_pkg(True))).init()
    g = ComputationGraph(build(_pkg(False)), device="cpu").init()
    g.params_map = cg_params_from_numpy(g.conf.nodes, _host(jg.params_map),
                                        device="cpu")
    return jg, g


@pytest.mark.parametrize("train", [False, True])
def test_graph_two_inputs_match_jax(train):
    jg, g = _graph_twins(_two_inputs)
    rng = np.random.default_rng(2)
    xa, xb = (rng.normal(size=(4, n)).astype(np.float32) for n in (3, 2))
    w = rng.normal(size=(4, 2)).astype(np.float32)
    jgr, jeps = jg.backpropGradient([xa, xb], [w], train=train)
    gr, eps = g.backpropGradient([xa, xb], [w], train=train)
    _trees(gr, _host(jgr), "grads")
    assert set(eps) == set(jeps) == {"a", "b"}
    for k in eps:
        np.testing.assert_allclose(_f32(eps[k]), _f32(jeps[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_graph_two_outputs_match_jax(train):
    jg, g = _graph_twins(_two_outputs)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    errs = [rng.normal(size=(6, n)).astype(np.float32) for n in (2, 4)]
    jgr, jeps = jg.backpropGradient(x, errs, train=train)
    gr, eps = g.backpropGradient(x, errs, train=train)
    _trees(gr, _host(jgr), "grads")
    np.testing.assert_allclose(_f32(eps["x"]), _f32(jeps["x"]), rtol=RTOL,
                               atol=ATOL)


def test_seq2seq_backprop_gradient_matches_jax():
    """The encoder-decoder: gradients through both LSTMs (the plain
    recurrence and its backward), the broadcast and the merge, and both
    inputs' epsilons."""
    from deeplearning4j_tpu.models.seq2seq import Seq2SeqLSTM as JS2S
    from deeplearning4j_tpu_torch.models import Seq2SeqLSTM

    jg = JS2S(5, 6, hidden=8, t_in=4, t_out=3).init()
    g = Seq2SeqLSTM(5, 6, hidden=8, t_in=4, t_out=3).init(device="cpu")
    g.params_map = cg_params_from_numpy(g.conf.nodes, _host(jg.params_map),
                                        device="cpu")
    rng = np.random.default_rng(4)
    e = rng.normal(size=(2, 4, 5)).astype(np.float32)
    d = rng.normal(size=(2, 3, 6)).astype(np.float32)
    w = rng.normal(size=(2, 3, 6)).astype(np.float32)
    jgr, jeps = jg.backpropGradient([e, d], [w], train=False)
    gr, eps = g.backpropGradient([e, d], [w], train=False)
    _trees(gr, _host(jgr), "grads")
    for k in ("encoderInput", "decoderInput"):
        np.testing.assert_allclose(_f32(eps[k]), _f32(jeps[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_graph_count_and_shape_errors_match_jax():
    def one(p):
        return (p.G.ComputationGraphConfiguration.graphBuilder().seed(4)
                .addInputs("x").setInputTypes(p.C.InputType.feedForward(3))
                .addLayer("out", p.Ly.OutputLayer(
                    n_out=2, loss="mse", activation="identity",
                    dropout=0.5), "x")
                .setOutputs("out").build())

    jg, g = _graph_twins(one)
    x = np.zeros((2, 3), np.float32)
    e2 = np.zeros((2, 2), np.float32)
    for args, match in ((([x], [e2, e2]), "one external error"),
                        (([x, x], [e2]), "one input per"),
                        (([x], [np.zeros((2, 5), np.float32)]),
                         "external error for output 'out' has shape")):
        with pytest.raises(ValueError, match=match):
            jg.backpropGradient(*args)
        state = g._generator.get_state()
        with pytest.raises(ValueError, match=match):
            g.backpropGradient(*args)
        assert torch.equal(g._generator.get_state(), state)
    # a good call in training mode draws dropout from the generator
    state = g._generator.get_state()
    g.backpropGradient([x], [e2], train=True)
    assert not torch.equal(g._generator.get_state(), state)


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_backprop_gradient_on_the_card_matches_the_cpu():
    """The seq2seq graph's external-error gradients on the card (B5
    forward and backward) against the CPU at f32, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deeplearning4j_tpu_torch.models import Seq2SeqLSTM
    from deeplearning4j_tpu_torch.params import tree_leaves

    cpu = Seq2SeqLSTM(5, 6, hidden=64, t_in=4, t_out=3).init(device="cpu")
    card = Seq2SeqLSTM(5, 6, hidden=64, t_in=4, t_out=3).init()
    card.params_map = {n: {k: v.cuda() for k, v in p.items()}
                       for n, p in cpu.params_map.items()}
    rng = np.random.default_rng(5)
    e = rng.normal(size=(3, 4, 5)).astype(np.float32)
    d = rng.normal(size=(3, 3, 6)).astype(np.float32)
    w = rng.normal(size=(3, 3, 6)).astype(np.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ga, ea = card.backpropGradient([e, d], [w], train=False)
        gb, eb = cpu.backpropGradient([e, d], [w], train=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5, atol=1e-6)
    for k in eb:
        np.testing.assert_allclose(_f32(ea[k]), _f32(eb[k]), rtol=1e-5,
                                   atol=1e-6)
