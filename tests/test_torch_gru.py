"""PyTorch port, the recurrent wrappers of ``nn/conf/layers_extra.py``:
``ops.nn.gru_layer`` (gates r, z, n, the reset after the recurrent
product, the optional recurrent bias) and the layers ``GRU``,
``GravesBidirectionalLSTM`` and ``MaskZeroLayer``, against the JAX package
on the same numpy inputs and weights at f32:

- ``gru_layer`` with and without ``rb`` and ``h0``: outputs, the last
  state and the gradients of a weighted sum with respect to every input;
- ``GRU`` trained three Adam steps beside JAX through
  ``MultiLayerNetwork`` (restored from the JAX zip) and through
  ``ComputationGraph``; ``rnnTimeStep`` step by step against ``output()``
  and against JAX's stepping, in both networks;
- ``GravesBidirectionalLSTM`` against JAX (three steps) and against the
  port's ``Bidirectional(LSTM, "CONCAT")`` with the same parameters;
- ``MaskZeroLayer(LSTM)`` against JAX (three steps), its padded steps
  zero; both refuse ``rnnTimeStep`` where JAX does.

Tolerances: outputs, losses and gradients within 1e-5 of max(1, max
|value|); parameters within 1e-4 absolute after three steps; stepping
against the full sequence within 1e-5.

The cuda-marked tests at the end hold the card (TF32 off) against the CPU
and import no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_gru.py``.
"""

import numpy as np
import pytest
import torch

from torch_twins import (card_vs_cpu, close, numpy_weights,  # noqa: F401
                         pair, pkg, trajectory, two_threads, twins)

from deeplearning4j_tpu_torch.nn.conf import (LSTM, Bidirectional,
                                              GravesBidirectionalLSTM)
from deeplearning4j_tpu_torch.ops import nn as tnn

TOL, LOSS_RTOL, PARAM_ATOL, STEPS = 1e-5, 1e-5, 1e-4, 3
N, T, F, H = 3, 7, 4, 6


def _arrays(h0: bool, rb: bool, seed=0):
    rs = np.random.RandomState(seed)
    a = [rs.randn(N, T, F).astype(np.float32),
         (rs.randn(F, 3 * H) * 0.5).astype(np.float32),
         (rs.randn(H, 3 * H) * 0.5).astype(np.float32),
         rs.randn(3 * H).astype(np.float32)]
    a.append(rs.randn(N, H).astype(np.float32) if h0 else None)
    a.append(rs.randn(3 * H).astype(np.float32) if rb else None)
    return a


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("rb", [False, True])
def test_gru_layer_matches_jax(h0, rb):
    from deeplearning4j_tpu.ops import nn as jnn

    arrays = _arrays(h0, rb)
    keep = [i for i, a in enumerate(arrays) if a is not None]

    def call(op, cat):
        def f(*given):
            a = dict(zip(keep, given))
            ys, hT = op(a[0], a[1], a[2], a[3], h0=a.get(4), rb=a.get(5))
            return cat([ys.reshape(-1), hT.reshape(-1)])
        return f

    pair(call(tnn.gru_layer, torch.cat),
         call(jnn.gru_layer, __import__("jax.numpy").numpy.concatenate),
         [arrays[i] for i in keep], TOL)


def _gru_layers(p, rb=True):
    return [p.X.GRU(n_out=H, recurrent_bias=rb),
            p.Ly.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def _seq_batch(n=N, t=T, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, t, F).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (n, t))]
    return x, y


@pytest.mark.parametrize("rb", [False, True])
def test_gru_network_follows_jax(rb, tmp_path):
    """``GRU`` through ``MultiLayerNetwork``: the JAX zip restored, three
    Adam steps, then ``rnnTimeStep`` (one step at a time, the stored state
    carried) against ``output()`` and against JAX's stepping."""
    jnet, net = twins(lambda p: _gru_layers(p, rb),
                      lambda it: it.recurrent(F, T), tmp_path)
    assert sorted(net.params_list[0]) == (["RW", "Rb", "W", "b"] if rb else
                                          ["RW", "W", "b"])
    x, y = _seq_batch()
    close(net.output(x), np.asarray(jnet.output(x)), TOL, "output")
    trajectory(jnet, net, x, y, STEPS, LOSS_RTOL, PARAM_ATOL,
               lambda m: m.params_list)
    full = net.output(x)
    net.rnnClearPreviousState()
    jnet.rnnClearPreviousState()
    steps = [net.rnnTimeStep(x[:, t]) for t in range(T)]
    jsteps = [np.asarray(jnet.rnnTimeStep(x[:, t:t + 1])) for t in range(T)]
    close(torch.stack(steps, dim=1), full, TOL, "stepping vs output")
    close(torch.stack(steps, dim=1), np.concatenate(jsteps, 1), TOL,
          "stepping vs JAX")


def _gru_graph(p):
    b = (p.G.ComputationGraphConfiguration.graphBuilder().seed(5)
         .updater(p.L.Adam(learning_rate=1e-3)).addInputs("in")
         .setInputTypes(p.C.InputType.recurrent(F)))
    b.addLayer("gru", p.X.GRU(n_out=H, recurrent_bias=True), "in")
    b.addLayer("out", p.Ly.RnnOutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "gru")
    return b.setOutputs("out").build()


def test_gru_graph_follows_jax(tmp_path):
    import jax
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.util import ModelSerializer as JSerializer
    from deeplearning4j_tpu_torch.util.model_serializer import \
        ModelSerializer

    jconf = _gru_graph(pkg(True))
    assert _gru_graph(pkg(False)).to_json() == jconf.to_json()
    jg = JCG(jconf).init()
    path = str(tmp_path / "gru_graph.zip")
    JSerializer.writeModel(jg, path)
    g = ModelSerializer.restore(path, device="cpu")
    x, y = _seq_batch(seed=1)
    trajectory(jg, g, x, y, STEPS, LOSS_RTOL, PARAM_ATOL,
               lambda m: m.params_map)
    full = g.output(x)[0]
    g.rnnClearPreviousState()
    jg.rnnClearPreviousState()
    got = torch.cat([g.rnnTimeStep(x[:, t:t + 2])[0] for t in (0, 2, 4)] +
                    [g.rnnTimeStep(x[:, 6:7])[0]], dim=1)
    want = np.concatenate(
        [np.asarray(jg.rnnTimeStep(x[:, t:t + 2])[0]) for t in (0, 2, 4)] +
        [np.asarray(jg.rnnTimeStep(x[:, 6:7])[0])], 1)
    close(got, full, TOL, "stepping vs output")
    close(got, want, TOL, "stepping vs JAX")
    assert jax is not None


def _graves_layers(p):
    return [p.X.GravesBidirectionalLSTM(n_out=H),
            p.Ly.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def test_graves_bidirectional_lstm_follows_jax(tmp_path):
    jnet, net = twins(_graves_layers, lambda it: it.recurrent(F, T),
                      tmp_path)
    assert net.conf.layers[0].n_in == F
    assert set(net.params_list[0]) == {"fw", "bw"}
    x, y = _seq_batch(seed=2)
    close(net.output(x), np.asarray(jnet.output(x)), TOL, "output")
    trajectory(jnet, net, x, y, STEPS, LOSS_RTOL, PARAM_ATOL,
               lambda m: m.params_list)
    for model in (net, jnet):
        with pytest.raises(NotImplementedError,
                           match="GravesBidirectionalLSTM"):
            model.rnnTimeStep(x[:, :1])


def test_graves_bidirectional_lstm_is_bidirectional_lstm():
    """The same parameters through ``Bidirectional(LSTM(n), "CONCAT")``
    give the same output, bit for bit, and the same gradients."""
    g = GravesBidirectionalLSTM(n_in=F, n_out=H, forget_gate_bias_init=0.5,
                                activation="tanh")
    b = Bidirectional(layer=LSTM(n_in=F, n_out=H, forget_gate_bias_init=0.5,
                                 activation="tanh"), mode="CONCAT")
    it = pkg(False).C.InputType.recurrent(F, T)
    p = g.init_params(torch.Generator().manual_seed(3), it, torch.float32,
                      "cpu")
    q = b.init_params(torch.Generator().manual_seed(3), it, torch.float32,
                      "cpu")
    for d in ("fw", "bw"):
        for k in p[d]:
            assert torch.equal(p[d][k], q[d][k])
        assert torch.all(p[d]["b"][H:2 * H] == 0.5)
    x = torch.from_numpy(_seq_batch()[0]).requires_grad_(True)
    y1, _ = g.apply(p, {}, x, False, None)
    y2, _ = b.apply(p, {}, x, False, None)
    assert torch.equal(y1, y2) and y1.shape == (N, T, 2 * H)
    g1 = torch.autograd.grad(y1.sum(), x)[0]
    g2 = torch.autograd.grad(y2.sum(), x)[0]
    assert torch.equal(g1, g2)


def _mask_zero_layers(p):
    return [p.X.MaskZeroLayer(layer=p.Ly.LSTM(n_out=H), mask_value=0.0),
            p.Ly.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def test_mask_zero_layer_follows_jax(tmp_path):
    jnet, net = twins(_mask_zero_layers, lambda it: it.recurrent(F, T),
                      tmp_path)
    assert net.conf.layers[0].layer.n_in == F
    x, y = _seq_batch(seed=3)
    x[0, 4:] = 0.0           # padded rows: every feature at the mask value
    x[2, 5:] = 0.0
    close(net.output(x), np.asarray(jnet.output(x)), TOL, "output")
    trajectory(jnet, net, x, y, STEPS, LOSS_RTOL, PARAM_ATOL,
               lambda m: m.params_list)
    hidden = net.feedForward(x)[1]
    assert torch.all(hidden[0, 4:] == 0) and torch.all(hidden[2, 5:] == 0)
    assert torch.all(hidden[1].abs().sum(-1) > 0)


# -------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("rb", [False, True])
def test_cuda_gru_layer_matches_the_cpu(card, rb):
    arrays = [a for a in _arrays(True, rb) if a is not None]

    def f(x, wi, wh, b, h0, *rest):
        ys, hT = tnn.gru_layer(x, wi, wh, b, h0=h0,
                               rb=rest[0] if rest else None)
        return torch.cat([ys.reshape(-1), hT.reshape(-1)])

    card_vs_cpu(f, arrays, card, TOL)


@pytest.mark.cuda
def test_cuda_graves_bidirectional_lstm_launches_b5(card):
    """On the card ``GravesBidirectionalLSTM`` runs the LSTM kernels: two
    forward launches (one a direction) and, with a backward, two more;
    its output and input gradient match the CPU's plain versions."""
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    g = GravesBidirectionalLSTM(n_in=F, n_out=H)
    p = g.init_params(torch.Generator().manual_seed(0),
                      pkg(False).C.InputType.recurrent(F, T), torch.float32,
                      "cpu")
    names = [(d, k) for d in ("fw", "bw") for k in sorted(p[d])]
    arrays = [_seq_batch()[0]] + [p[d][k].numpy() for d, k in names]

    def f(x, *ps):
        tree = {"fw": {}, "bw": {}}
        for (d, k), v in zip(names, ps):
            tree[d][k] = v
        return g.apply(tree, {}, x, False, None)[0]

    f0, b0 = lr.fwd_launches, lr.bwd_launches
    card_vs_cpu(f, arrays, card, TOL)
    assert (lr.fwd_launches - f0, lr.bwd_launches - b0) == (2, 2)
