"""PyTorch port, the layer framework: ``deeplearning4j_tpu_torch``'s
``MultiLayerNetwork``, configuration builders and JSON, ModelSerializer
reader and ``TextGenerationLSTM`` against the JAX package's on the same
numpy inputs at f32, the JAX network's weights carried across
(``params.mln_params_from_numpy`` or the ModelSerializer zip), never
re-initialised.

Tolerances: losses 1e-5 relative (the RNN loss sums over T, so it is of
order T ln(vocab)), parameters 1e-5 absolute after three Adam steps at
lr 1e-3 (different summation orders; Adam normalises each gradient, so
parity this close also shows the updates are the same), network outputs
1e-5 absolute.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import Adam as JaxAdam
from deeplearning4j_tpu.nn.conf import (
    DenseLayer as JaxDense, InputType as JaxInputType, LSTM as JaxLSTM,
    NeuralNetConfiguration as JaxNNC, OutputLayer as JaxOutput,
    RnnOutputLayer as JaxRnnOutput)
from deeplearning4j_tpu.nn.conf.builder import (
    MultiLayerConfiguration as JaxMLC)
from deeplearning4j_tpu.nn.multilayer.network import (
    MultiLayerNetwork as JaxMLN)
from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer
from deeplearning4j_tpu.zoo.textgen_lstm import (
    TextGenerationLSTM as JaxTextGen)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    LSTM, DenseLayer, InputType, MultiLayerConfiguration,
    NeuralNetConfiguration, OutputLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.params import (bfloat16_from_bits,
                                             mln_params_from_numpy,
                                             numpy_to_tensor)
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

VOCAB, HIDDEN, N, T = 11, 16, 4, 30
LOSS_RTOL, PARAM_ATOL, OUT_ATOL = 1e-5, 1e-5, 1e-5


def _char_batch(seed=0, n=N, t=T, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, t))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, 1)]


def _carry(jnet, conf=None):
    """A port network with the JAX network's configuration (through its
    JSON) and weights (through numpy)."""
    conf = conf or MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.params_list = mln_params_from_numpy(jax.device_get(jnet.params_list),
                                            device="cpu")
    return net


def _assert_params(net, jnet, atol=PARAM_ATOL):
    want = jax.device_get(jnet.params_list)
    assert len(net.params_list) == len(want)
    for i, (p, q) in enumerate(zip(net.params_list, want)):
        assert sorted(p) == sorted(q)
        for k in p:
            np.testing.assert_allclose(p[k].float().numpy(), np.asarray(q[k]),
                                       atol=atol, rtol=0,
                                       err_msg=f"layer {i} {k}")


def _trajectory(net, jnet, batches, fit=None):
    fit = fit or (lambda m, x, y: m.fit(x, y))
    for x, y in batches:
        fit(jnet, x, y)
        fit(net, x, y)
        lj, lt = jnet.score(), net.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    assert net.getIterationCount() == jnet.getIterationCount()
    _assert_params(net, jnet)


# ------------------------------------------------------------------ configs
def test_conf_json_written_by_jax_round_trips():
    jconf = JaxTextGen(vocab_size=VOCAB, hidden=HIDDEN).conf()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert [type(l).__name__ for l in conf.layers] == [
        "LSTM", "LSTM", "RnnOutputLayer"]
    assert [l.n_in for l in conf.layers] == [VOCAB, HIDDEN, HIDDEN]
    assert conf.tbptt_fwd_length == conf.tbptt_back_length == 50
    assert conf.updater == Adam(1e-3)
    assert conf.input_type == InputType.recurrent(VOCAB)
    # back to JAX through the port's JSON: the same configuration
    assert JaxMLC.from_json(conf.to_json()) == jconf
    assert MultiLayerConfiguration.from_json(conf.to_json()) == conf


def test_builders_agree_with_jax():
    def build(nnc, dense, out, it, adam):
        return (nnc.builder().seed(7).updater(adam(0.01)).l2(1e-4)
                .weightInit("relu").list()
                .layer(dense(n_out=12, activation="relu"))
                .layer(out(n_out=3, activation="softmax", loss="mcxent"))
                .setInputType(it.feedForward(5)).build())

    conf = build(NeuralNetConfiguration, DenseLayer, OutputLayer, InputType,
                 Adam)
    jconf = build(JaxNNC, JaxDense, JaxOutput, JaxInputType, JaxAdam)
    assert conf.to_json() == jconf.to_json()


def test_zoo_textgen_conf_matches_jax():
    assert (TextGenerationLSTM(vocab_size=VOCAB, hidden=HIDDEN).conf()
            .to_json() == JaxTextGen(vocab_size=VOCAB, hidden=HIDDEN).conf()
            .to_json())
    net = TextGenerationLSTM().init(device="cpu")
    assert net.numParams() == 887_117
    b = net.params_list[0]["b"]
    assert torch.all(b[256:512] == 1.0) and torch.all(b[:256] == 0.0)


@pytest.mark.parametrize("layer", ["SelfAttentionLayer",
                                   "RecurrentAttentionLayer", "GRU"])
def test_unported_layer_class_is_named(layer):
    """Once the three classes this test held as unported: the JAX JSON of
    each parses into the port's class and writes back equal to JAX's."""
    import dataclasses

    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.nn.conf import layers_extra as jx

    cls = getattr(jl, layer, None) or getattr(jx, layer)
    fields = {f.name for f in dataclasses.fields(cls)}
    jconf = JaxMLC(layers=[cls(n_out=4) if "n_out" in fields else cls()])
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert type(conf.layers[0]).__name__ == layer
    assert conf.to_json() == jconf.to_json()


def test_unported_tag_is_named():
    """A JAX tag the port still lacks (``TrainingConfig`` of
    ``autodiff/``, A10) raises ``NotImplementedError`` naming it."""
    from deeplearning4j_tpu_torch.common import serde

    with pytest.raises(NotImplementedError, match="TrainingConfig"):
        serde.from_json('{"@class": "TrainingConfig"}')


# ------------------------------------------------------------- serializer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_zip_written_by_jax(tmp_path, dtype):
    jconf = JaxTextGen(vocab_size=VOCAB, hidden=HIDDEN, tbptt_length=0).conf()
    jconf.dtype = dtype
    jnet = JaxMLN(jconf).init()
    x, y = _char_batch(1)
    jnet.fit(x, y)
    path = os.path.join(tmp_path, "model.zip")
    JaxSerializer.writeModel(jnet, path, save_updater=True)
    net = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    want_dtype = getattr(torch, dtype)
    assert net.getIterationCount() == 1
    for p, q in zip(net.params_list, jax.device_get(jnet.params_list)):
        for k in q:
            assert p[k].dtype == want_dtype
            np.testing.assert_array_equal(
                p[k].float().numpy(), np.asarray(q[k]).astype(np.float32))
    # without load_updater the moments are fresh; with it, the JAX ones
    assert float(net.opt_states[0]["m"]["W"].abs().max()) == 0.0
    full = ModelSerializer.restoreMultiLayerNetwork(path, load_updater=True,
                                                    device="cpu")
    for o, q in zip(full.opt_states, jax.device_get(jnet.opt_states)):
        for part in ("m", "v"):
            for k in q[part]:
                np.testing.assert_array_equal(o[part][k].numpy(),
                                              np.asarray(q[part][k]))
    out = net.output(x)
    assert out.dtype == want_dtype and out.shape == (N, T, VOCAB)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x).jax),
                                   atol=OUT_ATOL, rtol=0)
    else:
        assert bool(torch.isfinite(out.float()).all())


def test_bfloat16_bits_read_alike_from_either_form():
    """A JAX bfloat16 array and the uint16 view the npz writer stores of it
    become the same torch tensor, with JAX's values."""
    vals = np.array([[0.0, -1.5, 3.140625], [1e-3, 65280.0, -2.0 ** -20]],
                    np.float32)
    arr = np.asarray(jax.numpy.asarray(vals, jax.numpy.bfloat16))
    from_bf16 = numpy_to_tensor(arr)
    from_bits = bfloat16_from_bits(arr.view(np.uint16))
    assert from_bf16.dtype == from_bits.dtype == torch.bfloat16
    assert torch.equal(from_bf16.view(torch.int16),
                       from_bits.view(torch.int16))
    np.testing.assert_array_equal(from_bits.float().numpy(),
                                  arr.astype(np.float32))


# ------------------------------------------------------------ trajectories
@pytest.mark.parametrize("tbptt", [0, 10])
def test_textgen_trajectory_matches_jax(tbptt):
    """Three minibatches of TextGenerationLSTM: standard BPTT (one update
    each) or tBPTT 10 over 30 steps (three updates each, carries reset per
    minibatch)."""
    jnet = JaxTextGen(vocab_size=VOCAB, hidden=HIDDEN, tbptt_length=tbptt,
                      seed=3).init()
    net = _carry(jnet)
    assert net.conf.tbptt_fwd_length == tbptt
    _trajectory(net, jnet, [_char_batch(s) for s in range(3)])
    assert net.getIterationCount() == (9 if tbptt else 3)


@pytest.mark.parametrize("which", ["labels_mask", "features_mask"])
def test_masked_rnn_trajectory_matches_jax(which):
    """A per-timestep label mask folds time into the example axis and
    divides by N (``compute_loss``), through a DataSet. A features mask
    alone also zeroes the padded inputs and stands in for the label
    mask."""
    from deeplearning4j_tpu.datasets import DataSet as JaxDataSet

    jnet = JaxTextGen(vocab_size=VOCAB, hidden=HIDDEN, tbptt_length=0,
                      seed=4).init()
    net = _carry(jnet)
    lens = np.array([30, 21, 9, 1])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    batches = [_char_batch(s) for s in range(3)]

    def fit(m, x, y):
        ds = (JaxDataSet if m is jnet else DataSet)(x, y, **{which: mask})
        m.fit(ds)

    _trajectory(net, jnet, batches, fit)
    if which == "features_mask":
        x = batches[0][0]
        np.testing.assert_allclose(
            net.output(x, features_mask=mask).numpy(),
            np.asarray(jnet.output(x, features_mask=mask).jax),
            atol=OUT_ATOL, rtol=0)


def _mlp(nnc, dense, out, it, adam, **kw):
    b = nnc.builder().seed(42).updater(adam(1e-3))
    if kw.get("l2"):
        b = b.l2(kw["l2"]).l1(kw["l1"])
    if kw.get("clip"):
        b = b.gradientNormalization(kw["clip"], 0.5)
    return (b.list()
            .layer(dense(n_out=64, activation="relu"))
            .layer(dense(n_out=32, activation="tanh"))
            .layer(out(n_out=10, activation="softmax", loss="mcxent"))
            .setInputType(it.feedForward(20)).build())


@pytest.mark.parametrize("kw", [{}, {"l2": 1e-3, "l1": 1e-4},
                                {"clip": "ClipL2PerLayer"},
                                {"clip": "ClipElementWiseAbsoluteValue"},
                                {"clip": "RenormalizeL2PerLayer"}],
                         ids=["plain", "l1l2", "clip_l2", "clip_abs",
                              "renorm"])
def test_mlp_trajectory_matches_jax(kw):
    jnet = JaxMLN(_mlp(JaxNNC, JaxDense, JaxOutput, JaxInputType, JaxAdam,
                       **kw)).init()
    net = _carry(jnet, _mlp(NeuralNetConfiguration, DenseLayer, OutputLayer,
                            InputType, Adam, **kw))
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        x = rng.normal(size=(16, 20)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
        batches.append((x, y))
    _trajectory(net, jnet, batches)
    x = batches[0][0]
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x).jax), atol=OUT_ATOL,
                               rtol=0)


# ------------------------------------------------------------ rnnTimeStep
def test_rnn_time_step_equals_output_and_jax():
    jnet = JaxTextGen(vocab_size=VOCAB, hidden=HIDDEN, seed=6).init()
    net = _carry(jnet)
    x, _ = _char_batch(2, n=3, t=12)
    full = net.output(x)
    steps = torch.stack([net.rnnTimeStep(x[:, t]) for t in range(12)], 1)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), atol=OUT_ATOL,
                               rtol=0)
    jsteps = np.stack([np.asarray(jnet.rnnTimeStep(x[:, t]).jax)
                       for t in range(12)], 1)
    np.testing.assert_allclose(steps.numpy(), jsteps, atol=OUT_ATOL, rtol=0)
    # 3-D input steps T times from the stored state
    net.rnnClearPreviousState()
    first = net.rnnTimeStep(x[:, :5])
    rest = net.rnnTimeStep(x[:, 5:])
    assert first.shape == (3, 5, VOCAB)
    np.testing.assert_allclose(torch.cat([first, rest], 1).numpy(),
                               full.numpy(), atol=OUT_ATOL, rtol=0)
    h, c = net.rnnGetPreviousState(1)
    assert h.shape == c.shape == (3, HIDDEN)
    assert net.rnnGetPreviousState(2) is None


def test_rnn_time_step_state_rules():
    net = TextGenerationLSTM(vocab_size=VOCAB, hidden=HIDDEN).init(
        device="cpu")
    x, _ = _char_batch(0, n=2, t=4)
    assert net.rnnGetPreviousState(0) is None
    with pytest.raises(RuntimeError):
        net.rnnSetPreviousState(0, None)
    out = net.rnnTimeStep(x[:, 0])
    assert out.shape == (2, VOCAB)
    with pytest.raises(ValueError, match="batch size changed"):
        net.rnnTimeStep(x[:1, 1])
    saved = net.rnnGetPreviousState(0)
    net.rnnClearPreviousState()
    net.rnnTimeStep(x[:1, 1])
    net.rnnClearPreviousState()
    net.rnnTimeStep(x[:, 0])
    net.rnnSetPreviousState(0, saved)
    assert net.rnnGetPreviousState(0) is saved


# ----------------------------------------------------------- API surface
def test_params_and_param_table_match_jax():
    jnet = JaxTextGen(vocab_size=VOCAB, hidden=HIDDEN, seed=9).init()
    net = _carry(jnet)
    flat = net.params()
    assert flat.numel() == net.numParams() == jnet.numParams()
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jnet.params().jax))
    table = net.paramTable()
    assert list(table) == list(jnet.paramTable())
    assert list(table)[:3] == ["0_RW", "0_W", "0_b"]


def test_score_on_a_dataset_matches_jax():
    jnet = JaxTextGen(vocab_size=VOCAB, hidden=HIDDEN, seed=8).init()
    net = _carry(jnet)
    x, y = _char_batch(3)
    from deeplearning4j_tpu.datasets import DataSet as JaxDataSet
    want = jnet.score(JaxDataSet(x, y))
    assert abs(net.score(DataSet(x, y)) - want) <= LOSS_RTOL * abs(want)


def test_unported_parts_raise_with_their_roadmap_item():
    net = TextGenerationLSTM(vocab_size=VOCAB, hidden=HIDDEN).init(
        device="cpu")
    x, y = _char_batch(0)
    # the health monitor and the fault-tolerant fit are ported
    # (tests/test_torch_model_health.py, tests/test_torch_resilience.py)
    from deeplearning4j_tpu_torch.profiler.model_health import HealthMonitor
    from deeplearning4j_tpu_torch.util.resilience import FaultTolerance
    hm = HealthMonitor(frequency=1)
    assert net.setHealthMonitor(hm) is net and net.getHealthMonitor() is hm
    it0 = net.getIterationCount()
    net.fit(x, y, fault_tolerance=FaultTolerance(divergence_window=0))
    assert net.getIterationCount() == it0 + 1 and hm.fetches == 1
    assert net.setHealthMonitor(None).getHealthMonitor() is None
    # pretraining is ported (tests/test_torch_pretrain.py): a network
    # without a pretrainable layer pretrains nothing, as JAX's does, and
    # names the layer it cannot pretrain
    before = net.params()
    assert net.pretrain(x) is net and torch.equal(net.params(), before)
    with pytest.raises(ValueError, match="not pretrainable"):
        net.pretrainLayer(0, x)
    # iterators are ported: a plain Python iterator is no DataSetIterator
    with pytest.raises(TypeError, match="DataSetIterator"):
        net.fit(iter([DataSet(x, y)]))
    with pytest.raises(RuntimeError, match="init"):
        MultiLayerNetwork(net.conf, device="cpu").output(x)
