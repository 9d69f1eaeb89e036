"""PyTorch port, the training loop: ``fit`` over iterators, ``evaluate``,
the listeners, early stopping and ``ModelSerializer.writeModel``, through
``MultiLayerNetwork`` and ``ComputationGraph``, against the JAX package's
own runs from the same JAX zip (weights carried across, never
re-initialised).

Tolerances:
- losses step by step within 1e-5 relative, parameters within 2e-5
  absolute after ``fit(iterator, epochs=2)`` (LeNet, the cut ResNet with
  its BN state within 2e-5 of max(1, |value|), a char-LSTM with tBPTT), as
  the array-path tests of ``test_torch_cnn.py`` and ``test_torch_graph.py``
  hold them;
- ``evaluate``'s confusion matrix equal;
- early stopping: the same termination reason, best epoch and epochs,
  scores within 1e-5 relative;
- a zip the port writes (``writeModel``, ``CheckpointListener``) restores
  in the JAX package with outputs within 1e-6 of max(1, max |out|) and
  every array equal.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                               ArrayMultiDataSetIterator,
                                               DataSet, IrisDataSetIterator,
                                               MultiDataSet)
from deeplearning4j_tpu_torch.earlystopping import (
    ClassificationScoreCalculator, DataSetLossCalculator,
    EarlyStoppingConfiguration, EarlyStoppingTrainer, InMemoryModelSaver,
    LocalFileModelSaver, MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition, TerminationReason)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import (
    CheckpointListener, CollectScoresListener, EvaluativeListener,
    PerformanceListener, ScoreIterationListener, TelemetryListener,
    TimeIterationListener, TrainingListener)
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

LOSS_RTOL, PARAM_ATOL, STATE_TOL, OUT_TOL = 1e-5, 2e-5, 2e-5, 1e-6


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, want, tol, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _trees(got, want, tol, what, absolute=False):
    """Leaf by leaf over nested dicts / lists (JAX's tree on the host)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _trees(got[k], want[k], tol, f"{what}/{k}", absolute)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _trees(g, w, tol, f"{what}/{i}", absolute)
    elif absolute:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0,
                                   err_msg=what)
    else:
        _close(got, want, tol, what)


def _host(tree):
    """A JAX tree on the host (JAX is imported only by the CPU tests)."""
    import jax
    return jax.device_get(tree)


def _scores(t, j):
    assert len(t) == len(j) > 0
    for (it, lt), (ij, lj) in zip(t, j):
        assert it == ij
        assert abs(lt - float(lj)) <= LOSS_RTOL * abs(float(lj)), (it, lt,
                                                                   lj)


def _jax_iter(x, y, b, **kw):
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JA
    return JA(x, y, b, **kw)


def _jax_collect():
    from deeplearning4j_tpu.optimize import CollectScoresListener as J
    return J()


class _Epochs(TrainingListener):
    def __init__(self):
        self.ends = 0

    def onEpochEnd(self, model):
        self.ends += 1


# ------------------------------------------------------------------ LeNet
def _lenet_pair(tmp_path):
    from deeplearning4j_tpu.learning import Nesterovs as JN
    from deeplearning4j_tpu.util import ModelSerializer as JSer
    from deeplearning4j_tpu.zoo.lenet import LeNet as JLeNet

    jnet = JLeNet(num_classes=3, in_shape=(12, 12, 1),
                  updater=JN(0.01, 0.9)).init()
    path = str(tmp_path / "lenet.zip")
    JSer.writeModel(jnet, path, save_updater=True)
    return jnet, ModelSerializer.restoreMultiLayerNetwork(
        path, load_updater=True, device="cpu")


def _images(n, hw=12, c=1, classes=3, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, hw, hw, c).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)])


def test_lenet_fit_over_an_iterator_follows_jax(tmp_path):
    """LeNet through ``fit(ArrayDataSetIterator(shuffle=True), epochs=2)``
    in both packages: the same batches, losses, parameters and
    confusion matrix; ``onEpochEnd`` twice, the ETL wait recorded."""
    jnet, net = _lenet_pair(tmp_path)
    x, y = _images(20)
    tc, jc, ends = CollectScoresListener(), _jax_collect(), _Epochs()
    net.setListeners(tc, ends)
    jnet.setListeners(jc)
    net.fit(ArrayDataSetIterator(x, y, 8, shuffle=True, seed=5), epochs=2)
    jnet.fit(_jax_iter(x, y, 8, shuffle=True, seed=5), epochs=2)
    _scores(tc.scores, jc.scores)
    assert net.getIterationCount() == jnet.getIterationCount() == 6
    assert net.getEpochCount() == jnet.getEpochCount() == 2
    assert ends.ends == 2 and net._last_etl_ms is not None
    assert net.getListeners() == [tc, ends]
    _trees(net.params_list, _host(jnet.params_list), PARAM_ATOL,
           "params", absolute=True)
    xe, ye = _images(14, seed=1)
    tv = net.evaluate(ArrayDataSetIterator(xe, ye, 5))
    jv = jnet.evaluate(_jax_iter(xe, ye, 5))
    np.testing.assert_array_equal(tv.confusionMatrix(), jv.confusionMatrix())
    troc = net.evaluateROCMultiClass(ArrayDataSetIterator(xe, ye, 5))
    jroc = jnet.evaluateROCMultiClass(_jax_iter(xe, ye, 5))
    assert abs(troc.calculateAverageAUC() - jroc.calculateAverageAUC()) \
        <= 1e-6
    # a score on a DataSet, and fit(x, y) clears the ETL wait
    from deeplearning4j_tpu.datasets import DataSet as JD

    want = jnet.score(JD(xe, ye))
    assert abs(net.score(DataSet(xe, ye)) - want) <= LOSS_RTOL * abs(want)
    net.fit(xe, ye)
    assert net._last_etl_ms is None


def test_port_written_zips_restore_in_jax(tmp_path):
    """``writeModel`` (with the updater state) and ``CheckpointListener``:
    the JAX package restores the port's zips with every array equal and
    the same outputs; the port restores its own."""
    from deeplearning4j_tpu.util import ModelSerializer as JSer

    _, net = _lenet_pair(tmp_path)
    x, y = _images(16, seed=2)
    ckpt = CheckpointListener(str(tmp_path / "ckpt"),
                              save_every_n_iterations=2, keep_last=2)
    net.setListeners(ckpt)
    net.fit(ArrayDataSetIterator(x, y, 4), epochs=2)      # 8 iterations
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert names == ["checkpoint_iter_6.zip", "checkpoint_iter_8.zip"]
    path = str(tmp_path / "port.zip")
    ModelSerializer.writeModel(net, path, save_updater=True)
    # the last checkpoint was written in the second epoch, before its end
    for p, epoch in ((path, 2), (ckpt.lastCheckpoint(), 1)):
        jnet = JSer.restoreMultiLayerNetwork(p, load_updater=True)
        assert jnet.getIterationCount() == 8
        assert jnet.getEpochCount() == epoch
        _trees(net.params_list, _host(jnet.params_list), 0.0,
               "params")
        _trees(net.opt_states, _host(jnet.opt_states), 0.0,
               "updater")
        _close(net.output(x), np.asarray(jnet.output(x).jax), OUT_TOL,
               "output")
    back = ModelSerializer.restore(path, load_updater=True, device="cpu")
    assert torch.equal(back.output(x), net.output(x))
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_bf16_zip_written_by_the_port_restores_in_jax(tmp_path):
    from deeplearning4j_tpu.util import ModelSerializer as JSer
    from deeplearning4j_tpu_torch.zoo import LeNet

    conf = LeNet(num_classes=3, in_shape=(12, 12, 1)).conf()
    conf.dtype = "bfloat16"
    net = MultiLayerNetwork(conf, device="cpu").init()
    x, y = _images(4, seed=3)
    net.fit(x, y)
    path = str(tmp_path / "bf16.zip")
    ModelSerializer.writeModel(net, path)
    jnet = JSer.restoreMultiLayerNetwork(path)
    for p, q in zip(net.params_list, _host(jnet.params_list)):
        for k in q:
            assert str(q[k].dtype) == "bfloat16"
            np.testing.assert_array_equal(
                p[k].view(torch.int16).numpy(), np.asarray(q[k]).view(
                    np.int16))


# ------------------------------------------------------- the cut ResNet
def test_cut_resnet_fit_over_iterators_follows_jax(tmp_path):
    """The cut ResNet (BN, Nesterovs, l2) from a JAX zip:
    ``fit(DataSetIterator, epochs=2)`` in both packages, and in the port
    the same batches as a ``MultiDataSetIterator``; losses, parameters,
    BN state, the confusion matrix, and the port's zip in JAX."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.util import ModelSerializer as JSer
    from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

    jg = JCG(_jax_cut_resnet()).init()
    path = str(tmp_path / "cut.zip")
    JSer.writeModel(jg, path, save_updater=True)
    graphs = [ModelSerializer.restoreComputationGraph(path, device="cpu")
              for _ in range(2)]
    assert graphs[0].conf == cut_resnet_conf()
    x, y = _images(8, hw=32, c=3, classes=4, seed=4)
    jc = _jax_collect()
    jg.setListeners(jc)
    jg.fit(_jax_iter(x, y, 4), epochs=2)
    for g, data in zip(graphs, (ArrayDataSetIterator(x, y, 4),
                                ArrayMultiDataSetIterator([x], [y], 4))):
        tc, ends = CollectScoresListener(), _Epochs()
        g.setListeners(tc, ends)
        g.fit(data, epochs=2)
        _scores(tc.scores, jc.scores)
        assert ends.ends == 2 and g.getEpochCount() == 2
        _trees(g.params_map, _host(jg.params_map), PARAM_ATOL,
               "params", absolute=True)
        _trees(g.states_map, _host(jg.states_map), STATE_TOL,
               "BN state")
    g = graphs[0]
    tv = g.evaluate(ArrayDataSetIterator(x, y, 4))
    jv = jg.evaluate(_jax_iter(x, y, 4))
    np.testing.assert_array_equal(tv.confusionMatrix(), jv.confusionMatrix())
    out_path = str(tmp_path / "port.zip")
    ModelSerializer.writeModel(g, out_path)
    back = JSer.restore(out_path)
    assert type(back).__name__ == "ComputationGraph"
    _close(g.outputSingle(x), np.asarray(back.outputSingle(x).jax), OUT_TOL,
           "output")


def _jax_cut_resnet():
    from deeplearning4j_tpu.learning import Nesterovs as JN
    from deeplearning4j_tpu.nn.conf import (
        GlobalPoolingLayer as JGlobal, InputType as JIt, OutputLayer as JOut,
        SubsamplingLayer as JSub)
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraphConfiguration as JCGC)
    from deeplearning4j_tpu.zoo.resnet50 import ResNet50 as JaxResNet50

    z = JaxResNet50()
    b = (JCGC.graphBuilder().seed(3).updater(JN(0.05, 0.9))
         .weightInit("relu").l2(1e-4).dataType("float32").addInputs("input")
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


def test_graph_fit_sources_and_their_rules():
    """A ``MultiDataSet`` trains as its arrays do; more than one epoch
    over an iterator that cannot reset is refused, as in JAX."""
    from deeplearning4j_tpu_torch.datasets import MultiDataSetIterator
    from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

    x, y = _images(4, hw=32, c=3, classes=4, seed=6)
    a = ComputationGraph(cut_resnet_conf(), device="cpu").init()
    b = a.clone()
    a.fit(MultiDataSet([x], [y]))
    b.fit(x, y)
    assert float(a.score()) == float(b.score())
    assert torch.equal(a.params(), b.params())

    class OneShot(MultiDataSetIterator):
        def resetSupported(self):
            return False

        def hasNext(self):
            return False

    with pytest.raises(ValueError, match="resettable"):
        a.fit(OneShot(), epochs=2)


# --------------------------------------------------- char-LSTM with tBPTT
def test_char_lstm_with_tbptt_over_an_iterator_follows_jax(tmp_path):
    from deeplearning4j_tpu.util import ModelSerializer as JSer
    from deeplearning4j_tpu.zoo.textgen_lstm import TextGenerationLSTM as JT

    jnet = JT(vocab_size=7, hidden=8, tbptt_length=10, seed=2).init()
    path = str(tmp_path / "lstm.zip")
    JSer.writeModel(jnet, path, save_updater=True)
    net = ModelSerializer.restoreMultiLayerNetwork(path, load_updater=True,
                                                   device="cpu")
    rng = np.random.default_rng(4)
    eye = np.eye(7, dtype=np.float32)
    ids = rng.integers(0, 7, (8, 25))
    x, y = eye[ids], eye[np.roll(ids, -1, 1)]
    tc, jc = CollectScoresListener(), _jax_collect()
    net.setListeners(tc)
    jnet.setListeners(jc)
    net.fit(ArrayDataSetIterator(x, y, 4, shuffle=True), epochs=2)
    jnet.fit(_jax_iter(x, y, 4, shuffle=True), epochs=2)
    assert len(tc.scores) == 12          # 2 epochs x 2 batches x 3 segments
    _scores(tc.scores, jc.scores)
    _trees(net.params_list, _host(jnet.params_list), PARAM_ATOL,
           "params", absolute=True)
    tv = net.evaluate(ArrayDataSetIterator(x, y, 4))
    jv = jnet.evaluate(_jax_iter(x, y, 4))
    np.testing.assert_array_equal(tv.confusionMatrix(), jv.confusionMatrix())


# --------------------------------------------------------- early stopping
def _iris_pair(tmp_path):
    from deeplearning4j_tpu.learning import Sgd as JSgd
    from deeplearning4j_tpu.nn.conf import (DenseLayer as JD,
                                            InputType as JIt,
                                            NeuralNetConfiguration as JNNC,
                                            OutputLayer as JO)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.util import ModelSerializer as JSer

    conf = (JNNC.builder().seed(1).updater(JSgd(0.05)).list()
            .layer(JD(n_out=8, activation="tanh"))
            .layer(JO(n_out=3, activation="softmax", loss="mcxent"))
            .setInputType(JIt.feedForward(4)).build())
    jnet = JMLN(conf).init()
    path = str(tmp_path / "iris.zip")
    JSer.writeModel(jnet, path)
    return jnet, ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")


def _iris(pkg, batch, shuffle=True):
    """Iris batches from the package ``pkg`` (an earlystopping module)."""
    if pkg.__name__.startswith("deeplearning4j_tpu_torch"):
        return IrisDataSetIterator(batch=batch, shuffle=shuffle)
    from deeplearning4j_tpu.datasets import IrisDataSetIterator as JI
    return JI(batch=batch, shuffle=shuffle)


def _es_config(e, saver, iteration_conditions=()):
    """The same configuration from earlystopping module ``e``."""
    return e.EarlyStoppingConfiguration(
        e.DataSetLossCalculator(_iris(e, 150, shuffle=False)),
        [e.ScoreImprovementEpochTerminationCondition(2, 1e-3),
         e.MaxEpochsTerminationCondition(8)],
        list(iteration_conditions), saver)


def test_early_stopping_follows_jax(tmp_path):
    import deeplearning4j_tpu.earlystopping as je
    import deeplearning4j_tpu_torch.earlystopping as te

    jnet, net = _iris_pair(tmp_path)
    res_t = te.EarlyStoppingTrainer(_es_config(te, InMemoryModelSaver()),
                                    net, _iris(te, 50)).fit()
    res_j = je.EarlyStoppingTrainer(_es_config(je, je.InMemoryModelSaver()),
                                    jnet, _iris(je, 50)).fit()
    assert res_t.termination_reason == res_j.termination_reason
    assert res_t.termination_details == res_j.termination_details
    assert res_t.best_model_epoch == res_j.best_model_epoch
    assert res_t.total_epochs == res_j.total_epochs
    assert sorted(res_t.score_vs_epoch) == sorted(res_j.score_vs_epoch)
    for e, s in res_j.score_vs_epoch.items():
        assert abs(res_t.score_vs_epoch[e] - s) <= LOSS_RTOL * abs(s)
    # the saved best is a copy: the recomputed score is the recorded one
    again = DataSetLossCalculator(_iris(te, 150, False)).calculate_score(
        res_t.best_model)
    assert abs(again - res_t.best_model_score) <= 1e-6 * abs(again)
    assert net.getListeners() == []
    # an iteration condition stops both in their first step
    jnet, net = _iris_pair(tmp_path)
    stop_t = te.EarlyStoppingTrainer(_es_config(
        te, InMemoryModelSaver(), [MaxScoreIterationTerminationCondition(
            0.0)]), net, _iris(te, 50)).fit()
    stop_j = je.EarlyStoppingTrainer(_es_config(
        je, je.InMemoryModelSaver(),
        [je.MaxScoreIterationTerminationCondition(0.0)]), jnet,
        _iris(je, 50)).fit()
    assert stop_t.termination_reason == stop_j.termination_reason \
        == TerminationReason.ITERATION_TERMINATION
    assert stop_t.total_epochs == stop_j.total_epochs == 0


def test_early_stopping_saves_to_files(tmp_path):
    net = _iris_net()
    saver = LocalFileModelSaver(str(tmp_path / "es"))
    cfg = EarlyStoppingConfiguration(
        ClassificationScoreCalculator("accuracy", IrisDataSetIterator(
            150, shuffle=False)),
        [MaxEpochsTerminationCondition(3)], model_saver=saver,
        save_last_model=True)
    res = EarlyStoppingTrainer(cfg, net, IrisDataSetIterator(50)).fit()
    assert res.termination_reason == TerminationReason.EPOCH_TERMINATION
    assert res.total_epochs == 3
    best, latest = saver.get_best_model(), saver.get_latest_model()
    assert best.device == latest.device == torch.device("cpu")
    x = np.asarray(IrisDataSetIterator(150, shuffle=False).next().features)
    assert torch.equal(latest.output(x), net.output(x))


# ------------------------------------------------------------- listeners
def test_listeners_report_and_unported_ones_raise():
    net = _iris_net()
    lines = []
    perf = PerformanceListener(frequency=1, printer=lines.append)
    evl = EvaluativeListener(IrisDataSetIterator(150, shuffle=False),
                             frequency=2, printer=lines.append)
    net.setListeners(perf, ScoreIterationListener(3, lines.append))
    net.addListeners(TimeIterationListener(6, lines.append, frequency=3),
                     evl)
    net.fit(IrisDataSetIterator(batch=25), epochs=1)
    assert net.getIterationCount() == 6
    assert any("ETL" in s and "samples/sec" in s for s in lines)
    assert perf.etl_ms is not None and perf.samples_per_sec > 0
    assert [i for i, _ in evl.history] == [2, 4, 6]
    assert any(s.startswith("Score at iteration 3") for s in lines)
    assert any("ETA" in s for s in lines)
    # the telemetry listener is ported: it counts into the registry
    from deeplearning4j_tpu_torch.profiler import telemetry
    tl = TelemetryListener(frequency=2)
    before = telemetry.MetricsRegistry.get_default().counter(
        "dl4j_tpu_iterations_total").total()
    net.setListeners(tl)
    net.fit(IrisDataSetIterator(batch=25), epochs=1)
    reg = telemetry.MetricsRegistry.get_default()
    assert reg.counter("dl4j_tpu_iterations_total").total() - before == 6
    assert reg.gauge("dl4j_tpu_score").total() == pytest.approx(
        float(net.score()))


def _iris_net():
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer, InputType,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)

    conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.05))
            .list().layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .setInputType(InputType.feedForward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_lenet_through_the_prefetcher_on_the_card_is_bit_equal():
    """``fit(DevicePrefetchIterator(...), epochs=2)`` on the card against
    ``fit(x_i, y_i)`` on the same batches: bit-equal parameters (TF32 off,
    cuDNN deterministic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deeplearning4j_tpu_torch.datasets import DevicePrefetchIterator
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.zoo import LeNet

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        zoo = LeNet(num_classes=3, in_shape=(12, 12, 1),
                    updater=Nesterovs(0.01, 0.9))
        a, b = zoo.init(), zoo.init()
        x, y = _images(24, seed=7)
        it = DevicePrefetchIterator(ArrayDataSetIterator(x, y, 8,
                                                         shuffle=True))
        a.fit(it, epochs=2)
        it.shutdown()
        ref = ArrayDataSetIterator(x, y, 8, shuffle=True)
        for _ in range(2):
            for ds in ref:
                b.fit(ds.features, ds.labels)
        assert torch.equal(a.params(), b.params())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = prev


def test_the_lenet_mnist_example_runs_on_the_port(tmp_path):
    """The calls of ``examples/lenet_mnist.py`` on the port at a small
    size: ``MnistDataSetIterator`` over IDX files written here,
    ``fit(iterator, epochs)``, ``evaluate(iterator).stats()``,
    ``ModelSerializer.writeModel`` and a restore."""
    import struct

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import (
        ConvolutionLayer, DenseLayer, InputType, NeuralNetConfiguration,
        OutputLayer, SubsamplingLayer)

    rs = np.random.RandomState(8)
    for stem, n in (("train", 48), ("t10k", 16)):
        with open(tmp_path / f"{stem}-images-idx3-ubyte", "wb") as f:
            f.write(struct.pack(">IIII", 0x803, n, 28, 28))
            f.write(rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
                    .tobytes())
        with open(tmp_path / f"{stem}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">II", 0x801, n))
            f.write(rs.randint(0, 10, n).astype(np.uint8).tobytes())
    conf = (NeuralNetConfiguration.builder()
            .seed(123).updater(Adam(learning_rate=1e-3)).list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=6, kernel_size=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .setInputType(InputType.convolutionalFlat(28, 28, 1))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    train_it = MnistDataSetIterator(16, train=True, data_dir=str(tmp_path))
    test_it = MnistDataSetIterator(16, train=False, data_dir=str(tmp_path))
    net.fit(train_it, epochs=2)
    assert net.getIterationCount() == 6 and net.getEpochCount() == 2
    ev = net.evaluate(test_it)
    assert ev.getNumRowCounter() == 16 and "Accuracy" in ev.stats()
    path = str(tmp_path / "lenet-mnist.zip")
    ModelSerializer.writeModel(net, path, True)
    back = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    test_it.reset()
    x = test_it.next().features
    assert torch.equal(back.output(x), net.output(x))
