"""PyTorch port, model health: ``deeplearning4j_tpu_torch.profiler.model_health``
against the JAX package's ``HealthMonitor`` on the same weights (carried
in the JAX package's zip) and the same batches.

- ``grad_norms``, ``param_norms``, ``update_ratios``, the non-finite
  layers and ``nonfinite_first_layer`` equal JAX's ``HealthMonitor.last``
  within f32 tolerance (1e-5 relative, 1e-6 absolute), for
  MultiLayerNetwork, ComputationGraph and truncated-BPTT segments; a
  poisoned layer and a poisoned input are named the same in both; an
  overflow that ``mixed_float16`` handled reads clean in both (norms at
  f16's 2^-10).
- A monitored run is bit-equal to an unmonitored one (the statistics only
  read), and so is a run whose monitor was attached and detached.
- One read-back per sampled step (``fetches``).
- The FLOP count of the char-LSTM step at test widths (vocabulary 5,
  hidden 4, batch 2 x 6 steps) equals the analytic sum of 2*M*N*K over
  its matrix products stated below; XLA's ``cost_analysis`` of the JAX
  step is printed beside it, not asserted (it counts every elementwise
  operation too). The LSTM kernel's per-launch count equals what
  ``FlopCounterMode`` sees of its plain versions.
- MFU is omitted on a device with no peak entry, and filled in with one.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr
from deeplearning4j_tpu_torch.profiler import (chaos, flops, model_health,
                                               telemetry)
from deeplearning4j_tpu_torch.profiler.model_health import HealthMonitor
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
from deeplearning4j_tpu_torch.util.resilience import FaultTolerance
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _data(n=16, n_in=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


X, Y = _data()


def _jax_mln(layers=2, seed=3, precision=None):
    from deeplearning4j_tpu.learning import Adam
    from deeplearning4j_tpu.nn.conf import (DenseLayer, InputType,
                                            NeuralNetConfiguration,
                                            OutputLayer)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    b = NeuralNetConfiguration.builder().seed(seed).updater(Adam(0.01))
    if precision:
        b = b.precision(precision)
    lb = b.list()
    for _ in range(layers - 1):
        lb = lb.layer(DenseLayer(n_out=6, activation="tanh"))
    lb = lb.layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
    return MultiLayerNetwork(
        lb.setInputType(InputType.feedForward(4)).build()).init()


def _jax_cg(seed=3):
    from deeplearning4j_tpu.learning import Adam
    from deeplearning4j_tpu.nn.conf import DenseLayer, InputType, OutputLayer
    from deeplearning4j_tpu.nn.graph import (ComputationGraph,
                                             ComputationGraphConfiguration)

    conf = (ComputationGraphConfiguration.graphBuilder().seed(seed)
            .updater(Adam(0.01)).addInputs("in")
            .addLayer("a", DenseLayer(n_out=6, activation="tanh"), "in")
            .addLayer("b", DenseLayer(n_out=5, activation="relu"), "a")
            .addLayer("out", OutputLayer(n_out=3, activation="softmax",
                                         loss="mcxent"), "b")
            .setOutputs("out").setInputTypes(InputType.feedForward(4))
            .build())
    return ComputationGraph(conf).init()


def _jax_textgen(tbptt):
    from deeplearning4j_tpu.zoo import TextGenerationLSTM as JTextGen

    return JTextGen(vocab_size=5, hidden=4, seed=8,
                    tbptt_length=tbptt).init()


def _twin(jnet, tmp_path):
    """The port network of the JAX network's zip (configuration, weights,
    updater state)."""
    from deeplearning4j_tpu.util import ModelSerializer as JSer

    path = str(tmp_path / "twin.zip")
    JSer.writeModel(jnet, path)
    return ModelSerializer.restore(path, load_updater=True, device="cpu")


def _char_batch(n=2, t=6, v=5, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, (n, t))
    eye = np.eye(v, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, 1)]


def _assert_same_sample(got, want, rtol=RTOL):
    for key in ("grad_norms", "param_norms", "update_ratios"):
        assert list(got[key]) == list(want[key]), key
        np.testing.assert_allclose(
            [got[key][k] for k in want[key]],
            [float(want[key][k]) for k in want[key]],
            rtol=rtol, atol=ATOL, err_msg=key)
    for key in ("nonfinite_layers", "nonfinite_first_layer",
                "nonfinite_layer_name", "handled_overflow",
                "handled_overflow_layer", "iteration"):
        assert got[key] == want[key], key


def _fit_both(jnet, net, batches, rtol=RTOL):
    from deeplearning4j_tpu.profiler.model_health import \
        HealthMonitor as JHealthMonitor

    jhm, hm = JHealthMonitor(frequency=1), HealthMonitor(frequency=1)
    jnet.setHealthMonitor(jhm)
    net.setHealthMonitor(hm)
    for x, y in batches:
        jnet.fit(x, y)
        net.fit(x, y)
        _assert_same_sample(hm.last, jhm.last, rtol)
    return jhm, hm


# ------------------------------------------------------------- parity
@pytest.mark.parametrize("kind", ["mln", "cg", "tbptt"])
def test_health_matches_jax(kind, tmp_path):
    if kind == "mln":
        jnet = _jax_mln(layers=3)
        batches = [_data(seed=s) for s in range(3)]
    elif kind == "cg":
        jnet = _jax_cg()
        batches = [_data(seed=s) for s in range(3)]
    else:
        jnet = _jax_textgen(tbptt=3)
        batches = [_char_batch(t=9, seed=s) for s in range(2)]
    net = _twin(jnet, tmp_path)
    jhm, hm = _fit_both(jnet, net, batches)
    assert len(hm.last["grad_norms"]) == len(
        net.conf.layers if kind != "cg" else net.conf.nodes)
    assert hm.last["nonfinite_first_layer"] == -1
    if kind == "tbptt":     # 3 segments of 3 steps per fit
        assert net.getIterationCount() == 6 and hm.fetches == 6


@pytest.mark.parametrize("poison", ["weight", "input"])
def test_the_poisoned_layer_is_named_as_in_jax(poison, tmp_path):
    import jax.numpy as jnp

    jnet = _jax_mln(layers=3)
    net = _twin(jnet, tmp_path)
    x = X.copy()
    if poison == "weight":
        jnet.params_list[1]["W"] = \
            jnet.params_list[1]["W"].at[0, 0].set(jnp.nan)
        w = net.params_list[1]["W"].clone()
        w[0, 0] = float("nan")
        net.params_list[1]["W"] = w
    else:
        x[0, 0] = np.nan
    jhm, hm = _fit_both(jnet, net, [(x, Y)])
    want = 1 if poison == "weight" else 0
    assert hm.last["nonfinite_first_layer"] == want
    assert hm.nonfinite_label() == jhm.nonfinite_label() == \
        ["0:DenseLayer", "1:DenseLayer"][want]
    assert telemetry.MetricsRegistry.get_default().gauge(
        telemetry.NONFINITE_FIRST_LAYER).value(site="mln") == want


def test_a_handled_f16_overflow_reads_clean_as_in_jax(tmp_path):
    """The norms at f16's rounding (2^-10 relative): XLA's CPU compiler
    keeps excess precision inside its f16 fusions, the port rounds every
    f16 op (``test_torch_mixed_precision.py``); the provenance fields are
    exact."""
    jnet = _jax_mln(precision="mixed_float16")
    net = _twin(jnet, tmp_path)
    big = np.full_like(X, 1e7)              # inf once staged to f16
    jhm, hm = _fit_both(jnet, net, [(X, Y), (big, Y)], rtol=2.0 ** -10)
    assert hm.last["handled_overflow"]
    assert hm.last["nonfinite_first_layer"] == -1
    assert all(v == 0.0 for v in hm.last["update_ratios"].values())


# ------------------------------------------------------- cost contract
def _pair(seed=11):
    a = TextGenerationLSTM(vocab_size=5, hidden=4, seed=seed).init(
        device="cpu")
    b = TextGenerationLSTM(vocab_size=5, hidden=4, seed=seed).init(
        device="cpu")
    return a, b


def _bit_equal(a, b):
    for pa, pb in zip(a.params_list + a.opt_states,
                      b.params_list + b.opt_states):
        for k in pa:
            if torch.is_tensor(pa[k]):
                assert torch.equal(pa[k], pb[k]), k
            else:
                _bit_equal_tree(pa[k], pb[k])


def _bit_equal_tree(a, b):
    if isinstance(a, dict):
        for k in a:
            _bit_equal_tree(a[k], b[k])
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["monitored", "off"])
def test_monitoring_leaves_the_run_bit_equal(mode):
    a, b = _pair()
    if mode == "monitored":
        b.setHealthMonitor(HealthMonitor(frequency=2))
    else:
        b.setHealthMonitor(HealthMonitor(frequency=2)).setHealthMonitor(None)
    for s in range(4):
        x, y = _char_batch(seed=s)
        a.fit(x, y)
        b.fit(x, y)
    _bit_equal(a, b)
    assert float(a.score()) == float(b.score())


def test_one_read_back_per_sampled_step(monkeypatch):
    packs = []
    real = model_health._pack
    monkeypatch.setattr(model_health, "_pack",
                        lambda t: packs.append(1) or real(t))
    net = _pair()[0]
    hm = HealthMonitor(frequency=2)
    net.setHealthMonitor(hm)
    for s in range(6):
        net.fit(*_char_batch(seed=s))
    assert hm.fetches == 3 == len(packs)
    assert telemetry.MetricsRegistry.get_default().counter(
        telemetry.HEALTH_FETCHES).value(site="mln") == 3


def test_a_chaos_nan_batch_labels_the_rollback(tmp_path):
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer, InputType,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(0.01))
            .list().layer(DenseLayer(n_out=6, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .setInputType(InputType.feedForward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.setHealthMonitor(HealthMonitor(frequency=1))
    with chaos.installed(chaos.ChaosConfig(nan_steps=(2,))):
        net.fit(ArrayDataSetIterator(X, Y, 4), epochs=1,
                fault_tolerance=FaultTolerance(
                    divergence_window=4, snapshot_every=1,
                    flight_dir=str(tmp_path)))
    rb = telemetry.MetricsRegistry.get_default().counter(
        telemetry.FT_ROLLBACKS)
    assert rb.value(nonfinite_layer="0:DenseLayer") == 1


# -------------------------------------------------------- FLOPs and MFU
def test_the_char_lstm_step_count_is_analytic():
    """Forward: each LSTM's input projection ``2 N T F 4H`` and recurrent
    product ``2 T N H 4H``, the head ``2 N T H V``. Backward: twice each
    product (input and weight gradients), the first projection once (the
    one-hot input takes no gradient), each recurrence three times (the
    gate recompute, dh and dw)."""
    V, H, N, T = 5, 4, 2, 6
    proj1, proj2 = 2 * N * T * V * 4 * H, 2 * N * T * H * 4 * H
    rec, head = 2 * T * N * H * 4 * H, 2 * N * T * H * V
    want = (proj1 + proj2 + 2 * rec + head) \
        + (proj1 + 2 * proj2 + 2 * 3 * rec + 2 * head)
    net = TextGenerationLSTM(vocab_size=V, hidden=H).init(device="cpu")
    hm = HealthMonitor(frequency=1)
    net.setHealthMonitor(hm)
    x, y = _char_batch(N, T, V)
    net.fit(x, y)
    assert model_health.site_flops("mln_step") == want
    assert telemetry.MetricsRegistry.get_default().gauge(
        telemetry.STEP_FLOPS).value(site="mln_step") == want
    # measured once per input signature, charged to every step
    net.fit(x, y)
    assert model_health.dispatched_flops("mln_step") >= 2 * want
    jnet = _jax_textgen(tbptt=50)
    from deeplearning4j_tpu.profiler.model_health import \
        HealthMonitor as JHealthMonitor
    from deeplearning4j_tpu.profiler import model_health as jmh

    jnet.setHealthMonitor(JHealthMonitor(frequency=1))
    jnet.fit(x, y)
    print(f"char-LSTM step V={V} H={H} N={N} T={T}: port {want} FLOPs "
          f"(2*M*N*K of the matrix products); XLA cost_analysis of the JAX "
          f"step {jmh.site_flops('mln_step')}")


@pytest.mark.parametrize("steps,n,hidden", [(6, 2, 4), (3, 5, 8)])
def test_the_lstm_kernel_count_matches_its_plain_versions(steps, n, hidden):
    from torch.utils.flop_counter import FlopCounterMode

    g = torch.Generator().manual_seed(0)
    xp = torch.randn(steps, n, 4 * hidden, generator=g)
    w = torch.randn(hidden, 4 * hidden, generator=g) * 0.3
    h0, c0 = torch.zeros(n, hidden), torch.zeros(n, hidden)
    with FlopCounterMode(display=False) as fc:
        ys, _, _, cs = lr.lstm_recurrence_reference(xp, w, h0, c0, True)
    assert fc.get_total_flops() == lr.kernel_flops(steps, n, hidden)
    with FlopCounterMode(display=False) as fc:
        lr.lstm_recurrence_backward_reference(xp, w, h0, c0, ys, cs,
                                              torch.ones_like(ys))
    # the kernel's own products, plus the weight gradient's matmul that
    # runs after it (FlopCounterMode counts that one on the card too)
    dw = 2 * hidden * steps * n * 4 * hidden
    assert fc.get_total_flops() == lr.kernel_flops(
        steps, n, hidden, backward=True) + dw


def test_mfu_is_omitted_without_a_peak_entry():
    net = _pair()[0]
    hm = HealthMonitor(frequency=1)
    net.setHealthMonitor(hm)
    for s in range(3):
        net.fit(*_char_batch(seed=s))
    assert "mfu" not in hm.last
    assert telemetry.MetricsRegistry.get_default().peek(telemetry.MFU) is None


def test_mfu_is_filled_in_with_a_peak_entry(monkeypatch):
    monkeypatch.setitem(flops.PEAK_FLOPS, "cpu", {"bf16": 1e9, "f32": 1e9})
    net = _pair()[0]
    hm = HealthMonitor(frequency=1)
    net.setHealthMonitor(hm)
    for s in range(3):
        net.fit(*_char_batch(seed=s))
    mfu = hm.last["mfu"]
    assert 0 < mfu < 1e3
    assert telemetry.MetricsRegistry.get_default().gauge(
        telemetry.MFU).value(site="mln") == mfu


def test_a_monitor_moved_to_another_model_relabels():
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph, ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer, InputType,
                                                  OutputLayer)

    hm = HealthMonitor(frequency=1, mfu=False)
    net = _pair()[0].setHealthMonitor(hm)
    net.fit(*_char_batch())
    assert list(hm.last["grad_norms"]) == ["0:LSTM", "1:LSTM",
                                           "2:RnnOutputLayer"]
    conf = (ComputationGraphConfiguration.graphBuilder().addInputs("in")
            .addLayer("d", DenseLayer(n_out=3), "in")
            .addLayer("o", OutputLayer(n_out=3, loss="mcxent",
                                       activation="softmax"), "d")
            .setOutputs("o").setInputTypes(InputType.feedForward(4)).build())
    g = ComputationGraph(conf, device="cpu").init().setHealthMonitor(hm)
    g.fit(X, Y)
    assert list(hm.last["grad_norms"]) == ["d", "o"]
    assert hm.latest() is hm.last


def test_the_monitor_adds_few_launches_per_step():
    """The statistics cost a few operations whatever the number of
    parameter leaves: one probe per vertex for the flags, and a handful of
    batched reductions (the step's host is what they cost on ResNet-50)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += not func.is_view      # views launch nothing
            return func(*args, **(kwargs or {}))

    g = ComputationGraph(cut_resnet_conf(), device="cpu").init()
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    y = np.eye(4, dtype=np.float32)[[0, 1]]
    g.fit(x, y)

    def ops(monitor):
        g.setHealthMonitor(monitor)
        Count.n = 0
        with Count():
            g.fit(x, y)
        return Count.n

    plain = ops(None)
    hm = HealthMonitor(frequency=100, mfu=False)
    ops(hm)                            # the segment indices, once
    extra = ops(hm) - plain
    n_leaves = sum(len(p) for p in g.params_map.values())
    assert extra <= len(g.conf.nodes) + 50, (extra, n_leaves)
