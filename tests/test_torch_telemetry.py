"""PyTorch port, telemetry: ``deeplearning4j_tpu_torch.profiler.telemetry``,
``flops`` and ``flight_recorder`` against the JAX package's modules.

- the same ``inc`` / ``set`` / ``observe`` sequence, labels included, on a
  registry of each package renders the same ``to_prometheus()`` text and
  the same ``to_json()``: HELP and TYPE lines, label and help escaping,
  non-finite values, histogram buckets;
- every metric-name constant of the JAX module is in the port, spelled
  the same;
- spans nest, the Chrome trace parses, a disabled registry records
  nothing;
- a port fit over an iterator fills the ``etl_wait``, ``device_step`` and
  ``listener_host`` phases (MultiLayerNetwork and ComputationGraph), and
  the ``mixed_float16`` loss-scale series by site;
- the memory sampler returns ``{}`` on the CPU, the peak table holds the
  H100 and omits the rest, and a port incident dump passes the JAX
  package's ``load_dump``.
"""

import json
import logging
import math
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                               DevicePrefetchIterator)
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (DenseLayer, InputType,
                                              NeuralNetConfiguration,
                                              OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import TelemetryListener
from deeplearning4j_tpu_torch.profiler import flight_recorder, flops, telemetry


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    telemetry.set_enabled(True)
    yield
    telemetry.set_enabled(True)
    telemetry.reset()


def _net(precision=None):
    b = NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
    if precision:
        b = b.precision(precision)
    conf = (b.list()
            .layer(DenseLayer(n_out=5, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .setInputType(InputType.feedForward(3)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _graph(precision=None):
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph, ComputationGraphConfiguration)

    b = ComputationGraphConfiguration.graphBuilder().seed(4).updater(
        Adam(1e-2))
    if precision:
        b = b.precision(precision)
    conf = (b.addInputs("in")
            .addLayer("h", DenseLayer(n_out=4, activation="tanh"), "in")
            .addLayer("out", OutputLayer(n_out=2, activation="softmax",
                                         loss="mcxent"), "h")
            .setOutputs("out").setInputTypes(InputType.feedForward(3))
            .build())
    return ComputationGraph(conf, device="cpu").init()


def _data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]


# ------------------------------------------------------ registry parity
def _ops_counters(reg):
    c = reg.counter("dl4j_tpu_a_total", "plain counter")
    c.inc()
    c.inc(2.5, site="mln")
    c.inc(site="cg", phase="x")
    reg.counter("dl4j_tpu_b_total").inc(3)


def _ops_gauges(reg):
    g = reg.gauge("dl4j_tpu_g", 'help with "quotes", a \\ and a\nnewline')
    g.set(1.5, layer="0:DenseLayer", site="mln")
    g.set(float("nan"), layer="1")
    g.set(float("inf"), layer="2")
    g.set(float("-inf"), layer="3")
    g.set(-2, layer='we"ird\\na\nme')


def _ops_histograms(reg):
    h = reg.histogram("dl4j_tpu_h_seconds", "latency")
    for v in (0.0004, 0.003, 0.003, 0.2, 7.0, 120.0, float("nan")):
        h.observe(v, phase="etl_wait")
    h.observe(0.01)
    k = reg.histogram("dl4j_tpu_k", "custom buckets", buckets=(1, 10, 0.5))
    for v in range(12):
        k.observe(v * 0.9, site="a")


def _ops_mixed(reg):
    _ops_counters(reg)
    _ops_histograms(reg)
    _ops_gauges(reg)
    reg.counter("dl4j_tpu_a_total").inc(4, site="mln")


@pytest.mark.parametrize("ops", [_ops_counters, _ops_gauges, _ops_histograms,
                                 _ops_mixed],
                         ids=lambda f: f.__name__[5:])
def test_same_operations_render_the_same_text(ops):
    from deeplearning4j_tpu.profiler import telemetry as jt

    ours, theirs = telemetry.MetricsRegistry(), jt.MetricsRegistry()
    ops(ours)
    ops(theirs)
    assert ours.to_prometheus() == theirs.to_prometheus()
    assert json.dumps(ours.to_json(), sort_keys=True) == \
        json.dumps(theirs.to_json(), sort_keys=True)


def test_every_metric_name_is_spelled_as_in_jax():
    from deeplearning4j_tpu.profiler import telemetry as jt

    names = [n for n in dir(jt) if n.isupper() and isinstance(
        getattr(jt, n), str) and getattr(jt, n).startswith("dl4j_tpu_")]
    assert len(names) > 60
    assert {n: getattr(telemetry, n, None) for n in names} == \
        {n: getattr(jt, n) for n in names}
    assert telemetry.DEFAULT_BUCKETS == jt.DEFAULT_BUCKETS


def test_histogram_percentiles_and_capture_match_jax():
    from deeplearning4j_tpu.profiler import telemetry as jt

    vals = np.random.default_rng(1).exponential(0.05, 300).tolist()
    ours, theirs = telemetry.Histogram("h"), jt.Histogram("h")
    for v in vals:
        ours.observe(v, site="s")
        theirs.observe(v, site="s")
    assert ours.percentiles(site="s") == theirs.percentiles(site="s")
    assert ours._capture() == theirs._capture()
    assert ours.count(site="s") == 300
    assert math.isnan(ours.percentiles(site="none")["p50"])


def test_kind_conflict_raises_and_peek_never_creates():
    reg = telemetry.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")
    assert reg.peek("y") is None and "y" not in reg.to_json()


def test_counters_are_thread_safe():
    c = telemetry.MetricsRegistry().counter("t")

    def bump():
        for _ in range(2000):
            c.inc(site="a")

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value(site="a") == 8000


# ------------------------------------------------------------------ spans
def test_spans_nest_and_the_chrome_trace_parses(tmp_path):
    telemetry.clear_trace()
    with telemetry.span("outer", metric="dl4j_tpu_span_seconds",
                        site="t"):
        with telemetry.span("inner"):
            time.sleep(0.002)
    ev = {e["name"]: e for e in telemetry.chrome_trace()["traceEvents"]}
    assert ev["inner"]["args"] == {"depth": 1, "parent": "outer"}
    assert ev["outer"]["args"] == {"depth": 0, "site": "t"}
    assert ev["outer"]["dur"] >= ev["inner"]["dur"] >= 2000
    for e in ev.values():
        assert e["ph"] == "X" and {"ts", "pid", "tid"} <= set(e)
    path = telemetry.export_chrome_trace(str(tmp_path / "t.json"))
    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) == 2
    h = telemetry.MetricsRegistry.get_default().histogram(
        "dl4j_tpu_span_seconds")
    assert h.count(site="t") == 1        # depth/parent are not labels


def test_a_disabled_registry_records_nothing():
    telemetry.clear_trace()
    telemetry.set_enabled(False)
    with telemetry.span("off", metric="dl4j_tpu_off"):
        pass
    telemetry.record_phase("etl_wait", time.perf_counter())
    telemetry.record_on_device_batch("mln")
    assert telemetry.chrome_trace()["traceEvents"] == []
    assert telemetry.MetricsRegistry.get_default().to_json() == {}
    assert telemetry.sample_device_memory() == {}


def test_dropped_spans_are_counted_when_the_buffer_wraps(monkeypatch):
    import collections

    monkeypatch.setattr(telemetry, "_trace_events",
                        collections.deque(maxlen=3))
    for i in range(5):
        telemetry.record_span(f"s{i}", time.perf_counter())
    tr = telemetry.chrome_trace()
    assert len(tr["traceEvents"]) == 3
    assert tr["otherData"]["spans_dropped"] == 2


# ------------------------------------------------------------ step phases
def test_an_iterator_fit_fills_the_step_phases():
    x, y = _data()
    net = _net()
    net.setListeners(TelemetryListener(frequency=2))
    net.fit(ArrayDataSetIterator(x, y, 8), epochs=2)
    h = telemetry.MetricsRegistry.get_default().histogram(
        telemetry.STEP_PHASE_SECONDS)
    for phase in ("etl_wait", "device_step", "listener_host"):
        assert h.count(phase=phase) == 6, phase
    names = {e["name"] for e in telemetry.chrome_trace()["traceEvents"]}
    assert {"etl_wait", "device_step", "listener_host"} <= names
    reg = telemetry.MetricsRegistry.get_default()
    assert reg.counter("dl4j_tpu_iterations_total").total() == 6
    assert reg.counter("dl4j_tpu_epochs_total").total() == 2


def test_a_graph_fit_fills_the_step_phases():
    g = _graph()
    x, y = _data()
    g.fit(ArrayDataSetIterator(x, y, 12), epochs=1)
    h = telemetry.MetricsRegistry.get_default().histogram(
        telemetry.STEP_PHASE_SECONDS)
    assert h.count(phase="etl_wait") == h.count(phase="device_step") == 2


def test_a_prefetched_batch_counts_as_on_device():
    x, y = _data()
    net = _net()
    with DevicePrefetchIterator(ArrayDataSetIterator(x, y, 8), depth=2,
                                device="cpu", dtype=torch.float32) as it:
        net.fit(it)
    reg = telemetry.MetricsRegistry.get_default()
    assert reg.counter(telemetry.ON_DEVICE_BATCHES).value(site="mln") == 3


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "cg"])
def test_loss_scale_series_by_site(graph):
    x, y = _data(16)
    if graph:
        net, site = _graph("mixed_float16"), "cg"
    else:
        net, site = _net("mixed_float16"), "mln"
    net.fit(x, y)
    big = np.full_like(x, 1e7)        # inf once staged to f16
    net.fit(big, y)
    reg = telemetry.MetricsRegistry.get_default()
    text = reg.to_prometheus()
    for name in (telemetry.LOSS_SCALE, telemetry.LOSS_SCALE_OVERFLOWS,
                 telemetry.LOSS_SCALE_SKIPPED_STEPS,
                 telemetry.PRECISION_CASTS):
        assert f'{name}{{site="{site}"}}' in text, name
    scale = float(net._loss_scale_state["scale"])
    assert reg.gauge(telemetry.LOSS_SCALE).value(site=site) == scale
    assert reg.counter(telemetry.LOSS_SCALE_SKIPPED_STEPS).value(
        site=site) == int(net._loss_scale_state["skipped_steps"]) >= 1


# ------------------------------------------------------ memory and peaks
def test_device_memory_is_empty_on_the_cpu(monkeypatch):
    assert telemetry.sample_device_memory(torch.device("cpu")) == {}
    assert telemetry.sample_device_memory("cpu", force=True) == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    telemetry.reset()
    assert telemetry.sample_device_memory() == {}
    assert telemetry._mem_supported is False
    assert telemetry.MetricsRegistry.get_default().peek(
        telemetry.DEVICE_BYTES_IN_USE) is None


def test_a_failing_probe_does_not_latch(monkeypatch):
    telemetry.reset()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def boom(*a, **k):
        raise RuntimeError("transient")

    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    assert telemetry.sample_device_memory() == {}
    assert telemetry._mem_supported is None


def test_the_peak_table_holds_the_h100_only(caplog):
    assert flops.PEAK_FLOPS == {
        "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12}}
    assert flops.PEAK_HBM_GBPS == {"NVIDIA H100 80GB HBM3": 3350.0}
    assert flops._dtype_key(torch.bfloat16) == "bf16"
    assert flops._dtype_key("mixed_float16") == "f32"
    assert flops._dtype_key("float16") == "bf16"
    assert flops.device_kind("cpu") == "cpu"
    flops._warned_unknown_peak.discard("cpu")
    with caplog.at_level(logging.WARNING,
                         logger="deeplearning4j_tpu_torch"):
        assert flops.peak_flops("bf16", device="cpu") is None
        assert flops.peak_flops("f32", device="cpu") is None
    assert sum("no peak-FLOPs entry" in r.message
               for r in caplog.records) == 1
    assert flops.peak_hbm_gbps("cpu") is None


def test_the_telemetry_listener_honours_the_kill_switch():
    class Model:
        device = torch.device("cpu")

        def score(self):
            raise AssertionError("score() read with telemetry off")

    telemetry.set_enabled(False)
    TelemetryListener(1).iterationDone(Model(), 1, 0)
    telemetry.set_enabled(True)
    with pytest.raises(AssertionError):
        TelemetryListener(1).iterationDone(Model(), 1, 0)


# -------------------------------------------------------- flight recorder
def test_an_incident_dump_passes_the_jax_loader(tmp_path):
    from deeplearning4j_tpu.profiler import flight_recorder as jfr

    rec = flight_recorder.FlightRecorder(capacity=4, enabled=True)
    for i in range(6):
        rec.record("train_loss", step=i, loss=float("nan") if i == 5
                   else 0.5)
    path = rec.incident("divergence_rollback", directory=str(tmp_path),
                        why="non-finite loss")
    ours, theirs = flight_recorder.load_dump(path), jfr.load_dump(path)
    assert ours["valid"] and theirs["valid"]
    assert [e["seq"] for e in ours["events"]] == [4, 5, 6, 7]
    assert ours["events"][-2]["loss"] == "nan"
    assert ours["events"][-1]["kind"] == "divergence_rollback"
    assert theirs["events"] == ours["events"]
    with open(f"{path}/events.jsonl", "a") as f:
        f.write("{}\n")
    assert not flight_recorder.load_dump(path)["valid"]


def test_the_snapshot_carries_health_and_the_recorder(tmp_path):
    from deeplearning4j_tpu_torch.profiler.model_health import HealthMonitor

    flight_recorder.reset()
    x, y = _data()
    net = _net().setHealthMonitor(HealthMonitor(frequency=1, mfu=False))
    net.fit(x, y)
    snap = telemetry.snapshot()
    assert set(snap["model_health"]["layer_grad_norm"]) == {
        '{layer="0:DenseLayer",site="mln"}',
        '{layer="1:OutputLayer",site="mln"}'}
    assert snap["flight_recorder"]["events"] >= 1
    assert snap["step_phases"]['{phase="device_step"}']["count"] == 1
    assert "device_memory" not in snap
