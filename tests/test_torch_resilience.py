"""PyTorch port, fault tolerance: ``deeplearning4j_tpu_torch.util.resilience``,
``profiler.chaos``, the prefetcher's transfer retries and
``util.sharded_checkpoint``, mirroring ``tests/test_resilience.py`` and
held against the JAX package where both can run.

- A run preempted by ``ChaosConfig(preempt_at_step=...)`` and resumed in
  a fresh model ends bit-identical to an uninterrupted port run:
  parameters, updater state, loss-scale state, for MultiLayerNetwork and
  for a small ComputationGraph. The resumed run takes the next batch, and
  a finished run retires its bundles.
- Against JAX: the JAX package preempts the same net (the same weights,
  carried in its zip) at step 5, the port resumes from the JAX bundle, and
  after the remaining steps its parameters and updater state are within
  1e-5 of JAX's uninterrupted run (``test_torch_multilayer.py``'s
  trajectory tolerance); the port's bundles pass JAX's
  ``validate_bundle`` / ``latest_valid_bundle``; under
  ``ChaosConfig(nan_steps=(4,))`` both packages roll back and skip the
  same number of times and end within 1e-5.
- The divergence guard, the transfer retries and quarantine, the
  watchdog, the bundle stores under ``FaultyObjectStore`` and the sharded
  checkpoint (both ways with JAX) behave as the JAX tests hold them.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator, DataSet,
                                               DevicePrefetchIterator,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (DenseLayer, InputType,
                                              NeuralNetConfiguration,
                                              OutputLayer)
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.profiler import chaos, telemetry
from deeplearning4j_tpu_torch.util import resilience, sharded_checkpoint
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
from deeplearning4j_tpu_torch.util.resilience import (DivergenceError,
                                                      FaultTolerance,
                                                      StepWatchdog)

PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def small_net(seed=9, precision=None):
    b = NeuralNetConfiguration.builder().seed(seed).updater(
        Adam(learning_rate=0.01))
    if precision:
        b = b.precision(precision)
    conf = (b.list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .setInputType(InputType.feedForward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def small_graph(seed=9):
    conf = (ComputationGraphConfiguration.graphBuilder().seed(seed)
            .updater(Adam(learning_rate=0.01)).addInputs("in")
            .addLayer("h", DenseLayer(n_out=8, activation="tanh"), "in")
            .addLayer("out", OutputLayer(n_out=2, activation="softmax",
                                         loss="mcxent"), "h")
            .setOutputs("out").setInputTypes(InputType.feedForward(4))
            .build())
    return ComputationGraph(conf, device="cpu").init()


def toy_data(n=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]


X, Y = toy_data()


def make_iter(bs=8, shuffle=True):
    return ArrayDataSetIterator(X, Y, bs, shuffle=shuffle, seed=5)


def ft(ck=None, **kw):
    kw.setdefault("divergence_window", 0)
    return FaultTolerance(checkpoint_dir=ck, **kw)


def leaves(tree):
    if torch.is_tensor(tree):
        return [tree.detach().cpu().numpy().copy()]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in leaves(t)]
    if tree is None:
        return []
    return [np.asarray(tree)]


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        np.testing.assert_array_equal(u, v)


def iter_no_reset(it):
    while it.hasNext():
        yield it.next()


# ================================================ preemption and resume
class TestPreemptResume:
    @pytest.mark.parametrize("make", [small_net, small_graph],
                             ids=["mln", "cg"])
    def test_chaos_preemption_then_bit_identical_resume(self, make,
                                                        tmp_path):
        ck = str(tmp_path / "ck")
        clean = make()
        clean.fit(make_iter(), epochs=2)
        net = make()
        with chaos.installed(chaos.ChaosConfig(preempt_at_step=9)):
            net.fit(make_iter(), epochs=2, fault_tolerance=ft(ck))
        assert net.getIterationCount() == 9
        bundle = resilience.latest_valid_bundle(ck)
        assert bundle is not None and resilience.validate_bundle(bundle)
        net2 = make()
        net2.fit(make_iter(), epochs=2, fault_tolerance=ft(ck))
        assert (net2.getIterationCount(), net2.getEpochCount()) == (12, 2)
        for attr in ("params_map", "states_map") if hasattr(
                net2, "params_map") else ("params_list", "states_list"):
            assert_trees_equal(getattr(clean, attr), getattr(net2, attr))
        assert_trees_equal(clean.opt_states, net2.opt_states)
        assert torch.equal(clean._generator.get_state(),
                           net2._generator.get_state())
        # a finished run retires its bundles
        assert resilience.latest_valid_bundle(ck) is None

    def test_resume_consumes_next_batch_not_repeat(self, tmp_path):
        ck = str(tmp_path / "ck")
        seen = []

        class Spy(ArrayDataSetIterator):
            def next(self):
                ds = super().next()
                seen.append(np.asarray(ds.features)[:, 0].copy())
                return ds

        def spy_iter():
            return Spy(X, Y, 8, shuffle=True, seed=5)

        with chaos.installed(chaos.ChaosConfig(preempt_at_step=7)):
            small_net().fit(spy_iter(), epochs=2, fault_tolerance=ft(ck))
        small_net().fit(spy_iter(), epochs=2, fault_tolerance=ft(ck))
        rows = np.concatenate(seen)
        assert rows.shape[0] == 96
        _, counts = np.unique(rows, return_counts=True)
        assert (counts == 2).all()

    def test_loss_scale_state_survives_resume_bit_identical(self, tmp_path):
        ck = str(tmp_path / "ck")
        clean = small_net(precision="mixed_float16")
        clean.fit(make_iter(), epochs=2)
        net = small_net(precision="mixed_float16")
        with chaos.installed(chaos.ChaosConfig(preempt_at_step=8)):
            net.fit(make_iter(), epochs=2, fault_tolerance=ft(ck))
        net2 = small_net(precision="mixed_float16")
        net2.fit(make_iter(), epochs=2, fault_tolerance=ft(ck))
        assert_trees_equal(clean.params_list, net2.params_list)
        assert_trees_equal(clean.opt_states, net2.opt_states)
        assert_trees_equal(clean._loss_scale_state, net2._loss_scale_state)

    def test_corrupt_newest_bundle_falls_back(self, tmp_path):
        ck = str(tmp_path / "ck")
        with chaos.installed(chaos.ChaosConfig(preempt_at_step=4)):
            small_net().fit(make_iter(), epochs=3, fault_tolerance=ft(ck))
        with chaos.installed(chaos.ChaosConfig(preempt_at_step=4)):
            # resumes from bundle-4, preempts again at global step 8
            small_net().fit(make_iter(), epochs=3, fault_tolerance=ft(ck))
        bundles = sorted(d for d in os.listdir(ck) if d.startswith("bundle-"))
        assert len(bundles) == 2
        with open(os.path.join(ck, bundles[-1], "model.zip"), "r+b") as f:
            f.truncate(100)
        assert not resilience.validate_bundle(os.path.join(ck, bundles[-1]))
        assert resilience.latest_valid_bundle(ck) == \
            os.path.join(ck, bundles[0])
        net2 = small_net()
        net2.fit(make_iter(), epochs=3, fault_tolerance=ft(ck))
        assert net2.getIterationCount() == 18
        assert np.isfinite(float(net2.score()))

    def test_preemption_via_request_api(self, tmp_path):
        ck = str(tmp_path / "ck")
        policy = ft(ck)

        class Trigger:
            def __init__(self):
                self.n = 0

            def iterationDone(self, model, iteration, epoch):
                self.n += 1
                if self.n == 3:
                    policy.request_preemption(deadline_s=30.0)

        net = small_net()
        net.setListeners(Trigger())
        net.fit(make_iter(), epochs=2, fault_tolerance=policy)
        assert net.getIterationCount() == 3
        assert policy.preemptions_checkpointed == 1
        assert policy.notice is None and not policy.preemption_requested
        assert resilience.latest_valid_bundle(ck) is not None

    def test_preempt_on_epoch_boundary_bit_identical(self, tmp_path):
        ck = str(tmp_path / "ck")
        clean = small_net()
        clean.fit(make_iter(), epochs=2)
        epochs_seen = []

        class EpochSpy:
            def iterationDone(self, model, iteration, epoch):
                pass

            def onEpochEnd(self, model):
                epochs_seen.append(model.getEpochCount())

        net = small_net()
        net.setListeners(EpochSpy())
        with chaos.installed(chaos.ChaosConfig(preempt_at_step=6)):
            net.fit(make_iter(), epochs=2, fault_tolerance=ft(ck))
        assert net.getEpochCount() == 0 and epochs_seen == []
        net2 = small_net()
        net2.setListeners(EpochSpy())
        net2.fit(make_iter(), epochs=2, fault_tolerance=ft(ck))
        assert net2.getEpochCount() == 2 and epochs_seen == [1, 2]
        assert_trees_equal(clean.params_list, net2.params_list)
        assert_trees_equal(clean.opt_states, net2.opt_states)

    def test_preemption_requested_before_fit_is_honored(self, tmp_path):
        ck = str(tmp_path / "ck")
        policy = ft(ck)
        policy.request_preemption()
        net = small_net()
        net.fit(make_iter(), epochs=2, fault_tolerance=policy)
        assert net.getIterationCount() == 1
        net2 = small_net()
        net2.fit(make_iter(), epochs=2, fault_tolerance=policy)
        assert net2.getIterationCount() == 12
        assert resilience.latest_valid_bundle(ck) is None

    def test_policy_object_not_mutated_by_auto_resume(self, tmp_path):
        policy = ft()
        small_net().fit(make_iter(), epochs=1, fault_tolerance=policy,
                        auto_resume=str(tmp_path / "d"))
        assert policy.checkpoint_dir is None
        assert resilience.latest_valid_bundle(str(tmp_path / "d")) is None

    @pytest.mark.parametrize("make", [small_net, small_graph],
                             ids=["mln", "cg"])
    def test_identity_loop_matches_legacy_fit(self, make):
        legacy = make()
        legacy.fit(make_iter(), epochs=2)
        guarded = make()
        guarded.fit(make_iter(), epochs=2, fault_tolerance=ft())
        assert_trees_equal(legacy.opt_states, guarded.opt_states)
        assert legacy.getEpochCount() == guarded.getEpochCount() == 2
        assert float(legacy.score()) == float(guarded.score())

    def test_signal_handlers_are_restored_on_every_exit(self, tmp_path):
        before = signal.getsignal(signal.SIGTERM)
        small_net().fit(make_iter(), epochs=1, fault_tolerance=ft())
        assert signal.getsignal(signal.SIGTERM) is before
        with chaos.installed(chaos.ChaosConfig(nan_steps=tuple(range(50)))):
            with pytest.raises(DivergenceError):
                small_net().fit(make_iter(), epochs=2, fault_tolerance=ft(
                    divergence_window=4, max_rollbacks=1,
                    flight_dir=str(tmp_path)))
        assert signal.getsignal(signal.SIGTERM) is before
        assert signal.getsignal(signal.SIGINT) is not None


# ==================================================== against the JAX
def _jax_net(precision=None):
    from deeplearning4j_tpu.learning import Adam as JAdam
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer as JDense, InputType as JInputType,
        NeuralNetConfiguration as JConf, OutputLayer as JOutput)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    b = JConf.builder().seed(9).updater(JAdam(learning_rate=0.01))
    if precision:
        b = b.precision(precision)
    return JMLN((b.list()
                 .layer(JDense(n_out=8, activation="tanh"))
                 .layer(JOutput(n_out=2, activation="softmax",
                                loss="mcxent"))
                 .setInputType(JInputType.feedForward(4)).build())).init()


def _jax_iter():
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIter

    return JIter(X, Y, 8)


def _port_twin(jnet, tmp_path, name="init.zip"):
    """A port network holding the JAX network's configuration, weights and
    updater state (through the zip both packages read)."""
    from deeplearning4j_tpu.util import ModelSerializer as JSer

    path = str(tmp_path / name)
    JSer.writeModel(jnet, path)
    return ModelSerializer.restoreMultiLayerNetwork(path, load_updater=True,
                                                    device="cpu")


def _close_to_jax(net, jnet):
    import jax

    for got, want in ((net.params_list, jnet.params_list),
                      (net.opt_states, jnet.opt_states)):
        lg, lw = leaves(got), leaves(jax.device_get(want))
        assert len(lg) == len(lw)
        for u, v in zip(lg, lw):
            np.testing.assert_allclose(u, np.asarray(v, np.float32),
                                       atol=PARAM_ATOL, rtol=0)


class TestAgainstJax:
    def test_port_resumes_a_jax_bundle(self, tmp_path):
        from deeplearning4j_tpu.profiler import chaos as jchaos
        from deeplearning4j_tpu.util import FaultTolerance as JFT
        from deeplearning4j_tpu.util import resilience as jres

        ck = str(tmp_path / "ck")
        jclean = _jax_net()
        net = _port_twin(jclean, tmp_path)
        jclean.fit(_jax_iter(), epochs=2)
        jnet = _jax_net()
        with jchaos.installed(jchaos.ChaosConfig(preempt_at_step=5)):
            jnet.fit(_jax_iter(), epochs=2, fault_tolerance=JFT(
                checkpoint_dir=ck, divergence_window=0))
        assert jnet.getIterationCount() == 5
        bundle = resilience.latest_valid_bundle(ck)
        assert bundle == jres.latest_valid_bundle(ck)
        net.fit(make_iter(shuffle=False), epochs=2, fault_tolerance=ft(ck))
        assert (net.getIterationCount(), net.getEpochCount()) == (12, 2)
        _close_to_jax(net, jclean)

    def test_port_bundles_pass_the_jax_validator(self, tmp_path):
        from deeplearning4j_tpu.util import resilience as jres

        ck = str(tmp_path / "ck")
        with chaos.installed(chaos.ChaosConfig(preempt_at_step=3)):
            small_net().fit(make_iter(), epochs=2, fault_tolerance=ft(ck))
        bundle = resilience.latest_valid_bundle(ck)
        assert os.path.basename(bundle) == "bundle-0000000003"
        assert sorted(os.listdir(bundle)) == ["manifest.json", "model.zip",
                                              "resume.json"]
        assert jres.validate_bundle(bundle)
        assert jres.latest_valid_bundle(ck) == bundle
        with open(os.path.join(bundle, "resume.json"), "a") as f:
            f.write(" ")
        assert not jres.validate_bundle(bundle)
        assert not resilience.validate_bundle(bundle)

    def test_divergence_guard_matches_jax(self, tmp_path):
        from deeplearning4j_tpu.profiler import chaos as jchaos
        from deeplearning4j_tpu.profiler import telemetry as jtel
        from deeplearning4j_tpu.util import FaultTolerance as JFT

        jnet = _jax_net()
        net = _port_twin(jnet, tmp_path)
        jtel.MetricsRegistry.get_default().reset()
        with jchaos.installed(jchaos.ChaosConfig(nan_steps=(4,))):
            jnet.fit(_jax_iter(), epochs=2, fault_tolerance=JFT(
                divergence_window=8, snapshot_every=2,
                flight_dir=str(tmp_path)))
        with chaos.installed(chaos.ChaosConfig(nan_steps=(4,))):
            net.fit(make_iter(shuffle=False), epochs=2, fault_tolerance=ft(
                divergence_window=8, snapshot_every=2,
                flight_dir=str(tmp_path)))
        jreg = jtel.MetricsRegistry.get_default()
        reg = telemetry.MetricsRegistry.get_default()
        for name in (telemetry.FT_ROLLBACKS, telemetry.FT_SKIPPED_BATCHES):
            assert reg.counter(name).total() == \
                jreg.counter(name).total() == 1, name
        assert net.getIterationCount() == jnet.getIterationCount()
        _close_to_jax(net, jnet)

    def test_sharded_checkpoint_both_ways(self, tmp_path):
        from deeplearning4j_tpu.util import sharded_checkpoint as jsc

        jnet = _jax_net()
        jnet.fit(_jax_iter(), epochs=1)
        jsc.save_model(str(tmp_path / "j"), jnet, step=6,
                       iterator_state={"i": 48})
        net = small_net()
        meta = sharded_checkpoint.restore_model(str(tmp_path / "j"), net)
        assert meta == {"step": 6, "iterator_state": {"i": 48}}
        _close_to_jax(net, jnet)
        net.fit(make_iter(), epochs=1)
        sharded_checkpoint.save_model(str(tmp_path / "p"), net, step=12)
        jnet2 = _jax_net()
        jmeta = jsc.restore_model(str(tmp_path / "p"), jnet2)
        assert jmeta["step"] == 12
        _close_to_jax(net, jnet2)


# ===================================================== divergence guard
class TestDivergenceGuard:
    def test_nan_batch_rolls_back_and_skips(self, tmp_path):
        net = small_net()
        with chaos.installed(chaos.ChaosConfig(nan_steps=(4,))):
            net.fit(ArrayDataSetIterator(X, Y, 8), epochs=2,
                    fault_tolerance=ft(divergence_window=8, snapshot_every=2,
                                       flight_dir=str(tmp_path)))
        assert np.isfinite(float(net.score()))
        assert all(np.isfinite(l).all() for l in leaves(net.params_list))
        reg = telemetry.MetricsRegistry.get_default()
        assert reg.counter(telemetry.FT_ROLLBACKS).total() == 1
        assert reg.counter(telemetry.FT_SKIPPED_BATCHES).total() == 1

    def test_rollback_budget_exhaustion_raises(self, tmp_path):
        net = small_net()
        with chaos.installed(chaos.ChaosConfig(nan_steps=tuple(range(50)))):
            with pytest.raises(DivergenceError):
                net.fit(ArrayDataSetIterator(X, Y, 8), epochs=4,
                        fault_tolerance=ft(divergence_window=8,
                                           max_rollbacks=2,
                                           flight_dir=str(tmp_path)))
        assert all(np.isfinite(l).all() for l in leaves(net.params_list))
        assert telemetry.MetricsRegistry.get_default().counter(
            telemetry.FT_ROLLBACKS).total() == 2

    def test_min_history_clamped_to_window(self):
        assert FaultTolerance(divergence_window=4).min_history <= 4

    def test_spike_detection(self, tmp_path):
        policy = FaultTolerance(divergence_window=8, min_history=3,
                                spike_factor=10.0, snapshot_every=2,
                                flight_dir=str(tmp_path))
        adapter = resilience._FitAdapter(small_net())
        st = resilience._RunState(policy, adapter)
        resilience._maybe_snapshot(policy, adapter, st)
        for v in (0.7, 0.69, 0.68):
            adapter.model._score = torch.tensor(v)
            assert not resilience._check_divergence(policy, adapter, st)
        adapter.model._score = torch.tensor(500.0)
        assert resilience._check_divergence(policy, adapter, st)
        assert st.rollbacks == 1

    def test_snapshots_copy_and_rollback_restores(self):
        """The snapshot holds clones: writing into the live tensors after
        it leaves it intact, and a restore hands back fresh clones."""
        net = small_net()
        adapter = resilience._FitAdapter(net)
        snap = adapter.snapshot()
        want = leaves(net.params_list) + leaves(net.opt_states)
        for t in (net.params_list[0]["W"], net.opt_states[0]["m"]["W"]):
            t.add_(1.0)
        adapter.restore(snap)
        got = leaves(net.params_list) + leaves(net.opt_states)
        for u, v in zip(got, want):
            np.testing.assert_array_equal(u, v)
        net.params_list[0]["W"].add_(1.0)
        np.testing.assert_array_equal(leaves(snap["params"])[0], want[0])

    def test_handled_loss_scale_overflow_is_not_divergence(self, tmp_path):
        net = small_net(precision="mixed_float16")
        net.fit(ArrayDataSetIterator(X, Y, 8), epochs=1)   # warm-up
        base = resilience._ls_skipped(net)
        big = DataSet(np.full((8, 4), 1e7, np.float32), Y[:8])
        it = ListDataSetIterator(
            [DataSet(X[:8], Y[:8]), big, DataSet(X[8:16], Y[8:16])])
        net.fit(it, epochs=1, fault_tolerance=ft(
            divergence_window=8, snapshot_every=1, flight_dir=str(tmp_path)))
        assert telemetry.MetricsRegistry.get_default().counter(
            telemetry.FT_ROLLBACKS).total() == 0
        assert resilience._ls_skipped(net) > base
        assert all(np.isfinite(l).all() for l in leaves(net.params_list))


class _StreamIterator(ListDataSetIterator):
    def resetSupported(self) -> bool:
        return False

    def reset(self):
        raise NotImplementedError("stream cannot rewind")


class TestNonResettableIterator:
    def batches(self):
        return [DataSet(X[i:i + 8], Y[i:i + 8]) for i in range(0, 24, 8)]

    def test_single_epoch_consumes_stream_in_place(self):
        net = small_net()
        net.fit(_StreamIterator(self.batches()), epochs=1,
                fault_tolerance=ft())
        assert net.getIterationCount() == 3

    def test_multi_epoch_fails_fast_with_clear_error(self):
        net = small_net()
        it = _StreamIterator(self.batches())
        with pytest.raises(ValueError, match="resettable"):
            net.fit(it, epochs=2, fault_tolerance=ft())
        assert it.get_state() == {"i": 0}
        assert net.getIterationCount() == 0


# ============================================== transfer retries, chaos
class TestTransferRetry:
    def test_transient_errors_retry_to_success(self):
        net = small_net()
        it = DevicePrefetchIterator(ArrayDataSetIterator(X, Y, 8), depth=2,
                                    device="cpu", transfer_backoff=0.002)
        with chaos.installed(chaos.ChaosConfig(transfer_error_rate=0.4,
                                               seed=3)), it:
            net.fit(it, epochs=2, fault_tolerance=ft(
                transfer_backoff=0.002))
        assert net.getIterationCount() == 12
        reg = telemetry.MetricsRegistry.get_default()
        assert reg.counter(telemetry.TRANSFER_RETRIES).total() > 0
        assert reg.counter(telemetry.TRANSFER_QUARANTINES).total() == 0

    @pytest.mark.parametrize("depth", [0, 2])
    def test_poison_batch_quarantined_not_fatal(self, depth):
        net = small_net()
        it = DevicePrefetchIterator(
            ArrayDataSetIterator(X, Y, 8), depth=depth, device="cpu",
            transfer_retries=1, transfer_backoff=0.001, quarantine=True)
        with chaos.installed(chaos.ChaosConfig(transfer_error_rate=1.0)), it:
            net.fit(it, epochs=1, fault_tolerance=ft(transfer_retries=0))
        assert net.getIterationCount() == 0
        reg = telemetry.MetricsRegistry.get_default()
        assert reg.counter(telemetry.TRANSFER_QUARANTINES).total() == 6
        assert reg.counter(telemetry.TRANSFER_RETRIES).total() == 6

    def test_ft_retry_posture_restored_after_fit(self):
        net = small_net()
        with DevicePrefetchIterator(ArrayDataSetIterator(X, Y, 8), depth=2,
                                    device="cpu") as it:
            net.fit(it, epochs=1, fault_tolerance=ft())
            assert it._transfer_retries == 0 and not it._quarantine

    def test_default_remains_fail_fast(self):
        it = DevicePrefetchIterator(ArrayDataSetIterator(X, Y, 8), depth=2,
                                    device="cpu")
        with chaos.installed(chaos.ChaosConfig(transfer_error_rate=1.0)), it:
            with pytest.raises(chaos.ChaosTransferError):
                for _ in it:
                    pass


class TestChaosHarness:
    def test_env_gated_config(self, monkeypatch):
        monkeypatch.setenv("DL4J_TPU_CHAOS", "1")
        monkeypatch.setenv("DL4J_TPU_CHAOS_NAN_STEPS", "3,5")
        monkeypatch.setenv("DL4J_TPU_CHAOS_TRANSFER_P", "0.25")
        monkeypatch.setenv("DL4J_TPU_CHAOS_PREEMPT_AT", "12,30")
        cfg = chaos.ChaosConfig.from_env()
        assert cfg.nan_steps == (3, 5) and cfg.transfer_error_rate == 0.25
        assert (cfg.preempt_at_step, cfg.preempt_deadline_s) == (12, 30.0)
        monkeypatch.setenv("DL4J_TPU_CHAOS", "0")
        assert chaos.ChaosConfig.from_env() is None

    def test_corrupt_batch_targets_only_listed_ordinals(self):
        monkey = chaos.ChaosMonkey(chaos.ChaosConfig(nan_steps=(1,)))
        for feats in (X[:8], torch.from_numpy(X[:8]).to(torch.bfloat16)):
            ds = DataSet(feats, Y[:8])
            assert monkey.corrupt_batch(ds, 0) is ds
            bad = monkey.corrupt_batch(ds, 1).features
            assert torch.isnan(torch.as_tensor(bad).float()).all()
            assert np.isfinite(np.asarray(torch.as_tensor(feats).float())
                               ).all()
            if torch.is_tensor(feats):
                assert bad.dtype == torch.bfloat16


# ===================================================== watchdog, stores
class TestWatchdog:
    def test_fires_and_counts_on_deadline(self, caplog, tmp_path):
        with caplog.at_level("ERROR", logger="deeplearning4j_tpu_torch"):
            with StepWatchdog(0.05, context="test_step",
                              flight_dir=str(tmp_path)) as wd:
                time.sleep(0.3)
        assert wd.fired
        assert telemetry.MetricsRegistry.get_default().counter(
            telemetry.WATCHDOG_STALLS).total() == 1
        assert "WATCHDOG" in caplog.text and "MainThread" in caplog.text

    def test_fast_step_does_not_fire(self):
        with StepWatchdog(5.0) as wd:
            pass
        assert not wd.fired
        time.sleep(0.05)
        assert not any(t.name == "FT-watchdog" and t.is_alive()
                       for t in threading.enumerate())

    def test_chaos_hang_in_a_fit_trips_the_watchdog(self, tmp_path):
        net = small_net()
        with chaos.installed(chaos.ChaosConfig(hang_step=3,
                                               hang_seconds=0.4)):
            net.fit(make_iter(), epochs=1, fault_tolerance=ft(
                step_deadline=0.2, flight_dir=str(tmp_path)))
        assert net.getIterationCount() == 6
        stalls = telemetry.MetricsRegistry.get_default().counter(
            telemetry.WATCHDOG_STALLS).value(context="train_step")
        assert stalls >= 1


class TestBundleStores:
    def test_shared_fs_store_resumes_bit_identical(self, tmp_path):
        store = resilience.SharedFSBundleStore(str(tmp_path), "job",
                                               io_backoff=0.001)
        clean = small_net()
        clean.fit(make_iter(), epochs=2)
        with chaos.installed(chaos.ChaosConfig(preempt_at_step=5)):
            small_net().fit(make_iter(), epochs=2,
                            fault_tolerance=ft(bundle_store=store))
        found = store.discover()
        assert [d["iteration"] for d in found] == [5]
        assert found[0]["valid"] and found[0]["host"] == "p0"
        net = small_net()
        net.fit(make_iter(), epochs=2, fault_tolerance=ft(bundle_store=store))
        assert_trees_equal(clean.params_list, net.params_list)
        assert store.discover() == []

    def test_object_store_under_faults_resumes_bit_identical(self, tmp_path):
        inner = resilience.InMemoryObjectStore()
        faulty = chaos.FaultyObjectStore(inner, error_rate=1.0,
                                         torn_rate=1.0)
        store = resilience.ObjectStoreBundleStore(
            faulty, "job", cache_dir=str(tmp_path / "a"), io_backoff=0.001)
        clean = small_net()
        clean.fit(make_iter(), epochs=2)
        with chaos.installed(chaos.ChaosConfig(preempt_at_step=7)):
            small_net().fit(make_iter(), epochs=2,
                            fault_tolerance=ft(bundle_store=store))
        assert faulty.injected > 0
        assert telemetry.MetricsRegistry.get_default().counter(
            telemetry.FT_BUNDLE_IO_RETRIES).total() > 0
        # a second host, its own empty cache, the same bucket
        other = resilience.ObjectStoreBundleStore(
            inner, "job", cache_dir=str(tmp_path / "b"), io_backoff=0.001)
        net = small_net()
        net.fit(make_iter(), epochs=2, fault_tolerance=ft(bundle_store=other))
        assert net.getIterationCount() == 12
        assert_trees_equal(clean.params_list, net.params_list)
        assert_trees_equal(clean.opt_states, net.opt_states)
        assert inner.list("job/commit/") == []

    def test_sharded_paths_raise_a8(self, tmp_path):
        with pytest.raises(NotImplementedError, match="A8"):
            resilience.run_fit(small_net(), ft(), make_iter(),
                               trainer=object())
        with pytest.raises(NotImplementedError, match="A8"):
            resilience._mesh_topology(object())
        with pytest.raises(NotImplementedError, match="A8"):
            resilience.SharedFSBundleStore(
                str(tmp_path), process_index=1, process_count=2).write(
                    small_net(), {}, trainer=object())
