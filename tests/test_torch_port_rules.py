"""PyTorch port, ground rules: ``deeplearning4j_tpu_torch`` and
``chip_smoke.py`` never import JAX or the JAX package, nor
``tensorflow``, ``google.protobuf``, ``transformers``, ``onnx``,
``onnxruntime`` or ``torch.onnx`` (the model importers read their
formats themselves; the exceptions are the fixture tools:
``tools/make_tf_fixture.py`` makes the TF fixture with TF and
``tools/make_onnx_fixture.py`` the ONNX one with ``torch.onnx``, each
inside a function), and the port's entry points run on the CPU only when
the caller asks for it.

The name ``deeplearning4j_tpu_torch`` starts with ``deeplearning4j_tpu``,
so every check below matches the JAX package by its exact name or its
name followed by a dot, never by a bare prefix.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deeplearning4j_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")
#: the frameworks whose formats the importers read without them
FOREIGN = ("tensorflow", "google.protobuf", "transformers", "onnx",
           "onnxruntime", "torch.onnx")
#: the modules that may import some of them (inside a function)
FIXTURE_TOOL = os.path.join(PKG, "tools", "make_tf_fixture.py")
ONNX_FIXTURE_TOOL = os.path.join(PKG, "tools", "make_onnx_fixture.py")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _foreign(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FOREIGN)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def _imports(path, top_level_only=False):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_scan_covers_the_profiler_and_resilience():
    """The import scans below read every module of the port, the
    ``profiler/`` subpackage and ``util/resilience.py`` among them."""
    rel = {os.path.relpath(p, PKG) for p in _port_sources()}
    for name in ("telemetry", "flops", "flight_recorder", "chaos",
                 "model_health"):
        assert os.path.join("profiler", name + ".py") in rel, name
    assert os.path.join("util", "resilience.py") in rel
    assert os.path.join("util", "sharded_checkpoint.py") in rel


def test_prefix_trap_is_not_matched():
    assert not _forbidden("deeplearning4j_tpu_torch")
    assert not _forbidden("deeplearning4j_tpu_torch.ops.native")
    assert _forbidden("deeplearning4j_tpu")
    assert _forbidden("deeplearning4j_tpu.common.serde")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping_free")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("path", [p for p in _port_sources()
                                  if p not in (FIXTURE_TOOL,
                                               ONNX_FIXTURE_TOOL)],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_tensorflow_protobuf_transformers_or_onnx_import(path):
    bad = [m for m in _imports(path) if _foreign(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_foreign_scan_matches_names_exactly():
    assert _foreign("tensorflow.python.framework") and _foreign("onnx")
    assert _foreign("google.protobuf.message") and _foreign("transformers")
    assert _foreign("torch.onnx") and _foreign("onnxruntime")
    assert _foreign("torch.onnx._internal.torchscript_exporter")
    assert not _foreign("google") and not _foreign("torch")
    assert not _foreign("torch._C._onnx") and not _foreign("torch.onnx_x")
    assert not _foreign("onnx_compat") and not _foreign("tensorflow_io_x")
    assert FIXTURE_TOOL in _port_sources()
    assert [m for m in _imports(FIXTURE_TOOL) if _foreign(m)] == [
        "tensorflow", "transformers", "tensorflow.python.framework"
        ".convert_to_constants"]


def test_only_the_onnx_fixture_tool_imports_torch_onnx_in_a_function():
    """``tools/make_onnx_fixture.py`` imports ``torch.onnx``'s exporter
    shim inside ``main()`` and nothing foreign at its top level."""
    assert ONNX_FIXTURE_TOOL in _port_sources()
    assert [m for m in _imports(ONNX_FIXTURE_TOOL) if _foreign(m)] == [
        "torch.onnx._internal.torchscript_exporter"]
    assert not [m for m in _imports(ONNX_FIXTURE_TOOL, top_level_only=True)
                if _foreign(m)]


@pytest.mark.parametrize("path", [p for p in _port_sources()
                                  if p.startswith(PKG + os.sep)],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_package_never_imports_chip_smoke(path):
    """Imports run one way: ``chip_smoke.py`` drives the package (and its
    probes), never the reverse."""
    bad = [m for m in _imports(path)
           if m == "chip_smoke" or m.startswith("chip_smoke.")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_ast_scan_sees_every_import_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax.numpy as jnp\n"
                   "from deeplearning4j_tpu.common import serde\n"
                   "def f():\n    from jax import lax\n"
                   "from . import sibling\n")
    assert [m for m in _imports(str(src)) if _forbidden(m)] == [
        "jax.numpy", "deeplearning4j_tpu.common", "jax"]


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports every module of the port and
    ``chip_smoke.py`` (its imports; main() runs only as a script), then
    checks ``sys.modules`` for JAX, the JAX package and the frameworks of
    :data:`FOREIGN`."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {REPO!r})
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".")
                    for f in {FORBIDDEN + FOREIGN!r}))
print(len(names), bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert int(n) >= 16, out.stdout       # every module was imported
    assert bad == "[]", f"the port loaded {bad}"


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from deeplearning4j_tpu_torch.models.gpt import (
        CausalLM, init_params_numpy, params_from_jax)
    from deeplearning4j_tpu_torch.models.transformer import tiny_config
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(vocab=13, max_len=16, d_model=16, n_layers=1,
                      n_heads=2, d_ff=32)
    tree = init_params_numpy(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree)
    params = params_from_jax(tree, device="cpu")
    model = CausalLM(cfg, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(model, params, slots=1, page_size=4)
    with DecodeEngine(model, params, slots=1, page_size=4,
                      device="cpu") as eng:
        assert eng.device == torch.device("cpu")
        assert len(eng.generate(np.array([1, 2, 3], np.int32), 2)) == 2


def test_training_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """The encoder's and the classifier's parameters land on the card
    unless the caller names the CPU; so does everything the flat train
    step builds from them."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.models.bert_classifier import (
        BertSequenceClassifier)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerEncoder, tiny_config)
    from deeplearning4j_tpu_torch.params import FlatParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(vocab=16, max_len=8, d_model=16, n_layers=1,
                      n_heads=2, d_ff=32)
    enc = TransformerEncoder(cfg, attn_impl="flash")
    clf = BertSequenceClassifier(cfg, 2, attn_impl="flash")
    for init in (enc.init_params, clf.init_params):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init()
    flat = FlatParams(enc.init_params(device="cpu"))
    assert flat.master.device == torch.device("cpu")
    upd = Adam(1e-3)
    opt = upd.init_state(flat.master)
    assert opt["m"].device == torch.device("cpu")
    ids = torch.zeros(2, 8, dtype=torch.long)
    mask_pos = torch.zeros(2, 8)
    mask_pos[:, 1] = 1.0
    loss = enc.make_train_step(upd)(flat, opt, 0, ids, ids, mask_pos)
    assert loss.device == torch.device("cpu") and torch.isfinite(loss)
    assert clf.init_params(device="cpu")["classifier"]["W"].shape == (16, 2)


def test_layer_framework_entry_points_refuse_the_cpu_unless_asked(
        monkeypatch, tmp_path):
    """``MultiLayerNetwork``, the zoo, the zip reader and the weight bridge
    land on the card unless the caller names the CPU; ``lstm_layer`` runs
    where its tensors are, the plain version on CPU tensors (no launch),
    and refuses any other device."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr
    from deeplearning4j_tpu_torch.ops.nn import lstm_layer
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer)
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zoo = TextGenerationLSTM(vocab_size=5, hidden=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(zoo.conf())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mln_params_from_numpy([{"W": np.zeros((2, 2), np.float32)}])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelSerializer.restoreMultiLayerNetwork(
            str(tmp_path / "absent.zip"))
    net = zoo.init(device="cpu")
    assert net.device == torch.device("cpu")
    before = (lr.fwd_launches, lr.bwd_launches)
    x = np.eye(5, dtype=np.float32)[np.arange(6).reshape(2, 3) % 5]
    net.fit(x, x)
    assert net.output(x).device == torch.device("cpu")
    assert net.rnnTimeStep(x[:, 0]).shape == (2, 5)
    ys, _ = lstm_layer(torch.zeros(2, 3, 5), torch.zeros(5, 16),
                       torch.zeros(4, 16), torch.zeros(16))
    assert ys.shape == (2, 3, 4)
    assert (lr.fwd_launches, lr.bwd_launches) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        lstm_layer(torch.zeros(2, 3, 5, device="meta"),
                   torch.zeros(5, 16, device="meta"),
                   torch.zeros(4, 16, device="meta"),
                   torch.zeros(16, device="meta"))


def test_by_name_entry_points_refuse_the_cpu_unless_asked(monkeypatch,
                                                          tmp_path):
    """``Nd4j``'s constructors and ``SameDiff`` (built or loaded) land on
    the card unless the caller names the CPU; an op by name runs where its
    tensors are, the plain version on CPU tensors (no launch)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Nd4j.zeros(2), lambda: Nd4j.ones(2),
                 lambda: Nd4j.create([1.0]), lambda: Nd4j.rand(2),
                 lambda: Nd4j.randn(2), SameDiff, SameDiff.create):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    sd = SameDiff.create(device="cpu")
    sd.var("w", np.ones((2, 2), np.float32))
    path = str(tmp_path / "g.zip")
    sd.save(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SameDiff.load(path)
    assert SameDiff.load(path, device="cpu").device == torch.device("cpu")
    before = (cb.launches_1x1, cb.launches_3x3, rt.launches)
    y, _, _ = Nd4j.exec("conv1x1_bn_stats", torch.ones(2, 4), torch.ones(4, 3))
    c = torch.ones(3)
    out = Nd4j.exec("bn_relu_residual", y, y, c, c, c, c)
    assert out.device == torch.device("cpu")
    assert (cb.launches_1x1, cb.launches_3x3, rt.launches) == before


def test_graph_entry_points_refuse_the_cpu_unless_asked(monkeypatch,
                                                        tmp_path):
    """``ComputationGraph``, the image zoo models, ``restore*`` and the
    graph weight bridge land on the card unless the caller names the CPU;
    the image ops run where their tensors are."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops.nn import batch_norm_train, conv2d
    from deeplearning4j_tpu_torch.params import cg_params_from_numpy
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer)
    from deeplearning4j_tpu_torch.zoo import LeNet, ResNet50
    from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = cut_resnet_conf()
    absent = str(tmp_path / "absent.zip")
    for make in (lambda: ComputationGraph(conf), LeNet().init,
                 ResNet50(num_classes=2, in_shape=(32, 32, 3)).init,
                 lambda: cg_params_from_numpy(conf.nodes, {}),
                 lambda: ModelSerializer.restoreComputationGraph(absent),
                 lambda: ModelSerializer.restore(absent)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    g = ComputationGraph(conf, device="cpu").init()
    assert {t.device for p in g.params_map.values() for t in p.values()} \
        == {torch.device("cpu")}
    x = np.zeros((2, 32, 32, 3), np.float32)
    g.fit(x, np.eye(4, dtype=np.float32)[[0, 1]])
    assert g.output(x)[0].device == torch.device("cpu")
    assert LeNet(in_shape=(12, 12, 1)).init(device="cpu").device \
        == torch.device("cpu")
    y = conv2d(torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 5))
    assert y.shape == (1, 4, 4, 5)
    assert batch_norm_train(y, torch.ones(5), torch.zeros(5))[0].device \
        == torch.device("cpu")


def test_training_loop_entry_points_refuse_the_cpu_unless_asked(
        monkeypatch, tmp_path):
    """The device prefetcher lands batches on the card unless the caller
    names the CPU; the loop around it (fit over an iterator, evaluation,
    early stopping, writeModel and restore) runs where the network is."""
    from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                                   DevicePrefetchIterator)
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, LocalFileModelSaver,
        MaxEpochsTerminationCondition)
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer)
    from deeplearning4j_tpu_torch.zoo import LeNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((6, 12, 12, 1), np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetchIterator(ArrayDataSetIterator(x, y, 3))
    net = LeNet(num_classes=3, in_shape=(12, 12, 1)).init(device="cpu")
    with DevicePrefetchIterator(ArrayDataSetIterator(x, y, 3),
                                device="cpu") as it:
        net.fit(it)
    ev = net.evaluate(ArrayDataSetIterator(x, y, 3))
    assert ev._counts.device == torch.device("cpu")
    saver = LocalFileModelSaver(str(tmp_path / "es"))
    EarlyStoppingTrainer(EarlyStoppingConfiguration(
        DataSetLossCalculator(ArrayDataSetIterator(x, y, 3)),
        [MaxEpochsTerminationCondition(1)], model_saver=saver), net,
        ArrayDataSetIterator(x, y, 3)).fit()
    assert saver.get_best_model().device == torch.device("cpu")
    path = str(tmp_path / "m.zip")
    ModelSerializer.writeModel(net, path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelSerializer.restore(path)
    # the fault-tolerant fit and the health monitor run where the network
    # is: its bundle restores onto the CPU network, the memory sampler
    # reads no card
    from deeplearning4j_tpu_torch.profiler import telemetry
    from deeplearning4j_tpu_torch.profiler.model_health import HealthMonitor
    from deeplearning4j_tpu_torch.util.resilience import FaultTolerance

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LeNet(num_classes=3, in_shape=(12, 12, 1)).init().setHealthMonitor(
            HealthMonitor())
    hm = HealthMonitor(frequency=1, mfu=False)
    net.setHealthMonitor(hm)
    ck = str(tmp_path / "ck")
    policy = FaultTolerance(checkpoint_dir=ck, divergence_window=2)
    policy.request_preemption()
    net.fit(ArrayDataSetIterator(x, y, 3), epochs=2, fault_tolerance=policy)
    assert hm.fetches == 1 and hm.last["nonfinite_first_layer"] == -1
    fresh = LeNet(num_classes=3, in_shape=(12, 12, 1)).init(device="cpu")
    fresh.fit(ArrayDataSetIterator(x, y, 3), epochs=2, auto_resume=ck)
    assert fresh.getIterationCount() == net.getIterationCount() + 3
    assert {t.device for p in fresh.params_list for t in p.values()} == {
        torch.device("cpu")}
    assert telemetry.sample_device_memory(fresh.device) == {}


def test_samediff_slice_entry_points_refuse_the_cpu_unless_asked(
        monkeypatch, tmp_path):
    """The by-name slice: a graph for ``fit``, ``evaluate`` or control
    flow, the new ``Nd4j`` factories and the ops that take no tensor land
    on the card unless the caller names the CPU (a graph on the CPU names
    it for its ops); on the CPU they run and launch no kernel."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops.registry import get_op

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (SameDiff.create, lambda: Nd4j.eye(2),
                 lambda: Nd4j.arange(3), lambda: Nd4j.valueArrayOf(2, 1.0),
                 lambda: Nd4j.randint(0, 3, (2,)),
                 lambda: get_op("range")(0, 3),
                 lambda: get_op("random_normal")(0, (2,)),
                 lambda: get_op("fill")((2,), 1.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    sd = SameDiff.create(device="cpu")
    x = sd.placeholder("x", shape=(None, 2))
    y = sd.placeholder("y", shape=(None, 2))
    w = sd.var("w", np.eye(2, dtype=np.float32))
    p = sd.placeholder("p", shape=())
    h = sd.ifCond(p, [x @ w], lambda s, a: a * 2.0, lambda s, a: a)
    i0 = sd.constant("i0", np.int32(0))
    _, h2 = sd.whileLoop([i0, h], lambda s, i, a: i < 2,
                         lambda s, i, a: [i + 1, s.nn.tanh(a)])
    out = sd.nn.softmax(h2 + sd.math.range(0, 2, dtype="float32"),
                        name="out")
    sd.setLossVariables(sd.math.square(out - y).mean())
    sd.setTrainingConfig(TrainingConfig(
        updater=Sgd(0.1), data_set_feature_mapping=["x", "p"],
        data_set_label_mapping=["y"]))
    xs = np.ones((4, 2), np.float32)
    ys = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]
    before = (fa.fwd_launches, fa.bwd_launches)
    hist = sd.fit(DataSet([xs, np.asarray(True)], ys), epochs=2)
    assert len(hist.lossCurve()) == 2
    assert sd._arrays["w"].device == torch.device("cpu")
    ev = sd.evaluate([DataSet([xs, np.asarray(False)], ys)], "out")
    assert ev.accuracy() >= 0.0
    path = str(tmp_path / "g.sdz")
    sd.save(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SameDiff.load(path)
    assert SameDiff.load(path, device="cpu")._updater_state == ()  # Sgd
    assert (fa.fwd_launches, fa.bwd_launches) == before
