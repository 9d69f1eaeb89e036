"""PyTorch port, the ONNX importer (``modelimport/onnx/onnx_import.py``)
against the JAX package's, on the CPU.

- Every case of the JAX package's ONNX tests that imports a model
  (``tests/torch_onnx_cases.py``: the mapper battery, the import and
  breadth batteries, the recurrent corners, and the models
  ``torch.onnx.export`` writes: ResNet-18 at 64 x 64, the small
  transformer, the depthwise stack, the upsampling decoder, LSTM, GRU
  and RNN, the scripted If / Loop modules) runs as it is with both
  importers on the same ModelProto bytes: the case's own oracle checks
  the port's outputs, and they equal JAX's (shape and dtype; integers
  exactly, floats within rtol 1e-5 / atol 1e-6). A case that expects an
  ``OnnxImportError`` gets it from both, with the same message.
- The avals the walk ends with equal JAX's, name by name, shape and
  dtype, on the small transformer and the five scripted control-flow
  models.
- Control flow trains as JAX's does: the counted ``while i < N`` export
  derives JAX's ``max_trip_count`` (5; 3 with an If inside) and its
  gradients equal torch autograd's; a Loop's scan output carries its
  gradient; the condition-driven loop stays inference-only and its
  gradient raises JAX's documented error; the nested If-in-Loop graph
  saves and loads.
- A fine-tune of the imported ResNet-18 (rank >= 2 initializers
  promoted, softmax cross-entropy, Adam): the first three losses equal
  JAX's within 1e-4 relative from the same weights; two steps, save,
  load and a third step equal three steps bit for bit.
- The port raises where JAX's does (a non-constant input a mapper needs
  as a constant) and refuses the card's default with no card.
- Coverage: the port's mapper registry equals JAX's 130 names, and this
  file's imports drive every one of them and If / Loop (the port's
  ``modelimport.trace``; run last in the file).
"""

import numpy as np
import pytest
import torch

import torch_onnx_cases as tc
import test_onnx_real_models as tr

from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.modelimport import trace
from deeplearning4j_tpu_torch.modelimport.onnx import (
    OnnxImport, OnnxImportError, OnnxOpMappingRegistry, decode_model,
)
from deeplearning4j_tpu_torch.modelimport.onnx import onnx_import as pim
from test_onnx_import import graph, model, node, tensor, value_info


@pytest.mark.parametrize("cid", tc.HAND_CASES + tc.REAL_CASES)
def test_case_matches_jax(cid):
    tc.run(cid)


# ------------------------------------------------------------------ avals
def _walk_avals(mod, importer, data, **kw):
    """The top-level walk's avals dict of one import."""
    seen = {}
    orig = mod._walk_onnx_nodes

    def walk(sd, nodes, tensors, const_vals, avals, resolve_outer=None):
        if resolve_outer is None:
            seen.setdefault("avals", avals)
        return orig(sd, nodes, tensors, const_vals, avals, resolve_outer)

    mod._walk_onnx_nodes = walk
    try:
        importer.importGraph(data, **kw)
    finally:
        mod._walk_onnx_nodes = orig
    return seen["avals"]


def _exported(mod, x, script=False):
    with tc._export_shim():
        m = torch.jit.script(mod) if script else mod
        m.eval()
        return tc.model_bytes(tr._export(m, (x,)))


def _transformer():
    torch.manual_seed(1)
    try:
        torch.backends.mha.set_fastpath_enabled(False)
        return _exported(tr.SmallTransformer(), torch.randint(0, 50, (3, 12)))
    finally:
        torch.backends.mha.set_fastpath_enabled(True)


_SCRIPTED = {"if": (tr.ScriptedIf, False), "while": (tr.ScriptedWhile, False),
             "cond_while": (tr.ScriptedCondWhile, True),
             "loop_if": (tr.ScriptedLoopIf, False),
             "cond_while_weighted": (tr.ScriptedCondWhileWeighted, True)}


def _scripted(name, seed=0):
    cls, positive = _SCRIPTED[name]
    torch.manual_seed(seed)
    x = torch.randn(2, 3)
    x = x.abs() if positive else x
    return _exported(cls(), x, script=True), x


@pytest.mark.parametrize("name", ["transformer"] + sorted(_SCRIPTED))
def test_walk_avals_equal_jax(name):
    import deeplearning4j_tpu.modelimport.onnx.onnx_import as jim

    data = _transformer() if name == "transformer" else _scripted(name)[0]
    jav = _walk_avals(jim, jim.OnnxImport, data)
    pav = _walk_avals(pim, OnnxImport, data, device="cpu")
    assert sorted(pav) == sorted(jav)
    for k, j in jav.items():
        p = pav[k]
        assert tuple(p.shape) == tuple(j.shape), (k, p, j)
        assert str(p.dtype).split(".")[1] == np.dtype(j.dtype).name, \
            (k, p, j)
    if name == "transformer":
        assert len(jav) == 191


# ---------------------------------------------------------- control flow
def _import_scripted(name, seed):
    data, x = _scripted(name, seed)
    sd = OnnxImport.importGraph(data, device="cpu")
    g = decode_model(data).graph
    return sd, g.inputs[0].name, g.outputs[0].name, x


def _grad_matches_torch(name, seed, trips):
    sd, inp, out, x = _import_scripted(name, seed)
    node_ = next(n for n in sd._ops if n.op_name == "while_loop")
    assert node_.attrs["max_trip_count"] == trips
    xt = x.clone().requires_grad_(True)
    (_SCRIPTED[name][0]()(xt) ** 2).sum().backward()
    sq = sd._op("mul", [out, out])
    loss = sd._op("reduce_sum", [sq.name])
    sd.setLossVariables(loss.name)
    sd.convertConstantsToVariables(*[])
    leaf = x.clone().requires_grad_(True)
    env = {**sd._arrays, inp: leaf}
    total = sd._total_loss(env)
    (gx,) = torch.autograd.grad(total, [leaf])
    np.testing.assert_allclose(gx.numpy(), xt.grad.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_counted_while_derives_its_bound_and_trains():
    """``while i < 5`` exports a Loop with an INT64_MAX trip count and the
    condition recomputed in the body: JAX's derivation bounds it at 5,
    and gradients through it equal torch autograd's."""
    _grad_matches_torch("while", 4, 5)


def test_loop_with_if_inside_trains():
    _grad_matches_torch("loop_if", 6, 3)


def test_condition_driven_loop_stays_inference_only():
    sd, inp, out, x = _import_scripted("cond_while_weighted", 5)
    node_ = next(n for n in sd._ops if n.op_name == "while_loop")
    assert node_.attrs["max_trip_count"] is None
    with torch.no_grad():
        want = tr.ScriptedCondWhileWeighted()(x).numpy()
    got = sd.output({inp: x.numpy()}, [out])[out].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    loss = sd._op("reduce_sum", [out])
    sd.setLossVariables(loss.name)
    w = next(n for n, a in sd._arrays.items()
             if sd.getVariable(n).vtype.value == "CONSTANT"
             and tuple(a.shape) == (3,))
    sd.convertConstantsToVariables(w)
    with pytest.raises(ValueError, match="inference-only"):
        sd.calculateGradients({inp: x.numpy()})


def _scan_model():
    import test_onnx_rnn_corners as trc

    return trc.TestLoopScanOutputs()._model()


def test_loop_scan_output_carries_its_gradient():
    """``tests/test_onnx_rnn_corners.py``'s scan-output Loop: d/dx of the
    stacked rows' sum is sum_k 2(x + 0.5k)."""
    sd = OnnxImport.importGraph(_scan_model(), device="cpu")
    x = torch.tensor([1.0, -2.0], requires_grad=True)
    loss = sd._op("reduce_sum", ["stacked"])
    sd.setLossVariables(loss.name)
    (g,) = torch.autograd.grad(sd._total_loss({**sd._arrays, "x": x}), [x])
    want = sum(2.0 * (x.detach().numpy() + 0.5 * k) for k in (1, 2, 3))
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5)


def test_control_flow_graph_saves_and_loads(tmp_path):
    sd, inp, out, x = _import_scripted("loop_if", 9)
    with torch.no_grad():
        want = tr.ScriptedLoopIf()(x).numpy()
    p = str(tmp_path / "cf.sdz")
    sd.save(p)
    got = SameDiff.load(p, device="cpu").output({inp: x.numpy()},
                                                [out])[out].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- fine-tune
def _resnet18_model():
    torch.manual_seed(0)
    m = tr.ResNet18(num_classes=10)
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.uniform_(-0.2, 0.2)
            mod.running_var.uniform_(0.6, 1.4)
    return _exported(m, torch.randn(2, 3, 64, 64))


def _promote(sd, data, training_config, updater):
    g = decode_model(data).graph
    sd.convertConstantsToVariables(*[t.name for t in g.initializers
                                     if len(t.dims) >= 2])
    y = sd.placeholder("labels", shape=(None,))
    oh = sd.math.one_hot(y, depth=10)
    logp = sd.nn.log_softmax(sd.getVariable(g.outputs[0].name))
    loss = -(oh * logp).sum(-1).mean()
    sd.setLossVariables(loss.name)
    sd.setTrainingConfig(training_config(
        updater=updater, data_set_feature_mapping=[g.inputs[0].name],
        data_set_label_mapping=["labels"]))
    return sd


def _batches(n):
    rng = np.random.default_rng(23)
    return [(rng.standard_normal((4, 3, 64, 64), dtype=np.float32),
             rng.integers(0, 10, 4).astype(np.int32)) for _ in range(n)]


def test_resnet18_fine_tune_matches_jax_and_resumes_bit_equal(tmp_path):
    from deeplearning4j_tpu import autodiff as jad
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.learning import updaters as jup
    from deeplearning4j_tpu.modelimport.onnx import OnnxImport as JaxImport

    data = _resnet18_model()
    batches = _batches(3)
    jsd = _promote(JaxImport.importGraph(data), data, jad.TrainingConfig,
                   jup.Adam(1e-3))
    want = jsd.fit([JDataSet(x, y) for x, y in batches]).lossCurve()

    def port():
        return _promote(OnnxImport.importGraph(data, device="cpu"), data,
                        TrainingConfig, Adam(1e-3))

    sd = port()
    got = sd.fit([DataSet(x, y) for x, y in batches]).lossCurve()
    assert len(got) == 3 and got[-1] < got[0], got
    for p, j in zip(got, want):
        assert abs(p - j) <= 1e-4 * abs(j), (got, want)
    part = port()
    first = part.fit([DataSet(x, y) for x, y in batches[:2]]).lossCurve()
    path = str(tmp_path / "resnet18.sdz")
    part.save(path)
    resumed = SameDiff.load(path, device="cpu")
    last = resumed.fit([DataSet(*batches[2])]).lossCurve()
    assert first + last == got
    for n in sd.trainable_names():
        assert torch.equal(resumed._arrays[n], sd._arrays[n]), n


# ---------------------------------------------------------------- errors
def test_a_mapper_needs_its_constant_as_in_jax():
    from deeplearning4j_tpu.modelimport.onnx.onnx_import import (
        OnnxImport as JaxImport, OnnxImportError as JaxError)

    g = graph([node("Reshape", ["x", "shape"], ["y"], "r")], [],
              [value_info("x", [2, 6]), value_info("shape", [2])],
              [value_info("y", [])])
    data = model(g)
    with pytest.raises(JaxError) as je:
        JaxImport.importGraph(data)
    with pytest.raises(OnnxImportError) as pe:
        OnnxImport.importGraph(data, device="cpu")
    assert str(pe.value) == str(je.value)
    assert "must be a constant" in str(pe.value)


def test_the_import_needs_the_card_unless_the_cpu_is_named(monkeypatch):
    g = graph([node("Relu", ["x"], ["y"])], [tensor("w", np.ones(
        2, np.float32))], [value_info("x", [2])], [value_info("y", [2])])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnnxImport.importGraph(model(g))
    sd = OnnxImport.importGraph(model(g), device="cpu")
    assert sd.device == torch.device("cpu")
    assert all(a.device.type == "cpu" for a in sd._arrays.values())


# -------------------------------------------------------------- coverage
def test_zzz_mapper_coverage_equals_jax_and_is_driven():
    """The port's ONNX mappers are JAX's 130 names; this file's imports
    drove every one of them and If / Loop (run last in the file; the
    imports of any case not yet run in this process are made here, by the
    port alone)."""
    from deeplearning4j_tpu.modelimport.onnx import (
        OnnxOpMappingRegistry as JaxRegistry)

    assert OnnxOpMappingRegistry.coverage() == JaxRegistry.coverage()
    assert len(OnnxOpMappingRegistry.coverage()) == 130
    wanted = {f"onnx:{n}" for n in OnnxOpMappingRegistry.coverage()} | \
        {"onnx:If", "onnx:Loop"}
    for cid in tc.HAND_CASES + tc.REAL_CASES:
        if not wanted - trace.driven_mappers():
            break
        tc.run(cid, tc.PortOnlyImport)
    missing = sorted(wanted - trace.driven_mappers())
    assert not missing, missing
