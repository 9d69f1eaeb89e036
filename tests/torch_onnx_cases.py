"""The ONNX models of the port's importer tests
(``tests/test_torch_onnx_proto.py``, ``test_torch_onnx_import.py``): the
JAX package's own ONNX test cases, run as they are, with their
``OnnxImport`` replaced by one that imports the same ModelProto bytes
through JAX's importer and the port's (on the CPU).

- ``tests/test_onnx_mapper_battery.py`` (a micro-graph per mapper),
  ``tests/test_onnx_import.py`` (decoder, MLP, conv, shape ops and the
  round-4 breadth batches) and ``tests/test_onnx_rnn_corners.py`` (the
  recurrent corners and Loop scan outputs), each built by the tiny
  protobuf encoder of ``tests/test_onnx_import.py:15-60``
  (:data:`HAND_CASES`);
- ``tests/test_onnx_real_models.py``'s models exported by
  ``torch.onnx.export`` (ResNet-18 at 64 x 64, the small transformer,
  the depthwise stack, the upsampling decoder, the recurrent operators,
  the scripted If/Loop modules; :data:`REAL_CASES`).

Each case's own oracle (numpy or torch) then checks the PORT's outputs;
:class:`DualSameDiff` also holds them to JAX's outputs on the same feeds
(same shape and dtype; integers and booleans exactly, floats within
rtol 1e-5 / atol 1e-6). The cases that import no model, or take JAX gradients
of JAX's graph (``jax.grad`` over ``_build_fn``), or save JAX's graph
are left out here: the port's own decoder, gradient and save/load tests
stand in for them (:data:`JAX_ONLY`).
"""

import contextlib
import inspect
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_onnx_import as ti  # noqa: E402  (the JAX package's cases)
import test_onnx_mapper_battery as tb  # noqa: E402
import test_onnx_real_models as tr  # noqa: E402
import test_onnx_rnn_corners as trc  # noqa: E402

from deeplearning4j_tpu.modelimport.onnx.onnx_import import (  # noqa: E402
    OnnxImport as JaxImport, OnnxImportError as JaxImportError,
)
from deeplearning4j_tpu_torch.modelimport.onnx.onnx_import import (  # noqa: E402
    OnnxImport as PortImport, OnnxImportError as PortImportError,
)

#: the JAX package's cases that import nothing (they run JAX's decoder or
#: list JAX's registry), or take JAX gradients of, or save, JAX's own
#: graph: nothing of the port would run in them
JAX_ONLY = {
    "test_onnx_import:TestDecoder.test_model_fields",
    "test_onnx_import:TestDecoder.test_tensor_raw_roundtrip",
    "test_onnx_import:TestDecoder.test_int64_tensor",
    "test_onnx_import:TestDecoder.test_garbage_rejected",
    "test_onnx_import:TestMlpImport.test_coverage_listing",
    "test_onnx_rnn_corners:TestGruResetBefore.test_both_forms_differ",
    "test_onnx_rnn_corners:TestLoopScanOutputs.test_grad_flows_through_"
    "scan_output",
    "test_onnx_real_models:TestOnnxControlFlow.test_counted_while_is_"
    "trainable",
    "test_onnx_real_models:TestOnnxControlFlow.test_loop_if_nested_"
    "trainable",
    "test_onnx_real_models:TestOnnxControlFlow.test_control_flow_survives_"
    "serde",
    "test_onnx_real_models:TestOnnxControlFlow.test_condition_driven_"
    "while_stays_inference_only",
}
#: the models the running case handed to ``OnnxImport`` (bytes or paths)
RECORDED = []


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def same_outputs(want, got, name=""):
    """JAX's output against the port's: shape and dtype equal, integers
    and booleans exact, floats within rtol 1e-5 / atol 1e-6."""
    assert want.shape == got.shape and want.dtype == got.dtype, \
        (name, want.shape, got.shape, want.dtype, got.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   equal_nan=True, err_msg=name)


class DualSameDiff:
    """JAX's imported graph and the port's, as one: ``output`` runs both
    and returns the port's outputs (numpy), held to JAX's; every other
    attribute is JAX's graph's (the cases read variables and op names)."""

    def __init__(self, jsd, psd):
        self.jsd, self.psd = jsd, psd

    def __getattr__(self, name):
        return getattr(self.jsd, name)

    def output(self, feeds, names):
        want = self.jsd.output(feeds, names)
        got = self.psd.output(feeds, names)
        out = {}
        for n in names:
            w, g = np.asarray(want[n]), _np(got[n])
            same_outputs(w, g, n)
            out[n] = g
        return out


def _port_import(src):
    """The port's import of ``src`` on the CPU; its OnnxImportError is
    raised as JAX's class, with the port's message, so that the cases'
    ``pytest.raises(OnnxImportError, match=...)`` holds the port."""
    try:
        return PortImport.importGraph(src, device="cpu")
    except PortImportError as e:
        raise JaxImportError(str(e)) from e


class DualImport:
    """The cases' ``OnnxImport``: the same model through both importers
    (the port's on the CPU). Where one raises, the other must raise the
    same message."""

    @staticmethod
    def importGraph(src):
        RECORDED.append(src)
        try:
            psd = _port_import(src)
        except JaxImportError as e:
            with pytest.raises(JaxImportError) as je:
                JaxImport.importGraph(src)
            assert str(je.value) == str(e), (str(je.value), str(e))
            raise
        return DualSameDiff(JaxImport.importGraph(src), psd)

    @staticmethod
    def _as_model(src):
        # the RNN corners pass their bytes through _as_model; the scripted
        # models read the decoded graph's outputs
        return src if isinstance(src, bytes) else JaxImport._as_model(src)


class PortOnlySameDiff:
    """The port's imported graph, its outputs as numpy arrays (the cases'
    oracles read them)."""

    def __init__(self, psd):
        self.psd = psd

    def __getattr__(self, name):
        return getattr(self.psd, name)

    def output(self, feeds, names):
        return {n: _np(t) for n, t in self.psd.output(feeds, names).items()}


class PortOnlyImport:
    """The cases' ``OnnxImport`` with the port's importer alone (on the
    CPU): the cases' oracles check it, nothing is compared with JAX."""

    @staticmethod
    def importGraph(src):
        RECORDED.append(src)
        return PortOnlySameDiff(_port_import(src))

    _as_model = DualImport._as_model


def _cases(mod):
    out = []
    for cname, cls in inspect.getmembers(mod, inspect.isclass):
        if not cname.startswith("Test") or cls.__module__ != mod.__name__:
            continue
        for mname, fn in inspect.getmembers(cls, inspect.isfunction):
            if not mname.startswith("test"):
                continue
            params = [None]
            for mark in getattr(fn, "pytestmark", []):
                if mark.name == "parametrize":
                    params = list(mark.args[1])
            for p in params:
                cid = f"{mod.__name__}:{cname}.{mname}"
                if cid in JAX_ONLY:
                    continue
                out.append(cid if p is None else f"{cid}[{p}]")
    return out


HAND_CASES = _cases(tb) + _cases(ti) + _cases(trc)
REAL_CASES = _cases(tr)
_MODS = {m.__name__: m for m in (tb, ti, tr, trc)}


@contextlib.contextmanager
def _export_shim():
    """``tests/test_onnx_real_models.py``'s fixture: the TorchScript
    exporter's onnxscript hook as the identity."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    saved = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, opsets: \
        model_bytes
    try:
        yield
    finally:
        onnx_proto_utils._add_onnxscript_fn = saved


@contextlib.contextmanager
def patched_import(importer):
    """Every case module's ``OnnxImport`` is ``importer`` inside this
    block (``test_onnx_rnn_corners`` reads the encoder module under both
    of its names)."""
    mods = list(_MODS.values())
    extra = sys.modules.get("tests.test_onnx_import")
    saved = [(m, m.__dict__.get("OnnxImport")) for m in mods + (
        [extra] if extra is not None else [])]
    for m, _ in saved:
        m.OnnxImport = importer
    try:
        with _export_shim():
            yield
    finally:
        for m, v in saved:
            if v is not None:
                m.OnnxImport = v


def run(cid, importer=DualImport):
    """Run one case of the JAX package's ONNX tests with ``importer`` as
    its ``OnnxImport``; returns the models it imported."""
    head, _, param = cid.partition("[")
    modname, _, qual = head.partition(":")
    cname, mname = qual.split(".")
    cls = getattr(_MODS[modname], cname)
    fn = getattr(cls, mname)
    del RECORDED[:]
    with patched_import(importer):
        args = [cls()]
        if param:
            args.append(param[:-1])
        if "tmp_path" in inspect.signature(fn).parameters:
            import pathlib
            args.append(pathlib.Path(tempfile.mkdtemp()))
        fn(*args)
    return list(RECORDED)


def model_bytes(src) -> bytes:
    if isinstance(src, bytes):
        return src
    with open(src, "rb") as f:
        return f.read()
