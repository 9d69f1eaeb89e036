"""PyTorch port, the ONNX wire decoder and its initializer encoder
(``modelimport/onnx/onnx_proto.py``) against the JAX package's decoder.

- Every model the JAX package's ONNX tests build (``tests/
  torch_onnx_cases.py``: the hand-built batteries and the models
  ``torch.onnx.export`` writes), run through the port's importer alone
  (the cases' own oracles check its outputs), decodes as JAX's decoder
  decodes it: the model's fields, every node with its attributes and
  sub-graphs, every initializer's fields and values, the graph inputs
  and outputs, the opset.
- Tensors by hand: float16 in ``raw_data`` and in ``int32_data``, int64
  packed and unpacked with negative values, bool, uint8, int8, double,
  unpacked floats; bfloat16 and string tensors raise JAX's error, and so
  does a tensor whose data is external.
- The encoder: emptying and refilling gives the model's bytes back;
  ``seeded_initializers`` is deterministic, fills exactly the emptied
  float initializers, in name order, by its stated rule.
- The committed ResNet-50 fixture decodes as JAX's decoder decodes it,
  every emptied initializer gets its ``state_dict`` shape, the seeded
  model has the golden's byte count, and the port imports it on the CPU
  to torch's stored logits.
"""

import numpy as np
import pytest
import torch

import torch_onnx_cases as tc

from deeplearning4j_tpu.modelimport.onnx import onnx_proto as jp
from deeplearning4j_tpu_torch.modelimport.onnx import onnx_proto as pp
from deeplearning4j_tpu_torch.tools import make_onnx_fixture as mf
from test_onnx_import import (_iv, _ld, _str, graph, model, node, tensor,
                              value_info)


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a, b)
    else:
        assert a.tolist() == b.tolist()


def _same_tensor(jt, pt):
    assert (pt.name, pt.dims, pt.data_type) == (jt.name, jt.dims,
                                                jt.data_type)
    assert pt._raw == jt._raw
    for f in ("_float_data", "_int32_data", "_int64_data", "_double_data"):
        _same_array(getattr(jt, f), getattr(pt, f))
    if jt.data_type in jt._DTYPES and (jt._raw or jt._float_data or
                                       jt._int32_data or jt._int64_data or
                                       jt._double_data or not jt.dims):
        _same_array(jt.to_numpy(), pt.to_numpy())


def _same_value(jv, pv):
    if isinstance(jv, jp.GraphProto):
        _same_graph(jv, pv)
    elif isinstance(jv, list) and jv and isinstance(jv[0], jp.GraphProto):
        assert len(jv) == len(pv)
        for a, b in zip(jv, pv):
            _same_graph(a, b)
    elif isinstance(jv, np.ndarray):
        _same_array(jv, pv)
    else:
        assert type(jv) is type(pv) and jv == pv, (jv, pv)


def _same_info(jvs, pvs):
    assert [(v.name, v.elem_type, v.shape) for v in pvs] == \
        [(v.name, v.elem_type, v.shape) for v in jvs]


def _same_graph(jg, pg):
    assert pg.name == jg.name
    assert len(pg.nodes) == len(jg.nodes)
    for jn, pn in zip(jg.nodes, pg.nodes):
        assert (pn.name, pn.op_type, pn.domain, pn.input, pn.output) == \
            (jn.name, jn.op_type, jn.domain, jn.input, jn.output)
        assert list(pn.attributes) == list(jn.attributes)
        for k, v in jn.attributes.items():
            _same_value(v, pn.attributes[k])
    assert len(pg.initializers) == len(jg.initializers)
    for a, b in zip(jg.initializers, pg.initializers):
        _same_tensor(a, b)
    _same_info(jg.inputs, pg.inputs)
    _same_info(jg.outputs, pg.outputs)


def _same_model(data):
    jm, pm = jp.decode_model(data), pp.decode_model(data)
    assert (pm.ir_version, pm.producer_name, pm.opset_version) == \
        (jm.ir_version, jm.producer_name, jm.opset_version)
    _same_graph(jm.graph, pm.graph)
    return pm


@pytest.mark.parametrize("cid", tc.HAND_CASES + tc.REAL_CASES)
def test_every_test_model_decodes_as_jax_decodes_it(cid):
    models = tc.run(cid, tc.PortOnlyImport)
    assert models, cid
    for src in models:
        _same_model(tc.model_bytes(src))


def test_model_fields_and_garbage_as_jax():
    """``tests/test_onnx_import.py``'s decoder cases on the port's
    decoder: the MLP model's fields, a raw float tensor, an int64 tensor,
    and a model with no graph rejected."""
    blob, _ = __import__("test_onnx_import")._mlp_model(
        np.random.RandomState(0))
    m = _same_model(blob)
    assert m.producer_name == "dl4j-tpu-test" and m.opset_version == 13
    assert [n.op_type for n in m.graph.nodes] == \
        ["Gemm", "Relu", "Gemm", "Softmax"]
    assert m.graph.nodes[3].attributes["axis"] == 1
    assert m.graph.inputs[0].shape == [2, 4]
    for arr in (np.arange(12, dtype=np.float32).reshape(3, 4),
                np.asarray([2, -1, 7], np.int64)):
        t = _same_model(_model_of(tensor("t", arr))).graph.initializers[0]
        _same_array(t.to_numpy(), arr)
    for mod in (jp, pp):
        with pytest.raises(mod.OnnxDecodeError, match="no GraphProto"):
            mod.decode_model(b"\x08\x01")


def _raw_tensor(name, dt, dims, payload, field=9):
    out = b"".join(_iv(1, d) for d in dims) + _iv(2, dt) + _str(8, name)
    return out + _ld(field, payload)


def _model_of(*tensors):
    return model(graph([], list(tensors), [], []))


def _varint(v):
    from test_onnx_import import _varint as enc
    return enc(v)


def test_tensor_types_and_fields_decode_as_jax():
    f16 = np.asarray([[1.5, -2.25], [65504.0, 6e-5]], np.float16)
    ints = [-3, 0, 2 ** 40, -(2 ** 62)]
    tensors = [
        _raw_tensor("f16raw", 10, [2, 2], f16.tobytes()),
        _raw_tensor("f16i32", 10, [3], b"".join(_varint(v)
                                                 for v in (1, 2, 15360)),
                    field=5),
        _raw_tensor("i64packed", 7, [4], b"".join(_varint(v) for v in ints),
                    field=7),
        # unpacked int64 and float: one field a value
        b"".join(_iv(1, d) for d in [2]) + _iv(2, 7) + _str(8, "i64un")
        + _iv(7, -5) + _iv(7, 9),
        b"".join(_iv(1, d) for d in [2]) + _iv(2, 1) + _str(8, "f32un")
        + b"".join(_varint((4 << 3) | 5) + np.float32(v).tobytes()
                   for v in (0.25, -7.0)),
        _raw_tensor("f32packed", 1, [3], np.asarray(
            [1, 2, 3], np.float32).tobytes(), field=4),
        _raw_tensor("f64", 11, [2], np.asarray([1e300, -2.5]).tobytes(),
                    field=10),
        _raw_tensor("b", 9, [3], np.asarray([1, 0, 1], np.uint8).tobytes()),
        _raw_tensor("u8", 2, [2], bytes([0, 255])),
        _raw_tensor("i8", 3, [2], np.asarray([-128, 127], np.int8)
                    .tobytes()),
        tensor("scalar", np.asarray(3.5, np.float32)),
    ]
    pm = _same_model(_model_of(*tensors))
    vals = {t.name: t.to_numpy() for t in pm.graph.initializers}
    _same_array(vals["f16raw"], f16)
    _same_array(vals["i64packed"], np.asarray(ints, np.int64))
    _same_array(vals["i64un"], np.asarray([-5, 9], np.int64))
    _same_array(vals["f32un"], np.asarray([0.25, -7.0], np.float32))
    _same_array(vals["b"], np.asarray([True, False, True]))
    assert vals["scalar"].shape == ()


@pytest.mark.parametrize("dt", [16, 8])
def test_bfloat16_and_string_tensors_raise_as_in_jax(dt):
    data = _model_of(_raw_tensor("t", dt, [2], b"\x00\x01\x02\x03"))
    errs = []
    for mod in (jp, pp):
        with pytest.raises(mod.OnnxDecodeError) as e:
            mod.decode_model(data).graph.initializers[0].to_numpy()
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "unsupported data_type" in errs[1]


def test_external_data_raises_as_in_jax():
    """A tensor whose values live in another file (``data_location`` 1,
    ``external_data`` entries) holds none here: ``to_numpy`` fails to
    shape it in both decoders."""
    entry = _ld(1, b"location") + _ld(2, b"weights.bin")
    ext = b"".join(_iv(1, d) for d in [2, 3]) + _iv(2, 1) + _str(8, "w") \
        + _ld(13, entry) + _iv(14, 1)
    data = _model_of(ext)
    msgs = []
    for mod in (jp, pp):
        with pytest.raises(ValueError) as e:
            mod.decode_model(data).graph.initializers[0].to_numpy()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    _same_model(data)


def test_empty_and_fill_give_the_model_back():
    rs = np.random.RandomState(0)
    ws = {"w_b": rs.randn(3, 5).astype(np.float32),
          "w_a": rs.randn(4).astype(np.float32),
          "h": rs.randn(2, 2).astype(np.float16)}
    keep = tensor("shape", np.asarray([2, -1], np.int64))
    g = graph([node("Reshape", ["x", "shape"], ["y"])],
              [tensor("w_b", ws["w_b"]), keep, tensor("w_a", ws["w_a"]),
               _raw_tensor("h", 10, [2, 2], ws["h"].tobytes())],
              [value_info("x", [2, 6])], [value_info("y", [])])
    whole = model(g)
    small = pp.empty_initializers(whole)
    assert len(small) < len(whole)
    assert [t.name for t in pp.emptied_initializers(small)] == \
        ["h", "w_a", "w_b"]
    assert not pp.emptied_initializers(whole)
    assert pp.fill_initializers(small, ws) == whole
    with pytest.raises(pp.OnnxDecodeError, match="shape"):
        pp.fill_initializers(small, {"w_a": np.zeros(5, np.float32)})
    with pytest.raises(pp.OnnxDecodeError, match="no initializers"):
        pp.fill_initializers(small, {"nope": np.zeros(1, np.float32)})
    # the int64 initializer keeps its values and its bytes
    assert _ld(5, keep) in small


def test_seeded_initializers_follow_their_rule():
    names = {"conv.weight": [8, 3, 3, 3], "fc.weight": [10, 20],
             "bn.running_mean": [8], "bn.running_var": [8],
             "bn.weight": [8], "bn.bias": [8], "fc.bias": [10]}
    g = graph([], [tensor(n, np.zeros(d, np.float32))
                   for n, d in names.items()], [], [])
    small = pp.empty_initializers(model(g))
    a = pp.seeded_initializers(small, 7)
    b = pp.seeded_initializers(pp.decode_model(small), 7)
    assert list(a) == sorted(names)
    for n in a:
        assert a[n].dtype == np.float32 and list(a[n].shape) == names[n]
        np.testing.assert_array_equal(a[n], b[n])
    assert not np.array_equal(pp.seeded_initializers(small, 8)["fc.weight"],
                              a["fc.weight"])
    rng = np.random.default_rng(7)
    want = {}
    for n in sorted(names):
        size = int(np.prod(names[n]))
        if len(names[n]) >= 2:
            v = rng.standard_normal(size, dtype=np.float32) * np.float32(
                np.sqrt(2.0 / np.prod(names[n][1:])))
        else:
            lo, hi = {"bn.running_mean": (-0.2, 0.2),
                      "bn.running_var": (0.6, 1.4),
                      "bn.weight": (0.8, 1.2)}.get(n, (-0.1, 0.1))
            v = rng.uniform(lo, hi, size)
        want[n] = np.asarray(v, np.float32).reshape(names[n])
    for n in names:
        np.testing.assert_array_equal(a[n], want[n])
    full = pp.seeded_model(small, 7)
    for t in jp.decode_model(full).graph.initializers:
        np.testing.assert_array_equal(t.to_numpy(), a[t.name])


def test_committed_fixture_decodes_as_jax_and_seeds_the_state_dict():
    small, golden = mf.load_fixture()
    pm = _same_model(small)
    g = pm.graph
    assert len(g.nodes) == int(golden["nodes"]) == 175
    assert len(g.initializers) == int(golden["initializers"]) == 267
    assert pm.opset_version == 13
    assert g.inputs[0].shape == [None, 3, mf.HW, mf.HW]
    emptied = pp.emptied_initializers(small)
    assert len(emptied) == 267
    net = mf.ResNet50()
    assert sum(p.numel() for p in net.parameters()) == 25_557_032
    shapes = {k: list(v.shape) for k, v in net.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    seeded = pp.seeded_initializers(small, int(golden["seed"]))
    assert sorted(seeded) == sorted(shapes)
    for name, arr in seeded.items():
        assert list(arr.shape) == shapes[name], name
    full = pp.fill_initializers(small, seeded)
    assert len(full) == int(golden["whole_bytes"])
    assert full == pp.seeded_model(small, int(golden["seed"]))


def test_committed_fixture_imports_to_torchs_logits():
    """The whole ResNet-50 (224 x 224, 1,000 classes) through the port's
    importer on the CPU: torch's stored eval-mode logits within rtol 1e-3
    / atol 1e-3, as phase 26 holds the card."""
    from deeplearning4j_tpu_torch.modelimport.onnx import OnnxImport

    small, golden = mf.load_fixture()
    sd = OnnxImport.importGraph(pp.seeded_model(small, int(golden["seed"])),
                                device="cpu")
    assert len(sd._ops) == 815
    inp, out = str(golden["input"]), str(golden["output"])
    with torch.no_grad():
        got = sd.output({inp: mf.golden_input(int(golden["seed"]))},
                        [out])[out].numpy()
    np.testing.assert_allclose(got, golden["logits"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.sum(-1, dtype=np.float64),
                               golden["row_sums"], rtol=1e-3, atol=1e-3)
