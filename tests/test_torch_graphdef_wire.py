"""PyTorch port, the GraphDef wire decoder and encoder
(``modelimport/tensorflow/graphdef_wire.py``) against TF's own protobuf
parser, and the TF mapper battery and mapper coverage on the graphs it
decodes (one file: each file that holds TF pays ~18 s to import it).

- Every GraphDef of the TF batteries (``tests/torch_tf_cases.py``: the
  mapper and golden batteries, both control-flow forms with their
  function libraries, the v1 session graphs): node names, ops, inputs,
  devices and every attribute equal TF's parse, field by field, and every
  tensor's value equals ``tensor_util.MakeNdarray``'s.
- Tensors by hand: float16 and bfloat16 (``half_val`` and content),
  splats, edge-padded partial values, empty and all-zero tensors,
  strings, negative int64s, bool, uint8, double and complex values.
- Wire forms: unpacked repeated scalars, negative varints, unknown fields
  skipped.
- The encoder: ``encode_node`` / ``encode_tensor`` round-trip through TF's
  parser; ``seeded_consts`` fills exactly the emptied float constants,
  in name order, and copies the rest byte for byte.
- The output-argument table equals TF's OpDefs for every op in it, and
  holds every op a mapper handles.
- The committed BERT-base fixture decodes the same by both parsers, and
  seeding it gives back the whole graph's byte count that TF ran.
- The mapper battery (``tests/test_tf_mapper_battery.py``: one graph per
  mapper, the plain If / Case / StatelessCase, PartitionedCall /
  StatefulPartitionedCall and the TensorArrayV3 loop) goes, as the same
  GraphDef bytes, through JAX's ``TFGraphMapper`` and the port's on the
  CPU: outputs within rtol 1e-4 / atol 1e-5 of TF's and 1e-5 / 1e-6 of
  JAX's, dtypes equal JAX's.
- Coverage: the port's mapper registry equals JAX's
  ``OpMappingRegistry.coverage()`` (201 names) and its walker ops JAX's
  13; every one is driven by imports in this process (the port's
  ``modelimport.trace``): the battery's, and the port's imports of
  ``tests/test_torch_tf_import.py``'s graphs, made by the coverage test
  itself. JAX's own ``Ref*`` aliases are the exceptions, for the reason
  ``tests/test_zzz_mapper_execution_gate.py`` gives.
"""

import gzip
import struct

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import torch_tf_cases as tc  # noqa: E402

from tensorflow.core.framework import (  # noqa: E402
    attr_value_pb2, graph_pb2, node_def_pb2, tensor_pb2,
)
from tensorflow.python.framework import tensor_util  # noqa: E402

from deeplearning4j_tpu_torch.modelimport import trace  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    OpMappingRegistry, cf_import, graphdef_wire as gw,
)


def _same_value(tp, pt):
    """TF's and the port's decode of one TensorProto."""
    want = tensor_util.MakeNdarray(tp)
    got = gw.make_ndarray(pt)
    if tp.dtype == tf.bfloat16.as_datatype_enum:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
            np.uint16), want.view(np.uint16))
        return
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype == object:
        assert got.tolist() == want.tolist()
    else:
        np.testing.assert_array_equal(got, want)


def _same_shape(sp, ps):
    assert ps.dims == [d.size for d in sp.dim]
    assert ps.unknown_rank == sp.unknown_rank


def _same_attr(av, pa):
    field = av.WhichOneof("value")
    assert pa.which == field, (pa.which, field)
    if field in ("s", "i", "b", "type", "placeholder"):
        assert getattr(pa, field) == getattr(av, field), field
    elif field == "f":
        assert struct.pack("<f", pa.f) == struct.pack("<f", av.f)
    elif field == "shape":
        _same_shape(av.shape, pa.shape)
    elif field == "tensor":
        _same_value(av.tensor, pa.tensor)
    elif field == "func":
        _same_func(av.func, pa.func)
    elif field == "list":
        lv, pl = av.list, pa.list
        assert pl.s == list(lv.s) and pl.i == list(lv.i)
        assert pl.b == list(lv.b) and pl.type == list(lv.type)
        assert [struct.pack("<f", x) for x in pl.f] == \
            [struct.pack("<f", x) for x in lv.f]
        assert len(pl.shape) == len(lv.shape)
        for a, b in zip(lv.shape, pl.shape):
            _same_shape(a, b)
        assert len(pl.tensor) == len(lv.tensor)
        for a, b in zip(lv.tensor, pl.tensor):
            _same_value(a, b)
        assert len(pl.func) == len(lv.func)
        for a, b in zip(lv.func, pl.func):
            _same_func(a, b)


def _same_func(fa, pf):
    assert pf.name == fa.name and set(pf.attr) == set(fa.attr)
    for k in fa.attr:
        _same_attr(fa.attr[k], pf.attr[k])


def _same_node(nd, pn):
    assert (pn.name, pn.op, pn.input, pn.device) == \
        (nd.name, nd.op, list(nd.input), nd.device)
    assert set(pn.attr) == set(nd.attr), nd.name
    for k in nd.attr:
        _same_attr(nd.attr[k], pn.attr[k])


def _same_graph(gd, pg):
    assert len(pg.node) == len(gd.node)
    for nd, pn in zip(gd.node, pg.node):
        _same_node(nd, pn)
    assert len(pg.library.function) == len(gd.library.function)
    for fd, pf in zip(gd.library.function, pg.library.function):
        sig, ps = fd.signature, pf.signature
        assert ps.name == sig.name
        for args, pargs in ((sig.input_arg, ps.input_arg),
                            (sig.output_arg, ps.output_arg)):
            assert [(a.name, a.type, a.type_attr, a.number_attr,
                     a.type_list_attr) for a in args] == \
                [(a.name, a.type, a.type_attr, a.number_attr,
                  a.type_list_attr) for a in pargs]
        assert pf.ret == dict(fd.ret)
        assert len(pf.node_def) == len(fd.node_def)
        for nd, pn in zip(fd.node_def, pf.node_def):
            _same_node(nd, pn)


@pytest.mark.parametrize("name", tc.NAMES)
def test_battery_graph_decodes_as_tf_parses_it(name):
    data, gd, *_ = tc.case(name)
    _same_graph(gd, gw.parse_graph_def(data))


def _tensor_graph():
    """A GraphDef of Const nodes holding the awkward tensors."""
    gd = graph_pb2.GraphDef()

    def const(name, proto):
        n = gd.node.add()
        n.name, n.op = name, "Const"
        n.attr["value"].tensor.CopyFrom(proto)
        n.attr["dtype"].type = proto.dtype

    mk = tf.make_tensor_proto
    rng = np.random.default_rng(0)
    f = rng.normal(size=(3, 4)).astype(np.float32)
    const("f16_content", mk(f.astype(np.float16)))
    const("bf16_content", mk(tf.constant(f, tf.bfloat16).numpy()))
    h = tensor_pb2.TensorProto(dtype=tf.float16.as_datatype_enum)
    h.tensor_shape.dim.add().size = 5
    h.half_val.extend(np.asarray([1.5, -2.25], np.float16).view(
        np.uint16).tolist())
    const("f16_half_val_padded", h)
    b = tensor_pb2.TensorProto(dtype=tf.bfloat16.as_datatype_enum)
    b.tensor_shape.dim.add().size = 3
    b.half_val.append(0x3FC0)                      # 1.5
    const("bf16_half_val_splat", b)
    const("f32_splat", mk(1.5, tf.float32, shape=[3, 4]))
    const("i64_negative", mk(np.asarray([-1, -2 ** 40, 7], np.int64)))
    const("i32_splat", mk(np.int32(-3), shape=[2, 2]))
    z = tensor_pb2.TensorProto(dtype=tf.float32.as_datatype_enum)
    for s in (2, 3):
        z.tensor_shape.dim.add().size = s
    const("f32_no_values", z)
    const("f32_empty", mk(np.zeros((2, 0), np.float32)))
    const("strings", mk(np.asarray([b"ab", b"", b"\xff\x00"], object)))
    const("string_splat", mk(b"x", shape=[3]))
    const("bool", mk(np.asarray([[True, False]])))
    const("uint8", mk(np.asarray([0, 255, 7], np.uint8)))
    const("double", mk(np.asarray([1e-300, -2.5], np.float64)))
    const("complex64", mk(np.asarray([1 + 2j, -3j], np.complex64)))
    const("scalar", mk(np.float32(2.5)))
    v = tensor_pb2.TensorProto(dtype=tf.float32.as_datatype_enum)
    v.tensor_shape.dim.add().size = 4
    v.float_val.extend([1.0, 2.0])                 # edge-padded
    const("f32_partial", v)
    return gd


def test_awkward_tensors_decode_as_make_ndarray():
    gd = _tensor_graph()
    pg = gw.parse_graph_def(gd.SerializeToString())
    for nd, pn in zip(gd.node, pg.node):
        _same_value(nd.attr["value"].tensor, pn.attr["value"].tensor)
    got = {n.name: gw.make_ndarray(n.attr["value"].tensor) for n in pg.node}
    np.testing.assert_array_equal(got["f16_half_val_padded"], np.asarray(
        [1.5, -2.25, -2.25, -2.25, -2.25], np.float16))
    assert got["bf16_half_val_splat"].float().tolist() == [1.5] * 3
    assert got["f32_no_values"].tolist() == [[0.0] * 3] * 2
    assert got["i64_negative"].tolist() == [-1, -2 ** 40, 7]


def test_attr_forms_decode_as_tf_parses_them():
    """Every AttrValue field, negative ints, packed lists, shapes with
    unknown dims and an unknown rank, a function reference with
    attributes."""
    nd = node_def_pb2.NodeDef(name="n", op="Foo", input=["a:1", "^b"],
                              device="/cpu:0")
    nd.attr["s"].s = b"\xff text"
    nd.attr["i"].i = -5
    nd.attr["f"].f = 0.1
    nd.attr["b"].b = True
    nd.attr["type"].type = tf.bfloat16.as_datatype_enum
    nd.attr["shape"].shape.dim.add().size = -1
    nd.attr["shape"].shape.dim.add().size = 7
    nd.attr["rankless"].shape.unknown_rank = True
    nd.attr["ints"].list.i.extend([-1, 0, 2 ** 40])
    nd.attr["floats"].list.f.extend([0.5, -1e-30])
    nd.attr["strs"].list.s.extend([b"a", b""])
    nd.attr["bools"].list.b.extend([True, False])
    nd.attr["types"].list.type.extend([1, 3, 14])
    nd.attr["shapes"].list.shape.add().dim.add().size = 3
    nd.attr["empty_list"].list.SetInParent()
    nd.attr["func"].func.name = "f_body"
    nd.attr["func"].func.attr["T"].type = 1
    nd.attr["funcs"].list.func.add().name = "g"
    nd.attr["placeholder"].placeholder = "T"
    nd.attr["tensor"].tensor.CopyFrom(tf.make_tensor_proto([1, 2]))
    pn = gw.NodeDef.parse(memoryview(nd.SerializeToString()), 0,
                          nd.ByteSize())
    _same_node(nd, pn)


def _varint(v):
    return gw._enc_varint(v)


def test_unpacked_repeated_fields_and_unknown_fields():
    """A ListValue with its ints, floats and types unpacked (one field a
    value, as older writers emit them) and a field the decoder does not
    know: TF's parser and the port's agree."""
    lv = b""
    for v in (-3, 4):
        lv += _varint((3 << 3) | 0) + _varint(v)          # list.i
    for v in (1.5, -2.0):
        lv += _varint((4 << 3) | 5) + struct.pack("<f", v)  # list.f
    lv += _varint((6 << 3) | 0) + _varint(9)               # list.type
    av = gw._enc_len(1, lv) + _varint((99 << 3) | 0) + _varint(1)
    node = gw.encode_node("n", "Foo", ["x"], {"l": av})
    want = node_def_pb2.NodeDef()
    want.ParseFromString(node)
    got = gw.NodeDef.parse(memoryview(node), 0, len(node))
    assert list(want.attr["l"].list.i) == got.attr["l"].list.i == [-3, 4]
    assert got.attr["l"].list.f == [1.5, -2.0] and got.attr["l"].list.type \
        == [9]
    _same_node(want, got)


def test_encoder_round_trips_through_tf():
    t = gw.encode_tensor(1, [2, 3], np.arange(6, dtype=np.float32)
                         .tobytes())
    tp = tensor_pb2.TensorProto()
    tp.ParseFromString(t)
    np.testing.assert_array_equal(tensor_util.MakeNdarray(tp),
                                  np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))
    av = attr_value_pb2.AttrValue(i=-7).SerializeToString()
    raw = gw.encode_node("a/b", "Const", ["x", "y:2", "^z"],
                         {"value": gw.encode_attr_tensor(t), "k": av},
                         device="/cpu:0")
    nd = node_def_pb2.NodeDef()
    nd.ParseFromString(raw)
    assert (nd.name, nd.op, list(nd.input), nd.device) == \
        ("a/b", "Const", ["x", "y:2", "^z"], "/cpu:0")
    assert nd.attr["k"].i == -7
    _same_node(nd, gw.NodeDef.parse(memoryview(raw), 0, len(raw)))


def test_seeded_consts_fills_the_emptied_constants_only():
    gd = graph_pb2.GraphDef()
    for name, shape, empty in (("w_b", (3, 5), True), ("w_a", (4,), True),
                               ("keep", (2, 2), False)):
        n = gd.node.add()
        n.name, n.op = name, "Const"
        proto = tf.make_tensor_proto(np.ones(shape, np.float32))
        if empty:
            proto.ClearField("tensor_content")
            proto.ClearField("float_val")
        n.attr["value"].tensor.CopyFrom(proto)
        n.attr["dtype"].type = 1
    ph = gd.node.add()
    ph.name, ph.op = "x", "Placeholder"
    ph.attr["dtype"].type = 1
    small = gd.SerializeToString()
    full = gw.seeded_consts(small, 5)
    back = graph_pb2.GraphDef()
    back.ParseFromString(full)
    rng = np.random.default_rng(5)
    want_a = rng.standard_normal(4, dtype=np.float32) * np.float32(0.02)
    want_b = rng.standard_normal(15, dtype=np.float32) * np.float32(0.02)
    vals = {n.name: tensor_util.MakeNdarray(n.attr["value"].tensor)
            for n in back.node if n.op == "Const"}
    np.testing.assert_array_equal(vals["w_a"], want_a)
    np.testing.assert_array_equal(vals["w_b"], want_b.reshape(3, 5))
    np.testing.assert_array_equal(vals["keep"], np.ones((2, 2), np.float32))
    assert [n.name for n in back.node] == [n.name for n in gd.node]
    # the untouched nodes' bytes are copied verbatim; a re-serialization
    # of the parsed node may order its attr map differently
    for a, b in zip(gd.node[2:], back.node[2:]):
        assert a == b
        raw = a.SerializeToString()
        assert raw in small and raw in full
    assert [n.name for n in gw.seeded_nodes(gw.parse_graph_def(small))] \
        == ["w_a", "w_b"]


def test_output_arg_table_is_tfs_op_defs():
    from tensorflow.python.framework import op_def_registry

    for op, spec in gw.OUTPUT_ARGS.items():
        od = op_def_registry.get(op)
        want = " ".join(
            f"{a.name}*{a.number_attr}" if a.number_attr else
            f"{a.name}+{a.type_list_attr}" if a.type_list_attr else a.name
            for a in od.output_arg)
        assert spec == want, op
    handled = set(OpMappingRegistry.coverage()) | set(cf_import.WALKER_OPS)
    assert handled <= set(gw.OUTPUT_ARGS)
    n = gw.NodeDef("s", "Unpack")
    n.attr["num"] = gw.AttrValue()
    n.attr["num"].i = 3
    assert gw.output_arg_offset(n, "output") == 0
    fb = gw.NodeDef("f", "FusedBatchNormV3")
    assert gw.output_arg_offset(fb, "reserve_space_3") == 5


def test_committed_fixture_decodes_as_tf_parses_it():
    from deeplearning4j_tpu_torch.tools import make_tf_fixture as mf

    with gzip.open(mf.FIXTURE, "rb") as f:
        small = f.read()
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(small)
    pg = gw.parse_graph_def(small)
    _same_graph(gd, pg)
    _, golden = mf.load_fixture()
    assert len(pg.node) == int(golden["nodes"]) == 3053
    seeded = gw.seeded_nodes(pg)
    assert len(seeded) == 89
    full = gw.seeded_consts(pg, int(golden["seed"]))
    assert len(full) == int(golden["whole_bytes"])
    whole = gw.parse_graph_def(full)
    assert [n.name for n in whole.node] == [n.name for n in pg.node]
    assert not gw.seeded_nodes(whole)
    first = next(n for n in whole.node if n.name == seeded[0].name)
    rng = np.random.default_rng(int(golden["seed"]))
    t = first.attr["value"].tensor
    np.testing.assert_array_equal(
        gw.make_ndarray(t).reshape(-1),
        rng.standard_normal(t.num_elements, dtype=np.float32)
        * np.float32(0.02))


# ------------------------------------------------------- the mapper battery
@pytest.mark.parametrize("name", tc.BATTERY_NAMES)
def test_mapper_matches_tf_and_jax(name):
    tc.check(name)


_REF_REASON = (
    "TF1 ref-dtype variant: an alias of the non-Ref op in every dispatch "
    "table, driven through the non-Ref name; modern TF cannot emit Ref* "
    "nodes (tests/test_zzz_mapper_execution_gate.py)")
EXEMPT = {f"tf:{n}": _REF_REASON for n in (
    "RefEnter", "RefExit", "RefMerge", "RefNextIteration", "RefSwitch")}


def test_zzz_mapper_coverage_equals_jax_and_is_driven():
    """The port's TF mappers are JAX's 201 names and its 13 walker ops,
    and this file's imports drove every one of them (run last in the
    file; the imports of any test not yet run are made here)."""
    from deeplearning4j_tpu.modelimport.tensorflow import (
        OpMappingRegistry as JaxRegistry, cf_import as jcf,
    )

    assert OpMappingRegistry.coverage() == JaxRegistry.coverage()
    assert len(OpMappingRegistry.coverage()) == 201
    assert sorted(cf_import.WALKER_OPS) == sorted(jcf.WALKER_OPS)
    for name in tc.NAMES:
        tc.port(name)
    registered = {f"tf:{n}" for n in OpMappingRegistry.coverage()} | \
        {f"tf:{n}" for n in cf_import.WALKER_OPS}
    missing = sorted(registered - trace.driven_mappers() - set(EXEMPT))
    assert not missing, missing
    assert not set(EXEMPT) & trace.driven_mappers()
