"""ONNX protobuf wire format: the port's own copy of
``deeplearning4j_tpu/modelimport/onnx/onnx_proto.py`` (the decoder, :1-351)
and a small encoder that empties and refills initializers.

The decoder reads only the message fields the importer needs
(ModelProto/GraphProto/NodeProto/AttributeProto/TensorProto/
ValueInfoProto, field numbers from the public onnx.proto3 schema), with
JAX's rules: the ``TensorProto`` types of :attr:`TensorProto._DTYPES`
(bfloat16 and strings raise :class:`OnnxDecodeError`), ``raw_data`` or
the typed ``*_data`` fields, and no external data (such a tensor holds
no values, so ``to_numpy`` fails to reshape it, as JAX's does).

The encoder (:func:`empty_initializers`, :func:`fill_initializers`,
:func:`seeded_initializers`) rewrites a model's bytes at the wire level:
every field it does not touch is copied byte for byte. The committed
ResNet-50 fixture is a model with its float initializers emptied; the
seeded weights give the whole model back (``tools/make_onnx_fixture.py``).

Wire format refresher: each field is a varint key `(field_num << 3) |
wire_type`; wire types: 0 varint, 1 fixed64, 2 length-delimited,
5 fixed32. Packed repeated scalars arrive as one length-delimited blob.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np


class OnnxDecodeError(ValueError):
    pass


# ------------------------------------------------------------ wire level
def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if i >= len(buf):
            raise OnnxDecodeError("truncated varint")
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise OnnxDecodeError("varint too long")


def _signed(v: int) -> int:
    """Interpret a 64-bit varint as two's-complement int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _pieces(buf: bytes) -> Iterator[Tuple[int, int, Any, int, int]]:
    """Yield (field_number, wire_type, raw_value, start, end): each field
    with its byte span ``[start, end)`` in ``buf``."""
    i = 0
    n = len(buf)
    while i < n:
        start = i
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise OnnxDecodeError(f"unsupported wire type {wt}")
        yield field, wt, v, start, i


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw_value)."""
    for field, wt, v, _start, _end in _pieces(buf):
        yield field, wt, v


def _packed_varints(raw: bytes) -> List[int]:
    out, i = [], 0
    while i < len(raw):
        v, i = _read_varint(raw, i)
        out.append(_signed(v))
    return out


# --------------------------------------------------------- message types
@dataclasses.dataclass
class TensorProto:
    name: str = ""
    dims: List[int] = dataclasses.field(default_factory=list)
    data_type: int = 1
    _raw: bytes = b""
    _float_data: List[float] = dataclasses.field(default_factory=list)
    _int32_data: List[int] = dataclasses.field(default_factory=list)
    _int64_data: List[int] = dataclasses.field(default_factory=list)
    _double_data: List[float] = dataclasses.field(default_factory=list)

    #: onnx TensorProto.DataType -> numpy
    _DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
               5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
               10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}

    def to_numpy(self) -> np.ndarray:
        if self.data_type not in self._DTYPES:
            raise OnnxDecodeError(
                f"tensor {self.name!r}: unsupported data_type "
                f"{self.data_type}")
        dt = self._DTYPES[self.data_type]
        if self._raw:
            arr = np.frombuffer(self._raw, dtype=dt)
        elif self._float_data:
            arr = np.asarray(self._float_data, np.float32).astype(dt)
        elif self._int64_data:
            arr = np.asarray(self._int64_data, np.int64).astype(dt)
        elif self._int32_data:
            arr = np.asarray(self._int32_data, np.int32).astype(dt)
        elif self._double_data:
            arr = np.asarray(self._double_data, np.float64).astype(dt)
        else:
            arr = np.zeros(0, dt)
        return arr.reshape(self.dims) if self.dims else arr.reshape(())


@dataclasses.dataclass
class AttributeProto:
    name: str = ""
    type: int = 0        # 1=FLOAT 2=INT 3=STRING 4=TENSOR 5=GRAPH
    #                      6=FLOATS 7=INTS 8=STRINGS 10=GRAPHS
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorProto] = None
    g: Optional["GraphProto"] = None
    floats: List[float] = dataclasses.field(default_factory=list)
    ints: List[int] = dataclasses.field(default_factory=list)
    strings: List[bytes] = dataclasses.field(default_factory=list)
    graphs: List["GraphProto"] = dataclasses.field(default_factory=list)

    def value(self) -> Any:
        if self.type == 1:
            return self.f
        if self.type == 2:
            return self.i
        if self.type == 3:
            return self.s.decode(errors="replace")
        if self.type == 4:
            return self.t.to_numpy() if self.t is not None else None
        if self.type == 5:
            return self.g
        if self.type == 6:
            return list(self.floats)
        if self.type == 7:
            return list(self.ints)
        if self.type == 8:
            return [s.decode(errors="replace") for s in self.strings]
        if self.type == 10:
            return list(self.graphs)
        return None


@dataclasses.dataclass
class NodeProto:
    name: str = ""
    op_type: str = ""
    domain: str = ""
    input: List[str] = dataclasses.field(default_factory=list)
    output: List[str] = dataclasses.field(default_factory=list)
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ValueInfoProto:
    name: str = ""
    elem_type: int = 1
    shape: List[Optional[int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GraphProto:
    name: str = ""
    nodes: List[NodeProto] = dataclasses.field(default_factory=list)
    initializers: List[TensorProto] = dataclasses.field(default_factory=list)
    inputs: List[ValueInfoProto] = dataclasses.field(default_factory=list)
    outputs: List[ValueInfoProto] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModelProto:
    ir_version: int = 0
    producer_name: str = ""
    opset_version: int = 0
    graph: Optional[GraphProto] = None


# ----------------------------------------------------------- per message
def _decode_tensor(buf: bytes) -> TensorProto:
    t = TensorProto()
    for field, wt, v in _fields(buf):
        if field == 1:
            if wt == 2:
                t.dims.extend(_packed_varints(v))
            else:
                t.dims.append(_signed(v))
        elif field == 2:
            t.data_type = v
        elif field == 4:
            t._float_data.extend(
                struct.unpack(f"<{len(v) // 4}f", v) if wt == 2
                else (struct.unpack("<f", v)[0],))
        elif field == 5:
            t._int32_data.extend(_packed_varints(v) if wt == 2
                                 else [_signed(v)])
        elif field == 7:
            t._int64_data.extend(_packed_varints(v) if wt == 2
                                 else [_signed(v)])
        elif field == 8:
            t.name = v.decode()
        elif field == 9:
            t._raw = v
        elif field == 10:
            t._double_data.extend(
                struct.unpack(f"<{len(v) // 8}d", v) if wt == 2
                else (struct.unpack("<d", v)[0],))
    return t


def _decode_attribute(buf: bytes) -> AttributeProto:
    a = AttributeProto()
    for field, wt, v in _fields(buf):
        if field == 1:
            a.name = v.decode()
        elif field == 2:
            a.f = struct.unpack("<f", v)[0]
        elif field == 3:
            a.i = _signed(v)
        elif field == 4:
            a.s = v
        elif field == 5:
            a.t = _decode_tensor(v)
        elif field == 6:
            a.g = _decode_graph(v)      # sub-graph (If/Loop/Scan)
        elif field == 11:
            a.graphs.append(_decode_graph(v))
        elif field == 7:
            a.floats.extend(struct.unpack(f"<{len(v) // 4}f", v)
                            if wt == 2 else (struct.unpack("<f", v)[0],))
        elif field == 8:
            a.ints.extend(_packed_varints(v) if wt == 2 else [_signed(v)])
        elif field == 9:
            a.strings.append(v)
        elif field == 20:
            a.type = v
    if a.type == 0:
        # producers may omit type; infer from populated field
        if a.ints:
            a.type = 7
        elif a.floats:
            a.type = 6
        elif a.t is not None:
            a.type = 4
        elif a.g is not None:
            a.type = 5
        elif a.graphs:
            a.type = 10
        elif a.s:
            a.type = 3
    return a


def _decode_node(buf: bytes) -> NodeProto:
    n = NodeProto()
    for field, wt, v in _fields(buf):
        if field == 1:
            n.input.append(v.decode())
        elif field == 2:
            n.output.append(v.decode())
        elif field == 3:
            n.name = v.decode()
        elif field == 4:
            n.op_type = v.decode()
        elif field == 5:
            a = _decode_attribute(v)
            n.attributes[a.name] = a.value()
        elif field == 7:
            n.domain = v.decode()
    return n


def _decode_value_info(buf: bytes) -> ValueInfoProto:
    vi = ValueInfoProto()
    for field, wt, v in _fields(buf):
        if field == 1:
            vi.name = v.decode()
        elif field == 2:  # TypeProto
            for f2, _w2, v2 in _fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _w4, v4 in _fields(v3):
                                if f4 == 1:  # Dimension
                                    dim_val: Optional[int] = None
                                    for f5, _w5, v5 in _fields(v4):
                                        if f5 == 1:
                                            dim_val = _signed(v5)
                                    vi.shape.append(dim_val)
    return vi


def _decode_graph(buf: bytes) -> GraphProto:
    g = GraphProto()
    for field, wt, v in _fields(buf):
        if field == 1:
            g.nodes.append(_decode_node(v))
        elif field == 2:
            g.name = v.decode()
        elif field == 5:
            g.initializers.append(_decode_tensor(v))
        elif field == 11:
            g.inputs.append(_decode_value_info(v))
        elif field == 12:
            g.outputs.append(_decode_value_info(v))
    return g


def decode_model(data: bytes) -> ModelProto:
    m = ModelProto()
    for field, wt, v in _fields(data):
        if field == 1:
            m.ir_version = v
        elif field == 2:
            m.producer_name = v.decode()
        elif field == 7:
            m.graph = _decode_graph(v)
        elif field == 8:  # OperatorSetIdProto
            # Only the DEFAULT domain ("" / "ai.onnx") versions the core
            # op set; custom-domain entries (com.microsoft, ...) carry
            # unrelated version numbers and must not bump it.
            dom, ver = "", None
            for f2, _w2, v2 in _fields(v):
                if f2 == 1:
                    dom = v2.decode()
                elif f2 == 2:
                    ver = _signed(v2)
            if ver is not None and dom in ("", "ai.onnx"):
                m.opset_version = max(m.opset_version, ver)
    if m.graph is None:
        raise OnnxDecodeError("no GraphProto in model (not an ONNX file?)")
    return m


# ---------------------------------------------------------------- encoder
#: the float ``TensorProto`` types an initializer is emptied and seeded in
FLOAT_TYPES = {1: np.float32, 10: np.float16, 11: np.float64}
#: a TensorProto's value fields: float_data, int32_data, raw_data,
#: double_data (a float16 tensor keeps its values in int32_data)
_VALUE_FIELDS = (4, 5, 9, 10)


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _rewrite_initializers(data: bytes, fn) -> bytes:
    """``data`` (a serialized ModelProto) with each top-level initializer
    replaced by ``fn(its TensorProto bytes)`` where that is not None;
    every other byte is copied."""
    out = []
    for field, wt, v, a, b in _pieces(data):
        if field != 7 or wt != 2:
            out.append(data[a:b])
            continue
        graph = []
        for f2, w2, v2, a2, b2 in _pieces(v):
            new = fn(bytes(v2)) if f2 == 5 and w2 == 2 else None
            graph.append(v[a2:b2] if new is None else _ld(5, new))
        out.append(_ld(7, b"".join(graph)))
    return b"".join(bytes(p) for p in out)


def _without_values(buf: bytes) -> bytes:
    return b"".join(bytes(buf[a:b]) for f, _w, _v, a, b in _pieces(buf)
                    if f not in _VALUE_FIELDS)


def _holds_values(t: TensorProto) -> bool:
    return bool(t._raw or t._float_data or t._int32_data or t._int64_data
                or t._double_data)


def empty_initializers(data: bytes) -> bytes:
    """``data`` with the values of every float initializer removed (its
    name, dims and type stay): the committed fixture's form."""
    def empty(buf):
        t = _decode_tensor(buf)
        return _without_values(buf) if t.data_type in FLOAT_TYPES else None

    return _rewrite_initializers(data, empty)


def emptied_initializers(model: Union[bytes, ModelProto]
                         ) -> List[TensorProto]:
    """The float initializers of a model that hold no values and have at
    least one element, by name."""
    m = model if isinstance(model, ModelProto) else decode_model(model)
    out = [t for t in m.graph.initializers
           if t.data_type in FLOAT_TYPES and not _holds_values(t)
           and int(np.prod(t.dims, dtype=np.int64)) > 0]
    return sorted(out, key=lambda t: t.name)


def seeded_initializers(model: Union[bytes, ModelProto],
                        seed: int) -> Dict[str, np.ndarray]:
    """Weights for every emptied initializer (:func:`emptied_initializers`),
    by name, each of its own shape and type. One numpy
    ``default_rng(seed)`` draws them in name order, each draw in the
    shape's row-major order, by this rule:

    - rank >= 2: normal x sqrt(2 / fan_in), fan_in the product of all
      dims but the first (He's draw for OIHW convolutions and torch's
      ``[out, in]`` linear weights);
    - a name ending in ``running_mean``: U(-0.2, 0.2);
    - ``running_var``: U(0.6, 1.4);
    - any other rank-1 ``weight`` (a batch norm's scale): U(0.8, 1.2);
    - the rest (biases): U(-0.1, 0.1).
    """
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for t in emptied_initializers(model):
        shape = tuple(int(d) for d in t.dims)
        size = int(np.prod(shape, dtype=np.int64))
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[1:], dtype=np.int64))
            v = rng.standard_normal(size, dtype=np.float32) * \
                np.float32(math.sqrt(2.0 / fan_in))
        elif t.name.endswith("running_mean"):
            v = rng.uniform(-0.2, 0.2, size)
        elif t.name.endswith("running_var"):
            v = rng.uniform(0.6, 1.4, size)
        elif t.name.endswith("weight"):
            v = rng.uniform(0.8, 1.2, size)
        else:
            v = rng.uniform(-0.1, 0.1, size)
        out[t.name] = np.asarray(v, FLOAT_TYPES[t.data_type]).reshape(shape)
    return out


def fill_initializers(data: bytes, arrays: Dict[str, np.ndarray]) -> bytes:
    """``data`` with each initializer named in ``arrays`` holding that
    array as ``raw_data`` (little-endian, in the initializer's own type;
    the array must have its dims)."""
    left = set(arrays)

    def fill(buf):
        t = _decode_tensor(buf)
        if t.name not in arrays:
            return None
        a = np.asarray(arrays[t.name])
        if tuple(a.shape) != tuple(t.dims):
            raise OnnxDecodeError(
                f"initializer {t.name!r}: array of shape {a.shape} for dims "
                f"{t.dims}")
        dt = np.dtype(TensorProto._DTYPES[t.data_type]).newbyteorder("<")
        left.discard(t.name)
        return _without_values(buf) + _ld(9, a.astype(dt).tobytes())

    out = _rewrite_initializers(data, fill)
    if left:
        raise OnnxDecodeError(f"no initializers named {sorted(left)}")
    return out


def seeded_model(data: bytes, seed: int) -> bytes:
    """The whole model: ``data`` with its emptied initializers filled by
    :func:`seeded_initializers`."""
    return fill_initializers(data, seeded_initializers(data, seed))


__all__ = ["decode_model", "ModelProto", "GraphProto", "NodeProto",
           "TensorProto", "AttributeProto", "ValueInfoProto",
           "OnnxDecodeError", "FLOAT_TYPES", "empty_initializers",
           "emptied_initializers", "seeded_initializers",
           "fill_initializers", "seeded_model"]
