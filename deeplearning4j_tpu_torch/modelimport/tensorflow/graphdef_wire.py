"""A hand decoder (and a small encoder) of TensorFlow's GraphDef protobuf
wire format, so that the importer needs neither ``tensorflow`` nor
``google.protobuf``.

It replaces what the JAX package's importer takes from ``tensorflow``:
``graph_pb2`` (``tf_import.py:1414-1432``), ``tensor_util.MakeNdarray``
(``:1253-1255``, here :func:`make_ndarray`), ``node_def_pb2``
(``cf_import.py:441``, here :meth:`NodeDef.copy`) and ``op_def_registry``
(``cf_import.py:415-435``, here the table :data:`OUTPUT_ARGS` of the
output arguments of the ops the importer meets; an op missing from it
raises :class:`TFImportError`, as JAX's importer does where TF has no
OpDef). The messages read are the ones the importer touches:
``GraphDef``, ``NodeDef``, ``AttrValue`` with its ``ListValue`` and
``NameAttrList``, ``TensorProto``, ``TensorShapeProto``,
``FunctionDefLibrary``, ``FunctionDef`` and ``OpDef`` with its
``ArgDef``; other fields are skipped (and kept as bytes where a node is
written back).

Wire rules followed: repeated scalars packed or not, negative ``int64``
/ ``int32`` varints (ten bytes, two's complement), ``float`` as fixed32,
``half_val`` carrying float16 and bfloat16 as 16-bit patterns in
``int32``s. Tensor bytes stay views of the input (no copy until
:func:`make_ndarray`), so a 440 MB graph parses in about a second.

The encoder writes ``TensorProto.tensor_content`` and ``NodeDef``:
:func:`seeded_consts` splices seeded weights into a GraphDef whose large
constants were emptied (the committed BERT-base fixture), giving back
the whole graph's bytes.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


class TFImportError(ValueError):
    """A graph the importer cannot map (an unknown op, a dynamic shape it
    cannot fold, a malformed GraphDef)."""


#: TF ``DataType`` enum -> numpy dtype; bfloat16 (14) decodes to a torch
#: tensor (numpy has no such type)
_NP_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: np.object_, 9: np.int64, 10: np.bool_, 17: np.uint16,
    19: np.float16, 22: np.uint32, 23: np.uint64, 8: np.complex64,
    18: np.complex128,
}
DT_FLOAT, DT_DOUBLE, DT_BFLOAT16, DT_HALF, DT_STRING = 1, 2, 14, 19, 7


# ------------------------------------------------------------ wire reading
def _varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _signed(v: int) -> int:
    """A varint's two's-complement value (negative ints take ten bytes)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf, start: int = 0, end: Optional[int] = None
            ) -> Iterator[Tuple[int, int, object, int, int]]:
    """``(field number, wire type, value, field start, field end)`` for
    each field of the message in ``buf[start:end]``: the value is an int
    (varint, fixed), or a ``(start, end)`` span (length-delimited)."""
    pos = start
    end = len(buf) if end is None else end
    while pos < end:
        fstart = pos
        key, pos = _varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _varint(buf, pos)
        elif wt == 2:
            ln, pos = _varint(buf, pos)
            val = (pos, pos + ln)
            pos += ln
        elif wt == 5:
            val = (pos, pos + 4)
            pos += 4
        elif wt == 1:
            val = (pos, pos + 8)
            pos += 8
        else:
            raise TFImportError(f"unsupported protobuf wire type {wt}")
        yield num, wt, val, fstart, pos
    if pos != end:
        raise TFImportError("truncated protobuf message")


def _str(buf, span) -> str:
    return bytes(buf[span[0]:span[1]]).decode("utf-8", errors="replace")


def _ints(buf, wt: int, val, signed: bool = True) -> List[int]:
    """A repeated varint field's entries from one occurrence, packed or
    not."""
    if wt == 0:
        return [_signed(val) if signed else val]
    out = []
    pos, end = val
    while pos < end:
        v, pos = _varint(buf, pos)
        out.append(_signed(v) if signed else v)
    return out


def _floats(buf, wt: int, val, fmt: str) -> List[float]:
    """A repeated float/double field's entries, packed or not."""
    s, e = val
    return np.frombuffer(bytes(buf[s:e]), dtype=fmt).tolist() \
        if wt == 2 else [struct.unpack({"<f4": "<f", "<f8": "<d"}[fmt],
                                       bytes(buf[s:e]))[0]]


# ---------------------------------------------------------------- messages
class TensorShape:
    """``TensorShapeProto``: ``dims`` (``-1`` unknown), ``unknown_rank``."""

    __slots__ = ("dims", "unknown_rank")

    def __init__(self, dims=(), unknown_rank=False):
        self.dims = list(dims)
        self.unknown_rank = unknown_rank

    @staticmethod
    def parse(buf, start: int, end: int) -> "TensorShape":
        shp = TensorShape()
        for num, wt, val, _, _ in _fields(buf, start, end):
            if num == 2:
                size = 0
                for n2, _, v2, _, _ in _fields(buf, *val):
                    if n2 == 1:
                        size = _signed(v2)
                shp.dims.append(size)
            elif num == 3:
                shp.unknown_rank = bool(val)
        return shp


class Tensor:
    """``TensorProto``: ``dtype`` (the enum), ``shape`` (a
    :class:`TensorShape`), ``content`` (``tensor_content``, a view) and
    the repeated ``*_val`` fields by field number in ``vals``."""

    __slots__ = ("dtype", "shape", "content", "vals")

    def __init__(self):
        self.dtype = 0
        self.shape = TensorShape()
        self.content = b""
        self.vals: Dict[int, list] = {}

    @staticmethod
    def parse(buf, start: int, end: int) -> "Tensor":
        t = Tensor()
        for num, wt, val, _, _ in _fields(buf, start, end):
            if num == 1:
                t.dtype = val
            elif num == 2:
                t.shape = TensorShape.parse(buf, *val)
            elif num == 4:
                t.content = buf[val[0]:val[1]]
            elif num == 5 or num == 9:
                t.vals.setdefault(num, []).extend(
                    _floats(buf, wt, val, "<f4"))
            elif num == 6 or num == 12:
                t.vals.setdefault(num, []).extend(
                    _floats(buf, wt, val, "<f8"))
            elif num == 8:
                t.vals.setdefault(8, []).append(bytes(buf[val[0]:val[1]]))
            elif num in (7, 10, 11, 13, 16, 17):
                t.vals.setdefault(num, []).extend(
                    _ints(buf, wt, val, signed=num not in (16, 17)))
        return t

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.shape.dims, dtype=np.int64))

    def has_values(self) -> bool:
        return len(self.content) > 0 or any(len(v) for v in
                                              self.vals.values())


def _np_dtype(enum: int):
    if enum not in _NP_DTYPES and enum != DT_BFLOAT16:
        raise TFImportError(f"tensor of unsupported TF DataType {enum}")
    return _NP_DTYPES.get(enum)


def make_ndarray(t: Tensor):
    """The value of a ``TensorProto``, as ``tensor_util.MakeNdarray``
    gives it: ``tensor_content`` read as the dtype; else the dtype's
    ``*_val`` field, its last entry repeated to the element count (a
    single entry is a splat), zeros where there is none; string tensors
    as an object array of bytes. A bfloat16 tensor comes back as a CPU
    ``torch.bfloat16`` tensor (numpy has no bfloat16)."""
    shape = tuple(t.shape.dims)
    n = t.num_elements
    if t.dtype == DT_BFLOAT16:
        if len(t.content):
            bits = np.frombuffer(bytes(t.content), np.uint16).copy()
        else:
            bits = np.asarray(t.vals.get(13, []), np.int64).astype(np.uint16)
            bits = _fill(bits, n, np.uint16)
        return torch.from_numpy(bits.view(np.int16).reshape(shape)).view(
            torch.bfloat16)
    dt = _np_dtype(t.dtype)
    if dt is np.object_:
        vals = list(t.vals.get(8, []))
        if len(vals) < n:
            vals += [vals[-1] if vals else b""] * (n - len(vals))
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out.reshape(shape)
    if len(t.content):
        return np.frombuffer(bytes(t.content), dtype=dt).copy().reshape(
            shape)
    if t.dtype == DT_HALF:
        vals = np.asarray(t.vals.get(13, []), np.int64).astype(
            np.uint16).view(np.float16)
    elif dt in (np.float32,):
        vals = np.asarray(t.vals.get(5, []), dt)
    elif dt in (np.float64,):
        vals = np.asarray(t.vals.get(6, []), dt)
    elif dt in (np.int32, np.uint8, np.int16, np.int8, np.uint16):
        vals = np.asarray(t.vals.get(7, []), np.int64).astype(dt)
    elif dt is np.int64:
        vals = np.asarray(t.vals.get(10, []), np.int64)
    elif dt is np.uint32:
        vals = np.asarray(t.vals.get(16, []), np.uint32)
    elif dt is np.uint64:
        vals = np.asarray(t.vals.get(17, []), np.uint64)
    elif dt is np.bool_:
        vals = np.asarray(t.vals.get(11, []), np.bool_)
    elif dt is np.complex64:
        f = np.asarray(t.vals.get(9, []), np.float32)
        vals = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    else:
        f = np.asarray(t.vals.get(12, []), np.float64)
        vals = (f[0::2] + 1j * f[1::2]).astype(np.complex128)
    return _fill(vals, n, dt).reshape(shape)


def _fill(vals: np.ndarray, n: int, dt) -> np.ndarray:
    if vals.size == 0:
        return np.zeros(n, dt)
    if vals.size != n:
        vals = np.pad(vals, (0, n - vals.size), "edge")
    return vals


class NameAttrList:
    """``NameAttrList`` (a function reference): ``name`` and ``attr``."""

    __slots__ = ("name", "attr")

    def __init__(self, name: str = "", attr=None):
        self.name = name
        self.attr = attr or {}

    @staticmethod
    def parse(buf, start: int, end: int) -> "NameAttrList":
        out = NameAttrList()
        for num, _, val, _, _ in _fields(buf, start, end):
            if num == 1:
                out.name = _str(buf, val)
            elif num == 2:
                k, v = _map_entry(buf, val)
                out.attr[k] = v
        return out


class ListValue:
    """``AttrValue.ListValue``: each repeated field as a list."""

    __slots__ = ("s", "i", "f", "b", "type", "shape", "tensor", "func")

    def __init__(self):
        self.s, self.i, self.f, self.b = [], [], [], []
        self.type, self.shape, self.tensor, self.func = [], [], [], []

    @staticmethod
    def parse(buf, start: int, end: int) -> "ListValue":
        lv = ListValue()
        for num, wt, val, _, _ in _fields(buf, start, end):
            if num == 2:
                lv.s.append(bytes(buf[val[0]:val[1]]))
            elif num == 3:
                lv.i.extend(_ints(buf, wt, val))
            elif num == 4:
                lv.f.extend(_floats(buf, wt, val, "<f4"))
            elif num == 5:
                lv.b.extend(bool(x) for x in _ints(buf, wt, val))
            elif num == 6:
                lv.type.extend(_ints(buf, wt, val))
            elif num == 7:
                lv.shape.append(TensorShape.parse(buf, *val))
            elif num == 8:
                lv.tensor.append(Tensor.parse(buf, *val))
            elif num == 9:
                lv.func.append(NameAttrList.parse(buf, *val))
        return lv


class AttrValue:
    """``AttrValue``: ``which`` names the field set (``"list"``, ``"s"``,
    ``"i"``, ``"f"``, ``"b"``, ``"type"``, ``"shape"``, ``"tensor"``,
    ``"placeholder"``, ``"func"``, or None); every field reads its
    default when unset, as protobuf's do. ``raw`` is the message's
    bytes."""

    __slots__ = ("which", "s", "i", "f", "b", "type", "shape", "tensor",
                 "list", "func", "placeholder", "raw")

    _NAMES = {1: "list", 2: "s", 3: "i", 4: "f", 5: "b", 6: "type",
              7: "shape", 8: "tensor", 9: "placeholder", 10: "func"}

    def __init__(self):
        self.which = None
        self.s, self.i, self.f, self.b, self.type = b"", 0, 0.0, False, 0
        self.shape, self.tensor = TensorShape(), None
        self.list, self.func, self.placeholder = ListValue(), \
            NameAttrList(), ""
        self.raw = b""

    @staticmethod
    def parse(buf, start: int, end: int) -> "AttrValue":
        av = AttrValue()
        av.raw = buf[start:end]
        for num, wt, val, _, _ in _fields(buf, start, end):
            av.which = AttrValue._NAMES.get(num, av.which)
            if num == 1:
                av.list = ListValue.parse(buf, *val)
            elif num == 2:
                av.s = bytes(buf[val[0]:val[1]])
            elif num == 3:
                av.i = _signed(val)
            elif num == 4:
                av.f = struct.unpack("<f", bytes(buf[val[0]:val[1]]))[0]
            elif num == 5:
                av.b = bool(val)
            elif num == 6:
                av.type = val
            elif num == 7:
                av.shape = TensorShape.parse(buf, *val)
            elif num == 8:
                av.tensor = Tensor.parse(buf, *val)
            elif num == 9:
                av.placeholder = _str(buf, val)
            elif num == 10:
                av.func = NameAttrList.parse(buf, *val)
        return av


def _map_entry(buf, span) -> Tuple[str, AttrValue]:
    key, value = "", AttrValue()
    for num, _, val, _, _ in _fields(buf, *span):
        if num == 1:
            key = _str(buf, val)
        elif num == 2:
            value = AttrValue.parse(buf, *val)
    return key, value


class NodeDef:
    """``NodeDef``: ``name``, ``op``, ``input`` (a list; control inputs
    start with ``^``), ``device``, ``attr`` (name -> :class:`AttrValue`);
    ``extra`` holds the bytes of any other field."""

    __slots__ = ("name", "op", "input", "device", "attr", "extra")

    def __init__(self, name: str = "", op: str = "", inputs=(), attr=None,
                 device: str = ""):
        self.name, self.op, self.input = name, op, list(inputs)
        self.device = device
        self.attr: Dict[str, AttrValue] = attr or {}
        self.extra = b""

    @staticmethod
    def parse(buf, start: int, end: int) -> "NodeDef":
        nd = NodeDef()
        extra = []
        for num, _, val, fs, fe in _fields(buf, start, end):
            if num == 1:
                nd.name = _str(buf, val)
            elif num == 2:
                nd.op = _str(buf, val)
            elif num == 3:
                nd.input.append(_str(buf, val))
            elif num == 4:
                nd.device = _str(buf, val)
            elif num == 5:
                k, v = _map_entry(buf, val)
                nd.attr[k] = v
            else:
                extra.append(bytes(buf[fs:fe]))
        nd.extra = b"".join(extra)
        return nd

    def copy(self) -> "NodeDef":
        """A copy whose input list can be rewritten (attributes shared)."""
        c = NodeDef(self.name, self.op, self.input, dict(self.attr),
                    self.device)
        c.extra = self.extra
        return c


class ArgDef:
    """``OpDef.ArgDef``: the fields that size an output."""

    __slots__ = ("name", "type", "type_attr", "number_attr",
                 "type_list_attr")

    def __init__(self):
        self.name, self.type_attr = "", ""
        self.number_attr, self.type_list_attr, self.type = "", "", 0

    @staticmethod
    def parse(buf, start: int, end: int) -> "ArgDef":
        a = ArgDef()
        for num, _, val, _, _ in _fields(buf, start, end):
            if num == 1:
                a.name = _str(buf, val)
            elif num == 3:
                a.type = val
            elif num == 4:
                a.type_attr = _str(buf, val)
            elif num == 5:
                a.number_attr = _str(buf, val)
            elif num == 6:
                a.type_list_attr = _str(buf, val)
        return a


class OpDef:
    """``OpDef`` (a function's signature): ``name``, ``input_arg``,
    ``output_arg``."""

    __slots__ = ("name", "input_arg", "output_arg")

    def __init__(self):
        self.name, self.input_arg, self.output_arg = "", [], []

    @staticmethod
    def parse(buf, start: int, end: int) -> "OpDef":
        od = OpDef()
        for num, _, val, _, _ in _fields(buf, start, end):
            if num == 1:
                od.name = _str(buf, val)
            elif num == 2:
                od.input_arg.append(ArgDef.parse(buf, *val))
            elif num == 3:
                od.output_arg.append(ArgDef.parse(buf, *val))
        return od


class FunctionDef:
    """``FunctionDef``: ``signature``, ``node_def``, ``ret`` (output arg
    name -> tensor ref)."""

    __slots__ = ("signature", "node_def", "ret")

    def __init__(self):
        self.signature, self.node_def = OpDef(), []
        self.ret: Dict[str, str] = {}

    @staticmethod
    def parse(buf, start: int, end: int) -> "FunctionDef":
        fd = FunctionDef()
        for num, _, val, _, _ in _fields(buf, start, end):
            if num == 1:
                fd.signature = OpDef.parse(buf, *val)
            elif num == 3:
                fd.node_def.append(NodeDef.parse(buf, *val))
            elif num == 4:
                k = v = ""
                for n2, _, v2, _, _ in _fields(buf, *val):
                    if n2 == 1:
                        k = _str(buf, v2)
                    elif n2 == 2:
                        v = _str(buf, v2)
                fd.ret[k] = v
        return fd


class FunctionLibrary:
    """``FunctionDefLibrary``: ``function``, a list of FunctionDefs."""

    __slots__ = ("function",)

    def __init__(self):
        self.function: List[FunctionDef] = []


class GraphDef:
    """``GraphDef``: ``node`` (a list of :class:`NodeDef`) and
    ``library``. ``pieces`` keeps the top-level fields in order as ``(node
    index or None, bytes of the whole field)`` for :func:`seeded_consts`."""

    __slots__ = ("node", "library", "pieces")

    def __init__(self):
        self.node: List[NodeDef] = []
        self.library = FunctionLibrary()
        self.pieces: List[Tuple[Optional[int], object]] = []

    @staticmethod
    def parse(data) -> "GraphDef":
        buf = memoryview(data) if not isinstance(data, memoryview) \
            else data
        gd = GraphDef()
        for num, _, val, fs, fe in _fields(buf):
            if num == 1:
                gd.pieces.append((len(gd.node), buf[fs:fe]))
                gd.node.append(NodeDef.parse(buf, *val))
            else:
                gd.pieces.append((None, buf[fs:fe]))
                if num == 2:
                    for n2, _, v2, _, _ in _fields(buf, *val):
                        if n2 == 1:
                            gd.library.function.append(
                                FunctionDef.parse(buf, *v2))
        return gd


def parse_graph_def(data) -> GraphDef:
    """A serialized GraphDef (bytes, bytearray or memoryview) parsed."""
    return GraphDef.parse(data)


# ------------------------------------------------------------- op outputs
#: output arguments of every op the importer maps, for the
#: ``node:out_arg:k`` refs of function bodies: space-separated names, an
#: argument sized by a number attribute as ``name*attr``, one sized by a
#: type-list attribute as ``name+attr`` (from TF's OpDefs)
OUTPUT_ARGS = {
    "Abs": "y", "Acos": "y", "Acosh": "y", "Add": "z", "AddN": "sum",
    "AddV2": "z", "All": "output", "Any": "output", "ArgMax": "output",
    "Asin": "y", "Asinh": "y", "Assert": "", "Atan": "y", "Atan2": "z",
    "Atanh": "y", "AvgPool": "output", "BatchMatMul": "output",
    "BatchMatMulV2": "output", "BatchMatMulV3": "output",
    "BatchToSpaceND": "output", "Betainc": "z", "BiasAdd": "output",
    "Bincount": "bins", "BitwiseAnd": "z", "BitwiseOr": "z",
    "BitwiseXor": "z", "Bucketize": "output", "Case": "output+Tout",
    "Cast": "y", "Ceil": "y", "Cholesky": "output", "ClipByValue": "output",
    "ConcatV2": "output", "Const": "output", "Conv2D": "output", "Cos": "y",
    "Cosh": "y", "Cross": "product", "Cumprod": "out", "Cumsum": "out",
    "DenseBincount": "output", "DepthToSpace": "output",
    "DepthwiseConv2dNative": "output", "Diag": "output",
    "DiagPart": "diagonal", "Digamma": "y", "Div": "z", "DivNoNan": "z",
    "Einsum": "output", "Elu": "activations", "Enter": "output", "Equal": "z",
    "Erf": "y", "Erfc": "y", "Erfinv": "y", "Exit": "output", "Exp": "y",
    "ExpandDims": "output", "Expm1": "y", "Fill": "output", "Floor": "y",
    "FloorDiv": "z", "FloorMod": "z",
    "FusedBatchNorm": "y batch_mean batch_variance reserve_space_1 reserve_space_2",
    "FusedBatchNormV2": "y batch_mean batch_variance reserve_space_1 reserve_space_2",
    "FusedBatchNormV3": "y batch_mean batch_variance reserve_space_1 reserve_space_2 reserve_space_3",
    "Gather": "output", "GatherV2": "output", "Greater": "z",
    "GreaterEqual": "z", "Identity": "output", "If": "output+Tout",
    "Igamma": "z", "Igammac": "z", "InTopK": "precision",
    "InTopKV2": "precision", "Invert": "y", "InvertPermutation": "y",
    "IsFinite": "y", "IsInf": "y", "IsNan": "y", "L2Loss": "output",
    "LeakyRelu": "activations", "LeftShift": "z", "Less": "z",
    "LessEqual": "z", "Lgamma": "y", "LinSpace": "output", "Log": "y",
    "Log1p": "y", "LogSoftmax": "logsoftmax", "LogicalAnd": "z",
    "LogicalNot": "y", "LogicalOr": "z", "LoopCond": "output",
    "MatMul": "product", "MatrixBandPart": "band",
    "MatrixDeterminant": "output", "MatrixDiag": "output",
    "MatrixDiagPart": "diagonal", "MatrixDiagPartV2": "diagonal",
    "MatrixDiagPartV3": "diagonal", "MatrixDiagV2": "output",
    "MatrixDiagV3": "output", "MatrixInverse": "output",
    "MatrixSetDiag": "output", "MatrixSetDiagV2": "output",
    "MatrixSetDiagV3": "output", "Max": "output", "MaxPool": "output",
    "Maximum": "z", "Mean": "output", "Merge": "output value_index",
    "Min": "output", "Minimum": "z", "MirrorPad": "output", "Mod": "z",
    "Mul": "z", "Neg": "y", "NextIteration": "output", "NoOp": "",
    "NotEqual": "z", "OneHot": "output", "Pack": "output", "Pad": "output",
    "PadV2": "output", "PartitionedCall": "output+Tout",
    "Placeholder": "output", "PlaceholderWithDefault": "output",
    "Polygamma": "z", "Pow": "z", "PreventGradient": "output",
    "Prod": "output", "Range": "output", "RealDiv": "z", "Reciprocal": "y",
    "RefEnter": "output", "RefExit": "output",
    "RefMerge": "output value_index", "RefNextIteration": "output",
    "RefSwitch": "output_false output_true", "Relu": "activations",
    "Relu6": "activations", "Reshape": "output", "ReverseSequence": "output",
    "ReverseV2": "output", "RightShift": "z", "Rint": "y", "Roll": "output",
    "Round": "y", "Rsqrt": "y", "SegmentMax": "output",
    "SegmentMean": "output", "SegmentMin": "output", "SegmentProd": "output",
    "SegmentSum": "output", "Select": "output", "SelectV2": "output",
    "Selu": "activations", "Shape": "output", "Sigmoid": "y", "Sign": "y",
    "Sin": "y", "Sinh": "y", "Slice": "output", "Snapshot": "output",
    "Softmax": "softmax", "Softplus": "activations",
    "Softsign": "activations", "SpaceToBatchND": "output",
    "SpaceToDepth": "output",
    "SparseSoftmaxCrossEntropyWithLogits": "loss backprop",
    "Split": "output*num_split", "Sqrt": "y", "Square": "y",
    "SquaredDifference": "z", "Squeeze": "output",
    "StatefulPartitionedCall": "output+Tout", "StatelessCase": "output+Tout",
    "StatelessIf": "output+Tout", "StatelessWhile": "output+T",
    "StopGradient": "output", "StridedSlice": "output", "Sub": "z",
    "Sum": "output", "Switch": "output_false output_true", "Tan": "y",
    "Tanh": "y", "TensorArrayGatherV3": "value", "TensorArrayReadV3": "value",
    "TensorArrayScatterV3": "flow_out", "TensorArraySizeV3": "size",
    "TensorArrayV3": "handle flow", "TensorArrayWriteV3": "flow_out",
    "TensorListFromTensor": "output_handle", "TensorListGather": "values",
    "TensorListGetItem": "item", "TensorListLength": "length",
    "TensorListReserve": "handle", "TensorListSetItem": "output_handle",
    "TensorListStack": "tensor", "TensorScatterAdd": "output",
    "TensorScatterUpdate": "output", "Tile": "output",
    "TopKV2": "values indices", "Transpose": "y", "TruncateDiv": "z",
    "TruncateMod": "z", "Unpack": "output*num",
    "UnsortedSegmentMax": "output", "UnsortedSegmentMin": "output",
    "UnsortedSegmentProd": "output", "UnsortedSegmentSum": "output",
    "While": "output+T", "Xdivy": "z", "Xlog1py": "z", "Xlogy": "z",
    "Zeta": "z", "_SwitchN": "outputs*num_outs",
}


def output_arg_offset(node: NodeDef, out_name: str) -> int:
    """The overall output index at which ``node``'s output argument
    ``out_name`` starts; an op not in :data:`OUTPUT_ARGS` raises."""
    spec = OUTPUT_ARGS.get(node.op)
    if spec is None:
        raise TFImportError(
            f"unknown op {node.op!r} in function body (no OpDef)")
    off = 0
    for arg in spec.split():
        if "*" in arg:
            name, attr = arg.split("*")
            size = int(node.attr[attr].i) if attr in node.attr else 0
        elif "+" in arg:
            name, attr = arg.split("+")
            size = len(node.attr[attr].list.type) if attr in node.attr \
                else 0
        else:
            name, size = arg, 1
        if name == out_name:
            return off
        off += size
    raise TFImportError(f"{node.op}: no output arg {out_name!r}")


# ---------------------------------------------------------------- encoding
def _enc_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_len(num: int, payload) -> bytes:
    return _enc_varint((num << 3) | 2) + _enc_varint(len(payload)) + \
        bytes(payload)


def _enc_int(num: int, v: int) -> bytes:
    return _enc_varint(num << 3) + _enc_varint(v)


def encode_shape(dims) -> bytes:
    """A ``TensorShapeProto`` of ``dims``."""
    return b"".join(_enc_len(2, _enc_int(1, int(d)) if int(d) else b"")
                    for d in dims)


def encode_tensor(dtype: int, dims, content: bytes = b"") -> bytes:
    """A ``TensorProto`` of enum ``dtype``, shape ``dims`` and
    ``tensor_content``."""
    return _enc_int(1, dtype) + _enc_len(2, encode_shape(dims)) + \
        (_enc_len(4, content) if len(content) else b"")


def encode_attr_tensor(tensor: bytes) -> bytes:
    """An ``AttrValue`` holding the TensorProto bytes ``tensor``."""
    return _enc_len(8, tensor)


def encode_node(name: str, op: str, inputs=(), attrs=None,
                device: str = "", extra: bytes = b"") -> bytes:
    """A ``NodeDef``: ``attrs`` maps names to AttrValue bytes (written in
    sorted order, as TF's deterministic serialization does)."""
    out = [_enc_len(1, name.encode()), _enc_len(2, op.encode())]
    out += [_enc_len(3, i.encode()) for i in inputs]
    if device:
        out.append(_enc_len(4, device.encode()))
    for k in sorted(attrs or {}):
        out.append(_enc_len(5, _enc_len(1, k.encode())
                            + _enc_len(2, attrs[k])))
    out.append(bytes(extra))
    return b"".join(out)


_FLOAT_ENUMS = {DT_FLOAT: np.float32, DT_DOUBLE: np.float64,
                DT_HALF: np.float16, DT_BFLOAT16: None}
#: HF BERT's ``initializer_range``: the spread of the seeded weights
SEED_STD = 0.02


def seeded_nodes(gd: GraphDef) -> List[NodeDef]:
    """The float ``Const`` nodes that hold no values (the emptied large
    constants of the committed fixture), by name."""
    out = []
    for nd in gd.node:
        av = nd.attr.get("value")
        if nd.op != "Const" or av is None or av.tensor is None:
            continue
        t = av.tensor
        if t.dtype in _FLOAT_ENUMS and t.num_elements > 0 and \
                not t.has_values():
            out.append(nd)
    return sorted(out, key=lambda n: n.name)


def seeded_consts(graph_def, seed: int, std: float = SEED_STD) -> bytes:
    """The GraphDef ``graph_def`` (bytes or a parsed :class:`GraphDef`)
    with every emptied float constant (:func:`seeded_nodes`) filled with
    numpy ``default_rng(seed)`` normals times ``std``, drawn in node-name
    order, each node's draw in the shape's row-major order; the rest of
    the graph is copied byte for byte. Returns the serialized graph."""
    gd = graph_def if isinstance(graph_def, GraphDef) else \
        GraphDef.parse(graph_def)
    rng = np.random.default_rng(seed)
    fills: Dict[str, bytes] = {}
    for nd in seeded_nodes(gd):
        t = nd.attr["value"].tensor
        vals = rng.standard_normal(t.num_elements, dtype=np.float32) * \
            np.float32(std)
        if t.dtype == DT_BFLOAT16:
            raw = torch.from_numpy(vals).to(torch.bfloat16).view(
                torch.int16).numpy().tobytes()
        else:
            raw = vals.astype(_FLOAT_ENUMS[t.dtype]).tobytes()
        fills[nd.name] = encode_tensor(t.dtype, t.shape.dims, raw)
    out = []
    for idx, piece in gd.pieces:
        nd = gd.node[idx] if idx is not None else None
        if nd is None or nd.name not in fills:
            out.append(bytes(piece))
            continue
        attrs = {k: bytes(v.raw) for k, v in nd.attr.items()}
        attrs["value"] = encode_attr_tensor(fills[nd.name])
        out.append(_enc_len(1, encode_node(nd.name, nd.op, nd.input, attrs,
                                           nd.device, nd.extra)))
    return b"".join(out)
