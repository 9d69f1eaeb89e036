"""Frozen TF GraphDef -> SameDiff: counterpart of
``deeplearning4j_tpu/modelimport/tensorflow/tf_import.py`` (:1-1437).

A registry of per-TF-op mappers (``OpMappingRegistry``, 201 names with
``cf_import``'s) emits nodes of the port's registry ops into a
``SameDiff`` graph on the card (or on ``device="cpu"``), which then runs
op by op. Static operands (axes, shapes, permutations) are resolved from
Const nodes and folded shape sub-graphs at import time, as in JAX.

Where JAX takes a thing from ``tensorflow`` or ``jax``, the port has its
own: the GraphDef comes from ``graphdef_wire`` (no protobuf package); an
abstract value is an :class:`Aval` (shape, torch dtype) where JAX has a
``jax.ShapeDtypeStruct``; and the two-probe shape folding runs each
emitted op on ``device="meta"`` tensors where JAX calls
``jax.eval_shape`` (:meth:`_Walker._propagate_avals`, through
``modelimport/_shapes.py``, which the ONNX importer shares). An op that
needs a value on the host (``.item()``) fails there and drops the aval,
as a JAX op that needs a concrete value fails ``eval_shape``. Control-flow
ops are probed by their sub-graphs (a loop keeps its variables' avals,
a branch takes its first sub-graph's), as JAX traces them.

No fallback: an unknown op raises :class:`TFImportError`, and an import
on the card with no card raises (``device.resolve_device``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, SDVariable
from deeplearning4j_tpu_torch.modelimport import trace as mapper_trace
from deeplearning4j_tpu_torch.modelimport._shapes import Aval, eval_shape
from deeplearning4j_tpu_torch.modelimport.tensorflow import graphdef_wire
from deeplearning4j_tpu_torch.modelimport.tensorflow.graphdef_wire import (
    TFImportError,
)

__all__ = ["TFGraphMapper", "OpMappingRegistry", "TFImportError"]

_DTYPE_MAP = {
    1: "float32", 2: "float64", 3: "int32", 4: "uint8", 6: "int8",
    9: "int64", 10: "bool", 14: "bfloat16", 19: "float16",
}


def _dtype_name(enum_val: int) -> str:
    return _DTYPE_MAP.get(int(enum_val), "float32")


def _is_int_dtype(dt: torch.dtype) -> bool:
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)

# Sentinel for an unknown dim inside an import-time partially-known
# integer array (shape-subgraph folding; see _PartialEval). Values in
# [iinfo.min, _DYN_LIMIT] are all "dynamic": DYN is the anonymous one;
# _PartialEval allocates provenance-carrying sentinels above it that
# remember WHICH tensor dim they came from (so Reshape can emit
# copy-input-dim semantics when a target mixes a literal -1 with a
# dynamic batch dim — the transpose_for_scores pattern in real BERT
# graphs).
DYN = np.int64(np.iinfo(np.int64).min + 7)
_DYN_LIMIT = np.int64(np.iinfo(np.int64).min + 10_000_000)


def _is_dyn(v) -> np.ndarray:
    a = np.asarray(v)
    if a.dtype.kind not in "iu":
        return np.zeros(a.shape, bool)
    return a <= _DYN_LIMIT


class _Ctx:
    """Everything a mapper needs for one node."""

    def __init__(self, sd: SameDiff, node, inputs: List[SDVariable],
                 static: List[Optional[np.ndarray]], attrs: Dict[str, Any],
                 pe=None, avals=None):
        self.sd = sd
        self.node = node
        self.inputs = inputs
        self._static = static
        self.attrs = attrs
        self.pe = pe          # _PartialEval (provenance registry) or None
        self.avals = avals    # var name -> (probe2 aval, probe3 aval)

    def resolve_dyn_dim(self, sentinel: int) -> Optional[int]:
        """Map a provenance sentinel to a dim index of THIS node's data
        input whose two-probe extents match the sentinel's source dim
        (i.e. 'copy input dim k'), or None."""
        if self.pe is None or self.avals is None:
            return None
        prov = self.pe.dyn_prov.get(int(sentinel))
        if prov is None:
            return None
        vname, dim = prov
        src = self.avals.get(vname)
        dst = self.avals.get(self.inputs[0].name)
        if src is None or dst is None or dim >= len(src[0].shape):
            return None
        want = (src[0].shape[dim], src[1].shape[dim])
        if want[0] == want[1]:
            return None
        for k, ab in enumerate(zip(dst[0].shape, dst[1].shape)):
            if ab == want:
                return k
        return None

    def static_np(self, i: int) -> np.ndarray:
        """Constant value of input i (axes/shapes/perms must be static —
        XLA static-shape discipline; the reference resolves these from
        Const nodes the same way, plus folded shape subgraphs)."""
        v = self._static[i]
        if v is None or bool(np.any(_is_dyn(v))):
            raise TFImportError(
                f"node {self.node.name} ({self.node.op}): input {i} must "
                "be a constant (dynamic shapes/axes not importable)")
        return v

    def partial_np(self, i: int) -> np.ndarray:
        """Like static_np but tolerates DYN entries (unknown dims) —
        used by Reshape, where one unknown dim becomes -1."""
        v = self._static[i]
        if v is None:
            raise TFImportError(
                f"node {self.node.name} ({self.node.op}): input {i} is "
                "not statically resolvable (even partially)")
        return np.asarray(v)

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def op(self, op_name: str, inputs: Sequence[SDVariable], n_out: int = 1,
           **attrs):
        return self.sd._op(op_name, [v.name for v in inputs], n_out=n_out,
                           name=self.node.name, **attrs)


class OpMappingRegistry:
    """TF op type → mapper fn(ctx) -> SDVariable | tuple (reference:
    OpMappingRegistry + per-op MappingRule sets)."""

    _mappers: Dict[str, Callable[[_Ctx], Any]] = {}

    @classmethod
    def register(cls, *tf_ops: str):
        def deco(fn):
            for name in tf_ops:
                cls._mappers[name] = fn
            return fn
        return deco

    @classmethod
    def get(cls, tf_op: str) -> Callable[[_Ctx], Any]:
        try:
            fn = cls._mappers[tf_op]
        except KeyError:
            raise TFImportError(
                f"no mapper for TF op {tf_op!r} "
                f"(have {len(cls._mappers)}: add one via "
                "OpMappingRegistry.register)") from None
        mapper_trace.record("tf", tf_op)
        return fn

    @classmethod
    def has(cls, tf_op: str) -> bool:
        return tf_op in cls._mappers

    @classmethod
    def coverage(cls) -> List[str]:
        return sorted(cls._mappers)


# ------------------------------------------------------------------ attrs
def _decode_attrs(node) -> Dict[str, Any]:
    """A node's attributes as plain values, as JAX's decoder gives them
    (a ``list.type`` reads as ``[]`` there too; the raw field stays on
    the node for ``cf_import``'s output offsets)."""
    out: Dict[str, Any] = {}
    for k, v in node.attr.items():
        field = v.which
        if field == "b":
            out[k] = bool(v.b)
        elif field == "i":
            out[k] = int(v.i)
        elif field == "f":
            out[k] = float(v.f)
        elif field == "s":
            out[k] = v.s.decode(errors="replace")
        elif field == "type":
            out[k] = _dtype_name(v.type)
        elif field == "shape":
            out[k] = list(v.shape.dims)
        elif field == "tensor":
            out[k] = v.tensor  # decoded lazily by the Const mapper
        elif field == "list":
            lst = v.list
            if lst.i:
                out[k] = [int(x) for x in lst.i]
            elif lst.f:
                out[k] = [float(x) for x in lst.f]
            elif lst.s:
                out[k] = [x.decode(errors="replace") for x in lst.s]
            elif lst.b:
                out[k] = [bool(x) for x in lst.b]
            else:
                out[k] = []
    return out


# ---------------------------------------------------------------- mappers
def _register_standard_mappers():
    R = OpMappingRegistry.register

    # elementwise binary
    for tf_op, our in [("Add", "add"), ("AddV2", "add"), ("Sub", "sub"),
                       ("Mul", "mul"), ("RealDiv", "div"), ("Div", "div"),
                       # TF Mod is C-truncation for floats (sign
                       # follows dividend) — NOT python floor-mod
                       # (caught by the mapper battery)
                       ("FloorDiv", "floordiv"), ("Mod", "fmod"),
                       ("FloorMod", "floormod"),
                       ("Pow", "pow_pairwise"), ("Maximum", "maximum"),
                       ("Minimum", "minimum"),
                       ("SquaredDifference", "squared_difference"),
                       ("Equal", "eq"), ("NotEqual", "neq"),
                       ("Greater", "gt"), ("GreaterEqual", "gte"),
                       ("Less", "lt"), ("LessEqual", "lte"),
                       ("LogicalAnd", "logical_and"),
                       ("LogicalOr", "logical_or")]:
        R(tf_op)(lambda ctx, _o=our: ctx.op(_o, ctx.inputs[:2]))

    # elementwise unary
    for tf_op, our in [("Neg", "neg"), ("Exp", "exp"), ("Log", "log"),
                       ("Log1p", "log1p"), ("Sqrt", "sqrt"),
                       ("Rsqrt", "rsqrt"), ("Square", "square"),
                       ("Abs", "abs"), ("Sign", "sign"), ("Floor", "floor"),
                       ("Ceil", "ceil"), ("Round", "round"),
                       ("Relu", "relu"), ("Relu6", "relu6"),
                       ("Sigmoid", "sigmoid"), ("Tanh", "tanh"),
                       ("Softplus", "softplus"), ("Softsign", "softsign"),
                       ("Elu", "elu"), ("Selu", "selu"), ("Erf", "erf"),
                       ("Sin", "sin"), ("Cos", "cos"), ("Tan", "tan"),
                       ("Sinh", "sinh"), ("Cosh", "cosh"),
                       ("Reciprocal", "reciprocal"),
                       ("LogicalNot", "logical_not"),
                       ("IsNan", "isnan"), ("IsInf", "isinf"),
                       ("StopGradient", "stop_gradient"),
                       ("Identity", "identity"), ("Snapshot", "identity")]:
        R(tf_op)(lambda ctx, _o=our: ctx.op(_o, ctx.inputs[:1]))

    @R("LeakyRelu")
    def _leaky(ctx):
        return ctx.op("leakyrelu", ctx.inputs[:1],
                      alpha=float(ctx.attr("alpha", 0.2)))

    @R("Softmax")
    def _softmax(ctx):
        return ctx.op("softmax", ctx.inputs[:1])

    @R("LogSoftmax")
    def _log_softmax(ctx):
        return ctx.op("log_softmax", ctx.inputs[:1])

    @R("MatMul")
    def _matmul(ctx):
        return ctx.op("matmul", ctx.inputs[:2],
                      transpose_a=bool(ctx.attr("transpose_a", False)),
                      transpose_b=bool(ctx.attr("transpose_b", False)))

    @R("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
    def _batch_matmul(ctx):
        ta = bool(ctx.attr("adj_x", False))
        tb = bool(ctx.attr("adj_y", False))
        return ctx.op("matmul", ctx.inputs[:2],
                      transpose_a=ta, transpose_b=tb)

    @R("BiasAdd")
    def _bias_add(ctx):
        if ctx.attr("data_format", "NHWC") == "NCHW":
            # late binding: _nchw_sandwich is defined below in this
            # same registration scope, before any mapper runs
            return _nchw_sandwich(
                ctx, lambda xt: ctx.sd._op(
                    "add", [xt.name, ctx.inputs[1].name]))
        return ctx.op("add", ctx.inputs[:2])

    @R("AddN")
    def _addn(ctx):
        if len(ctx.inputs) == 1:
            # must emit a fresh variable: importGraph renames the mapper's
            # output to the node name, and renaming the upstream input
            # would corrupt the graph's name table
            return ctx.op("identity", ctx.inputs[:1])
        out = ctx.inputs[0]
        for v in ctx.inputs[1:]:
            out = ctx.sd._op("add", [out.name, v.name])
        return out

    # reductions: axes come from a const input
    for tf_op, our in [("Mean", "reduce_mean"), ("Sum", "reduce_sum"),
                       ("Max", "reduce_max"), ("Min", "reduce_min"),
                       ("Prod", "reduce_prod"), ("All", "reduce_all"),
                       ("Any", "reduce_any")]:
        def _red(ctx, _o=our):
            axes = ctx.static_np(1)
            dims = [int(a) for a in np.atleast_1d(axes)]
            return ctx.op(_o, ctx.inputs[:1], dimensions=dims,
                          keep_dims=bool(ctx.attr("keep_dims", False)))
        R(tf_op)(_red)

    @R("ArgMax")
    def _argmax(ctx):
        axis = int(ctx.static_np(1))
        return ctx.op("argmax", ctx.inputs[:1], dimensions=axis)

    # shape manipulation
    @R("Reshape")
    def _reshape(ctx):
        arr = np.atleast_1d(ctx.partial_np(1)).astype(np.int64)
        shape: List[int] = []
        copy_dims: Dict[int, int] = {}
        unknown = 0
        for pos, val in enumerate(arr.tolist()):
            if bool(_is_dyn(np.int64(val))):
                k = ctx.resolve_dyn_dim(val)
                if k is None:
                    unknown += 1
                    shape.append(-1)
                else:
                    copy_dims[pos] = k
                    shape.append(0)   # placeholder; runtime substitutes
            else:
                if val == -1:
                    unknown += 1
                shape.append(int(val))
        if unknown > 1:
            raise TFImportError(
                f"{ctx.node.name}: Reshape target has {unknown} unknown "
                "dims — at most one (mapped to -1) is importable")
        if copy_dims:
            return ctx.op("reshape", ctx.inputs[:1], shape=shape,
                          copy_dims=copy_dims)
        return ctx.op("reshape", ctx.inputs[:1], shape=shape)

    @R("Transpose")
    def _transpose(ctx):
        perm = [int(p) for p in ctx.static_np(1)]
        return ctx.op("transpose", ctx.inputs[:1], permute=perm)

    @R("ExpandDims")
    def _expand(ctx):
        return ctx.op("expand_dims", ctx.inputs[:1],
                      axis=int(ctx.static_np(1)))

    @R("Squeeze")
    def _squeeze(ctx):
        dims = ctx.attr("squeeze_dims") or ctx.attr("axis") or None
        axis = tuple(dims) if dims else None
        return ctx.op("squeeze", ctx.inputs[:1], axis=axis)

    @R("ConcatV2")
    def _concat(ctx):
        axis = int(ctx.static_np(len(ctx.inputs) - 1))
        return ctx.op("concat", ctx.inputs[:-1], axis=axis)

    @R("Pack")
    def _pack(ctx):
        return ctx.op("stack", ctx.inputs, axis=int(ctx.attr("axis", 0)))

    @R("Unpack")
    def _unpack(ctx):
        n = int(ctx.attr("num"))
        return ctx.op("unstack", ctx.inputs[:1], n_out=n,
                      axis=int(ctx.attr("axis", 0)), num=n)

    @R("Split")
    def _split(ctx):
        axis = int(ctx.static_np(0))
        n = int(ctx.attr("num_split"))
        return ctx.op("split", ctx.inputs[1:2], n_out=n,
                      num_splits=n, axis=axis)

    @R("Tile")
    def _tile(ctx):
        reps = [int(r) for r in ctx.static_np(1)]
        return ctx.op("tile", ctx.inputs[:1], reps=reps)

    @R("Pad", "PadV2")
    def _pad(ctx):
        pads = [[int(a), int(b)] for a, b in ctx.static_np(1)]
        value = (float(ctx.static_np(2))
                 if ctx.node.op == "PadV2" and len(ctx.node.input) > 2
                 else 0.0)
        return ctx.op("pad", ctx.inputs[:1], paddings=pads,
                      constant_value=value)

    @R("Slice")
    def _slice(ctx):
        begin = [int(b) for b in ctx.static_np(1)]
        size = [int(s) for s in ctx.static_np(2)]
        return ctx.op("slice", ctx.inputs[:1], begin=begin, size=size)

    @R("StridedSlice")
    def _strided_slice(ctx):
        if ctx.attr("ellipsis_mask", 0):
            raise TFImportError(
                f"{ctx.node.name}: StridedSlice ellipsis mask "
                "not supported")
        bm = int(ctx.attr("begin_mask", 0))
        em = int(ctx.attr("end_mask", 0))
        sm = int(ctx.attr("shrink_axis_mask", 0))
        nm = int(ctx.attr("new_axis_mask", 0))
        try:
            begin = [int(b) for b in ctx.static_np(1)]
            end = [int(e) for e in ctx.static_np(2)]
            strides = [int(s) for s in ctx.static_np(3)]
        except TFImportError:
            return _strided_slice_dynamic(ctx, bm, em, sm, nm)
        return ctx.op("tf_strided_slice", ctx.inputs[:1], begin=begin,
                      end=end, strides=strides, begin_mask=bm, end_mask=em,
                      shrink_axis_mask=sm, new_axis_mask=nm)

    def _strided_slice_dynamic(ctx, bm, em, sm, nm):
        """Loop-counter indexing (``a[:, i]``, ``a[i]``): begin/end hold
        traced scalars. Supported subset: unit strides, no new-axis,
        dynamic entries only on shrink dims (size-1 runtime index) —
        lowered to lax.dynamic_slice which XLA keeps on-device."""
        if nm:
            raise TFImportError(
                f"{ctx.node.name}: dynamic StridedSlice with "
                "new_axis_mask not supported")
        begin = np.atleast_1d(ctx.partial_np(1)).astype(np.int64)
        end = np.atleast_1d(ctx.partial_np(2)).astype(np.int64)
        strides = np.atleast_1d(ctx.partial_np(3)).astype(np.int64)
        if np.any(_is_dyn(strides)) or not np.all(strides == 1):
            raise TFImportError(
                f"{ctx.node.name}: dynamic StridedSlice requires unit "
                "strides")
        b_spec: List[Optional[int]] = []
        e_spec: List[Optional[int]] = []
        for d in range(len(begin)):
            b_dyn = bool(_is_dyn(begin[d]))
            e_dyn = bool(_is_dyn(end[d]))
            if (b_dyn or e_dyn) and not (sm & (1 << d)) \
                    and not ((bm & (1 << d)) and (em & (1 << d))):
                raise TFImportError(
                    f"{ctx.node.name}: dynamic StridedSlice begin/end "
                    f"at dim {d} without shrink_axis_mask (only size-1 "
                    "runtime indexing is importable)")
            b_spec.append(None if b_dyn else int(begin[d]))
            e_spec.append(None if e_dyn else int(end[d]))
        return ctx.op("tf_strided_slice_dyn",
                      [ctx.inputs[0], ctx.inputs[1]],
                      begin=b_spec, end=e_spec, begin_mask=bm,
                      end_mask=em, shrink_axis_mask=sm)

    @R("GatherV2", "Gather")
    def _gather(ctx):
        axis = int(ctx.static_np(2)) if len(ctx.inputs) > 2 else 0
        return ctx.op("gather", ctx.inputs[:2], axis=axis)

    @R("OneHot")
    def _one_hot(ctx):
        depth = int(ctx.static_np(1))
        on = float(ctx.static_np(2)) if len(ctx.node.input) > 2 else 1.0
        off = float(ctx.static_np(3)) if len(ctx.node.input) > 3 else 0.0
        axis = int(ctx.attr("axis", -1))
        return ctx.op("one_hot", ctx.inputs[:1], depth=depth, on_value=on,
                      off_value=off, axis=axis)

    @R("Cast")
    def _cast(ctx):
        return ctx.op("cast", ctx.inputs[:1], dtype=ctx.attr("DstT"))

    @R("Shape")
    def _shape(ctx):
        return ctx.op("shape_of", ctx.inputs[:1])

    @R("Fill")
    def _fill(ctx):
        dims = [int(d) for d in ctx.static_np(0)]
        value = float(ctx.static_np(1))
        return ctx.op("tf_fill", [], shape=dims, value=value)

    @R("Range")
    def _range(ctx):
        start, limit, delta = (ctx.static_np(i) for i in range(3))
        is_f = any(np.issubdtype(np.asarray(v).dtype, np.floating)
                   for v in (start, limit, delta))
        return ctx.op("range", [],
                      start=float(start), stop=float(limit),
                      step=float(delta),
                      dtype="float32" if is_f else "int32")

    @R("Select", "SelectV2")
    def _select(ctx):
        return ctx.op("where", ctx.inputs[:3])

    # ---- NN ops ----
    # NCHW graphs import via a transpose sandwich: NCHW -> NHWC (the
    # op's native layout here, TPU-preferred) -> NCHW. Between two
    # consecutive NCHW nodes the inner [0,3,1,2]/[0,2,3,1] pair is
    # adjacent in the graph and XLA cancels it, so a whole NCHW conv
    # stack costs two real layout ops total (reference: the importer's
    # permuteFirstDims/NCHW handling in Conv2D MappingRules).
    def _check_rank4(ctx, v, what):
        aval = (ctx.avals or {}).get(v.name)
        if aval is not None and len(aval[0].shape) != 4:
            raise TFImportError(
                f"{ctx.node.name}: {what} expects a rank-4 tensor, got "
                f"rank {len(aval[0].shape)}")

    def _nchw_sandwich(ctx, emit, *extra_inputs):
        """Emit `emit(nhwc_x, *extra)` wrapped in NCHW<->NHWC
        transposes; the final transpose carries the node's name."""
        x = ctx.inputs[0]
        _check_rank4(ctx, x, f"{ctx.node.op} NCHW")
        xt = ctx.sd._op("transpose", [x.name], permute=[0, 2, 3, 1])
        y = emit(xt, *extra_inputs)
        return ctx.op("transpose", [y], permute=[0, 3, 1, 2])

    def _check_padding(ctx, allow_explicit=False):
        """SAME/VALID (+ EXPLICIT for convs) — anything else must not
        be silently treated as VALID."""
        pad = ctx.attr("padding", "VALID")
        ok = ("SAME", "VALID", "EXPLICIT") if allow_explicit \
            else ("SAME", "VALID")
        if pad not in ok:
            raise TFImportError(
                f"{ctx.node.name}: padding={pad!r} not supported "
                f"({'/'.join(ok)} only)")
        return pad

    def _explicit_pairs(ctx, df):
        """TF explicit_paddings: 8 ints, (lo,hi) per dim in data_format
        order. Returns ((h_lo,h_hi),(w_lo,w_hi)); batch/channel pads
        must be zero (TF enforces this too)."""
        ep = [int(v) for v in ctx.attr("explicit_paddings", [])]
        if len(ep) != 8:
            raise TFImportError(
                f"{ctx.node.name}: EXPLICIT padding needs 8 "
                f"explicit_paddings entries, got {len(ep)}")
        pairs = list(zip(ep[0::2], ep[1::2]))
        if df == "NHWC":
            nc, hw = (pairs[0], pairs[3]), (pairs[1], pairs[2])
        else:
            nc, hw = (pairs[0], pairs[1]), (pairs[2], pairs[3])
        if any(v != 0 for q in nc for v in q):
            raise TFImportError(
                f"{ctx.node.name}: nonzero batch/channel explicit "
                "padding is not a convolution")
        return hw

    def _layout(ctx):
        df = ctx.attr("data_format", "NHWC")
        if df not in ("NHWC", "NCHW"):
            raise TFImportError(
                f"{ctx.node.name}: data_format={df!r} not supported")
        return df, ((2, 3) if df == "NCHW" else (1, 2))

    def _conv_pad_attr(ctx, df):
        pad = _check_padding(ctx, allow_explicit=True)
        if pad == "EXPLICIT":
            return _explicit_pairs(ctx, df)
        return "SAME" if pad == "SAME" else (0, 0)

    @R("Conv2D")
    def _conv2d(ctx):
        df, hw = _layout(ctx)
        strides = ctx.attr("strides", [1, 1, 1, 1])
        dil = ctx.attr("dilations", [1, 1, 1, 1])
        kw = dict(strides=(int(strides[hw[0]]), int(strides[hw[1]])),
                  padding=_conv_pad_attr(ctx, df),
                  dilation=(int(dil[hw[0]]), int(dil[hw[1]])))
        if df == "NCHW":
            # TF filters are HWIO for BOTH layouts; only x needs moving
            return _nchw_sandwich(
                ctx, lambda xt: ctx.sd._op(
                    "conv2d", [xt.name, ctx.inputs[1].name], **kw))
        return ctx.op("conv2d", ctx.inputs[:2], **kw)

    @R("DepthwiseConv2dNative")
    def _depthwise(ctx):
        df, hw = _layout(ctx)
        strides = ctx.attr("strides", [1, 1, 1, 1])
        dil = ctx.attr("dilations", [1, 1, 1, 1])
        kw = dict(strides=(int(strides[hw[0]]), int(strides[hw[1]])),
                  padding=_conv_pad_attr(ctx, df),
                  dilation=(int(dil[hw[0]]), int(dil[hw[1]])))
        if df == "NCHW":
            return _nchw_sandwich(
                ctx, lambda xt: ctx.sd._op(
                    "depthwise_conv2d", [xt.name, ctx.inputs[1].name],
                    **kw))
        return ctx.op("depthwise_conv2d", ctx.inputs[:2], **kw)

    @R("MaxPool")
    def _maxpool(ctx):
        df, hw = _layout(ctx)
        ks = ctx.attr("ksize", [1, 2, 2, 1])
        st = ctx.attr("strides", [1, 2, 2, 1])
        pad = _check_padding(ctx)
        kw = dict(kernel=(int(ks[hw[0]]), int(ks[hw[1]])),
                  strides=(int(st[hw[0]]), int(st[hw[1]])),
                  padding="SAME" if pad == "SAME" else "VALID")
        if df == "NCHW":
            return _nchw_sandwich(
                ctx, lambda xt: ctx.sd._op("maxpool2d", [xt.name], **kw))
        return ctx.op("maxpool2d", ctx.inputs[:1], **kw)

    @R("AvgPool")
    def _avgpool(ctx):
        df, hw = _layout(ctx)
        ks = ctx.attr("ksize", [1, 2, 2, 1])
        st = ctx.attr("strides", [1, 2, 2, 1])
        pad = _check_padding(ctx)
        kw = dict(kernel=(int(ks[hw[0]]), int(ks[hw[1]])),
                  strides=(int(st[hw[0]]), int(st[hw[1]])),
                  padding="SAME" if pad == "SAME" else "VALID")
        if df == "NCHW":
            return _nchw_sandwich(
                ctx, lambda xt: ctx.sd._op("avgpool2d", [xt.name], **kw))
        return ctx.op("avgpool2d", ctx.inputs[:1], **kw)

    def _diag_guard(ctx, roles):
        """MatrixDiag/Part/SetDiag V2/V3 extra operands — only the
        defaults map onto the square diag ops: k must be 0 (the main
        diagonal; -1 here means SUB-diagonal, not a default), num_rows/
        num_cols must be the -1 'infer' sentinel OR equal the natural
        diagonal length (converters often materialize concrete shapes;
        an explicit size that pads/truncates would be miscompiled by
        matrix_diag), padding_value must be 0."""
        diag_len = None
        p = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
        if p is not None and p[0].shape and \
                p[0].shape[-1] == p[1].shape[-1]:
            diag_len = int(p[0].shape[-1])
        base = len(ctx.inputs) - len(roles)
        for i, role in enumerate(roles):
            v = np.atleast_1d(ctx.static_np(base + i))
            ok = np.all(v == 0) if role in ("k", "padding") \
                else (np.all(v == -1)
                      or (diag_len is not None
                          and np.all(v == diag_len)))
            if not ok:
                raise TFImportError(
                    f"{ctx.node.name} ({ctx.node.op}): {role}="
                    f"{v.tolist()} — only the k=0 main-diagonal "
                    "inferred-size zero-padding form is importable")

    @R("MatrixDiag", "MatrixDiagV2", "MatrixDiagV3")
    def _matrix_diag(ctx):
        # V2/V3 operands: diagonal, k, num_rows, num_cols, padding
        _diag_guard(ctx, ["k", "rows", "cols", "padding"]
                    [:len(ctx.inputs) - 1])
        return ctx.op("matrix_diag", ctx.inputs[:1])

    @R("MatrixDiagPart", "MatrixDiagPartV2", "MatrixDiagPartV3")
    def _matrix_diag_part(ctx):
        # V2/V3 operands: input, k, padding_value
        _diag_guard(ctx, ["k", "padding"][:len(ctx.inputs) - 1])
        return ctx.op("diag_part", ctx.inputs[:1])

    @R("MatrixSetDiag", "MatrixSetDiagV2", "MatrixSetDiagV3")
    def _matrix_set_diag(ctx):
        # V2/V3 operands: input, diagonal, k
        _diag_guard(ctx, ["k"][:len(ctx.inputs) - 2])
        return ctx.op("matrix_set_diag", ctx.inputs[:2])

    @R("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
    def _fused_bn(ctx):
        if ctx.attr("is_training", True):
            raise TFImportError(
                f"{ctx.node.name}: FusedBatchNorm with is_training=True — "
                "freeze the graph for inference first")
        eps = float(ctx.attr("epsilon", 1e-3))
        if ctx.attr("data_format", "NHWC") == "NCHW":
            # scale/offset/mean/var are per-channel vectors — layout
            # only moves the data tensor
            return _nchw_sandwich(
                ctx, lambda xt: ctx.sd._op(
                    "batch_norm",
                    [xt.name] + [v.name for v in ctx.inputs[1:5]],
                    eps=eps))
        return ctx.op("batch_norm", ctx.inputs[:5], eps=eps)


def _register_extended_mappers():
    """Scientific/segment/linalg/layout mappers over ALREADY-registered
    ops (round-3 breadth: graphs using tf.math special functions,
    cumulative ops, segment ops, top-k, space/depth layout ops import
    without custom work — reference: the TFGraphTestAllSameDiff battery
    spans these op families)."""
    R = OpMappingRegistry.register

    for tf_op, our in [("Asin", "asin"), ("Acos", "acos"),
                       ("Atan", "atan"), ("Asinh", "asinh"),
                       ("Acosh", "acosh"), ("Atanh", "atanh"),
                       ("Lgamma", "lgamma"), ("Digamma", "digamma"),
                       ("Erfinv", "erfinv"), ("Rint", "rint"),
                       ("Expm1", "expm1"), ("IsFinite", "is_finite"),
                       ("Invert", "bitwise_not"),
                       ("InvertPermutation", "invert_permutation"),
                       ("Cholesky", "cholesky"),
                       ("MatrixDeterminant", "matrix_determinant"),
                       ("L2Loss", "l2_loss")]:
        R(tf_op)(lambda ctx, _o=our: ctx.op(_o, ctx.inputs[:1]))

    for tf_op, our in [("Atan2", "atan2"), ("Igamma", "igamma"),
                       ("Igammac", "igammac"), ("Zeta", "zeta"),
                       ("Polygamma", "polygamma"), ("Xlogy", "xlogy"),
                       ("Xdivy", "xdivy"), ("Xlog1py", "xlog1py"),
                       ("TruncateDiv", "truncatediv"),
                       ("TruncateMod", "fmod"),
                       ("DivNoNan", "divide_no_nan"),
                       ("LeftShift", "shift_left"),
                       ("RightShift", "shift_right"),
                       ("BitwiseAnd", "bitwise_and"),
                       ("BitwiseOr", "bitwise_or"),
                       ("BitwiseXor", "bitwise_xor"),
                       ("Cross", "cross")]:
        R(tf_op)(lambda ctx, _o=our: ctx.op(_o, ctx.inputs[:2]))

    R("Betainc")(lambda ctx: ctx.op("betainc", ctx.inputs[:3]))
    R("ClipByValue")(lambda ctx: ctx.op("clip_by_value",
                                        ctx.inputs[:3]))

    for tf_op, our in [("Cumsum", "cumsum"), ("Cumprod", "cumprod")]:
        def _cum(ctx, _o=our):
            return ctx.op(_o, ctx.inputs[:1],
                          axis=int(ctx.static_np(1)),
                          exclusive=bool(ctx.attr("exclusive", False)),
                          reverse=bool(ctx.attr("reverse", False)))
        R(tf_op)(_cum)

    @R("TopKV2")
    def _topk(ctx):
        return ctx.op("top_k", ctx.inputs[:1], n_out=2,
                      k=int(ctx.static_np(1)),
                      sorted=bool(ctx.attr("sorted", True)))

    @R("InTopK", "InTopKV2")
    def _in_top_k(ctx):
        k = (int(ctx.static_np(2)) if ctx.node.op == "InTopKV2"
             else int(ctx.attr("k")))
        return ctx.op("in_top_k", ctx.inputs[:2], k=k)

    @R("ReverseV2")
    def _reverse_v2(ctx):
        dims = [int(d) for d in np.atleast_1d(ctx.static_np(1))]
        return ctx.op("reverse", ctx.inputs[:1], dimensions=dims)

    @R("ReverseSequence")
    def _reverse_seq(ctx):
        return ctx.op("reverse_sequence", ctx.inputs[:2],
                      seq_axis=int(ctx.attr("seq_dim", 1)),
                      batch_axis=int(ctx.attr("batch_dim", 0)))

    for tf_op, our in [("SpaceToDepth", "space_to_depth"),
                       ("DepthToSpace", "depth_to_space")]:
        def _s2d(ctx, _o=our):
            if ctx.attr("data_format", "NHWC") != "NHWC":
                raise TFImportError(f"{ctx.node.name}: NHWC only")
            return ctx.op(_o, ctx.inputs[:1],
                          block_size=int(ctx.attr("block_size")))
        R(tf_op)(_s2d)

    @R("SpaceToBatchND")
    def _s2b_nd(ctx):
        return ctx.op(
            "space_to_batch_nd", ctx.inputs[:1],
            block_shape=[int(v) for v in ctx.static_np(1)],
            paddings=[[int(a), int(b)] for a, b in ctx.static_np(2)])

    @R("BatchToSpaceND")
    def _b2s_nd(ctx):
        return ctx.op(
            "batch_to_space_nd", ctx.inputs[:1],
            block_shape=[int(v) for v in ctx.static_np(1)],
            crops=[[int(a), int(b)] for a, b in ctx.static_np(2)])

    # sorted segment ops: segment_ids must be a constant so the output
    # size (max id + 1) is static under jit
    for tf_op, our in [("SegmentSum", "segment_sum"),
                       ("SegmentMean", "segment_mean"),
                       ("SegmentMax", "segment_max"),
                       ("SegmentMin", "segment_min"),
                       ("SegmentProd", "segment_prod")]:
        def _seg(ctx, _o=our):
            ids = ctx.static_np(1)
            return ctx.op(_o, ctx.inputs[:2],
                          num_segments=int(np.max(ids)) + 1)
        R(tf_op)(_seg)

    for tf_op, our in [("UnsortedSegmentSum", "unsorted_segment_sum"),
                       ("UnsortedSegmentMax", "unsorted_segment_max"),
                       ("UnsortedSegmentMin", "unsorted_segment_min"),
                       ("UnsortedSegmentProd",
                        "unsorted_segment_prod")]:
        def _useg(ctx, _o=our):
            return ctx.op(_o, ctx.inputs[:2],
                          num_segments=int(ctx.static_np(2)))
        R(tf_op)(_useg)

    @R("MatrixBandPart")
    def _band_part(ctx):
        return ctx.op("matrix_band_part", ctx.inputs[:1],
                      num_lower=int(ctx.static_np(1)),
                      num_upper=int(ctx.static_np(2)))

    @R("MatrixInverse")
    def _matrix_inverse(ctx):
        if ctx.attr("adjoint", False):
            raise TFImportError(
                f"{ctx.node.name}: MatrixInverse adjoint=True "
                "not supported")
        return ctx.op("matrix_inverse", ctx.inputs[:1])

    @R("LinSpace")
    def _linspace(ctx):
        return ctx.op("linspace", [],
                      start=float(ctx.static_np(0)),
                      stop=float(ctx.static_np(1)),
                      num=int(ctx.static_np(2)))

    @R("Diag")
    def _tf_diag(ctx):
        p = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
        if p is None or len(p[0].shape) != 1:
            raise TFImportError(
                f"{ctx.node.name}: Diag mapped for rank-1 input only")
        return ctx.op("matrix_diag", ctx.inputs[:1])

    @R("DiagPart")
    def _tf_diag_part(ctx):
        p = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
        if p is None or len(p[0].shape) != 2:
            raise TFImportError(
                f"{ctx.node.name}: DiagPart mapped for rank-2 input "
                "only")
        return ctx.op("diag_part", ctx.inputs[:1])

    @R("Bincount", "DenseBincount")
    def _bincount(ctx):
        binary = bool(ctx.attr("binary_output", False))
        size = int(ctx.static_np(1))
        # weights may be RUNTIME-computed (only size must be static);
        # the no-weights case is an EMPTY tensor, detected by shape —
        # via the aval (works for traced tensors) or the const value
        has_w = False
        if len(ctx.inputs) > 2 and ctx.inputs[2] is not None:
            wv = ctx._static[2]
            p = ctx.avals.get(ctx.inputs[2].name) if ctx.avals else None
            if p is not None:
                has_w = int(np.prod(p[0].shape, dtype=np.int64)) > 0
            elif wv is not None:
                has_w = np.asarray(wv).size > 0
            else:
                # no static value and no aval: runtime-computed weights.
                # The NO-weights encoding is always a constant empty
                # tensor (caught above), so unknown => real weights.
                has_w = True
        if binary and has_w:
            raise TFImportError(
                f"{ctx.node.name}: binary_output with weights is "
                "undefined in TF as well")
        ins = [ctx.inputs[0]] + ([ctx.inputs[2]] if has_w else [])
        return ctx.op("bincount", ins, minlength=size,
                      binary_output=binary)

    @R("Bucketize")
    def _bucketize(ctx):
        bnd = np.asarray([float(v) for v in ctx.attr("boundaries")],
                         np.float32)
        c = ctx.sd.constant(f"{ctx.node.name}_boundaries", bnd)
        return ctx.op("searchsorted", [c, ctx.inputs[0]], side="right")


_register_standard_mappers()
_register_extended_mappers()


# The ops these mappers emit by TF's conventions (tf_strided_slice,
# tf_fill, erfc, ...) are registered in deeplearning4j_tpu_torch.ops
# .tf_compat, so that loading a saved imported graph needs no importer.
from deeplearning4j_tpu_torch.ops import tf_compat as _tf_compat  # noqa: E402,F401

OpMappingRegistry.register("Erfc")(
    lambda ctx: ctx.op("erfc", ctx.inputs[:1]))


def _register_round4_tail():
    R = OpMappingRegistry.register

    @R("Einsum")
    def _einsum(ctx):
        return ctx.op("einsum", ctx.inputs,
                      equation=ctx.attr("equation"))

    @R("MirrorPad")
    def _mirror_pad(ctx):
        mode = ctx.attr("mode", "REFLECT")  # _decode_attrs gives str
        pads = [[int(a), int(b)] for a, b in ctx.static_np(1)]
        return ctx.op("mirror_pad", ctx.inputs[:1], paddings=pads,
                      reflect=(mode == "REFLECT"))

    @R("Roll")
    def _roll(ctx):
        shift = [int(s) for s in np.atleast_1d(ctx.static_np(1))]
        axis = [int(a) for a in np.atleast_1d(ctx.static_np(2))]
        return ctx.op("roll", ctx.inputs[:1], shift=shift, axis=axis)

    @R("TensorScatterUpdate")
    def _tensor_scatter_update(ctx):
        return ctx.op("scatter_nd_update", ctx.inputs[:3])

    @R("TensorScatterAdd")
    def _tensor_scatter_add(ctx):
        return ctx.op("scatter_nd_add", ctx.inputs[:3])

    @R("PreventGradient")
    def _prevent_gradient(ctx):
        # inference-time identity (the gradient barrier only matters
        # to TF's own autodiff; our import differentiates the WHOLE
        # rebuilt graph, where stop_gradient is the closest analog)
        return ctx.op("stop_gradient", ctx.inputs[:1])

    @R("SparseSoftmaxCrossEntropyWithLogits")
    def _sparse_softmax_ce(ctx):
        # TF returns (loss_per_example, backprop); graphs consume #0
        return ctx.op("sparse_softmax_cross_entropy", ctx.inputs[:2])


_register_round4_tail()


# ------------------------------------------------- shape-subgraph folding
class _PartialEval:
    """Import-time abstract interpreter for SHAPE-COMPUTATION subgraphs.

    Real frozen graphs (e.g. a full BERT-base, SURVEY.md §3.4) compute
    reshape targets dynamically: Shape -> StridedSlice -> Pack/Prod ->
    Reshape, with the batch dim unknown. The reference's importer folds
    these through its own shape inference; here each node's value is
    evaluated as an int64 array with DYN marking unknown dims. Shapes
    come from TWO-PROBE abstract evaluation: the importer propagates
    meta-device shapes (``_shapes.eval_shape``) with every unknown (None)
    placeholder dim set to 2 in one probe and 3 in the other — a dim whose two probe
    values agree is static, one that differs is DYN. A folded value with
    no DYN is a plain constant; Reshape accepts exactly one DYN as -1.
    """

    def __init__(self):
        # provenance registry: sentinel value -> (tensor var name, dim)
        self.dyn_prov: Dict[int, Tuple[str, int]] = {}
        self._by_src: Dict[Tuple[str, int], int] = {}
        self._next = int(np.iinfo(np.int64).min) + 1000

    def _sentinel(self, var_name: str, dim: int) -> np.int64:
        key = (var_name, dim)
        if key not in self._by_src:
            self._by_src[key] = self._next
            self.dyn_prov[self._next] = key
            self._next += 1
        return np.int64(self._by_src[key])

    def eval(self, node, attrs, in_partials: List[Optional[np.ndarray]],
             in_shape_pairs: List[Optional[Tuple[tuple, tuple]]],
             in_var_names: List[str]) -> Optional[np.ndarray]:
        op = node.op
        try:
            if op == "Shape":
                pair = in_shape_pairs[0] if in_shape_pairs else None
                if pair is None:
                    return None
                s2, s3 = pair
                if len(s2) != len(s3):
                    return None
                return np.array(
                    [a if a == b else self._sentinel(in_var_names[0], i)
                     for i, (a, b) in enumerate(zip(s2, s3))],
                    np.int64)
            vals = in_partials

            def _int(v):
                return (v is not None
                        and np.asarray(v).dtype.kind in "iu")

            if op in ("Identity", "Snapshot", "StopGradient"):
                return vals[0] if _int(vals[0]) else None
            if op == "Cast":
                # only int->int casts keep a foldable value; a float
                # target would silently truncate if folded
                if _int(vals[0]) and str(attrs.get("DstT", "")).startswith(
                        ("int", "uint")):
                    return vals[0]
                return None
            if op in ("Add", "AddV2", "Sub", "Mul", "Maximum", "Minimum",
                      "FloorDiv"):
                a, b = vals[0], vals[1]
                if not (_int(a) and _int(b)):
                    return None
                a = np.asarray(a, np.int64)
                b = np.asarray(b, np.int64)
                fn = {"Add": np.add, "AddV2": np.add, "Sub": np.subtract,
                      "Mul": np.multiply, "Maximum": np.maximum,
                      "Minimum": np.minimum,
                      "FloorDiv": np.floor_divide}[op]
                out = fn(a, b)
                dyn = _is_dyn(a) | _is_dyn(b)
                out = np.where(np.broadcast_to(dyn, out.shape), DYN, out)
                return out.astype(np.int64)
            if op == "Pack":
                if not all(_int(v) for v in vals):
                    return None
                axis = int(attrs.get("axis", 0))
                return np.stack([np.asarray(v, np.int64) for v in vals],
                                axis=axis)
            if op == "ConcatV2":
                if not all(_int(v) for v in vals):
                    return None
                axis = int(np.asarray(vals[-1]))
                return np.concatenate(
                    [np.atleast_1d(np.asarray(v, np.int64))
                     for v in vals[:-1]], axis=axis)
            if op == "Prod":
                a, ax = vals[0], vals[1]
                if not (_int(a) and _int(ax)):
                    return None
                a = np.asarray(a, np.int64)
                if np.any(_is_dyn(a)):
                    return np.asarray(DYN)
                # axis=() is TF's identity reduction — keep it, don't
                # collapse to a full (axis=None) reduction
                return np.prod(a, axis=tuple(int(x) for x in
                                             np.atleast_1d(ax)),
                               keepdims=bool(attrs.get("keep_dims", False))
                               ).astype(np.int64)
            if op in ("GatherV2", "Gather"):
                a, idxs = vals[0], vals[1]
                if not (_int(a) and _int(idxs)):
                    return None
                axis = vals[2] if len(vals) > 2 else 0
                if int(attrs.get("batch_dims", 0)) != 0 or \
                        axis is None or int(np.asarray(axis)) != 0:
                    return None  # only axis-0, no batch_dims folding
                return np.take(np.asarray(a, np.int64),
                               np.asarray(idxs, np.int64), axis=0)
            if op == "Range":
                if any(not _int(v) or np.any(_is_dyn(v))
                       for v in vals[:3]):
                    return None
                return np.arange(int(vals[0]), int(vals[1]),
                                 int(vals[2]), dtype=np.int64)
            if op == "Squeeze":
                if not _int(vals[0]):
                    return None
                v = np.asarray(vals[0])
                dims = tuple(int(d) for d in
                             attrs.get("squeeze_dims",
                                       attrs.get("axis", [])) or ())
                if not dims:
                    return np.squeeze(v)
                try:  # axis on a non-unit dim: TF errors; don't fold
                    return np.squeeze(
                        v, axis=tuple(d % max(v.ndim, 1) for d in dims))
                except ValueError:
                    return None
            if op == "ExpandDims":
                if not (_int(vals[0]) and _int(vals[1])):
                    return None
                return np.expand_dims(np.asarray(vals[0], np.int64),
                                      int(vals[1]))
            if op == "StridedSlice":
                a = vals[0]
                if not _int(a) or any(
                        not _int(v) or np.any(_is_dyn(v))
                        for v in vals[1:4]):
                    # dynamic begin/end/stride sentinels would clamp to
                    # array bounds and fold a confidently wrong slice
                    return None
                a = np.atleast_1d(np.asarray(a, np.int64))
                if a.ndim != 1:
                    return None
                begin = np.atleast_1d(vals[1])
                end = np.atleast_1d(vals[2])
                strides = np.atleast_1d(vals[3])
                bm = int(attrs.get("begin_mask", 0))
                em = int(attrs.get("end_mask", 0))
                sm = int(attrs.get("shrink_axis_mask", 0))
                if int(attrs.get("ellipsis_mask", 0)) or \
                        int(attrs.get("new_axis_mask", 0)):
                    return None
                b = None if (bm & 1) else int(begin[0])
                e = None if (em & 1) else int(end[0])
                out = a[slice(b, e, int(strides[0]))]
                if sm & 1:
                    return out[0] if out.size else None
                return out
        except Exception:
            return None
        return None


# ----------------------------------------------------------------- import
class _Walker:
    """One import scope: the top-level GraphDef, a FunctionDef body, or
    a control-flow sub-graph. TF1 frames are reconstructed at import
    into while_loop/if_cond ops (``cf_import``)."""

    def __init__(self, sd: SameDiff, library=None, pe=None):
        self.sd = sd
        self.library = library or {}
        self.pe = pe
        # tensor key ("node" / "node:k") -> SDVariable
        self.tensors: Dict[str, SDVariable] = {}
        self.const_vals: Dict[str, np.ndarray] = {}
        # node name -> import-time folded value (may contain DYN)
        self.partials: Dict[str, np.ndarray] = {}
        # SDVariable name -> (aval under probe 2, probe 3)
        self.avals: Dict[str, Tuple[Aval, Aval]] = {}
        # tensor key -> {pred var name: branch value} (v1 Switch/Merge
        # lowering; a bool Switch uses 0/1, _SwitchN the branch int)
        self.branch_tags: Dict[str, Dict[str, Any]] = {}
        # pred var name -> "bool" (Switch) | "int" (_SwitchN index)
        self.pred_kinds: Dict[str, str] = {}
        self.nodes_by_name: Dict[str, Any] = {}

    # ------------------------------------------------------------ helpers
    @staticmethod
    def resolve(ref: str) -> Tuple[str, int]:
        if ":" in ref:
            name, idx = ref.rsplit(":", 1)
            return name, int(idx)
        return ref, 0

    def lookup(self, ref: str) -> SDVariable:
        src, idx = self.resolve(ref)
        key = f"{src}:{idx}" if idx else src
        if key not in self.tensors and f"{src}:{idx}" in self.tensors:
            key = f"{src}:{idx}"
        if key not in self.tensors:
            raise TFImportError(f"unresolved tensor ref {ref!r}")
        return self.tensors[key]

    def _propagate_avals(self, from_idx: int) -> None:
        """Two-probe abstract shape evaluation of the ops appended since
        ``from_idx`` (a mapper may emit several chained ops). Gated on
        ``pe``: ``importGraph`` enables it for graphs with shape
        sub-graphs, control flow or runtime indexing; control-flow
        sub-imports always have it."""
        if self.pe is None:
            return
        from deeplearning4j_tpu_torch.ops.registry import get_op

        for opnode in self.sd._ops[from_idx:]:
            fn = get_op(opnode.op_name)
            pair = []
            for probe in (0, 1):
                ins = []
                for iname in opnode.inputs:
                    if iname in self.avals:
                        ins.append(self.avals[iname][probe])
                    elif iname in self.sd._arrays:
                        a = self.sd._arrays[iname]
                        ins.append(Aval(tuple(a.shape), a.dtype))
                    else:
                        ins = None
                        break
                if ins is None:
                    pair = None
                    break
                try:
                    out = eval_shape(opnode.op_name, fn, ins, opnode.attrs)
                except Exception:       # noqa: BLE001 (no aval, as JAX)
                    pair = None
                    break
                pair.append(out)
            if pair is None:
                continue
            for k, on in enumerate(opnode.outputs):
                if k < len(pair[0]):
                    self.avals[on] = (pair[0][k], pair[1][k])

    def _gather_tags(self, node) -> Dict[str, bool]:
        """Union of branch tags over a node's data AND control inputs
        (v1 cond pipes branch constants to Merge with only a control
        edge from the branch pivot, so control edges carry tags too)."""
        tags: Dict[str, bool] = {}
        conflicted: set = set()
        for ref in node.input:
            key = ref
            if ref.startswith("^"):
                key = ref[1:]
            else:
                src, idx = self.resolve(ref)
                key = f"{src}:{idx}" if idx else src
                if key not in self.branch_tags and \
                        f"{src}:{idx}" in self.branch_tags:
                    key = f"{src}:{idx}"
            t = self.branch_tags.get(key)
            if t:
                for p, b in t.items():
                    if p in conflicted:
                        continue
                    if p in tags and tags[p] != b:
                        # both branches feed this node: it is post-merge
                        # or pred-side; the tag cancels STICKILY (a
                        # later same-pred input must not re-add it)
                        tags.pop(p)
                        conflicted.add(p)
                    else:
                        tags[p] = b
        return tags

    # --------------------------------------------------------------- walk
    def walk(self, nodes: Sequence[Any]) -> None:
        from deeplearning4j_tpu_torch.modelimport.tensorflow.cf_import \
            import plan_v1_frames

        for n in nodes:
            self.nodes_by_name.setdefault(n.name, n)
        skip, exit_map, plans = plan_v1_frames(self, nodes)
        emitted: Dict[str, Tuple[SDVariable, ...]] = {}
        for node in nodes:
            if node.name in exit_map:
                frame_key, var_idx = exit_map[node.name]
                if frame_key not in emitted:
                    emitted[frame_key] = plans[frame_key].emit(self)
                v = emitted[frame_key][var_idx]
                # downstream refs use the Exit node's name
                if node.name not in self.sd._vars:
                    old = v.name
                    v.rename(node.name)
                    if old in self.avals:
                        self.avals[node.name] = self.avals.pop(old)
                self.tensors[node.name] = v
                self.tensors[node.name + ":0"] = v
                continue
            if node.name in skip:
                continue
            self.process_node(node)

    def process_node(self, node) -> None:
        from deeplearning4j_tpu_torch.modelimport.tensorflow import cf_import
        from deeplearning4j_tpu_torch.ops.jax_rules import torch_dtype

        sd = self.sd
        attrs = _decode_attrs(node)
        if node.op in ("NoOp", "Assert"):
            # Assert: a runtime check consumed through control edges
            # only; the reference importer drops it as well
            return
        if node.op == "Const":
            val = graphdef_wire.make_ndarray(node.attr["value"].tensor)
            if isinstance(val, np.ndarray) and val.dtype.kind in "OSU":
                # string constants (Assert messages) stay on the host;
                # their only consumers are dropped check nodes
                self.const_vals[node.name] = val
                return
            v = sd.constant(node.name, val)
            if v.name != node.name:
                raise TFImportError(f"duplicate node name {node.name!r}")
            self.tensors[node.name] = v
            self.tensors[node.name + ":0"] = v
            if isinstance(val, np.ndarray):
                self.const_vals[node.name] = val
            arr = sd._arrays[v.name]
            aval = Aval(tuple(arr.shape), arr.dtype)
            self.avals[v.name] = (aval, aval)
            return
        if node.op in ("Placeholder", "PlaceholderWithDefault"):
            shape = attrs.get("shape")
            shape = [None if d in (-1, None) else int(d)
                     for d in shape] if shape else None
            v = sd.placeholder(node.name, shape=shape,
                               dtype=attrs.get("dtype", "float32"))
            self.tensors[node.name] = v
            self.tensors[node.name + ":0"] = v
            if shape is not None:
                dt = torch_dtype(attrs.get("dtype", "float32"))
                # distinct probe pairs PER DIM INDEX (dim i -> (2+2i,
                # 3+2i)) so two dynamic dims of one placeholder stay
                # distinguishable in resolve_dyn_dim; the same dim index
                # across placeholders shares a pair so elementwise ops
                # between placeholders still probe consistently
                self.avals[v.name] = tuple(
                    Aval(tuple(p + 2 * i if d is None else d
                               for i, d in enumerate(shape)), dt)
                    for p in (2, 3))
            return

        in_vars: List[SDVariable] = []
        statics: List[Optional[np.ndarray]] = []
        in_refs: List[Tuple[str, int]] = []
        for ref in node.input:
            if ref.startswith("^"):  # control edge: ordering only
                continue
            src, idx = self.resolve(ref)
            key = f"{src}:{idx}" if idx else src
            if key not in self.tensors and \
                    f"{src}:{idx}" in self.tensors:
                key = f"{src}:{idx}"
            if key not in self.tensors:
                raise TFImportError(
                    f"node {node.name}: unresolved input {ref!r}")
            in_vars.append(self.tensors[key])
            sv = self.const_vals.get(src) if idx == 0 else None
            if sv is None and idx == 0:
                sv = self.partials.get(src)
            if sv is None:
                # a runtime integer scalar/small vector (loop counter,
                # runtime begin index) becomes a DYN-valued partial so
                # shape/index sub-graphs fold around it and mappers with
                # a dynamic form (StridedSlice) can take it
                p = self.avals.get(self.tensors[key].name)
                if p is not None and p[0].shape == p[1].shape and \
                        _is_int_dtype(p[0].dtype) and \
                        len(p[0].shape) <= 1 and \
                        int(np.prod(p[0].shape, dtype=np.int64)) <= 16:
                    sv = np.full(p[0].shape, DYN, np.int64)
            statics.append(sv)
            in_refs.append((src, idx))

        # v1 cond lowering + functional (v2) control flow live in
        # cf_import; they need walker state, not just a _Ctx
        if node.op in cf_import.WALKER_OPS:
            mapper_trace.record("tf", node.op)
            n_before = len(sd._ops)
            cf_import.WALKER_OPS[node.op](self, node, in_vars, in_refs)
            self._propagate_avals(n_before)
            return

        if self.pe is not None:
            shape_pairs = []
            for v in in_vars:
                p = self.avals.get(v.name)
                shape_pairs.append(
                    (tuple(p[0].shape), tuple(p[1].shape))
                    if p is not None else None)
            pv = self.pe.eval(node, attrs, statics, shape_pairs,
                              [v.name for v in in_vars])
            if pv is not None:
                self.partials[node.name] = np.asarray(pv)

        mapper = OpMappingRegistry.get(node.op)
        ctx = _Ctx(sd, node, in_vars, statics, attrs, pe=self.pe,
                   avals=self.avals)
        n_ops_before = len(sd._ops)
        out = mapper(ctx)
        if isinstance(out, tuple):
            for k, v in enumerate(out):
                self.tensors[f"{node.name}:{k}"] = v
            self.tensors[node.name] = out[0]
        else:
            self.tensors[node.name] = out
            self.tensors[node.name + ":0"] = out
            # TF names the node's output after the node; align the
            # variable's name so sd.output(..., ["node_name"]) works
            if out.name != node.name:
                out.rename(node.name)
        self._propagate_avals(n_ops_before)
        tags = self._gather_tags(node)
        if tags:
            for key in ([node.name, node.name + ":0"] +
                        [f"{node.name}:{k}" for k in range(
                            1, len(out) if isinstance(out, tuple) else 1)]):
                self.branch_tags[key] = dict(tags)


class TFGraphMapper:
    """reference: TFGraphMapper#importGraph / ImportGraph.importGraph."""

    @staticmethod
    def importGraph(graph_def_or_path, device=None) -> SameDiff:
        """Import a frozen GraphDef (serialized bytes, a ``.pb`` path, a
        parsed :class:`graphdef_wire.GraphDef`, or any object with
        ``SerializeToString``) into a SameDiff graph on ``device`` (the
        CUDA card unless the caller names one).

        Placeholders become SameDiff placeholders; Consts become
        constants (``SameDiff.convertConstantsToVariables`` makes them
        trainable). TF1 Switch/Merge/Enter/Exit/NextIteration frames are
        reconstructed into while_loop/if_cond ops, and TF2 functional
        While/If/Case/PartitionedCall map through the graph's function
        library (``cf_import``)."""
        gd = TFGraphMapper._as_graph_def(graph_def_or_path)
        sd = SameDiff(device=device)
        library = {f.signature.name: f for f in gd.library.function} \
            if gd.library.function else {}
        # two-probe shape folding + aval tracking cost two meta runs per
        # node; enabled only where they can matter (shape sub-graphs,
        # control flow, runtime indexing)
        _PE_OPS = {"Shape", "Enter", "RefEnter", "While",
                   "StatelessWhile", "If", "StatelessIf",
                   "PartitionedCall", "StatefulPartitionedCall",
                   "Switch", "Merge", "StridedSlice",
                   # aval-consuming mappers
                   "Bincount", "DenseBincount", "Diag", "DiagPart"}
        all_nodes = list(gd.node)
        lib_nodes = [nd for f in library.values() for nd in f.node_def]
        needs_pe = any(n.op in _PE_OPS for n in all_nodes) or \
            any(n.op in _PE_OPS for n in lib_nodes)
        walker = _Walker(sd, library=library,
                         pe=_PartialEval() if needs_pe else None)
        walker.walk(all_nodes)
        return sd

    @staticmethod
    def _as_graph_def(src) -> graphdef_wire.GraphDef:
        if isinstance(src, graphdef_wire.GraphDef):
            return src
        if isinstance(src, (bytes, bytearray, memoryview)):
            return graphdef_wire.parse_graph_def(src)
        if isinstance(src, str):
            with open(src, "rb") as f:
                return graphdef_wire.parse_graph_def(f.read())
        if hasattr(src, "SerializeToString"):       # a protobuf message
            return graphdef_wire.parse_graph_def(src.SerializeToString())
        if hasattr(src, "as_graph_def"):            # a tf.Graph
            return graphdef_wire.parse_graph_def(
                src.as_graph_def().SerializeToString())
        raise TFImportError(f"cannot interpret {type(src)} as a GraphDef")


# Control-flow import (v1 frames, functional While/If, TensorArrays)
# registers its mappers on load; imported last so every name above is
# available to it.
from deeplearning4j_tpu_torch.modelimport.tensorflow import cf_import  # noqa: E402,F401
