"""ONNX ModelProto -> SameDiff: counterpart of
``deeplearning4j_tpu/modelimport/onnx/onnx_import.py`` (:1-1856).

A registry of per-ONNX-op mappers (``OnnxOpMappingRegistry``, JAX's 130
names) emits nodes of the port's registry ops into a ``SameDiff`` graph
on the card (or on ``device="cpu"``), which then runs op by op. The
mappers are JAX's, line for line: ONNX's NCHW layout is kept end to end,
each convolution and pool is bracketed by NCHW<->NHWC transposes into
the NHWC ops (on the card the transposes are views: the convolution
hands cuDNN the NCHW tensor it was given, no copy), inference batch norm
is decomposed, and the recurrent operators re-pack ONNX's gate orders
into the port's ``onnx_lstm_seq`` / ``onnx_gru_seq`` / ``onnx_rnn_seq``.

Where JAX takes a thing from ``jax``, the port has its own:

- an abstract value is a ``_shapes.Aval`` (shape, torch dtype) where JAX
  has a ``jax.ShapeDtypeStruct``, and each emitted op is run on
  ``device="meta"`` tensors where JAX calls ``jax.eval_shape``
  (``modelimport/_shapes.py``, shared with the TF importer). The inputs
  of that run are narrowed first (int64 to int32, float64 to float32), as
  JAX without x64 narrows them; an op that reads a value on the host
  fails there and drops its aval, as a concretising op fails JAX's trace;
- small integer and bool results (<= 256 elements) whose inputs are all
  import-time constants are folded by running the port's op on int64
  host tensors under ``jax_rules.x64()``, where JAX folds under
  ``jax.enable_x64()``: the exporters' INT64_MAX slice ends and
  Shape->Gather->Concat reshape chains survive;
- If and Loop lower onto the port's ``if_cond`` and ``while_loop``
  (``autodiff/control_flow.py``) with JAX's static trip-count derivation.

Initializers import as CONSTANTs; ``SameDiff.convertConstantsToVariables``
makes them trainable. No fallback: an unknown op raises
:class:`OnnxImportError` with JAX's message, a mapper that needs a
constant input raises where it is not one (:meth:`_Ctx.static_np`), and
an import on the card with no card raises (``device.resolve_device``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, SDVariable
from deeplearning4j_tpu_torch.modelimport import trace as mapper_trace
from deeplearning4j_tpu_torch.modelimport._shapes import Aval, eval_shape
from deeplearning4j_tpu_torch.modelimport.onnx.onnx_proto import (
    GraphProto, ModelProto, NodeProto, TensorProto, decode_model,
)
# the ONNX-semantics ops live with the op set (ops/onnx_compat.py)
from deeplearning4j_tpu_torch.ops import onnx_compat  # noqa: F401
from deeplearning4j_tpu_torch.ops.jax_rules import NARROW


class OnnxImportError(ValueError):
    pass


# Default-attribute semantics changed across opsets (Hardmax/Softmax
# axis, reduce axes, ...). importGraph stamps the model's ai.onnx opset
# here for the duration of the walk (sub-graph walks run inside the
# top-level walk, so one slot suffices); 13 = modern default when a
# mapper is driven outside importGraph (unit micro-graphs).
_ACTIVE_OPSET = 13

def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.zeros((), dt)).dtype


def _aval(arr) -> Aval:
    """The aval of a numpy array or tensor, in its own dtype (JAX's
    ``ShapeDtypeStruct`` of the array)."""
    if isinstance(arr, torch.Tensor):
        return Aval(tuple(arr.shape), arr.dtype)
    arr = np.asarray(arr)
    return Aval(tuple(arr.shape), _torch_dtype(arr.dtype))


class _Ctx:
    def __init__(self, sd: SameDiff, node: NodeProto,
                 inputs: List[Optional[SDVariable]],
                 static: List[Optional[np.ndarray]], avals=None):
        self.sd = sd
        self.node = node
        self.inputs = inputs
        self._static = static
        self.avals = avals  # var name -> _shapes.Aval

    @property
    def opset(self) -> int:
        return _ACTIVE_OPSET

    def attr(self, name: str, default=None):
        return self.node.attributes.get(name, default)

    def static_np(self, i: int) -> np.ndarray:
        v = self._static[i] if i < len(self._static) else None
        if v is None:
            raise OnnxImportError(
                f"node {self.node.name or self.node.op_type}: input {i} "
                "must be a constant/initializer (XLA static-shape "
                "discipline)")
        return v

    def maybe_static(self, i: int) -> Optional[np.ndarray]:
        return self._static[i] if i < len(self._static) else None

    def op(self, op_name: str, inputs: Sequence[SDVariable], n_out: int = 1,
           **attrs):
        return self.sd._op(op_name, [v.name for v in inputs], n_out=n_out,
                           **attrs)

    # NCHW <-> NHWC brackets for the conv/pool ops
    def to_nhwc(self, v: SDVariable) -> SDVariable:
        return self.op("transpose", [v], permute=[0, 2, 3, 1])

    def to_nchw(self, v: SDVariable) -> SDVariable:
        return self.op("transpose", [v], permute=[0, 3, 1, 2])


class OnnxOpMappingRegistry:
    _mappers: Dict[str, Callable[[_Ctx], Any]] = {}

    @classmethod
    def register(cls, *op_types: str):
        def deco(fn):
            for name in op_types:
                cls._mappers[name] = fn
            return fn
        return deco

    @classmethod
    def get(cls, op_type: str):
        try:
            fn = cls._mappers[op_type]
        except KeyError:
            raise OnnxImportError(
                f"no mapper for ONNX op {op_type!r} (have "
                f"{len(cls._mappers)}; add one via "
                "OnnxOpMappingRegistry.register)") from None
        mapper_trace.record("onnx", op_type)
        return fn

    @classmethod
    def coverage(cls) -> List[str]:
        return sorted(cls._mappers)


R = OnnxOpMappingRegistry.register


# ----------------------------------------------------------- elementwise
_UNARY = {
    "Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh", "Exp": "exp",
    "Log": "log", "Sqrt": "sqrt", "Abs": "abs", "Erf": "erf",
    "Floor": "floor", "Ceil": "ceil", "Round": "round", "Sign": "sign",
    "Softplus": "softplus", "Softsign": "softsign", "Sin": "sin",
    "Cos": "cos", "Tan": "tan", "Asin": "asin", "Acos": "acos",
    "Atan": "atan", "Sinh": "sinh", "Cosh": "cosh", "Mish": "mish",
    "Reciprocal": "reciprocal", "IsNaN": "isnan", "IsInf": "isinf",
}
for _onnx_name, _our in _UNARY.items():
    @R(_onnx_name)
    def _unary(ctx, _o=_our):
        return ctx.op(_o, ctx.inputs[:1])

_BINARY = {"Add": "add", "Sub": "sub", "Mul": "mul", "Div": "div",
           "Pow": "pow_pairwise"}
for _onnx_name, _our in _BINARY.items():
    @R(_onnx_name)
    def _binary(ctx, _o=_our):
        return ctx.op(_o, ctx.inputs[:2])

@R("Mod")
def _mod(ctx):
    # fmod=0 (default): python/floor semantics, sign follows divisor;
    # fmod=1: C fmod, sign follows dividend (the attr was previously
    # ignored — caught by the mapper battery)
    our = "fmod" if int(ctx.attr("fmod", 0)) else "mod"
    return ctx.op(our, ctx.inputs[:2])


# Min/Max are VARIADIC in ONNX (1..N inputs, numpy-broadcast fold) —
# truncating to 2 silently dropped inputs 3+ (caught by the mapper
# battery, tests/test_onnx_mapper_battery.py)
for _onnx_name, _our in (("Min", "min_pairwise"), ("Max", "max_pairwise")):
    @R(_onnx_name)
    def _minmax_n(ctx, _o=_our):
        out = ctx.inputs[0]
        for v in ctx.inputs[1:]:
            out = ctx.op(_o, [out, v])
        return out


@R("Neg")
def _neg(ctx):
    return ctx.op("rsub", ctx.inputs[:1] + [ctx.sd.constant_like(0.0)])


@R("Sum")
def _sum_n(ctx):
    out = ctx.inputs[0]
    for v in ctx.inputs[1:]:
        out = ctx.op("add", [out, v])
    return out


@R("LeakyRelu")
def _leaky(ctx):
    return ctx.op("leakyrelu", ctx.inputs[:1],
                  alpha=float(ctx.attr("alpha", 0.01)))


@R("Elu")
def _elu(ctx):
    return ctx.op("elu", ctx.inputs[:1], alpha=float(ctx.attr("alpha", 1.0)))


@R("Selu")
def _selu(ctx):
    return ctx.op("selu", ctx.inputs[:1])


@R("HardSigmoid")
def _hardsigmoid(ctx):
    # alpha/beta attrs (defaults 0.2/0.5) — the fixed-constant
    # `hardsigmoid` op only covers the default pair (caught by the
    # mapper battery)
    alpha = float(ctx.attr("alpha", 0.2))
    beta = float(ctx.attr("beta", 0.5))
    if (alpha, beta) == (0.2, 0.5):
        return ctx.op("hardsigmoid", ctx.inputs[:1])
    a = ctx.sd.constant(f"{ctx.node.output[0]}_hsa", np.float32(alpha))
    b = ctx.sd.constant(f"{ctx.node.output[0]}_hsb", np.float32(beta))
    ax = ctx.op("mul", [ctx.inputs[0], a])
    axb = ctx.op("add", [ax, b])
    return ctx.op("clip_by_value", [axb], lo=0.0, hi=1.0)


@R("Gelu")
def _gelu(ctx):
    return ctx.op("gelu", ctx.inputs[:1])


@R("ThresholdedRelu")
def _thresholded(ctx):
    return ctx.op("thresholdedrelu", ctx.inputs[:1],
                  theta=float(ctx.attr("alpha", 1.0)))


@R("Clip")
def _clip(ctx):
    lo = ctx.attr("min")
    hi = ctx.attr("max")
    if lo is None and len(ctx.inputs) > 1 and ctx.inputs[1] is not None:
        lo = float(ctx.static_np(1))
    if hi is None and len(ctx.inputs) > 2 and ctx.inputs[2] is not None:
        hi = float(ctx.static_np(2))
    return ctx.op("clip_by_value", ctx.inputs[:1],
                  lo=float(lo if lo is not None else -np.inf),
                  hi=float(hi if hi is not None else np.inf))


def _opset13_axis_family(ctx, opname):
    """Softmax/LogSoftmax/Hardmax share the opset-13 semantics change:
    >=13 is per-axis (default -1); <13 is default axis=1 with
    COERCE-TO-2D — the op runs over the flattened trailing dims
    [prod(:axis), prod(axis:)], materially different when >1 trailing
    dim (onnx Operators.md changelog)."""
    if ctx.opset >= 13:
        return ctx.op(opname, ctx.inputs[:1],
                      axis=int(ctx.attr("axis", -1)))
    axis = int(ctx.attr("axis", 1))
    aval = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
    if aval is None:
        if axis == -1:
            # coerce-to-2D over [prod(:-1), last] IS per-last-axis —
            # no shape needed for this one case
            return ctx.op(opname, ctx.inputs[:1], axis=-1)
        raise OnnxImportError(
            f"{ctx.node.name}: {ctx.node.op_type} at opset "
            f"{ctx.opset} < 13 uses coerce-to-2D semantics and needs "
            "a known input shape")
    shape = tuple(int(d) for d in aval.shape)
    if axis < 0:
        axis += len(shape)
    if axis == len(shape) - 1 or all(d == 1 for d in shape[axis:-1]):
        return ctx.op(opname, ctx.inputs[:1], axis=-1)
    rows = int(np.prod(shape[:axis], dtype=np.int64))
    cols = int(np.prod(shape[axis:], dtype=np.int64))
    flat = ctx.op("reshape", ctx.inputs[:1], shape=[rows, cols])
    out = ctx.op(opname, [flat], axis=-1)
    return ctx.op("reshape", [out], shape=list(shape))


@R("Softmax")
def _softmax(ctx):
    return _opset13_axis_family(ctx, "softmax")


@R("LogSoftmax")
def _log_softmax(ctx):
    return _opset13_axis_family(ctx, "log_softmax")


@R("PRelu")
def _prelu(ctx):
    return ctx.op("prelu", ctx.inputs[:2])


# ------------------------------------------------------------- matmul/fc
@R("MatMul")
def _matmul(ctx):
    return ctx.op("matmul", ctx.inputs[:2])


@R("Gemm")
def _gemm(ctx):
    a, b = ctx.inputs[0], ctx.inputs[1]
    alpha = float(ctx.attr("alpha", 1.0))
    beta = float(ctx.attr("beta", 1.0))
    out = ctx.op("matmul", [a, b],
                 transpose_a=bool(ctx.attr("transA", 0)),
                 transpose_b=bool(ctx.attr("transB", 0)))
    if alpha != 1.0:
        out = ctx.op("mul", [out, ctx.sd.constant_like(alpha)])
    if len(ctx.inputs) > 2 and ctx.inputs[2] is not None:
        c = ctx.inputs[2]
        if beta != 1.0:
            c = ctx.op("mul", [c, ctx.sd.constant_like(beta)])
        out = ctx.op("add", [out, c])
    return out


# ----------------------------------------------------------------- shape
@R("Identity")
def _identity(ctx):
    return ctx.op("add", [ctx.inputs[0], ctx.sd.constant_like(0.0)])


@R("Dropout")
def _dropout(ctx):
    # inference import: dropout is identity (reference does the same)
    return ctx.op("add", [ctx.inputs[0], ctx.sd.constant_like(0.0)])


@R("Reshape")
def _reshape(ctx):
    shape = [int(s) for s in ctx.static_np(1)]
    return ctx.op("onnx_reshape", ctx.inputs[:1], shape=shape)


@R("Transpose")
def _transpose(ctx):
    perm = ctx.attr("perm")
    if perm is None:
        raise OnnxImportError("Transpose without perm unsupported")
    return ctx.op("transpose", ctx.inputs[:1],
                  permute=[int(p) for p in perm])


@R("Flatten")
def _flatten(ctx):
    return ctx.op("onnx_flatten", ctx.inputs[:1],
                  axis=int(ctx.attr("axis", 1)))


@R("Concat")
def _concat(ctx):
    return ctx.op("concat", ctx.inputs, axis=int(ctx.attr("axis", 0)))


def _axes_attr_or_input(ctx, input_idx=1):
    """ONNX moved reduce/squeeze axes from an attribute (opset <13/18)
    to an optional tensor input; accept both, None when absent."""
    axes = ctx.attr("axes")
    if axes is None and len(ctx.inputs) > input_idx \
            and ctx.inputs[input_idx] is not None:
        axes = ctx.static_np(input_idx)
    # empty axes == absent axes == reduce over all (pre-opset-18 rule)
    return [int(a) for a in axes] if axes is not None and len(axes) else None


def _reduce_kwargs(ctx):
    return dict(dimensions=_axes_attr_or_input(ctx),
                keep_dims=bool(ctx.attr("keepdims", 1)))


@R("Squeeze")
def _squeeze(ctx):
    axes = _axes_attr_or_input(ctx)
    return ctx.op("squeeze", ctx.inputs[:1],
                  axis=tuple(axes) if axes else None)


@R("Unsqueeze")
def _unsqueeze(ctx):
    axes = ctx.attr("axes")
    if axes is None and len(ctx.inputs) > 1:
        axes = [int(a) for a in ctx.static_np(1)]
    out = ctx.inputs[0]
    for a in sorted(int(x) for x in axes):
        out = ctx.op("expand_dims", [out], axis=a)
    return out


@R("Gather")
def _gather(ctx):
    idx = ctx.maybe_static(1)
    if idx is not None:
        indices = ctx.sd.constant(
            f"{ctx.node.output[0]}_idx", idx.astype(np.int32))
    else:
        indices = ctx.inputs[1]
    return ctx.op("gather", [ctx.inputs[0], indices],
                  axis=int(ctx.attr("axis", 0)))


@R("Slice")
def _slice(ctx):
    if ctx.attr("starts") is not None:  # opset < 10: attrs
        starts = [int(v) for v in ctx.attr("starts")]
        ends = [int(v) for v in ctx.attr("ends")]
        axes = [int(v) for v in ctx.attr("axes",
                                         list(range(len(starts))))]
        steps = [1] * len(starts)
    else:
        starts = [int(v) for v in ctx.static_np(1)]
        ends = [int(v) for v in ctx.static_np(2)]
        axes = ([int(v) for v in ctx.static_np(3)]
                if len(ctx.inputs) > 3 and ctx.maybe_static(3) is not None
                else list(range(len(starts))))
        steps = ([int(v) for v in ctx.static_np(4)]
                 if len(ctx.inputs) > 4 and ctx.maybe_static(4) is not None
                 else [1] * len(starts))
    return ctx.op("onnx_slice", ctx.inputs[:1], starts=starts, ends=ends,
                  axes=axes, steps=steps)


@R("Tile")
def _tile(ctx):
    reps = [int(v) for v in ctx.static_np(1)]
    return ctx.op("tile", ctx.inputs[:1], reps=reps)


@R("Expand")
def _expand(ctx):
    # ONNX Expand is BIDIRECTIONAL numpy broadcasting: the requested
    # shape's 1-dims adopt the input's size (Expand([1,1,64],[2,1,1])
    # -> [2,1,64]) — plain broadcast_to rejects that form
    shape = [int(v) for v in ctx.static_np(1)]
    aval = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
    if aval is not None:
        ins = list(aval.shape)
        n = max(len(ins), len(shape))
        ins = [1] * (n - len(ins)) + ins
        req = [1] * (n - len(shape)) + shape
        shape = [max(a, b) for a, b in zip(ins, req)]
    return ctx.op("broadcast_to", ctx.inputs[:1], shape=shape)


@R("Pad")
def _pad(ctx):
    pads = ctx.attr("pads")
    if pads is None:
        pads = [int(v) for v in ctx.static_np(1)]
    mode = ctx.attr("mode", "constant")
    if mode != "constant":
        raise OnnxImportError(f"Pad mode {mode!r} unsupported")
    n = len(pads) // 2
    pairs = [[int(pads[i]), int(pads[i + n])] for i in range(n)]
    return ctx.op("pad", ctx.inputs[:1], paddings=pairs)


@R("Cast")
def _cast(ctx):
    to = int(ctx.attr("to", 1))
    np_dt = TensorProto._DTYPES.get(to, np.float32)
    return ctx.op("cast", ctx.inputs[:1], dtype=np.dtype(np_dt).name)


@R("Shape")
def _shape(ctx):
    """Static shapes fold to an import-time constant (real exporters
    emit Shape->Gather->Concat reshape subgraphs around attention; the
    whole chain folds via the importer's int-subgraph folding)."""
    aval = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
    if aval is None or any(d is None or d < 0 for d in aval.shape):
        raise OnnxImportError(
            f"{ctx.node.name or ctx.node.op_type}: Shape of a tensor "
            "with unknown dims — re-export with static shapes (XLA "
            "compiles static programs)")
    # opset >= 15: optional start/end attrs slice the shape vector;
    # spec rule: negative values add rank, then CLAMP to [0, rank]
    rank = len(aval.shape)

    def _clamp(v):
        v = int(v)
        if v < 0:
            v += rank
        return max(0, min(v, rank))

    start = _clamp(ctx.attr("start", 0))
    end = rank if ctx.attr("end") is None else _clamp(ctx.attr("end"))
    return ctx.sd.constant(ctx.node.output[0],
                           np.asarray(aval.shape[start:end], np.int64))


@R("Constant")
def _constant(ctx):
    val = ctx.attr("value")
    if val is None:
        val = np.asarray(ctx.attr("value_float", 0.0), np.float32)
    return ctx.sd.constant(ctx.node.output[0], np.asarray(val))


@R("ConstantOfShape")
def _constant_of_shape(ctx):
    # output dtype = the value tensor's dtype (spec; default f32 zero)
    # — torch's expand-shape idiom fills int64 ones and feeds the
    # result into shape arithmetic, so forcing f32 breaks const folding
    shape = [int(v) for v in ctx.static_np(0)]
    val = ctx.attr("value")
    if val is not None:
        v = np.asarray(val)
        arr = np.full(shape, v.ravel()[0], v.dtype)
    else:
        arr = np.zeros(shape, np.float32)
    return ctx.sd.constant(ctx.node.output[0], arr)


@R("Where")
def _where(ctx):
    return ctx.op("where", ctx.inputs[:3])


for _onnx_name, _our in {"Equal": "eq", "Greater": "gt", "Less": "lt",
                         "GreaterOrEqual": "gte",
                         "LessOrEqual": "lte"}.items():
    @R(_onnx_name)
    def _cmp(ctx, _o=_our):
        return ctx.op(_o, ctx.inputs[:2])


# ---------------------------------------------------------- reductions
_REDUCE = {"ReduceSum": "reduce_sum", "ReduceMean": "reduce_mean",
           "ReduceMax": "reduce_max", "ReduceMin": "reduce_min",
           "ReduceProd": "reduce_prod"}
for _onnx_name, _our in _REDUCE.items():
    @R(_onnx_name)
    def _reduce(ctx, _o=_our):
        return ctx.op(_o, ctx.inputs[:1], **_reduce_kwargs(ctx))


@R("ArgMax")
def _argmax(ctx):
    out = ctx.op("argmax", ctx.inputs[:1],
                 dimensions=int(ctx.attr("axis", 0)))
    if int(ctx.attr("keepdims", 1)):
        out = ctx.op("expand_dims", [out], axis=int(ctx.attr("axis", 0)))
    return out


# -------------------------------------------------------------- conv/pool
def _conv_padding_args(ctx, default_kernel=None):
    auto = ctx.attr("auto_pad", "NOTSET")
    pads = ctx.attr("pads")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        return "SAME", None
    if pads is None or not any(pads):
        return "VALID", None
    n = len(pads) // 2
    # [x1b, x2b, x1e, x2e] -> [(b,e), ...] per spatial dim
    return None, [(int(pads[i]), int(pads[i + n])) for i in range(n)]


def _explicit_pad_nhwc(ctx, v, spatial_pads):
    pairs = [[0, 0]] + [list(p) for p in spatial_pads] + [[0, 0]]
    return ctx.op("pad", [v], paddings=pairs)


@R("Conv")
def _conv(ctx):
    x = ctx.to_nhwc(ctx.inputs[0])
    w = ctx.inputs[1]                         # OIHW
    w = ctx.op("transpose", [w], permute=[2, 3, 1, 0])  # -> HWIO
    strides = [int(s) for s in ctx.attr("strides", [1, 1])]
    dil = [int(d) for d in ctx.attr("dilations", [1, 1])]
    group = int(ctx.attr("group", 1))
    pad_mode, spatial = _conv_padding_args(ctx)
    if spatial is not None:
        if len(spatial) == 2:
            # conv2d takes ((lo,hi),(lo,hi)) directly — no separate pad
            # node to rely on XLA re-fusing (pool padding semantics
            # differ, so _pool keeps the explicit pad op)
            pad_mode = tuple(tuple(p) for p in spatial)
        else:
            x = _explicit_pad_nhwc(ctx, x, spatial)
            pad_mode = "VALID"
    # ONNX OIHW weights transpose to (kH, kW, I/g, O) above — exactly
    # the grouped-HWIO layout conv2d's feature_group_count expects
    out = ctx.op("conv2d", [x, w], strides=strides, padding=pad_mode,
                 dilation=dil, groups=group)
    if len(ctx.inputs) > 2 and ctx.inputs[2] is not None:
        out = ctx.op("add", [out, ctx.inputs[2]])
    return ctx.to_nchw(out)


@R("MaxPool", "AveragePool")
def _pool(ctx):
    x = ctx.to_nhwc(ctx.inputs[0])
    kernel = [int(k) for k in ctx.attr("kernel_shape")]
    strides = [int(s) for s in ctx.attr("strides", kernel)]
    pad_mode, spatial = _conv_padding_args(ctx)
    if spatial is not None:
        x = _explicit_pad_nhwc(ctx, x, spatial)
        pad_mode = "VALID"
    op = "maxpool2d" if ctx.node.op_type == "MaxPool" else "avgpool2d"
    out = ctx.op(op, [x], kernel=kernel, strides=strides, padding=pad_mode)
    return ctx.to_nchw(out)


@R("GlobalAveragePool")
def _gap(ctx):
    out = ctx.op("reduce_mean", ctx.inputs[:1], dimensions=[2, 3],
                 keep_dims=True)
    return out


@R("GlobalMaxPool")
def _gmp(ctx):
    return ctx.op("reduce_max", ctx.inputs[:1], dimensions=[2, 3],
                  keep_dims=True)


@R("BatchNormalization")
def _bn(ctx):
    x, scale, bias, mean, var = ctx.inputs[:5]
    eps = float(ctx.attr("epsilon", 1e-5))
    # params are [C]; x is NCHW -> reshape params to [C,1,1] to broadcast
    def chan(v):
        return ctx.op("reshape", [v], shape=[-1, 1, 1])
    xm = ctx.op("sub", [x, chan(mean)])
    inv = ctx.op("rsqrt", [ctx.op(
        "add", [chan(var), ctx.sd.constant_like(eps)])])
    return ctx.op("add", [ctx.op("mul", [ctx.op("mul", [xm, inv]),
                                         chan(scale)]), chan(bias)])


@R("LRN")
def _lrn(ctx):
    x = ctx.to_nhwc(ctx.inputs[0])
    size = int(ctx.attr("size", 5))
    out = ctx.op("lrn", [x], depth_radius=size // 2,
                 bias=float(ctx.attr("bias", 1.0)),
                 alpha=float(ctx.attr("alpha", 1e-4)) / size,
                 beta=float(ctx.attr("beta", 0.75)))
    return ctx.to_nchw(out)


# ------------------------------------------------------- recurrent ops
# (ONNX LSTM/GRU/RNN — what torch.onnx.export emits for nn.LSTM/GRU/RNN
# and what keras/sklearn exporters emit with the reset-before GRU form;
# reference: samediff-import-onnx maps these onto nd4j's flexible
# lstmLayer, incl. cell clip / coupled gates / activations / ragged
# sequence lengths — SURVEY.md §2.14)
def _rnn_setup(ctx, n_gates, hidden):
    """Common decode: batch-major x, per-direction packed weights.
    ONNX tensor layout (layout=0): X [T,N,in]; W [dirs, gates*H, in];
    R [dirs, gates*H, H]; B [dirs, 2*gates*H] (Wb ++ Rb); layout=1
    swaps X to [N,T,in] and states/Y to batch-major. Weights must be
    constants (true for every real exporter; re-packed at import).

    Returns (x [N,T,in], W, R, B, dirs, layout, seq_lens_var, clip)."""
    clip = float(ctx.attr("clip", 0.0) or 0.0)
    layout = int(ctx.attr("layout", 0))
    W = ctx.static_np(1)
    R = ctx.static_np(2)
    dirs = W.shape[0]
    if len(ctx.inputs) > 3 and ctx.inputs[3] is not None:
        B = ctx.static_np(3)   # present-but-runtime bias must be LOUD,
        # not silently zeroed; static_np raises for non-constants
    else:
        B = np.zeros((dirs, 2 * n_gates * hidden), np.float32)
    seq_lens = None
    if len(ctx.inputs) > 4 and ctx.inputs[4] is not None:
        seq_lens = ctx.inputs[4]
        sl = ctx.maybe_static(4)
        p = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
        t_axis = 1 if layout else 0
        t = int(p.shape[t_axis]) if p is not None and p.shape else None
        if sl is not None and t is not None and sl.size \
                and np.all(sl == t):
            seq_lens = None  # full-length: skip the masking machinery
    x = ctx.inputs[0] if layout else \
        ctx.op("transpose", ctx.inputs[:1], permute=[1, 0, 2])
    return x, W, R, B, dirs, layout, seq_lens, clip


def _rnn_state(ctx, input_idx, d, layout=0):
    """initial_h/initial_c -> direction d's [N, H] (the state tensor is
    [dirs, N, H] for layout=0, [N, dirs, H] for layout=1)."""
    if len(ctx.inputs) <= input_idx or ctx.inputs[input_idx] is None:
        return None
    idx = ctx.sd.constant(f"{ctx.node.output[0]}_d{input_idx}_{d}",
                          np.int32(d))
    return ctx.op("gather", [ctx.inputs[input_idx], idx],
                  axis=1 if layout else 0)


def _rnn_acts(ctx, per_dir, dirs, defaults):
    """Parse activations/activation_alpha/activation_beta into per-
    direction lists of (name, alpha, beta) triples, or None when the
    attrs just restate the defaults (keeps the graph attr small)."""
    names = ctx.attr("activations")
    if not names:
        return None
    names = [n.decode() if isinstance(n, bytes) else str(n)
             for n in names]
    if [n.lower() for n in names] == [d.lower()
                                      for d in defaults] * dirs:
        return None
    alphas = list(ctx.attr("activation_alpha") or [])
    betas = list(ctx.attr("activation_beta") or [])
    if len(names) != per_dir * dirs:
        raise OnnxImportError(
            f"{ctx.node.name}: {len(names)} activations for "
            f"{dirs} direction(s) x {per_dir}")
    specs = [(names[i],
              float(alphas[i]) if i < len(alphas) else None,
              float(betas[i]) if i < len(betas) else None)
             for i in range(len(names))]
    return [specs[d * per_dir:(d + 1) * per_dir] for d in range(dirs)]


def _rnn_outputs(ctx, ys_list, states, layout=0):
    """Per-direction [N,T,H] outputs -> ONNX Y (+ final states).
    layout=0: Y [T, dirs, N, H], states [dirs, N, H];
    layout=1: Y [N, T, dirs, H], states [N, dirs, H]."""
    if layout:
        y = ctx.op("stack", ys_list, axis=2)
        outs = [y]
        for group in states:
            outs.append(ctx.op("stack", group, axis=1))
        return tuple(outs)
    ys_t = [ctx.op("transpose", [y], permute=[1, 0, 2])
            for y in ys_list]
    y = ctx.op("stack", ys_t, axis=1)
    outs = [y]
    for group in states:
        outs.append(ctx.op("stack", group, axis=0))
    return tuple(outs)


@R("LSTM")
def _onnx_lstm(ctx):
    hs = int(ctx.attr("hidden_size"))
    direction = ctx.attr("direction", "forward")
    x, W, R, B, dirs, layout, seq_lens, clip = _rnn_setup(ctx, 4, hs)
    acts_by_dir = _rnn_acts(ctx, 3, dirs, ["Sigmoid", "Tanh", "Tanh"])
    input_forget = bool(int(ctx.attr("input_forget", 0)))
    P = None
    if len(ctx.inputs) > 7 and ctx.inputs[7] is not None:
        P = ctx.static_np(7)   # peepholes [dirs, 3H] as (p_i, p_o, p_f)
    order = [0, 2, 3, 1]          # ONNX iofc -> our i,f,g(=c),o
    ys_list, h_list, c_list = [], [], []
    for d in range(dirs):
        w_ih = W[d].reshape(4, hs, -1)[order].reshape(4 * hs, -1).T
        w_hh = R[d].reshape(4, hs, hs)[order].reshape(4 * hs, hs).T
        b = (B[d][:4 * hs] + B[d][4 * hs:]) \
            .reshape(4, hs)[order].reshape(-1)
        base = f"{ctx.node.output[0]}_d{d}"
        ins = [x,
               ctx.sd.constant(base + "_wih", w_ih.astype(np.float32)),
               ctx.sd.constant(base + "_whh", w_hh.astype(np.float32)),
               ctx.sd.constant(base + "_b", b.astype(np.float32))]
        h0 = _rnn_state(ctx, 5, d, layout)
        c0 = _rnn_state(ctx, 6, d, layout)
        has_state = h0 is not None or c0 is not None
        if has_state:
            # ONNX allows either state alone (other defaults to zeros)
            if h0 is None:
                h0 = ctx.op("zeros_like", [c0])
            if c0 is None:
                c0 = ctx.op("zeros_like", [h0])
            ins += [h0, c0]
        if seq_lens is not None:
            ins.append(seq_lens)
        if P is not None:
            pi, po, pf = (P[d][:hs], P[d][hs:2 * hs], P[d][2 * hs:])
            ins.append(ctx.sd.constant(
                base + "_peep",
                np.stack([pi, pf, po]).astype(np.float32)))
        reverse = (direction == "reverse") or d == 1
        ys, hT, cT = ctx.op(
            "onnx_lstm_seq", ins, n_out=3, reverse=reverse,
            has_state=has_state, has_lens=seq_lens is not None,
            has_peep=P is not None, cell_clip=clip,
            input_forget=input_forget,
            acts=acts_by_dir[d] if acts_by_dir else None)
        ys_list.append(ys)
        h_list.append(hT)
        c_list.append(cT)
    return _rnn_outputs(ctx, ys_list, [h_list, c_list], layout)


@R("GRU")
def _onnx_gru(ctx):
    hs = int(ctx.attr("hidden_size"))
    direction = ctx.attr("direction", "forward")
    x, W, R, B, dirs, layout, seq_lens, clip = _rnn_setup(ctx, 3, hs)
    acts_by_dir = _rnn_acts(ctx, 2, dirs, ["Sigmoid", "Tanh"])
    lbr = bool(int(ctx.attr("linear_before_reset", 0)))
    order = [1, 0, 2]             # ONNX z,r,h -> our r,z,n
    ys_list, h_list = [], []
    for d in range(dirs):
        w_ih = W[d].reshape(3, hs, -1)[order].reshape(3 * hs, -1).T
        w_hh = R[d].reshape(3, hs, hs)[order].reshape(3 * hs, hs).T
        wb = B[d][:3 * hs].reshape(3, hs)[order].reshape(-1)
        rb = B[d][3 * hs:].reshape(3, hs)[order].reshape(-1)
        base = f"{ctx.node.output[0]}_d{d}"
        ins = [x,
               ctx.sd.constant(base + "_wih", w_ih.astype(np.float32)),
               ctx.sd.constant(base + "_whh", w_hh.astype(np.float32)),
               ctx.sd.constant(base + "_b", wb.astype(np.float32)),
               ctx.sd.constant(base + "_rb", rb.astype(np.float32))]
        h0 = _rnn_state(ctx, 5, d, layout)
        if h0 is not None:
            ins.append(h0)
        if seq_lens is not None:
            ins.append(seq_lens)
        reverse = (direction == "reverse") or d == 1
        ys, hT = ctx.op(
            "onnx_gru_seq", ins, n_out=2, reverse=reverse,
            has_state=h0 is not None, has_lens=seq_lens is not None,
            linear_before_reset=lbr, cell_clip=clip,
            acts=acts_by_dir[d] if acts_by_dir else None)
        ys_list.append(ys)
        h_list.append(hT)
    return _rnn_outputs(ctx, ys_list, [h_list], layout)


@R("RNN")
def _onnx_rnn(ctx):
    hs = int(ctx.attr("hidden_size"))
    direction = ctx.attr("direction", "forward")
    x, W, R, B, dirs, layout, seq_lens, clip = _rnn_setup(ctx, 1, hs)
    acts_by_dir = _rnn_acts(ctx, 1, dirs, ["Tanh"])
    ys_list, h_list = [], []
    for d in range(dirs):
        w_ih = W[d].T
        w_hh = R[d].T
        b = B[d][:hs] + B[d][hs:]
        base = f"{ctx.node.output[0]}_d{d}"
        ins = [x,
               ctx.sd.constant(base + "_wih", w_ih.astype(np.float32)),
               ctx.sd.constant(base + "_whh", w_hh.astype(np.float32)),
               ctx.sd.constant(base + "_b", b.astype(np.float32))]
        h0 = _rnn_state(ctx, 5, d, layout)
        if h0 is not None:
            ins.append(h0)
        if seq_lens is not None:
            ins.append(seq_lens)
        rev = (direction == "reverse") or d == 1
        ys, hT = ctx.op(
            "onnx_rnn_seq", ins, n_out=2, reverse=rev,
            has_state=h0 is not None, has_lens=seq_lens is not None,
            cell_clip=clip,
            acts=acts_by_dir[d] if acts_by_dir else None)
        ys_list.append(ys)
        h_list.append(hT)
    return _rnn_outputs(ctx, ys_list, [h_list], layout)


@R("LayerNormalization")
def _layer_norm(ctx):
    x, scale = ctx.inputs[0], ctx.inputs[1]
    bias = ctx.inputs[2] if len(ctx.inputs) > 2 else None
    eps = float(ctx.attr("epsilon", 1e-5))
    ins = [x, scale] + ([bias] if bias is not None else [])
    return ctx.op("layer_norm", ins, eps=eps)


# --------------------------------------------------- breadth (round 4)
@R("ArgMin")
def _argmin(ctx):
    return ctx.op("argmin", ctx.inputs[:1],
                  dimensions=int(ctx.attr("axis", 0)),
                  keep_dims=bool(ctx.attr("keepdims", 1)))


for _onnx_name, _our in {"And": "logical_and", "Or": "logical_or",
                         "Xor": "logical_xor"}.items():
    @R(_onnx_name)
    def _logic2(ctx, _o=_our):
        return ctx.op(_o, ctx.inputs[:2])


@R("Not")
def _logic_not(ctx):
    return ctx.op("logical_not", ctx.inputs[:1])


@R("Split")
def _split(ctx):
    axis = int(ctx.attr("axis", 0))
    n_out = len(ctx.node.output)
    sizes = ctx.attr("split")                       # opset < 13: attr
    if sizes is None and len(ctx.inputs) > 1 and ctx.inputs[1] is not None:
        sizes = [int(v) for v in ctx.static_np(1)]  # opset >= 13: input
    if sizes is None:
        return ctx.op("split", ctx.inputs[:1], n_out=n_out,
                      num_splits=n_out, axis=axis)
    sizes = [int(s) for s in sizes]
    if len(set(sizes)) == 1:
        return ctx.op("split", ctx.inputs[:1], n_out=n_out,
                      num_splits=n_out, axis=axis)
    return ctx.op("split_v", ctx.inputs[:1], n_out=n_out, sizes=sizes,
                  axis=axis)


@R("ConvTranspose")
def _conv_transpose(ctx):
    """Maps onto deconv2d (out = s*(in-1) + k - 2p): symmetric pads,
    no output_padding — the torch ConvTranspose2d export defaults."""
    if int(ctx.attr("group", 1)) != 1:
        raise OnnxImportError(
            f"{ctx.node.name}: grouped ConvTranspose not supported")
    if any(int(v) for v in ctx.attr("output_padding", []) or []):
        raise OnnxImportError(
            f"{ctx.node.name}: output_padding not supported")
    if any(int(d) != 1 for d in ctx.attr("dilations", []) or []):
        raise OnnxImportError(
            f"{ctx.node.name}: dilated ConvTranspose not supported")
    strides = [int(s) for s in ctx.attr("strides", [1, 1])]
    auto = ctx.attr("auto_pad", "NOTSET")
    if auto == "SAME_LOWER":
        raise OnnxImportError(
            f"{ctx.node.name}: ConvTranspose SAME_LOWER not supported "
            "(odd pad lands on the opposite side)")
    if auto == "SAME_UPPER":
        padding = "SAME"
    else:
        pads = [int(p) for p in ctx.attr("pads", [0, 0, 0, 0])]
        n = len(pads) // 2
        if pads[:n] != pads[n:]:
            raise OnnxImportError(
                f"{ctx.node.name}: asymmetric ConvTranspose pads not "
                "supported")
        padding = tuple(pads[:n]) if any(pads) else "VALID"
    x = ctx.to_nhwc(ctx.inputs[0])
    # ONNX W is (Cin, Cout, kH, kW) -> deconv2d wants (kH, kW, Cin, Cout);
    # ONNX/torch ConvTranspose is the GRADIENT of a forward conv, i.e.
    # correlation with the spatially FLIPPED kernel — lax.conv_transpose
    # (deconv2d) zero-inserts then correlates unflipped, so flip here
    w = ctx.op("transpose", [ctx.inputs[1]], permute=[2, 3, 0, 1])
    w = ctx.op("reverse", [w], dimensions=[0, 1])
    ins = [x, w] + ([ctx.inputs[2]] if len(ctx.inputs) > 2
                    and ctx.inputs[2] is not None else [])
    out = ctx.op("deconv2d", ins, strides=strides, padding=padding)
    return ctx.to_nchw(out)


def _resize_src_coords(out_size, in_size, coord, scale=None):
    """ONNX output-index -> continuous input coordinate per
    coordinate_transformation_mode (spec table, opset 11+).

    When the model provides a SCALE (not sizes), the spec transforms
    through 1/scale — which differs from in/out whenever
    out = floor(in*scale) truncates (e.g. in=3, scale=2.6 -> out=7,
    1/2.6 != 3/7); using the wrong ratio picks wrong source pixels."""
    i = np.arange(out_size, dtype=np.float64)
    ratio = (1.0 / scale) if scale is not None else in_size / out_size
    if coord == "asymmetric":
        return i * ratio
    if coord in ("half_pixel", "pytorch_half_pixel"):
        x = (i + 0.5) * ratio - 0.5
        if coord == "pytorch_half_pixel" and out_size == 1:
            x = np.zeros_like(x)
        return x
    if coord == "align_corners":
        if out_size == 1:
            return np.zeros_like(i)
        return i * (in_size - 1) / (out_size - 1)
    raise OnnxImportError(
        f"Resize coordinate_transformation_mode {coord!r} not supported")


def _nearest_round(x_orig, nearest_mode):
    if nearest_mode == "floor":
        return np.floor(x_orig)
    if nearest_mode == "ceil":
        return np.ceil(x_orig)
    if nearest_mode == "round_prefer_ceil":
        return np.floor(x_orig + 0.5)
    # spec default: round_prefer_floor (round-half-down)
    return np.ceil(x_orig - 0.5)


def _resize_axis_nearest(ctx, v, axis, in_size, out_size, coord,
                         nearest_mode, prefix, scale=None):
    x_orig = _resize_src_coords(out_size, in_size, coord, scale)
    idx = np.clip(_nearest_round(x_orig, nearest_mode),
                  0, in_size - 1).astype(np.int32)
    c = ctx.sd.constant(f"{prefix}_nidx{axis}", idx)
    return ctx.op("gather", [v, c], axis=axis)


def _resize_axis_linear(ctx, v, axis, in_size, out_size, coord, prefix,
                        ndim=4, scale=None):
    x_orig = np.clip(_resize_src_coords(out_size, in_size, coord, scale),
                     0, in_size - 1)
    lo = np.floor(x_orig)
    frac = (x_orig - lo).astype(np.float32)
    hi = np.minimum(lo + 1, in_size - 1).astype(np.int32)
    lo = lo.astype(np.int32)
    wshape = [1] * ndim
    wshape[axis] = out_size
    glo = ctx.op("gather", [v, ctx.sd.constant(f"{prefix}_llo{axis}", lo)],
                 axis=axis)
    ghi = ctx.op("gather", [v, ctx.sd.constant(f"{prefix}_lhi{axis}", hi)],
                 axis=axis)
    w1 = ctx.sd.constant(f"{prefix}_lw1{axis}",
                         (1.0 - frac).reshape(wshape))
    w2 = ctx.sd.constant(f"{prefix}_lw2{axis}", frac.reshape(wshape))
    return ctx.op("add", [ctx.op("mul", [glo, w1]),
                          ctx.op("mul", [ghi, w2])])


@R("Resize", "Upsample")
def _resize(ctx):
    """Exact per-coordinate-mode resize: nearest (all nearest_modes,
    asymmetric/half_pixel/align_corners) and linear (asymmetric incl.
    the opset-9 Upsample semantics, half_pixel, align_corners), lowered
    to static gather indices + separable lerp weights computed at
    import time (XLA static-shape discipline; the half_pixel linear
    case keeps the fused resize_bilinear kernel). Loud elsewhere
    (cubic, dynamic scales)."""
    mode = ctx.attr("mode", "nearest")
    # Upsample (opset <=9) predates coordinate_transformation_mode:
    # its fixed semantics are asymmetric coords + floor rounding
    if ctx.node.op_type == "Upsample":
        coord, nearest_mode = "asymmetric", "floor"
    else:
        coord = ctx.attr("coordinate_transformation_mode", "half_pixel")
        nearest_mode = ctx.attr("nearest_mode", "round_prefer_floor")
    # scales: Upsample/opset10 input 1; Resize opset>=11 input 2 (roi=1)
    scales = sizes = None
    if ctx.node.op_type == "Upsample":
        scales = ctx.static_np(1)
    else:
        s = ctx.maybe_static(2)
        if s is not None and np.asarray(s).size:
            scales = s
        elif len(ctx.inputs) > 3:
            sizes = ctx.static_np(3)
        else:
            raise OnnxImportError(
                f"{ctx.node.name}: Resize needs static scales or a "
                "sizes input (dynamic scales not importable)")

    aval = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
    if aval is None:
        raise OnnxImportError(
            f"{ctx.node.name}: Resize needs a known input shape")
    in_h, in_w = int(aval.shape[2]), int(aval.shape[3])
    sc_h = sc_w = None  # provided scale factors (None when sizes given)
    if sizes is not None:
        out_h, out_w = [int(v) for v in np.asarray(sizes).ravel()[2:]]
    else:
        sc = [float(v) for v in np.asarray(scales).ravel()]
        if len(sc) != 4 or sc[0] != 1 or sc[1] != 1:
            raise OnnxImportError(
                f"{ctx.node.name}: Resize scales must be [1,1,sH,sW]")
        # spec: output dim = floor(input_dim * scale); the coordinate
        # transform still uses 1/scale, NOT in/out (they differ when
        # the floor truncates)
        sc_h, sc_w = sc[2], sc[3]
        out_h = int(np.floor(in_h * sc_h))
        out_w = int(np.floor(in_w * sc_w))

    name = ctx.node.output[0]
    if mode == "nearest":
        # integer-upsample fast path: repeat equals exactly the two
        # diagonal pairs (asymmetric+floor, half_pixel+round_prefer_
        # floor) for WHOLE scale factors; the CROSS pairs differ (e.g.
        # half_pixel+floor at scale 2 picks [0,0,0,1], not repeat),
        # and a fractional provided scale (2.4 -> out%in==0 by luck)
        # must not silently become a plain repeat
        whole = (sc_h is None or sc_h == int(sc_h)) \
            and (sc_w is None or sc_w == int(sc_w)) \
            and out_h % in_h == 0 and out_w % in_w == 0
        if whole and (coord, nearest_mode) in (
                ("asymmetric", "floor"),
                ("half_pixel", "round_prefer_floor")):
            x = ctx.to_nhwc(ctx.inputs[0])
            out = ctx.op("upsampling2d", [x],
                         scale=(out_h // in_h, out_w // in_w))
            return ctx.to_nchw(out)
        v = _resize_axis_nearest(ctx, ctx.inputs[0], 2, in_h, out_h,
                                 coord, nearest_mode, name, sc_h)
        return _resize_axis_nearest(ctx, v, 3, in_w, out_w, coord,
                                    nearest_mode, name, sc_w)
    if mode == "linear":
        # the fused resize_bilinear kernel transforms through in/out;
        # valid only when that equals the spec ratio (sizes given, or
        # scales that divide exactly) and the coord mode is half_pixel
        exact_ratio = (sc_h is None or in_h * sc_h == out_h) \
            and (sc_w is None or in_w * sc_w == out_w)
        if exact_ratio and (
                coord == "half_pixel"
                or (coord == "pytorch_half_pixel"
                    and out_h > 1 and out_w > 1)):
            x = ctx.to_nhwc(ctx.inputs[0])
            out = ctx.op("resize_bilinear", [x], size=[out_h, out_w])
            return ctx.to_nchw(out)
        v = _resize_axis_linear(ctx, ctx.inputs[0], 2, in_h, out_h,
                                coord, name, scale=sc_h)
        return _resize_axis_linear(ctx, v, 3, in_w, out_w, coord, name,
                                   scale=sc_w)
    raise OnnxImportError(
        f"{ctx.node.name}: Resize mode {mode!r} not supported")


@R("InstanceNormalization")
def _instance_norm(ctx):
    x = ctx.to_nhwc(ctx.inputs[0])
    out = ctx.op("instance_norm", [x, ctx.inputs[1], ctx.inputs[2]],
                 eps=float(ctx.attr("epsilon", 1e-5)))
    return ctx.to_nchw(out)


@R("TopK")
def _topk(ctx):
    k = int(ctx.static_np(1).ravel()[0])
    axis = int(ctx.attr("axis", -1))
    largest = int(ctx.attr("largest", 1))
    aval = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
    rank = len(aval.shape) if aval is not None else None
    if axis not in (-1, (rank - 1 if rank else -1)):
        raise OnnxImportError(
            f"{ctx.node.name}: TopK on non-last axis not supported")
    x = ctx.inputs[0]
    if not largest:
        x = ctx.op("neg", [x])
    vals, idx = ctx.op("top_k", [x], n_out=2, k=k)
    if not largest:
        vals = ctx.op("neg", [vals])
    return vals, idx


@R("CumSum")
def _cumsum(ctx):
    axis = int(ctx.static_np(1).ravel()[0])
    return ctx.op("cumsum", ctx.inputs[:1], axis=axis,
                  exclusive=bool(ctx.attr("exclusive", 0)),
                  reverse=bool(ctx.attr("reverse", 0)))


@R("Range")
def _range(ctx):
    start, limit, delta = (ctx.static_np(i).ravel()[0] for i in range(3))
    if any(np.issubdtype(np.asarray(v).dtype, np.floating)
           for v in (start, limit, delta)):
        vals = np.arange(float(start), float(limit), float(delta),
                         dtype=np.float32)
    else:
        vals = np.arange(int(start), int(limit), int(delta),
                         dtype=np.int32)
    return ctx.sd.constant(ctx.node.output[0], vals)


@R("OneHot")
def _one_hot(ctx):
    depth = int(ctx.static_np(1).ravel()[0])
    values = np.asarray(ctx.static_np(2)).ravel()   # [off, on]
    ids = ctx.op("cast", ctx.inputs[:1], dtype="int32")
    return ctx.op("one_hot", [ids], depth=depth,
                  axis=int(ctx.attr("axis", -1)),
                  off_value=float(values[0]), on_value=float(values[1]))


@R("GatherND")
def _gather_nd(ctx):
    if int(ctx.attr("batch_dims", 0)) != 0:
        raise OnnxImportError(
            f"{ctx.node.name}: GatherND batch_dims != 0 not supported")
    return ctx.op("gather_nd", ctx.inputs[:2])


@R("GatherElements")
def _gather_elements(ctx):
    return ctx.op("take_along_axis", ctx.inputs[:2],
                  axis=int(ctx.attr("axis", 0)))


@R("ScatterND")
def _scatter_nd(ctx):
    if ctx.attr("reduction", "none") != "none":
        raise OnnxImportError(
            f"{ctx.node.name}: ScatterND reduction not supported")
    return ctx.op("scatter_nd_update", ctx.inputs[:3])


# ReduceL1/L2/LogSumExp have direct registered counterparts — extend
# the same axes-attr-or-input extraction the core _REDUCE loop uses
for _onnx_name, _our in {"ReduceL1": "reduce_norm1",
                         "ReduceL2": "reduce_norm2",
                         "ReduceLogSumExp": "reduce_logsumexp"}.items():
    @R(_onnx_name)
    def _reduce_direct(ctx, _o=_our):
        return ctx.op(_o, ctx.inputs[:1], **_reduce_kwargs(ctx))


@R("ReduceSumSquare", "ReduceLogSum")
def _reduce_composite(ctx):
    kw = _reduce_kwargs(ctx)
    x = ctx.inputs[0]
    if ctx.node.op_type == "ReduceSumSquare":
        return ctx.op("reduce_sum", [ctx.op("mul", [x, x])], **kw)
    return ctx.op("log", [ctx.op("reduce_sum", [x], **kw)])


@R("DepthToSpace", "SpaceToDepth")
def _d2s_s2d(ctx):
    if ctx.node.op_type == "DepthToSpace" \
            and ctx.attr("mode", "DCR") != "DCR":
        raise OnnxImportError(
            f"{ctx.node.name}: DepthToSpace CRD mode not supported")
    our = ("depth_to_space" if ctx.node.op_type == "DepthToSpace"
           else "space_to_depth")
    x = ctx.to_nhwc(ctx.inputs[0])
    out = ctx.op(our, [x], block_size=int(ctx.attr("blocksize")))
    return ctx.to_nchw(out)


@R("HardSwish")
def _hard_swish(ctx):
    return ctx.op("hard_swish", ctx.inputs[:1])


@R("Mish")
def _mish(ctx):
    return ctx.op("mish", ctx.inputs[:1])


@R("Trilu")
def _trilu(ctx):
    k = 0
    if len(ctx.inputs) > 1 and ctx.inputs[1] is not None:
        k = int(ctx.static_np(1).ravel()[0])
    our = "triu" if int(ctx.attr("upper", 1)) else "tril"
    return ctx.op(our, ctx.inputs[:1], k=k)


@R("Einsum")
def _einsum(ctx):
    return ctx.op("einsum", ctx.inputs,
                  equation=ctx.attr("equation"))


@R("ReverseSequence")
def _reverse_sequence(ctx):
    return ctx.op("reverse_sequence", ctx.inputs[:2],
                  seq_axis=int(ctx.attr("time_axis", 0)),
                  batch_axis=int(ctx.attr("batch_axis", 1)))


@R("Mean")
def _mean_nary(ctx):
    out = ctx.inputs[0]
    for v in ctx.inputs[1:]:
        out = ctx.op("add", [out, v])
    inv = ctx.sd.constant(f"{ctx.node.output[0]}_invn",
                          np.float32(1.0 / len(ctx.inputs)))
    return ctx.op("mul", [out, inv])


# ------------------------------------------------ breadth (round 4, pt 2)
@R("Celu")
def _celu(ctx):
    return ctx.op("celu", ctx.inputs[:1],
                  alpha=float(ctx.attr("alpha", 1.0)))


@R("Shrink")
def _shrink(ctx):
    return ctx.op("shrink", ctx.inputs[:1],
                  lambd=float(ctx.attr("lambd", 0.5)),
                  bias=float(ctx.attr("bias", 0.0)))


@R("Hardmax")
def _hardmax(ctx):
    return _opset13_axis_family(ctx, "hardmax")


@R("LpNormalization")
def _lp_normalization(ctx):
    axis = int(ctx.attr("axis", -1))
    p = int(ctx.attr("p", 2))
    if p == 2:
        return ctx.op("l2_normalize", ctx.inputs[:1], axis=axis)
    if p != 1:
        raise OnnxImportError(
            f"{ctx.node.name}: LpNormalization supports p=1 or 2, "
            f"got {p}")
    norm = ctx.op("reduce_sum", [ctx.op("abs", ctx.inputs[:1])],
                  dimensions=[axis], keep_dims=True)
    return ctx.op("div", [ctx.inputs[0], norm])


@R("MeanVarianceNormalization")
def _mvn(ctx):
    axes = ctx.attr("axes", [0, 2, 3])
    return ctx.op("mean_variance_norm", ctx.inputs[:1],
                  axes=tuple(int(a) for a in axes))


# ONNX TensorProto.DataType enum -> numpy (supported subset; unknown
# enums raise loudly per the importer's convention)
_EYE_DT = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
           5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
           10: np.float16, 11: np.float64, 12: np.uint32,
           13: np.uint64}


@R("EyeLike")
def _eye_like(ctx):
    aval = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
    if aval is None or len(aval.shape) != 2:
        raise OnnxImportError(
            f"{ctx.node.name}: EyeLike needs a known 2-D input shape")
    k = int(ctx.attr("k", 0))
    dt_attr = ctx.attr("dtype")
    # ONNX TensorProto.DataType enum; default = input dtype
    if dt_attr is not None:
        if int(dt_attr) not in _EYE_DT:
            raise OnnxImportError(
                f"{ctx.node.name}: EyeLike dtype enum {int(dt_attr)} "
                "not supported (loud-by-convention: silently casting "
                "would corrupt results)")
        dtype = _EYE_DT[int(dt_attr)]
    else:
        dtype = _np_dtype(aval.dtype)
    return ctx.sd.constant(
        ctx.node.output[0] + "_eye",
        np.eye(aval.shape[0], aval.shape[1], k, dtype=dtype))


@R("BitShift")
def _bit_shift(ctx):
    d = ctx.attr("direction")
    if d not in ("LEFT", "RIGHT"):
        raise OnnxImportError(
            f"{ctx.node.name}: BitShift direction must be LEFT/RIGHT")
    our = "shift_left" if d == "LEFT" else "shift_right"
    return ctx.op(our, ctx.inputs[:2])


@R("Det")
def _det(ctx):
    return ctx.op("matrix_determinant", ctx.inputs[:1])


@R("LpPool")
def _lp_pool(ctx):
    k = [int(v) for v in ctx.attr("kernel_shape")]
    strides = [int(v) for v in ctx.attr("strides", [1] * len(k))]
    pads = [int(v) for v in ctx.attr("pads", [0] * 2 * len(k))]
    dil = [int(v) for v in ctx.attr("dilations", [1] * len(k))]
    if any(pads) or int(ctx.attr("ceil_mode", 0)) \
            or any(d != 1 for d in dil):
        raise OnnxImportError(
            f"{ctx.node.name}: LpPool with explicit pads, ceil_mode or "
            "dilations not supported")
    p = int(ctx.attr("p", 2))
    x = ctx.to_nhwc(ctx.inputs[0])
    out = ctx.op("pnormpool2d", [x], kernel=tuple(k),
                 strides=tuple(strides), padding="VALID", p=p)
    return ctx.to_nchw(out)


@R("GlobalLpPool")
def _global_lp_pool(ctx):
    # spec: (sum |x|^p)^(1/p) over ALL dims from 2 on (N,C,spatial...)
    # — the ABS matters for odd p on negative inputs
    aval = ctx.avals.get(ctx.inputs[0].name) if ctx.avals else None
    if aval is None:
        raise OnnxImportError(
            f"{ctx.node.name}: GlobalLpPool needs a known input rank")
    p = int(ctx.attr("p", 2))
    powed = ctx.op("pow", [ctx.op("abs", ctx.inputs[:1]),
                           ctx.sd.constant(ctx.node.output[0] + "_p",
                                           np.float32(p))])
    s = ctx.op("reduce_sum", [powed],
               dimensions=list(range(2, len(aval.shape))), keep_dims=True)
    return ctx.op("pow", [s, ctx.sd.constant(
        ctx.node.output[0] + "_ip", np.float32(1.0 / p))])


@R("GridSample")
def _grid_sample(ctx):
    mode = ctx.attr("mode", "bilinear")
    if mode == "linear":  # opset-20 rename
        mode = "bilinear"
    pad = ctx.attr("padding_mode", "zeros")
    if mode not in ("bilinear", "nearest") or pad not in ("zeros",
                                                          "border"):
        raise OnnxImportError(
            f"{ctx.node.name}: GridSample mode={mode!r}/"
            f"padding_mode={pad!r} not supported")
    x = ctx.to_nhwc(ctx.inputs[0])
    out = ctx.op("grid_sample", [x, ctx.inputs[1]], mode=mode,
                 padding_mode=pad,
                 align_corners=bool(ctx.attr("align_corners", 0)))
    return ctx.to_nchw(out)


@R("DequantizeLinear")
def _dequantize_linear(ctx):
    ins = [v for v in ctx.inputs[:3] if v is not None]
    return ctx.op("dequantize_linear", ins,
                  axis=int(ctx.attr("axis", 1)))


@R("QuantizeLinear")
def _quantize_linear(ctx):
    ins = [v for v in ctx.inputs[:3] if v is not None]
    # output range follows the zero-point dtype (spec default uint8
    # when omitted); the dtype is knowable from avals even when the
    # value itself is not a static initializer
    zp_dtype = None
    zp = ctx.maybe_static(2)
    if zp is not None:
        zp_dtype = zp.dtype
    elif len(ctx.inputs) > 2 and ctx.inputs[2] is not None and ctx.avals:
        aval = ctx.avals.get(ctx.inputs[2].name)
        zp_dtype = _np_dtype(aval.dtype) if aval is not None else None
    qmin, qmax = (-128, 127) if zp_dtype == np.int8 else (0, 255)
    return ctx.op("quantize_linear", ins, axis=int(ctx.attr("axis", 1)),
                  qmin=qmin, qmax=qmax)


# ---------------------------------------------------------------- import
def _probe_aval(a: Aval) -> Aval:
    """An aval as JAX's ``eval_shape`` sees it without x64."""
    return Aval(a.shape, NARROW.get(a.dtype, a.dtype))


def _host_tensor(v) -> torch.Tensor:
    """An import-time constant as a host tensor in its own dtype (int64
    kept: the fold runs at JAX's x64)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def _host_array(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _propagate_onnx(sd, const_vals, avals, from_idx: int) -> None:
    """Shape/dtype eval for ops emitted since from_idx, plus eager
    folding of small integer results whose inputs are all import-time
    constants (the exporter's Shape->Gather->Concat reshape subgraphs
    become consts Reshape can consume)."""
    from deeplearning4j_tpu_torch.ops.jax_rules import on_device, x64
    from deeplearning4j_tpu_torch.ops.registry import get_op

    for opnode in sd._ops[from_idx:]:
        fn = get_op(opnode.op_name)
        ins = []
        for iname in opnode.inputs:
            if iname in avals:
                ins.append(_probe_aval(avals[iname]))
            elif iname in sd._arrays:
                ins.append(_probe_aval(_aval(sd._arrays[iname])))
            else:
                ins = None
                break
        if ins is None:
            continue
        try:
            outs = eval_shape(opnode.op_name, fn, ins, opnode.attrs)
        except Exception:       # noqa: BLE001 (no aval, as in JAX)
            continue
        for k, on in enumerate(opnode.outputs):
            if k < len(outs):
                avals[on] = outs[k]
        dt = outs[0].dtype
        if (len(opnode.outputs) == 1
                and (not (dt.is_floating_point or dt.is_complex))
                and int(np.prod(outs[0].shape, dtype=np.int64)) <= 256):
            # bools ride the int fold: shape-selection chains like
            # ConstantOfShape->Mul->Equal->Where (torch ViT's
            # expand-shape idiom) break without the Equal link
            vals = []
            for iname in opnode.inputs:
                v = const_vals.get(iname)
                if v is None and iname in sd._arrays:
                    v = _host_array(sd._arrays[iname])
                if v is None:
                    vals = None
                    break
                vals.append(v)
            if vals is not None:
                try:
                    # int64 kept: int32 would truncate the INT64_MAX
                    # slice-end sentinels flowing through these folds
                    # (-1 = drop-last-element)
                    with on_device("cpu"), x64(), torch.no_grad():
                        res = fn(*(_host_tensor(v) for v in vals),
                                 **opnode.attrs)
                    const_vals[opnode.outputs[0]] = _host_array(res)
                except Exception:       # noqa: BLE001 (no fold, as JAX)
                    pass


def _walk_onnx_nodes(sd, nodes, tensors, const_vals, avals,
                     resolve_outer=None) -> None:
    """The node walk, reusable for the top graph AND for If/Loop
    sub-graphs (resolve_outer supplies outer-scope captures — ONNX
    sub-graphs reference enclosing tensors by name)."""
    for node in nodes:
        ins: List[Optional[SDVariable]] = []
        statics: List[Optional[np.ndarray]] = []
        for ref in node.input:
            if ref == "":
                ins.append(None)
                statics.append(None)
                continue
            if ref not in tensors and resolve_outer is not None:
                v = resolve_outer(ref)
                if v is not None:
                    tensors[ref] = v
            if ref not in tensors:
                raise OnnxImportError(
                    f"node {node.name or node.op_type}: unresolved "
                    f"input {ref!r}")
            ins.append(tensors[ref])
            statics.append(const_vals.get(ref))
        if node.op_type in ("If", "Loop"):
            mapper_trace.record("onnx", node.op_type)
            handler = _handle_if if node.op_type == "If" else _handle_loop
            out = handler(sd, node, tensors, const_vals, avals, ins,
                          resolve_outer)
            n_ops_before = len(sd._ops)
        else:
            mapper = OnnxOpMappingRegistry.get(node.op_type)
            n_ops_before = len(sd._ops)
            out = mapper(_Ctx(sd, node, ins, statics, avals=avals))
        outs = out if isinstance(out, tuple) else (out,)
        for name, v in zip(node.output, outs):
            if v.name != name:
                v.rename(name)
            tensors[name] = v
            # track import-time-computable constants: Constant nodes
            # AND constants materialized by mappers (Shape). Constant
            # values come from the RAW proto attribute — sd._arrays
            # holds narrowed tensors, which truncate int64 to int32 and
            # would turn INT64_MAX slice sentinels into -1
            if node.op_type == "Constant":
                val = np.asarray(node.attributes.get("value"))
            elif v.name in sd._arrays:
                val = _host_array(sd._arrays[v.name])
            else:
                val = None
            if val is not None:
                const_vals.setdefault(name, val)
                avals[v.name] = _aval(val)
        _propagate_onnx(sd, const_vals, avals, n_ops_before)


def _import_onnx_subgraph(g, outer, capture_index, capture_base,
                          formal_start=0, parent_resolve=None,
                          build_dict=True, formal_avals=None,
                          outer_avals=None):
    """Import a GraphProto as a serialized sub-graph dict.

    outer = (tensors, const_vals) of the ENCLOSING scope; referenced
    outer names either bake in (constants) or become capture
    placeholders at slot capture_base + capture_index[name] — the
    SHARED capture_index lets If's two branches agree on operand
    order. formal_avals (aligned with g.inputs) and outer_avals (the
    enclosing scope's aval map, consulted for captures) seed shape
    inference inside the sub-graph — Loop scan outputs need the
    element shape to pre-allocate their stacked buffer. The sub-graph
    is traced on a CPU SameDiff: its dict runs on any device.
    Returns (dict, (sub, tensors, avals))."""
    from deeplearning4j_tpu_torch.autodiff.control_flow import (
        ARG_PREFIX, subgraph_to_dict,
    )

    o_tensors, o_consts = outer
    sub = SameDiff(device="cpu")
    tensors: Dict[str, SDVariable] = {}
    const_vals: Dict[str, np.ndarray] = {}
    avals: Dict[str, Any] = {}
    for k, vi in enumerate(g.inputs):
        ph = sub.placeholder(f"{ARG_PREFIX}{formal_start + k}")
        tensors[vi.name] = ph
        if formal_avals is not None and k < len(formal_avals) \
                and formal_avals[k] is not None:
            avals[ph.name] = formal_avals[k]
    for init in g.initializers:
        arr = init.to_numpy()
        const_vals[init.name] = arr
        tensors[init.name] = sub.constant(init.name, arr)

    def resolve_outer(ref):
        if ref not in o_tensors and ref not in o_consts \
                and parent_resolve is not None:
            # grand-outer reference (If inside Loop etc.): let the
            # enclosing scope capture it first, then capture from there
            pv = parent_resolve(ref)
            if pv is not None:
                o_tensors[ref] = pv
        if ref in o_consts:
            # outer constants bake in, so static-operand mappers
            # (axes, shapes) keep working inside the sub-graph
            arr = np.asarray(o_consts[ref])
            const_vals[ref] = arr
            return sub.constant(ref, arr)
        if ref in o_tensors:
            if ref not in capture_index:
                capture_index[ref] = len(capture_index)
            ph = sub.placeholder(
                f"{ARG_PREFIX}{capture_base + capture_index[ref]}")
            if outer_avals is not None:
                av = outer_avals.get(o_tensors[ref].name)
                if av is not None:
                    avals[ph.name] = av
            return ph
        return None

    _walk_onnx_nodes(sub, g.nodes, tensors, const_vals, avals,
                     resolve_outer)
    outs = []
    for o in g.outputs:
        if o.name not in tensors:
            raise OnnxImportError(
                f"sub-graph output {o.name!r} not produced")
        outs.append(tensors[o.name].name)
    if not build_dict:
        return None, (sub, tensors, avals)
    d = subgraph_to_dict(sub, outs, capture_base + len(capture_index))
    return d, (sub, tensors, avals)


def _handle_if(sd, node, tensors, const_vals, avals, ins,
               resolve_outer):
    """ONNX If → if_cond: branches have no formal inputs; every outer
    reference becomes a shared capture operand."""
    then_g = node.attributes.get("then_branch")
    else_g = node.attributes.get("else_branch")
    if then_g is None or else_g is None:
        raise OnnxImportError(f"{node.name or 'If'}: missing branch")
    caps: Dict[str, int] = {}
    outer = (tensors, const_vals)
    then_d, _ = _import_onnx_subgraph(then_g, outer, caps,
                                      capture_base=0,
                                      parent_resolve=resolve_outer,
                                      outer_avals=avals)
    else_d, _ = _import_onnx_subgraph(else_g, outer, caps,
                                      capture_base=0,
                                      parent_resolve=resolve_outer,
                                      outer_avals=avals)
    then_d["n_in"] = else_d["n_in"] = len(caps)
    ordered = sorted(caps, key=caps.get)
    operands = [ins[0].name] + [tensors[n].name for n in ordered]
    return sd._op("if_cond", operands, n_out=len(node.output),
                  name=node.output[0], true_graph=then_d,
                  false_graph=else_d)


def _handle_loop(sd, node, tensors, const_vals, avals, ins,
                 resolve_outer):
    """ONNX Loop → while_loop. State = (iter, cond, carried...,
    captures..., M, scan_buffers...).

    Scan outputs (per-iteration values stacked along a new axis 0) use
    the dense-TensorArray pattern: each becomes a pre-allocated
    ``[trips, *elem]`` buffer carried as loop state, written at the
    iteration index each step — which requires a STATICALLY BOUNDED
    loop, so scan outputs on a dynamically-terminated Loop stay a loud
    error, as in JAX. If the loop exits early, trailing rows keep their
    zero init (counted for-loops — the pattern every real exporter
    emits — are exact). A derived trip count makes the loop
    differentiable (``while_loop``'s ``max_trip_count``)."""
    from deeplearning4j_tpu_torch.autodiff.control_flow import (
        ARG_PREFIX, derive_trip_count, subgraph_to_dict,
    )

    body_g = node.attributes.get("body")
    if body_g is None:
        raise OnnxImportError(f"{node.name or 'Loop'}: missing body")
    carried = ins[2:]
    n_carried = len(carried)
    n_scan = len(node.output) - n_carried
    if n_scan < 0:
        raise OnnxImportError(
            f"{node.name or 'Loop'}: {len(node.output)} outputs < "
            f"{n_carried} carried values")
    n_formal = len(body_g.inputs)          # iter, cond, carried...
    if n_formal != 2 + n_carried:
        raise OnnxImportError(
            f"{node.name or 'Loop'}: body takes {n_formal} inputs, "
            f"expected {2 + n_carried}")
    if len(body_g.outputs) != 1 + n_carried + n_scan:
        raise OnnxImportError(
            f"{node.name or 'Loop'}: body returns "
            f"{len(body_g.outputs)} values, expected "
            f"{1 + n_carried + n_scan} (cond + carried + scan)")

    caps: Dict[str, int] = {}
    formal_avals = [Aval((), torch.int32), Aval((), torch.bool)]
    for v in carried:
        formal_avals.append(avals.get(v.name) if v is not None
                            else None)
    _, (sub, sub_tensors, sub_avals) = _import_onnx_subgraph(
        body_g, (tensors, const_vals), caps, capture_base=n_formal,
        parent_resolve=resolve_outer, build_dict=False,
        formal_avals=formal_avals, outer_avals=avals)
    n_caps = len(caps)
    m_slot = n_formal + n_caps             # trip count rides here
    n_state = m_slot + 1 + n_scan          # ... then scan buffers

    # body must return the FULL state: iter+1, cond_out, carried_out,
    # captures (pass-through), M (pass-through), buffers (written at
    # the CURRENT iteration index)
    it_ph = sub._vars[f"{ARG_PREFIX}0"]
    one = sub.constant("loop_one", np.int32(1))
    it_next = sub._op("add", [it_ph.name, one.name])
    body_outs = [it_next.name]
    for o in body_g.outputs[:1 + n_carried]:
        if o.name not in sub_tensors:
            raise OnnxImportError(
                f"Loop body output {o.name!r} not produced")
        body_outs.append(sub_tensors[o.name].name)
    for slot in range(n_formal, m_slot + 1):
        phn = f"{ARG_PREFIX}{slot}"
        if phn not in sub._vars:
            sub.placeholder(phn)
        body_outs.append(phn)
    scan_avals = []
    for k in range(n_scan):
        o = body_g.outputs[1 + n_carried + k]
        if o.name not in sub_tensors:
            raise OnnxImportError(
                f"Loop scan output {o.name!r} not produced")
        av = sub_avals.get(sub_tensors[o.name].name)
        if av is None:
            raise OnnxImportError(
                f"{node.name or 'Loop'}: cannot infer the element "
                f"shape of scan output {o.name!r} (needed to "
                "pre-allocate the stacked buffer)")
        scan_avals.append(av)
        buf_ph = sub.placeholder(f"{ARG_PREFIX}{m_slot + 1 + k}")
        written = sub._op("tensorarray_write",
                          [buf_ph.name, it_ph.name,
                           sub_tensors[o.name].name])
        body_outs.append(written.name)
    body_full = subgraph_to_dict(sub, body_outs, n_state)

    # cond: iter < M (when given) AND carried cond (when given)
    csub = SameDiff(device="cpu")
    c_it = csub.placeholder(f"{ARG_PREFIX}0")
    c_cond = csub.placeholder(f"{ARG_PREFIX}1")
    have_m = ins[0] is not None
    have_cond = ins[1] is not None
    if have_m:
        c_m = csub.placeholder(f"{ARG_PREFIX}{m_slot}")
        lt = csub._op("lt", [c_it.name, c_m.name])
    if have_m and have_cond:
        pred = csub._op("logical_and", [lt.name, c_cond.name])
    elif have_m:
        pred = lt
    elif have_cond:
        pred = csub._op("identity", [c_cond.name])
    else:
        raise OnnxImportError(
            f"{node.name or 'Loop'}: neither trip count nor condition")
    cond_full = subgraph_to_dict(csub, [pred.name], n_state)

    zero = sd.constant(f"{node.output[0]}_it0", np.int32(0))
    cond0 = ins[1] if have_cond else sd.constant(
        f"{node.output[0]}_cond0", np.bool_(True))
    m_opnd = ins[0] if have_m else sd.constant(
        f"{node.output[0]}_m0", np.int32(0))
    m_const = None
    if have_m:
        mv = const_vals.get(node.input[0])
        if mv is not None and int(np.asarray(mv)) >= 2 ** 31 - 1:
            # "run forever" trip count (torch exports INT64_MAX for
            # cond-driven while loops) — int32 truncation would turn
            # it into -1 and the loop would never run
            m_opnd = sd.constant(f"{node.output[0]}_minf",
                                 np.int32(2 ** 31 - 2))
        elif mv is not None:
            m_const = np.int32(mv)
    # static trip-count derivation makes the loop train: constant M
    # bounds it directly; torch `while i < N` exports bound it through
    # the carried cond recomputed in the body
    init_consts = [np.int32(0),
                   const_vals.get(node.input[1]) if have_cond
                   else np.bool_(True)]
    init_consts += [const_vals.get(r) for r in node.input[2:]]
    init_consts += [None] * len(caps)
    init_consts += [m_const]
    init_consts += [None] * n_scan
    trips = derive_trip_count(cond_full, body_full, init_consts)
    if n_scan and trips is None:
        raise OnnxImportError(
            f"{node.name or 'Loop'}: scan outputs need a statically "
            "bounded loop (XLA allocates the stacked buffer at compile "
            "time) — this Loop's trip count could not be derived "
            "(dynamic termination)")
    buf_names = []
    for k, av in enumerate(scan_avals):
        buf = sd.constant(
            f"{node.output[0]}_scanbuf{k}",
            np.zeros((trips,) + tuple(av.shape), _np_dtype(av.dtype)))
        buf_names.append(buf.name)
    operands = ([zero.name, cond0.name]
                + [v.name for v in carried]
                + [tensors[n].name
                   for n in sorted(caps, key=caps.get)]
                + [m_opnd.name] + buf_names)
    out = sd._op("while_loop", operands, n_out=n_state,
                 name=node.output[0] + "_state", cond_graph=cond_full,
                 body_graph=body_full, max_trip_count=trips)
    out = out if isinstance(out, tuple) else (out,)
    return tuple([out[2 + i] for i in range(n_carried)]
                 + [out[m_slot + 1 + k] for k in range(n_scan)])


class OnnxImport:
    """Entry point (reference: OnnxFrameworkImporter#runImport)."""

    @staticmethod
    def importGraph(model_or_path, device=None) -> SameDiff:
        """Import an ONNX model (serialized bytes, a ``.onnx`` path or a
        decoded :class:`ModelProto`) into a SameDiff graph on ``device``
        (the CUDA card unless the caller names one). Initializers become
        constants, graph inputs placeholders; a placeholder with an
        unknown dimension gets no aval, as in JAX."""
        model = OnnxImport._as_model(model_or_path)
        g: GraphProto = model.graph
        global _ACTIVE_OPSET
        saved_opset = _ACTIVE_OPSET
        sd = SameDiff(device=device)
        tensors: Dict[str, SDVariable] = {}
        const_vals: Dict[str, np.ndarray] = {}
        # var name -> Aval: everything is static (no dynamic_axes), so
        # one abstract eval per op gives Shape folding + int-subgraph
        # constant folding for free
        avals: Dict[str, Any] = {}

        for init in g.initializers:
            arr = init.to_numpy()
            const_vals[init.name] = arr
            tensors[init.name] = sd.constant(init.name, arr)
            avals[init.name] = _aval(arr)
        init_names = {i.name for i in g.initializers}
        for vi in g.inputs:
            if vi.name in init_names:
                continue
            shape = [d if d is not None else -1 for d in vi.shape]
            tensors[vi.name] = sd.placeholder(vi.name, shape=shape or None)
            if shape and all(d >= 0 for d in shape):
                dt = TensorProto._DTYPES.get(vi.elem_type, np.float32)
                avals[vi.name] = Aval(tuple(shape), _torch_dtype(dt))

        try:
            _ACTIVE_OPSET = int(model.opset_version) or 13
            _walk_onnx_nodes(sd, g.nodes, tensors, const_vals, avals)
        finally:
            _ACTIVE_OPSET = saved_opset
        return sd

    @staticmethod
    def _as_model(src) -> ModelProto:
        if isinstance(src, ModelProto):
            return src
        if isinstance(src, bytes):
            return decode_model(src)
        if isinstance(src, str):
            with open(src, "rb") as f:
                return decode_model(f.read())
        raise OnnxImportError(f"cannot interpret {type(src)} as ONNX model")


__all__ = ["OnnxImport", "OnnxOpMappingRegistry", "OnnxImportError"]
