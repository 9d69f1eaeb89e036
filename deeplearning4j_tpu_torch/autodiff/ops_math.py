"""Math, reduction and shape ops for the graph engine: counterpart of the
part of ``deeplearning4j_tpu/autodiff/ops_math.py`` that ``SDVariable``'s
operators and reductions emit (``samediff.py:103-206``), registered under
the same names with the same attributes (``dimensions=``,
``keep_dims=``), as plain functions on torch tensors.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ndarray.dtypes import DataType
from deeplearning4j_tpu_torch.ops.registry import register_op


# ---------------------------------------------------------------- binary
@register_op("add")
def add(x, y):
    return torch.add(x, y)


@register_op("sub")
def sub(x, y):
    return torch.sub(x, y)


@register_op("mul")
def mul(x, y):
    return torch.mul(x, y)


@register_op("div")
def div(x, y):
    return torch.div(x, y)


@register_op("rsub")
def rsub(x, y):
    return torch.sub(y, x)


@register_op("rdiv")
def rdiv(x, y):
    return torch.div(y, x)


@register_op("pow_pairwise")
def pow_pairwise(x, y):
    return torch.pow(x, y)


@register_op("matmul")
def matmul(x, y, transpose_a=False, transpose_b=False):
    if transpose_a:
        x = torch.swapaxes(x, -1, -2)
    if transpose_b:
        y = torch.swapaxes(y, -1, -2)
    return torch.matmul(x, y)


@register_op("gt")
def gt(x, y):
    return torch.gt(x, y)


@register_op("gte")
def gte(x, y):
    return torch.ge(x, y)


@register_op("lt")
def lt(x, y):
    return torch.lt(x, y)


@register_op("lte")
def lte(x, y):
    return torch.le(x, y)


# ----------------------------------------------------------------- unary
@register_op("neg")
def neg(x):
    return torch.neg(x)


@register_op("identity")
def identity(x):
    return x


@register_op("cast")
def cast(x, dtype):
    return x.to(DataType.from_any(dtype).torch)


# ---------------------------------------------------------------- reduce
def _reduce(fn, x, dimensions, keep_dims, **kw):
    """``fn(x, dim=..., keepdim=...)`` over ``dimensions`` (None: all)."""
    if dimensions is None:
        dimensions = tuple(range(x.dim()))
    elif isinstance(dimensions, int):
        dimensions = (dimensions,)
    return fn(x, dim=tuple(dimensions), keepdim=keep_dims, **kw)


@register_op("reduce_sum")
def reduce_sum(x, dimensions=None, keep_dims=False):
    return _reduce(torch.sum, x, dimensions, keep_dims)


@register_op("reduce_mean")
def reduce_mean(x, dimensions=None, keep_dims=False):
    return _reduce(torch.mean, x, dimensions, keep_dims)


@register_op("reduce_max")
def reduce_max(x, dimensions=None, keep_dims=False):
    return _reduce(torch.amax, x, dimensions, keep_dims)


@register_op("reduce_min")
def reduce_min(x, dimensions=None, keep_dims=False):
    return _reduce(torch.amin, x, dimensions, keep_dims)


@register_op("reduce_std")
def reduce_std(x, dimensions=None, keep_dims=False, bias_corrected=True):
    return _reduce(torch.std, x, dimensions, keep_dims,
                   correction=1 if bias_corrected else 0)


@register_op("reduce_norm2")
def reduce_norm2(x, dimensions=None, keep_dims=False):
    return torch.sqrt(_reduce(torch.sum, x * x, dimensions, keep_dims))


@register_op("argmax")
def argmax(x, dimensions=0, keep_dims=False):
    return torch.argmax(x, dim=dimensions, keepdim=keep_dims)


# ----------------------------------------------------------------- shape
@register_op("reshape")
def reshape(x, shape, copy_dims=None):
    """Reshape; ``copy_dims`` maps target positions to input dims whose
    extent is substituted there."""
    shape = list(shape)
    if copy_dims:
        for pos, src in copy_dims.items():
            shape[int(pos)] = x.shape[int(src)]
    return torch.reshape(x, tuple(shape))


@register_op("transpose")
def transpose(x, permute=None):
    if permute is None:
        permute = tuple(reversed(range(x.dim())))
    return x.permute(*permute)
