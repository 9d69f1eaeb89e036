"""Math, reduction and shape ops for the graph engine: counterpart of
``deeplearning4j_tpu/autodiff/ops_math.py``, every name it registers,
with the same attributes (``dimensions=``, ``keep_dims=``, ...) and
defaults, as plain functions on torch tensors. JAX's rules for types,
axes and out-of-range indices come from ``ops/jax_rules.py``.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import (jax_float_input,
                                                      jax_int_result)
from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op
from deeplearning4j_tpu_torch.ops.transforms import jax_abs


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
    """``x.astype(dtype)``: a 64-bit type narrows, as JAX without x64
    makes it (:func:`jax_rules.torch_dtype`)."""
    return x.to(jr.torch_dtype(dtype))


# ---------------------------------------------------------------- reduce
def _reduce(fn, x, dimensions, keep_dims, **kw):
    """``fn(x, dim=..., keepdim=...)`` over ``dimensions``, read as JAX's
    ``_axes`` reads them: None is every axis, an empty list or tuple is
    none (torch would take an empty ``dim`` as every axis, so ``fn`` then
    reduces an added axis of one element). An integer sum comes back in
    JAX's type (:func:`jax_int_result`)."""
    if dimensions is None:
        dimensions = tuple(range(x.dim()))
    elif isinstance(dimensions, int):
        dimensions = (dimensions,)
    if len(dimensions) == 0:
        out = fn(x.unsqueeze(-1), dim=-1, keepdim=False, **kw)
    else:
        out = fn(x, dim=tuple(dimensions), keepdim=keep_dims, **kw)
    return jax_int_result(out, x)


@register_op("reduce_sum")
def reduce_sum(x, dimensions=None, keep_dims=False):
    return _reduce(torch.sum, x, dimensions, keep_dims)


@register_op("reduce_mean")
def reduce_mean(x, dimensions=None, keep_dims=False):
    return _reduce(torch.mean, jax_float_input(x), dimensions, keep_dims)


@register_op("reduce_max")
def reduce_max(x, dimensions=None, keep_dims=False):
    return _reduce(torch.amax, x, dimensions, keep_dims)


@register_op("reduce_min")
def reduce_min(x, dimensions=None, keep_dims=False):
    return _reduce(torch.amin, x, dimensions, keep_dims)


@register_op("reduce_std")
def reduce_std(x, dimensions=None, keep_dims=False, bias_corrected=True):
    return _reduce(torch.std, jax_float_input(x), dimensions, keep_dims,
                   correction=1 if bias_corrected else 0)


@register_op("reduce_norm2")
def reduce_norm2(x, dimensions=None, keep_dims=False):
    return torch.sqrt(_reduce(torch.sum, x * x, dimensions, keep_dims))


@register_op("argmax")
def argmax(x, dimensions=0, keep_dims=False):
    return torch.argmax(x, dim=dimensions, keepdim=keep_dims).to(torch.int32)


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


@register_op("floordiv")
def floordiv(x, y):
    """``jnp.floor_divide``: rounds toward minus infinity."""
    return torch.div(x, y, rounding_mode="floor")


@register_op("mod")
def mod(x, y):
    """``jnp.mod``: the result takes the divisor's sign (Python's rule,
    ``torch.remainder``; not ``fmod``)."""
    return torch.remainder(x, y)


@register_op("squared_difference")
def squared_difference(x, y):
    d = torch.sub(x, y)
    return d * d


@register_op("tensordot")
def tensordot(x, y, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(int(i) for i in a) for a in axes)
    return torch.tensordot(x, y, dims=axes)


@register_op("batch_mmul")
def batch_mmul(x, y):
    return torch.matmul(x, y)


# ----------------------------------------------------------- comparisons
@register_op("eq")
def eq(x, y):
    return torch.eq(x, y)


@register_op("neq")
def neq(x, y):
    return torch.ne(x, y)


@register_op("where")
def where(cond, x, y):
    return torch.where(jr.as_tensor(cond).to(torch.bool), x, y)


@register_op("logical_and")
def logical_and(x, y):
    return torch.logical_and(x, y)


@register_op("logical_or")
def logical_or(x, y):
    return torch.logical_or(x, y)


@register_op("logical_not")
def logical_not(x):
    return torch.logical_not(x)


@register_op("logical_xor")
def logical_xor(x, y):
    return torch.logical_xor(x, y)


# ----------------------------------------------------------------- unary
@register_op("stop_gradient")
def stop_gradient(x):
    return x.detach()


def _cum(fn, x, axis, exclusive, reverse, one):
    """``jnp.cumsum`` / ``cumprod`` with TF's flags: ``exclusive`` shifts
    by one (no division, which zeros would poison), ``reverse`` runs from
    the end. Integers and booleans accumulate in int32."""
    if not x.is_floating_point():
        x = x.to(torch.int32)
    if reverse:
        x = torch.flip(x, (axis,))
    if exclusive:
        pad = list(x.shape)
        pad[axis] = 1
        x = torch.cat([torch.full(pad, one, dtype=x.dtype, device=x.device),
                       x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    out = fn(x, dim=axis, dtype=x.dtype)
    if reverse:
        out = torch.flip(out, (axis,))
    return out


@register_op("cumsum")
def cumsum(x, axis=0, exclusive=False, reverse=False):
    return _cum(torch.cumsum, x, axis, exclusive, reverse, 0)


@register_op("cumprod")
def cumprod(x, axis=0, exclusive=False, reverse=False):
    return _cum(torch.cumprod, x, axis, exclusive, reverse, 1)


# ---------------------------------------------------------------- reduce
@register_op("reduce_prod")
def reduce_prod(x, dimensions=None, keep_dims=False):
    return jr.reduce_over(jr.prod, x, dimensions, keep_dims)


@register_op("reduce_var")
def reduce_var(x, dimensions=None, keep_dims=False, bias_corrected=True):
    return _reduce(torch.var, jax_float_input(x), dimensions, keep_dims,
                   correction=1 if bias_corrected else 0)


@register_op("reduce_norm1")
def reduce_norm1(x, dimensions=None, keep_dims=False):
    return _reduce(torch.sum, jax_abs(x), dimensions, keep_dims)


@register_op("reduce_norm_max")
def reduce_norm_max(x, dimensions=None, keep_dims=False):
    return _reduce(torch.amax, jax_abs(x), dimensions, keep_dims)


@register_op("reduce_logsumexp")
def reduce_logsumexp(x, dimensions=None, keep_dims=False):
    return _reduce(torch.logsumexp, jax_float_input(x), dimensions,
                   keep_dims)


@register_op("reduce_any")
def reduce_any(x, dimensions=None, keep_dims=False):
    return _reduce(torch.any, x, dimensions, keep_dims)


@register_op("reduce_all")
def reduce_all(x, dimensions=None, keep_dims=False):
    return _reduce(torch.all, x, dimensions, keep_dims)


@register_op("count_nonzero")
def count_nonzero(x, dimensions=None, keep_dims=False):
    return _reduce(torch.sum, (x != 0).to(torch.int32), dimensions,
                   keep_dims)


@register_op("argmin")
def argmin(x, dimensions=0, keep_dims=False):
    return torch.argmin(x, dim=dimensions, keepdim=keep_dims).to(torch.int32)


# ----------------------------------------------------------------- shape
@register_op("expand_dims")
def expand_dims(x, axis=0):
    ax = jr.axes(axis, 0)
    nd = x.dim() + len(ax)
    for a in sorted(a % nd for a in ax):
        x = x.unsqueeze(a)
    return x


@register_op("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    ax = jr.axes(axis, x.dim())
    for a in ax:
        if x.shape[a] != 1:
            raise ValueError(f"cannot squeeze axis {a} of size {x.shape[a]}")
    return torch.squeeze(x, dim=ax)


@register_op("concat")
def concat(*xs, axis=0):
    return torch.cat(xs, dim=axis)


@register_op("stack")
def stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


@register_op("unstack")
def unstack(x, axis=0, num=None):
    n = num if num is not None else x.shape[axis]
    if n != x.shape[axis]:
        raise ValueError(f"unstack: num={n} but axis {axis} has "
                         f"{x.shape[axis]}")
    return tuple(torch.unbind(x, dim=axis))


def _split_points(x, sections, axis):
    """``jnp.split``'s ``indices_or_sections``: an int splits into equal
    parts (it must divide the axis), a list gives the split points."""
    if isinstance(sections, (int,)) or (hasattr(sections, "ndim")
                                        and sections.ndim == 0):
        k = int(sections)
        if x.shape[axis] % k:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {x.shape[axis]} by {k}")
        return k
    return [int(i) for i in sections]


@register_op("split")
def split(x, num_splits, axis=0):
    return tuple(torch.tensor_split(x, _split_points(x, num_splits, axis),
                                    dim=axis))


@register_op("tile")
def tile(x, reps):
    return torch.tile(x, tuple(int(r) for r in reps))


@register_op("repeat")
def repeat(x, repeats, axis=0):
    if not isinstance(repeats, int):
        repeats = jr.index_tensor(repeats, x.device)
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


@register_op("reverse")
def reverse(x, dimensions):
    return torch.flip(x, jr.axes(dimensions, x.dim()))


def slice_indices(begin, end, step, n):
    """Python slicing of an axis of ``n`` as ``(start, stop, step)``."""
    return slice(begin, end, step).indices(n)


@register_op("strided_slice")
def strided_slice(x, begin, end, strides=None):
    """``x[b:e:s, ...]`` per axis, negative strides included (torch
    slicing takes none: those axes are gathered)."""
    strides = strides if strides is not None else [1] * len(begin)
    for d, (b, e, s) in enumerate(zip(begin, end, strides)):
        b = None if b is None else int(b)
        e = None if e is None else int(e)
        start, stop, step = slice_indices(b, e, int(s), x.shape[d])
        idx = torch.arange(start, stop, step, device=x.device)
        x = torch.index_select(x, d, idx)
    return x


@register_op("gather")
def gather(x, indices, axis=0):
    """``jnp.take``: out-of-range indices give the fill value."""
    return jr.take_fill(x, indices, axis)


@register_op("gather_nd")
def gather_nd(x, indices):
    """``x[tuple(moveaxis(indices, -1, 0))]``: indices clamped, as JAX's
    gather clamps."""
    idx = jr.index_tensor(indices, x.device)
    return x[tuple(jr.clamp_index(idx[..., d], x.shape[d])
                   for d in range(idx.shape[-1]))]


@register_op("scatter_update")
def scatter_update(x, indices, updates):
    return jr.scatter(x, indices, updates, "set")


@register_op("scatter_add")
def scatter_add(x, indices, updates):
    return jr.scatter(x, indices, updates, "add")


@register_op("pad")
def pad(x, paddings, mode="constant", constant_value=0.0):
    return jr.pad_array(x, paddings, mode.lower(), constant_value)


@register_op("slice")
def slice_(x, begin, size):
    """``lax.dynamic_slice``: each start clamped so the slice fits."""
    for d, (b, n) in enumerate(zip(begin, size)):
        b = min(max(int(b), 0), x.shape[d] - int(n))
        x = x.narrow(d, b, int(n))
    return x


@register_op("shape_of")
def shape_of(x):
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


@register_op("size_of")
def size_of(x):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


@register_op("rank_of")
def rank_of(x):
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


@register_op("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register_op("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register_op("fill_like")
def fill_like(x, value):
    if isinstance(value, torch.Tensor):
        return torch.zeros_like(x) + value.to(x.dtype)
    return torch.full_like(x, value)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@register_op("linspace")
def linspace(start, stop, num):
    return torch.linspace(float(_scalar(start)), float(_scalar(stop)),
                          int(_scalar(num)), dtype=torch.float32,
                          device=jr.op_device(start, stop))


@register_op("range")
def arange(start, stop, step=1, dtype="int32"):
    return torch.arange(_scalar(start), _scalar(stop), _scalar(step),
                        dtype=jr.torch_dtype(dtype),
                        device=jr.op_device(start, stop, step))


@register_op("eye")
def eye(n, m=None, dtype="float32"):
    n = int(_scalar(n))
    return torch.eye(n, int(_scalar(m)) if m is not None else n,
                     dtype=jr.torch_dtype(dtype), device=jr.op_device())


@register_op("diag")
def diag(x):
    return torch.diag(x)


@register_op("trace")
def trace(x):
    return jax_int_result(torch.trace(x), x)


# ------------------------------------------------------------ segment ops
@register_op("segment_sum")
def segment_sum(x, ids, num_segments):
    return jr.segment_reduce(x, ids, num_segments, "sum")


@register_op("segment_max")
def segment_max(x, ids, num_segments):
    return jr.segment_reduce(x, ids, num_segments, "max")


@register_op("segment_min")
def segment_min(x, ids, num_segments):
    return jr.segment_reduce(x, ids, num_segments, "min")


@register_op("segment_mean")
def segment_mean(x, ids, num_segments):
    s = jr.segment_reduce(x, ids, num_segments, "sum")
    c = jr.segment_reduce(torch.ones_like(x), ids, num_segments, "sum")
    return s / torch.clamp(c, min=1)


# ------------------------------------------------------------------ misc
@register_op("top_k")
def top_k(x, k, sorted=True):  # noqa: A002
    return jr.top_k_stable(x, int(_scalar(k)))


@register_op("is_finite")
def is_finite(x):
    return torch.isfinite(x)


@register_op("maximum")
def maximum(x, y):
    """``jnp.maximum``: a tie splits the gradient, as torch's does."""
    return torch.maximum(x, jr.as_tensor(y, x.device))


@register_op("minimum")
def minimum(x, y):
    return torch.minimum(x, jr.as_tensor(y, x.device))
