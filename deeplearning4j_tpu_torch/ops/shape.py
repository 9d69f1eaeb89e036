"""Shape, gather-scatter and layout ops: counterpart of
``deeplearning4j_tpu/ops/shape.py``, every name it registers, with its
parameters. The layout ops (``space_to_depth`` and the rest, ``:155-195``)
are the ones ``SpaceToDepthLayer`` and ``SpaceToBatchLayer`` run: plain
reshapes and permutes of NHWC tensors. Gathers fill, scatters drop rows
out of range, as JAX's do (``ops/jax_rules.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


@register_op("space_to_depth")
def space_to_depth(x, block_size: int):
    """NHWC ``[N, H, W, C]`` -> ``[N, H / b, W / b, C * b * b]``, each
    ``b x b`` block's pixels stacked along the channels in row-major block
    order (channel ``(i * b + j) * C + c`` holds pixel ``(i, j)`` of the
    block)."""
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h // b, b, w // b, b, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, c * b * b)


@register_op("depth_to_space")
def depth_to_space(x, block_size: int):
    """The inverse of :func:`space_to_depth`: ``[N, H, W, C]`` -> ``[N, H *
    b, W * b, C / (b * b)]``."""
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h, w, b, b, c // (b * b))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * b, w * b,
                                               c // (b * b))


@register_op("batch_to_space")
def batch_to_space(x, block_shape, crops):
    """``[N * b0 * b1, H, W, C]`` -> ``[N, H * b0 - crops, W * b1 - crops,
    C]``, the inverse of :func:`space_to_batch`; ``crops`` ``((top,
    bottom), (left, right))``."""
    b0, b1 = block_shape
    n, h, w, c = x.shape
    r = x.reshape(b0, b1, n // (b0 * b1), h, w, c)
    r = r.permute(2, 3, 0, 4, 1, 5).reshape(n // (b0 * b1), h * b0, w * b1,
                                            c)
    (ct0, cb0), (ct1, cb1) = crops
    return r[:, ct0:h * b0 - cb0, ct1:w * b1 - cb1, :]


@register_op("space_to_batch")
def space_to_batch(x, block_shape, paddings):
    """Zero-pad NHWC ``x`` by ``paddings`` ``((top, bottom), (left,
    right))``, then move each ``b0 x b1`` block's pixel offsets to the
    batch: ``[N, H, W, C]`` -> ``[b0 * b1 * N, H / b0, W / b1, C]``, offset
    ``(i, j)`` of image ``n`` at batch index ``(i * b1 + j) * N + n``."""
    b0, b1 = block_shape
    (pt0, pb0), (pt1, pb1) = paddings
    x = F.pad(x, (0, 0, pt1, pb1, pt0, pb0))
    n, h, w, c = x.shape
    x = x.reshape(n, h // b0, b0, w // b1, b1, c)
    return x.permute(2, 4, 0, 1, 3, 5).reshape(n * b0 * b1, h // b0, w // b1,
                                               c)


# -- pure shape --------------------------------------------------------
@register_op("permute")
def permute(x, axes):
    return x.permute(*axes)


@register_op("flatten_2d")
def flatten_2d(x, axis=1):
    """Collapse to 2D around ``axis``."""
    lead = 1
    for s in x.shape[:axis]:
        lead *= s
    return torch.reshape(x, (lead, -1))


@register_op("broadcast_to")
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(int(d) for d in shape))


@register_op("rank")
def rank(x):
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


# -- concat / split family ---------------------------------------------
@register_op("split_v")
def split_v(x, sizes, axis=0):
    idx, acc = [], 0
    for s in list(sizes)[:-1]:
        acc += int(s)
        idx.append(acc)
    return list(torch.tensor_split(x, idx, dim=axis))


@register_op("reverse_sequence")
def reverse_sequence(x, seq_lengths, seq_axis=1, batch_axis=0):
    """Each row's first ``n`` steps reversed, the rest kept (JAX's
    ``vmap`` over rows, with ``jnp.take``'s fill past the end)."""
    t = x.shape[seq_axis]
    lens = jr.index_tensor(seq_lengths, x.device)
    idx = torch.arange(t, device=x.device)
    rev = torch.where(idx[None, :] < lens[:, None], lens[:, None] - 1 - idx,
                      idx[None, :])                       # [B, T]
    shape = [1] * x.dim()
    shape[batch_axis], shape[seq_axis] = x.shape[batch_axis], t
    if batch_axis > seq_axis:
        rev = rev.T
    return jr.take_along_fill(x, rev.reshape(shape), seq_axis)


# -- pad ---------------------------------------------------------------
@register_op("mirror_pad")
def mirror_pad(x, paddings, reflect=True):
    return jr.pad_array(x, paddings, "reflect" if reflect else "symmetric")


# -- gather / scatter --------------------------------------------------
@register_op("take_along_axis")
def take_along_axis(x, indices, axis):
    return jr.take_along_fill(x, indices, axis)


@register_op("scatter_sub")
def scatter_sub(ref, indices, updates):
    return jr.scatter(ref, indices, -jr.as_tensor(updates, ref.device), "add")


@register_op("scatter_mul")
def scatter_mul(ref, indices, updates):
    return jr.scatter(ref, indices, updates, "mul")


@register_op("scatter_div")
def scatter_div(ref, indices, updates):
    return jr.scatter(ref, indices, updates, "div")


@register_op("scatter_max")
def scatter_max(ref, indices, updates):
    return jr.scatter(ref, indices, updates, "max")


@register_op("scatter_min")
def scatter_min(ref, indices, updates):
    return jr.scatter(ref, indices, updates, "min")


@register_op("scatter_nd")
def scatter_nd(indices, updates, shape):
    """``zeros(shape)`` with ``updates`` added at ``indices``."""
    updates = jr.as_tensor(updates)
    zeros = torch.zeros(tuple(int(d) for d in shape), dtype=updates.dtype,
                        device=updates.device)
    return jr.scatter_nd(zeros, indices, updates, "add")


# -- slicing -----------------------------------------------------------
@register_op("dynamic_update_slice")
def dynamic_update_slice(x, update, start_indices):
    """``lax.dynamic_update_slice``: each start clamped so the update
    fits."""
    out = x.clone()
    view = out
    for d, b in enumerate(start_indices):
        n = update.shape[d]
        b = min(max(int(b), 0), x.shape[d] - n)
        view = view.narrow(d, b, n)
    view.copy_(update.to(x.dtype))
    return out


# -- construction ------------------------------------------------------
@register_op("fill")
def fill(shape, value, dtype=None):
    """``jnp.full``: without ``dtype``, a Python float fills float32, an
    int int32 and a bool bool (a tensor value keeps its type)."""
    shape = tuple(int(d) for d in (shape if isinstance(shape, (list, tuple))
                                   else jr.as_tensor(shape).tolist()))
    if isinstance(value, torch.Tensor):
        out = value.reshape(()).expand(shape).clone()
        return out if dtype is None else out.to(jr.torch_dtype(dtype))
    dt = jr.torch_dtype(dtype) if dtype is not None else jr.as_tensor(
        value, "cpu").dtype
    return torch.full(shape, value, dtype=dt, device=jr.op_device())


@register_op("meshgrid")
def meshgrid(*arrays, indexing="xy"):
    return list(torch.meshgrid(*arrays, indexing=indexing))


@register_op("diag_part")
def diag_part(x):
    return torch.diagonal(x, dim1=-2, dim2=-1)


@register_op("matrix_diag")
def matrix_diag(x):
    return torch.diag_embed(x)


@register_op("matrix_set_diag")
def matrix_set_diag(x, diagonal):
    n = min(x.shape[-2], x.shape[-1])
    return torch.diagonal_scatter(x, diagonal[..., :n].to(x.dtype), dim1=-2,
                                  dim2=-1)


# -- selection ---------------------------------------------------------
@register_op("select")
def select(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


@register_op("masked_fill")
def masked_fill(x, mask, value):
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) else \
        torch.tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(mask.to(torch.bool), v, x)


@register_op("compress")
def compress(x, mask, size, axis=0, fill_value=0):
    """The first ``size`` slices along ``axis`` where ``mask`` holds;
    surplus slots hold ``fill_value``."""
    n = x.shape[axis]
    m = mask.reshape(-1).to(torch.bool)
    # the held positions first, in order (a stable sort, not a nonzero:
    # no host read); a slot past their count takes the fill row n
    order = torch.sort((~m).to(torch.int32), stable=True).indices[:size]
    if order.numel() < size:
        order = torch.cat([order, order.new_full((size - order.numel(),),
                                                 n)])
    slot = torch.arange(size, device=x.device)
    idx = torch.where(slot < m.sum(), order, torch.full_like(order, n))
    pad_shape = list(x.shape)
    pad_shape[axis] = 1
    padded = torch.cat([x, torch.full(pad_shape, fill_value, dtype=x.dtype,
                                      device=x.device)], dim=axis)
    return torch.index_select(padded, axis, idx)


@register_op("unique_with_counts")
def unique_with_counts(x, size):
    """``jnp.unique(x, size=size, return_counts=True)``: sorted unique
    values of the flattened ``x`` in ``size`` slots, surplus slots holding
    ``max(x)`` with count 0; counts int32."""
    # sorted runs numbered by a cumulative sum, not torch.unique: no host
    # read, and runs past ``size`` drop as out-of-range segments do
    s = torch.sort(x.reshape(-1)).values
    first = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    run = torch.cumsum(first.to(torch.int32), 0) - 1
    counts = jr.segment_reduce(torch.ones_like(run), run, size, "sum")
    vals = jr.segment_reduce(s, run, size, "max")
    return torch.where(counts > 0, vals, s[-1]), counts.to(torch.int32)
