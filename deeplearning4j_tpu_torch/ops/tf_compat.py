"""Ops with TF's attribute conventions that imported graphs run:
counterpart of ``deeplearning4j_tpu/ops/tf_compat.py`` (:19-100).

They live in the ops package, not the importer, so that a process that
loads a saved imported graph has them without the importer. No op here
reads a value on the host: the dynamic strided slice gathers at a device
index, where JAX's ``lax.dynamic_slice`` takes a traced start.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


def _slice_axis(x: torch.Tensor, d: int, s: slice) -> torch.Tensor:
    """``x[..., s, ...]`` on axis ``d`` with numpy's rules: a view for a
    positive step, a gather for a negative one (torch slices take no
    negative step)."""
    start, stop, step = s.indices(x.shape[d])
    if step > 0:
        return x[(slice(None),) * d + (slice(start, stop, step),)]
    idx = torch.arange(start, stop, step, device=x.device)
    return torch.index_select(x, d, idx)


@register_op("tf_strided_slice")
def tf_strided_slice(x, begin=None, end=None, strides=None, begin_mask=0,
                     end_mask=0, shrink_axis_mask=0, new_axis_mask=0):
    """TF StridedSlice: begin/end/shrink/new-axis masks, no ellipsis. A
    new-axis position takes one spec entry (its begin/end/stride are
    ignored) and inserts a length-1 axis there."""
    slices = []
    shrink_axes = []
    new_axes = []
    out_pos = 0
    for i in range(len(begin)):
        if new_axis_mask & (1 << i):
            new_axes.append(out_pos)
            out_pos += 1
            continue
        if shrink_axis_mask & (1 << i):
            # begin=-1 means "last element": the end is None, not 0
            e = begin[i] + 1 if begin[i] != -1 else None
            slices.append(slice(begin[i], e, 1))
            shrink_axes.append(len(slices) - 1)
            continue
        b = None if begin_mask & (1 << i) else begin[i]
        e = None if end_mask & (1 << i) else end[i]
        slices.append(slice(b, e, strides[i]))
        out_pos += 1
    out = x
    for d, s in enumerate(slices):
        out = _slice_axis(out, d, s)
    if shrink_axes:
        out = _squeeze_axes(out, shrink_axes)
    for pos in new_axes:
        out = out.unsqueeze(pos)
    return out


def _squeeze_axes(x: torch.Tensor, axes) -> torch.Tensor:
    """``jnp.squeeze(x, axis=axes)``: each named axis must be 1."""
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(
                f"cannot squeeze axis {a} of size {x.shape[a]}")
    keep = [n for d, n in enumerate(x.shape) if d not in set(axes)]
    return x.reshape(keep)


@register_op("tf_strided_slice_dyn")
def tf_strided_slice_dyn(x, begin_t, begin=None, end=None, begin_mask=0,
                         end_mask=0, shrink_axis_mask=0):
    """StridedSlice with runtime begin entries (None in ``begin``/
    ``end``), unit strides. Dynamic entries are legal only on shrink axes
    (the importer checks): each is a one-row gather at the device index,
    clamped into the axis as ``lax.dynamic_slice`` clamps its start, so
    the card never waits for the index."""
    out = x
    squeeze = []
    for d in range(len(begin)):
        dim = x.shape[d]
        if shrink_axis_mask & (1 << d):
            if begin[d] is None:
                st = begin_t.reshape(-1)[d:d + 1].to(torch.int64)
                st = torch.where(st < 0, st + dim, st)
                st = st.clamp(0, max(dim - 1, 0))
            else:
                b = begin[d] + dim if begin[d] < 0 else begin[d]
                st = torch.tensor([min(max(b, 0), max(dim - 1, 0))],
                                  device=x.device)
            out = torch.index_select(out, d, st)
            squeeze.append(d)
        else:
            b = 0 if (begin_mask & (1 << d)) else begin[d]
            e = dim if (end_mask & (1 << d)) else end[d]
            b = b + dim if b < 0 else b
            e = e + dim if e < 0 else e
            b = max(0, min(b, dim))
            e = max(0, min(e, dim))
            out = out.narrow(d, b, max(0, e - b))
    return _squeeze_axes(out, squeeze) if squeeze else out


@register_op("tf_fill")
def tf_fill(shape=None, value=0.0):
    """``jnp.full(shape, value)`` on the running graph's device: a Python
    float gives float32, an int int32, a bool bool."""
    return jr.as_tensor(value).expand(tuple(int(d) for d in shape)).clone()


@register_op("erfc")
def erfc(x):
    return torch.special.erfc(x)
