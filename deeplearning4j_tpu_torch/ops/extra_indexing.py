"""Indexing, segment and scatter long tail: counterpart of
``deeplearning4j_tpu/ops/extra_indexing.py``, every name it registers,
with its parameters. Output sizes are static as in JAX (``bincount``
takes ``minlength`` / ``maxlength``, ``dynamic_stitch`` a ``size``);
indices out of range follow JAX's rules (``ops/jax_rules.py``)."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


# ------------------------------------------------------------- segments
@register_op("unsorted_segment_max")
def unsorted_segment_max(data, segment_ids, num_segments):
    return jr.segment_reduce(data, segment_ids, num_segments, "max")


@register_op("unsorted_segment_min")
def unsorted_segment_min(data, segment_ids, num_segments):
    return jr.segment_reduce(data, segment_ids, num_segments, "min")


@register_op("unsorted_segment_prod")
def unsorted_segment_prod(data, segment_ids, num_segments):
    return jr.segment_reduce(data, segment_ids, num_segments, "prod")


@register_op("unsorted_segment_sqrt_n")
def unsorted_segment_sqrt_n(data, segment_ids, num_segments):
    """The segment sum over the square root of the segment's count."""
    s = jr.segment_reduce(data, segment_ids, num_segments, "sum")
    n = jr.segment_reduce(torch.ones_like(data), segment_ids, num_segments,
                          "sum")
    return s / torch.sqrt(torch.clamp(n, min=1.0))


# -------------------------------------------------------------- scatter
@register_op("scatter_nd_add")
def scatter_nd_add(ref, indices, updates):
    return jr.scatter_nd(ref, indices, updates, "add")


@register_op("scatter_nd_sub")
def scatter_nd_sub(ref, indices, updates):
    return jr.scatter_nd(ref, indices, -jr.as_tensor(updates, ref.device),
                         "add")


@register_op("scatter_nd_update")
def scatter_nd_update(ref, indices, updates):
    return jr.scatter_nd(ref, indices, updates, "set")


# ------------------------------------------------------------- indexing
@register_op("roll")
def roll(x, shift, axis=None):
    if axis is None:
        return torch.roll(x, int(shift))
    return torch.roll(x, shift, dims=axis)


@register_op("flip")
def flip(x, axis=None):
    return torch.flip(x, jr.axes(axis, x.dim()))


@register_op("rot90")
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, int(k), tuple(axes))


@register_op("bincount")
def bincount(x, weights=None, minlength=0, maxlength=None,
             binary_output=False):
    """TF's bincount with a static size: ``maxlength`` caps the values
    counted, ``minlength`` is the floor of the output size,
    ``binary_output`` reports presence; counts int32, weighted sums in
    the weights' type."""
    if binary_output and weights is not None:
        raise ValueError("bincount: binary_output with weights is "
                         "undefined (TF rejects it too)")
    nbins = maxlength if maxlength is not None else minlength
    if nbins <= 0:
        raise ValueError("bincount needs a static minlength/maxlength "
                         "under jit")
    w = torch.ones(x.shape, dtype=torch.float32, device=x.device) \
        if weights is None else jr.as_tensor(weights, x.device)
    idx = x.reshape(-1).to(torch.int64)
    keep = idx < nbins
    idx = torch.where(keep, idx, torch.full_like(idx, nbins))
    wf = w.reshape(-1)
    out = jr.segment_reduce(torch.where(keep, wf, torch.zeros_like(wf)), idx,
                            nbins + 1, "sum")[:nbins]
    if binary_output:
        return (out > 0).to(torch.int32)
    return out if weights is not None else out.to(torch.int32)


@register_op("searchsorted")
def searchsorted(sorted_seq, values, side="left"):
    return torch.searchsorted(sorted_seq, values,
                              right=(side == "right")).to(torch.int32)


@register_op("nth_element")
def nth_element(x, n, reverse=False):
    """The ``n``-th smallest (largest with ``reverse``) along the last
    axis."""
    s = torch.sort(x, dim=-1).values
    if reverse:
        s = torch.flip(s, (-1,))
    return s[..., int(n)]


@register_op("histogram_fixed_width")
def histogram_fixed_width(x, range_min, range_max, nbins=100):
    scale = (range_max - range_min) / nbins
    idx = torch.clamp(((x - range_min) / scale).to(torch.int32), 0,
                      nbins - 1)
    return jr.segment_reduce(torch.ones(idx.numel(), dtype=torch.int32,
                                        device=x.device),
                             idx.reshape(-1), nbins, "sum")


@register_op("sequence_mask")
def sequence_mask(lengths, maxlen):
    r = torch.arange(int(maxlen), device=lengths.device)
    return r < lengths.unsqueeze(-1)


@register_op("batch_gather")
def batch_gather(params, indices):
    """Gather along axis 1 with a shared leading batch axis."""
    idx = jr.index_tensor(indices, params.device)
    idx = idx.reshape(idx.shape + (1,) * (params.dim() - idx.dim()))
    return jr.take_along_fill(params, idx, 1)


@register_op("dynamic_partition_masks")
def dynamic_partition_masks(data, partitions, num_partitions):
    """``[num_partitions, *data.shape]`` with non-members zeroed, and the
    ``[num_partitions, n]`` membership masks."""
    masks = torch.stack([partitions == p for p in range(num_partitions)])
    expanded = masks.reshape(masks.shape + (1,) * (data.dim() - 1))
    return data[None] * expanded.to(data.dtype), masks


@register_op("dynamic_stitch")
def dynamic_stitch(indices_list, data_list, size):
    """Partitions merged back into ``size`` rows, later ones winning."""
    out = torch.zeros((size,) + tuple(data_list[0].shape[1:]),
                      dtype=data_list[0].dtype, device=data_list[0].device)
    for idx, d in zip(indices_list, data_list):
        out = jr.scatter(out, idx, d, "set")
    return out
