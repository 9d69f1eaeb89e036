"""Reductions, index reductions, pairwise distances and segment variants:
counterpart of ``deeplearning4j_tpu/ops/reduce.py``, every name it
registers, with its ``axis=`` / ``keepdims=`` parameters. Integer results
are int32 and out-of-range segment ids are dropped, as in JAX
(``ops/jax_rules.py``)."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op
from deeplearning4j_tpu_torch.ops.transforms import jax_abs


def _f(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _sum(x, axis=None, keepdims=False):
    return jr.reduce_over(torch.sum, x, axis, keepdims)


# -- plain reductions --------------------------------------------------
@register_op("count_zero")
def count_zero(x, axis=None, keepdims=False):
    return _sum((x == 0).to(torch.int32), axis, keepdims)


# -- norms -------------------------------------------------------------
@register_op("norm1")
def norm1(x, axis=None, keepdims=False):
    return _sum(jax_abs(x), axis, keepdims)


@register_op("norm2")
def norm2(x, axis=None, keepdims=False):
    return torch.sqrt(_sum(x * x, axis, keepdims))


@register_op("normmax")
def normmax(x, axis=None, keepdims=False):
    return jr.reduce_over(torch.amax, jax_abs(x), axis, keepdims)


@register_op("squared_norm")
def squared_norm(x, axis=None, keepdims=False):
    return _sum(x * x, axis, keepdims)


@register_op("std")
def std(x, axis=None, keepdims=False, ddof=0):
    return jr.reduce_over(torch.std, _f(x), axis, keepdims, correction=ddof)


@register_op("variance")
def variance(x, axis=None, keepdims=False, ddof=0):
    return jr.reduce_over(torch.var, _f(x), axis, keepdims, correction=ddof)


@register_op("moments")
def moments(x, axis=None, keepdims=False):
    """(mean, variance) of ``x`` over ``axis``."""
    x = _f(x)
    return (jr.reduce_over(torch.mean, x, axis, keepdims),
            jr.reduce_over(torch.var, x, axis, keepdims, correction=0))


@register_op("entropy")
def entropy(x, axis=None):
    """``-sum(p log p)``."""
    return -_sum(x * torch.log(x), axis)


@register_op("log_entropy")
def log_entropy(x, axis=None):
    return torch.log(entropy(x, axis=axis))


@register_op("shannon_entropy")
def shannon_entropy(x, axis=None):
    return -_sum(x * torch.log2(x), axis)


# -- index reductions --------------------------------------------------
def _arg(fn, x, axis):
    if axis is None:
        return fn(x.reshape(-1)).to(torch.int32)
    return fn(x, dim=axis).to(torch.int32)


@register_op("argamax")
def argamax(x, axis=None):
    """Index of the largest absolute value."""
    return _arg(torch.argmax, torch.abs(x), axis)


@register_op("argamin")
def argamin(x, axis=None):
    return _arg(torch.argmin, torch.abs(x), axis)


# -- pairwise distance reductions --------------------------------------
@register_op("dot")
def dot(x, y, axis=None):
    return _sum(x * y, axis)


@register_op("cosine_similarity")
def cosine_similarity(x, y, axis=None, eps=1e-12):
    num = _sum(x * y, axis)
    den = torch.sqrt(_sum(x * x, axis) * _sum(y * y, axis))
    return num / torch.maximum(den, torch.tensor(eps, dtype=den.dtype,
                                                 device=den.device))


@register_op("cosine_distance")
def cosine_distance(x, y, axis=None):
    return 1.0 - cosine_similarity(x, y, axis=axis)


@register_op("euclidean_distance")
def euclidean_distance(x, y, axis=None):
    d = x - y
    return torch.sqrt(_sum(d * d, axis))


@register_op("manhattan_distance")
def manhattan_distance(x, y, axis=None):
    return _sum(jax_abs(x - y), axis)


@register_op("hamming_distance")
def hamming_distance(x, y, axis=None):
    return _sum((x != y).to(torch.float32), axis)


@register_op("jaccard_distance")
def jaccard_distance(x, y, axis=None, eps=1e-12):
    mn = _sum(torch.minimum(x, y), axis)
    mx = _sum(torch.maximum(x, y), axis)
    return 1.0 - mn / torch.maximum(mx, torch.tensor(eps, dtype=mx.dtype,
                                                     device=mx.device))


# -- segment reductions ------------------------------------------------
@register_op("segment_prod")
def segment_prod(data, segment_ids, num_segments):
    return jr.segment_reduce(data, segment_ids, num_segments, "prod")


@register_op("unsorted_segment_sum")
def unsorted_segment_sum(data, segment_ids, num_segments):
    return jr.segment_reduce(data, segment_ids, num_segments, "sum")


@register_op("unsorted_segment_mean")
def unsorted_segment_mean(data, segment_ids, num_segments):
    # the arithmetic of segment_mean (ops_math imports this package)
    from deeplearning4j_tpu_torch.autodiff.ops_math import segment_mean

    return segment_mean(data, segment_ids, num_segments)


# -- top-k family ------------------------------------------------------
@register_op("in_top_k")
def in_top_k(predictions, targets, k):
    """``[N, C]`` predictions, ``[N]`` targets -> ``[N]`` bool (ties go to
    the lower index, as ``lax.top_k`` breaks them)."""
    _, idx = jr.top_k_stable(predictions, int(k))
    t = jr.as_tensor(targets, predictions.device)
    return torch.any(idx == t[:, None], dim=-1)


@register_op("confusion_matrix")
def confusion_matrix(labels, predictions, num_classes, weights=None):
    flat = labels.to(torch.int32) * num_classes + predictions.to(torch.int32)
    w = torch.ones(flat.shape, dtype=torch.float32, device=flat.device) \
        if weights is None else jr.as_tensor(weights, flat.device)
    cm = jr.segment_reduce(w, flat, num_classes ** 2, "sum")
    return cm.reshape(num_classes, num_classes)


@register_op("zero_fraction")
def zero_fraction(x):
    return torch.mean((x == 0).to(torch.float32))


@register_op("matrix_trace")
def matrix_trace(x):
    return jr.int32(torch.diagonal(x, dim1=-2, dim2=-1).sum(-1))
