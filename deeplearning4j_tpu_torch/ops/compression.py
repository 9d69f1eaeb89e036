"""Threshold gradient compression: counterpart of
``deeplearning4j_tpu/ops/compression.py`` (:29-74), the reference's
``encodeThreshold`` / ``decodeThreshold`` ops and its adaptive
threshold.

- ternary: sign(g) where |g| >= t, as int8; decode multiplies by t;
- top-k: the k largest |g| as (int32 indices, values), ties to the lower
  index as ``lax.top_k`` takes them; decode scatter-adds, dropping
  indices out of range as JAX's ``.at[].add`` does.

Both encoders return the residual ``g - decoded`` beside the encoding.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ndarray.dtypes import DataType
from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


@register_op("encode_threshold")
def encode_threshold(grad, threshold):
    """Ternary threshold encoding: ``(encoded int8, residual)``."""
    mask = torch.abs(grad) >= threshold
    enc = torch.where(mask, torch.sign(grad),
                      torch.zeros((), dtype=grad.dtype, device=grad.device))
    residual = grad - enc * threshold
    return enc.to(torch.int8), residual


@register_op("decode_threshold")
def decode_threshold(encoded, threshold, dtype="float32"):
    return encoded.to(DataType.from_any(dtype).torch) * threshold


@register_op("encode_topk")
def encode_topk(grad, k):
    """The ``k`` largest-|g| elements of a flat ``[D]`` gradient:
    ``(indices int32 [k], values [k], residual [D])``."""
    _, idx = jr.top_k_stable(torch.abs(grad), int(k))
    idx = idx.to(torch.int64)
    vals = grad[idx]
    residual = grad.index_fill(0, idx, 0.0)
    return idx.to(torch.int32), vals, residual


@register_op("decode_topk")
def decode_topk(indices, values, size):
    out = torch.zeros((int(size),), dtype=values.dtype, device=values.device)
    return jr.scatter(out, indices, values, "add")


@register_op("adaptive_threshold")
def adaptive_threshold(grad, target_sparsity=1e-3, current_threshold=1e-3,
                       decay=0.95, min_threshold=1e-5):
    """The next threshold (reference: AdaptiveThresholdAlgorithm): divided
    by ``decay`` while the encoded density is above the target, else
    multiplied by it, never below ``min_threshold``; an f32 scalar."""
    density = torch.mean((torch.abs(grad) >= current_threshold).to(
        torch.float32))
    too_dense = density > target_sparsity
    f32 = dict(dtype=torch.float32, device=grad.device)
    up = jr.as_tensor(current_threshold / decay, grad.device).to(**f32)
    down = jr.as_tensor(current_threshold * decay, grad.device).to(**f32)
    new_t = torch.where(too_dense, up, down)
    return torch.maximum(new_t, torch.tensor(min_threshold, **f32))


__all__ = ["encode_threshold", "decode_threshold", "encode_topk",
           "decode_topk", "adaptive_threshold"]
