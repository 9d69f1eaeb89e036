"""Layout ops of the layer framework: the part of
``deeplearning4j_tpu/ops/shape.py`` (``:155-195``) that
``SpaceToDepthLayer`` and ``SpaceToBatchLayer`` run. Plain reshapes and
permutes of NHWC tensors, not registered by name (the port's registry
holds them under A10)."""

from __future__ import annotations

import torch.nn.functional as F


def space_to_depth(x, block_size: int):
    """NHWC ``[N, H, W, C]`` -> ``[N, H / b, W / b, C * b * b]``, each
    ``b x b`` block's pixels stacked along the channels in row-major block
    order (channel ``(i * b + j) * C + c`` holds pixel ``(i, j)`` of the
    block)."""
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h // b, b, w // b, b, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, c * b * b)


def depth_to_space(x, block_size: int):
    """The inverse of :func:`space_to_depth`: ``[N, H, W, C]`` -> ``[N, H *
    b, W * b, C / (b * b)]``."""
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h, w, b, b, c // (b * b))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * b, w * b,
                                               c // (b * b))


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


__all__ = ["space_to_depth", "depth_to_space", "space_to_batch",
           "batch_to_space"]
