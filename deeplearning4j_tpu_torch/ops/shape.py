"""Layout ops of the vision zoo: the part of
``deeplearning4j_tpu/ops/shape.py`` (``:155-172``) that
``SpaceToDepthLayer`` runs. Plain reshapes and permutes of NHWC tensors,
not registered by name (the port's registry holds them under A10)."""

from __future__ import annotations


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


__all__ = ["space_to_depth", "depth_to_space"]
