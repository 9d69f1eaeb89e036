"""Ops with ONNX's semantics that imported ONNX graphs run: counterpart of
``deeplearning4j_tpu/ops/onnx_compat.py`` (:14-138).

They live in the ops package, not the importer, so that a process that
loads a saved imported graph has them without the importer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op
from deeplearning4j_tpu_torch.ops.tf_compat import _slice_axis


@register_op("onnx_reshape")
def onnx_reshape(x, shape):
    """ONNX Reshape: 0 copies the input dim, -1 infers."""
    resolved = [x.shape[i] if s == 0 else int(s)
                for i, s in enumerate(shape)] if 0 in list(shape) \
        else [int(s) for s in shape]
    return torch.reshape(x, tuple(resolved))


@register_op("onnx_flatten")
def onnx_flatten(x, axis=1):
    lead = 1
    for d in x.shape[:axis]:
        lead *= d
    return torch.reshape(x, (lead, -1))


@register_op("onnx_slice")
def onnx_slice(x, starts, ends, axes, steps):
    """numpy slicing per axis; an end past the axis (the exporters'
    INT64_MAX) is clipped to its length first, as JAX's op does."""
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % x.dim()
        n = x.shape[ax]
        en = min(en, n) if en >= 0 else en
        x = _slice_axis(x, ax, slice(int(st), int(en), int(sp)))
    return x


@register_op("hardmax")
def hardmax(x, axis=-1):
    """ONNX Hardmax: 1.0 at the (first) argmax along axis, else 0."""
    idx = torch.argmax(x, dim=axis)
    return F.one_hot(idx, x.shape[axis]).to(x.dtype).movedim(-1, axis)


@register_op("shrink")
def shrink(x, lambd=0.5, bias=0.0):
    """ONNX Shrink: x+bias if x < -lambd; x-bias if x > lambd; else 0."""
    return torch.where(x < -lambd, x + bias,
                       torch.where(x > lambd, x - bias,
                                   torch.zeros((), dtype=x.dtype,
                                               device=x.device)))


@register_op("mean_variance_norm")
def mean_variance_norm(x, axes=(0, 2, 3), eps=1e-9):
    """ONNX MeanVarianceNormalization: (x - mean) / std over axes."""
    axes = tuple(axes)
    m = torch.mean(x, dim=axes, keepdim=True)
    v = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps)


def _per_axis_qparams(x, scale, zero_point, axis):
    """Broadcast ONNX per-tensor or per-axis quantization params against
    x. A scalar zero_point (incl. the omitted-input default 0) stays
    scalar even when scale is per-axis — it broadcasts fine."""
    scale = jr.as_tensor(scale, x.device)
    zp = jr.as_tensor(0 if zero_point is None else zero_point, x.device)
    if scale.dim() == 1 and scale.shape[0] > 1:
        shape = [1] * x.dim()
        shape[axis] = scale.shape[0]
        scale = scale.reshape(shape)
        if zp.numel() > 1:
            zp = zp.reshape(shape)
    return scale, zp


@register_op("quantize_linear")
def quantize_linear(x, scale, zero_point=None, axis=1, qmin=0, qmax=255):
    """ONNX QuantizeLinear: saturate(round(x/scale) + zero_point), the
    rounding half to even."""
    scale, zp = _per_axis_qparams(x, scale, zero_point, axis)
    q = torch.round(x / scale) + zp.to(torch.float32)
    return torch.clamp(q, qmin, qmax).to(
        torch.uint8 if qmin == 0 else torch.int8)


@register_op("dequantize_linear")
def dequantize_linear(x, scale, zero_point=None, axis=1):
    """ONNX DequantizeLinear: (x - zero_point) * scale — the QDQ-format
    entry point (quantized exports import as float through this)."""
    scale, zp = _per_axis_qparams(x, scale, zero_point, axis)
    return (x.to(torch.float32) - zp.to(torch.float32)) \
        * scale.to(torch.float32)


@register_op("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False):
    """ONNX/torch GridSample, NHWC x + [N,Hout,Wout,2] grid of (x,y) in
    [-1,1]. Bilinear or nearest (half to even); zeros or border padding,
    as JAX's gathers compute them."""
    n, h, w, c = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * 0.5 * (w - 1)
        fy = (gy + 1) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1) * w - 1) * 0.5
        fy = ((gy + 1) * h - 1) * 0.5
    batch = torch.arange(n, device=x.device).reshape(n, 1, 1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    def sample(iy, ix):
        vals = x[batch, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            ok = ((iy >= 0) & (iy <= h - 1) & (ix >= 0)
                  & (ix <= w - 1))[..., None]
            vals = torch.where(ok, vals, zero)
        return vals

    if mode == "nearest":
        return sample(torch.round(fy).to(torch.int64),
                      torch.round(fx).to(torch.int64))
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = (fy - y0)[..., None].to(x.dtype)
    wx = (fx - x0)[..., None].to(x.dtype)
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


__all__ = ["onnx_reshape", "onnx_flatten", "onnx_slice", "hardmax",
           "shrink", "mean_variance_norm", "quantize_linear",
           "dequantize_linear", "grid_sample"]
