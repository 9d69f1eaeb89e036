"""Neural-net ops the layer framework calls: counterpart of the part of
``deeplearning4j_tpu/ops/nn.py`` that the ported layers reach.

Ported: :func:`conv2d` (``:36-79``), :func:`depthwise_conv2d`
(``:117-134``), :func:`separable_conv2d` (``:137-142``),
:func:`upsampling2d` (``:173-176``), the four pools (``:198-253``),
:func:`global_avg_pool` (``:370-373``), :func:`batch_norm` (``:383-387``),
:func:`batch_norm_train` with its shifted one-pass statistics
(``:390-428``), :func:`batch_norm_relu_train` with its two-pass backward
(``:431-531``; both through ``ops.batch_norm``), :func:`layer_norm`
(``:534-541``), :func:`local_response_normalization` (``:544-555``),
:func:`lstm_layer`
(``:592-651``), :func:`simple_rnn_layer` (``:709-722``),
:func:`dot_product_attention` (``:981-997``) and :func:`dropout`
(``:558-564``); every one but the last four and the three image ops of
the vision zoo (``depthwise_conv2d``, ``separable_conv2d``,
``upsampling2d``, called by their layers) is registered under its JAX
name. The simple RNN and the attention are plain PyTorch: no Pallas
kernel computes them in the reference. Layouts stay the JAX package's, so a parameter tree from the JAX
side loads unchanged: images NHWC ``[N, H, W, C]``, conv weights HWIO
``[kh, kw, C_in, C_out]``; ``x`` ``[N, T, in]``, ``w_ih`` ``[in, 4H]``,
``w_hh`` ``[H, 4H]``, ``b`` ``[4H]`` with gates i, f, g, o.

The convolutions and pools are the library's (``F.conv2d``, the pooling
functions), as ``lax.conv`` and ``lax.reduce_window`` are outside any
Pallas kernel in the reference. An NHWC tensor permuted to NCHW is a
``channels_last`` view, so cuDNN runs its NHWC kernels on it without a
copy (on the card; the CPU takes an NCHW copy, C13). ``lax``'s SAME
padding puts the odd pixel on the high side, which
the library's symmetric ``padding=`` cannot say: such a pad is applied
with ``F.pad`` (``-inf`` for max pooling) before an unpadded call.
Integer inputs keep ``jnp``'s result types: max and sum pools stay in the
integer dtype (their windows taken by ``unfold``, since the library's
pools take no integers), average and p-norm pools and the global mean
give float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import batch_norm as bn
from deeplearning4j_tpu_torch.ops.lstm_recurrence import lstm_recurrence
from deeplearning4j_tpu_torch.ops.registry import register_op


# ---------------------------------------------------------- convolution
def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_padding(padding, kernel, strides, dilation):
    """The reference's padding argument in ``lax`` terms: "SAME" or
    "VALID", or a ``(lo, hi)`` pair per spatial axis (an int or a pair of
    ints is symmetric; a pair of pairs passes through)."""
    if isinstance(padding, str):
        return padding.upper()
    if (isinstance(padding, (tuple, list)) and len(padding) == 2
            and all(isinstance(q, (tuple, list)) and len(q) == 2
                    for q in padding)):
        return [tuple(int(v) for v in q) for q in padding]
    p = _pair(padding)
    return [(p[0], p[0]), (p[1], p[1])]


def _same_pads(sizes, kernel, strides, dilation=(1, 1)):
    """``lax``'s SAME pads: ``ceil(n / s)`` outputs, the odd pixel of the
    total pad on the high side."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _spatial_pads(pad, x, kernel, strides, dilation=(1, 1)):
    """``(lo, hi)`` per spatial axis of an NHWC ``x`` for a resolved
    ``lax`` padding (a string or a list of pairs)."""
    if pad == "SAME":
        return _same_pads(x.shape[1:3], kernel, strides, dilation)
    if pad == "VALID":
        return [(0, 0), (0, 0)]
    return [tuple(q) for q in pad]


def _pad_nhwc(x, pads, value=0.0):
    (hl, hh), (wl, wh) = pads
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (0, 0, wl, wh, hl, hh), value=value)


def _nchw(x):
    """An NHWC tensor as the NCHW view the library takes (``channels_last``
    strides when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


@register_op("conv2d")
def conv2d(x, w, b=None, strides=(1, 1), padding="SAME", dilation=(1, 1),
           groups=1):
    """2D convolution, NHWC x HWIO -> NHWC (``w`` ``[kh, kw, C_in/groups,
    C_out]``, ``b`` ``[C_out]`` or None) through ``F.conv2d``. Symmetric
    pads go to the library; asymmetric ones (SAME with an odd total, or
    explicit pairs) are applied first."""
    s, d = _pair(strides), _pair(dilation)
    pads = _spatial_pads(_conv_padding(padding, w.shape[:2], s, d), x,
                         w.shape[:2], s, d)
    (hl, hh), (wl, wh) = pads
    if hl == hh >= 0 and wl == wh >= 0:
        sym = (hl, wl)
    else:
        x, sym = _pad_nhwc(x, pads), (0, 0)
    xc = _nchw(x)
    if xc.device.type == "cpu":
        # the CPU convolution's backward on a channels_last input corrupts
        # the heap at some of the vision zoo's shapes (C13): the CPU takes
        # an NCHW copy; the card keeps the channels_last view
        xc = xc.contiguous()
    out = _nhwc(F.conv2d(xc, w.permute(3, 2, 0, 1), None, s, sym, d,
                         int(groups)))
    if b is not None:
        out = out + b
    return out


def depthwise_conv2d(x, w, b=None, strides=(1, 1), padding="SAME",
                     dilation=(1, 1)):
    """Depthwise convolution, NHWC x ``[kh, kw, C_in, mult]`` -> NHWC
    ``[..., C_in * mult]``: :func:`conv2d` with ``groups = C_in`` on the
    weight as ``[kh, kw, 1, C_in * mult]``, so output channel ``c * mult +
    m`` is input channel ``c`` under multiplier ``m`` (XLA's feature
    grouping); ``b`` ``[C_in * mult]`` or None."""
    kh, kw, c_in, mult = w.shape
    return conv2d(x, w.reshape(kh, kw, 1, c_in * mult), b, strides, padding,
                  dilation, groups=c_in)


def separable_conv2d(x, depth_w, point_w, b=None, strides=(1, 1),
                     padding="SAME", dilation=(1, 1)):
    """:func:`depthwise_conv2d` by ``depth_w`` ``[kh, kw, C_in, mult]`` at
    ``strides``, then a 1x1 :func:`conv2d` by ``point_w`` ``[1, 1, C_in *
    mult, C_out]`` with the bias."""
    out = depthwise_conv2d(x, depth_w, None, strides, padding, dilation)
    return conv2d(out, point_w, b, (1, 1), "SAME")


def upsampling2d(x, scale=2):
    """Nearest-neighbour upsampling of NHWC ``x``: each pixel repeated
    ``scale`` times along H, then along W (``jnp.repeat`` twice), as one
    broadcast copy."""
    s0, s1 = _pair(scale)
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, s0, w, s1, c).reshape(
        n, h * s0, w * s1, c)


# -------------------------------------------------------------- pooling
def _pool_pad(padding):
    """Pooling padding: "SAME"/"VALID", or per-axis symmetric (pH, pW)."""
    if isinstance(padding, str):
        return padding.upper()
    p = _pair(padding)
    return [(p[0], p[0]), (p[1], p[1])]


def _window(kernel, strides):
    k = _pair(kernel)
    return k, (_pair(strides) if strides is not None else k)


def _int_windows(x, k, s, pads, value=0):
    """Each window of the padded integer ``x`` as the two trailing axes:
    ``[N, oh, ow, C, kh, kw]``."""
    xp = _pad_nhwc(x, pads, value)
    return xp.unfold(1, k[0], s[0]).unfold(2, k[1], s[1])


def _sum_windows(x, k, s, pads):
    """The sum over each window of the zero-padded ``x``; integers sum
    exactly in their own dtype, as ``lax.reduce_window``'s add does."""
    if not x.is_floating_point():
        return _int_windows(x, k, s, pads).sum(dim=(-2, -1), dtype=x.dtype)
    return _nhwc(F.avg_pool2d(_nchw(_pad_nhwc(x, pads)), k, s,
                              divisor_override=1))


@register_op("maxpool2d")
def maxpool2d(x, kernel=(2, 2), strides=None, padding="VALID"):
    """The window max; padding takes no part (``-inf``, or an integer
    dtype's minimum, where the reference's ``-inf`` init converts)."""
    k, s = _window(kernel, strides)
    pads = _spatial_pads(_pool_pad(padding), x, k, s)
    if not x.is_floating_point():
        low = torch.iinfo(x.dtype).min
        return _int_windows(x, k, s, pads, low).amax(dim=(-2, -1))
    return _nhwc(F.max_pool2d(_nchw(_pad_nhwc(x, pads, float("-inf"))), k,
                              s))


@register_op("sumpool2d")
def sumpool2d(x, kernel=(2, 2), strides=None, padding="VALID"):
    k, s = _window(kernel, strides)
    return _sum_windows(x, k, s, _spatial_pads(_pool_pad(padding), x, k, s))


def _true_div(summed, count):
    """``jnp``'s ``/``: an integer sum becomes float32 before dividing."""
    if not summed.is_floating_point():
        summed = summed.to(torch.float32)
    return summed / count


@register_op("avgpool2d")
def avgpool2d(x, kernel=(2, 2), strides=None, padding="VALID"):
    """The window mean; with padding, over the window's real pixels only
    (the reference divides by the edge-clipped window sizes). An integer
    x sums exactly, then divides in float32, as ``jnp`` does."""
    k, s = _window(kernel, strides)
    pad = _pool_pad(padding)
    pads = _spatial_pads(pad, x, k, s)
    summed = _sum_windows(x, k, s, pads)
    if pad == "VALID":
        return _true_div(summed, k[0] * k[1])
    ones = torch.ones((1, x.shape[1], x.shape[2], 1), dtype=x.dtype,
                      device=x.device)
    return _true_div(summed, _sum_windows(ones, k, s, pads))


@register_op("pnormpool2d")
def pnormpool2d(x, kernel=(2, 2), strides=None, padding="VALID", p=2):
    k, s = _window(kernel, strides)
    summed = _sum_windows(torch.abs(x) ** p, k, s,
                          _spatial_pads(_pool_pad(padding), x, k, s))
    if not summed.is_floating_point():
        summed = summed.to(torch.float32)
    return summed ** (1.0 / p)


@register_op("global_avg_pool")
def global_avg_pool(x, spatial_axes=(1, 2)):
    """The mean over ``spatial_axes``; an integer x in float32, as
    ``jnp.mean`` promotes it."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=tuple(spatial_axes))


# -------------------------------------------------------- normalization
@register_op("batch_norm")
def batch_norm(x, gamma, beta, mean, var, eps=1e-5):
    """Inference-mode batch norm over the trailing channel axis, in the
    JAX op's order: ``(x - mean) * rsqrt(var + eps) * gamma + beta``."""
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * gamma + beta


@register_op("batch_norm_train")
def batch_norm_train(x, gamma, beta, eps=1e-5, axes=None):
    """Training-mode batch norm: ``(y, batch_mean, batch_var)``, the
    statistics over ``axes`` (default: all but the last, the channel
    axis) in f32 with the reference's shifted one-pass formula, scale and
    shift cast to x's dtype before the multiply-add, mean and variance
    returned in x's dtype. On CPU tensors the plain formula, whose
    gradient is autograd's as the reference's is ``jax.grad``'s; on CUDA
    tensors the kernels of ``ops.batch_norm``, whose backward gives the
    same gradients, those reaching the returned statistics included."""
    return bn.batch_norm_train(x, gamma, beta, eps, axes)


#: take ``batch_norm_relu_train`` in ``BatchNormalization`` layers with a
#: ReLU (the reference's ``FUSED_BN_RELU_BWD``, which it reads from
#: ``DL4J_TPU_FUSED_BN_RELU``); the port reads no environment variable,
#: so the caller sets this attribute
FUSED_BN_RELU_BWD = False


@register_op("batch_norm_relu_train")
def batch_norm_relu_train(x, gamma, beta, eps=1e-5, axes=None):
    """Training-mode batch norm with the ReLU fused: ``(relu(y),
    batch_mean, batch_var)``, the statistics detached (the reference's
    ``stop_gradient``: they feed only the running averages). The
    backward is the reference's two-pass ``custom_vjp``, which recomputes
    the ReLU mask from x: the plain version on CPU tensors, kernel (c) on
    CUDA tensors."""
    return bn.batch_norm_train(x, gamma, beta, eps, axes, relu=True)


@register_op("layer_norm")
def layer_norm(x, gamma, beta=None, axis=-1, eps=1e-5):
    """``(x - mean) * rsqrt(var + eps) * gamma + beta`` over ``axis``, the
    variance the mean of the squared deviations (``jnp.var``)."""
    m = torch.mean(x, dim=axis, keepdim=True)
    c = x - m
    v = torch.mean(c * c, dim=axis, keepdim=True)
    y = c * torch.rsqrt(v + eps) * gamma
    if beta is not None:
        y = y + beta
    return y


@register_op("lrn")
def local_response_normalization(x, depth_radius=5, bias=1.0, alpha=1.0,
                                 beta=0.5):
    """``x / (bias + alpha * sum of x^2 over 2 * depth_radius + 1
    channels) ** beta`` over the trailing channel axis, the window sum
    taken slice by slice in the reference's order."""
    sq = F.pad(x * x, (depth_radius, depth_radius))
    c = x.shape[-1]
    acc = sq[..., 0:c]
    for i in range(1, 2 * depth_radius + 1):
        acc = acc + sq[..., i:i + c]
    return x / torch.pow(bias + alpha * acc, beta)


def dropout(x, rate: float, generator: Optional[torch.Generator] = None):
    """Inverted dropout: each entry is kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``. The draws come from ``generator``
    (the same distribution as ``jax.random.bernoulli``, not the same
    bits)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def lstm_layer(x, w_ih, w_hh, b, h0=None, c0=None, reverse: bool = False):
    """LSTM over time: ``(outputs [N, T, H], (hT, cT))``.

    One input projection for all timesteps, ``x @ w_ih + b`` as a single
    ``[T*N, in] @ [in, 4H]`` product (a library matmul: the JAX layer
    leaves it to XLA outside any Pallas kernel), taken in time-major row
    order so the recurrence reads it without a transpose; then
    :func:`~deeplearning4j_tpu_torch.ops.lstm_recurrence.lstm_recurrence`
    (the hand kernels on the card, the plain versions on the CPU).
    ``reverse`` runs the recurrence from the last timestep to the first
    and returns the outputs in input order."""
    n, t, _ = x.shape
    hidden = w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
    xt = x.transpose(0, 1).reshape(t * n, -1)
    x_proj = (xt @ w_ih + b).reshape(t, n, 4 * hidden)      # [T, N, 4H]
    if reverse:
        x_proj = torch.flip(x_proj, dims=(0,))
    ys, hT, cT = lstm_recurrence(x_proj, w_hh, h0, c0)
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys.transpose(0, 1), (hT, cT)


def simple_rnn_layer(x, w_ih, w_hh, b, h0=None, activation=torch.tanh):
    """Elman RNN over time: ``(outputs [N, T, H], hT)`` with
    ``h_t = activation(x_t @ w_ih + b + h_{t-1} @ w_hh)``; the input
    projection of all timesteps is one matmul, as in the reference."""
    n, t, _ = x.shape
    hidden = w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
    x_proj = (x.reshape(n * t, -1) @ w_ih + b).reshape(n, t, hidden)
    h, ys = h0, []
    for s in range(t):
        h = activation(x_proj[:, s] + h @ w_hh)
        ys.append(h)
    return torch.stack(ys, dim=1), h


def dot_product_attention(q, k, v, mask=None, scale=None):
    """Scaled dot-product attention: ``q`` ``[..., Tq, d]``, ``k``
    ``[..., Tk, d]``, ``v`` ``[..., Tk, dv]``; ``mask`` broadcastable to
    ``[..., Tq, Tk]``, 1 attends and 0 is masked (its logits set to the
    dtype's lowest value). ``scale`` defaults to ``1 / sqrt(d)`` in
    ``q``'s dtype."""
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]),
                                              dtype=q.dtype))
    logits = torch.einsum("...qd,...kd->...qk", q, k) * scale
    if mask is not None:
        logits = torch.where(mask.to(torch.bool), logits,
                             torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("...qk,...kv->...qv", weights, v)
