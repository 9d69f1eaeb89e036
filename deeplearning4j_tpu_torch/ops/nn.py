"""Neural-net ops: counterpart of ``deeplearning4j_tpu/ops/nn.py``, every
name it registers, under its JAX name with its parameters and defaults
(``lstm_layer`` takes JAX's ``impl`` and runs B5 for "scan" and
"pallas" alike; ``dropout`` takes a ``torch.Generator`` or a seed as
``rng``).

The layer framework calls them directly: the convolutions (``conv2d``,
``conv1d``, ``conv3d``, ``deconv2d``, ``depthwise_conv2d``,
``separable_conv2d``), ``upsampling2d``, ``im2col``, the 1D, 2D and 3D
pools, the locally connected layers, the norms (:func:`batch_norm_train`
with its shifted one-pass statistics and :func:`batch_norm_relu_train`
with its two-pass backward, both through ``ops.batch_norm``), the
recurrent layers (:func:`lstm_layer` on B5, :func:`gru_layer` and
:func:`simple_rnn_layer` as plain loops over T, as ``lax.scan`` is) and
the attention. Copies of ``ops/declarable_tail.py``'s :func:`deconv3d`
and :func:`upsampling3d` (``:284-296``) stay unregistered until that file
is ported (ROADMAP A10.1b). The ONNX recurrences (``onnx_lstm_seq``,
``onnx_gru_seq``, ``onnx_rnn_seq``) are plain loops; ``ctc_loss`` is the
library's CTC (``optax.ctc_loss`` in the reference). No Pallas kernel
computes any of these but the LSTM recurrence.

Layouts stay the JAX package's, so a parameter tree from the JAX side
loads unchanged: images NHWC ``[N, H, W, C]``, conv weights HWIO
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

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import batch_norm as bn
from deeplearning4j_tpu_torch.ops.lstm_recurrence import lstm_recurrence
from deeplearning4j_tpu_torch.ops.registry import register_op
from deeplearning4j_tpu_torch.ops.transforms import (jax_abs, jax_clip, relu6,
                                                     softplus)


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


@register_op("depthwise_conv2d")
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


@register_op("separable_conv2d")
def separable_conv2d(x, depth_w, point_w, b=None, strides=(1, 1),
                     padding="SAME", dilation=(1, 1)):
    """:func:`depthwise_conv2d` by ``depth_w`` ``[kh, kw, C_in, mult]`` at
    ``strides``, then a 1x1 :func:`conv2d` by ``point_w`` ``[1, 1, C_in *
    mult, C_out]`` with the bias."""
    out = depthwise_conv2d(x, depth_w, None, strides, padding, dilation)
    return conv2d(out, point_w, b, (1, 1), "SAME")


@register_op("upsampling2d")
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
    # jnp.abs's slope 1 at 0, which a p of 1 passes on (C16)
    summed = _sum_windows(jax_abs(x) ** p, k, s,
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


@register_op("dropout")
def dropout(x, rate: float, rng, deterministic: bool = False):
    """Inverted dropout: each entry is kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``; ``deterministic`` or a rate of 0
    returns ``x``. The draws come from ``rng``, a ``torch.Generator`` or
    an integer seed where JAX takes a key, or None for torch's default
    generator (the same distribution as
    ``jax.random.bernoulli``, not the same bits)."""
    if deterministic or rate == 0.0:
        return x
    from deeplearning4j_tpu_torch.ops.random import generator_on

    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator_on(rng, x.device),
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


@register_op("lstm_layer")
def lstm_layer(x, w_ih, w_hh, b, h0=None, c0=None, reverse: bool = False,
               impl: str = "scan"):
    """LSTM over time: ``(outputs [N, T, H], (hT, cT))``.

    ``impl`` is JAX's choice between its scan and its Pallas kernel; the
    port validates it as JAX does (anything but "scan" or "pallas"
    raises) and takes the same path for both: B5's hand kernels on CUDA
    tensors, their plain versions on CPU tensors.

    One input projection for all timesteps, ``x @ w_ih + b`` as a single
    ``[T*N, in] @ [in, 4H]`` product (a library matmul: the JAX layer
    leaves it to XLA outside any Pallas kernel), taken in time-major row
    order so the recurrence reads it without a transpose; then
    :func:`~deeplearning4j_tpu_torch.ops.lstm_recurrence.lstm_recurrence`
    (the hand kernels on the card, the plain versions on the CPU).
    ``reverse`` runs the recurrence from the last timestep to the first
    and returns the outputs in input order."""
    if impl not in ("scan", "pallas"):
        raise ValueError(f"lstm_layer impl={impl!r}: 'scan' or 'pallas'")
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


@register_op("simple_rnn_layer")
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


@register_op("dot_product_attention")
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


# ------------------------------------------- 1D and 3D, channels last
#: the library's functions by the number of spatial axes
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _cf(x):
    """A channels-last tensor ``[N, *S, C]`` as the channels-first view the
    library takes (``channels_last`` / ``channels_last_3d`` strides when
    ``x`` is contiguous)."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _cl(y):
    return y.permute(0, *range(2, y.dim()), 1)


def _pad_cl(x, pads, value=0.0):
    """``(lo, hi)`` per spatial axis of a channels-last ``x``; a negative
    pad crops, as ``lax``'s does."""
    if all(lo == hi == 0 for lo, hi in pads):
        return x
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _pads_nd(padding, x, kernel, strides, dilation):
    """A resolved padding of a channels-last ``x`` over ``len(kernel)``
    spatial axes: "SAME" (``lax``'s, the odd cell high), "VALID", an int
    or a tuple of ints (symmetric) or a list of ``(lo, hi)`` pairs."""
    nd = len(kernel)
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return _same_pads(x.shape[1:1 + nd], kernel, strides, dilation)
        return [(0, 0)] * nd
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    if all(isinstance(q, (tuple, list)) for q in padding):
        return [tuple(int(v) for v in q) for q in padding]
    return [(int(v), int(v)) for v in padding]


def _conv_cl(x, w, b, strides, pads, dilation):
    """The correlation of channels-last ``x`` with ``w`` ``[*k, C_in,
    C_out]`` through the library: symmetric pads go to it, others are
    applied first."""
    nd = w.dim() - 2
    if all(lo == hi >= 0 for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        x, sym = _pad_cl(x, pads), (0,) * nd
    xc = _cf(x)
    if xc.device.type == "cpu":
        # C13: the CPU backward takes a channels-first copy
        xc = xc.contiguous()
    out = _cl(_CONV[nd](xc, w.permute(nd + 1, nd, *range(nd)), None,
                        tuple(strides), sym, tuple(dilation)))
    return out if b is None else out + b


@register_op("conv1d")
def conv1d(x, w, b=None, stride=1, padding="SAME", dilation=1):
    """1D convolution, NWC ``[N, T, C_in]`` x WIO ``[k, C_in, C_out]`` ->
    NWC; ``padding`` "SAME", "VALID" or an int a side."""
    pads = _pads_nd(padding, x, w.shape[:1], (stride,), (dilation,))
    return _conv_cl(x, w, b, (stride,), pads, (dilation,))


@register_op("conv3d")
def conv3d(x, w, b=None, strides=(1, 1, 1), padding="SAME",
           dilation=(1, 1, 1)):
    """3D convolution, NDHWC x DHWIO ``[kd, kh, kw, C_in, C_out]`` ->
    NDHWC (cuDNN on the ``channels_last_3d`` view on the card)."""
    s, d = _triple(strides), _triple(dilation)
    pads = _pads_nd(padding if isinstance(padding, str) else
                    _triple(padding), x, w.shape[:3], s, d)
    return _conv_cl(x, w, b, s, pads, d)


def _transpose_pads(k, s, padding):
    """``lax.conv_transpose``'s ``(lo, hi)`` pad of the stride-dilated
    input for "SAME" or "VALID" (``_conv_transpose_padding``): SAME gives
    ``in * s`` outputs, VALID ``(in - 1) * s + max(k, s)``."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    return lo, pad_len - lo


def _conv_transpose_cl(x, w, strides, padding):
    """``lax.conv_transpose`` without ``transpose_kernel``: channels-last
    ``x`` dilated by ``strides``, padded by ``padding`` ("SAME", "VALID"
    or ``(lo, hi)`` pairs) and correlated with ``w`` ``[*k, C_in, C_out]``
    as it is. The library's transposed convolution is the gradient of a
    convolution, so it takes ``w`` flipped and permuted, its ``padding``
    ``p`` is a pad of ``k - 1 - p`` a side and its ``output_padding``
    adds to the high side; pads it cannot say are cropped (or zero-padded)
    from its unpadded output."""
    nd = w.dim() - 2
    ks, s = tuple(w.shape[:nd]), tuple(strides)
    pads = ([_transpose_pads(k, st, padding.upper())
             for k, st in zip(ks, s)] if isinstance(padding, str)
            else [tuple(q) for q in padding])
    xc = _cf(x)
    if xc.device.type == "cpu":
        xc = xc.contiguous()
    wt = torch.flip(w, dims=tuple(range(nd))).permute(nd, nd + 1,
                                                     *range(nd))
    p = [k - 1 - lo for k, (lo, _) in zip(ks, pads)]
    op = [hi - lo for lo, hi in pads]
    if all(v >= 0 for v in p) and all(0 <= o < st for o, st in zip(op, s)):
        return _cl(_CONV_T[nd](xc, wt, None, s, p, op))
    full = _cl(_CONV_T[nd](xc, wt, None, s))          # pads k - 1 a side
    return _pad_cl(full, [(lo - (k - 1), hi - (k - 1))
                          for k, (lo, hi) in zip(ks, pads)])


@register_op("deconv2d")
def deconv2d(x, w, b=None, strides=(2, 2), padding="SAME"):
    """Transposed convolution, NHWC x ``[kh, kw, C_in, C_out]``: "SAME" or
    "VALID" as ``lax.conv_transpose`` pads them, or an integer padding
    ``p`` (an int or a pair) with the reference's ``s (in - 1) + k - 2p``
    output: a pad of ``k - 1 - p`` a side."""
    if isinstance(padding, str):
        pad = padding
    else:
        pad = [(k - 1 - p, k - 1 - p)
               for k, p in zip(w.shape[:2], _pair(padding))]
    out = _conv_transpose_cl(x, w, _pair(strides), pad)
    return out if b is None else out + b


def deconv3d(x, w, strides=(1, 1, 1), padding="VALID"):
    """3D transposed convolution, NDHWC x DHWIO: ``lax.conv_transpose``
    with ``padding`` "SAME", "VALID" or ``(lo, hi)`` pairs (a copy of
    JAX ``ops/declarable_tail.py:284-289``)."""
    return _conv_transpose_cl(x, w, tuple(strides), padding)


def upsampling3d(x, scale=2):
    """Each voxel of NDHWC ``x`` repeated ``scale`` times along D, H and W
    (JAX ``ops/declarable_tail.py:292-296``), as one broadcast copy."""
    s0, s1, s2 = _triple(scale)
    n, d, h, w, c = x.shape
    return x[:, :, None, :, None, :, None, :].expand(
        n, d, s0, h, s1, w, s2, c).reshape(n, d * s0, h * s1, w * s2, c)


@register_op("im2col")
def im2col(x, kernel, strides=(1, 1), padding="VALID"):
    """Patches of NHWC ``x``: ``[N, oh, ow, C * kh * kw]``, the feature
    axis channel-major ``(C, kh, kw)`` as
    ``lax.conv_general_dilated_patches`` orders it."""
    k, s = _pair(kernel), _pair(strides)
    pads = _pads_nd(padding, x, k, s, (1, 1))
    xp = _pad_cl(x, pads)
    p = xp.unfold(1, k[0], s[0]).unfold(2, k[1], s[1])  # [N,oh,ow,C,kh,kw]
    return p.reshape(p.shape[0], p.shape[1], p.shape[2], -1)


@register_op("locally_connected2d")
def locally_connected2d(x, w, b=None, kernel=(2, 2), strides=(1, 1),
                        padding="VALID"):
    """Unshared-weight convolution: ``w`` ``[oh * ow, C * kh * kw,
    C_out]``, one filter bank per output position over :func:`im2col`'s
    channel-major patches; ``b`` ``[oh, ow, C_out]`` or None."""
    patches = im2col(x, kernel, strides, padding)
    n, oh, ow, kc = patches.shape
    out = torch.einsum("npk,pko->npo", patches.reshape(n, oh * ow, kc), w)
    out = out.reshape(n, oh, ow, w.shape[-1])
    return out if b is None else out + b


@register_op("locally_connected1d")
def locally_connected1d(x, w, b=None, kernel=2, stride=1, padding="VALID"):
    """1D unshared-weight convolution of ``[N, T, F]``: ``w`` ``[oT, F * k,
    C_out]`` over channel-major ``(F, k)`` patches; ``b`` ``[oT, C_out]``
    or None."""
    pads = _pads_nd(padding, x, (kernel,), (stride,), (1,))
    p = _pad_cl(x, pads).unfold(1, kernel, stride)          # [N, oT, F, k]
    out = torch.einsum("npk,pko->npo", p.reshape(p.shape[0], p.shape[1], -1),
                       w)
    return out if b is None else out + b


# --------------------------------------------------- 1D and 3D pooling
def _pool_nd(kernel, strides, nd):
    k = (kernel,) * nd if isinstance(kernel, int) else tuple(kernel)
    if strides is None:
        return k, k
    return k, ((strides,) * nd if isinstance(strides, int)
               else tuple(strides))


def _pool_pads(padding, x, k, s):
    """``(mode, pads)``: "SAME" or "VALID" for a string ``padding`` (None
    for integer pads), and the resolved pads."""
    mode = padding.upper() if isinstance(padding, str) else None
    return mode, _pads_nd(padding, x, k, s, (1,) * len(k))


def _max_cl(x, k, s, pads):
    """The window max of channels-last ``x``, padding at ``-inf``; the
    library's pools pass the gradient to the first maximum of a window, as
    XLA's ``select_and_scatter`` does."""
    xc = _cf(_pad_cl(x, pads, float("-inf")))
    if len(k) == 1:
        return _cl(F.max_pool1d(xc, k, s))
    return _cl(F.max_pool3d(xc, k, s))


def _sum_cl(x, k, s, pads):
    """The sum over each window of the zero-padded channels-last ``x``."""
    xp = _pad_cl(x, pads)
    if len(k) == 1:
        y = F.avg_pool2d(_cf(xp)[:, :, None, :], (1, k[0]), (1, s[0]),
                         divisor_override=1)
        return _cl(y[:, :, 0, :])
    return _cl(F.avg_pool3d(_cf(xp), k, s, divisor_override=1))


def _avg_cl(x, k, s, padding):
    """The window mean; with padding, over the window's real cells only
    (the reference divides by a pool of ones)."""
    mode, pads = _pool_pads(padding, x, k, s)
    summed = _sum_cl(x, k, s, pads)
    if mode == "VALID":
        return summed / math.prod(k)
    ones = torch.ones((1, *x.shape[1:-1], 1), dtype=x.dtype, device=x.device)
    return summed / _sum_cl(ones, k, s, pads)


@register_op("maxpool1d")
def maxpool1d(x, kernel=2, stride=None, padding="VALID"):
    """Max pooling over the T axis of ``[N, T, F]``."""
    k, s = _pool_nd(kernel, stride, 1)
    return _max_cl(x, k, s, _pool_pads(padding, x, k, s)[1])


@register_op("avgpool1d")
def avgpool1d(x, kernel=2, stride=None, padding="VALID"):
    k, s = _pool_nd(kernel, stride, 1)
    return _avg_cl(x, k, s, padding)


@register_op("sumpool1d")
def sumpool1d(x, kernel=2, stride=None, padding="VALID"):
    k, s = _pool_nd(kernel, stride, 1)
    return _sum_cl(x, k, s, _pool_pads(padding, x, k, s)[1])


@register_op("pnormpool1d")
def pnormpool1d(x, kernel=2, stride=None, padding="VALID", p=2):
    """``(sum over the window of |x|^p)^(1/p)``, ``|x|`` with ``jnp.abs``'s
    slope 1 at 0."""
    k, s = _pool_nd(kernel, stride, 1)
    summed = _sum_cl(jax_abs(x) ** p, k, s, _pool_pads(padding, x, k, s)[1])
    return summed ** (1.0 / p)


@register_op("maxpool3d")
def maxpool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID"):
    """Max pooling over NDHWC."""
    k, s = _pool_nd(kernel, strides, 3)
    return _max_cl(x, k, s, _pool_pads(padding, x, k, s)[1])


@register_op("avgpool3d")
def avgpool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID"):
    """Average pooling over NDHWC, over the real cells of a padded
    window."""
    k, s = _pool_nd(kernel, strides, 3)
    return _avg_cl(x, k, s, padding)


# -------------------------------------------------------- GRU, attention
@register_op("gru_layer")
def gru_layer(x, w_ih, w_hh, b, h0=None, rb=None):
    """GRU over time: ``(outputs [N, T, H], hT)``; ``w_ih`` ``[in, 3H]``,
    ``w_hh`` ``[H, 3H]``, ``b`` ``[3H]``, gates r, z, n in that order, the
    reset applied after the recurrent product (``n = tanh(x_n + r (h
    w_hh_n + rb_n))``, Keras' ``reset_after``), ``rb`` ``[3H]`` an
    optional recurrent bias. The input projection of all timesteps is
    one matmul, then a plain loop over T."""
    n, t, _ = x.shape
    hidden = w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
    x_proj = (x.reshape(n * t, -1) @ w_ih + b).reshape(n, t, 3 * hidden)
    h, ys = h0, []
    for s in range(t):
        hp = h @ w_hh
        if rb is not None:
            hp = hp + rb
        xr, xz, xn = x_proj[:, s].chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        h = (1 - z) * torch.tanh(xn + r * hn) + z * h
        ys.append(h)
    return torch.stack(ys, dim=1), h


@register_op("multi_head_dot_product_attention")
def multi_head_dot_product_attention(x_q, x_kv, wq, wk, wv, wo, mask=None,
                                     num_heads=None):
    """Multi-head attention: ``x_q`` ``[N, Tq, D]``, ``x_kv`` ``[N, Tk,
    D]``, ``wq`` / ``wk`` / ``wv`` ``[D, H * dh]``, ``wo`` ``[H * dh,
    D_out]``; ``num_heads`` defaults to ``max(1, proj // 64)``; a ``[N,
    Tk]`` mask is a key-padding mask, broadcast over heads and queries."""
    n, tq, _ = x_q.shape
    proj = wq.shape[-1]
    h = num_heads if num_heads else max(1, proj // 64)
    dh = proj // h

    def split(y):
        return y.reshape(n, -1, h, dh).transpose(1, 2)     # [N, H, T, dh]

    if mask is not None and mask.dim() == 2:
        mask = mask[:, None, None, :]
    out = dot_product_attention(split(x_q @ wq), split(x_kv @ wk),
                                split(x_kv @ wv), mask)
    return out.transpose(1, 2).reshape(n, tq, proj) @ wo


# ------------------------------------------------ the rest of the names
@register_op("global_max_pool")
def global_max_pool(x, spatial_axes=(1, 2)):
    return torch.amax(x, dim=tuple(spatial_axes))


@register_op("xw_plus_b")
def xw_plus_b(x, w, b):
    return x @ w + b


@register_op("embedding_lookup")
def embedding_lookup(table, ids):
    """``jnp.take(table, ids, axis=0)``: an id out of range gives a row of
    the fill value (NaN for a float table), never a device assert."""
    from deeplearning4j_tpu_torch.ops.jax_rules import take_fill

    return take_fill(table, ids, 0)


@register_op("one_hot")
def one_hot(ids, depth, dtype="float32", on_value=1.0, off_value=0.0,
            axis=-1):
    """``jax.nn.one_hot``: an id out of ``[0, depth)`` gives a row of
    ``off_value``."""
    from deeplearning4j_tpu_torch.ops.jax_rules import torch_dtype

    dt = torch_dtype(dtype)
    hot = (ids.unsqueeze(-1) == torch.arange(int(depth), device=ids.device))
    if axis != -1:
        hot = torch.movedim(hot, -1, axis)
    hot = hot.to(dt)
    if on_value == 1.0 and off_value == 0.0:
        return hot
    return off_value + hot * (on_value - off_value)


@register_op("lstm_seq")
def lstm_seq(x, w_ih, w_hh, b, h0=None, c0=None, reverse=False):
    """:func:`lstm_layer` with a flat ``(ys, hT, cT)`` return."""
    ys, (hT, cT) = lstm_layer(x, w_ih, w_hh, b, h0=h0, c0=c0,
                              reverse=reverse)
    return ys, hT, cT


@register_op("gru_seq")
def gru_seq(x, w_ih, w_hh, b, rb, h0=None, reverse=False):
    """:func:`gru_layer` with ``rb`` positional and a ``reverse`` flag."""
    if reverse:
        x = torch.flip(x, (1,))
    ys, hT = gru_layer(x, w_ih, w_hh, b, h0=h0, rb=rb)
    if reverse:
        ys = torch.flip(ys, (1,))
    return ys, hT


# ----------------------------------------- ONNX-semantics recurrent ops
def _onnx_act(spec):
    """An ONNX activation ``(name, alpha, beta)`` as a function."""
    name, alpha, beta = spec
    n = name.lower()
    if n == "sigmoid":
        return torch.sigmoid
    if n == "tanh":
        return torch.tanh
    if n == "relu":
        return torch.relu
    if n == "leakyrelu":
        a = 0.01 if alpha is None else alpha
        return lambda v: torch.where(v >= 0, v, a * v)
    if n == "hardsigmoid":
        a = 0.2 if alpha is None else alpha
        c = 0.5 if beta is None else beta
        return lambda v: jax_clip(a * v + c, 0.0, 1.0)
    if n == "elu":
        a = 1.0 if alpha is None else alpha
        return lambda v: torch.where(v > 0, v, a * (torch.exp(v) - 1.0))
    if n == "softsign":
        return lambda v: v / (torch.abs(v) + 1)
    if n == "softplus":
        return lambda v: torch.logaddexp(v, torch.zeros_like(v))
    if n == "affine":
        a = 1.0 if alpha is None else alpha
        c = 0.0 if beta is None else beta
        return lambda v: a * v + c
    if n == "thresholdedrelu":
        a = 1.0 if alpha is None else alpha
        return lambda v: torch.where(v > a, v, torch.zeros_like(v))
    raise ValueError(f"unsupported RNN activation {name!r}")


def _rev_seq(x, lens):
    from deeplearning4j_tpu_torch.ops.shape import reverse_sequence

    return reverse_sequence(x, lens, seq_axis=1, batch_axis=0)


def _maybe_clip(v, clip):
    return jax_clip(v, -clip, clip) if clip else v


def _onnx_scan(x, lens, reverse, x_proj, step, carry):
    """The ONNX recurrences' loop: ``step(carry, xp_t) -> (carry, y)``
    over T; with ``lens``, rows at ``t >= len`` emit 0 and freeze their
    carry; ``reverse`` runs each row over its own prefix reversed."""
    t = x_proj.shape[1]
    ys = []
    for s in range(t):
        new, y = step(carry, x_proj[:, s])
        if lens is not None:
            valid = (s < lens)[:, None]
            y = torch.where(valid, y, torch.zeros_like(y))
            new = tuple(torch.where(valid, a, b) for a, b in zip(new, carry))
        carry = new
        ys.append(y)
    ys = torch.stack(ys, dim=1)
    if reverse:
        ys = _rev_seq(ys, lens) if lens is not None else torch.flip(ys, (1,))
    return ys, carry


def _onnx_prep(x, w_ih, b, reverse, lens, gates):
    n, t, _ = x.shape
    if reverse:
        x = _rev_seq(x, lens) if lens is not None else torch.flip(x, (1,))
    return (x.reshape(n * t, -1) @ w_ih + b).reshape(n, t, gates)


@register_op("onnx_lstm_seq")
def onnx_lstm_seq(x, w_ih, w_hh, b, *rest, has_state=False,
                  has_lens=False, has_peep=False, reverse=False,
                  cell_clip=0.0, input_forget=False, acts=None):
    """ONNX LSTM for one direction (gates i, f, g, o): ``rest`` holds h0
    and c0 if ``has_state``, seq_lens if ``has_lens``, peepholes ``[3,
    H]`` (i, f, o) if ``has_peep``. Returns ``(ys, hT, cT)``. A plain
    loop over T, as JAX's is a ``lax.scan``."""
    n = x.shape[0]
    hidden = w_hh.shape[0]
    k = 0
    if has_state:
        h0, c0 = rest[0], rest[1]
        k = 2
    else:
        h0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
        c0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
    lens = rest[k].to(torch.int32) if has_lens else None
    k += int(has_lens)
    peep = rest[k] if has_peep else None
    f_act, g_act, h_act = [_onnx_act(a) for a in (
        acts or (("sigmoid", None, None), ("tanh", None, None),
                 ("tanh", None, None)))]
    x_proj = _onnx_prep(x, w_ih, b, reverse, lens, 4 * hidden)

    def step(carry, xp):
        h, c = carry
        gi, gf, gg, go = (xp + h @ w_hh).chunk(4, dim=-1)
        if peep is not None:
            gi = gi + peep[0] * c
            gf = gf + peep[1] * c
        i = f_act(_maybe_clip(gi, cell_clip))
        f = (1.0 - i) if input_forget else f_act(_maybe_clip(gf, cell_clip))
        g = g_act(_maybe_clip(gg, cell_clip))
        c2 = f * c + i * g
        if peep is not None:
            go = go + peep[2] * c2
        h2 = f_act(_maybe_clip(go, cell_clip)) * h_act(c2)
        return (h2, c2), h2

    ys, (hT, cT) = _onnx_scan(x, lens, reverse, x_proj, step, (h0, c0))
    return ys, hT, cT


@register_op("onnx_gru_seq")
def onnx_gru_seq(x, w_ih, w_hh, wb, rb, *rest, has_state=False,
                 has_lens=False, reverse=False,
                 linear_before_reset=True, cell_clip=0.0, acts=None):
    """ONNX GRU for one direction (gates r, z, n): ``rest`` holds h0 if
    ``has_state``, then seq_lens if ``has_lens``. ``linear_before_reset``
    True is torch's form ``n = g(xn + r (h Rn + rbn))``, False ONNX's
    default ``n = g(xn + (r h) Rn + rbn)``. Returns ``(ys, hT)``."""
    n = x.shape[0]
    hidden = w_hh.shape[0]
    k = 0
    if has_state:
        h0 = rest[0]
        k = 1
    else:
        h0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
    lens = rest[k].to(torch.int32) if has_lens else None
    f_act, g_act = [_onnx_act(a) for a in (
        acts or (("sigmoid", None, None), ("tanh", None, None)))]
    x_proj = _onnx_prep(x, w_ih, wb, reverse, lens, 3 * hidden)

    def step(carry, xp):
        (h,) = carry
        xr, xz, xn = xp.chunk(3, dim=-1)
        if linear_before_reset:
            hr, hz, hn = (h @ w_hh + rb).chunk(3, dim=-1)
        else:
            hr, hz = (h @ w_hh[:, :2 * hidden] + rb[:2 * hidden]).chunk(
                2, dim=-1)
        r = f_act(_maybe_clip(xr + hr, cell_clip))
        z = f_act(_maybe_clip(xz + hz, cell_clip))
        if linear_before_reset:
            n_pre = xn + r * hn
        else:
            n_pre = xn + (r * h) @ w_hh[:, 2 * hidden:] + rb[2 * hidden:]
        h2 = (1.0 - z) * g_act(_maybe_clip(n_pre, cell_clip)) + z * h
        return (h2,), h2

    ys, (hT,) = _onnx_scan(x, lens, reverse, x_proj, step, (h0,))
    return ys, hT


@register_op("onnx_rnn_seq")
def onnx_rnn_seq(x, w_ih, w_hh, b, *rest, has_state=False,
                 has_lens=False, reverse=False, cell_clip=0.0,
                 acts=None):
    """ONNX vanilla RNN for one direction: ``h = f(x W + h R + b)``, the
    same ``rest`` convention as the GRU. Returns ``(ys, hT)``."""
    n = x.shape[0]
    hidden = w_hh.shape[0]
    k = 0
    if has_state:
        h0 = rest[0]
        k = 1
    else:
        h0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
    lens = rest[k].to(torch.int32) if has_lens else None
    f_act = _onnx_act(acts[0] if acts else ("tanh", None, None))
    x_proj = _onnx_prep(x, w_ih, b, reverse, lens, hidden)

    def step(carry, xp):
        h2 = f_act(_maybe_clip(xp + carry[0] @ w_hh, cell_clip))
        return (h2,), h2

    ys, (hT,) = _onnx_scan(x, lens, reverse, x_proj, step, (h0,))
    return ys, hT


# ------------------------------------------------ losses-adjacent ops
def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("softmax_cross_entropy")
def softmax_cross_entropy(logits, labels, axis=-1):
    """Per-example cross entropy with probabilistic labels."""
    return -torch.sum(labels * torch.log_softmax(logits, dim=axis), dim=axis)


@register_op("sigmoid_cross_entropy")
def sigmoid_cross_entropy(logits, labels):
    return (torch.maximum(logits, _zero(logits)) - logits * labels
            + torch.log1p(torch.exp(-jax_abs(logits))))


@register_op("log_loss")
def log_loss(probs, labels, eps=1e-7):
    p = jax_clip(probs, eps, 1 - eps)
    return -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))


# ------------------------------- activation / normalization long tail
@register_op("celu")
def celu(x, alpha=1.0):
    """``jax.nn.celu``: ``max(x, 0) + alpha expm1(min(x, 0) / alpha)``."""
    z = _zero(x)
    return torch.maximum(x, z) + alpha * torch.expm1(torch.minimum(x, z)
                                                     / alpha)


@register_op("glu")
def glu(x, axis=-1):
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


@register_op("log_sigmoid")
def log_sigmoid(x):
    """``-softplus(-x)``, as ``jax.nn.log_sigmoid``."""
    return -softplus(-x)


@register_op("hard_swish")
def hard_swish(x):
    """``x * relu6(x + 3) / 6``, as ``jax.nn.hard_swish``."""
    return x * relu6(x + 3.0) / 6.0


@register_op("group_norm")
def group_norm(x, gamma, beta, num_groups, eps=1e-5):
    """Channel-last group norm; statistics per (sample, group)."""
    c = x.shape[-1]
    xs = x.reshape(x.shape[:-1] + (num_groups, c // num_groups))
    ax = tuple(range(1, x.dim() - 1)) + (x.dim(),)
    m = torch.mean(xs, dim=ax, keepdim=True)
    v = torch.var(xs, dim=ax, keepdim=True, correction=0)
    xs = (xs - m) * torch.rsqrt(v + eps)
    return xs.reshape(x.shape) * gamma + beta


@register_op("instance_norm")
def instance_norm(x, gamma, beta, eps=1e-5):
    """Per-sample, per-channel norm over the spatial axes (NHWC)."""
    ax = tuple(range(1, x.dim() - 1))
    m = torch.mean(x, dim=ax, keepdim=True)
    v = torch.var(x, dim=ax, keepdim=True, correction=0)
    return (x - m) * torch.rsqrt(v + eps) * gamma + beta


@register_op("rms_norm")
def rms_norm(x, gamma, eps=1e-6):
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


# ----------------------------------------------------- loss long tail
@register_op("huber_loss")
def huber_loss(labels, predictions, delta=1.0):
    err = jax_abs(predictions - labels)
    quad = torch.minimum(err, torch.tensor(delta, dtype=err.dtype,
                                           device=err.device))
    return 0.5 * quad * quad + delta * (err - quad)


@register_op("hinge_loss")
def hinge_loss(labels, logits):
    """Labels in {0, 1} taken as {-1, 1}."""
    all_ones = 2.0 * labels - 1.0
    v = 1.0 - all_ones * logits
    return torch.maximum(_zero(v), v)


@register_op("kl_divergence")
def kl_divergence(p, q, axis=-1, eps=1e-12):
    return torch.sum(p * (torch.log(p + eps) - torch.log(q + eps)), dim=axis)


@register_op("poisson_nll_loss")
def poisson_nll_loss(targets, log_input):
    return torch.exp(log_input) - targets * log_input


@register_op("mean_pairwise_squared_error")
def mean_pairwise_squared_error(labels, predictions):
    """The mean squared difference over ordered element pairs of each
    sample: ``n (n - 1)`` pairs."""
    d = (predictions - labels).reshape(labels.shape[0], -1)
    n = d.shape[-1]
    s1 = torch.sum(d, dim=-1)
    s2 = torch.sum(d * d, dim=-1)
    return 2.0 * (n * s2 - s1 * s1) / (n * max(n - 1, 1))


@register_op("ctc_loss")
def ctc_loss(log_probs, labels, logit_lengths, label_lengths, blank=0):
    """Per-sequence CTC loss, as ``optax.ctc_loss`` computes it from the
    JAX op's arguments: ``log_probs`` ``[B, T, C]`` are taken as logits
    (normalised again, which leaves log-probabilities as they are),
    ``labels`` ``[B, L]``, the lengths ``[B]``. The library's CTC forward
    (``F.ctc_loss``), a dynamic program outside any kernel in both
    packages."""
    lp = torch.log_softmax(log_probs.to(torch.float32), dim=-1)
    return F.ctc_loss(lp.transpose(0, 1), labels.to(torch.int64),
                      logit_lengths.to(torch.int64),
                      label_lengths.to(torch.int64), blank=int(blank),
                      reduction="none", zero_infinity=False)
