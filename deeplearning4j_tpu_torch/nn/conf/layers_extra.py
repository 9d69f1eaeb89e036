"""The classes of ``deeplearning4j_tpu/nn/conf/layers_extra.py``, each
with the JAX class's name, fields, parameter keys and shapes:

- recurrent: :class:`GRU` (``ops.nn.gru_layer``, a plain loop over T),
  :class:`GravesBidirectionalLSTM` (``Bidirectional(LSTM, "CONCAT")``, so
  the LSTM kernels on the card) and :class:`MaskZeroLayer`;
- 1D, on ``[N, T, F]``: :class:`Convolution1D`,
  :class:`Subsampling1DLayer`, :class:`Upsampling1D`, :class:`Cropping1D`,
  :class:`ZeroPadding1DLayer`, :class:`LocallyConnected1D`;
- 2D, on NHWC: :class:`Deconvolution2D`, :class:`DepthwiseConvolution2D`,
  :class:`Cropping2D`, :class:`SpaceToDepthLayer`,
  :class:`SpaceToBatchLayer`, :class:`LocallyConnected2D`;
- 3D, on NDHWC: :class:`Convolution3D`, :class:`Deconvolution3D`,
  :class:`Subsampling3DLayer`, :class:`Upsampling3D`, :class:`Cropping3D`,
  :class:`ZeroPadding3DLayer`;
- misc: :class:`PReLULayer`, :class:`ElementWiseMultiplicationLayer`,
  :class:`RepeatVector`, :class:`MaskLayer`, :class:`CenterLossOutputLayer`;
- capsules (Sabour et al. 2017): :class:`PrimaryCapsules`,
  :class:`CapsuleLayer`, :class:`CapsuleStrengthLayer`;
- structural: :class:`LambdaLayer` (a torch function; not serializable,
  so a network holding one raises at ``to_json()``), :class:`PermuteLayer`
  and :class:`ReshapeLayer`.

Same contract as ``nn/conf/layers.py``: serializable dataclasses, plain
functions of tensors in the JAX layouts (sequences NTF, images NHWC,
volumes NDHWC), draws from an explicit ``torch.Generator``. As in JAX,
``PReLULayer``, ``ElementWiseMultiplicationLayer``,
``LocallyConnected2D`` and ``CapsuleLayer`` write the fields they infer
into the configuration at ``init_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.serde import serializable, tuplify
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, Bidirectional, ConvolutionLayer, Layer, OutputLayer, _act,
    _conv_out)
from deeplearning4j_tpu_torch.nn.weights import WeightInit, init_weights
from deeplearning4j_tpu_torch.ops import nn as nnops
from deeplearning4j_tpu_torch.ops import shape as shapeops
from deeplearning4j_tpu_torch.ops.transforms import prelu


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _weight(layer, generator, shape, fan_in, fan_out, dtype, device):
    return init_weights(layer.weight_init or WeightInit.XAVIER, generator,
                        shape, fan_in, fan_out, dtype, device)


def _triples(layer, *names):
    for f in names:
        v = getattr(layer, f)
        setattr(layer, f, (v, v, v) if isinstance(v, int) else tuplify(v))


# ------------------------------------------------------------ recurrent
@serializable
@dataclasses.dataclass
class GRU(Layer):
    """GRU, gates r, z, n, reset after the recurrent product: ``W`` ``[in,
    3H]``, ``RW`` ``[H, 3H]``, ``b`` ``[3H]``, and ``Rb`` ``[3H]`` where
    ``recurrent_bias`` is set (Keras' two biases)."""

    n_in: int = 0
    n_out: int = 0
    #: a separate bias on the recurrent product (parameter ``Rb``)
    recurrent_bias: bool = False

    is_recurrent = True

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it, dtype, device) -> dict:
        h = self.n_out
        p = {"W": _weight(self, generator, (self.n_in, 3 * h), self.n_in,
                          3 * h, dtype, device),
             "RW": _weight(self, generator, (h, 3 * h), h, 3 * h, dtype,
                           device),
             "b": _zeros((3 * h,), dtype, device)}
        if self.recurrent_bias:
            p["Rb"] = _zeros((3 * h,), dtype, device)
        return p

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        ys, _ = nnops.gru_layer(x, params["W"], params["RW"], params["b"],
                                rb=params.get("Rb"))
        return ys, state

    def init_carry(self, batch, dtype, device):
        return _zeros((batch, self.n_out), dtype, device)

    def apply_with_carry(self, params, state, carry, x, train, generator):
        ys, new_carry = nnops.gru_layer(x, params["W"], params["RW"],
                                        params["b"], h0=carry,
                                        rb=params.get("Rb"))
        return ys, state, new_carry


@serializable
@dataclasses.dataclass
class GravesBidirectionalLSTM(Layer):
    """Two LSTMs, forward and over the reversed sequence, concatenated:
    ``Bidirectional(LSTM(...), "CONCAT")`` with parameters ``fw`` and
    ``bw``, two launches of the LSTM kernels a direction on the card.
    Stepping is refused."""

    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0

    is_recurrent = True

    def _delegate(self) -> Bidirectional:
        return Bidirectional(layer=LSTM(
            n_in=self.n_in, n_out=self.n_out,
            forget_gate_bias_init=self.forget_gate_bias_init,
            activation=self.activation, weight_init=self.weight_init,
            dropout=self.dropout, l1=self.l1, l2=self.l2), mode="CONCAT")

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(2 * self.n_out, it.timeseries_length)

    def init_params(self, generator, it, dtype, device) -> dict:
        return self._delegate().init_params(generator, it, dtype, device)

    def apply(self, params, state, x, train, generator):
        return self._delegate().apply(params, state, x, train, generator)

    def init_carry(self, batch, dtype, device):
        raise NotImplementedError(
            "rnnTimeStep is not supported for GravesBidirectionalLSTM "
            "(reference behavior: requires the full sequence)")


@serializable
@dataclasses.dataclass
class MaskZeroLayer(Layer):
    """A wrapped recurrent layer whose output is zero at the timesteps
    where every input feature equals ``mask_value``. ``n_in`` is the
    wrapped layer's, so the builder infers it there."""

    layer: Optional[Layer] = None
    mask_value: float = 0.0

    @property
    def is_recurrent(self):
        return self.layer is not None and self.layer.is_recurrent

    @property
    def n_in(self):
        return self.layer.n_in

    @n_in.setter
    def n_in(self, v):
        self.layer.n_in = v

    @property
    def n_out(self):
        return self.layer.n_out

    def has_params(self):
        return self.layer.has_params()

    def output_type(self, it: InputType) -> InputType:
        return self.layer.output_type(it)

    def init_params(self, generator, it, dtype, device) -> dict:
        return self.layer.init_params(generator, it, dtype, device)

    def init_state(self, it, dtype, device) -> dict:
        return self.layer.init_state(it, dtype, device)

    def apply(self, params, state, x, train, generator):
        mask = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        out, st = self.layer.apply(params, state, x, train, generator)
        return out * mask.to(out.dtype), st


# ------------------------------------------------------- 1D, on [N, T, F]
def _t_out(it: InputType, k, s, mode, pad, dilation=1):
    t = it.timeseries_length
    if t and t > 0:
        t = _conv_out(t, k, s, mode, pad, dilation)
    return t


@serializable
@dataclasses.dataclass
class Convolution1D(Layer):
    """1D convolution over T (``ops.nn.conv1d``): ``W`` ``[k, n_in,
    n_out]``, ``b`` ``[n_out]``."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    convolution_mode: str = "Truncate"
    dilation: int = 1
    has_bias: bool = True

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, _t_out(
            it, self.kernel_size, self.stride, self.convolution_mode,
            self.padding, self.dilation))

    def init_params(self, generator, it, dtype, device) -> dict:
        k = self.kernel_size
        p = {"W": _weight(self, generator, (k, self.n_in, self.n_out),
                          k * self.n_in, k * self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = _zeros((self.n_out,), dtype, device)
        return p

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        pad = "SAME" if self.convolution_mode == "Same" else self.padding
        out = nnops.conv1d(x, params["W"], params.get("b"),
                           stride=self.stride, padding=pad,
                           dilation=self.dilation)
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class Subsampling1DLayer(Layer):
    """Pooling over T: max, avg, sum or pnorm."""

    pooling_type: str = "max"
    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: str = "Truncate"
    pnorm: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.size, _t_out(
            it, self.kernel_size, self.stride, self.convolution_mode,
            self.padding))

    def apply(self, params, state, x, train, generator):
        pad = "SAME" if self.convolution_mode == "Same" else (
            "VALID" if self.padding == 0 else self.padding)
        k, s = self.kernel_size, self.stride
        pt = self.pooling_type.lower()
        if pt == "max":
            return nnops.maxpool1d(x, k, s, pad), state
        if pt == "avg":
            return nnops.avgpool1d(x, k, s, pad), state
        if pt == "pnorm":
            return nnops.pnormpool1d(x, k, s, pad, self.pnorm), state
        return nnops.sumpool1d(x, k, s, pad), state


@serializable
@dataclasses.dataclass
class Upsampling1D(Layer):
    """Each timestep repeated ``size`` times."""

    size: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length
        return InputType.recurrent(it.size,
                                   t * self.size if t and t > 0 else t)

    def apply(self, params, state, x, train, generator):
        return torch.repeat_interleave(x, self.size, dim=1), state


@serializable
@dataclasses.dataclass
class Cropping1D(Layer):
    """``crop`` ``(start, end)`` timesteps cut from the two ends."""

    crop: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        c = self.crop
        self.crop = (c, c) if isinstance(c, int) else tuplify(c)

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length
        if t and t > 0:
            t = t - self.crop[0] - self.crop[1]
        return InputType.recurrent(it.size, t)

    def apply(self, params, state, x, train, generator):
        return x[:, self.crop[0]:x.shape[1] - self.crop[1], :], state


@serializable
@dataclasses.dataclass
class ZeroPadding1DLayer(Layer):
    """``pad`` ``(start, end)`` zero timesteps."""

    pad: Tuple[int, int] = (1, 1)

    def __post_init__(self):
        p = self.pad
        self.pad = (p, p) if isinstance(p, int) else tuplify(p)

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length
        if t and t > 0:
            t = t + self.pad[0] + self.pad[1]
        return InputType.recurrent(it.size, t)

    def apply(self, params, state, x, train, generator):
        return F.pad(x, (0, 0, self.pad[0], self.pad[1])), state


@serializable
@dataclasses.dataclass
class LocallyConnected1D(Layer):
    """Unshared-weight 1D convolution (``ops.nn.locally_connected1d``):
    ``W`` ``[oT, n_in * k, n_out]`` (channel-major patches), a
    per-position ``b`` ``[oT, n_out]``; needs a fixed length."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 2
    stride: int = 1
    has_bias: bool = True

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, _t_out(
            it, self.kernel_size, self.stride, "Truncate", 0))

    def init_params(self, generator, it, dtype, device) -> dict:
        t = it.timeseries_length
        if not t or t <= 0:
            raise ValueError(
                "LocallyConnected1D needs a fixed sequence length")
        ot = _conv_out(t, self.kernel_size, self.stride, "Truncate", 0)
        kc = self.kernel_size * self.n_in
        p = {"W": _weight(self, generator, (ot, kc, self.n_out), kc,
                          self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = _zeros((ot, self.n_out), dtype, device)
        return p

    def apply(self, params, state, x, train, generator):
        out = nnops.locally_connected1d(x, params["W"], params.get("b"),
                                        self.kernel_size, self.stride,
                                        "VALID")
        return _act(self.activation or "identity").fn(out), state


# ----------------------------------------------------------- 2D, on NHWC
@serializable
@dataclasses.dataclass
class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution (``ops.nn.deconv2d``), ``W`` ``[kh, kw,
    n_in, n_out]`` correlated as it is with the stride-dilated input, as
    ``lax.conv_transpose`` does; Truncate gives ``s (in - 1) + k - 2p``."""

    def output_type(self, it: InputType) -> InputType:
        if self.convolution_mode == "Same":
            h = it.height * self.stride[0]
            w = it.width * self.stride[1]
        else:
            h = self.stride[0] * (it.height - 1) + self.kernel_size[0] \
                - 2 * self.padding[0]
            w = self.stride[1] * (it.width - 1) + self.kernel_size[1] \
                - 2 * self.padding[1]
        return InputType.convolutional(h, w, self.n_out)

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        pad = "SAME" if self.convolution_mode == "Same" else self.padding
        out = nnops.deconv2d(x, params["W"], params.get("b"),
                             strides=self.stride, padding=pad)
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class DepthwiseConvolution2D(ConvolutionLayer):
    """Depthwise convolution (``ops.nn.depthwise_conv2d``): ``W`` ``[kh,
    kw, C_in, depth_multiplier]``, ``b`` ``[C_in * depth_multiplier]``; the
    output has ``n_in * depth_multiplier`` channels whatever ``n_out``
    says."""

    depth_multiplier: int = 1

    def output_type(self, it: InputType) -> InputType:
        base = super().output_type(it)
        return InputType.convolutional(base.height, base.width,
                                       self.n_in * self.depth_multiplier)

    def init_params(self, generator, it, dtype, device) -> dict:
        kh, kw = self.kernel_size
        fan = kh * kw * self.n_in
        p = {"W": _weight(self, generator,
                          (kh, kw, self.n_in, self.depth_multiplier), fan,
                          fan * self.depth_multiplier, dtype, device)}
        if self.has_bias:
            p["b"] = _zeros((self.n_in * self.depth_multiplier,), dtype,
                            device)
        return p

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        pad = "SAME" if self.convolution_mode == "Same" else self.padding
        out = nnops.depthwise_conv2d(x, params["W"], params.get("b"),
                                     strides=self.stride, padding=pad,
                                     dilation=self.dilation)
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class Cropping2D(Layer):
    """``crop`` ``(top, bottom, left, right)`` pixels cut (an int or a
    pair spreads)."""

    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def __post_init__(self):
        c = tuplify(self.crop)
        if isinstance(c, int):
            c = (c, c, c, c)
        elif len(c) == 2:
            c = (c[0], c[0], c[1], c[1])
        self.crop = c

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        t, b, l, r = self.crop
        return InputType.convolutional(it.height - t - b, it.width - l - r,
                                       it.channels)

    def apply(self, params, state, x, train, generator):
        t, b, l, r = self.crop
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :], state


@serializable
@dataclasses.dataclass
class SpaceToDepthLayer(Layer):
    """``ops.shape.space_to_depth`` by ``block_size``: ``[N, H, W, C]`` to
    ``[N, H / b, W / b, C * b * b]``."""

    block_size: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        bs = self.block_size
        return InputType.convolutional(it.height // bs, it.width // bs,
                                       it.channels * bs * bs)

    def apply(self, params, state, x, train, generator):
        return shapeops.space_to_depth(x, self.block_size), state


@serializable
@dataclasses.dataclass
class SpaceToBatchLayer(Layer):
    """``ops.shape.space_to_batch`` by a square ``block_size`` after
    ``padding`` ``((top, bottom), (left, right))``."""

    block_size: int = 2
    padding: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0))

    def __post_init__(self):
        self.padding = tuple(tuplify(v) for v in tuplify(self.padding))

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        bs = self.block_size
        (pt, pb), (pl, pr) = self.padding
        return InputType.convolutional((it.height + pt + pb) // bs,
                                       (it.width + pl + pr) // bs,
                                       it.channels)

    def apply(self, params, state, x, train, generator):
        return shapeops.space_to_batch(
            x, (self.block_size, self.block_size), list(self.padding)), state


@serializable
@dataclasses.dataclass
class LocallyConnected2D(Layer):
    """Unshared-weight 2D convolution (``ops.nn.locally_connected2d``),
    VALID: ``W`` ``[oh * ow, n_in * kh * kw, n_out]`` (channel-major
    patches), a per-position ``b`` ``[oh, ow, n_out]``; ``input_size`` is
    set from the input type at ``init_params``."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (1, 1)
    has_bias: bool = True
    #: resolved at init from the input type
    input_size: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.kernel_size = tuplify(self.kernel_size)
        self.stride = tuplify(self.stride)
        self.input_size = tuplify(self.input_size)

    def _out_hw(self, it: InputType):
        return tuple(_conv_out(n, k, s, "Truncate", 0) for n, k, s in zip(
            (it.height, it.width), self.kernel_size, self.stride))

    def output_type(self, it: InputType) -> InputType:
        h, w = self._out_hw(it)
        return InputType.convolutional(h, w, self.n_out)

    def init_params(self, generator, it, dtype, device) -> dict:
        self.input_size = (it.height, it.width)
        oh, ow = self._out_hw(it)
        kh, kw = self.kernel_size
        kc = kh * kw * self.n_in
        p = {"W": _weight(self, generator, (oh * ow, kc, self.n_out), kc,
                          self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = _zeros((oh, ow, self.n_out), dtype, device)
        return p

    def apply(self, params, state, x, train, generator):
        out = nnops.locally_connected2d(x, params["W"], params.get("b"),
                                        self.kernel_size, self.stride,
                                        "VALID")
        return _act(self.activation or "identity").fn(out), state


# ---------------------------------------------------------- 3D, on NDHWC
@serializable
@dataclasses.dataclass
class Convolution3D(Layer):
    """3D convolution (``ops.nn.conv3d``, cuDNN on the
    ``channels_last_3d`` view on the card): ``W`` DHWIO ``[kd, kh, kw,
    n_in, n_out]``, ``b`` ``[n_out]``."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Tuple[int, int, int] = (0, 0, 0)
    convolution_mode: str = "Truncate"
    dilation: Tuple[int, int, int] = (1, 1, 1)
    has_bias: bool = True

    def __post_init__(self):
        _triples(self, "kernel_size", "stride", "padding", "dilation")

    def output_type(self, it: InputType) -> InputType:
        dims = [_conv_out(n, self.kernel_size[i], self.stride[i],
                          self.convolution_mode, self.padding[i],
                          self.dilation[i])
                for i, n in enumerate((it.depth, it.height, it.width))]
        return InputType.convolutional3D(*dims, self.n_out)

    def init_params(self, generator, it, dtype, device) -> dict:
        kd, kh, kw = self.kernel_size
        taps = kd * kh * kw
        p = {"W": _weight(self, generator, (kd, kh, kw, self.n_in,
                                            self.n_out), taps * self.n_in,
                          taps * self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = _zeros((self.n_out,), dtype, device)
        return p

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        pad = "SAME" if self.convolution_mode == "Same" else self.padding
        out = nnops.conv3d(x, params["W"], params.get("b"),
                           strides=self.stride, padding=pad,
                           dilation=self.dilation)
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class Deconvolution3D(Convolution3D):
    """3D transposed convolution (``ops.nn.deconv3d``); Truncate gives
    ``s (in - 1) + k - 2p`` (a pad of ``k - 1 - p`` a side of the
    stride-dilated input). No dilation."""

    def __post_init__(self):
        super().__post_init__()
        if tuple(self.dilation) != (1, 1, 1):
            raise ValueError(
                "Deconvolution3D does not support dilation != (1,1,1) "
                "(the transposed-conv lowering has no dilated form here); "
                f"got {self.dilation}")

    def output_type(self, it: InputType) -> InputType:
        dims = []
        for i, n in enumerate((it.depth, it.height, it.width)):
            if self.convolution_mode == "Same":
                dims.append(n * self.stride[i])
            else:
                dims.append(self.stride[i] * (n - 1) + self.kernel_size[i]
                            - 2 * self.padding[i])
        return InputType.convolutional3D(*dims, self.n_out)

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        if self.convolution_mode == "Same":
            pad = "SAME"
        else:
            pad = [(k - 1 - p, k - 1 - p)
                   for k, p in zip(self.kernel_size, self.padding)]
        out = nnops.deconv3d(x, params["W"], strides=self.stride,
                             padding=pad)
        if self.has_bias:
            out = out + params["b"]
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class Subsampling3DLayer(Layer):
    """3D pooling, max or avg (``ops.nn.maxpool3d`` / ``avgpool3d``)."""

    pooling_type: str = "max"
    kernel_size: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    padding: Tuple[int, int, int] = (0, 0, 0)
    convolution_mode: str = "Truncate"

    def __post_init__(self):
        _triples(self, "kernel_size", "stride", "padding")

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        dims = [_conv_out(n, self.kernel_size[i], self.stride[i],
                          self.convolution_mode, self.padding[i])
                for i, n in enumerate((it.depth, it.height, it.width))]
        return InputType.convolutional3D(*dims, it.channels)

    def apply(self, params, state, x, train, generator):
        pad = "SAME" if self.convolution_mode == "Same" else (
            "VALID" if self.padding == (0, 0, 0) else self.padding)
        if self.pooling_type.lower() == "avg":
            return nnops.avgpool3d(x, self.kernel_size, self.stride,
                                   pad), state
        return nnops.maxpool3d(x, self.kernel_size, self.stride, pad), state


@serializable
@dataclasses.dataclass
class Upsampling3D(Layer):
    """Each voxel repeated ``size`` times along D, H and W."""

    size: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        s = self.size
        return InputType.convolutional3D(it.depth * s, it.height * s,
                                         it.width * s, it.channels)

    def apply(self, params, state, x, train, generator):
        return nnops.upsampling3d(x, self.size), state


@serializable
@dataclasses.dataclass
class Cropping3D(Layer):
    """``crop`` ``(d0, d1, h0, h1, w0, w1)`` voxels cut (an int or a
    triple spreads)."""

    crop: Tuple[int, int, int, int, int, int] = (0, 0, 0, 0, 0, 0)

    def __post_init__(self):
        c = tuplify(self.crop)
        if isinstance(c, int):
            c = (c,) * 6
        elif len(c) == 3:
            c = (c[0], c[0], c[1], c[1], c[2], c[2])
        self.crop = c

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        c = self.crop
        return InputType.convolutional3D(it.depth - c[0] - c[1],
                                         it.height - c[2] - c[3],
                                         it.width - c[4] - c[5], it.channels)

    def apply(self, params, state, x, train, generator):
        c = self.crop
        return x[:, c[0]:x.shape[1] - c[1], c[2]:x.shape[2] - c[3],
                 c[4]:x.shape[3] - c[5], :], state


@serializable
@dataclasses.dataclass
class ZeroPadding3DLayer(Layer):
    """``pad`` ``(d, h, w)`` zero voxels on both sides of each axis."""

    pad: Tuple[int, int, int] = (1, 1, 1)

    def __post_init__(self):
        p = tuplify(self.pad)
        self.pad = (p, p, p) if isinstance(p, int) else p

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        p = self.pad
        return InputType.convolutional3D(it.depth + 2 * p[0],
                                         it.height + 2 * p[1],
                                         it.width + 2 * p[2], it.channels)

    def apply(self, params, state, x, train, generator):
        d, h, w = self.pad
        return F.pad(x, (0, 0, w, w, h, h, d, d)), state


# ----------------------------------------------------------------- misc
@serializable
@dataclasses.dataclass
class PReLULayer(Layer):
    """A learned leaky slope ``alpha`` per feature (the channels of an
    image or a volume), zero at init; ``n_in`` set at ``init_params``."""

    n_in: int = 0

    def output_type(self, it: InputType) -> InputType:
        return it

    def init_params(self, generator, it, dtype, device) -> dict:
        n = it.channels if it.kind in ("convolutional", "convolutional3d") \
            else it.size
        self.n_in = self.n_in or n
        return {"alpha": _zeros((self.n_in,), dtype, device)}

    def apply(self, params, state, x, train, generator):
        return prelu(x, params["alpha"]), state


@serializable
@dataclasses.dataclass
class ElementWiseMultiplicationLayer(Layer):
    """``act(x * W + b)``, a learned scale and shift per feature (``W``
    ones, ``b`` zeros at init); ``n_in = n_out`` set at ``init_params``."""

    n_in: int = 0
    n_out: int = 0

    def output_type(self, it: InputType) -> InputType:
        return it

    def init_params(self, generator, it, dtype, device) -> dict:
        n = self.n_in or it.size
        self.n_in = self.n_out = n
        return {"W": torch.ones((n,), dtype=dtype, device=device),
                "b": _zeros((n,), dtype, device)}

    def apply(self, params, state, x, train, generator):
        return _act(self.activation or "identity").fn(
            x * params["W"] + params["b"]), state


@serializable
@dataclasses.dataclass
class RepeatVector(Layer):
    """``[N, F]`` -> ``[N, n, F]``."""

    n: int = 1

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.size, self.n)

    def apply(self, params, state, x, train, generator):
        return x[:, None, :].expand(x.shape[0], self.n, x.shape[-1]), state


@serializable
@dataclasses.dataclass
class MaskLayer(Layer):
    """The identity: masks travel beside the activations and are applied
    in the loss, as in the JAX package."""

    def has_params(self):
        return False

    def apply(self, params, state, x, train, generator):
        return x, state


@serializable
@dataclasses.dataclass
class CenterLossOutputLayer(OutputLayer):
    """Softmax head plus the center loss (Wen et al. 2016): ``loss + (lambda
    / 2) mean ||x - c_y||^2``. As in the JAX package the centers
    ``[n_out, n_in]`` are parameters that the shared updater moves by
    their gradient; ``alpha`` is kept for the configuration."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_params(self, generator, it, dtype, device) -> dict:
        p = super().init_params(generator, it, dtype, device)
        p["centers"] = _zeros((self.n_out, self.n_in), dtype, device)
        return p

    def loss_value(self, params, state, x, labels, mask=None):
        base = super().loss_value(params, state, x, labels, mask)
        d = x - labels @ params["centers"]
        return base + 0.5 * self.lambda_ * torch.mean(torch.sum(d * d,
                                                                dim=-1))


# ------------------------------------------------------------- capsules
def _squash(s, axis=-1, eps=1e-8):
    """``|s|^2 / (1 + |s|^2) * s / sqrt(|s|^2 + eps)``: a length below 1."""
    n2 = torch.sum(s * s, dim=axis, keepdim=True)
    return (n2 / (1.0 + n2)) * s / torch.sqrt(n2 + eps)


@serializable
@dataclasses.dataclass
class PrimaryCapsules(Layer):
    """A VALID convolution to ``channels * capsule_dimensions`` channels,
    reshaped to capsules and squashed: ``[N, oh * ow * channels,
    capsule_dimensions]``, a capsule the ``capsule_dimensions`` consecutive
    channels of one NHWC pixel."""

    n_in: int = 0
    capsules: int = 0            # inferred from the geometry where 0
    capsule_dimensions: int = 8
    channels: int = 32
    kernel_size: Tuple[int, int] = (9, 9)
    stride: Tuple[int, int] = (2, 2)

    def __post_init__(self):
        self.kernel_size = tuplify(self.kernel_size)
        self.stride = tuplify(self.stride)

    def output_type(self, it: InputType) -> InputType:
        h, w = (_conv_out(n, k, s, "Truncate", 0) for n, k, s in zip(
            (it.height, it.width), self.kernel_size, self.stride))
        return InputType.recurrent(self.capsule_dimensions,
                                   self.capsules or h * w * self.channels)

    def init_params(self, generator, it, dtype, device) -> dict:
        kh, kw = self.kernel_size
        c_out = self.channels * self.capsule_dimensions
        return {"W": _weight(self, generator, (kh, kw, self.n_in, c_out),
                             kh * kw * self.n_in, kh * kw * c_out, dtype,
                             device),
                "b": _zeros((c_out,), dtype, device)}

    def apply(self, params, state, x, train, generator):
        out = nnops.conv2d(x, params["W"], params["b"], strides=self.stride,
                           padding=(0, 0))
        return _squash(out.reshape(out.shape[0], -1,
                                   self.capsule_dimensions)), state


@serializable
@dataclasses.dataclass
class CapsuleLayer(Layer):
    """Dynamic routing (Sabour et al. 2017) over a fixed ``routings``
    iterations: ``[N, input_capsules, n_in]`` -> ``[N, capsules,
    capsule_dimensions]``, ``W`` ``[input_capsules, n_in, capsules *
    capsule_dimensions]``; ``input_capsules`` and ``n_in`` set from the
    input type at ``init_params``."""

    n_in: int = 0
    input_capsules: int = 0
    capsules: int = 10
    capsule_dimensions: int = 16
    routings: int = 3

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.capsule_dimensions, self.capsules)

    def init_params(self, generator, it, dtype, device) -> dict:
        in_caps = self.input_capsules or max(it.timeseries_length, 1)
        in_dim = self.n_in or it.size
        self.input_capsules, self.n_in = in_caps, in_dim
        out = self.capsules * self.capsule_dimensions
        return {"W": _weight(self, generator, (in_caps, in_dim, out), in_dim,
                             out, dtype, device)}

    def apply(self, params, state, x, train, generator):
        n, in_caps, _ = x.shape
        oc, od = self.capsules, self.capsule_dimensions
        # the predictions u_hat [N, in_caps, oc, od]
        u_hat = torch.einsum("nid,ido->nio", x, params["W"]).reshape(
            n, in_caps, oc, od)
        b = torch.zeros((n, in_caps, oc), dtype=x.dtype, device=x.device)
        v = None
        for _ in range(self.routings):
            c = torch.softmax(b, dim=2)
            v = _squash(torch.einsum("nio,niod->nod", c, u_hat))
            b = b + torch.einsum("niod,nod->nio", u_hat, v)
        return v, state


@serializable
@dataclasses.dataclass
class CapsuleStrengthLayer(Layer):
    """Capsule lengths: ``[N, caps, dim]`` -> ``[N, caps]``."""

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(max(it.timeseries_length, 1))

    def apply(self, params, state, x, train, generator):
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-12), state


# ----------------------------------------------------------- structural
@dataclasses.dataclass
class LambdaLayer(Layer):
    """A stateless layer from a torch function ``fn(x) -> y``;
    ``output_type_fn`` (InputType -> InputType) defaults to the input's.
    Not serializable: a network holding one raises at ``to_json()``."""

    fn: Any = None
    output_type_fn: Any = None

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return self.output_type_fn(it) if self.output_type_fn else it

    def apply(self, params, state, x, train, generator):
        if self.fn is None:
            raise ValueError("LambdaLayer needs fn=<torch function>")
        return self.fn(x), state


@serializable
@dataclasses.dataclass
class PermuteLayer(Layer):
    """The non-batch axes permuted by ``dims``, 1-indexed as Keras'
    ``Permute``."""

    dims: Tuple[int, ...] = ()

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        dims = tuple(int(d) for d in self.dims)
        if it.kind == "recurrent" and dims == (2, 1):
            return InputType.recurrent(it.timeseries_length or 0, it.size)
        if it.kind == "convolutional" and len(dims) == 3:
            hwc = (it.height, it.width, it.channels)
            return InputType.convolutional(*(hwc[d - 1] for d in dims))
        if dims == tuple(range(1, len(dims) + 1)):
            return it
        raise ValueError(
            f"Permute{dims} unsupported for input kind {it.kind!r}")

    def apply(self, params, state, x, train, generator):
        return x.permute(0, *(int(d) for d in self.dims)), state


@serializable
@dataclasses.dataclass
class ReshapeLayer(Layer):
    """The non-batch axes reshaped to ``target_shape`` (Keras'
    ``Reshape``): one axis is feed-forward, two ``(T, F)`` recurrent,
    three ``(H, W, C)`` an image."""

    target_shape: Tuple[int, ...] = ()

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        ts = tuple(int(d) for d in self.target_shape)
        if len(ts) == 1:
            return InputType.feedForward(ts[0])
        if len(ts) == 2:
            return InputType.recurrent(ts[1], ts[0])
        if len(ts) == 3:
            return InputType.convolutional(*ts)
        raise ValueError(f"unsupported Reshape target {ts}")

    def apply(self, params, state, x, train, generator):
        ts = tuple(int(d) for d in self.target_shape)
        return x.reshape(x.shape[0], *ts), state


__all__ = ["GRU", "GravesBidirectionalLSTM", "MaskZeroLayer",
           "Convolution1D", "Subsampling1DLayer", "Upsampling1D",
           "Cropping1D", "ZeroPadding1DLayer", "LocallyConnected1D",
           "Deconvolution2D", "DepthwiseConvolution2D", "Cropping2D",
           "SpaceToDepthLayer", "SpaceToBatchLayer", "LocallyConnected2D",
           "Convolution3D", "Deconvolution3D", "Subsampling3DLayer",
           "Upsampling3D", "Cropping3D", "ZeroPadding3DLayer", "PReLULayer",
           "ElementWiseMultiplicationLayer", "RepeatVector", "MaskLayer",
           "CenterLossOutputLayer", "PrimaryCapsules", "CapsuleLayer",
           "CapsuleStrengthLayer", "LambdaLayer", "PermuteLayer",
           "ReshapeLayer"]
