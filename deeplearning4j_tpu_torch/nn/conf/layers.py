"""Layer configurations and their functions: the part of
``deeplearning4j_tpu/nn/conf/layers.py`` that the ported networks run.

A layer is a ``@serializable`` dataclass with the JAX class's name and
fields (so a ``configuration.json`` from the JAX side parses) and plain
functions of tensors:

    init_params(generator, input_type, dtype, device) -> param dict
    init_state(input_type, dtype, device)             -> state dict
    apply(params, state, x, train, generator)         -> (out, new_state)

Parameter names and layouts follow the JAX package (``W`` ``[in, out]``,
``b``; the LSTM's ``W`` ``[in, 4H]``, ``RW`` ``[H, 4H]``, ``b`` ``[4H]``
with gates i, f, g, o; conv ``W`` HWIO ``[kh, kw, C_in, C_out]``; a
separable conv's ``dW`` ``[kh, kw, C_in, mult]`` and ``pW`` ``[1, 1,
C_in * mult, C_out]``; batch norm ``gamma``, ``beta`` and the state
``mean``, ``var``; a
``Bidirectional``'s ``{"fw": ..., "bw": ...}``). Ported:
:class:`DenseLayer`, :class:`OutputLayer`, the parameterless loss heads
:class:`LossLayer`, :class:`CnnLossLayer` and :class:`RnnLossLayer`,
:class:`EmbeddingLayer` and :class:`EmbeddingSequenceLayer`, the
recurrent family (:class:`LSTM` and its alias :class:`GravesLSTM`,
:class:`SimpleRnn`, :class:`Bidirectional`, the :class:`LastTimeStep`
wrapper, :class:`RnnOutputLayer`), :class:`ActivationLayer`, and the
image layers :class:`ConvolutionLayer`, :class:`SeparableConvolution2D`,
:class:`SubsamplingLayer`, :class:`Upsampling2D`,
:class:`ZeroPaddingLayer`, :class:`GlobalPoolingLayer` (with masked
pooling over sequences), the normalizations :class:`BatchNormalization`
(NHWC), :class:`LayerNormalization` and
:class:`LocalResponseNormalization`, and :class:`DropoutLayer` and
:class:`FlattenLayer`. A layer's ``dropout`` is a float drop rate or an
``IDropout`` config (``nn/conf/dropout.py``), its ``weight_noise`` an
``IWeightNoise`` (``nn/conf/weightnoise.py``, applied by the networks in
training) and its ``constraints`` a list of ``LayerConstraint``
(``nn/conf/constraint.py``, applied by the networks after each update).
The attention layers :class:`SelfAttentionLayer`,
:class:`LearnedSelfAttentionLayer` and :class:`RecurrentAttentionLayer`
run the plain ``ops.nn.dot_product_attention``, as the reference's do.
``nn/conf/layers_extra.py``, ``nn/conf/objdetect.py``,
``nn/conf/variational.py`` and ``nn/conf/ocnn.py`` hold the classes of the
JAX modules of those names, and ``nn/transferlearning.py`` the frozen
wrappers: every layer class of the JAX package has its counterpart, and
only ``LambdaLayer`` (which holds a function) is not registered with the
JSON serde.
"""

from __future__ import annotations

import dataclasses
import enum
import numbers
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common.serde import serializable, tuplify
from deeplearning4j_tpu_torch.loss import LossFunction, compute_loss
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.weights import WeightInit, init_weights
from deeplearning4j_tpu_torch.ops import nn as nnops


class PoolingType(enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


def _act(a) -> Activation:
    return Activation.resolve(a)


@dataclasses.dataclass
class Layer:
    """Base layer config. Fields set to None inherit network defaults."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    updater: Optional[Any] = None        # per-layer updater override
    l1: Optional[float] = None
    l2: Optional[float] = None
    #: input dropout: a float drop rate or an ``IDropout`` config
    dropout: Optional[Any] = None
    #: an ``IWeightNoise`` (DropConnect, WeightNoise), training only
    weight_noise: Optional[Any] = None
    #: a list of ``LayerConstraint``, applied after every update
    constraints: Optional[Any] = None

    def __post_init__(self):
        pass

    # -- to be overridden ----------------------------------------------
    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init_params(self, generator, input_type: InputType, dtype,
                    device) -> dict:
        return {}

    def init_state(self, input_type: InputType, dtype, device) -> dict:
        return {}

    def apply(self, params, state, x, train: bool, generator):
        raise NotImplementedError

    # -- recurrent state (rnnTimeStep and truncated BPTT) ---------------
    is_recurrent = False  # class attribute, not a field

    def init_carry(self, batch: int, dtype, device):
        """Initial hidden carry for stateful stepping / tBPTT."""
        return None

    def apply_with_carry(self, params, state, carry, x, train, generator):
        """Like :meth:`apply`, threading the recurrent hidden state.
        Returns ``(out, new_state, new_carry)``."""
        out, ns = self.apply(params, state, x, train, generator)
        return out, ns, carry

    def _maybe_dropout(self, x, train, generator):
        return _dropout(self.dropout, x, train, generator)

    def has_params(self) -> bool:
        return True


def _dropout(d, x, train, generator):
    """``x`` through dropout ``d`` (a float drop rate or an ``IDropout``)
    in training with a generator; ``x`` itself otherwise."""
    if train and d and generator is not None:
        if isinstance(d, numbers.Real):
            return nnops.dropout(x, float(d), generator)
        return d.apply(x, generator)
    return x


@serializable
@dataclasses.dataclass
class DenseLayer(Layer):
    """Fully connected, ``z = x @ W + b`` over the last axis (so it is
    time-distributed over ``[N, T, F]`` input)."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def output_type(self, it: InputType) -> InputType:
        if it.kind == "recurrent":
            return InputType.recurrent(self.n_out, it.timeseries_length)
        return InputType.feedForward(self.n_out)

    def init_params(self, generator, it, dtype, device) -> dict:
        p = {"W": init_weights(self.weight_init or WeightInit.XAVIER,
                               generator, (self.n_in, self.n_out), self.n_in,
                               self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def _pre(self, params, x):
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        return _act(self.activation or "identity").fn(
            self._pre(params, x)), state


@serializable
@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head. :meth:`loss_value` takes the loss on the
    pre-activations, so softmax + MCXENT runs the fused stable path."""

    loss: str = "mcxent"

    def loss_value(self, params, state, x, labels, mask=None):
        return compute_loss(LossFunction.resolve(self.loss), labels,
                            self._pre(params, x),
                            self.activation or "softmax", mask)

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        return _act(self.activation or "softmax").fn(
            self._pre(params, x)), state


@serializable
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output head on ``[N, T, F]``."""

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)


@serializable
@dataclasses.dataclass
class LossLayer(Layer):
    """A loss head without parameters: the loss of ``x`` itself, under the
    activation (identity by default)."""

    loss: str = "mse"

    def has_params(self):
        return False

    def loss_value(self, params, state, x, labels, mask=None):
        return compute_loss(LossFunction.resolve(self.loss), labels, x,
                            self.activation or "identity", mask)

    def apply(self, params, state, x, train, generator):
        return _act(self.activation or "identity").fn(x), state


@serializable
@dataclasses.dataclass
class CnnLossLayer(LossLayer):
    """Per-pixel loss head on ``[N, H, W, C]`` activations."""


@serializable
@dataclasses.dataclass
class RnnLossLayer(LossLayer):
    """Per-timestep loss head on ``[N, T, C]`` activations."""


@serializable
@dataclasses.dataclass
class EmbeddingLayer(Layer):
    """Index lookup in ``W`` ``[n_in, n_out]`` (a gather). Takes ``[N]``
    or ``[N, T]`` ids of any dtype (cast to int32; a trailing axis of one
    is dropped) and gives ``[N, n_out]`` or ``[N, T, n_out]``."""

    n_in: int = 0     # vocabulary size
    n_out: int = 0

    def output_type(self, it: InputType) -> InputType:
        if it.kind == "recurrent":
            return InputType.recurrent(self.n_out, it.timeseries_length)
        return InputType.feedForward(self.n_out)

    def init_params(self, generator, it, dtype, device) -> dict:
        return {"W": init_weights(self.weight_init or WeightInit.XAVIER,
                                  generator, (self.n_in, self.n_out),
                                  self.n_in, self.n_out, dtype, device)}

    def _lookup(self, params, ids):
        out = F.embedding(ids.to(torch.int32).long(), params["W"])
        return _act(self.activation or "identity").fn(out)

    def apply(self, params, state, x, train, generator):
        if x.dim() > 1 and x.shape[-1] == 1:
            x = x[..., 0]
        return self._lookup(params, x), state


@serializable
@dataclasses.dataclass
class EmbeddingSequenceLayer(EmbeddingLayer):
    """Sequence lookup: ``[N, T]`` ids to ``[N, T, n_out]``; ``[N]`` is a
    sequence of one. ``[N, 1]`` stays a sequence of length 1 (no trailing
    axis is dropped)."""

    input_length: int = 0

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length if it.kind == "recurrent" else (
            self.input_length or it.size or -1)
        return InputType.recurrent(self.n_out, t)

    def apply(self, params, state, x, train, generator):
        if x.dim() == 1:
            x = x[:, None]
        return self._lookup(params, x), state


@serializable
@dataclasses.dataclass
class LastTimeStep(Layer):
    """A recurrent layer of which only the last timestep is emitted:
    ``[N, T, F]`` to ``[N, F]``."""

    underlying: Optional[Layer] = None

    def has_params(self):
        return self.underlying.has_params()

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(self.underlying.output_type(it).size)

    def init_params(self, generator, it, dtype, device) -> dict:
        return self.underlying.init_params(generator, it, dtype, device)

    def init_state(self, it, dtype, device) -> dict:
        return self.underlying.init_state(it, dtype, device)

    def apply(self, params, state, x, train, generator):
        out, st = self.underlying.apply(params, state, x, train, generator)
        return out[:, -1, :], st

    @property
    def is_recurrent(self):
        return self.underlying is not None and self.underlying.is_recurrent

    def init_carry(self, batch, dtype, device):
        return self.underlying.init_carry(batch, dtype, device)

    def apply_with_carry(self, params, state, carry, x, train, generator):
        out, st, c = self.underlying.apply_with_carry(
            params, state, carry, x, train, generator)
        return out[:, -1, :], st, c


@serializable
@dataclasses.dataclass
class ActivationLayer(Layer):
    """An activation alone. ``alpha`` parametrises leakyrelu (the slope),
    elu (alpha) and thresholdedrelu (the threshold)."""

    alpha: Optional[float] = None

    def has_params(self):
        return False

    def apply(self, params, state, x, train, generator):
        a = _act(self.activation or "identity")
        if self.alpha is not None and a in (Activation.LEAKYRELU,
                                            Activation.ELU,
                                            Activation.THRESHOLDEDRELU):
            return a.fn(x, self.alpha), state
        return a.fn(x), state


@serializable
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Dropout alone (``ops.nn.dropout`` at a float ``rate``, or an
    ``IDropout`` config's ``apply``, in training; the identity in
    inference)."""

    rate: Any = 0.5

    def has_params(self):
        return False

    def apply(self, params, state, x, train, generator):
        return _dropout(self.rate, x, train, generator), state


@serializable
@dataclasses.dataclass
class FlattenLayer(Layer):
    """Any input to ``[N, flat]``."""

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        if it.kind == "recurrent" and it.timeseries_length in (-1, None):
            raise ValueError("FlattenLayer needs a fixed timeseries length")
        return InputType.feedForward(it.flat_size())

    def apply(self, params, state, x, train, generator):
        return x.reshape(x.shape[0], -1), state


@serializable
@dataclasses.dataclass
class LSTM(Layer):
    """LSTM, gates i, f, g, o; weights ``W`` (input), ``RW`` (recurrent)
    and ``b``, the forget-gate slice ``b[H:2H]`` set to
    ``forget_gate_bias_init``. Runs ``ops.nn.lstm_layer``: the hand
    kernels on the card."""

    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0

    is_recurrent = True

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it, dtype, device) -> dict:
        h = self.n_out
        scheme = self.weight_init or WeightInit.XAVIER
        w = init_weights(scheme, generator, (self.n_in, 4 * h), self.n_in,
                         4 * h, dtype, device)
        rw = init_weights(scheme, generator, (h, 4 * h), h, 4 * h, dtype,
                          device)
        b = torch.zeros((4 * h,), dtype=dtype, device=device)
        b[h:2 * h] = self.forget_gate_bias_init
        return {"W": w, "RW": rw, "b": b}

    def _out(self, ys):
        act = self.activation
        return _act(act).fn(ys) if act and act != "tanh" else ys

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        ys, _ = nnops.lstm_layer(x, params["W"], params["RW"], params["b"])
        return self._out(ys), state

    def init_carry(self, batch, dtype, device):
        h = self.n_out
        return (torch.zeros((batch, h), dtype=dtype, device=device),
                torch.zeros((batch, h), dtype=dtype, device=device))

    def apply_with_carry(self, params, state, carry, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        ys, new_carry = nnops.lstm_layer(x, params["W"], params["RW"],
                                         params["b"], h0=carry[0],
                                         c0=carry[1])
        return self._out(ys), state, new_carry


@serializable
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """Alias of :class:`LSTM`, without peepholes, as in the JAX package."""


@serializable
@dataclasses.dataclass
class SimpleRnn(Layer):
    """Elman RNN, ``h_t = tanh(x_t W + b + h_{t-1} RW)`` through
    ``ops.nn.simple_rnn_layer`` (plain PyTorch: no kernel computes it in
    the reference); weights ``W`` ``[in, H]``, ``RW`` ``[H, H]``, ``b``
    ``[H]``."""

    n_in: int = 0
    n_out: int = 0

    is_recurrent = True

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it, dtype, device) -> dict:
        scheme = self.weight_init or WeightInit.XAVIER
        h = self.n_out
        return {"W": init_weights(scheme, generator, (self.n_in, h),
                                  self.n_in, h, dtype, device),
                "RW": init_weights(scheme, generator, (h, h), h, h, dtype,
                                   device),
                "b": torch.zeros((h,), dtype=dtype, device=device)}

    def apply(self, params, state, x, train, generator):
        ys, _ = nnops.simple_rnn_layer(x, params["W"], params["RW"],
                                       params["b"])
        return ys, state

    def init_carry(self, batch, dtype, device):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def apply_with_carry(self, params, state, carry, x, train, generator):
        ys, new_carry = nnops.simple_rnn_layer(
            x, params["W"], params["RW"], params["b"], h0=carry)
        return ys, state, new_carry


@serializable
@dataclasses.dataclass
class Bidirectional(Layer):
    """Two copies of a recurrent layer (parameters ``fw`` and ``bw``), the
    second run over the time-reversed input and its output reversed back,
    merged by ``mode``: CONCAT, ADD, MUL or AVERAGE. An LSTM's two
    directions are two launches of the recurrence kernels on the card.
    ``return_sequences=False`` merges the forward direction's last step
    with the backward direction's output at input step 0 (its own last),
    giving ``[N, out]``. Stepping (``rnnTimeStep``, truncated BPTT) is
    refused: the backward direction needs the whole sequence."""

    layer: Optional[Layer] = None
    mode: str = "CONCAT"
    return_sequences: bool = True

    is_recurrent = True

    @property
    def n_out(self):
        n = self.layer.n_out
        return 2 * n if self.mode.upper() == "CONCAT" else n

    @property
    def n_in(self):
        return self.layer.n_in

    @n_in.setter
    def n_in(self, v):
        self.layer.n_in = v

    def output_type(self, it: InputType) -> InputType:
        if not self.return_sequences:
            return InputType.feedForward(self.n_out)
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it, dtype, device) -> dict:
        return {"fw": self.layer.init_params(generator, it, dtype, device),
                "bw": self.layer.init_params(generator, it, dtype, device)}

    def init_state(self, it, dtype, device) -> dict:
        return {}

    def apply(self, params, state, x, train, generator):
        yf, _ = self.layer.apply(params["fw"], {}, x, train, generator)
        yb, _ = self.layer.apply(params["bw"], {}, torch.flip(x, dims=(1,)),
                                 train, generator)
        yb = torch.flip(yb, dims=(1,))
        if not self.return_sequences:
            yf, yb = yf[:, -1], yb[:, 0]
        m = self.mode.upper()
        if m == "CONCAT":
            return torch.cat([yf, yb], dim=-1), state
        if m == "ADD":
            return yf + yb, state
        if m == "MUL":
            return yf * yb, state
        if m == "AVERAGE":
            return 0.5 * (yf + yb), state
        raise ValueError(f"Unknown Bidirectional mode: {self.mode}")

    def init_carry(self, batch, dtype, device):
        raise NotImplementedError(
            "rnnTimeStep is not supported for Bidirectional layers "
            "(reference behavior: requires the full sequence)")


# ---------------------------------------------------------------- images
def _conv_out(size, k, s, mode, pad, dilation=1):
    if mode == "Same":
        return -(-size // s)
    k_eff = (k - 1) * dilation + 1
    return (size - k_eff + 2 * pad) // s + 1


@serializable
@dataclasses.dataclass
class ConvolutionLayer(Layer):
    """2D convolution through ``ops.nn.conv2d`` (NHWC x HWIO).
    ``convolution_mode`` "Same" pads as ``lax``'s SAME does; "Truncate"
    takes ``padding`` symmetric pixels a side."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "Truncate"
    dilation: Tuple[int, int] = (1, 1)
    has_bias: bool = True

    def __post_init__(self):
        super().__post_init__()
        self.kernel_size = tuplify(self.kernel_size)
        self.stride = tuplify(self.stride)
        self.padding = tuplify(self.padding)
        self.dilation = tuplify(self.dilation)

    def output_type(self, it: InputType) -> InputType:
        h = _conv_out(it.height, self.kernel_size[0], self.stride[0],
                      self.convolution_mode, self.padding[0], self.dilation[0])
        w = _conv_out(it.width, self.kernel_size[1], self.stride[1],
                      self.convolution_mode, self.padding[1], self.dilation[1])
        return InputType.convolutional(h, w, self.n_out)

    def init_params(self, generator, it, dtype, device) -> dict:
        kh, kw = self.kernel_size
        p = {"W": init_weights(self.weight_init or WeightInit.XAVIER,
                               generator, (kh, kw, self.n_in, self.n_out),
                               kh * kw * self.n_in, kh * kw * self.n_out,
                               dtype, device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        pad = "SAME" if self.convolution_mode == "Same" else self.padding
        out = nnops.conv2d(x, params["W"], params.get("b"),
                           strides=self.stride, padding=pad,
                           dilation=self.dilation)
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class SeparableConvolution2D(ConvolutionLayer):
    """Depthwise-separable convolution through ``ops.nn.separable_conv2d``:
    a depthwise ``dW`` ``[kh, kw, C_in, depth_multiplier]`` at the layer's
    stride and padding, then a pointwise ``pW`` ``[1, 1, C_in *
    depth_multiplier, C_out]`` and ``b``."""

    depth_multiplier: int = 1

    def init_params(self, generator, it, dtype, device) -> dict:
        kh, kw = self.kernel_size
        scheme = self.weight_init or WeightInit.XAVIER
        fan = kh * kw * self.n_in
        mid = self.n_in * self.depth_multiplier
        p = {"dW": init_weights(scheme, generator,
                                (kh, kw, self.n_in, self.depth_multiplier),
                                fan, fan, dtype, device),
             "pW": init_weights(scheme, generator, (1, 1, mid, self.n_out),
                                mid, self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        pad = "SAME" if self.convolution_mode == "Same" else self.padding
        out = nnops.separable_conv2d(x, params["dW"], params["pW"],
                                     params.get("b"), strides=self.stride,
                                     padding=pad, dilation=self.dilation)
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """Pooling (max, avg, sum or pnorm) over NHWC windows."""

    pooling_type: str = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "Truncate"
    pnorm: int = 2

    def has_params(self):
        return False

    def __post_init__(self):
        super().__post_init__()
        self.kernel_size = tuplify(self.kernel_size)
        self.stride = tuplify(self.stride)
        self.padding = tuplify(self.padding)

    def output_type(self, it: InputType) -> InputType:
        h = _conv_out(it.height, self.kernel_size[0], self.stride[0],
                      self.convolution_mode, self.padding[0])
        w = _conv_out(it.width, self.kernel_size[1], self.stride[1],
                      self.convolution_mode, self.padding[1])
        return InputType.convolutional(h, w, it.channels)

    def apply(self, params, state, x, train, generator):
        pad = "SAME" if self.convolution_mode == "Same" else (
            "VALID" if self.padding == (0, 0) else self.padding)
        k, s = self.kernel_size, self.stride
        pt = PoolingType(self.pooling_type)
        if pt is PoolingType.MAX:
            return nnops.maxpool2d(x, k, s, pad), state
        if pt is PoolingType.AVG:
            return nnops.avgpool2d(x, k, s, pad), state
        if pt is PoolingType.PNORM:
            return nnops.pnormpool2d(x, k, s, pad, self.pnorm), state
        return nnops.sumpool2d(x, k, s, pad), state


@serializable
@dataclasses.dataclass
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling by ``size`` along H and W
    (``ops.nn.upsampling2d``)."""

    size: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(it.height * self.size,
                                       it.width * self.size, it.channels)

    def apply(self, params, state, x, train, generator):
        return nnops.upsampling2d(x, self.size), state


@serializable
@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    """``pad`` zero pixels on each side of H and of W."""

    pad: Tuple[int, int] = (1, 1)

    def has_params(self):
        return False

    def __post_init__(self):
        super().__post_init__()
        self.pad = tuplify(self.pad)

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(it.height + 2 * self.pad[0],
                                       it.width + 2 * self.pad[1],
                                       it.channels)

    def apply(self, params, state, x, train, generator):
        p = self.pad
        return F.pad(x, (0, 0, p[1], p[1], p[0], p[0])), state


@serializable
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Pooling over every axis between the batch and the last (the
    spatial axes of an image, the time axis of a sequence)."""

    pooling_type: str = "max"

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        if it.kind == "recurrent":
            return InputType.feedForward(it.size)
        return InputType.feedForward(it.channels)

    def apply(self, params, state, x, train, generator):
        axes = tuple(range(1, x.dim() - 1))
        pt = PoolingType(self.pooling_type)
        if pt is PoolingType.MAX:
            return torch.amax(x, dim=axes), state
        if pt is PoolingType.SUM:
            return torch.sum(x, dim=axes), state
        if pt is PoolingType.PNORM:
            return torch.sum(torch.abs(x) ** 2, dim=axes) ** 0.5, state
        return torch.mean(x, dim=axes), state

    def apply_masked(self, params, state, x, mask, train, generator):
        """Pooling over the real timesteps of ``x`` ``[N, T, F]`` only,
        ``mask`` ``[N, T]`` (1 real): max over them (the dtype's lowest
        value in the padding), their sum, p-norm, or their mean (the sum
        over at least one step)."""
        m = mask[..., None].to(x.dtype)
        pt = PoolingType(self.pooling_type)
        if pt is PoolingType.MAX:
            return torch.amax(torch.where(m > 0, x, torch.finfo(
                x.dtype).min), dim=1), state
        if pt is PoolingType.SUM:
            return torch.sum(x * m, dim=1), state
        if pt is PoolingType.PNORM:
            return torch.sum(torch.abs(x * m) ** 2, dim=1) ** 0.5, state
        return torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                      min=1.0), state


def _weak(c: float, like: torch.Tensor) -> float:
    """A Python float as JAX takes it beside an array (a weak type):
    rounded to the array's dtype. PyTorch would keep it at f32 beside a
    bf16 tensor."""
    return torch.tensor(c, dtype=like.dtype).item()


@serializable
@dataclasses.dataclass
class BatchNormalization(Layer):
    """Batch norm over the last (channel) axis. Training normalises with
    the batch statistics (``ops.nn.batch_norm_train``, or with a ReLU
    activation ``ops.nn.batch_norm_relu_train`` where
    ``ops.nn.FUSED_BN_RELU_BWD`` is set) and moves the running state by
    ``decay * state + (1 - decay) * batch`` in the state's dtype (the
    parameter dtype); inference uses the running state
    (``ops.nn.batch_norm``)."""

    eps: float = 1e-5
    decay: float = 0.9
    use_log_std: bool = False

    def _nf(self, it: InputType) -> int:
        return it.channels if it.kind == "convolutional" else it.size

    def init_params(self, generator, it, dtype, device) -> dict:
        n = self._nf(it)
        return {"gamma": torch.ones((n,), dtype=dtype, device=device),
                "beta": torch.zeros((n,), dtype=dtype, device=device)}

    def init_state(self, it, dtype, device) -> dict:
        n = self._nf(it)
        return {"mean": torch.zeros((n,), dtype=dtype, device=device),
                "var": torch.ones((n,), dtype=dtype, device=device)}

    def apply(self, params, state, x, train, generator):
        if train:
            act = self.activation or "identity"
            fused = act == "relu" and nnops.FUSED_BN_RELU_BWD
            # the ReLU fused, with the two-pass backward that recomputes
            # its mask (ops.nn.batch_norm_relu_train), where the caller
            # turned it on, as the reference's flag does
            op = nnops.batch_norm_relu_train if fused else \
                nnops.batch_norm_train
            out, m, v = op(x, params["gamma"], params["beta"], self.eps)
            d = self.decay
            state = {k: _weak(d, state[k]) * state[k]
                     + _weak(1 - d, b) * b.detach()
                     for k, b in (("mean", m), ("var", v))}
            if fused:
                return out, state
        else:
            out = nnops.batch_norm(x, params["gamma"], params["beta"],
                                   state["mean"], state["var"], self.eps)
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class LayerNormalization(Layer):
    """Layer norm over the last (feature) axis, ``ops.nn.layer_norm``,
    with ``gamma`` and ``beta``."""

    eps: float = 1e-5

    def _nf(self, it: InputType) -> int:
        return it.channels if it.kind == "convolutional" else it.size

    def init_params(self, generator, it, dtype, device) -> dict:
        n = self._nf(it)
        return {"gamma": torch.ones((n,), dtype=dtype, device=device),
                "beta": torch.zeros((n,), dtype=dtype, device=device)}

    def apply(self, params, state, x, train, generator):
        return nnops.layer_norm(x, params["gamma"], params["beta"],
                                eps=self.eps), state


@serializable
@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    """Local response normalization across channels (AlexNet's),
    ``ops.nn.local_response_normalization`` over a window of ``n``
    channels."""

    n: int = 5
    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75

    def has_params(self):
        return False

    def apply(self, params, state, x, train, generator):
        return nnops.local_response_normalization(
            x, depth_radius=self.n // 2, bias=self.k, alpha=self.alpha,
            beta=self.beta), state


# ------------------------------------------------------------- attention
def _head_size(layer) -> int:
    """The head size a ``head_size`` of 0 takes: ``(n_out or n_in) //
    n_heads``, at construction, as the JAX layers fix it."""
    if not layer.head_size and layer.n_heads:
        return (layer.n_out or layer.n_in) // layer.n_heads
    return layer.head_size


def _split_heads(a, heads: int, dh: int):
    """``[N, T, heads * dh]`` -> ``[N, heads, T, dh]``."""
    return a.reshape(a.shape[0], a.shape[1], heads, dh).transpose(1, 2)


@serializable
@dataclasses.dataclass
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over ``[N, T, n_in]``
    (``ops.nn.multi_head_dot_product_attention``): ``Wq``, ``Wk``, ``Wv``
    ``[n_in, n_heads * head_size]`` and ``Wo`` ``[proj, n_out]``; the
    builder sets ``n_out = n_in`` where it is 0."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0

    def __post_init__(self):
        self.head_size = _head_size(self)

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it, dtype, device) -> dict:
        proj = self.n_heads * self.head_size
        wi = self.weight_init or WeightInit.XAVIER
        shapes = (("Wq", self.n_in, proj), ("Wk", self.n_in, proj),
                  ("Wv", self.n_in, proj), ("Wo", proj, self.n_out))
        return {k: init_weights(wi, generator, (a, b), a, b, dtype, device)
                for k, a, b in shapes}

    def apply(self, params, state, x, train, generator):
        out = nnops.multi_head_dot_product_attention(
            x, x, params["Wq"], params["Wk"], params["Wv"], params["Wo"],
            num_heads=self.n_heads)
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class LearnedSelfAttentionLayer(Layer):
    """Attention of ``n_queries`` learned queries ``Q`` ``[n_queries,
    proj]`` (already in the projection space, the same for every row of
    the batch) over ``[N, T, n_in]``: a sequence of length ``n_queries``
    whatever T is."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0
    n_queries: int = 1

    def __post_init__(self):
        self.head_size = _head_size(self)

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, self.n_queries)

    def init_params(self, generator, it, dtype, device) -> dict:
        proj = self.n_heads * self.head_size
        wi = self.weight_init or WeightInit.XAVIER
        shapes = (("Q", self.n_queries, proj), ("Wk", self.n_in, proj),
                  ("Wv", self.n_in, proj), ("Wo", proj, self.n_out))
        return {k: init_weights(wi, generator, (a, b), a, b, dtype, device)
                for k, a, b in shapes}

    def apply(self, params, state, x, train, generator):
        n = x.shape[0]
        h, dh = self.n_heads, self.head_size
        q = params["Q"].expand(n, *params["Q"].shape)
        out = nnops.dot_product_attention(
            _split_heads(q, h, dh), _split_heads(x @ params["Wk"], h, dh),
            _split_heads(x @ params["Wv"], h, dh))
        out = out.transpose(1, 2).reshape(n, self.n_queries, h * dh)
        return _act(self.activation or "identity").fn(
            out @ params["Wo"]), state


@serializable
@dataclasses.dataclass
class RecurrentAttentionLayer(Layer):
    """A recurrent cell that attends over the whole input sequence at
    every step: ``h_t = act(x_t W + b + h_{t-1} RW + attn(h_{t-1} Wq, K,
    V) Wa)``, ``act`` tanh by default. K and V (``x Wk``, ``x Wv``) and
    the input projection are computed once before a plain loop over T.
    Stepping (``rnnTimeStep``) is refused: each step reads the whole
    sequence."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0

    is_recurrent = True

    def __post_init__(self):
        self.head_size = _head_size(self)

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it, dtype, device) -> dict:
        proj = self.n_heads * self.head_size
        wi = self.weight_init or WeightInit.XAVIER
        n_in, n_out = self.n_in, self.n_out
        shapes = (("W", n_in, n_out), ("RW", n_out, n_out),
                  ("Wq", n_out, proj), ("Wk", n_in, proj),
                  ("Wv", n_in, proj), ("Wa", proj, n_out))
        p = {k: init_weights(wi, generator, (a, b), a, b, dtype, device)
             for k, a, b in shapes}
        p["b"] = torch.zeros((n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, state, x, train, generator):
        n, t, _ = x.shape
        heads, dh = self.n_heads, self.head_size
        flat = x.reshape(n * t, -1)
        k = _split_heads((flat @ params["Wk"]).reshape(n, t, -1), heads, dh)
        v = _split_heads((flat @ params["Wv"]).reshape(n, t, -1), heads, dh)
        x_proj = (flat @ params["W"] + params["b"]).reshape(n, t,
                                                            self.n_out)
        act = _act(self.activation or "tanh").fn
        h = torch.zeros((n, self.n_out), dtype=x.dtype, device=x.device)
        ys = []
        for s in range(t):
            q = (h @ params["Wq"]).reshape(n, heads, 1, dh)
            a = nnops.dot_product_attention(q, k, v).reshape(n, heads * dh)
            h = act(x_proj[:, s] + h @ params["RW"] + a @ params["Wa"])
            ys.append(h)
        return torch.stack(ys, dim=1), state

    def init_carry(self, batch, dtype, device):
        raise NotImplementedError(
            "rnnTimeStep is not supported for RecurrentAttentionLayer "
            "(attends over the full input sequence)")


__all__ = ["Layer", "DenseLayer", "OutputLayer", "RnnOutputLayer", "LSTM",
           "GravesLSTM", "ActivationLayer", "PoolingType", "ConvolutionLayer",
           "SeparableConvolution2D", "SubsamplingLayer", "Upsampling2D",
           "ZeroPaddingLayer", "GlobalPoolingLayer",
           "BatchNormalization", "LossLayer", "CnnLossLayer", "RnnLossLayer",
           "EmbeddingLayer", "EmbeddingSequenceLayer", "LastTimeStep",
           "SimpleRnn", "Bidirectional", "DropoutLayer", "FlattenLayer",
           "LayerNormalization", "LocalResponseNormalization",
           "SelfAttentionLayer", "LearnedSelfAttentionLayer",
           "RecurrentAttentionLayer"]
