"""Layer configurations and their functions: the part of
``deeplearning4j_tpu/nn/conf/layers.py`` that the MultiLayerNetwork slice
runs.

A layer is a ``@serializable`` dataclass with the JAX class's name and
fields (so a ``configuration.json`` from the JAX side parses) and plain
functions of tensors:

    init_params(generator, input_type, dtype, device) -> param dict
    init_state(input_type, dtype, device)             -> state dict
    apply(params, state, x, train, generator)         -> (out, new_state)

Parameter names and layouts follow the JAX package (``W`` ``[in, out]``,
``b``; the LSTM's ``W`` ``[in, 4H]``, ``RW`` ``[H, 4H]``, ``b`` ``[4H]``
with gates i, f, g, o). Ported: :class:`DenseLayer`,
:class:`OutputLayer`, :class:`LSTM` (and its alias :class:`GravesLSTM`)
and :class:`RnnOutputLayer`. Dropout is a float rate; an ``IDropout``
config, weight noise and constraints are not ported and raise
``NotImplementedError``. Every other layer class of the JAX package is
not registered here, so a configuration naming one raises
``NotImplementedError`` with its name (``common.serde``).
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.loss import LossFunction, compute_loss
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.weights import WeightInit, init_weights
from deeplearning4j_tpu_torch.ops import nn as nnops


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
    dropout: Optional[Any] = None        # input dropout rate (float)
    weight_noise: Optional[Any] = None   # not ported
    constraints: Optional[Any] = None    # not ported

    def __post_init__(self):
        for field in ("weight_noise", "constraints"):
            if getattr(self, field) is not None:
                raise NotImplementedError(
                    f"{type(self).__name__}.{field} is not ported to "
                    f"deeplearning4j_tpu_torch yet")
        if self.dropout is not None and not isinstance(self.dropout,
                                                       numbers.Real):
            raise NotImplementedError(
                f"dropout config {type(self.dropout).__name__} is not ported "
                f"yet; pass a float drop rate")

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
        if train and self.dropout and generator is not None:
            return nnops.dropout(x, float(self.dropout), generator)
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


__all__ = ["Layer", "DenseLayer", "OutputLayer", "RnnOutputLayer", "LSTM",
           "GravesLSTM"]
