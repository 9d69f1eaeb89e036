"""Activation functions: counterpart of ``deeplearning4j_tpu/activations``.

:class:`Activation` keeps every name of the JAX enum (so a configuration
written by the JAX side resolves), and :meth:`Activation.fn` returns the
PyTorch function for the ported ones: ``identity``, ``sigmoid``,
``tanh``, ``relu`` and ``softmax`` (over the last axis). The others raise
``NotImplementedError`` when used.
"""

from __future__ import annotations

import enum
from typing import Callable

import torch

_FNS = {
    "identity": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


class Activation(enum.Enum):
    """Reference: org.nd4j.linalg.activations.Activation."""

    IDENTITY = "identity"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    SWISH = "swish"
    MISH = "mish"
    HARDSIGMOID = "hardsigmoid"
    HARDTANH = "hardtanh"
    CUBE = "cube"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "recttanh"
    THRESHOLDEDRELU = "thresholdedrelu"

    @property
    def fn(self) -> Callable:
        try:
            return _FNS[self.value]
        except KeyError:
            raise NotImplementedError(
                f"activation {self.value!r} is not ported to "
                f"deeplearning4j_tpu_torch yet (ported: "
                f"{sorted(_FNS)})") from None

    @staticmethod
    def resolve(a) -> "Activation":
        if isinstance(a, Activation):
            return a
        if isinstance(a, str):
            if a.upper() in Activation.__members__:
                return Activation[a.upper()]
            return Activation(a.lower())
        raise ValueError(f"Cannot resolve activation: {a!r}")


__all__ = ["Activation"]
