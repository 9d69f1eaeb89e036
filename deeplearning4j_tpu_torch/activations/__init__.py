"""Activation functions: counterpart of ``deeplearning4j_tpu/activations``.

:class:`Activation` keeps every name of the JAX enum (so a configuration
written by the JAX side resolves), and :meth:`Activation.fn` returns the
PyTorch function of each, from the port's registry (``ops/transforms.py``,
under the JAX op names), as the JAX enum resolves each through its own;
``identity`` is the identity.
"""

from __future__ import annotations

import enum
from typing import Callable

from deeplearning4j_tpu_torch.ops import transforms  # noqa: F401  (registers)
from deeplearning4j_tpu_torch.ops.registry import get_op


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
        if self is Activation.IDENTITY:
            return _identity
        return get_op(self.value)

    @staticmethod
    def resolve(a) -> "Activation":
        if isinstance(a, Activation):
            return a
        if isinstance(a, str):
            if a.upper() in Activation.__members__:
                return Activation[a.upper()]
            return Activation(a.lower())
        raise ValueError(f"Cannot resolve activation: {a!r}")


def _identity(x):
    return x


__all__ = ["Activation"]
