"""Weight initialization: counterpart of ``deeplearning4j_tpu/nn/weights``.

The same schemes and fan-in/fan-out formulas (reference: WeightInitUtil),
drawn from an explicit ``torch.Generator``. The values are not JAX's
threefry draws: parity with the JAX side comes from carrying its weights
across (``util.model_serializer``, ``params.mln_params_from_numpy``),
never from re-initialising.
"""

from __future__ import annotations

import enum
import math

import torch


class WeightInit(enum.Enum):
    """Reference: org.deeplearning4j.nn.weights.WeightInit."""

    ZERO = "zero"
    ONES = "ones"
    CONSTANT = "constant"
    NORMAL = "normal"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    RELU = "relu"              # He normal
    RELU_UNIFORM = "relu_uniform"
    HE_NORMAL = "he_normal"
    HE_UNIFORM = "he_uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    VAR_SCALING_NORMAL_FAN_IN = "var_scaling_normal_fan_in"
    VAR_SCALING_NORMAL_FAN_OUT = "var_scaling_normal_fan_out"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"
    IDENTITY = "identity"

    @staticmethod
    def resolve(w) -> "WeightInit":
        if isinstance(w, WeightInit):
            return w
        if isinstance(w, str):
            if w.upper() in WeightInit.__members__:
                return WeightInit[w.upper()]
            return WeightInit(w.lower())
        raise ValueError(f"Cannot resolve weight init: {w!r}")


def init_weights(scheme, generator: torch.Generator, shape, fan_in: float,
                 fan_out: float, dtype=torch.float32, device=None,
                 gain: float = 1.0) -> torch.Tensor:
    """Draw a weight tensor per the scheme (reference: WeightInitUtil),
    in f32 from ``generator`` (a CPU generator: the draws do not depend
    on the device), then cast to ``dtype`` on ``device``."""
    w = WeightInit.resolve(scheme)
    shape = tuple(shape)

    def normal():
        return torch.randn(shape, generator=generator)

    def uniform(a):
        return (torch.rand(shape, generator=generator) * 2 - 1) * a

    if w is WeightInit.ZERO:
        out = torch.zeros(shape)
    elif w is WeightInit.ONES:
        out = torch.ones(shape)
    elif w is WeightInit.CONSTANT:
        out = torch.full(shape, float(gain))
    elif w in (WeightInit.NORMAL, WeightInit.XAVIER_FAN_IN):
        out = normal() / math.sqrt(fan_in)
    elif w is WeightInit.UNIFORM:
        out = uniform(math.sqrt(1.0 / fan_in))
    elif w is WeightInit.XAVIER:
        out = math.sqrt(2.0 / (fan_in + fan_out)) * normal()
    elif w is WeightInit.XAVIER_UNIFORM:
        out = uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    elif w is WeightInit.LECUN_NORMAL:
        out = math.sqrt(1.0 / fan_in) * normal()
    elif w is WeightInit.LECUN_UNIFORM:
        out = uniform(math.sqrt(3.0 / fan_in))
    elif w in (WeightInit.RELU, WeightInit.HE_NORMAL):
        out = math.sqrt(2.0 / fan_in) * normal()
    elif w in (WeightInit.RELU_UNIFORM, WeightInit.HE_UNIFORM):
        out = uniform(math.sqrt(6.0 / fan_in))
    elif w is WeightInit.SIGMOID_UNIFORM:
        out = uniform(4.0 * math.sqrt(6.0 / (fan_in + fan_out)))
    elif w is WeightInit.VAR_SCALING_NORMAL_FAN_IN:
        out = math.sqrt(gain / fan_in) * normal()
    elif w is WeightInit.VAR_SCALING_NORMAL_FAN_OUT:
        out = math.sqrt(gain / fan_out) * normal()
    elif w is WeightInit.VAR_SCALING_NORMAL_FAN_AVG:
        out = math.sqrt(2.0 * gain / (fan_in + fan_out)) * normal()
    elif w is WeightInit.IDENTITY:
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires square 2D shape")
        out = torch.eye(shape[0])
    else:
        raise ValueError(f"Unhandled weight init: {w}")
    return out.to(device=device, dtype=dtype)


__all__ = ["WeightInit", "init_weights"]
