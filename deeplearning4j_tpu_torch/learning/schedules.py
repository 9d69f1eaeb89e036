"""Learning-rate schedules: counterpart of
``deeplearning4j_tpu/learning/schedules.py``.

The same eight ``ISchedule`` classes with the same fields (so a
configuration written by the JAX side parses) and :func:`resolve_lr`.
The JAX schedules evaluate ``value_at(step)`` in f32 inside the compiled
step. Here the rate is a Python float computed on the host from the host
step count, each operation rounded to f32 as XLA rounds it (numpy f32
scalars; ``pow``, ``exp`` and ``cos`` taken in f64 and rounded, which is
how close XLA's f32 functions come over the first steps; and XLA's
rewrites of the reference's CPU program: a power by a constant 0, 1, 2
or -1 simplified, a division by a constant made a product with its f32
reciprocal, ``a * b + c`` fused into one rounding), so an updater
gets the same number without a device tensor (a tensor-valued rate would
be copied to the card at every step). Over steps 0-50 the rates equal
JAX's or differ by an ulp of a transcendental; XLA's f32 ``pow`` drifts
from the rounded value as the exponent grows (0.99^300: 2.5e-6
relative).

A schedule typed ``"epoch"`` is evaluated at the epoch count; both
networks pick it by :func:`uses_epoch_schedule`.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict

import numpy as np

from deeplearning4j_tpu_torch.common.serde import serializable

_f32 = np.float32


def _pow(x, y) -> np.float32:
    """``x ** y`` of f32 values as XLA gives it: a constant exponent of 0,
    1, 2 or -1 rewritten (1, x, x * x, 1 / x), else the f64 power
    rounded to f32."""
    x, y = _f32(x), _f32(y)
    if y == 0:
        return _f32(1.0)
    if y == 1:
        return x
    if y == 2:
        return x * x
    if y == -1:
        return _f32(1.0) / x
    return _f32(math.pow(float(x), float(y)))


def _fma(a, b, c) -> np.float32:
    """``a * b + c`` of f32 values with one rounding (the product of two
    f32 values is exact in f64)."""
    return _f32(float(_f32(a)) * float(_f32(b)) + float(_f32(c)))


def _div_const(x, c) -> np.float32:
    """``x / c`` for a constant ``c``: ``x`` times the f32 reciprocal."""
    return _f32(x) * (_f32(1.0) / _f32(c))


def _exp(x) -> np.float32:
    return _f32(math.exp(float(x)))


def _cos(x) -> np.float32:
    return _f32(math.cos(float(x)))


class ScheduleType(enum.Enum):
    ITERATION = "iteration"
    EPOCH = "epoch"


@dataclasses.dataclass
class ISchedule:
    """Base schedule: :meth:`value_at` gives the rate at a step as a
    Python float (an f32 value)."""

    def value_at(self, step) -> float:
        return float(self._f32_at(int(step)))

    def _f32_at(self, step: int) -> np.float32:
        raise NotImplementedError

    @property
    def schedule_type(self) -> ScheduleType:
        return ScheduleType(getattr(self, "type", "iteration"))


@serializable
@dataclasses.dataclass
class ExponentialSchedule(ISchedule):
    """``initial_value * gamma ** step``."""

    initial_value: float = 0.1
    gamma: float = 0.99
    type: str = "iteration"

    def _f32_at(self, step):
        return _f32(self.initial_value) * _pow(self.gamma, step)


@serializable
@dataclasses.dataclass
class InverseSchedule(ISchedule):
    """``initial_value / (1 + gamma * step) ** power``."""

    initial_value: float = 0.1
    gamma: float = 0.01
    power: float = 1.0
    type: str = "iteration"

    def _f32_at(self, step):
        base = _fma(self.gamma, step, 1.0)
        return _f32(self.initial_value) / _pow(base, self.power)


@serializable
@dataclasses.dataclass
class StepSchedule(ISchedule):
    """``initial_value * decay_rate ** floor(step / step_size)``, the step
    size in the field ``step``."""

    initial_value: float = 0.1
    decay_rate: float = 0.1
    step: float = 100.0
    type: str = "iteration"

    def _f32_at(self, step):
        k = np.floor(_div_const(step, self.step))
        return _f32(self.initial_value) * _pow(self.decay_rate, k)


def _frac(step: int, max_iter) -> np.float32:
    """``min(step / max_iter, 1)`` in f32."""
    return np.minimum(_div_const(step, max_iter), _f32(1.0))


@serializable
@dataclasses.dataclass
class PolySchedule(ISchedule):
    """``initial_value * (1 - min(step / max_iter, 1)) ** power``."""

    initial_value: float = 0.1
    power: float = 1.0
    max_iter: int = 1000
    type: str = "iteration"

    def _f32_at(self, step):
        return _f32(self.initial_value) * _pow(
            _f32(1.0) - _frac(step, self.max_iter), self.power)


@serializable
@dataclasses.dataclass
class SigmoidSchedule(ISchedule):
    """``initial_value / (1 + exp(gamma * (step - step_size)))``."""

    initial_value: float = 0.1
    gamma: float = 0.1
    step_size: int = 100
    type: str = "iteration"

    def _f32_at(self, step):
        e = _exp(_f32(self.gamma) * _f32(step - self.step_size))
        return _f32(self.initial_value) / (_f32(1.0) + e)


@serializable
@dataclasses.dataclass
class MapSchedule(ISchedule):
    """Piecewise constant from ``{step: value}``: the value of the largest
    key at or below the step. JSON keys are strings, made ints here; a
    value for step 0 is required."""

    values: Dict = dataclasses.field(default_factory=dict)
    type: str = "iteration"

    def __post_init__(self):
        self.values = {int(k): float(v) for k, v in self.values.items()}
        if 0 not in self.values:
            raise ValueError("MapSchedule requires a value for step 0")

    def _f32_at(self, step):
        reached = [k for k in self.values if k <= step]
        return _f32(self.values[max(reached) if reached
                                else min(self.values)])


@serializable
@dataclasses.dataclass
class CosineSchedule(ISchedule):
    """Cosine decay from ``initial_value`` to ``final_value`` over
    ``max_iter`` steps, then flat."""

    initial_value: float = 0.1
    max_iter: int = 1000
    final_value: float = 0.0
    type: str = "iteration"

    def _f32_at(self, step):
        c = _f32(0.5) * (_f32(1.0) + _cos(_f32(np.pi)
                                          * _frac(step, self.max_iter)))
        # the JAX side subtracts the two Python floats before rounding
        return _fma(self.initial_value - self.final_value, c,
                    self.final_value)


@serializable
@dataclasses.dataclass
class WarmupSchedule(ISchedule):
    """Linear warmup over ``warmup_steps`` in front of the schedule
    ``base``, which starts at 0 after the warmup."""

    warmup_steps: int = 100
    base: object = None

    def _f32_at(self, step):
        warm = max(self.warmup_steps, 1)
        base_v = _f32(self.base._f32_at(max(step - warm, 0)))
        return base_v * np.minimum(_div_const(step + 1, warm), _f32(1.0))


def resolve_lr(lr_or_schedule, step) -> float:
    """A float learning rate rounded to f32, or a schedule's value at
    ``step`` (an int or a one-element tensor), as a Python float."""
    if isinstance(lr_or_schedule, ISchedule):
        return lr_or_schedule.value_at(int(step))
    return float(_f32(lr_or_schedule))


def uses_epoch_schedule(updater) -> bool:
    """Whether ``updater``'s learning rate is a schedule that counts
    epochs rather than iterations."""
    lr = getattr(updater, "learning_rate", None)
    return (isinstance(lr, ISchedule)
            and lr.schedule_type is ScheduleType.EPOCH)


__all__ = ["ScheduleType", "ISchedule", "ExponentialSchedule",
           "InverseSchedule", "StepSchedule", "PolySchedule",
           "SigmoidSchedule", "MapSchedule", "CosineSchedule",
           "WarmupSchedule", "resolve_lr", "uses_epoch_schedule"]
