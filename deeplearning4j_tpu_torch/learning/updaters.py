"""Updaters: counterpart of ``deeplearning4j_tpu/learning/updaters.py``.

Same contract: ``apply(state, grads, step) -> (updates, new_state)`` over
a parameter tree (nested dicts and lists of tensors, or one flat
tensor), and the caller subtracts the updates. State leaves parallel the
parameter leaves and are f32. :func:`apply_updater` is the layer
framework's entry point (grads cast up to f32 on the way in, updates cast
to each parameter's dtype on the way out).

Only :class:`Adam`, :class:`Nesterovs` and :class:`Sgd` with a float
learning rate are ported, registered for the config JSON like the JAX classes. A
learning-rate schedule (an ``ISchedule`` in the JAX package) raises
``NotImplementedError`` until ``learning/schedules.py`` is ported; the
other updaters are not ported yet.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Any

import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.params import tree_map


def step_float(t) -> torch.Tensor:
    """The bias-correction step count as an f32 scalar (``_step_float``,
    updaters.py:36-43): ``1 - beta ** t`` is taken in f32 even where
    parameters are half precision."""
    if torch.is_tensor(t):
        return t.to(torch.float32)
    return torch.tensor(float(t), dtype=torch.float32)


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """A zero accumulator for ``p``, at least f32 (``_zeros_f32``,
    updaters.py:46-52)."""
    return torch.zeros(p.shape, device=p.device,
                       dtype=torch.promote_types(p.dtype, torch.float32))


@dataclasses.dataclass
class IUpdater:
    """Base updater config. Stateless by default."""

    def init_state(self, params) -> Any:
        return ()

    def apply(self, state, grads, step):
        """Return (updates, new_state); the caller applies
        ``params -= updates``."""
        raise NotImplementedError

    def has_state(self) -> bool:
        return False

    def _lr(self, step) -> float:
        lr = self.learning_rate
        if isinstance(lr, numbers.Real):
            return float(lr)
        raise NotImplementedError(
            f"learning-rate schedules are not ported yet (got "
            f"{type(lr).__name__}); pass a float learning rate")


@serializable
@dataclasses.dataclass
class Sgd(IUpdater):
    learning_rate: Any = 0.1

    def apply(self, state, grads, step):
        lr = self._lr(step)
        return tree_map(lambda g: lr * g, grads), state


@serializable
@dataclasses.dataclass
class Nesterovs(IUpdater):
    """SGD with Nesterov momentum, the reference's formulation:
    ``v' = mu * v - lr * g`` and ``update = -(mu * v' - lr * g)``."""

    learning_rate: Any = 0.1
    momentum: float = 0.9

    def has_state(self):
        return True

    def init_state(self, params):
        return {"v": tree_map(zeros_f32, params)}

    def apply(self, state, grads, step):
        lr = self._lr(step)
        mu = self.momentum
        v_new = tree_map2(lambda v, g: mu * v - lr * g, state["v"], grads)
        updates = tree_map2(lambda vn, g: -(mu * vn - lr * g), v_new, grads)
        return updates, {"v": v_new}


@serializable
@dataclasses.dataclass
class Adam(IUpdater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def has_state(self):
        return True

    def init_state(self, params):
        # m and v are distinct buffers: the flat train step updates both
        # in place
        return {"m": tree_map(zeros_f32, params),
                "v": tree_map(zeros_f32, params)}

    def bias_corrected_lr(self, step) -> torch.Tensor:
        """``alpha = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` at
        ``t = step + 1``, in f32 (updaters.py:141-148)."""
        lr = self._lr(step)
        tf = step_float(step + 1)
        bc1 = 1 - torch.pow(torch.tensor(self.beta1, dtype=torch.float32), tf)
        bc2 = 1 - torch.pow(torch.tensor(self.beta2, dtype=torch.float32), tf)
        return lr * torch.sqrt(bc2) / bc1

    def apply(self, state, grads, step):
        b1, b2 = self.beta1, self.beta2
        # the f32 value as a Python number: a scalar operand needs no copy
        # to the card (a blocking copy there waits for the stream)
        alpha = float(self.bias_corrected_lr(step))
        m = tree_map2(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map2(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                      grads)
        updates = tree_map2(
            lambda m_, v_: alpha * m_ / (torch.sqrt(v_) + self.epsilon), m, v)
        return updates, {"m": m, "v": v}


def tree_map2(fn, a, b):
    """``fn`` over the paired leaves of two trees of the same structure."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [tree_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def apply_updater(updater: IUpdater, state, grads, params, step):
    """``updater.apply`` with the gradients cast up to at least f32 on the
    way in and the updates cast to each parameter's dtype on the way out
    (updaters.py:283-298): the update math runs in f32 while bf16
    parameters stay bf16."""
    grads = tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, torch.float32)), grads)
    updates, new_state = updater.apply(state, grads, step)
    return tree_map2(lambda u, p: u.to(p.dtype), updates, params), new_state
