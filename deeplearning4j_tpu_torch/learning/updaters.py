"""Updaters: counterpart of ``deeplearning4j_tpu/learning/updaters.py``.

Same contract: ``apply(state, grads, step) -> (updates, new_state)`` over
a parameter tree (nested dicts and lists of tensors, or one flat
tensor), and the caller subtracts the updates. State leaves parallel the
parameter leaves and are f32. :func:`apply_updater` is the layer
framework's entry point (grads cast up to f32 on the way in, updates cast
to each parameter's dtype on the way out).

All eleven updaters of the JAX package are ported and registered for
the config JSON like the JAX classes: :class:`NoOp`, :class:`Sgd`,
:class:`Nesterovs`, :class:`Adam`, :class:`AdamW` (decoupled weight
decay, through ``apply_with_params``), :class:`AdaMax`, :class:`Nadam`,
:class:`AMSGrad`, :class:`AdaGrad`, :class:`AdaDelta` and
:class:`RmsProp`. A learning rate is a float or an ``ISchedule``
(``learning.schedules``), resolved on the host to a Python float of f32
value at each step, so no rate is copied to the card. Bias corrections
``1 - beta^t`` are taken in f32 whatever the parameters' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.learning.schedules import resolve_lr
from deeplearning4j_tpu_torch.params import tree_map, tree_map2


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
        """The learning rate at ``step`` (a float, or a schedule's value)
        as a Python float of f32 value."""
        return resolve_lr(self.learning_rate, step)


def _tmap(fn, *trees):
    """``fn`` over the matching leaves of trees of one structure."""
    a = trees[0]
    if isinstance(a, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, (list, tuple)):
        return [_tmap(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _bias_correction(beta: float, step) -> torch.Tensor:
    """``1 - beta^t`` at ``t = step + 1``, in f32."""
    return 1 - torch.pow(torch.tensor(beta, dtype=torch.float32),
                         step_float(step + 1))


@serializable
@dataclasses.dataclass
class NoOp(IUpdater):
    """A zero update (frozen parameters)."""

    def apply(self, state, grads, step):
        return tree_map(torch.zeros_like, grads), state


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
        bc1 = _bias_correction(self.beta1, step)
        bc2 = _bias_correction(self.beta2, step)
        return lr * torch.sqrt(bc2) / bc1

    def _moments(self, state, grads):
        b1, b2 = self.beta1, self.beta2
        m = tree_map2(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map2(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                      grads)
        return m, v

    def apply(self, state, grads, step):
        # the f32 value as a Python number: a scalar operand needs no copy
        # to the card (a blocking copy there waits for the stream)
        alpha = float(self.bias_corrected_lr(step))
        m, v = self._moments(state, grads)
        updates = tree_map2(
            lambda m_, v_: alpha * m_ / (torch.sqrt(v_) + self.epsilon), m, v)
        return updates, {"m": m, "v": v}


@serializable
@dataclasses.dataclass
class AdamW(Adam):
    """Adam with decoupled weight decay: ``lr * weight_decay * p`` added
    to Adam's update (``apply_with_params``, which ``apply_updater``
    calls)."""

    weight_decay: float = 0.01

    def apply_with_params(self, state, grads, params, step):
        updates, new_state = Adam.apply(self, state, grads, step)
        # lr * weight_decay in f32, as the JAX side's f32 rate makes it;
        # the parameter promoted to at least f32 by that product
        c = float(np.float32(self._lr(step)) * np.float32(self.weight_decay))
        return tree_map2(lambda u, p: u + c * p.to(torch.promote_types(
            p.dtype, torch.float32)), updates, params), new_state


@serializable
@dataclasses.dataclass
class AdaMax(Adam):
    """Adam with the infinity norm: ``u = max(beta2 * u, |g|)`` (kept
    under the state key ``v``), update ``lr / (1 - beta1^t) * m / (u +
    eps)``."""

    def apply(self, state, grads, step):
        b1 = self.beta1
        scale = float(self._lr(step) / _bias_correction(b1, step))
        m = tree_map2(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        u = tree_map2(lambda v_, g: torch.maximum(self.beta2 * v_,
                                                  torch.abs(g)),
                      state["v"], grads)
        updates = tree_map2(lambda m_, u_: scale * m_ / (u_ + self.epsilon),
                            m, u)
        return updates, {"m": m, "v": u}


@serializable
@dataclasses.dataclass
class Nadam(Adam):
    """Adam with Nesterov momentum: ``lr / bc1 * (beta1 * m + (1 - beta1)
    * g) / (sqrt(v / bc2) + eps)``."""

    def apply(self, state, grads, step):
        b1 = self.beta1
        bc1 = _bias_correction(b1, step)
        bc2 = float(_bias_correction(self.beta2, step))
        scale = float(self._lr(step) / bc1)
        m, v = self._moments(state, grads)

        def upd(m_, v_, g):
            return (scale * (b1 * m_ + (1 - b1) * g)
                    / (torch.sqrt(v_ / bc2) + self.epsilon))

        return _tmap(upd, m, v, grads), {"m": m, "v": v}


@serializable
@dataclasses.dataclass
class AMSGrad(Adam):
    """Adam on the running maximum ``vhat`` of the second moment."""

    def init_state(self, params):
        return {"m": tree_map(zeros_f32, params),
                "v": tree_map(zeros_f32, params),
                "vhat": tree_map(zeros_f32, params)}

    def apply(self, state, grads, step):
        alpha = float(self.bias_corrected_lr(step))
        m, v = self._moments(state, grads)
        vhat = tree_map2(torch.maximum, state["vhat"], v)
        updates = tree_map2(
            lambda m_, vh: alpha * m_ / (torch.sqrt(vh) + self.epsilon), m,
            vhat)
        return updates, {"m": m, "v": v, "vhat": vhat}


@serializable
@dataclasses.dataclass
class AdaGrad(IUpdater):
    """``h += g^2``, update ``lr * g / (sqrt(h) + eps)``."""

    learning_rate: Any = 0.1
    epsilon: float = 1e-6

    def has_state(self):
        return True

    def init_state(self, params):
        return {"h": tree_map(zeros_f32, params)}

    def apply(self, state, grads, step):
        lr = self._lr(step)
        h = tree_map2(lambda h_, g: h_ + g * g, state["h"], grads)
        updates = tree_map2(
            lambda g, h_: lr * g / (torch.sqrt(h_) + self.epsilon), grads, h)
        return updates, {"h": h}


@serializable
@dataclasses.dataclass
class AdaDelta(IUpdater):
    """No learning rate: ``msg`` and ``msdx``, running means of g^2 and
    of the squared updates, update ``g * sqrt(msdx + eps) / sqrt(msg +
    eps)``."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def has_state(self):
        return True

    def init_state(self, params):
        return {"msg": tree_map(zeros_f32, params),
                "msdx": tree_map(zeros_f32, params)}

    def apply(self, state, grads, step):
        rho, eps = self.rho, self.epsilon
        msg = tree_map2(lambda a, g: rho * a + (1 - rho) * g * g,
                        state["msg"], grads)
        updates = _tmap(
            lambda g, ms, md: g * torch.sqrt(md + eps) / torch.sqrt(ms + eps),
            grads, msg, state["msdx"])
        msdx = tree_map2(lambda a, u: rho * a + (1 - rho) * u * u,
                         state["msdx"], updates)
        return updates, {"msg": msg, "msdx": msdx}


@serializable
@dataclasses.dataclass
class RmsProp(IUpdater):
    """``g2 = decay * g2 + (1 - decay) * g^2``, update ``lr * g / (sqrt(g2)
    + eps)``."""

    learning_rate: Any = 0.1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def has_state(self):
        return True

    def init_state(self, params):
        return {"g2": tree_map(zeros_f32, params)}

    def apply(self, state, grads, step):
        lr, d = self._lr(step), self.rms_decay
        g2 = tree_map2(lambda a, g: d * a + (1 - d) * g * g, state["g2"],
                       grads)
        updates = tree_map2(
            lambda g, a: lr * g / (torch.sqrt(a) + self.epsilon), grads, g2)
        return updates, {"g2": g2}


def apply_updater(updater: IUpdater, state, grads, params, step):
    """``updater.apply`` (or ``apply_with_params``, for an updater that
    reads the parameters: AdamW) with the gradients cast up to at least
    f32 on the way in and the updates cast to each parameter's dtype on
    the way out (updaters.py:283-298): the update math runs in f32 while
    bf16 parameters stay bf16."""
    grads = tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, torch.float32)), grads)
    if hasattr(updater, "apply_with_params"):
        updates, new_state = updater.apply_with_params(state, grads, params,
                                                       step)
    else:
        updates, new_state = updater.apply(state, grads, step)
    return tree_map2(lambda u, p: u.to(p.dtype), updates, params), new_state


__all__ = ["IUpdater", "NoOp", "Sgd", "Nesterovs", "Adam", "AdamW",
           "AdaMax", "Nadam", "AMSGrad", "AdaGrad", "AdaDelta", "RmsProp",
           "apply_updater", "step_float", "zeros_f32"]
