"""Weight constraints: counterpart of ``deeplearning4j_tpu/nn/conf/constraint.py``
(``LayerConstraint`` and its four configs, ``apply_constraints``).

Applied after every update to a layer's weight parameters (the keys of
``weightnoise.WEIGHT_KEYS``), by ``fit`` of both networks and by the
pretrain step. A unit's norm is taken over the fan-in axes, all but the
last (:func:`_unit_axes`), as in the JAX package. The constraints are
deterministic and match JAX's formulas term for term. Configure through
``Layer.constraints`` (a list).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.nn.conf.weightnoise import WEIGHT_KEYS


class LayerConstraint:
    """The interface: ``apply(params)`` gives the parameters with each
    weight entry constrained by ``_constrain_one``."""

    def _constrain_one(self, w):  # pragma: no cover - interface
        raise NotImplementedError

    def apply(self, params: dict) -> dict:
        out = dict(params)
        for k in params:
            if k in WEIGHT_KEYS:
                out[k] = self._constrain_one(params[k])
        return out


def _unit_axes(w) -> Tuple[int, ...]:
    """The fan-in axes: every axis but the output (last) one."""
    return tuple(range(w.dim() - 1)) if w.dim() > 1 else (0,)


def _unit_norm(w) -> torch.Tensor:
    return torch.sqrt(torch.sum(w * w, dim=_unit_axes(w), keepdim=True)
                      + 1e-12)


@serializable
@dataclasses.dataclass
class MaxNormConstraint(LayerConstraint):
    """Each unit's incoming-weight L2 norm clipped to ``max_norm``."""

    max_norm: float = 2.0

    def _constrain_one(self, w):
        return w * torch.clamp(self.max_norm / _unit_norm(w), max=1.0)


@serializable
@dataclasses.dataclass
class MinMaxNormConstraint(LayerConstraint):
    """Each unit's norm moved into ``[min_norm, max_norm]`` with strength
    ``rate`` (1 rescales all the way)."""

    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0

    def _constrain_one(self, w):
        norm = _unit_norm(w)
        clipped = torch.clamp(norm, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1.0 - self.rate) * norm
        return w * (target / norm)


@serializable
@dataclasses.dataclass
class UnitNormConstraint(LayerConstraint):
    """Each unit's incoming weights scaled to L2 norm 1."""

    def _constrain_one(self, w):
        return w / _unit_norm(w)


@serializable
@dataclasses.dataclass
class NonNegativeConstraint(LayerConstraint):
    """Weights clamped at 0 from below."""

    def _constrain_one(self, w):
        return torch.clamp(w, min=0.0)


def apply_constraints(layer, params: dict) -> dict:
    """``layer``'s configured constraints, in order, on ``params`` (the
    parameters after an update); ``params`` itself where it has none."""
    for c in getattr(layer, "constraints", None) or ():
        params = c.apply(params)
    return params


__all__ = ["LayerConstraint", "MaxNormConstraint", "MinMaxNormConstraint",
           "UnitNormConstraint", "NonNegativeConstraint", "apply_constraints"]
