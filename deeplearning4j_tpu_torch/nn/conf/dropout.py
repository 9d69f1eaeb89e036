"""The dropout family: counterpart of ``deeplearning4j_tpu/nn/conf/dropout.py``
(``IDropout`` and its five configs).

Each config is a serializable dataclass with the JAX class's name and
fields, and ``apply(x, generator)`` draws its noise from the explicit
``torch.Generator`` (on ``x``'s device). A layer's ``dropout`` field takes
a plain float (inverted dropout at that drop rate, ``ops.nn.dropout``) or
one of these configs; both run in training only.

The draws keep JAX's distributions, not its threefry bits; everything
deterministic (the scalings, the SELU constants, the affine correction)
is JAX's. ``rate`` is the DROP probability, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from deeplearning4j_tpu_torch.common.serde import serializable


def _keep_mask(shape, keep: float, generator, device) -> torch.Tensor:
    """A boolean mask, each entry True with probability ``keep``."""
    return torch.rand(shape, generator=generator, device=device) < keep


def _normal(shape, generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=like.dtype)


class IDropout:
    """The interface: ``apply(x, generator)`` in training."""

    def apply(self, x, generator):  # pragma: no cover - interface
        raise NotImplementedError


@serializable
@dataclasses.dataclass
class Dropout(IDropout):
    """Inverted dropout: kept entries scaled by ``1 / (1 - rate)``."""

    rate: float = 0.5

    def apply(self, x, generator):
        keep = 1.0 - self.rate
        mask = _keep_mask(x.shape, keep, generator, x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


@serializable
@dataclasses.dataclass
class SpatialDropout(IDropout):
    """Whole channels dropped: the mask is drawn per (example, channel),
    shape ``(N, 1, ..., 1, C)`` on the trailing (NHWC or NTF) axis, and
    broadcast over the spatial or time axes."""

    rate: float = 0.5

    def apply(self, x, generator):
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        mask = _keep_mask(shape, keep, generator, x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


@serializable
@dataclasses.dataclass
class GaussianDropout(IDropout):
    """Multiplicative noise ``N(1, rate / (1 - rate))``: mean-preserving,
    so inference needs no rescale."""

    rate: float = 0.5

    def apply(self, x, generator):
        std = math.sqrt(self.rate / (1.0 - self.rate))
        return x * (1.0 + std * _normal(x.shape, generator, x))


@serializable
@dataclasses.dataclass
class GaussianNoise(IDropout):
    """Additive zero-mean noise of standard deviation ``stddev``."""

    stddev: float = 0.1

    def apply(self, x, generator):
        return x + self.stddev * _normal(x.shape, generator, x)


# SELU fixed-point constants (Klambauer et al. 2017), as the JAX module
_ALPHA = 1.6732632423543772
_SCALE = 1.0507009873554805
_ALPHA_PRIME = -_SCALE * _ALPHA


@serializable
@dataclasses.dataclass
class AlphaDropout(IDropout):
    """Dropout for SELU networks: dropped units set to ``alpha'`` and the
    result corrected by ``a * x + b`` so the mean and variance hold."""

    rate: float = 0.5

    def apply(self, x, generator):
        keep = 1.0 - self.rate
        a = (keep + _ALPHA_PRIME ** 2 * keep * (1.0 - keep)) ** -0.5
        b = -a * _ALPHA_PRIME * (1.0 - keep)
        mask = _keep_mask(x.shape, keep, generator, x.device)
        dropped = torch.full((), _ALPHA_PRIME, dtype=x.dtype, device=x.device)
        return (a * torch.where(mask, x, dropped) + b).to(x.dtype)


def resolve_dropout(d):
    """A float to ``Dropout(rate)``; an ``IDropout`` to itself; None to
    None."""
    if d is None:
        return None
    if isinstance(d, IDropout):
        return d
    return Dropout(rate=float(d))


__all__ = ["IDropout", "Dropout", "SpatialDropout", "GaussianDropout",
           "GaussianNoise", "AlphaDropout", "resolve_dropout"]
