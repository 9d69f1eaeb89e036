"""Weight noise: counterpart of ``deeplearning4j_tpu/nn/conf/weightnoise.py``
(``IWeightNoise``, ``DropConnect``, ``WeightNoise``).

Applied to a layer's weight parameters (the keys of :data:`WEIGHT_KEYS`;
never a bias or a normalisation scale) on each training forward, by
``MultiLayerNetwork``, ``ComputationGraph`` and the pretrain step; the
noise is drawn from the explicit ``torch.Generator`` (JAX's
distributions, not its draws). Configure through ``Layer.weight_noise``.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.common.serde import serializable

#: parameter keys treated as weights (the JAX set)
WEIGHT_KEYS = {"W", "RW", "dW", "pW", "Wq", "Wk", "Wv", "Wo", "Wa"}


class IWeightNoise:
    """The interface: ``apply(params, generator)`` gives the parameters
    with each weight entry noised by ``_noise_one``."""

    def _noise_one(self, w, generator):  # pragma: no cover - interface
        raise NotImplementedError

    def apply(self, params: dict, generator) -> dict:
        out = dict(params)
        for k in params:
            if k in WEIGHT_KEYS:
                out[k] = self._noise_one(params[k], generator)
        return out


@serializable
@dataclasses.dataclass
class DropConnect(IWeightNoise):
    """Each weight dropped with probability ``rate``; the kept ones scaled
    by ``1 / (1 - rate)`` (inverted), so the expected pre-activation holds.
    """

    rate: float = 0.5

    def _noise_one(self, w, generator):
        keep = 1.0 - self.rate
        mask = torch.rand(w.shape, generator=generator,
                          device=w.device) < keep
        return torch.where(mask, w / keep, torch.zeros((), dtype=w.dtype,
                                                       device=w.device))


@serializable
@dataclasses.dataclass
class WeightNoise(IWeightNoise):
    """Gaussian noise ``mean + stddev * N(0, 1)``, added to each weight
    (``additive``) or multiplied into it."""

    mean: float = 0.0
    stddev: float = 0.1
    additive: bool = True

    def _noise_one(self, w, generator):
        noise = self.mean + self.stddev * torch.randn(
            w.shape, generator=generator, device=w.device, dtype=w.dtype)
        return w + noise if self.additive else w * noise


__all__ = ["WEIGHT_KEYS", "IWeightNoise", "DropConnect", "WeightNoise"]
