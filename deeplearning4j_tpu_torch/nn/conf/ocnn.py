"""The one-class output layer: counterpart of
``deeplearning4j_tpu/nn/conf/ocnn.py`` (``OCNNOutputLayer``, Chalapathy
et al.'s one-class neural network head).

The objective ``0.5 ||V||^2 + 0.5 ||w||^2 + mean(max(0, r - w . g(x V)))
/ nu - r`` ignores the labels. ``r`` is a trainable f32 scalar under
every policy, moved by the same step as ``V`` and ``w`` (the JAX
package's design in place of the reference's windowed quantile). The
hinge takes JAX's gradient at a tie (half, ``ops.transforms.jax_clip``).
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, _act
from deeplearning4j_tpu_torch.nn.weights import WeightInit, init_weights
from deeplearning4j_tpu_torch.ops.transforms import jax_clip


@serializable
@dataclasses.dataclass
class OCNNOutputLayer(Layer):
    """A one-class head: ``fit(x, y)`` ignores ``y`` (pass zeros); the
    activation (relu by default) is the hidden ``g``. The output is the
    decision value ``w . g(x V) - r`` per example, ``[N, 1]`` (>= 0 is
    normal)."""

    n_in: int = 0
    hidden_size: int = 64
    nu: float = 0.04
    initial_r_value: float = 0.1

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(1)

    def init_params(self, generator, it, dtype, device) -> dict:
        v = init_weights(self.weight_init or WeightInit.XAVIER, generator,
                         (self.n_in, self.hidden_size), self.n_in,
                         self.hidden_size, dtype, device)
        return {"V": v,
                "W": torch.full((self.hidden_size,), 1.0 / self.hidden_size,
                                dtype=dtype, device=device),
                "r": torch.tensor(self.initial_r_value, dtype=torch.float32,
                                  device=device)}

    def _scores(self, params, x):
        h = _act(self.activation or "relu").fn(x @ params["V"])
        return (h @ params["W"]).to(torch.float32)

    def loss_value(self, params, state, x, labels, mask=None):
        s = self._scores(params, x)
        r = params["r"]
        hinge = jax_clip(r - s, lo=0.0)
        if mask is not None:
            m = mask.to(hinge.dtype).reshape(hinge.shape)
            hinge_mean = torch.sum(hinge * m) / torch.clamp(torch.sum(m),
                                                            min=1.0)
        else:
            hinge_mean = torch.mean(hinge)
        vf = params["V"].to(torch.float32)
        wf = params["W"].to(torch.float32)
        return (0.5 * torch.sum(vf * vf) + 0.5 * torch.sum(wf * wf)
                + hinge_mean / self.nu - r)

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        return (self._scores(params, x) - params["r"])[:, None], state


__all__ = ["OCNNOutputLayer"]
