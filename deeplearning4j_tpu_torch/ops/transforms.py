"""Elementwise transforms: counterpart of the activation part of
``deeplearning4j_tpu/ops/transforms.py``, each under its JAX name in the
port's own registry, each the formula of the JAX function (``jax.nn``'s
where the JAX op calls it): ``sigmoid`` (:19), ``tanh`` (:24), ``relu``
(:29), ``relu6`` (:34), ``leakyrelu`` (:39), ``elu`` (:44), ``selu``
(:49), ``gelu`` (:54, the tanh approximation, ``jax.nn.gelu``'s
default), ``softplus`` (:59), ``softsign`` (:64), ``swish`` (:69),
``mish`` (:74), ``hardsigmoid`` (:79), ``hardtanh`` (:84), ``softmax``
(:89), ``cube`` (:159), ``rationaltanh`` (:256), ``recttanh`` (:262) and
``thresholdedrelu`` (:267); and, unregistered, ``PReLULayer``'s
:func:`prelu` (:273-274). The rest of the file waits (ROADMAP A10)."""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops.registry import register_op


def _const(c: float, x: torch.Tensor) -> torch.Tensor:
    """A constant in ``x``'s dtype, as ``numpy``'s ``astype`` gives it to
    ``jax.nn.gelu``."""
    return torch.tensor(c, dtype=x.dtype, device=x.device)


def jax_abs(x):
    """``|x|`` with slope 1 at 0, where ``jnp.abs`` differentiates so
    (``torch.abs`` gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def jax_clip(x, lo=None, hi=None):
    """``jnp.clip`` (and ``jnp.maximum`` / ``jnp.minimum`` with a constant):
    at a tie with a bound the gradient is split, half to ``x``, as JAX's
    ``max`` / ``min`` differentiate (``torch.clamp`` passes all of it)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


@register_op("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register_op("tanh")
def tanh(x):
    return torch.tanh(x)


@register_op("relu")
def relu(x):
    return torch.relu(x)


@register_op("relu6")
def relu6(x):
    """``min(max(x, 0), 6)`` with slope 0 at both kinks, as
    ``jax.nn.relu6`` differentiates."""
    return torch.where(x >= 6.0, torch.full_like(x, 6.0), torch.relu(x))


@register_op("leakyrelu")
def leaky_relu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


@register_op("elu")
def elu(x, alpha=1.0):
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(
        torch.where(pos, torch.zeros_like(x), x)))


@register_op("selu")
def selu(x):
    return 1.0507009873554804934193349852946 * elu(
        x, 1.6732632423543772848170429916717)


@register_op("gelu")
def gelu(x):
    """The tanh approximation in ``jax.nn.gelu``'s order."""
    cdf = 0.5 * (1.0 + torch.tanh(_const(math.sqrt(2 / math.pi), x)
                                  * (x + 0.044715 * (x ** 3))))
    return x * cdf


@register_op("softplus")
def softplus(x):
    """``logaddexp(x, 0)``, as ``jax.nn.softplus`` (slope 1/2 at 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@register_op("softsign")
def softsign(x):
    return x / (torch.abs(x) + 1)


@register_op("swish")
def swish(x):
    return x * torch.sigmoid(x)


@register_op("mish")
def mish(x):
    return x * torch.tanh(softplus(x))


@register_op("hardsigmoid")
def hard_sigmoid(x):
    return jax_clip(0.2 * x + 0.5, 0.0, 1.0)


@register_op("hardtanh")
def hard_tanh(x):
    return jax_clip(x, -1.0, 1.0)


@register_op("softmax")
def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


@register_op("cube")
def cube(x):
    return x * x * x


@register_op("rationaltanh")
def rational_tanh(x):
    """The reference's tanh approximation ``1.7159 * tanh(2x / 3)``."""
    return 1.7159 * torch.tanh(2.0 * x / 3.0)


@register_op("recttanh")
def rectified_tanh(x):
    return jax_clip(torch.tanh(x), lo=0.0)


@register_op("thresholdedrelu")
def thresholded_relu(x, theta=1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


def prelu(x, alpha):
    """``x`` where ``x >= 0``, else ``alpha * x`` (``jnp.where``: at ``x =
    0`` the gradient goes to ``x``)."""
    return torch.where(x >= 0, x, alpha * x)
