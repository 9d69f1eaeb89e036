"""Elementwise transforms: counterpart of
``deeplearning4j_tpu/ops/transforms.py``, every name it registers, each
the formula of the JAX function (``jax.nn``'s where the JAX op calls it),
with JAX's parameter names and defaults. Where torch differentiates a
kink otherwise than JAX (``jnp.abs`` at 0, ``jnp.clip`` at a bound),
:func:`jax_abs` and :func:`jax_clip` take JAX's slope."""

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


@register_op("prelu")
def prelu(x, alpha):
    """``x`` where ``x >= 0``, else ``alpha * x`` (``jnp.where``: at ``x =
    0`` the gradient goes to ``x``)."""
    return torch.where(x >= 0, x, alpha * x)


def _f(x):
    """Integers and booleans as float32, as ``jnp``'s float functions take
    them."""
    return x if x.is_floating_point() else x.to(torch.float32)


@register_op("log_softmax")
def log_softmax(x, axis=-1):
    return torch.log_softmax(_f(x), dim=axis)


@register_op("exp")
def exp(x):
    return torch.exp(x)


@register_op("log")
def log(x):
    return torch.log(x)


@register_op("log1p")
def log1p(x):
    return torch.log1p(x)


@register_op("sqrt")
def sqrt(x):
    return torch.sqrt(x)


@register_op("rsqrt")
def rsqrt(x):
    return torch.rsqrt(_f(x))


@register_op("abs")
def abs_(x):
    return jax_abs(x) if x.is_floating_point() else torch.abs(x)


@register_op("sign")
def sign(x):
    return torch.sign(x)


@register_op("floor")
def floor(x):
    return torch.floor(x)


@register_op("ceil")
def ceil(x):
    return torch.ceil(x)


@register_op("round")
def round_(x):
    """Half to even, as ``jnp.round``."""
    return torch.round(x)


@register_op("pow")
def pow_(x, p):
    return torch.pow(x, p)


@register_op("square")
def square(x):
    return torch.square(x)


@register_op("reciprocal")
def reciprocal(x):
    return 1.0 / x


@register_op("sin")
def sin(x):
    return torch.sin(x)


@register_op("cos")
def cos(x):
    return torch.cos(x)


@register_op("tan")
def tan(x):
    return torch.tan(x)


@register_op("asin")
def asin(x):
    return torch.asin(x)


@register_op("acos")
def acos(x):
    return torch.acos(x)


@register_op("atan")
def atan(x):
    return torch.atan(x)


@register_op("atan2")
def atan2(y, x):
    return torch.atan2(y, x)


@register_op("sinh")
def sinh(x):
    return torch.sinh(x)


@register_op("cosh")
def cosh(x):
    return torch.cosh(x)


@register_op("erf")
def erf(x):
    return torch.erf(_f(x))


def _bound(v, x):
    return v.to(x.dtype) if isinstance(v, torch.Tensor) else \
        torch.tensor(v, dtype=x.dtype, device=x.device)


@register_op("clip_by_value")
def clip_by_value(x, lo, hi):
    """``jnp.clip``: ``min(max(x, lo), hi)`` with JAX's split slope at a
    tie."""
    return torch.minimum(torch.maximum(x, _bound(lo, x)), _bound(hi, x))


@register_op("clip_by_norm")
def clip_by_norm(x, clip_norm, axis=None):
    if axis is None:
        n = torch.sqrt(torch.sum(x * x))
    else:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    scale = torch.where(n > clip_norm, clip_norm / torch.clamp(n, min=1e-12),
                        torch.ones_like(n))
    return x * scale


@register_op("max_pairwise")
def max_pairwise(x, y):
    return torch.maximum(x, y)


@register_op("min_pairwise")
def min_pairwise(x, y):
    return torch.minimum(x, y)


@register_op("isnan")
def isnan(x):
    return torch.isnan(x)


@register_op("isinf")
def isinf(x):
    return torch.isinf(x)


@register_op("step")
def step(x):
    return (x > 0).to(x.dtype)


@register_op("standardize")
def standardize(x, axis=-1, eps=1e-5):
    m = torch.mean(x, dim=axis, keepdim=True)
    v = torch.var(x, dim=axis, keepdim=True, correction=0)
    return (x - m) / torch.sqrt(v + eps)
