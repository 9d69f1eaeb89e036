"""Random draws by name: counterpart of ``deeplearning4j_tpu/ops/random.py``,
every name it registers, with its parameters and defaults.

Where JAX takes a key as ``rng``, the port takes a ``torch.Generator`` or
an integer seed (a generator seeded with it on the result's device):
the same distribution as ``jax.random``'s, not the same draws. A draw
with no tensor input lands on the running graph's device, else the CUDA
card (``ops/jax_rules.py`` ``op_device``).
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


def generator_on(rng, device) -> torch.Generator:
    """``rng`` as a generator on ``device``: a generator is used as it is
    (it must live there), an integer seeds a new one, None takes torch's
    default generator."""
    if rng is None or isinstance(rng, torch.Generator):
        return rng
    g = torch.Generator(device=device)
    g.manual_seed(int(rng))
    return g


def _draw(rng, shape, dtype="float32"):
    """``(generator, device, dtype, shape)`` of a draw."""
    dev = rng.device if isinstance(rng, torch.Generator) else jr.op_device()
    return (generator_on(rng, dev), dev, jr.torch_dtype(dtype),
            tuple(int(d) for d in shape))


def _uniform(g, dev, shape, lo=0.0, hi=1.0):
    """f32 uniform on ``[lo, hi)``."""
    return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo


@register_op("random_uniform")
def random_uniform(rng, shape, minval=0.0, maxval=1.0, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    return _uniform(g, dev, shape, minval, maxval).to(dt)


@register_op("random_normal")
def random_normal(rng, shape, mean=0.0, std=1.0, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    return (mean + std * torch.randn(shape, generator=g, device=dev)).to(dt)


@register_op("random_bernoulli")
def random_bernoulli(rng, shape, p=0.5, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    return (torch.rand(shape, generator=g, device=dev) < p).to(dt)


@register_op("random_exponential")
def random_exponential(rng, shape, lam=1.0, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    e = torch.empty(shape, device=dev).exponential_(generator=g)
    return (e / lam).to(dt)


@register_op("truncated_normal")
def truncated_normal(rng, shape, mean=0.0, std=1.0, dtype="float32"):
    """A standard normal truncated to ``[-2, 2]`` (by the inverse CDF),
    then scaled and shifted."""
    g, dev, dt, shape = _draw(rng, shape, dtype)
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = _uniform(g, dev, shape, lo, hi)
    z = math.sqrt(2) * torch.erfinv(2 * u - 1)
    return (mean + std * torch.clamp(z, -2.0, 2.0)).to(dt)


def _gamma(alpha, g, dev, shape):
    return torch._standard_gamma(
        torch.full(shape, float(alpha), device=dev), generator=g)


@register_op("random_gamma")
def random_gamma(rng, shape, alpha=1.0, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    return _gamma(alpha, g, dev, shape).to(dt)


@register_op("random_poisson")
def random_poisson(rng, shape, lam=1.0, dtype="int32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    return torch.poisson(torch.full(shape, float(lam), device=dev),
                         generator=g).to(dt)


@register_op("dropout_mask")
def dropout_mask(rng, shape, keep_prob, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    keep = (torch.rand(shape, generator=g, device=dev) < keep_prob)
    return keep.to(dt) / keep_prob


@register_op("random_laplace")
def random_laplace(rng, shape, loc=0.0, scale=1.0, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    u = _uniform(g, dev, shape, -0.5, 0.5)
    lap = -torch.sign(u) * torch.log1p(-2 * torch.abs(u))
    return (loc + scale * lap).to(dt)


@register_op("random_cauchy")
def random_cauchy(rng, shape, loc=0.0, scale=1.0, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    c = torch.empty(shape, device=dev).cauchy_(generator=g)
    return (loc + scale * c).to(dt)


@register_op("random_gumbel")
def random_gumbel(rng, shape, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    u = _uniform(g, dev, shape, torch.finfo(torch.float32).tiny, 1.0)
    return (-torch.log(-torch.log(u))).to(dt)


@register_op("random_beta")
def random_beta(rng, shape, a=1.0, b=1.0, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    x = _gamma(a, g, dev, shape)
    y = _gamma(b, g, dev, shape)
    return (x / (x + y)).to(dt)


@register_op("random_categorical")
def random_categorical(rng, logits, num_samples):
    """``[batch, num_samples]`` int32 class draws from ``[batch, C]``
    logits."""
    g = generator_on(rng, logits.device)
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(p, int(num_samples), replacement=True,
                             generator=g).to(torch.int32)


@register_op("random_shuffle")
def random_shuffle(rng, x, axis=0):
    """``x`` permuted along ``axis`` (whole slices move together)."""
    g = generator_on(rng, x.device)
    perm = torch.randperm(x.shape[axis], generator=g, device=x.device)
    return torch.index_select(x, axis, perm)


@register_op("random_rademacher")
def random_rademacher(rng, shape, dtype="float32"):
    g, dev, dt, shape = _draw(rng, shape, dtype)
    b = torch.rand(shape, generator=g, device=dev) < 0.5
    return (2 * b.to(torch.float32) - 1).to(dt)
