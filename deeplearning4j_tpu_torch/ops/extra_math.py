"""Long-tail math and special functions: counterpart of
``deeplearning4j_tpu/ops/extra_math.py`` (:19-280), every name it
registers, with its parameters.

Where torch has no function of JAX's, the port computes JAX's definition:
``cbrt`` from the magnitude, ``polygamma`` from ``zeta`` and ``lgamma``
(JAX's own formula), ``betainc`` by the continued fraction in float64,
``nanmax``/``nanmin`` by masking, ``median`` as the 0.5 quantile (numpy's
mean of the two middle values, where ``torch.median`` takes the lower).
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


def _inexact(*xs):
    """Operands as tensors of one floating type (JAX's
    ``promote_args_inexact``): integers become float32."""
    ts = [jr.as_tensor(x) if not isinstance(x, torch.Tensor) else x
          for x in xs]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    if not dt.is_floating_point:
        dt = torch.float32
    dev = ts[0].device
    return [t.to(dev, dt) for t in ts]


# ----------------------------------------------------------- unary math
@register_op("asinh")
def asinh(x):
    return torch.asinh(x)


@register_op("acosh")
def acosh(x):
    return torch.acosh(x)


@register_op("atanh")
def atanh(x):
    return torch.atanh(x)


@register_op("expm1")
def expm1(x):
    return torch.expm1(x)


@register_op("rint")
def rint(x):
    """Round half to even."""
    return torch.round(x)


@register_op("trunc")
def trunc(x):
    return torch.trunc(x)


@register_op("cbrt")
def cbrt(x):
    (x,) = _inexact(x)
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


@register_op("erfinv")
def erfinv(x):
    (x,) = _inexact(x)
    return torch.erfinv(x)


@register_op("lgamma")
def lgamma(x):
    (x,) = _inexact(x)
    return torch.lgamma(x)


@register_op("digamma")
def digamma(x):
    (x,) = _inexact(x)
    return torch.digamma(x)


@register_op("polygamma")
def polygamma(n, x):
    """``jax.scipy.special.polygamma``: digamma where ``n`` is 0, else
    ``(-1)^(n+1) n! zeta(n + 1, x)``; a float ``n`` is taken as its
    integer part first (TF passes floats of integral value)."""
    n = jr.as_tensor(n) if not isinstance(n, torch.Tensor) else n
    if n.dtype.is_floating_point:
        n = n.to(torch.int32)
    n, x = _inexact(n, x)
    n1 = n + 1
    sign = 1 - torch.remainder(n1, 2) * 2
    return torch.where(n == 0, torch.digamma(x),
                       sign * torch.exp(torch.lgamma(n1))
                       * torch.special.zeta(n1, x))


@register_op("igamma")
def igamma(a, x):
    """Regularized lower incomplete gamma."""
    a, x = _inexact(a, x)
    return torch.special.gammainc(a, x)


@register_op("igammac")
def igammac(a, x):
    """Regularized upper incomplete gamma."""
    a, x = _inexact(a, x)
    return torch.special.gammaincc(a, x)


_BETAINC_TERMS = 300


def _betacf(a, b, x):
    """The continued fraction of the incomplete beta function (modified
    Lentz), a fixed number of terms, elementwise in float64."""
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    d = 1.0 / d
    h = d
    for m in range(1, _BETAINC_TERMS + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
    return h


@register_op("betainc")
def betainc(a, b, x):
    """Regularized incomplete beta ``I_x(a, b)``: the continued fraction
    on whichever side of the mean converges (``x < (a + 1) / (a + b +
    2)``, else ``1 - I_{1-x}(b, a)``), in float64, cast back."""
    a, b, x = _inexact(a, b, x)
    a, b, x = torch.broadcast_tensors(a, b, x)
    dt = x.dtype
    a64, b64, x64 = a.double(), b.double(), x.double()
    xin = x64.clamp(0.0, 1.0)
    lbt = (torch.lgamma(a64 + b64) - torch.lgamma(a64) - torch.lgamma(b64)
           + a64 * torch.log(xin) + b64 * torch.log1p(-xin))
    front = torch.exp(lbt)
    flip = xin >= (a64 + 1.0) / (a64 + b64 + 2.0)
    aa = torch.where(flip, b64, a64)
    bb = torch.where(flip, a64, b64)
    xx = torch.where(flip, 1.0 - xin, xin)
    cf = _betacf(aa, bb, xx)
    low = front * cf / aa
    val = torch.where(flip, 1.0 - low, low)
    val = torch.where(x64 <= 0.0, torch.zeros_like(val), val)
    val = torch.where(x64 >= 1.0, torch.ones_like(val), val)
    bad = (a64 <= 0) | (b64 <= 0) | (x64 < 0) | (x64 > 1) \
        | torch.isnan(a64) | torch.isnan(b64) | torch.isnan(x64)
    val = torch.where(bad, torch.full_like(val, math.nan), val)
    return val.to(dt)


@register_op("sinc")
def sinc(x):
    (x,) = _inexact(x)
    return torch.sinc(x)


@register_op("deg2rad")
def deg2rad(x):
    (x,) = _inexact(x)
    return torch.deg2rad(x)


@register_op("rad2deg")
def rad2deg(x):
    (x,) = _inexact(x)
    return torch.rad2deg(x)


@register_op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@register_op("log_cosh")
def log_cosh(x):
    """``|x| + log1p(exp(-2|x|)) - log 2``, stable for large ``|x|``."""
    ax = x.abs()
    return ax + torch.log1p(torch.exp(-2.0 * ax)) - math.log(2.0)


@register_op("softmin")
def softmin(x, axis=-1):
    return torch.softmax(-x, dim=axis)


# --------------------------------------------------------- binary math
@register_op("logaddexp")
def logaddexp(a, b):
    a, b = _inexact(a, b)
    return torch.logaddexp(a, b)


@register_op("logaddexp2")
def logaddexp2(a, b):
    a, b = _inexact(a, b)
    return torch.logaddexp2(a, b)


@register_op("hypot")
def hypot(a, b):
    a, b = _inexact(a, b)
    return torch.hypot(a, b)


@register_op("heaviside")
def heaviside(x, h0):
    """0 below zero, 1 above, ``h0`` at zero."""
    x, h0 = _inexact(x, h0)
    return torch.where(x < 0, torch.zeros_like(x),
                       torch.where(x > 0, torch.ones_like(x), h0))


@register_op("copysign")
def copysign(a, b):
    a, b = _inexact(a, b)
    return torch.copysign(a, b)


@register_op("fmod")
def fmod(a, b):
    """C's remainder: the sign of the dividend (TF's Mod on floats)."""
    if not isinstance(a, torch.Tensor):
        a = jr.as_tensor(a, b.device)
    return torch.fmod(a, b)


@register_op("xdivy")
def xdivy(x, y):
    """0 where ``x`` is 0, else ``x / y``."""
    zero = x == 0
    return torch.where(zero, torch.zeros_like(x),
                       x / torch.where(zero, torch.ones_like(y), y))


@register_op("xlogy")
def xlogy(x, y):
    x, y = _inexact(x, y)
    return torch.where(x != 0, x * torch.log(y), torch.zeros_like(x))


@register_op("xlog1py")
def xlog1py(x, y):
    x, y = _inexact(x, y)
    return torch.where(x != 0, x * torch.log1p(y), torch.zeros_like(x))


@register_op("lerp")
def lerp(a, b, weight):
    """``a + weight * (b - a)``."""
    return a + weight * (b - a)


@register_op("addcmul")
def addcmul(x, t1, t2, value=1.0):
    return x + value * t1 * t2


@register_op("addcdiv")
def addcdiv(x, t1, t2, value=1.0):
    return x + value * t1 / t2


@register_op("polyval")
def polyval(coeffs, x):
    """Horner's rule; ``coeffs[0]`` is the highest power."""
    out = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        out = out * x + c
    return out


@register_op("absolute_difference")
def absolute_difference(a, b):
    return (a - b).abs()


# -------------------------------------------------- nan-skipping reduces
@register_op("nanmean")
def nanmean(x, dimensions=None, keep_dims=False):
    return jr.reduce_over(torch.nanmean, x, dimensions, keep_dims)


@register_op("nansum")
def nansum(x, dimensions=None, keep_dims=False):
    return jr.reduce_over(torch.nansum, x, dimensions, keep_dims)


def _nan_extreme(x, dimensions, keep_dims, fn, skip):
    """``fn`` over the non-NaN values; NaN where a slice is all NaN."""
    nan = torch.isnan(x)
    filled = torch.where(nan, torch.full_like(x, skip), x)
    out = jr.reduce_over(fn, filled, dimensions, keep_dims)
    all_nan = jr.reduce_over(torch.all, nan, dimensions, keep_dims) \
        if nan.dim() else nan
    return torch.where(all_nan.to(torch.bool),
                       torch.full_like(out, math.nan), out)


@register_op("nanmax")
def nanmax(x, dimensions=None, keep_dims=False):
    return _nan_extreme(x, dimensions, keep_dims, torch.amax, -math.inf)


@register_op("nanmin")
def nanmin(x, dimensions=None, keep_dims=False):
    return _nan_extreme(x, dimensions, keep_dims, torch.amin, math.inf)


# ----------------------------------------------------------- percentile
def _quantile(x, q, dimensions, keep_dims, method):
    """``jnp.quantile``: the axes moved to the end and flattened (torch
    takes one axis), ``q``'s shape in front of the result."""
    (x,) = _inexact(x)
    qt = torch.as_tensor(q, dtype=x.dtype).to(x.device) \
        if not isinstance(q, torch.Tensor) else q.to(x.device, x.dtype)
    ax = jr.axes(dimensions, x.dim())
    ax = tuple(sorted(a % x.dim() for a in ax))
    rest = [d for d in range(x.dim()) if d not in ax]
    flat = x.permute(*rest, *ax).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = torch.quantile(flat, qt, dim=-1, interpolation=method)
    if keep_dims:
        shape = list(out.shape[:qt.dim()]) + [
            1 if d in ax else x.shape[d] for d in range(x.dim())]
        out = out.reshape(shape)
    return out


@register_op("percentile")
def percentile(x, q, dimensions=None, keep_dims=False,
               interpolation="linear"):
    """``jnp.percentile`` (linear, lower, higher, nearest, midpoint)."""
    q = q / 100.0 if isinstance(q, torch.Tensor) else \
        torch.as_tensor(q, dtype=torch.float64) / 100.0
    return _quantile(x, q, dimensions, keep_dims, interpolation)


@register_op("median")
def median(x, dimensions=None, keep_dims=False):
    return _quantile(x, 0.5, dimensions, keep_dims, "linear")


@register_op("quantile")
def quantile(x, q, dimensions=None, keep_dims=False):
    return _quantile(x, q, dimensions, keep_dims, "linear")


# --------------------------------------------------------- cumulative
@register_op("cummax")
def cummax(x, axis=0):
    return torch.cummax(x, dim=axis).values


@register_op("cummin")
def cummin(x, axis=0):
    return torch.cummin(x, dim=axis).values


@register_op("diff")
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


@register_op("trapz")
def trapz(y, dx=1.0, axis=-1):
    return torch.trapezoid(y, dx=dx, dim=axis)


@register_op("einsum")
def einsum(*operands, equation):
    """General tensor contraction (TF's and ONNX's Einsum)."""
    return torch.einsum(equation, *operands)
