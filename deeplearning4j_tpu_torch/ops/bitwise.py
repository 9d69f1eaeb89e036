"""Bitwise, boolean and comparison ops: counterpart of
``deeplearning4j_tpu/ops/bitwise.py`` (:16-152), every name it registers,
with its parameters.

JAX's rules where torch's differ: a shift by the type's width or more
gives 0 (``lax.shift_left``; an arithmetic right shift of a negative
value gives -1), a rotation works on the unsigned bits, and
``bitcast_convert_type`` between widths adds or drops a last axis.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


def _pair(x, y):
    """Both operands as tensors on one device; a number beside a tensor
    becomes a 0-d tensor, which torch promotes as JAX promotes a weak
    type (an int keeps the tensor's integer type, a float makes an
    integer tensor float32)."""
    if isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        return x, torch.as_tensor(y, device=x.device)
    if isinstance(y, torch.Tensor) and not isinstance(x, torch.Tensor):
        return torch.as_tensor(x, device=y.device), y
    return jr.as_tensor(x), jr.as_tensor(y)


@register_op("bitwise_and")
def bitwise_and(x, y):
    return torch.bitwise_and(*_pair(x, y))


@register_op("bitwise_or")
def bitwise_or(x, y):
    return torch.bitwise_or(*_pair(x, y))


@register_op("bitwise_xor")
def bitwise_xor(x, y):
    return torch.bitwise_xor(*_pair(x, y))


@register_op("bitwise_not")
def bitwise_not(x):
    return torch.bitwise_not(x)


def _bits(t: torch.Tensor) -> int:
    return 1 if t.dtype == torch.bool else t.element_size() * 8


@register_op("shift_left")
def shift_left(x, n):
    x, n = _pair(x, n)
    bits = _bits(x)
    big = (n < 0) | (n >= bits)
    out = torch.bitwise_left_shift(x, n.clamp(0, bits - 1))
    return torch.where(big, torch.zeros_like(out), out)


@register_op("shift_right")
def shift_right(x, n):
    """An arithmetic shift for signed types, a logical one for unsigned,
    as ``jnp.right_shift``; past the width the sign fills the result."""
    x, n = _pair(x, n)
    bits = _bits(x)
    big = (n < 0) | (n >= bits)
    out = torch.bitwise_right_shift(x, n.clamp(0, bits - 1))
    fill = torch.where(x < 0, torch.full_like(x, -1), torch.zeros_like(x)) \
        if x.dtype.is_signed else torch.zeros_like(x)
    return torch.where(big, fill, out)


def _rotate(x, n, left):
    """Rotation of the unsigned bits by ``n`` (a Python int), computed in
    int64 for widths below 64, with masks at 64."""
    x = jr.as_tensor(x)
    bits = x.element_size() * 8
    n = int(n) % bits
    if n == 0:
        return x
    if not left:
        n = bits - n
    if bits < 64:
        mask = (1 << bits) - 1
        u = x.to(torch.int64) & mask
        r = ((u << n) | (u >> (bits - n))) & mask
        if x.dtype.is_signed:
            r = torch.where(r >= (1 << (bits - 1)), r - (1 << bits), r)
        return r.to(x.dtype)
    hi = (x >> (bits - n)) & ((1 << n) - 1)        # logical shift
    return (x << n) | hi


@register_op("cyclic_shift_left")
def cyclic_shift_left(x, n):
    return _rotate(x, n, left=True)


@register_op("cyclic_shift_right")
def cyclic_shift_right(x, n):
    return _rotate(x, n, left=False)


@register_op("toggle_bits")
def toggle_bits(x):
    return torch.bitwise_not(x)


def _popcount(t: torch.Tensor) -> torch.Tensor:
    """Set bits of each element's unsigned pattern, int32 (SWAR in int64;
    64-bit values in two halves)."""
    bits = t.element_size() * 8
    if bits == 64:
        lo = t & 0xFFFFFFFF
        hi = (t >> 32) & 0xFFFFFFFF
        return _popcount32(lo) + _popcount32(hi)
    return _popcount32(t.to(torch.int64) & ((1 << bits) - 1))


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


@register_op("bits_hamming_distance")
def bits_hamming_distance(x, y):
    """The set bits of ``x ^ y``, summed: int32 for inputs of 32 bits or
    fewer (JAX's population count keeps the type; its sum promotes)."""
    x, y = _pair(x, y)
    out = _popcount(torch.bitwise_xor(x, y)).sum()
    return out.to(torch.int64 if x.element_size() == 8 else torch.int32) \
        if x.dtype.is_signed else out


@register_op("bitcast")
def bitcast(x, dtype):
    """``lax.bitcast_convert_type``: the same bits as ``dtype``; to a
    narrower type a last axis of the width ratio is added, to a wider one
    the last axis (of that ratio) is dropped."""
    dt = jr.torch_dtype(dtype) if not isinstance(dtype, torch.dtype) \
        else dtype
    src, dst = x.element_size(), torch.empty((), dtype=dt).element_size()
    if src == dst:
        return x.view(dt)
    if dst < src:
        return x.contiguous().view(dt).reshape(
            tuple(x.shape) + (src // dst,))
    if x.shape[-1] != dst // src:
        raise ValueError(
            f"bitcast to a wider type needs a last axis of {dst // src}")
    return x.contiguous().view(dt).reshape(tuple(x.shape[:-1]))


# -- comparisons -------------------------------------------------------
@register_op("equals")
def equals(x, y):
    return torch.eq(*_pair(x, y))


@register_op("not_equals")
def not_equals(x, y):
    return torch.ne(*_pair(x, y))


@register_op("greater")
def greater(x, y):
    return torch.gt(*_pair(x, y))


@register_op("greater_equal")
def greater_equal(x, y):
    return torch.ge(*_pair(x, y))


@register_op("less")
def less(x, y):
    return torch.lt(*_pair(x, y))


@register_op("less_equal")
def less_equal(x, y):
    return torch.le(*_pair(x, y))


@register_op("is_close")
def is_close(x, y, rtol=1e-5, atol=1e-8):
    return torch.isclose(*_pair(x, y), rtol=rtol, atol=atol)


@register_op("floormod")
def floormod(x, y):
    """``jnp.mod``: the remainder takes the divisor's sign."""
    return torch.remainder(*_pair(x, y))


@register_op("truncatediv")
def truncatediv(x, y):
    x, y = _pair(x, y)
    rt = torch.result_type(x, y)
    if not rt.is_floating_point:
        # integers stay integers: a float round trip loses precision past
        # the f32 mantissa
        q = torch.div(x.abs(), y.abs(), rounding_mode="floor")
        return (torch.sign(x) * torch.sign(y)).to(q.dtype) * q
    return torch.trunc(x / y).to(rt)


@register_op("divide_no_nan")
def divide_no_nan(x, y):
    """``x / y``, 0 where ``y`` is 0; the division uses a safe
    denominator first, so the gradient of the masked branch is no NaN."""
    x, y = _pair(x, y)
    zero = y == 0
    safe = torch.where(zero, torch.ones((), dtype=y.dtype, device=y.device),
                       y)
    rt = torch.result_type(x, y)
    return torch.where(zero, torch.zeros((), dtype=rt, device=y.device),
                       x / safe)
