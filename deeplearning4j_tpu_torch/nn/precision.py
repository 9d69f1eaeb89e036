"""Serving-side quantization helpers: int8 weight-only decode weights and
the fp8 KV-cache format.

Counterpart of the serving half of ``deeplearning4j_tpu/nn/precision.py``
(its int8 and fp8 sections), copied rather than imported: the port
never imports the JAX package. The mixed-precision training policy of
that module is not ported here.

int8 (``DecodeEngine(quantization="int8")``): decode re-reads every
weight for one token per slot, so the decode step keeps its matmul
weights as int8 with one f32 scale per output channel and dequantizes
inside the matmul, ``(x @ q) * scale``. Symmetric scales bound each
channel's error by half an int8 step of that channel's max.

fp8 KV (``kv_dtype="fp8_e4m3"``): pages store ``torch.float8_e4m3fn``
with per-page-per-head f32 scales beside them, half the bytes of a
bf16 page. e4m3fn's largest finite value is 448 and an out-of-range
cast gives NaN (there is no inf), so :func:`quantize_fp8` clips to ±448
before the cast; the scale is floored so an all-zero page divides
cleanly. ``torch``'s f32 -> ``float8_e4m3fn`` cast rounds to nearest
even, as JAX's does, so quantized pages are bit-equal to the JAX
package's on equal inputs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


# ------------------------------------------------------ int8 weights
def quantize_int8(w: torch.Tensor, axis: int = -1) -> Dict[str, Any]:
    """Symmetric per-channel int8 quantization of one weight tensor.

    ``axis`` is the kept (channel) axis: ``scale`` has shape
    ``(w.shape[axis],)`` and ``w ≈ q * scale`` broadcast along ``axis``.
    All-zero channels get scale 1 (q is then 0)."""
    axis = axis % w.dim()
    reduce_dims = tuple(i for i in range(w.dim()) if i != axis)
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=reduce_dims) if reduce_dims else wf.abs()
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    bshape = [1] * w.dim()
    bshape[axis] = -1
    q = torch.clamp(torch.round(wf / scale.reshape(bshape)), -127, 127) \
        .to(torch.int8)
    return {"q": q, "s": scale, "axis": axis}


def is_int8(leaf) -> bool:
    """True for a :func:`quantize_int8` result dict."""
    return (isinstance(leaf, dict) and "q" in leaf and "s" in leaf
            and getattr(leaf["q"], "dtype", None) == torch.int8)


def dequantize_int8(wq: Dict[str, Any],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The full-precision approximation ``q * scale``."""
    q, s = wq["q"], wq["s"]
    axis = int(wq.get("axis", -1)) % q.dim()
    bshape = [1] * q.dim()
    bshape[axis] = -1
    return q.to(dtype) * s.reshape(bshape).to(dtype)


def int8_matmul(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """``(x @ q) * scale`` for a weight quantized along its OUTPUT axis
    (``axis=1`` of an ``[in, out]`` matrix); a plain tensor passes
    through as ``x @ w``, so call sites need not know which they hold."""
    if is_int8(w):
        return (x @ w["q"].to(dtype)) * w["s"].to(dtype)
    return x @ w.to(dtype)


# ---------------------------------------------------------- fp8 KV
FP8_E4M3_MAX = 448.0
#: scale floor: keeps ``scale * 448 >= 1`` for pages whose absmax is
#: below 1, so tiny pages do not round-trip through denormal scales
FP8_SCALE_FLOOR = 1.0 / 448.0

_KV_DTYPE_ALIASES = {
    "fp8_e4m3": "fp8_e4m3", "fp8": "fp8_e4m3", "e4m3": "fp8_e4m3",
    "float8_e4m3fn": "fp8_e4m3", "float8_e4m3": "fp8_e4m3",
}


def resolve_kv_dtype(kv_dtype) -> Optional[str]:
    """Canonical KV-cache format: None / "" / "bf16" / "native" keep the
    compute dtype (None); "fp8", "e4m3", "float8_e4m3fn" and friends
    resolve to ``"fp8_e4m3"``. Raises on any other name."""
    if kv_dtype is None or kv_dtype == "":
        return None
    key = str(kv_dtype).strip().lower()
    if key in ("none", "bf16", "bfloat16", "native"):
        return None
    canon = _KV_DTYPE_ALIASES.get(key)
    if canon is None:
        raise ValueError(
            f"Unknown kv_dtype {kv_dtype!r} (expected None or one of "
            f"{sorted(set(_KV_DTYPE_ALIASES))})")
    return canon


def fp8_kv_dtype() -> torch.dtype:
    """The storage dtype behind ``kv_dtype="fp8_e4m3"``."""
    return torch.float8_e4m3fn


def fp8_scale(amax) -> torch.Tensor:
    """Per-page-per-head scale from an absmax: ``max(amax / 448,
    floor)`` in f32, shape-preserving."""
    a = torch.as_tensor(amax).to(torch.float32)
    return torch.clamp(a / FP8_E4M3_MAX, min=FP8_SCALE_FLOOR)


def quantize_fp8(x: torch.Tensor, scale) -> torch.Tensor:
    """``clip(x / scale, ±448)`` cast to ``float8_e4m3fn``; ``scale``
    broadcasts against ``x``."""
    xf = x.to(torch.float32) / torch.as_tensor(scale).to(torch.float32)
    return torch.clamp(xf, -FP8_E4M3_MAX, FP8_E4M3_MAX).to(fp8_kv_dtype())


def dequantize_fp8(q: torch.Tensor, scale,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype``."""
    return (q.to(torch.float32)
            * torch.as_tensor(scale).to(torch.float32)).to(dtype)


__all__ = ["quantize_int8", "is_int8", "dequantize_int8", "int8_matmul",
           "FP8_E4M3_MAX", "FP8_SCALE_FLOOR", "resolve_kv_dtype",
           "fp8_kv_dtype", "fp8_scale", "quantize_fp8", "dequantize_fp8"]
