"""NDArray, the eager array type: counterpart of
``deeplearning4j_tpu/ndarray/ndarray.py``, over a ``torch.Tensor``.

Ported: the accessors and conversions (:44-140), arithmetic and ``mmul``
(:242-330) and the reductions (:333-350). The in-place (``...i``) methods
rebind the wrapped tensor to a new value, as the JAX side rebinds its
immutable array, so a dtype promotion behaves alike in both packages.
Indexing, ``put``, TADs, comparisons and the rest wait (ROADMAP A10).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.dtypes import DataType


def _unwrap(x):
    return x._buf if isinstance(x, NDArray) else x


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``; bfloat16, which numpy lacks, comes back as
    float32 (every bfloat16 value is exact in float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class NDArray:
    """Eager n-dimensional array over ``torch.Tensor`` (reference:
    INDArray / BaseNDArray). Mutating methods rebind ``_buf``."""

    __slots__ = ("_buf",)

    def __init__(self, buf):
        if isinstance(buf, NDArray):
            buf = buf._buf
        if not isinstance(buf, torch.Tensor):
            buf = torch.as_tensor(np.asarray(buf))
        self._buf = buf

    def _o(self, other):
        """A binary operand: NDArrays unwrapped, numpy arrays as tensors on
        this array's device, Python numbers as they are."""
        other = _unwrap(other)
        if isinstance(other, np.ndarray):
            return torch.as_tensor(other, device=self._buf.device)
        return other

    # ------------------------------------------------------------ structure
    @property
    def torch(self) -> torch.Tensor:
        """The wrapped tensor (the JAX side's ``.jax``)."""
        return self._buf

    @property
    def device(self) -> torch.device:
        return self._buf.device

    def shape(self) -> tuple[int, ...]:
        return tuple(self._buf.shape)

    def rank(self) -> int:
        return self._buf.dim()

    def length(self) -> int:
        return int(self._buf.numel())

    def size(self, dim: int) -> int:
        return self._buf.shape[dim]

    def dataType(self) -> DataType:
        return DataType.from_any(self._buf.dtype)

    def dtype(self):
        return self._buf.dtype

    def isVector(self) -> bool:
        return self._buf.dim() == 1 or (
            self._buf.dim() == 2 and 1 in self._buf.shape)

    def isMatrix(self) -> bool:
        return self._buf.dim() == 2

    def isScalar(self) -> bool:
        return self._buf.dim() == 0 or self._buf.numel() == 1

    def isEmpty(self) -> bool:
        return self._buf.numel() == 0

    def rows(self) -> int:
        return self._buf.shape[0]

    def columns(self) -> int:
        return self._buf.shape[1]

    # -------------------------------------------------- conversion / copies
    def dup(self) -> "NDArray":
        return NDArray(self._buf.clone())

    def castTo(self, dtype) -> "NDArray":
        return NDArray(self._buf.to(DataType.from_any(dtype).torch))

    def toNumpy(self) -> np.ndarray:
        return to_numpy(self._buf)

    def ravel(self) -> "NDArray":
        return NDArray(self._buf.reshape(-1))

    def flatten(self) -> "NDArray":
        return NDArray(self._buf.reshape(-1))

    def reshape(self, *shape) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray(self._buf.reshape(shape))

    def transpose(self, *axes) -> "NDArray":
        if not axes:
            return NDArray(self._buf.permute(*reversed(range(self.rank()))))
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return NDArray(self._buf.permute(*axes))

    def permute(self, *axes) -> "NDArray":
        return self.transpose(*axes)

    def broadcast(self, *shape) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray(torch.broadcast_to(self._buf, shape))

    def repeat(self, repeats, axis=None) -> "NDArray":
        if axis is None:
            return NDArray(torch.repeat_interleave(self._buf.reshape(-1),
                                                   repeats))
        return NDArray(torch.repeat_interleave(self._buf, repeats, dim=axis))

    def swapAxes(self, a: int, b: int) -> "NDArray":
        return NDArray(torch.swapaxes(self._buf, a, b))

    # ----------------------------------------------------------- arithmetic
    def add(self, other) -> "NDArray":
        return NDArray(self._buf + self._o(other))

    def addi(self, other) -> "NDArray":
        self._buf = self._buf + self._o(other)
        return self

    def sub(self, other) -> "NDArray":
        return NDArray(self._buf - self._o(other))

    def subi(self, other) -> "NDArray":
        self._buf = self._buf - self._o(other)
        return self

    def rsub(self, other) -> "NDArray":
        return NDArray(self._o(other) - self._buf)

    def rsubi(self, other) -> "NDArray":
        self._buf = self._o(other) - self._buf
        return self

    def mul(self, other) -> "NDArray":
        return NDArray(self._buf * self._o(other))

    def muli(self, other) -> "NDArray":
        self._buf = self._buf * self._o(other)
        return self

    def div(self, other) -> "NDArray":
        return NDArray(self._buf / self._o(other))

    def divi(self, other) -> "NDArray":
        self._buf = self._buf / self._o(other)
        return self

    def rdiv(self, other) -> "NDArray":
        return NDArray(self._o(other) / self._buf)

    def rdivi(self, other) -> "NDArray":
        self._buf = self._o(other) / self._buf
        return self

    def neg(self) -> "NDArray":
        return NDArray(-self._buf)

    def negi(self) -> "NDArray":
        self._buf = -self._buf
        return self

    def fmod(self, other) -> "NDArray":
        return NDArray(torch.fmod(self._buf, self._o(other)))

    def addRowVector(self, row) -> "NDArray":
        return NDArray(self._buf + self._o(row).reshape(1, -1))

    def addColumnVector(self, col) -> "NDArray":
        return NDArray(self._buf + self._o(col).reshape(-1, 1))

    def mulRowVector(self, row) -> "NDArray":
        return NDArray(self._buf * self._o(row).reshape(1, -1))

    def mulColumnVector(self, col) -> "NDArray":
        return NDArray(self._buf * self._o(col).reshape(-1, 1))

    def subRowVector(self, row) -> "NDArray":
        return NDArray(self._buf - self._o(row).reshape(1, -1))

    def divRowVector(self, row) -> "NDArray":
        return NDArray(self._buf / self._o(row).reshape(1, -1))

    # -------------------------------------------------------- linear algebra
    def mmul(self, other) -> "NDArray":
        return NDArray(self._buf @ self._o(other))

    def mmuli(self, other) -> "NDArray":
        self._buf = self._buf @ self._o(other)
        return self

    def tensorMmul(self, other, axes) -> "NDArray":
        return NDArray(torch.tensordot(self._buf, self._o(other), dims=axes))

    def dot(self, other) -> float:
        return float(torch.sum(self._buf.reshape(-1)
                               * self._o(other).reshape(-1)))

    # ------------------------------------------------------------ reductions
    def _reduce(self, fn, dims, keepdims=False):
        if not dims:
            out = fn(self._buf)
            if keepdims:
                out = out.reshape((1,) * self.rank())
            return NDArray(out)
        return NDArray(fn(self._buf, dim=tuple(dims), keepdim=keepdims))

    def sum(self, *dims, keepdims=False):
        r = self._reduce(torch.sum, dims, keepdims)
        return r if dims or keepdims else r.item()

    def mean(self, *dims, keepdims=False):
        r = self._reduce(torch.mean, dims, keepdims)
        return r if dims or keepdims else r.item()

    def max(self, *dims, keepdims=False):
        r = self._reduce(torch.amax, dims, keepdims)
        return r if dims or keepdims else r.item()

    def min(self, *dims, keepdims=False):
        r = self._reduce(torch.amin, dims, keepdims)
        return r if dims or keepdims else r.item()

    def prod(self, *dims, keepdims=False):
        def prod(t, dim=None, keepdim=False):
            if dim is None:
                return torch.prod(t)
            for d in sorted((d % t.dim() for d in dim), reverse=True):
                t = torch.prod(t, dim=d, keepdim=keepdim)
            return t
        r = self._reduce(prod, dims, keepdims)
        return r if dims or keepdims else r.item()

    def std(self, *dims, ddof: int = 1):
        out = torch.std(self._buf, dim=(dims if dims else None),
                        correction=ddof)
        return NDArray(out) if dims else float(out)

    def item(self):
        v = self._buf
        if v.dtype == torch.bool:
            return bool(v)
        if not v.is_floating_point():
            return int(v)
        return float(v)

    # -------------------------------------------------------- python protocol
    def __add__(self, other):
        return self.add(other)

    __radd__ = __add__

    def __sub__(self, other):
        return self.sub(other)

    def __rsub__(self, other):
        return self.rsub(other)

    def __mul__(self, other):
        return self.mul(other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.div(other)

    def __rtruediv__(self, other):
        return self.rdiv(other)

    def __matmul__(self, other):
        return self.mmul(other)

    def __neg__(self):
        return self.neg()

    def __pow__(self, p):
        return NDArray(self._buf ** self._o(p))

    def __len__(self):
        return self._buf.shape[0]

    def __float__(self):
        return float(self._buf)

    def __int__(self):
        return int(self._buf)

    def __array__(self, dtype=None, copy=None):
        a = self.toNumpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return (f"NDArray{self.shape()}:{str(self._buf.dtype)[6:]}\n"
                f"{self.toNumpy()!r}")
