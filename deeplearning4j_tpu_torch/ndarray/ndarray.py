"""NDArray, the eager array type: counterpart of
``deeplearning4j_tpu/ndarray/ndarray.py``, over a ``torch.Tensor``.

Ported: every method but the JAX array hooks (``jax``,
``__jax_array__``; ``torch`` is the port's escape hatch). The mutating
methods (the ``...i`` arithmetic, ``assign``, ``put``, ``putScalar``,
``putRow``, ``putColumn``, ``__setitem__``) rebind the wrapped tensor to
a new value, as the JAX side rebinds its immutable array: a ``put``
writes into a copy, so a view taken earlier with ``get`` (a torch view
of the old tensor) never changes, as a JAX array taken earlier never
does; and a dtype promotion behaves alike in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.dtypes import DataType
from deeplearning4j_tpu_torch.params import numpy_to_tensor_narrowed


def _unwrap(x):
    return x._buf if isinstance(x, NDArray) else x


def jax_int_result(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A reduction's result in the type JAX gives it without x64: torch
    sums and multiplies integers and booleans into int64, JAX into int32.
    The cast back keeps the low 32 bits, so an int32 sum that overflows
    wraps as JAX's does."""
    if out.dtype == torch.int64 and x.dtype != torch.int64:
        return out.to(torch.int32)
    return out


def jax_float_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 when it is an integer or boolean tensor: JAX takes
    the mean and the standard deviation of integers in float32, torch
    refuses them."""
    return x if x.is_floating_point() else x.to(torch.float32)


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
        this array's device (64-bit numbers made 32-bit, as JAX makes
        them), Python numbers as they are."""
        other = _unwrap(other)
        if isinstance(other, np.ndarray):
            return numpy_to_tensor_narrowed(other).to(self._buf.device)
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

    # ------------------------------------------- mutation by rebinding
    def _index(self, idx):
        """An index for the wrapped tensor: NDArrays and numpy arrays as
        tensors, tuples taken piece by piece."""
        if isinstance(idx, tuple):
            return tuple(self._index(i) for i in idx)
        idx = _unwrap(idx)
        if isinstance(idx, np.ndarray):
            return torch.from_numpy(idx)
        if isinstance(idx, list):
            return torch.tensor(idx)
        return idx

    def _set(self, idx, value) -> "NDArray":
        """``buf.at[idx].set(value)``: a copy written and rebound."""
        new = self._buf.clone()
        v = self._o(value)
        new[self._index(idx)] = v.to(new.dtype) if isinstance(
            v, torch.Tensor) else v
        self._buf = new
        return self

    def assign(self, other) -> "NDArray":
        v = self._o(other)
        v = torch.as_tensor(v, dtype=self._buf.dtype, device=self._buf.device)
        self._buf = torch.broadcast_to(v.to(self._buf.dtype),
                                       self._buf.shape).clone()
        return self

    def putScalar(self, idx, value) -> "NDArray":
        if isinstance(idx, int):
            idx = np.unravel_index(idx, self._buf.shape)
        return self._set(tuple(int(i) for i in idx), value)

    def put(self, *args) -> "NDArray":
        """``put(idx, value)`` with ``idx`` a raw index or a list/tuple of
        INDArrayIndex (reference: INDArray#put(INDArrayIndex[], ...))."""
        from deeplearning4j_tpu_torch.ndarray.indexing import (
            INDArrayIndex, resolve_indices)

        if len(args) < 2:
            raise TypeError(
                "put(idx..., value) needs at least an index and a value")
        *idxs, value = args
        if len(idxs) == 1 and not isinstance(idxs[0], INDArrayIndex):
            idx = idxs[0]
            if isinstance(idx, (list, tuple)) and idx and \
                    isinstance(idx[0], INDArrayIndex):
                idx = resolve_indices(idx)
        else:
            idx = resolve_indices(idxs)
        return self._set(idx, value)

    # -- indexing (reference: INDArray#get with NDArrayIndex) ----------
    def get(self, *idxs) -> "NDArray":
        from deeplearning4j_tpu_torch.ndarray.indexing import resolve_indices

        return NDArray(self._buf[self._index(resolve_indices(idxs))])

    def getRow(self, i: int) -> "NDArray":
        return NDArray(self._buf[i])

    def getRows(self, *rows: int) -> "NDArray":
        return NDArray(self._buf[torch.tensor(rows)])

    def getColumn(self, i: int) -> "NDArray":
        return NDArray(self._buf[:, i])

    def getColumns(self, *cols: int) -> "NDArray":
        return NDArray(self._buf[:, torch.tensor(cols)])

    def putRow(self, i: int, row) -> "NDArray":
        return self._set(i, row)

    def putColumn(self, i: int, col) -> "NDArray":
        return self._set((slice(None), i), col)

    def slice(self, i: int, dim: int = 0) -> "NDArray":
        """The ``i``-th sub-array along ``dim`` (reference:
        INDArray#slice)."""
        return NDArray(torch.select(self._buf, dim, i))

    def tensorAlongDimension(self, index: int, *dims: int) -> "NDArray":
        """TAD (reference: INDArray#tensorAlongDimension): the
        ``index``-th sub-tensor spanning ``dims``, the other axes taken in
        C order."""
        nd = self._buf.dim()
        dset = {d % nd for d in dims}
        other = [d for d in range(nd) if d not in dset]
        moved = torch.movedim(self._buf, other, list(range(len(other))))
        flat = moved.reshape((-1,) + tuple(moved.shape[len(other):]))
        return NDArray(flat[index])

    def tensorsAlongDimension(self, *dims: int) -> int:
        nd = self._buf.dim()
        dset = {d % nd for d in dims}
        n = 1
        for d in range(nd):
            if d not in dset:
                n *= self._buf.shape[d]
        return n

    def getDouble(self, *idx) -> float:
        if len(idx) == 1 and isinstance(idx[0], int) and self._buf.dim() != 1:
            idx = np.unravel_index(idx[0], self._buf.shape)
        return float(self._buf[tuple(int(i) for i in idx)])

    def getInt(self, *idx) -> int:
        return int(self.getDouble(*idx))

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
    def _reduce(self, fn, dims, keepdims=False, x=None):
        """``fn`` over ``dims`` (none given: every axis) of ``x`` (default:
        this array), with an integer result in JAX's type."""
        x = self._buf if x is None else x
        if not dims:
            out = fn(x)
            if keepdims:
                out = out.reshape((1,) * self.rank())
        else:
            out = fn(x, dim=tuple(dims), keepdim=keepdims)
        return NDArray(jax_int_result(out, x))

    def sum(self, *dims, keepdims=False):
        r = self._reduce(torch.sum, dims, keepdims)
        return r if dims or keepdims else r.item()

    def mean(self, *dims, keepdims=False):
        r = self._reduce(torch.mean, dims, keepdims,
                         jax_float_input(self._buf))
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
        out = torch.std(jax_float_input(self._buf),
                        dim=(dims if dims else None), correction=ddof)
        return NDArray(out) if dims else float(out)

    def var(self, *dims, ddof: int = 1):
        out = torch.var(jax_float_input(self._buf),
                        dim=(dims if dims else None), correction=ddof)
        return NDArray(out) if dims else float(out)

    # scalar reductions (reference: INDArray#sumNumber etc.)
    def sumNumber(self) -> float:
        return float(torch.sum(self._buf))

    def meanNumber(self) -> float:
        return float(torch.mean(jax_float_input(self._buf)))

    def maxNumber(self) -> float:
        return float(torch.max(self._buf))

    def minNumber(self) -> float:
        return float(torch.min(self._buf))

    def prodNumber(self) -> float:
        return float(torch.prod(self._buf))

    def stdNumber(self, bias_corrected: bool = True) -> float:
        return float(torch.std(jax_float_input(self._buf),
                               correction=1 if bias_corrected else 0))

    def varNumber(self, bias_corrected: bool = True) -> float:
        return float(torch.var(jax_float_input(self._buf),
                               correction=1 if bias_corrected else 0))

    def argMax(self, *dims):
        if not dims:
            return int(torch.argmax(self._buf))
        return NDArray(torch.argmax(self._buf, dim=dims[0]).to(torch.int32))

    def argMin(self, *dims):
        if not dims:
            return int(torch.argmin(self._buf))
        return NDArray(torch.argmin(self._buf, dim=dims[0]).to(torch.int32))

    def cumsum(self, axis=None) -> "NDArray":
        x = self._buf.reshape(-1) if axis is None else self._buf
        out = torch.cumsum(x, dim=0 if axis is None else axis)
        return NDArray(jax_int_result(out, x))

    def norm1(self, *dims):
        r = self._reduce(torch.sum, dims, x=torch.abs(self._buf))
        return r if dims else r.item()

    def norm2(self, *dims):
        r = self._reduce(torch.sum, dims, x=self._buf * self._buf)
        r = NDArray(torch.sqrt(jax_float_input(r._buf)))
        return r if dims else r.item()

    def normMax(self, *dims):
        r = self._reduce(torch.amax, dims, x=torch.abs(self._buf))
        return r if dims else r.item()

    def item(self):
        v = self._buf
        if v.dtype == torch.bool:
            return bool(v)
        if not v.is_floating_point():
            return int(v)
        return float(v)

    # ------------------------------------------------------------ comparisons
    def gt(self, other) -> "NDArray":
        return NDArray(self._buf > self._o(other))

    def gte(self, other) -> "NDArray":
        return NDArray(self._buf >= self._o(other))

    def lt(self, other) -> "NDArray":
        return NDArray(self._buf < self._o(other))

    def lte(self, other) -> "NDArray":
        return NDArray(self._buf <= self._o(other))

    def eq(self, other) -> "NDArray":
        return NDArray(self._buf == self._o(other))

    def neq(self, other) -> "NDArray":
        return NDArray(self._buf != self._o(other))

    def equalsWithEps(self, other, eps: float = 1e-5) -> bool:
        o = self._o(other)
        if not isinstance(o, torch.Tensor):
            o = torch.as_tensor(o, device=self._buf.device)
        if tuple(o.shape) != tuple(self._buf.shape):
            return False
        return bool(torch.all(torch.abs(self._buf - o) <= eps))

    def equals(self, other) -> bool:
        return self.equalsWithEps(other, 1e-5)

    # -------------------------------------------------------- python protocol
    def __getitem__(self, idx) -> "NDArray":
        return NDArray(self._buf[self._index(idx)])

    def __setitem__(self, idx, value):
        self._set(idx, value)

    def __iter__(self):
        for i in range(self._buf.shape[0]):
            yield NDArray(self._buf[i])

    def __bool__(self):
        return bool(self._buf)

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
