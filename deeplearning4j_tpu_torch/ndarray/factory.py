"""Nd4j, the static array factory: counterpart of
``deeplearning4j_tpu/ndarray/factory.py``.

Every member is ported. Constructors, and the combining functions
given numpy arrays, take ``device=None``, which means the CUDA card
(:func:`~deeplearning4j_tpu_torch.device.resolve_device`); functions of
NDArrays or tensors work where those are. The random state is a seeded
``torch.Generator`` per device: the same laws as the JAX side's threefry
draws, not the same bits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray.dtypes import DEFAULT_FLOAT, DataType
from deeplearning4j_tpu_torch.ndarray.ndarray import (NDArray, _unwrap,
                                                      to_numpy)
from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.params import bfloat16_bits, numpy_to_tensor


def _dt(dtype) -> torch.dtype:
    if dtype is None:
        return DEFAULT_FLOAT.torch
    return DataType.from_any(dtype).torch


def _shape(shape) -> tuple:
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(shape[0])
    return tuple(shape)


def _tensor(a, device=None) -> torch.Tensor:
    """An NDArray or tensor as it is; anything else as a tensor on
    ``device`` (the card unless named), 64-bit numbers made 32-bit."""
    t = _unwrap(a)
    if isinstance(t, torch.Tensor):
        return t
    return jr.as_tensor(t, resolve_device(device))


def _tensors(arrays, device=None) -> list:
    return [_tensor(a, device) for a in arrays]


class _RandomState:
    """Seeded generators, one per device, made at first use (reference:
    Nd4j.getRandom(), a Philox generator in libnd4j)."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self._gens: Dict[torch.device, torch.Generator] = {}

    def setSeed(self, seed: int) -> None:
        self._seed = seed
        self._gens.clear()

    def getSeed(self) -> int:
        return self._seed

    def generator(self, device: torch.device) -> torch.Generator:
        g = self._gens.get(device)
        if g is None:
            g = self._gens[device] = torch.Generator(device=device)
            g.manual_seed(self._seed)
        return g


class Nd4j:
    """Static factory namespace (reference: Nd4j.java)."""

    _random = _RandomState(seed=0)

    # -- RNG ----------------------------------------------------------------
    @staticmethod
    def getRandom() -> _RandomState:
        return Nd4j._random

    @staticmethod
    def setSeed(seed: int) -> None:
        Nd4j._random.setSeed(seed)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def create(data=None, shape=None, dtype=None, device=None) -> NDArray:
        """From nested lists, numpy arrays or tensors (float64 becomes the
        default float, as on the JAX side), or zeros of ``shape``."""
        if data is None and shape is not None:
            return Nd4j.zeros(*shape, dtype=dtype, device=device)
        dev = resolve_device(device)
        data = _unwrap(data)
        if isinstance(data, torch.Tensor):
            t = data
        elif hasattr(data, "dtype"):
            t = numpy_to_tensor(np.asarray(data))
        else:
            t = torch.as_tensor(np.asarray(data), dtype=_dt(dtype))
        if dtype is not None:
            t = t.to(_dt(dtype))
        elif t.dtype == torch.float64:
            t = t.to(_dt(None))
        if shape is not None:
            t = t.reshape(tuple(shape))
        return NDArray(t.to(dev))

    @staticmethod
    def zeros(*shape, dtype=None, device=None) -> NDArray:
        return NDArray(torch.zeros(_shape(shape), dtype=_dt(dtype),
                                   device=resolve_device(device)))

    @staticmethod
    def ones(*shape, dtype=None, device=None) -> NDArray:
        return NDArray(torch.ones(_shape(shape), dtype=_dt(dtype),
                                  device=resolve_device(device)))

    # -- random constructors ------------------------------------------------
    @staticmethod
    def rand(*shape, dtype=None, device=None) -> NDArray:
        """Uniform on [0, 1)."""
        dev = resolve_device(device)
        return NDArray(torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                                  generator=Nd4j._random.generator(dev)))

    @staticmethod
    def randn(*shape, dtype=None, device=None) -> NDArray:
        """Standard normal."""
        dev = resolve_device(device)
        return NDArray(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                                   generator=Nd4j._random.generator(dev)))

    @staticmethod
    def randint(minval, maxval, shape, dtype=DataType.INT,
                device=None) -> NDArray:
        dev = resolve_device(device)
        return NDArray(torch.randint(int(minval), int(maxval), tuple(shape),
                                     generator=Nd4j._random.generator(dev),
                                     device=dev).to(_dt(dtype)))

    @staticmethod
    def bernoulli(p, shape, dtype=None, device=None) -> NDArray:
        dev = resolve_device(device)
        u = torch.rand(tuple(shape), generator=Nd4j._random.generator(dev),
                       device=dev)
        return NDArray((u < p).to(_dt(dtype)))

    @staticmethod
    def shuffle(a, device=None) -> NDArray:
        """Permute rows; an NDArray is rebound in place (reference:
        Nd4j.shuffle)."""
        t = _tensor(a, device)
        perm = torch.randperm(t.shape[0], device=t.device,
                              generator=Nd4j._random.generator(t.device))
        if isinstance(a, NDArray):
            a._buf = t[perm]
            return a
        return NDArray(t[perm])

    # -- more constructors ----------------------------------------------------
    @staticmethod
    def zerosLike(a) -> NDArray:
        return NDArray(torch.zeros_like(_tensor(a)))

    @staticmethod
    def onesLike(a) -> NDArray:
        return NDArray(torch.ones_like(_tensor(a)))

    @staticmethod
    def valueArrayOf(shape, value, dtype=None, device=None) -> NDArray:
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(torch.full(tuple(shape), value, dtype=_dt(dtype),
                                  device=resolve_device(device)))

    @staticmethod
    def scalar(value, dtype=None, device=None) -> NDArray:
        t = _tensor(np.asarray(value), device)
        return NDArray(t.to(_dt(dtype)) if dtype else t)

    @staticmethod
    def eye(n: int, dtype=None, device=None) -> NDArray:
        return NDArray(torch.eye(n, dtype=_dt(dtype),
                                 device=resolve_device(device)))

    @staticmethod
    def arange(*args, dtype=None, device=None) -> NDArray:
        """``jnp.arange(*args)`` in the default float type unless a dtype
        is given, as on the JAX side."""
        return NDArray(torch.arange(*args, dtype=_dt(dtype),
                                    device=resolve_device(device)))

    @staticmethod
    def linspace(start, stop, num, dtype=None, device=None) -> NDArray:
        return NDArray(torch.linspace(start, stop, num, dtype=_dt(dtype),
                                      device=resolve_device(device)))

    # -- combining ------------------------------------------------------------
    @staticmethod
    def concat(axis: int, *arrays, device=None) -> NDArray:
        return NDArray(torch.cat(_tensors(arrays, device), dim=axis))

    @staticmethod
    def hstack(*arrays, device=None) -> NDArray:
        return NDArray(torch.hstack(_tensors(arrays, device)))

    @staticmethod
    def vstack(*arrays, device=None) -> NDArray:
        return NDArray(torch.vstack(_tensors(arrays, device)))

    @staticmethod
    def stack(axis: int, *arrays, device=None) -> NDArray:
        return NDArray(torch.stack(_tensors(arrays, device), dim=axis))

    @staticmethod
    def pile(*arrays, device=None) -> NDArray:
        return Nd4j.stack(0, *arrays, device=device)

    @staticmethod
    def tile(a, *reps, device=None) -> NDArray:
        if len(reps) == 1 and isinstance(reps[0], (tuple, list)):
            reps = tuple(reps[0])
        return NDArray(torch.tile(_tensor(a, device), reps))

    @staticmethod
    def where(cond, x, y, device=None) -> NDArray:
        c, a, b = _tensors((cond, x, y), device)
        return NDArray(torch.where(c.to(torch.bool), a, b))

    # -- linalg -------------------------------------------------------------
    @staticmethod
    def gemm(a, b, transposeA: bool = False, transposeB: bool = False,
             alpha: float = 1.0, device=None) -> NDArray:
        A, B = _tensors((a, b), device)
        A = A.T if transposeA else A
        B = B.T if transposeB else B
        return NDArray(alpha * (A @ B))

    @staticmethod
    def matmul(a, b) -> NDArray:
        return NDArray(_unwrap(a) @ _unwrap(b))

    # -- misc ---------------------------------------------------------------
    @staticmethod
    def sort(a, axis=-1, descending: bool = False, device=None) -> NDArray:
        out = torch.sort(_tensor(a, device), dim=axis).values
        if descending:
            out = torch.flip(out, (axis,))
        return NDArray(out)

    @staticmethod
    def argsort(a, axis=-1, device=None) -> NDArray:
        return NDArray(torch.argsort(_tensor(a, device), dim=axis,
                                     stable=True).to(torch.int32))

    # -- ops by name ----------------------------------------------------------
    @staticmethod
    def exec(op_name: str, *args, **kwargs):
        """Execute a registered op by name (reference: Nd4j.exec(CustomOp)).
        NDArray arguments go in as their tensors; the op's own result
        comes back (tensors, or a tuple of them)."""
        from deeplearning4j_tpu_torch.ops.registry import get_op

        return get_op(op_name)(*(_unwrap(a) for a in args),
                               **{k: _unwrap(v) for k, v in kwargs.items()})

    # -- array serde ----------------------------------------------------------
    @staticmethod
    def saveBinary(a, path: str) -> None:
        """The npy container, as the JAX side writes it: bfloat16 goes out
        as its 16-bit patterns under numpy's 2-byte void type (``<V2``),
        the bytes numpy writes for an ``ml_dtypes`` bfloat16 array."""
        t = _unwrap(a)
        if isinstance(t, torch.Tensor):
            arr = (bfloat16_bits(t) if t.dtype == torch.bfloat16
                   else to_numpy(t))
        else:
            arr = np.asarray(t)
        with open(path, "wb") as f:
            np.save(f, arr, allow_pickle=False)

    @staticmethod
    def readBinary(path: str, device=None) -> NDArray:
        dev = resolve_device(device)
        return NDArray(numpy_to_tensor(
            np.load(path, allow_pickle=False)).to(dev))

    @staticmethod
    def writeTxt(a, path: str) -> None:
        """The JAX side's text format: one JSON header line (shape, dtype
        name), then the flattened values one a line."""
        import json as _json

        t = _unwrap(a)
        arr = to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)
        with open(path, "w") as f:
            f.write(_json.dumps({"shape": list(arr.shape),
                                 "dtype": arr.dtype.name}) + "\n")
            flat = arr.ravel()
            if arr.dtype.kind == "b":
                f.write("\n".join(str(int(v)) for v in flat))
            else:
                f.write("\n".join(repr(v.item()) for v in flat))
            f.write("\n")

    @staticmethod
    def readTxt(path: str, device=None) -> NDArray:
        import json as _json

        with open(path) as f:
            head = _json.loads(f.readline())
            vals = [line.strip() for line in f if line.strip()]
        dt = np.dtype(head["dtype"])
        if dt.kind == "b":
            arr = np.array([v in ("1", "True") for v in vals], dtype=bool)
        else:
            arr = np.array(vals, dtype=dt)
        return NDArray(numpy_to_tensor(arr.reshape(head["shape"])).to(
            resolve_device(device)))

    # numpy interop keeps the reference names
    writeAsNumpy = saveBinary
    createFromNpyFile = readBinary
