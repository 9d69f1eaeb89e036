"""Nd4j, the static array factory: counterpart of
``deeplearning4j_tpu/ndarray/factory.py``.

Ported: ``create``, ``zeros``, ``ones``, ``rand``, ``randn``,
``setSeed``, ``getRandom``, ``matmul``, ``exec`` (ops by name, :211-217),
``saveBinary`` and ``readBinary``. Constructors take ``device=None``,
which means the CUDA card (:func:`~deeplearning4j_tpu_torch.device.
resolve_device`). The random state is a seeded ``torch.Generator`` per
device: the same laws as the JAX side's threefry draws, not the same
bits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray.dtypes import DEFAULT_FLOAT, DataType
from deeplearning4j_tpu_torch.ndarray.ndarray import (NDArray, _unwrap,
                                                      to_numpy)
from deeplearning4j_tpu_torch.params import bfloat16_bits, numpy_to_tensor


def _dt(dtype) -> torch.dtype:
    if dtype is None:
        return DEFAULT_FLOAT.torch
    return DataType.from_any(dtype).torch


def _shape(shape) -> tuple:
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(shape[0])
    return tuple(shape)


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

    # -- linalg -------------------------------------------------------------
    @staticmethod
    def matmul(a, b) -> NDArray:
        return NDArray(_unwrap(a) @ _unwrap(b))

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

    # numpy interop keeps the reference names
    writeAsNumpy = saveBinary
    createFromNpyFile = readBinary
