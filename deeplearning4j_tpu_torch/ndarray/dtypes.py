"""Data types: counterpart of ``deeplearning4j_tpu/ndarray/dtypes.py``.

The enum keeps nd4j's names and the JAX package's values (numpy dtype
names); ``.torch`` gives the torch dtype in place of the JAX side's
``.jax``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    """Mirror of nd4j's DataType enum, mapped onto torch dtypes."""

    DOUBLE = "float64"
    FLOAT = "float32"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    LONG = "int64"
    INT = "int32"
    SHORT = "int16"
    BYTE = "int8"
    UBYTE = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    BOOL = "bool"

    @property
    def torch(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def np(self) -> np.dtype:
        """The numpy dtype; numpy has no bfloat16, so that one raises."""
        return np.dtype(self.value)

    def is_float(self) -> bool:
        return self in _FLOATS

    def is_int(self) -> bool:
        return self in _INTS

    def is_signed(self) -> bool:
        return self in _SIGNED

    def width_bytes(self) -> int:
        return torch.empty((), dtype=self.torch).element_size()

    @staticmethod
    def from_any(dtype) -> "DataType":
        """Coerce a DataType, torch dtype, numpy dtype or string (with the
        JAX side's short aliases: "bf16", "fp16", "f32", ...)."""
        if isinstance(dtype, DataType):
            return dtype
        if isinstance(dtype, torch.dtype):
            name = str(dtype).split(".", 1)[1]
        else:
            if isinstance(dtype, str):
                alias = _DTYPE_ALIASES.get(dtype.strip().lower())
                if alias is not None:
                    return alias
                if dtype == "bfloat16":
                    return DataType.BFLOAT16
            try:
                name = np.dtype(dtype).name
            except TypeError:
                name = getattr(dtype, "name", str(dtype))
        for dt in DataType:
            if dt.value == name:
                return dt
        raise ValueError(f"Unsupported dtype: {dtype!r}")


#: short-form spellings accepted by from_any (the JAX side's table)
_DTYPE_ALIASES = {
    "bf16": DataType.BFLOAT16,
    "fp16": DataType.HALF,
    "f16": DataType.HALF,
    "half": DataType.HALF,
    "f32": DataType.FLOAT,
    "fp32": DataType.FLOAT,
    "single": DataType.FLOAT,
    "f64": DataType.DOUBLE,
    "fp64": DataType.DOUBLE,
    "double": DataType.DOUBLE,
}

_FLOATS = {DataType.DOUBLE, DataType.FLOAT, DataType.HALF, DataType.BFLOAT16}
_INTS = {DataType.LONG, DataType.INT, DataType.SHORT, DataType.BYTE,
         DataType.UBYTE, DataType.UINT16, DataType.UINT32, DataType.UINT64}
_SIGNED = _FLOATS | {DataType.LONG, DataType.INT, DataType.SHORT,
                     DataType.BYTE}

#: default floating point type (nd4j's FLOAT)
DEFAULT_FLOAT = DataType.FLOAT
