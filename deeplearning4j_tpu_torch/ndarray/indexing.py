"""NDArray indexing: counterpart of ``deeplearning4j_tpu/ndarray/indexing.py``
(:17-111) (reference: org/nd4j/linalg/indexing/: NDArrayIndex and the
INDArrayIndex kinds PointIndex, IntervalIndex, NDArrayIndexAll, NewAxis,
SpecifiedIndex, consumed by INDArray#get and #put).

Index objects resolve to numpy-style index pieces; a SpecifiedIndex
resolves to an int64 tensor, which torch indexing takes on any device.
``get`` reads, ``put`` writes into a copy and rebinds the array (see
``ndarray.py``).
"""

from __future__ import annotations

from typing import Any, List, Sequence


class INDArrayIndex:
    """Marker base (reference: indexing/INDArrayIndex)."""

    def resolve(self):  # -> numpy-style index piece
        raise NotImplementedError


class PointIndex(INDArrayIndex):
    def __init__(self, i: int):
        self.i = int(i)

    def resolve(self):
        return self.i


class IntervalIndex(INDArrayIndex):
    def __init__(self, begin: int, end: int, stride: int = 1,
                 inclusive: bool = False):
        self.begin = int(begin)
        self.end = int(end) + (1 if inclusive else 0)
        self.stride = int(stride)

    def resolve(self):
        return slice(self.begin, self.end, self.stride)


class NDArrayIndexAll(INDArrayIndex):
    def resolve(self):
        return slice(None)


class NewAxis(INDArrayIndex):
    def resolve(self):
        return None  # numpy newaxis


class SpecifiedIndex(INDArrayIndex):
    def __init__(self, *indices: int):
        self.indices = [int(i) for i in indices]

    def resolve(self):
        import torch

        return torch.tensor(self.indices, dtype=torch.int64)


class NDArrayIndex:
    """Static factory (reference: indexing/NDArrayIndex)."""

    @staticmethod
    def all() -> INDArrayIndex:
        return NDArrayIndexAll()

    @staticmethod
    def point(i: int) -> INDArrayIndex:
        return PointIndex(i)

    @staticmethod
    def interval(begin: int, *args, stride: int = 1,
                 inclusive: bool = False) -> INDArrayIndex:
        """Reference overloads, argument order preserved EXACTLY:
        interval(begin, end) / interval(begin, stride, end[, inclusive]).
        Keyword form interval(begin, end, stride=..., inclusive=...)
        also accepted."""
        if len(args) == 1:
            end = args[0]
        elif len(args) in (2, 3):
            # 3-positional is the reference's (begin, STRIDE, end)
            stride, end = args[0], args[1]
            if len(args) == 3:
                inclusive = bool(args[2])
        else:
            raise TypeError(
                "interval(begin, end) or interval(begin, stride, end"
                "[, inclusive])")
        return IntervalIndex(begin, end, stride, inclusive)

    @staticmethod
    def newAxis() -> INDArrayIndex:
        return NewAxis()

    @staticmethod
    def indices(*idx: int) -> INDArrayIndex:
        return SpecifiedIndex(*idx)


def resolve_indices(idxs: Sequence[Any]) -> tuple:
    """INDArrayIndex / int / slice / list mix -> numpy index tuple."""
    out: List[Any] = []
    for ix in idxs:
        if isinstance(ix, INDArrayIndex):
            out.append(ix.resolve())
        else:
            out.append(ix)
    return tuple(out)
