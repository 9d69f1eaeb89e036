"""DataSet iterators: counterpart of
``deeplearning4j_tpu/datasets/iterator.py``. Python-iterable, with the
reference's ``reset`` / ``hasNext`` / ``next`` surface. The shuffle is the
JAX class's exactly (``np.random.default_rng(seed + epoch)``), so both
packages give the same batches in the same order."""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, take


class DataSetIterator:
    """Base iterator protocol (reference interface)."""

    def reset(self):
        raise NotImplementedError

    def hasNext(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def resetSupported(self) -> bool:
        return True

    def get_state(self) -> dict:
        """The position to resume from: the next batch, not a repeat."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support state capture")

    def set_state(self, state: dict) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support state restore")

    def asyncSupported(self) -> bool:
        return True

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.hasNext():
            yield self.next()


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of pre-built DataSets."""

    def __init__(self, datasets: Sequence[DataSet],
                 batch_size: Optional[int] = None):
        self._ds = list(datasets)
        self._i = 0
        self._batch = batch_size or (self._ds[0].numExamples()
                                     if self._ds else 0)

    def reset(self):
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._ds)

    def next(self) -> DataSet:
        ds = self._ds[self._i]
        self._i += 1
        return ds

    def get_state(self) -> dict:
        return {"i": int(self._i)}

    def set_state(self, state: dict) -> None:
        i = int(state["i"])
        if not 0 <= i <= len(self._ds):
            raise ValueError(
                f"iterator state position {i} out of range for "
                f"{len(self._ds)} datasets (checkpoint from a different "
                "dataset?)")
        self._i = i

    def batch(self) -> int:
        return self._batch


class ArrayDataSetIterator(DataSetIterator):
    """Minibatches over in-memory arrays, optionally shuffled each epoch.
    Numpy arrays give numpy batches; tensors give tensors on their
    device."""

    def __init__(self, features, labels, batch_size: int,
                 shuffle: bool = False, seed: int = 123,
                 drop_last: bool = False):
        self._x = features if torch.is_tensor(features) \
            else np.asarray(features)
        self._y = labels if torch.is_tensor(labels) else np.asarray(labels)
        if self._x.shape[0] != self._y.shape[0]:
            raise ValueError(f"{self._x.shape[0]} feature rows but "
                             f"{self._y.shape[0]} label rows")
        self._bs = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last
        self._order = np.arange(self._x.shape[0])
        self._i = 0
        self._maybe_shuffle()

    def _maybe_shuffle(self):
        if self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            self._order = rng.permutation(self._x.shape[0])

    def reset(self):
        self._i = 0
        self._epoch += 1
        self._maybe_shuffle()

    def get_state(self) -> dict:
        return {"i": int(self._i), "epoch": int(self._epoch)}

    def set_state(self, state: dict) -> None:
        i = int(state["i"])
        if not 0 <= i <= self._x.shape[0]:
            raise ValueError(
                f"iterator state position {i} out of range for "
                f"{self._x.shape[0]} examples (checkpoint from a different "
                "dataset?)")
        self._epoch = int(state["epoch"])
        self._i = i
        # the order is a function of (seed, epoch): restoring (epoch, i)
        # gives the same batches again
        self._maybe_shuffle()

    def hasNext(self) -> bool:
        remaining = self._x.shape[0] - self._i
        if self._drop_last:
            return remaining >= self._bs
        return remaining > 0

    def next(self) -> DataSet:
        j = min(self._i + self._bs, self._x.shape[0])
        idx = self._order[self._i:j]
        self._i = j
        return DataSet(take(self._x, idx), take(self._y, idx))

    def batch(self) -> int:
        return self._bs

    def totalExamples(self) -> int:
        return int(self._x.shape[0])


__all__ = ["DataSetIterator", "ListDataSetIterator", "ArrayDataSetIterator"]
