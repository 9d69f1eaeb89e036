"""Utility DataSet iterators: counterpart of
``deeplearning4j_tpu/datasets/iterator_utils.py`` (k-fold splits, views,
sampling with replacement, repeated epochs, early termination, caching
and pre-saved minibatch files). Host plumbing: batches keep the kind of
array they were given; files are ``DataSet.save``'s npz."""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, take
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


def _slice_ds(ds: DataSet, idx: np.ndarray) -> DataSet:
    """Rows ``idx`` of features, labels and masks."""
    fm, lm = ds.features_mask, ds.labels_mask
    return DataSet(take(ds.features, idx), take(ds.labels, idx),
                   take(fm, idx) if fm is not None else None,
                   take(lm, idx) if lm is not None else None)


class KFoldIterator(DataSetIterator):
    """k-fold splits: ``next()`` gives fold i's training set,
    ``testFold()`` its held-out fold (contiguous index ranges)."""

    def __init__(self, k: int, dataset: DataSet):
        n = dataset.numExamples()
        if k < 2 or k > n:
            raise ValueError(f"need 2 <= k <= numExamples, got k={k}, "
                             f"n={n}")
        self._ds = dataset
        self.k = k
        self._bounds = np.linspace(0, n, k + 1).astype(int)
        self._fold = 0

    def reset(self):
        self._fold = 0

    def hasNext(self) -> bool:
        return self._fold < self.k

    def _split(self, fold: int):
        lo, hi = self._bounds[fold], self._bounds[fold + 1]
        n = self._ds.numExamples()
        test = np.arange(lo, hi)
        train = np.concatenate([np.arange(0, lo), np.arange(hi, n)])
        return train, test

    def next(self) -> DataSet:
        train, _ = self._split(self._fold)
        self._fold += 1
        return _slice_ds(self._ds, train)

    def testFold(self) -> DataSet:
        """Held-out fold of the most recent ``next()``."""
        if self._fold == 0:
            raise ValueError("call next() before testFold()")
        _, test = self._split(self._fold - 1)
        return _slice_ds(self._ds, test)

    def batch(self) -> int:
        return int(self._bounds[1] - self._bounds[0])


class ViewIterator(DataSetIterator):
    """Sequential minibatches over one DataSet."""

    def __init__(self, dataset: DataSet, batch_size: int):
        self._ds = dataset
        self._bs = int(batch_size)
        self._i = 0

    def reset(self):
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < self._ds.numExamples()

    def next(self) -> DataSet:
        j = min(self._i + self._bs, self._ds.numExamples())
        out = _slice_ds(self._ds, np.arange(self._i, j))
        self._i = j
        return out

    def batch(self) -> int:
        return self._bs


class SamplingDataSetIterator(DataSetIterator):
    """Minibatches drawn with replacement, ``total_num_samples`` an
    epoch."""

    def __init__(self, dataset: DataSet, batch_size: int,
                 total_num_samples: int, seed: int = 123):
        self._ds = dataset
        self._bs = int(batch_size)
        self._total = int(total_num_samples)
        self._seed = seed
        self._epoch = 0
        self._drawn = 0
        self._rng = np.random.default_rng(seed)

    def reset(self):
        self._drawn = 0
        self._epoch += 1
        self._rng = np.random.default_rng(self._seed + self._epoch)

    def hasNext(self) -> bool:
        return self._drawn < self._total

    def next(self) -> DataSet:
        n = min(self._bs, self._total - self._drawn)
        idx = self._rng.integers(0, self._ds.numExamples(), size=n)
        self._drawn += n
        return _slice_ds(self._ds, idx)

    def batch(self) -> int:
        return self._bs


class MultipleEpochsIterator(DataSetIterator):
    """The underlying iterator replayed ``num_epochs`` times as one
    pass."""

    def __init__(self, num_epochs: int, underlying: DataSetIterator):
        if num_epochs < 1:
            raise ValueError("num_epochs must be >= 1")
        self._n = num_epochs
        self._it = underlying
        self._epoch = 0

    def reset(self):
        self._epoch = 0
        self._it.reset()

    def hasNext(self) -> bool:
        if self._it.hasNext():
            return True
        if self._epoch + 1 < self._n:
            self._epoch += 1
            self._it.reset()
            return self._it.hasNext()
        return False

    def next(self) -> DataSet:
        if not self.hasNext():
            raise StopIteration
        return self._it.next()

    def batch(self) -> int:
        return self._it.batch()


class EarlyTerminationDataSetIterator(DataSetIterator):
    """At most ``max_minibatches`` an epoch."""

    def __init__(self, underlying: DataSetIterator, max_minibatches: int):
        if max_minibatches < 1:
            raise ValueError("max_minibatches must be >= 1")
        self._it = underlying
        self._max = max_minibatches
        self._count = 0

    def reset(self):
        self._count = 0
        self._it.reset()

    def hasNext(self) -> bool:
        return self._count < self._max and self._it.hasNext()

    def next(self) -> DataSet:
        if not self.hasNext():
            raise StopIteration
        self._count += 1
        return self._it.next()

    def batch(self) -> int:
        return self._it.batch()


class CachingDataSetIterator(DataSetIterator):
    """The first epoch pulls from the underlying iterator and fills the
    cache; later epochs are served from it. ``cache_dir=None`` keeps the
    batches in memory; a directory holds one npz per minibatch."""

    def __init__(self, underlying: DataSetIterator,
                 cache_dir: Optional[str] = None,
                 namespace: str = "default"):
        self._it = underlying
        self._dir = cache_dir
        self._ns = namespace
        self._mem: List[DataSet] = []
        self._complete = False
        self._pos = 0
        self._n_files = 0
        if cache_dir is not None:
            os.makedirs(os.path.join(cache_dir, namespace), exist_ok=True)

    def _cache_path(self, i: int) -> str:
        return os.path.join(self._dir, self._ns, f"batch-{i}.npz")

    def reset(self):
        self._pos = 0
        if not self._complete:
            self._mem = []
            self._it.reset()

    def hasNext(self) -> bool:
        if self._complete:
            return self._pos < (len(self._mem) if self._dir is None
                                else self._n_files)
        return self._it.hasNext()

    def next(self) -> DataSet:
        if self._complete:
            if self._dir is None:
                ds = self._mem[self._pos]
            else:
                ds = DataSet.load(self._cache_path(self._pos))
            self._pos += 1
            return ds
        ds = self._it.next()
        if self._dir is None:
            self._mem.append(ds)
        else:
            ds.save(self._cache_path(self._pos))
        self._pos += 1
        if not self._it.hasNext():
            self._complete = True
            self._n_files = self._pos
        return ds

    def batch(self) -> int:
        return self._it.batch()


class ExistingMiniBatchDataSetIterator(DataSetIterator):
    """Pre-saved minibatch files of a directory (``DataSet.save``'s
    output; default pattern ``dataset-%d.npz``), in index order."""

    def __init__(self, directory: str, pattern: str = "dataset-%d.npz"):
        self._dir = directory
        self._pattern = pattern
        rx = re.compile(
            "^" + re.escape(pattern).replace("%d", r"(\d+)") + "$")
        found = []
        for name in os.listdir(directory):
            m = rx.match(name)
            if m:
                found.append((int(m.group(1)), name))
        if not found:
            raise ValueError(f"no files matching {pattern!r} in {directory}")
        self._files = [n for _, n in sorted(found)]
        self._i = 0
        self._batch = DataSet.load(
            os.path.join(directory, self._files[0])).numExamples()

    def reset(self):
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._files)

    def next(self) -> DataSet:
        ds = DataSet.load(os.path.join(self._dir, self._files[self._i]))
        self._i += 1
        return ds

    def batch(self) -> int:
        return self._batch


__all__ = ["KFoldIterator", "ViewIterator", "SamplingDataSetIterator",
           "MultipleEpochsIterator", "EarlyTerminationDataSetIterator",
           "CachingDataSetIterator", "ExistingMiniBatchDataSetIterator"]
