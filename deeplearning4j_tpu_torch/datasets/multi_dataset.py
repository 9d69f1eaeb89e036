"""MultiDataSet: counterpart of
``deeplearning4j_tpu/datasets/multi_dataset.py`` (N feature arrays, M
label arrays and their optional masks: the data of a multi-input or
multi-output ``ComputationGraph``), and its iterators."""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


def _as_list(v) -> List:
    if v is None:
        return []
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _host(a):
    return a if torch.is_tensor(a) else np.asarray(a)


class MultiDataSet:
    """N features arrays + M labels arrays (+ optional masks)."""

    def __init__(self, features=None, labels=None,
                 features_mask_arrays=None, labels_mask_arrays=None):
        self.features = _as_list(features)
        self.labels = _as_list(labels)
        self.features_mask_arrays = _as_list(features_mask_arrays)
        self.labels_mask_arrays = _as_list(labels_mask_arrays)

    def getFeatures(self, idx: Optional[int] = None):
        return self.features if idx is None else self.features[idx]

    def getLabels(self, idx: Optional[int] = None):
        return self.labels if idx is None else self.labels[idx]

    def numFeatureArrays(self) -> int:
        return len(self.features)

    def numLabelsArrays(self) -> int:
        return len(self.labels)

    def numExamples(self) -> int:
        return 0 if not self.features else int(self.features[0].shape[0])

    @staticmethod
    def fromDataSet(ds: DataSet) -> "MultiDataSet":
        return MultiDataSet(
            [ds.features], [ds.labels],
            [ds.features_mask] if ds.features_mask is not None else None,
            [ds.labels_mask] if ds.labels_mask is not None else None)

    def splitBatches(self, batch_size: int) -> List["MultiDataSet"]:
        n = self.numExamples()

        def cut(arrs, s):
            # a mask list may hold None for some arrays
            return [_host(a)[s:s + batch_size]
                    if a is not None else None for a in arrs] or None

        return [MultiDataSet(cut(self.features, s), cut(self.labels, s),
                             cut(self.features_mask_arrays, s),
                             cut(self.labels_mask_arrays, s))
                for s in range(0, n, batch_size)]


class MultiDataSetIterator:
    """reference: api/MultiDataSetIterator."""

    def reset(self):
        raise NotImplementedError

    def hasNext(self) -> bool:
        raise NotImplementedError

    def next(self) -> MultiDataSet:
        raise NotImplementedError

    def resetSupported(self) -> bool:
        return True

    def asyncSupported(self) -> bool:
        return False

    def __iter__(self) -> Iterator[MultiDataSet]:
        if self.resetSupported():
            self.reset()
        while self.hasNext():
            yield self.next()


class ListMultiDataSetIterator(MultiDataSetIterator):
    def __init__(self, datasets: Sequence[MultiDataSet]):
        self._data = list(datasets)
        self._i = 0

    def reset(self):
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._data)

    def next(self) -> MultiDataSet:
        ds = self._data[self._i]
        self._i += 1
        return ds


class ArrayMultiDataSetIterator(MultiDataSetIterator):
    """Batches over in-memory lists of feature and label arrays."""

    def __init__(self, features: Sequence, labels: Sequence,
                 batch_size: int):
        self._f = [_host(f) for f in _as_list(features)]
        self._l = [_host(l) for l in _as_list(labels)]
        self._bs = int(batch_size)
        self._i = 0
        self._n = self._f[0].shape[0] if self._f else 0

    def reset(self):
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < self._n

    def next(self) -> MultiDataSet:
        s = self._i
        self._i += self._bs
        return MultiDataSet([f[s:s + self._bs] for f in self._f],
                            [l[s:s + self._bs] for l in self._l])

    def batch(self) -> int:
        return self._bs


class MultiDataSetIteratorAdapter(MultiDataSetIterator):
    """A single-input DataSetIterator as a MultiDataSetIterator."""

    def __init__(self, iterator):
        self._it = iterator

    def reset(self):
        self._it.reset()

    def hasNext(self) -> bool:
        return self._it.hasNext()

    def next(self) -> MultiDataSet:
        return MultiDataSet.fromDataSet(self._it.next())

    def resetSupported(self) -> bool:
        return self._it.resetSupported()


__all__ = ["MultiDataSet", "MultiDataSetIterator", "ListMultiDataSetIterator",
           "ArrayMultiDataSetIterator", "MultiDataSetIteratorAdapter"]
