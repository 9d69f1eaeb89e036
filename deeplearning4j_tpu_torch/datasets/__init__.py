"""Datasets: a minimal ``DataSet`` (counterpart of
``deeplearning4j_tpu/datasets/dataset.py``), enough for
``MultiLayerNetwork.fit(DataSet)``. ``DataSetIterator`` and the rest of
the datasets package are not ported yet (ROADMAP.md A9)."""

from __future__ import annotations


class DataSet:
    """A minibatch: features and labels, each with an optional mask.
    Arrays are kept as given (numpy arrays or tensors)."""

    def __init__(self, features, labels, features_mask=None,
                 labels_mask=None):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask


__all__ = ["DataSet"]
