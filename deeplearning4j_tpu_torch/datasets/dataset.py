"""DataSet: counterpart of ``deeplearning4j_tpu/datasets/dataset.py``
(features, labels and optional masks).

Arrays are kept as given: numpy arrays stay on the host, tensors stay on
their device (a ``DevicePrefetchIterator`` hands the fit loops batches
already on the card). ``NDArray`` arguments are unwrapped to their
tensors, as the JAX class unwraps its ``NDArray``.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray, _unwrap
from deeplearning4j_tpu_torch.params import bfloat16_bits, numpy_to_tensor


def to_numpy(a) -> np.ndarray:
    """A host numpy array of ``a`` (numpy, or a tensor on any device); a
    bfloat16 tensor comes back as float32 (the same values)."""
    if torch.is_tensor(a):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def file_array(a) -> np.ndarray:
    """``a`` as numpy for an npz file: a bfloat16 tensor as the 2-byte
    void numpy writes for the JAX side's bfloat16 arrays."""
    if torch.is_tensor(a) and a.dtype == torch.bfloat16:
        return bfloat16_bits(a)
    return to_numpy(a)


def take(a, idx: np.ndarray):
    """Rows ``idx`` of ``a``, in ``a``'s own kind (numpy or a tensor on
    its device)."""
    if torch.is_tensor(a):
        return a[torch.as_tensor(idx, dtype=torch.long, device=a.device)]
    return np.asarray(a)[idx]


class DataSet:
    """A minibatch: features and labels, each with an optional mask."""

    def __init__(self, features, labels, features_mask=None,
                 labels_mask=None):
        self.features = _unwrap(features)
        self.labels = _unwrap(labels)
        self.features_mask = (_unwrap(features_mask)
                              if features_mask is not None else None)
        self.labels_mask = (_unwrap(labels_mask)
                            if labels_mask is not None else None)

    def getFeatures(self) -> NDArray:
        return NDArray(self.features)

    def getLabels(self) -> NDArray:
        return NDArray(self.labels)

    def numExamples(self) -> int:
        return int(self.features.shape[0])

    def sample(self, n: int, rng=None) -> "DataSet":
        idx = np.random.default_rng(rng).permutation(self.numExamples())[:n]
        return DataSet(take(self.features, idx), take(self.labels, idx))

    def splitTestAndTrain(self, n_train: int):
        return (DataSet(self.features[:n_train], self.labels[:n_train]),
                DataSet(self.features[n_train:], self.labels[n_train:]))

    def shuffle(self, seed: int = 0) -> "DataSet":
        idx = np.random.default_rng(seed).permutation(self.numExamples())
        self.features = take(self.features, idx)
        self.labels = take(self.labels, idx)
        return self

    def asList(self):
        return [DataSet(self.features[i:i + 1], self.labels[i:i + 1])
                for i in range(self.numExamples())]

    def save(self, path: str) -> None:
        """npz at exactly ``path`` (the JAX class's format: ``features``,
        ``labels`` and the masks present; bfloat16 as 2-byte voids)."""
        arrs = {"features": file_array(self.features),
                "labels": file_array(self.labels)}
        if self.features_mask is not None:
            arrs["features_mask"] = file_array(self.features_mask)
        if self.labels_mask is not None:
            arrs["labels_mask"] = file_array(self.labels_mask)
        # through a file object: np.savez(str) would append '.npz'
        with open(path, "wb") as f:
            np.savez(f, **arrs)

    @staticmethod
    def load(path: str) -> "DataSet":
        """A DataSet of host arrays from :meth:`save` (or the JAX
        class's) file; a bfloat16 array comes back as a CPU tensor."""
        with np.load(path) as z:
            def opt(k):
                if k not in z.files:
                    return None
                a = z[k]
                return numpy_to_tensor(a) if a.dtype.kind == "V" else a
            return DataSet(opt("features"), opt("labels"),
                           opt("features_mask"), opt("labels_mask"))

    @staticmethod
    def merge(datasets) -> "DataSet":
        """Row-concatenate (host numpy arrays)."""
        if not datasets:
            raise ValueError("merge of empty list")
        f = np.concatenate([to_numpy(d.features) for d in datasets])
        l = np.concatenate([to_numpy(d.labels) for d in datasets])
        masks = []
        for attr in ("features_mask", "labels_mask"):
            have = [getattr(d, attr) is not None for d in datasets]
            if any(have) and not all(have):
                raise ValueError(f"cannot merge: {attr} present on "
                                 "some DataSets but not others")
            masks.append(np.concatenate(
                [to_numpy(getattr(d, attr)) for d in datasets])
                if all(have) else None)
        return DataSet(f, l, masks[0], masks[1])

    def __repr__(self):
        return (f"DataSet(features={tuple(self.features.shape)}, "
                f"labels={tuple(self.labels.shape)})")


__all__ = ["DataSet", "to_numpy", "take"]
