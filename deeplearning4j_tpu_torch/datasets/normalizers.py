"""Data normalizers: counterpart of
``deeplearning4j_tpu/datasets/normalizers.py`` (``NormalizerStandardize``,
``NormalizerMinMaxScaler``, the ``Multi*`` pair, ``VGG16ImagePreProcessor``,
``CompositeDataSetPreProcessor`` and ``ImagePreProcessingScaler``).

``fit`` gathers its statistics on the host in numpy, in the JAX class's
order, and ``state_dict`` / ``load_state_dict`` carry them as numpy, so
the ``normalizer.npz`` member of a model zip is the same in both
packages. ``transform`` and ``revert`` run in torch on the device of the
batch they are given (the card, for a batch a ``DevicePrefetchIterator``
placed there) and replace the batch's arrays, as the reference mutates
its DataSets.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, to_numpy
from deeplearning4j_tpu_torch.params import numpy_to_tensor_narrowed


def _tensor(a) -> torch.Tensor:
    """``a`` as a tensor where it lies (numpy on the CPU, 64-bit numbers
    made 32-bit as ``jnp.asarray`` makes them)."""
    return a if torch.is_tensor(a) else numpy_to_tensor_narrowed(a)


def _on(stat, x: torch.Tensor) -> torch.Tensor:
    """A numpy statistic as a tensor on ``x``'s device (32-bit)."""
    return numpy_to_tensor_narrowed(stat).to(x.device)


def _batches(data):
    return [data] if isinstance(data, DataSet) else data


class DataNormalization:
    def fit(self, data):
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def preProcess(self, ds: DataSet) -> DataSet:
        return self.transform(ds)

    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, d: dict):
        raise NotImplementedError


class _RunningMoments:
    """Streaming mean/std accumulator over [..., F] batches."""

    def __init__(self):
        self.n, self.s, self.s2 = 0, None, None

    def add(self, x: np.ndarray) -> None:
        feats = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x[:, None]
        if self.s is None:
            self.s = feats.sum(0)
            self.s2 = (feats ** 2).sum(0)
        else:
            self.s += feats.sum(0)
            self.s2 += (feats ** 2).sum(0)
        self.n += feats.shape[0]

    def finalize(self):
        if self.n == 0:
            raise ValueError("fit() saw no data")
        mean = self.s / self.n
        std = np.sqrt(np.maximum(self.s2 / self.n - mean ** 2, 0)) + 1e-8
        return mean, std


class _RunningMinMax:
    """Streaming per-column min/max accumulator over [..., F] batches."""

    def __init__(self):
        self.mn = None
        self.mx = None

    def add(self, x: np.ndarray) -> None:
        flat = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x[:, None]
        bmn, bmx = flat.min(0), flat.max(0)
        if self.mn is None:
            self.mn, self.mx = bmn, bmx
        else:
            self.mn = np.minimum(self.mn, bmn)
            self.mx = np.maximum(self.mx, bmx)

    def finalize(self):
        if self.mn is None:
            raise ValueError("fit() saw no data")
        return self.mn, self.mx


def _check_arity(got: int, expected: int, kind: str) -> None:
    if got != expected:
        raise ValueError(
            f"MultiDataSet has {got} {kind} arrays but the normalizer was "
            f"fitted on {expected}: refusing to truncate")


def _min_max(x, mn, mx, lo: float, hi: float) -> torch.Tensor:
    x = _tensor(x)
    rng = np.maximum(mx - mn, 1e-8)
    scaled = (x - _on(mn, x)) / _on(rng, x)
    return scaled * (hi - lo) + lo


class NormalizerStandardize(DataNormalization):
    """Zero mean and unit variance per feature; ``fitLabel(True)`` does
    the same to the labels (``revertLabels`` undoes it on predictions)."""

    def __init__(self):
        self.mean = None
        self.std = None
        self.label_mean = None
        self.label_std = None
        self._fit_label = False

    def fitLabel(self, fit: bool = True) -> "NormalizerStandardize":
        self._fit_label = fit
        return self

    def fit(self, data):
        """``data``: a DataSet or an iterator of them, in one pass."""
        fm, lm = _RunningMoments(), _RunningMoments()
        for ds in _batches(data):
            fm.add(to_numpy(ds.features))
            if self._fit_label:
                lm.add(to_numpy(ds.labels))
        self.mean, self.std = fm.finalize()
        if self._fit_label:
            self.label_mean, self.label_std = lm.finalize()
        else:
            self.label_mean = self.label_std = None

    def transform(self, ds: DataSet) -> DataSet:
        x = _tensor(ds.features)
        ds.features = (x - _on(self.mean, x)) / _on(self.std, x)
        if self.label_mean is not None:
            y = _tensor(ds.labels)
            ds.labels = (y - _on(self.label_mean, y)) / _on(self.label_std,
                                                            y)
        return ds

    def revert(self, ds: DataSet) -> DataSet:
        x = _tensor(ds.features)
        ds.features = x * _on(self.std, x) + _on(self.mean, x)
        if self.label_mean is not None:
            ds.labels = self.revertLabels(ds.labels)
        return ds

    def revertLabels(self, labels):
        """Predictions in the labels' original scale."""
        if self.label_mean is None:
            return labels
        y = _tensor(labels)
        return y * _on(self.label_std, y) + _on(self.label_mean, y)

    def state_dict(self):
        d = {"mean": self.mean, "std": self.std}
        if self.label_mean is not None:
            d["label_mean"] = self.label_mean
            d["label_std"] = self.label_std
        return d

    def load_state_dict(self, d):
        self.mean = np.asarray(d["mean"])
        self.std = np.asarray(d["std"])
        if "label_mean" in d:
            self.label_mean = np.asarray(d["label_mean"])
            self.label_std = np.asarray(d["label_std"])
            self._fit_label = True
        else:
            self.label_mean = self.label_std = None
            self._fit_label = False


class NormalizerMinMaxScaler(DataNormalization):
    """Features scaled to [min_range, max_range] (default [0, 1])."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min = None
        self.data_max = None

    def fit(self, data):
        acc = _RunningMinMax()
        for ds in _batches(data):
            acc.add(to_numpy(ds.features))
        self.data_min, self.data_max = acc.finalize()

    def transform(self, ds: DataSet) -> DataSet:
        ds.features = _min_max(ds.features, self.data_min, self.data_max,
                               self.min_range, self.max_range)
        return ds

    def state_dict(self):
        return {"data_min": self.data_min, "data_max": self.data_max,
                "range": np.asarray([self.min_range, self.max_range])}

    def load_state_dict(self, d):
        self.data_min = np.asarray(d["data_min"])
        self.data_max = np.asarray(d["data_max"])
        self.min_range, self.max_range = (float(v) for v in d["range"])


def _multi_batches(data):
    from deeplearning4j_tpu_torch.datasets.multi_dataset import MultiDataSet

    return [data] if isinstance(data, MultiDataSet) else data


class MultiNormalizerStandardize:
    """Per-input (and with ``fitLabel``, per-output) standardisation of
    MultiDataSets, one streaming pass over all arrays."""

    def __init__(self):
        self.means: list = []
        self.stds: list = []
        self.label_means: list = []
        self.label_stds: list = []
        self._fit_label = False

    def fitLabel(self, fit: bool = True) -> "MultiNormalizerStandardize":
        self._fit_label = fit
        return self

    def fit(self, data):
        """``data``: a MultiDataSet or an iterator of them."""
        first = True
        fms: list = []
        lms: list = []
        for mds in _multi_batches(data):
            if first:
                fms = [_RunningMoments() for _ in mds.features]
                lms = ([_RunningMoments() for _ in mds.labels]
                       if self._fit_label else [])
                first = False
            _check_arity(len(mds.features), len(fms), "feature")
            if lms:
                _check_arity(len(mds.labels), len(lms), "label")
            for m, x in zip(fms, mds.features):
                m.add(to_numpy(x))
            for m, y in zip(lms, mds.labels):
                m.add(to_numpy(y))
        if first:
            raise ValueError("fit() saw no data")
        self.means, self.stds = map(list, zip(*[m.finalize() for m in fms]))
        if lms:
            self.label_means, self.label_stds = map(
                list, zip(*[m.finalize() for m in lms]))

    def transform(self, mds):
        if not self.means:
            raise ValueError("MultiNormalizerStandardize not fitted: call "
                             "fit() first")
        _check_arity(len(mds.features), len(self.means), "feature")
        feats = [_tensor(x) for x in mds.features]
        mds.features = [(x - _on(m, x)) / _on(s, x)
                        for x, m, s in zip(feats, self.means, self.stds)]
        if self.label_means:
            _check_arity(len(mds.labels), len(self.label_means), "label")
            labs = [_tensor(y) for y in mds.labels]
            mds.labels = [(y - _on(m, y)) / _on(s, y)
                          for y, m, s in zip(labs, self.label_means,
                                             self.label_stds)]
        return mds

    def preProcess(self, mds):
        return self.transform(mds)

    def revertLabels(self, labels: list) -> list:
        if not self.label_means:
            return labels
        _check_arity(len(labels), len(self.label_means), "label")
        labs = [_tensor(y) for y in labels]
        return [y * _on(s, y) + _on(m, y)
                for y, m, s in zip(labs, self.label_means, self.label_stds)]

    def state_dict(self) -> dict:
        d = {}
        for i, (m, s) in enumerate(zip(self.means, self.stds)):
            d[f"mean{i}"] = m
            d[f"std{i}"] = s
        for i, (m, s) in enumerate(zip(self.label_means, self.label_stds)):
            d[f"label_mean{i}"] = m
            d[f"label_std{i}"] = s
        return d

    def load_state_dict(self, d: dict) -> None:
        self.means, self.stds = [], []
        self.label_means, self.label_stds = [], []
        i = 0
        while f"mean{i}" in d:
            self.means.append(np.asarray(d[f"mean{i}"]))
            self.stds.append(np.asarray(d[f"std{i}"]))
            i += 1
        i = 0
        while f"label_mean{i}" in d:
            self.label_means.append(np.asarray(d[f"label_mean{i}"]))
            self.label_stds.append(np.asarray(d[f"label_std{i}"]))
            i += 1
        self._fit_label = bool(self.label_means)


class MultiNormalizerMinMaxScaler:
    """Per-input min/max scaling of MultiDataSets."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.mins: list = []
        self.maxs: list = []

    def fit(self, data):
        accs: list = []
        first = True
        for mds in _multi_batches(data):
            if first:
                accs = [_RunningMinMax() for _ in mds.features]
                first = False
            _check_arity(len(mds.features), len(accs), "feature")
            for a, x in zip(accs, mds.features):
                a.add(to_numpy(x))
        if first:
            raise ValueError("fit() saw no data")
        self.mins, self.maxs = map(list, zip(*[a.finalize() for a in accs]))

    def transform(self, mds):
        if not self.mins:
            raise ValueError("MultiNormalizerMinMaxScaler not fitted: call "
                             "fit() first")
        _check_arity(len(mds.features), len(self.mins), "feature")
        mds.features = [_min_max(x, mn, mx, self.min_range, self.max_range)
                        for x, mn, mx in zip(mds.features, self.mins,
                                             self.maxs)]
        return mds

    def preProcess(self, mds):
        return self.transform(mds)

    def state_dict(self) -> dict:
        d = {"range": np.asarray([self.min_range, self.max_range])}
        for i, (mn, mx) in enumerate(zip(self.mins, self.maxs)):
            d[f"min{i}"] = mn
            d[f"max{i}"] = mx
        return d

    def load_state_dict(self, d: dict) -> None:
        self.min_range, self.max_range = (float(v) for v in d["range"])
        self.mins, self.maxs = [], []
        i = 0
        while f"min{i}" in d:
            self.mins.append(np.asarray(d[f"min{i}"]))
            self.maxs.append(np.asarray(d[f"max{i}"]))
            i += 1


class VGG16ImagePreProcessor(DataNormalization):
    """The ImageNet per-channel pixel means subtracted (RGB, NHWC)."""

    MEANS = np.array([123.68, 116.779, 103.939], np.float32)

    def fit(self, data):
        pass  # stateless

    def transform(self, ds: DataSet) -> DataSet:
        x = _tensor(ds.features).to(torch.float32)
        ds.features = x - _on(self.MEANS, x)
        return ds

    def revert(self, ds: DataSet) -> DataSet:
        x = _tensor(ds.features)
        ds.features = x + _on(self.MEANS, x)
        return ds

    def state_dict(self):
        return {}

    def load_state_dict(self, d):
        pass


class CompositeDataSetPreProcessor(DataNormalization):
    """Preprocessors in sequence. ``fit`` fits each child on the data as
    the children before it transform it, from one materialised pass over
    the source."""

    def __init__(self, *preprocessors: DataNormalization):
        self.preprocessors = list(preprocessors)

    def fit(self, data):
        batches = [data] if isinstance(data, DataSet) else list(data)
        for p in self.preprocessors:
            p.fit(batches[0] if len(batches) == 1 else batches)
            batches = [p.transform(DataSet(
                np.array(to_numpy(b.features)), np.array(to_numpy(b.labels)),
                b.features_mask, b.labels_mask)) for b in batches]

    def transform(self, ds: DataSet) -> DataSet:
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def state_dict(self):
        return {f"p{i}": p.state_dict()
                for i, p in enumerate(self.preprocessors)}

    def load_state_dict(self, d):
        for i, p in enumerate(self.preprocessors):
            p.load_state_dict(d[f"p{i}"])


class ImagePreProcessingScaler(DataNormalization):
    """Pixels in [0, max_pixel] to [min_range, max_range], in f32."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def fit(self, data):
        pass  # stateless

    def transform(self, ds: DataSet) -> DataSet:
        x = _tensor(ds.features).to(torch.float32) / self.max_pixel
        ds.features = x * (self.max_range - self.min_range) + self.min_range
        return ds

    def state_dict(self):
        return {"range": np.asarray([self.min_range, self.max_range,
                                     self.max_pixel])}

    def load_state_dict(self, d):
        self.min_range, self.max_range, self.max_pixel = (
            float(v) for v in d["range"])


__all__ = ["DataNormalization", "NormalizerStandardize",
           "NormalizerMinMaxScaler", "MultiNormalizerStandardize",
           "MultiNormalizerMinMaxScaler", "VGG16ImagePreProcessor",
           "CompositeDataSetPreProcessor", "ImagePreProcessingScaler"]
