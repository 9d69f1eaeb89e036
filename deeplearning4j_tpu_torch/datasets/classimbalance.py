"""Class-imbalance preprocessors: counterpart of
``deeplearning4j_tpu/datasets/classimbalance.py``.

``UnderSamplingByMaskingPreProcessor`` edits the labels mask of binary
time-series labels ([B, T, 1] sigmoid or [B, T, 2] one-hot) so that in
each window of ``window_length`` steps the expected share of minority
steps among the unmasked ones is ``target_minority_dist``: minority
steps are always kept, majority steps kept with the probability that
gives the target, and (by default) windows with no minority step masked
whole. The multi variant applies it to chosen label arrays of a
MultiDataSet. Host numpy work on the ETL path, with the JAX class's
random draws (``np.random.default_rng(seed)``); the mask comes back as
numpy.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, to_numpy


class UnderSamplingByMaskingPreProcessor:
    """``preProcess(ds)`` rewrites ``ds.labels_mask`` in place.

    target_minority_dist: desired share of minority timesteps among
    the UNMASKED ones in each window. window_length: the tbptt window
    the reference balances over. minority_label: which class index is
    the minority (default 1, the reference's default)."""

    def __init__(self, target_minority_dist: float, window_length: int,
                 minority_label: int = 1, seed: int = 0,
                 mask_all_majority_windows: bool = True):
        if not 0.0 < target_minority_dist <= 0.5:
            raise ValueError(
                "target_minority_dist must be in (0, 0.5] — under-"
                "sampling raises the minority share toward one half")
        if window_length < 1:
            raise ValueError("window_length must be >= 1")
        if minority_label not in (0, 1):
            raise ValueError("minority_label must be 0 or 1 (binary)")
        self.target = float(target_minority_dist)
        self.window = int(window_length)
        self.minority_label = minority_label
        self.mask_all_majority_windows = mask_all_majority_windows
        self._rng = np.random.default_rng(seed)

    # -- core ----------------------------------------------------------
    def _is_minority(self, labels: np.ndarray) -> np.ndarray:
        """[B,T] bool from [B,T,1] sigmoid or [B,T,2] one-hot labels."""
        if labels.ndim != 3 or labels.shape[-1] not in (1, 2):
            raise ValueError(
                "labels must be [B, T, 1] or [B, T, 2] binary time "
                f"series, got shape {labels.shape}")
        if labels.shape[-1] == 1:
            cls = labels[..., 0] > 0.5
            return cls if self.minority_label == 1 else ~cls
        return labels[..., self.minority_label] > 0.5

    def adjusted_mask(self, labels, labels_mask=None) -> np.ndarray:
        """Return the new [B,T] labels mask."""
        labels = to_numpy(labels)
        minority = self._is_minority(labels)
        B, T = minority.shape
        mask = np.ones((B, T), np.float32) if labels_mask is None \
            else to_numpy(labels_mask).astype(np.float32)
        t = self.target
        for lo in range(0, T, self.window):
            hi = min(lo + self.window, T)
            w_min = minority[:, lo:hi] & (mask[:, lo:hi] > 0)
            w_maj = ~minority[:, lo:hi] & (mask[:, lo:hi] > 0)
            m = w_min.sum(1).astype(np.float64)      # [B]
            j = w_maj.sum(1).astype(np.float64)
            # keep-probability per example: expected kept majority
            # j' = m(1-t)/t  ->  p = m(1-t) / (t*j)
            with np.errstate(divide="ignore", invalid="ignore"):
                p = np.where(j > 0, m * (1 - t) / (t * j), 0.0)
            p = np.clip(p, 0.0, 1.0)
            keep = self._rng.random((B, hi - lo)) < p[:, None]
            drop = w_maj & ~keep
            if not self.mask_all_majority_windows:
                # windows with no minority stay fully unmasked
                drop &= (m > 0)[:, None]
            mask[:, lo:hi][drop] = 0.0
        return mask

    def preProcess(self, ds: DataSet) -> DataSet:
        ds.labels_mask = self.adjusted_mask(ds.labels, ds.labels_mask)
        return ds


class UnderSamplingByMaskingMultiDataSetPreProcessor:
    """Apply the masking under-sampler to selected label arrays of a
    MultiDataSet (reference:
    UnderSamplingByMaskingMultiDataSetPreProcessor — constructed with
    the same knobs plus the label-array indices to balance)."""

    def __init__(self, target_minority_dist: float, window_length: int,
                 label_indices: Optional[List[int]] = None,
                 minority_label: int = 1, seed: int = 0,
                 mask_all_majority_windows: bool = True):
        self._inner = UnderSamplingByMaskingPreProcessor(
            target_minority_dist, window_length,
            minority_label=minority_label, seed=seed,
            mask_all_majority_windows=mask_all_majority_windows)
        self.label_indices = label_indices

    def preProcess(self, mds) -> "object":
        idxs = self.label_indices if self.label_indices is not None \
            else range(len(mds.labels))
        masks = list(mds.labels_mask_arrays) \
            if mds.labels_mask_arrays else [None] * len(mds.labels)
        while len(masks) < len(mds.labels):
            masks.append(None)
        for i in idxs:
            masks[i] = self._inner.adjusted_mask(
                to_numpy(mds.labels[i]), masks[i])
        mds.labels_mask_arrays = masks
        return mds


__all__ = ["UnderSamplingByMaskingPreProcessor",
           "UnderSamplingByMaskingMultiDataSetPreProcessor"]
