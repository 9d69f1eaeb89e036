"""Evaluation: counterpart of ``deeplearning4j_tpu/evaluation/__init__.py``
(``Evaluation``, ``EvaluationBinary``, ``ROC`` with ``RocCurve`` and
``PrecisionRecallCurve``, ``RegressionEvaluation``, ``ROCBinary``,
``ROCMultiClass``, ``EvaluationCalibration``).

``eval(labels, predictions, mask)`` accumulates on the predictions'
device: counts as int64 tensors added with ``index_add_`` into a spare
bin for masked entries, scores kept as tensors with their masks, so a
batch costs no copy to the host and no wait for the card. Everything
moves to the host once, when a metric is read, and the metric is the
JAX class's numpy formula on it: counts equal the JAX package's exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import to_numpy
from deeplearning4j_tpu_torch.ndarray.ndarray import _unwrap
from deeplearning4j_tpu_torch.params import numpy_to_tensor


def _tensor(a, device=None) -> torch.Tensor:
    """``a`` (numpy, an NDArray or a tensor) as a tensor on ``device``
    (default: where it is)."""
    a = _unwrap(a)
    t = a if torch.is_tensor(a) else numpy_to_tensor(np.asarray(a))
    return t if device is None else t.to(device)


def _sink(idx: torch.Tensor, keep: Optional[torch.Tensor],
          sink: int) -> torch.Tensor:
    """``idx`` with masked-out rows sent to bin ``sink``."""
    if keep is None:
        return idx
    while keep.dim() < idx.dim():
        keep = keep[..., None]
    return torch.where(keep, idx, torch.full_like(idx, sink))


def _count(total: torch.Tensor, idx: torch.Tensor) -> None:
    total.index_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))


class _Rows:
    """Per-batch rows kept on their device, concatenated on the host on
    first read (``(labels, predictions, keep)`` triples)."""

    def __init__(self):
        self._parts = []
        self._host = None

    def add(self, *arrays) -> None:
        self._parts.append(arrays)
        self._host = None

    def __bool__(self) -> bool:
        return bool(self._parts)

    def host(self):
        """``(labels, predictions)`` as numpy over every batch, without the
        rows a mask dropped."""
        if self._host is None:
            ys, ps = [], []
            for y, p, keep in self._parts:
                if keep is not None:
                    y, p = y[keep], p[keep]
                ys.append(to_numpy(y))
                ps.append(to_numpy(p))
            self._host = (np.concatenate(ys), np.concatenate(ps))
        return self._host


class Evaluation:
    """Multi-class classification evaluation with a confusion matrix."""

    def __init__(self, num_classes: Optional[int] = None, labels_list=None,
                 top_n: int = 1):
        self._n = num_classes
        self._counts: Optional[torch.Tensor] = None   # [n * n + 1]
        self._labels_list = labels_list
        self._top_n = top_n
        self._top_n_correct = None
        self._top_n_total = None
        self._conf_host = None

    def _ensure(self, n, device):
        if self._counts is None:
            self._n = self._n or n
            self._counts = torch.zeros(self._n * self._n + 1,
                                       dtype=torch.int64, device=device)
        elif n > self._n:
            # an integer-label stream showed a higher class id: grow
            old = self._counts[:-1].reshape(self._n, self._n)
            grown = torch.zeros(n, n, dtype=torch.int64, device=device)
            grown[:self._n, :self._n] = old
            self._counts = torch.cat([grown.reshape(-1),
                                      self._counts[-1:]])
            self._n = n

    def eval(self, labels, predictions, mask=None):
        p = _tensor(predictions)
        dev = p.device
        y = _tensor(labels, dev)
        if y.dim() == 3:                    # [N,T,C] -> one row a step
            y = y.reshape(-1, y.shape[-1])
            p = p.reshape(-1, p.shape[-1])
        yi = y.argmax(-1) if y.dim() > 1 else y.long()
        if p.dim() > 1:
            pi = p.argmax(-1)
        elif not p.is_floating_point():
            pi = p.long()                   # class ids already
        else:
            pi = (p > 0.5).long()           # binary probabilities
        if y.dim() > 1:
            n = y.shape[-1]
        else:                               # the one host read: ids
            n = max(int(yi.max()) if yi.numel() else 1, 1,
                    int(pi.max()) if pi.numel() else 1) + 1
        self._ensure(n, dev)
        keep = None if mask is None else _tensor(mask, dev).reshape(-1).bool()
        nn_ = self._n
        _count(self._counts, _sink(yi.reshape(-1) * nn_ + pi.reshape(-1),
                                   keep, nn_ * nn_))
        if self._top_n > 1 and p.dim() > 1:
            p2 = p.reshape(-1, p.shape[-1])
            topk = torch.argsort(-p2, dim=-1, stable=True)[:, :self._top_n]
            hit = (topk == yi.reshape(-1)[:, None]).any(1)
            rows = torch.ones_like(hit) if keep is None else keep
            hits = (hit & rows).sum()
            total = rows.sum()
            if self._top_n_correct is None:
                self._top_n_correct, self._top_n_total = hits, total
            else:
                self._top_n_correct = self._top_n_correct + hits
                self._top_n_total = self._top_n_total + total
        self._conf_host = None

    @property
    def _conf(self) -> Optional[np.ndarray]:
        """The confusion matrix on the host (one copy per read after an
        ``eval``)."""
        if self._counts is None:
            return None
        if self._conf_host is None:
            self._conf_host = (self._counts[:-1].reshape(self._n, self._n)
                               .cpu().numpy())
        return self._conf_host

    def accuracy(self) -> float:
        c = self._conf
        return float(np.trace(c) / max(c.sum(), 1))

    def _tp(self):
        return np.diag(self._conf).astype(np.float64)

    def precision(self, cls: Optional[int] = None) -> float:
        col = self._conf.sum(0).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(col > 0, self._tp() / col, np.nan)
        if cls is not None:
            return float(per[cls])
        return float(np.nanmean(per))

    def recall(self, cls: Optional[int] = None) -> float:
        row = self._conf.sum(1).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(row > 0, self._tp() / row, np.nan)
        if cls is not None:
            return float(per[cls])
        return float(np.nanmean(per))

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 0.0 if p + r == 0 else 2 * p * r / (p + r)

    def falsePositiveRate(self, cls: int) -> float:
        c = self._conf
        fp = c[:, cls].sum() - c[cls, cls]
        tn = c.sum() - c[cls, :].sum() - c[:, cls].sum() + c[cls, cls]
        return float(fp / max(fp + tn, 1))

    def topNAccuracy(self) -> float:
        if self._top_n <= 1:
            return self.accuracy()
        if self._top_n_correct is None:
            return 0.0
        return float(int(self._top_n_correct)
                     / max(int(self._top_n_total), 1))

    def confusionMatrix(self) -> np.ndarray:
        return self._conf.copy()

    def getNumRowCounter(self) -> int:
        return int(self._conf.sum()) if self._counts is not None else 0

    def stats(self) -> str:
        if self._counts is None:
            return "Evaluation: no data"
        return "\n".join([
            "=" * 24 + "Evaluation Metrics" + "=" * 24,
            f" # of classes:    {self._n}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "=" * 25 + "Confusion Matrix" + "=" * 25,
            str(self._conf),
        ])


class EvaluationBinary:
    """Independent binary classification per output column."""

    def __init__(self, threshold: float = 0.5):
        self._t = threshold
        self._dev = None        # [4, n] tp, fp, tn, fn on the device
        self._host = None

    def eval(self, labels, predictions, mask=None):
        p = _tensor(predictions)
        y = _tensor(labels, p.device).bool()
        pb = p >= self._t
        n = y.shape[-1]
        y2, p2 = y.reshape(-1, n), pb.reshape(-1, n)
        if mask is not None:
            keep = _tensor(mask, p.device).reshape(-1).bool()[:, None]
            y2, p2 = y2 & keep, p2 & keep
            neg = keep
        else:
            neg = torch.ones_like(y2)
        counts = torch.stack([(y2 & p2).sum(0), (~y2 & p2 & neg).sum(0),
                              (~y2 & ~p2 & neg).sum(0),
                              (y2 & ~p2).sum(0)])
        self._dev = counts if self._dev is None else self._dev + counts
        self._host = None

    def _counts(self):
        if self._host is None:
            self._host = self._dev.cpu().numpy()
        return self._host

    @property
    def _tp(self):
        return None if self._dev is None else self._counts()[0]

    @property
    def _fp(self):
        return None if self._dev is None else self._counts()[1]

    @property
    def _tn(self):
        return None if self._dev is None else self._counts()[2]

    @property
    def _fn(self):
        return None if self._dev is None else self._counts()[3]

    def accuracy(self, i: int) -> float:
        tot = self._tp[i] + self._fp[i] + self._tn[i] + self._fn[i]
        return float((self._tp[i] + self._tn[i]) / max(tot, 1))

    def precision(self, i: int) -> float:
        return float(self._tp[i] / max(self._tp[i] + self._fp[i], 1))

    def recall(self, i: int) -> float:
        return float(self._tp[i] / max(self._tp[i] + self._fn[i], 1))

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 0.0 if p + r == 0 else 2 * p * r / (p + r)

    def stats(self) -> str:
        n = len(self._tp) if self._dev is not None else 0
        rows = [f"out {i}: acc={self.accuracy(i):.4f} "
                f"prec={self.precision(i):.4f} rec={self.recall(i):.4f} "
                f"f1={self.f1(i):.4f}" for i in range(n)]
        return "\n".join(["EvaluationBinary:"] + rows)


class ROC:
    """Binary ROC / AUC by an exact threshold sweep (the reference's
    thresholdSteps=0 mode). Like the JAX class it takes no mask."""

    def __init__(self):
        self._rows = _Rows()

    def eval(self, labels, predictions, mask=None):
        p = _tensor(predictions)
        y = _tensor(labels, p.device)
        y = (y.reshape(-1) if y.dim() == 1 or y.shape[-1] == 1
             else y[..., -1].reshape(-1))
        p = (p.reshape(-1) if p.dim() == 1 or p.shape[-1] == 1
             else p[..., -1].reshape(-1))
        self._rows.add(y, p, None)

    def calculateAUC(self) -> float:
        return self.getRocCurve().calculateAUC()

    def calculateAUCPR(self) -> float:
        return self.getPrecisionRecallCurve().calculateAUCPR()

    def _flat(self):
        if not self._rows:
            return np.zeros(0), np.zeros(0)
        return self._rows.host()

    def getRocCurve(self) -> "RocCurve":
        """ROC points at every distinct score, tied scores one point."""
        return _roc_curve_from(*self._flat())

    def getPrecisionRecallCurve(self) -> "PrecisionRecallCurve":
        return _pr_curve_from(*self._flat())


class RocCurve:
    """ROC points (reference: evaluation/curves/RocCurve)."""

    def __init__(self, thresholds, fpr, tpr):
        self.thresholds = np.asarray(thresholds)
        self.fpr = np.asarray(fpr)
        self.tpr = np.asarray(tpr)

    def numPoints(self) -> int:
        return len(self.thresholds)

    def getThreshold(self, i: int) -> float:
        return float(self.thresholds[i])

    def getTruePositiveRate(self, i: int) -> float:
        return float(self.tpr[i])

    def getFalsePositiveRate(self, i: int) -> float:
        return float(self.fpr[i])

    def calculateAUC(self) -> float:
        return float(np.trapezoid(self.tpr, self.fpr))


class PrecisionRecallCurve:
    """PR points (reference: evaluation/curves/PrecisionRecallCurve)."""

    def __init__(self, thresholds, precision, recall):
        self.thresholds = np.asarray(thresholds)
        self.precision = np.asarray(precision)
        self.recall = np.asarray(recall)

    def numPoints(self) -> int:
        return len(self.thresholds)

    def getThreshold(self, i: int) -> float:
        return float(self.thresholds[i])

    def getPrecision(self, i: int) -> float:
        return float(self.precision[i])

    def getRecall(self, i: int) -> float:
        return float(self.recall[i])

    def calculateAUCPR(self) -> float:
        return float(np.trapezoid(self.precision, self.recall))


class RegressionEvaluation:
    """Regression metrics per output column. Like the JAX class it takes
    no mask."""

    def __init__(self):
        self._rows = _Rows()

    def eval(self, labels, predictions, mask=None):
        p = _tensor(predictions)
        y = _tensor(labels, p.device)
        self._rows.add(y.reshape(-1, y.shape[-1]),
                       p.reshape(-1, p.shape[-1]), None)

    def _cat(self):
        return self._rows.host()

    def meanSquaredError(self, col: int = 0) -> float:
        y, p = self._cat()
        return float(np.mean((y[:, col] - p[:, col]) ** 2))

    def meanAbsoluteError(self, col: int = 0) -> float:
        y, p = self._cat()
        return float(np.mean(np.abs(y[:, col] - p[:, col])))

    def rootMeanSquaredError(self, col: int = 0) -> float:
        return float(np.sqrt(self.meanSquaredError(col)))

    def rSquared(self, col: int = 0) -> float:
        y, p = self._cat()
        ss_res = np.sum((y[:, col] - p[:, col]) ** 2)
        ss_tot = np.sum((y[:, col] - y[:, col].mean()) ** 2)
        return float(1.0 - ss_res / max(ss_tot, 1e-12))

    def pearsonCorrelation(self, col: int = 0) -> float:
        y, p = self._cat()
        return float(np.corrcoef(y[:, col], p[:, col])[0, 1])

    def stats(self) -> str:
        y, _ = self._cat()
        rows = [f"col {i}: MSE={self.meanSquaredError(i):.6f} "
                f"MAE={self.meanAbsoluteError(i):.6f} "
                f"RMSE={self.rootMeanSquaredError(i):.6f} "
                f"R^2={self.rSquared(i):.4f}" for i in range(y.shape[1])]
        return "\n".join(["RegressionEvaluation:"] + rows)


def _auc_from_scores(y: np.ndarray, s: np.ndarray) -> float:
    """Tie-collapsed ROC area (the same answer for tied scores in any
    order)."""
    return _roc_curve_from(y, s).calculateAUC()


def _tie_collapsed(y: np.ndarray, s: np.ndarray):
    """Descending-score order with tied scores one operating point:
    (thresholds, tps, fps, n_pred, P, N)."""
    order = np.argsort(-s, kind="stable")
    y, s = y[order].astype(np.float64), s[order]
    if len(s) == 0:
        z = np.zeros(0)
        return z, z, z, z, 0.0, 0.0
    last = np.concatenate([s[1:] != s[:-1], [True]])
    tps = np.cumsum(y)[last]
    fps = np.cumsum(1.0 - y)[last]
    n_pred = (np.arange(len(y)) + 1.0)[last]
    return s[last], tps, fps, n_pred, float(y.sum()), float((1 - y).sum())


def _roc_curve_from(y: np.ndarray, s: np.ndarray) -> RocCurve:
    th, tps, fps, _, P, N = _tie_collapsed(y, s)
    if len(th) == 0:
        return RocCurve([np.inf], [0.0], [0.0])
    P, N = max(P, 1e-12), max(N, 1e-12)
    return RocCurve(np.concatenate([[np.inf], th]),
                    np.concatenate([[0.0], fps / N]),
                    np.concatenate([[0.0], tps / P]))


def _pr_curve_from(y: np.ndarray, s: np.ndarray) -> PrecisionRecallCurve:
    th, tps, _, n_pred, P, _ = _tie_collapsed(y, s)
    if len(th) == 0:
        return PrecisionRecallCurve([np.inf], [1.0], [0.0])
    prec = tps / n_pred
    # the recall-0 anchor at the first point's precision
    return PrecisionRecallCurve(
        np.concatenate([[np.inf], th]),
        np.concatenate([[prec[0]], prec]),
        np.concatenate([[0.0], tps / max(P, 1e-12)]))


class _PerColumnROC:
    """Shared by ROCBinary and ROCMultiClass: masked rows kept on the
    device, one-vs-rest AUC per column on the host."""

    def __init__(self):
        self._rows = _Rows()

    def eval(self, labels, predictions, mask=None):
        p = _tensor(predictions)
        y = _tensor(labels, p.device)
        y = y.reshape(-1, y.shape[-1])
        p = p.reshape(-1, p.shape[-1])
        keep = (None if mask is None
                else _tensor(mask, p.device).reshape(-1).bool())
        self._rows.add(y, p, keep)

    def _columns(self) -> int:
        return self._rows._parts[0][0].shape[1] if self._rows else 0

    def calculateAUC(self, col: int) -> float:
        y, s = self._rows.host()
        return _auc_from_scores(y[:, col], s[:, col])

    def calculateAverageAUC(self) -> float:
        return float(np.mean([self.calculateAUC(i)
                              for i in range(self._columns())]))


class ROCBinary(_PerColumnROC):
    """Per-output-column ROC for multi-label binary outputs."""

    def numLabels(self) -> int:
        return self._columns()

    def stats(self) -> str:
        rows = [f"out {i}: AUC={self.calculateAUC(i):.4f}"
                for i in range(self.numLabels())]
        return "\n".join(["ROCBinary:"] + rows)


class ROCMultiClass(_PerColumnROC):
    """One-vs-all ROC per class for softmax outputs."""

    def numClasses(self) -> int:
        return self._columns()

    def stats(self) -> str:
        rows = [f"class {i}: AUC={self.calculateAUC(i):.4f}"
                for i in range(self.numClasses())]
        return "\n".join(["ROCMultiClass:"] + rows)


class EvaluationCalibration:
    """Probability calibration: reliability-diagram bins, label and
    prediction counts per class, and the residual histogram."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self._rb = reliability_bins
        self._hb = histogram_bins
        self._dev = None
        self._host = None

    def _ensure(self, c, device):
        if self._dev is None:
            f64 = dict(dtype=torch.float64, device=device)
            i64 = dict(dtype=torch.int64, device=device)
            rb, hb = self._rb, self._hb
            self._dev = {
                # each with a spare last bin for masked rows
                "counts": torch.zeros(c * rb + 1, **i64),
                "pos": torch.zeros(c * rb, **f64),
                "prob_sum": torch.zeros(c * rb, **f64),
                "label_counts": torch.zeros(c, **i64),
                "pred_counts": torch.zeros(c + 1, **i64),
                "residual": torch.zeros(hb + 1, **i64),
            }

    def eval(self, labels, predictions, mask=None):
        p = _tensor(predictions)
        dev = p.device
        y = _tensor(labels, dev)
        y = y.reshape(-1, y.shape[-1])
        p = p.reshape(-1, p.shape[-1])
        keep = None if mask is None else _tensor(mask, dev).reshape(-1).bool()
        c, rb, hb = y.shape[1], self._rb, self._hb
        self._ensure(c, dev)
        d = self._dev
        bins = torch.clamp((p * rb).long(), 0, rb - 1)
        flat = bins + torch.arange(c, device=dev) * rb
        _count(d["counts"], _sink(flat, keep, c * rb))
        w = 1.0 if keep is None else keep[:, None].double()
        d["pos"].index_add_(0, flat.reshape(-1),
                            (y.double() * w).reshape(-1))
        d["prob_sum"].index_add_(0, flat.reshape(-1),
                                 (p.double() * w).reshape(-1))
        yl = y.long()
        d["label_counts"] += (yl if keep is None
                              else yl * keep[:, None].long()).sum(0)
        _count(d["pred_counts"], _sink(p.argmax(1), keep, c))
        resid = torch.abs(y - p)
        rbin = torch.clamp((resid * hb).long(), 0, hb - 1)
        _count(d["residual"], _sink(rbin, keep, hb))
        self._host = None

    def _h(self) -> dict:
        if self._host is None:
            c, rb = self._dev["label_counts"].shape[0], self._rb
            d = {k: v.cpu().numpy() for k, v in self._dev.items()}
            self._host = {
                "counts": d["counts"][:-1].reshape(c, rb).astype(np.float64),
                "pos": d["pos"].reshape(c, rb),
                "prob_sum": d["prob_sum"].reshape(c, rb),
                "label_counts": d["label_counts"],
                "pred_counts": d["pred_counts"][:-1],
                "residual": d["residual"][:-1],
            }
        return self._host

    def getReliabilityInfo(self, cls: int):
        """(mean predicted probability, fraction positive, count) per
        bin: the reliability-diagram curve."""
        h = self._h()
        cnt = h["counts"][cls]
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_p = np.where(cnt > 0, h["prob_sum"][cls] / cnt, np.nan)
            frac_pos = np.where(cnt > 0, h["pos"][cls] / cnt, np.nan)
        return mean_p, frac_pos, cnt.astype(np.int64)

    def expectedCalibrationError(self, cls: int) -> float:
        mean_p, frac_pos, cnt = self.getReliabilityInfo(cls)
        ok = cnt > 0
        w = cnt[ok] / cnt.sum()
        return float(np.sum(w * np.abs(mean_p[ok] - frac_pos[ok])))

    def getLabelCountsEachClass(self) -> np.ndarray:
        return self._h()["label_counts"].copy()

    def getPredictionCountsEachClass(self) -> np.ndarray:
        return self._h()["pred_counts"].copy()

    def getResidualPlotAllClasses(self) -> np.ndarray:
        return self._h()["residual"].copy()

    def stats(self) -> str:
        if self._dev is None:
            return "EvaluationCalibration:"
        lc, pc = self._h()["label_counts"], self._h()["pred_counts"]
        rows = [f"class {i}: ECE={self.expectedCalibrationError(i):.4f} "
                f"labels={lc[i]} preds={pc[i]}" for i in range(len(lc))]
        return "\n".join(["EvaluationCalibration:"] + rows)


__all__ = ["Evaluation", "EvaluationBinary", "ROC", "ROCBinary",
           "ROCMultiClass", "RegressionEvaluation", "EvaluationCalibration",
           "RocCurve", "PrecisionRecallCurve"]
