"""PyTorch port, evaluation: ``deeplearning4j_tpu_torch.evaluation``
against the JAX package's classes on the same numpy labels, predictions
and masks, fed in several batches.

Tolerances: counts exact (confusion matrices, binary counts, calibration
bins, label and prediction counts, the residual histogram); derived
floats (accuracy, precision, recall, F1, AUC, AUCPR, the curves,
regression metrics, calibration error) within 1e-6. The running counts
stay on the predictions' device until a metric is read.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import evaluation as te

FLOAT_TOL = 1e-6


def _jax():
    from deeplearning4j_tpu import evaluation as je
    return je


def _batches(seed, n=40, c=5, t=None, batches=3, masked=True):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        shape = (n, c) if t is None else (n, t, c)
        y = np.eye(c, dtype=np.float32)[rs.randint(0, c, shape[:-1])]
        p = rs.rand(*shape).astype(np.float32)
        p /= p.sum(-1, keepdims=True)
        m = ((rs.rand(*shape[:-1]) > 0.2).astype(np.float32)
             if masked else None)
        out.append((y, p, m))
    return out


def _feed(t, j, batches):
    for y, p, m in batches:
        t.eval(y, torch.from_numpy(p), mask=m)
        j.eval(y, p, mask=m)


def _num(a, b, what):
    if np.isnan(b):
        assert np.isnan(a), what
    else:
        assert abs(a - b) <= FLOAT_TOL, (what, a, b)


@pytest.mark.parametrize("t", [None, 4], ids=["2d", "time"])
@pytest.mark.parametrize("masked", [False, True])
def test_evaluation_counts_match_jax(masked, t):
    je = _jax()
    tv, jv = te.Evaluation(top_n=2), je.Evaluation(top_n=2)
    _feed(tv, jv, _batches(1, t=t, masked=masked))
    np.testing.assert_array_equal(tv.confusionMatrix(), jv.confusionMatrix())
    assert tv.getNumRowCounter() == jv.getNumRowCounter()
    assert tv._counts.device == torch.device("cpu")
    for name in ("accuracy", "precision", "recall", "f1", "topNAccuracy"):
        _num(getattr(tv, name)(), getattr(jv, name)(), name)
    for c in range(5):
        for name in ("precision", "recall", "f1", "falsePositiveRate"):
            _num(getattr(tv, name)(c), getattr(jv, name)(c), f"{name} {c}")
    assert tv.stats() == jv.stats()


def test_evaluation_of_class_ids_and_probabilities_matches_jax():
    je = _jax()
    rs = np.random.RandomState(2)
    ids, pids = rs.randint(0, 3, 30), rs.randint(0, 5, 30)
    tv, jv = te.Evaluation(), je.Evaluation()
    for sl in (slice(0, 10), slice(10, 30)):   # the second batch grows it
        tv.eval(ids[sl], torch.from_numpy(pids[sl]))
        jv.eval(ids[sl], pids[sl])
    np.testing.assert_array_equal(tv.confusionMatrix(), jv.confusionMatrix())
    bin_y, bin_p = rs.randint(0, 2, 25), rs.rand(25).astype(np.float32)
    tv, jv = te.Evaluation(), je.Evaluation()
    tv.eval(bin_y, bin_p)
    jv.eval(bin_y, bin_p)
    np.testing.assert_array_equal(tv.confusionMatrix(), jv.confusionMatrix())
    assert te.Evaluation().stats() == je.Evaluation().stats()


def test_binary_evaluation_matches_jax():
    je = _jax()
    rs = np.random.RandomState(3)
    tv, jv = te.EvaluationBinary(0.4), je.EvaluationBinary(0.4)
    for _ in range(3):
        y = (rs.rand(20, 3) > 0.5).astype(np.float32)
        p = rs.rand(20, 3).astype(np.float32)
        m = (rs.rand(20) > 0.3).astype(np.float32)
        tv.eval(y, torch.from_numpy(p), m)
        jv.eval(y, p, m)
    for k in ("_tp", "_fp", "_tn", "_fn"):
        np.testing.assert_array_equal(getattr(tv, k), getattr(jv, k))
    assert tv.stats() == jv.stats()


def test_roc_matches_jax():
    je = _jax()
    rs = np.random.RandomState(4)
    tv, jv = te.ROC(), je.ROC()
    for _ in range(3):
        y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 30)]
        # rounded scores: tied operating points
        p = np.round(rs.rand(30, 2), 1).astype(np.float32)
        tv.eval(y, torch.from_numpy(p))
        jv.eval(y, p)
    _num(tv.calculateAUC(), jv.calculateAUC(), "AUC")
    _num(tv.calculateAUCPR(), jv.calculateAUCPR(), "AUCPR")
    for tc, jc in ((tv.getRocCurve(), jv.getRocCurve()),
                   (tv.getPrecisionRecallCurve(),
                    jv.getPrecisionRecallCurve())):
        assert tc.numPoints() == jc.numPoints()
        for k in vars(jc):
            np.testing.assert_allclose(getattr(tc, k), getattr(jc, k),
                                       atol=FLOAT_TOL, rtol=0)
    _num(te.ROC().calculateAUC(), je.ROC().calculateAUC(), "empty")


def test_per_column_rocs_match_jax():
    je = _jax()
    for tcls, jcls, count in ((te.ROCBinary, je.ROCBinary, "numLabels"),
                              (te.ROCMultiClass, je.ROCMultiClass,
                               "numClasses")):
        tv, jv = tcls(), jcls()
        _feed(tv, jv, _batches(5, c=3))
        assert getattr(tv, count)() == getattr(jv, count)() == 3
        for c in range(3):
            _num(tv.calculateAUC(c), jv.calculateAUC(c), f"AUC {c}")
        _num(tv.calculateAverageAUC(), jv.calculateAverageAUC(), "average")
        assert tv.stats() == jv.stats()


def test_regression_evaluation_matches_jax():
    je = _jax()
    rs = np.random.RandomState(6)
    tv, jv = te.RegressionEvaluation(), je.RegressionEvaluation()
    for _ in range(3):
        y = rs.randn(15, 2).astype(np.float32)
        p = (y + 0.3 * rs.randn(15, 2)).astype(np.float32)
        tv.eval(y, torch.from_numpy(p))
        jv.eval(y, p)
    for c in range(2):
        for name in ("meanSquaredError", "meanAbsoluteError",
                     "rootMeanSquaredError", "rSquared",
                     "pearsonCorrelation"):
            _num(getattr(tv, name)(c), getattr(jv, name)(c), f"{name} {c}")
    assert tv.stats() == jv.stats()


def test_calibration_matches_jax():
    je = _jax()
    tv = te.EvaluationCalibration(reliability_bins=7, histogram_bins=11)
    jv = je.EvaluationCalibration(reliability_bins=7, histogram_bins=11)
    _feed(tv, jv, _batches(7, c=4))
    for name in ("getLabelCountsEachClass", "getPredictionCountsEachClass",
                 "getResidualPlotAllClasses"):
        np.testing.assert_array_equal(getattr(tv, name)(),
                                      getattr(jv, name)())
    for c in range(4):
        for a, b in zip(tv.getReliabilityInfo(c), jv.getReliabilityInfo(c)):
            np.testing.assert_allclose(a, b, atol=FLOAT_TOL, rtol=0)
        _num(tv.expectedCalibrationError(c),
             jv.expectedCalibrationError(c), f"ECE {c}")
    assert tv.stats() == jv.stats()


@pytest.mark.cuda
def test_counts_on_the_card_equal_the_cpus():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    classes = (te.Evaluation, te.EvaluationBinary, te.ROCMultiClass,
               te.EvaluationCalibration)
    for cls in classes:
        card, cpu = cls(), cls()
        for y, p, m in _batches(8, c=4):
            card.eval(torch.from_numpy(y).cuda(), torch.from_numpy(p).cuda(),
                      mask=torch.from_numpy(m).cuda())
            cpu.eval(y, torch.from_numpy(p), mask=m)
        assert card.stats() == cpu.stats(), cls.__name__
