"""PyTorch port, device prefetch: ``deeplearning4j_tpu_torch.datasets.
device_prefetch`` against the JAX package's ``DevicePrefetchIterator`` and
``BatchShapePolicy`` on the same numpy batches.

- depth 0 and depth 2 yield the underlying iterator's batches exactly,
  over epochs and a state restore, and report the JAX prefetcher's state;
- ``pad_last`` and ``bucket`` pad exactly as JAX does, and the padded
  batch's loss equals the unpadded one's within 1e-6 relative (LeNet for
  the rows, a char-LSTM for time buckets: the labels-mask scale cancels
  the padded divisor);
- an exception in the underlying iterator is raised by the consumer's
  ``next()``; ``mesh=`` raises naming A8, the retry policy naming A9;
  no thread outlives ``shutdown()`` (``test_torch_port_rules.py`` checks
  that without a card it refuses to run unless given ``device="cpu"``).

The cuda-marked test at the end moves uint8 batches to the card through
the pinned ring and casts them there, against the CPU
(``python -m pytest --noconftest -m cuda tests/test_torch_prefetch.py``).
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (
    ArrayDataSetIterator, ArrayMultiDataSetIterator, BatchShapePolicy,
    DataSet, DevicePrefetchIterator, DevicePrefetchMultiIterator)

LOSS_RTOL = 1e-6
THREADS = ("DevicePrefetch-transfer", "AsyncDataSet-ETL")


def _np(a):
    if a is None:
        return None
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy() \
            if a.dtype == torch.bfloat16 else a.detach().cpu().numpy()
    return np.asarray(a)


def _same(got, want):
    for k in ("features", "labels", "features_mask", "labels_mask"):
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if w is not None:
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=k)


def _alive():
    return [t.name for t in threading.enumerate()
            if t.name in THREADS and t.is_alive()]


def _data(n=22, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 6, 6, 1).astype(np.float32),
            np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])


class _Failing(ArrayDataSetIterator):
    """Raises on its third batch."""

    def next(self):
        if self._i >= 2 * self._bs:
            raise OSError("disk gone")
        return super().next()


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_yields_the_underlying_batches(depth):
    x, y = _data()
    it = DevicePrefetchIterator(ArrayDataSetIterator(x, y, 5, shuffle=True),
                                depth=depth, device="cpu")
    ref = ArrayDataSetIterator(x, y, 5, shuffle=True)
    for _ in range(3):
        got, want = list(it), list(ref)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert torch.is_tensor(g.features)
            _same(g, w)
    assert it.batch() == 5 and it.resetSupported()
    if depth:
        assert it.transfer_overlap_batches == 15
        assert it.transfer_overlap_ms_total >= 0.0
    assert it.copy_ms() == []          # the CPU has no copy events
    it.shutdown()
    assert not _alive()


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_state_resumes_like_jax(depth):
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JA
    from deeplearning4j_tpu.datasets import DevicePrefetchIterator as JP

    x, y = _data()
    t = DevicePrefetchIterator(ArrayDataSetIterator(x, y, 4, shuffle=True),
                               depth=depth, device="cpu")
    j = JP(JA(x, y, 4, shuffle=True), depth=depth)
    for it in (t, j):
        it.reset()
        it.next()
        it.next()
    assert t.get_state() == j.get_state()
    t2 = DevicePrefetchIterator(ArrayDataSetIterator(x, y, 4, shuffle=True),
                                depth=depth, device="cpu")
    t2.set_state(t.get_state())
    rest = ArrayDataSetIterator(x, y, 4, shuffle=True)
    rest.set_state(t.get_state()["underlying"])
    while rest.hasNext():
        _same(t2.next(), rest.next())
    assert not t2.hasNext()
    for it in (t, t2, j):
        it.shutdown()
    assert not _alive()


@pytest.mark.parametrize("mode", ["pad_last", "bucket"])
def test_policy_pads_like_jax(mode):
    from deeplearning4j_tpu.datasets import DataSet as JD
    from deeplearning4j_tpu.datasets import multi_dataset as jm
    from deeplearning4j_tpu.datasets.device_prefetch import (
        BatchShapePolicy as JPolicy)
    from deeplearning4j_tpu_torch.datasets import MultiDataSet

    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, 2).astype(np.float32)
    y = rs.randn(3, 5, 4).astype(np.float32)
    fm = np.ones((3, 5), np.float32)
    fm[0, 3:] = 0
    cases = [(x, y, fm, None), (x, y, None, np.ones(3, np.float32)),
             (x[:, 0], y[:, 0], None, None)]
    for args in cases:
        t = BatchShapePolicy(mode, batch_size=8).apply(DataSet(*args))
        w = JPolicy(mode, batch_size=8).apply(JD(*args))
        _same(t, w)
    tm = BatchShapePolicy(mode, batch_size=4).apply(MultiDataSet([x], [y]))
    wm = JPolicy(mode, batch_size=4).apply(jm.MultiDataSet([x], [y]))
    for g, w in zip(tm.features + tm.labels + tm.labels_mask_arrays,
                    wm.features + wm.labels + wm.labels_mask_arrays):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert BatchShapePolicy("bucket", seq_buckets=[4, 12]).bucket_t(5) == 12
    with pytest.raises(ValueError, match="unknown"):
        BatchShapePolicy("ragged")


def _lenet():
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.zoo import LeNet

    return LeNet(num_classes=3, in_shape=(6, 6, 1),
                 updater=Sgd(0.1)).init(device="cpu")


@pytest.mark.parametrize("mode", ["pad_last", "bucket"])
def test_padded_rows_keep_the_unpadded_loss(mode):
    """LeNet: the last batch of 22 (2 rows) padded to 5 has the loss of
    its 2 rows alone, and the counters see 3 padded rows (images have no
    time axis: ``bucket`` pads the rows as ``pad_last`` does)."""
    x, y = _data()
    net = _lenet()
    it = DevicePrefetchIterator(ArrayDataSetIterator(x, y, 5),
                                policy=BatchShapePolicy(mode),
                                device="cpu")
    batches = list(it)
    assert [b.features.shape[0] for b in batches] == [5] * 5
    assert it.padded_examples_total == 3
    for got, (lo, hi) in zip(batches, [(0, 5), (5, 10), (10, 15),
                                       (15, 20), (20, 22)]):
        want = net.score(DataSet(x[lo:hi], y[lo:hi]))
        assert abs(net.score(got) - want) <= LOSS_RTOL * abs(want)
    it.shutdown()


def test_time_buckets_keep_the_unpadded_loss():
    """``bucket``: 13 steps padded to 16, 3 rows to 4; a per-timestep
    sum-reduced loss (MCXENT) is that of the real steps and rows."""
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(vocab_size=5, hidden=6).init(device="cpu")
    rng = np.random.default_rng(3)
    eye = np.eye(5, dtype=np.float32)
    ids = rng.integers(0, 5, (3, 13))
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, 1)])
    policy = BatchShapePolicy("bucket", batch_size=4)
    padded = policy.apply(ds)
    assert padded.features.shape == (4, 16, 5)
    assert policy.bucket_misses_total == 1
    policy.apply(ds)
    assert policy.bucket_hits_total == 1
    want = net.score(ds)
    assert abs(net.score(padded) - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("depth", [0, 2])
def test_errors_in_the_pipeline_reach_next(depth):
    x, y = _data()
    it = DevicePrefetchIterator(_Failing(x, y, 4), depth=depth, device="cpu")
    it.reset()
    it.next()
    it.next()
    with pytest.raises(OSError, match="disk gone"):
        it.next()
    it.shutdown()
    assert not _alive()


def test_unported_options_raise_and_threads_end():
    x, y = _data()
    base = ArrayDataSetIterator(x, y, 4)
    with pytest.raises(NotImplementedError, match="A8"):
        DevicePrefetchIterator(base, mesh=object(), device="cpu")
    for kw in (dict(transfer_retries=2), dict(quarantine=True)):
        with pytest.raises(NotImplementedError, match="A9"):
            DevicePrefetchIterator(base, device="cpu", **kw)
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetchIterator(base, depth=-1, device="cpu")
    with DevicePrefetchIterator(base, device="cpu") as it:
        it.reset()
        it.next()               # both threads running, the epoch unfinished
        assert _alive()
    assert not _alive()
    it.reset()                  # reopens after shutdown
    assert len(list(it)) == 6
    it.shutdown()
    assert not _alive()


def test_multi_variant_and_dtype():
    x, y = _data(9)
    multi = DevicePrefetchIterator(ArrayMultiDataSetIterator([x], [y], 4),
                                   device="cpu", dtype=torch.bfloat16)
    assert isinstance(multi, DevicePrefetchMultiIterator)
    got = list(multi)
    assert [g.features[0].dtype for g in got] == [torch.bfloat16] * 3
    assert got[0].labels[0].dtype == torch.float32
    np.testing.assert_array_equal(
        _np(got[0].features[0]),
        torch.from_numpy(x[:4]).to(torch.bfloat16).float().numpy())
    multi.shutdown()
    assert not _alive()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
def test_uint8_batches_cast_on_the_card(depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rs = np.random.RandomState(5)
    x = rs.randint(0, 256, (20, 8, 8, 3)).astype(np.uint8)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 20)]
    it = DevicePrefetchIterator(ArrayDataSetIterator(x, y, 6), depth=depth,
                                dtype=torch.bfloat16)
    for _ in range(2):
        got = list(it)
        assert len(got) == 4
        for g, lo in zip(got, range(0, 20, 6)):
            assert g.features.device.type == "cuda"
            assert g.features.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                _np(g.features), x[lo:lo + 6].astype(np.float32))
            np.testing.assert_array_equal(_np(g.labels), y[lo:lo + 6])
    assert len(it.copy_ms()) == 8 and min(it.copy_ms()) > 0
    assert all(r >= c for r, c in zip(it.ready_ms(), it.copy_ms()))
    it.shutdown()
    assert not _alive()
