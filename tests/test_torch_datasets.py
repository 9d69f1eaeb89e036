"""PyTorch port, datasets: ``deeplearning4j_tpu_torch.datasets``'s DataSet,
iterators, MultiDataSet, iterator tools, fetchers, the host prefetcher and
the class-imbalance preprocessor against the JAX package's on the same
numpy inputs.

Tolerance: none. Every iterator gives the JAX one's batches exactly, in
the same order (the shuffle is the same ``default_rng(seed + epoch)``),
through resets, epochs, ``drop_last`` and state capture and restore.
The fetchers read synthetic IDX and CIFAR files written under
``tmp_path``; nothing is downloaded.
"""

import gzip
import os
import struct
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (
    ArrayDataSetIterator, ArrayMultiDataSetIterator, AsyncDataSetIterator,
    CachingDataSetIterator, Cifar10DataSetIterator, DataSet,
    EarlyTerminationDataSetIterator, EmnistDataSetIterator,
    ExistingMiniBatchDataSetIterator, IrisDataSetIterator, KFoldIterator,
    ListDataSetIterator, ListMultiDataSetIterator, MnistDataSetIterator,
    MultiDataSet, MultiDataSetIteratorAdapter, MultipleEpochsIterator,
    RecordReaderDataSetIterator, RecordReaderMultiDataSetIterator,
    SamplingDataSetIterator, SequenceRecordReaderDataSetIterator,
    ViewIterator)
from deeplearning4j_tpu_torch.datasets.classimbalance import (
    UnderSamplingByMaskingMultiDataSetPreProcessor,
    UnderSamplingByMaskingPreProcessor)


def _np(a):
    if a is None:
        return None
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _same(got, want):
    """Two DataSets (or MultiDataSets) hold the same arrays."""
    if hasattr(want, "features_mask_arrays"):
        pairs = [(got.features, want.features), (got.labels, want.labels),
                 (got.features_mask_arrays, want.features_mask_arrays),
                 (got.labels_mask_arrays, want.labels_mask_arrays)]
        for g, w in pairs:
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(_np(a), _np(b))
        return
    for k in ("features", "labels", "features_mask", "labels_mask"):
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if w is not None:
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=k)


def _same_stream(tit, jit, epochs=1):
    n = 0
    for _ in range(epochs):
        tb, jb = list(tit), list(jit)
        assert len(tb) == len(jb) > 0
        for g, w in zip(tb, jb):
            _same(g, w)
        n += len(tb)
    return n


def _data(n=23, f=3, c=4, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, f).astype(np.float32),
            np.eye(c, dtype=np.float32)[rs.randint(0, c, n)])


# ------------------------------------------------------------- iterators
@pytest.mark.parametrize("n", [23, 25])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_array_iterator_matches_jax_over_epochs(shuffle, drop_last, n):
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator as J

    x, y = _data(n)
    args = (x, y, 5)
    kw = dict(shuffle=shuffle, seed=7, drop_last=drop_last)
    t, j = ArrayDataSetIterator(*args, **kw), J(*args, **kw)
    _same_stream(t, j, epochs=3)
    assert t.batch() == j.batch() == 5
    assert t.totalExamples() == j.totalExamples() == n


def test_array_iterator_state_resumes_like_jax():
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator as J

    x, y = _data(23)
    t, j = (ArrayDataSetIterator(x, y, 4, shuffle=True, seed=3),
            J(x, y, 4, shuffle=True, seed=3))
    for it in (t, j):
        it.reset()
        it.next()
        it.next()
    assert t.get_state() == j.get_state()
    state = t.get_state()
    t2, j2 = (ArrayDataSetIterator(x, y, 4, shuffle=True, seed=3),
              J(x, y, 4, shuffle=True, seed=3))
    t2.set_state(state)
    j2.set_state(state)
    while j2.hasNext():
        assert t2.hasNext()
        _same(t2.next(), j2.next())
    assert not t2.hasNext()
    with pytest.raises(ValueError, match="out of range"):
        t2.set_state({"i": 99, "epoch": 0})


def test_array_iterator_keeps_tensors_on_their_device():
    x, y = _data(10)
    it = ArrayDataSetIterator(torch.from_numpy(x), torch.from_numpy(y), 4,
                              shuffle=True)
    ref = ArrayDataSetIterator(x, y, 4, shuffle=True)
    for g, w in zip(it, ref):
        assert torch.is_tensor(g.features)
        _same(g, w)


def test_list_iterator_matches_jax():
    from deeplearning4j_tpu.datasets import DataSet as JD
    from deeplearning4j_tpu.datasets import ListDataSetIterator as J

    x, y = _data(12)
    t = ListDataSetIterator([DataSet(x[i:i + 4], y[i:i + 4])
                             for i in range(0, 12, 4)])
    j = J([JD(x[i:i + 4], y[i:i + 4]) for i in range(0, 12, 4)])
    _same_stream(t, j, epochs=2)
    assert t.batch() == j.batch() == 4
    t.reset()
    t.next()
    assert t.get_state() == {"i": 1}
    with pytest.raises(ValueError, match="out of range"):
        t.set_state({"i": 4})


# --------------------------------------------------------------- DataSet
def test_dataset_methods_match_jax(tmp_path):
    from deeplearning4j_tpu.datasets import DataSet as JD

    x, y = _data(9)
    m = (np.arange(9) % 2).astype(np.float32)
    t, j = DataSet(x, y, labels_mask=m), JD(x, y, labels_mask=m)
    assert t.numExamples() == j.numExamples() == 9
    _same(t.sample(4, rng=5), j.sample(4, rng=5))
    for a, b in zip(t.splitTestAndTrain(6), j.splitTestAndTrain(6)):
        _same(a, b)
    _same(DataSet(x, y).shuffle(2), JD(x, y).shuffle(2))
    assert [d.numExamples() for d in t.asList()] == [1] * 9
    merged = DataSet.merge([DataSet(x[:4], y[:4]), DataSet(x[4:], y[4:])])
    _same(merged, JD.merge([JD(x[:4], y[:4]), JD(x[4:], y[4:])]))
    with pytest.raises(ValueError, match="labels_mask"):
        DataSet.merge([DataSet(x, y, labels_mask=m), DataSet(x, y)])
    # files cross over: the port reads the JAX file and the reverse
    pj, pt = str(tmp_path / "j.npz.bin"), str(tmp_path / "t.npz.bin")
    j.save(pj)
    t.save(pt)
    assert os.path.exists(pt)
    _same(DataSet.load(pj), t)
    _same(JD.load(pt), j)


# ------------------------------------------------------------ MultiDataSet
def test_multi_dataset_iterators_match_jax():
    from deeplearning4j_tpu.datasets import multi_dataset as jm
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JA

    x, y = _data(11)
    x2 = x * 2
    t = ArrayMultiDataSetIterator([x, x2], [y], 4)
    j = jm.ArrayMultiDataSetIterator([x, x2], [y], 4)
    _same_stream(t, j, epochs=2)
    lm = np.ones((11, 1), np.float32)
    tm = MultiDataSet([x, x2], [y], None, [lm])
    jmd = jm.MultiDataSet([x, x2], [y], None, [lm])
    assert tm.numExamples() == jmd.numExamples() == 11
    assert tm.numFeatureArrays() == 2 and tm.numLabelsArrays() == 1
    for a, b in zip(tm.splitBatches(5), jmd.splitBatches(5)):
        _same(a, b)
    _same_stream(ListMultiDataSetIterator(tm.splitBatches(5)),
                 jm.ListMultiDataSetIterator(jmd.splitBatches(5)))
    _same_stream(MultiDataSetIteratorAdapter(ArrayDataSetIterator(x, y, 3)),
                 jm.MultiDataSetIteratorAdapter(JA(x, y, 3)))
    _same(MultiDataSet.fromDataSet(DataSet(x, y, labels_mask=lm)),
          jm.MultiDataSet.fromDataSet(_jax_ds(x, y, labels_mask=lm)))


# --------------------------------------------------------- iterator tools
def _jax_ds(x, y, **kw):
    from deeplearning4j_tpu.datasets import DataSet as JD
    return JD(x, y, **kw)


def test_iterator_tools_match_jax(tmp_path):
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JA
    from deeplearning4j_tpu.datasets import iterator_utils as ju

    x, y = _data(17)
    m = (np.arange(17) % 3 > 0).astype(np.float32)
    t, j = DataSet(x, y, labels_mask=m), _jax_ds(x, y, labels_mask=m)
    tk, jk = KFoldIterator(4, t), ju.KFoldIterator(4, j)
    while jk.hasNext():
        _same(tk.next(), jk.next())
        _same(tk.testFold(), jk.testFold())
    assert tk.batch() == jk.batch()
    _same_stream(ViewIterator(t, 5), ju.ViewIterator(j, 5), epochs=2)
    _same_stream(SamplingDataSetIterator(t, 4, 10, seed=9),
                 ju.SamplingDataSetIterator(j, 4, 10, seed=9), epochs=2)
    _same_stream(MultipleEpochsIterator(3, ArrayDataSetIterator(
        x, y, 6, shuffle=True)), ju.MultipleEpochsIterator(
        3, JA(x, y, 6, shuffle=True)))
    _same_stream(EarlyTerminationDataSetIterator(ArrayDataSetIterator(
        x, y, 4), 2), ju.EarlyTerminationDataSetIterator(JA(x, y, 4), 2),
        epochs=2)
    for cache_dir in (None, str(tmp_path / "cache")):
        _same_stream(CachingDataSetIterator(
            ArrayDataSetIterator(x, y, 5, shuffle=True), cache_dir),
            ju.CachingDataSetIterator(JA(x, y, 5, shuffle=True)), epochs=3)
    with pytest.raises(ValueError):
        KFoldIterator(1, t)
    with pytest.raises(ValueError):
        MultipleEpochsIterator(0, ArrayDataSetIterator(x, y, 4))


def test_existing_minibatch_files_cross_over(tmp_path):
    from deeplearning4j_tpu.datasets import iterator_utils as ju

    x, y = _data(12)
    for i in range(3):          # JAX writes 0 and 2, the port 1
        sl = slice(4 * i, 4 * i + 4)
        ds = (_jax_ds(x[sl], y[sl]) if i != 1 else DataSet(x[sl], y[sl]))
        ds.save(str(tmp_path / f"dataset-{i}.npz"))
    _same_stream(ExistingMiniBatchDataSetIterator(str(tmp_path)),
                 ju.ExistingMiniBatchDataSetIterator(str(tmp_path)))
    with pytest.raises(ValueError, match="no files"):
        ExistingMiniBatchDataSetIterator(str(tmp_path), "other-%d.npz")


# ---------------------------------------------------------------- fetchers
def _write_idx(path, arr, gz=False):
    code = 0x00000800 | arr.ndim
    body = struct.pack(">I", code) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape) + arr.astype(np.uint8).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(body)


def test_iris_matches_jax():
    from deeplearning4j_tpu.datasets import IrisDataSetIterator as J

    for kw in (dict(batch=40), dict(batch=150, shuffle=False),
               dict(batch=32, num_examples=100, seed=3)):
        _same_stream(IrisDataSetIterator(**kw), J(**kw), epochs=2)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_from_local_idx_files_matches_jax(tmp_path, gz):
    from deeplearning4j_tpu.datasets import MnistDataSetIterator as J

    rs = np.random.RandomState(1)
    sfx = ".gz" if gz else ""
    _write_idx(str(tmp_path / f"train-images-idx3-ubyte{sfx}"),
               rs.randint(0, 256, (30, 28, 28)), gz)
    _write_idx(str(tmp_path / f"train-labels-idx1-ubyte{sfx}"),
               rs.randint(0, 10, 30), gz)
    for kw in (dict(), dict(as_images=True, binarize=True),
               dict(num_examples=20, shuffle=False)):
        t = MnistDataSetIterator(8, data_dir=str(tmp_path), **kw)
        _same_stream(t, J(8, data_dir=str(tmp_path), **kw))
    with pytest.raises(FileNotFoundError, match="t10k-images"):
        MnistDataSetIterator(8, train=False, data_dir=str(tmp_path))


def test_emnist_letters_and_cifar_match_jax(tmp_path):
    from deeplearning4j_tpu.datasets import Cifar10DataSetIterator as JC
    from deeplearning4j_tpu.datasets import EmnistDataSetIterator as JE

    rs = np.random.RandomState(2)
    _write_idx(str(tmp_path / "emnist-letters-test-images-idx3-ubyte"),
               rs.randint(0, 256, (12, 28, 28)))
    _write_idx(str(tmp_path / "emnist-letters-test-labels-idx1-ubyte"),
               rs.randint(1, 27, 12))
    t = EmnistDataSetIterator("letters", 5, train=False,
                              data_dir=str(tmp_path))
    assert t.next().labels.shape == (5, 26)
    _same_stream(t, JE("letters", 5, train=False, data_dir=str(tmp_path)))
    cdir = tmp_path / "cifar"
    cdir.mkdir()
    rec = np.concatenate([rs.randint(0, 10, (7, 1)),
                          rs.randint(0, 256, (7, 3072))], 1).astype(np.uint8)
    rec.tofile(str(cdir / "test_batch.bin"))
    _same_stream(Cifar10DataSetIterator(4, train=False, data_dir=str(cdir)),
                 JC(4, train=False, data_dir=str(cdir)))
    with pytest.raises(FileNotFoundError, match="data_batch_1"):
        Cifar10DataSetIterator(4, train=True, data_dir=str(cdir))


# ------------------------------------------------------ host prefetch
class _Failing(ArrayDataSetIterator):
    """Raises on its third batch."""

    def next(self):
        if self._i >= 2 * self._bs:
            raise OSError("disk gone")
        return super().next()


def _no_etl_thread():
    return not any(t.name == "AsyncDataSet-ETL" and t.is_alive()
                   for t in threading.enumerate())


def test_async_iterator_yields_the_batches_and_raises_worker_errors():
    from deeplearning4j_tpu.datasets import AsyncDataSetIterator as J
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JA

    x, y = _data(14)
    t = AsyncDataSetIterator(ArrayDataSetIterator(x, y, 4, shuffle=True), 2)
    j = J(JA(x, y, 4, shuffle=True), 2)
    _same_stream(t, j, epochs=2)
    assert t.batch() == 4
    t.shutdown()
    j.shutdown()
    bad = AsyncDataSetIterator(_Failing(x, y, 4))
    got = [bad.next(), bad.next()]
    assert len(got) == 2
    with pytest.raises(OSError, match="disk gone"):
        bad.next()
    bad.shutdown()
    assert _no_etl_thread()


# --------------------------------------------------------- class imbalance
def test_undersampling_masks_match_jax():
    from deeplearning4j_tpu.datasets import classimbalance as jc
    from deeplearning4j_tpu.datasets import multi_dataset as jm

    rs = np.random.RandomState(4)
    lab = (rs.rand(6, 20, 1) < 0.1).astype(np.float32)
    mask = (rs.rand(6, 20) < 0.9).astype(np.float32)
    for kw in (dict(), dict(mask_all_majority_windows=False),
               dict(minority_label=0)):
        t = UnderSamplingByMaskingPreProcessor(0.3, 5, seed=2, **kw)
        j = jc.UnderSamplingByMaskingPreProcessor(0.3, 5, seed=2, **kw)
        for m in (None, mask):
            np.testing.assert_array_equal(t.adjusted_mask(lab, m),
                                          j.adjusted_mask(lab, m))
    two = np.concatenate([1 - lab, lab], -1)
    tm = MultiDataSet([lab], [two, lab])
    jmd = jm.MultiDataSet([lab], [two, lab])
    UnderSamplingByMaskingMultiDataSetPreProcessor(
        0.4, 4, label_indices=[0], seed=1).preProcess(tm)
    jc.UnderSamplingByMaskingMultiDataSetPreProcessor(
        0.4, 4, label_indices=[0], seed=1).preProcess(jmd)
    np.testing.assert_array_equal(tm.labels_mask_arrays[0],
                                  jmd.labels_mask_arrays[0])
    assert tm.labels_mask_arrays[1] is None
    with pytest.raises(ValueError, match="target_minority_dist"):
        UnderSamplingByMaskingPreProcessor(0.7, 5)


def test_record_readers_raise_with_their_roadmap_item():
    for cls in (RecordReaderDataSetIterator,
                SequenceRecordReaderDataSetIterator,
                RecordReaderMultiDataSetIterator):
        with pytest.raises(NotImplementedError, match="A9"):
            cls(object(), 4)
