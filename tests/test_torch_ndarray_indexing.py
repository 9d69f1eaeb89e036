"""PyTorch port, NDArray indexing (``deeplearning4j_tpu_torch/ndarray/
indexing.py`` and the rest of ``NDArray`` and ``Nd4j``): the indexing,
``put``, TAD, comparison and factory cases of ``tests/test_ndarray.py``,
each run through both packages on the same values and held equal (exact;
1e-6 for the float reductions), and the port's rebinding ``put``: a view
taken earlier with ``get`` never changes, as a JAX array never does.
"""

import inspect

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ndarray import (DataType, NDArray, NDArrayIndex,
                                              Nd4j)


class _Port:
    """The port's factory on the CPU, in the JAX factory's spelling."""

    Index = NDArrayIndex

    def __getattr__(self, name):
        fn = getattr(Nd4j, name)
        if "device" not in inspect.signature(fn).parameters:
            return fn
        return lambda *a, **k: fn(*a, device="cpu", **k)


def _packages():
    from deeplearning4j_tpu.ndarray import Nd4j as JNd4j
    from deeplearning4j_tpu.ndarray import NDArrayIndex as JIndex

    class _Jax:
        Index = JIndex

        def __getattr__(self, name):
            return getattr(JNd4j, name)

    return _Port(), _Jax()


def _same(fn):
    """``fn(nd)`` in both packages: results equal in shape, dtype and
    value."""
    port, jax = _packages()
    got, want = fn(port), fn(jax)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g = g.toNumpy() if hasattr(g, "toNumpy") else np.asarray(g)
        w = w.toNumpy() if hasattr(w, "toNumpy") else np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_get_with_indices():
    def run(nd):
        I = nd.Index
        a = nd.arange(24).reshape(4, 6)
        return (a.get(I.interval(1, 3), I.all()),
                a.get(I.point(2), I.interval(0, 4)),
                a.get(I.indices(0, 3), I.all()),
                a.get(I.all(), I.interval(0, 2, 4, inclusive=True)),
                a.get(I.all(), I.newAxis(), I.all()))
    _same(run)


def test_put_with_indices_and_raw_index():
    def run(nd):
        I = nd.Index
        a = nd.zeros(3, 4)
        a.put(I.point(1), I.interval(1, 3), nd.ones(2))
        a.put((0, 0), 7.0)
        a.put([I.point(2), I.indices(0, 3)], 5.0)
        return a
    _same(run)


def test_item_assignment_and_scalars():
    def run(nd):
        a = nd.arange(12, dtype=DataType.FLOAT).reshape(3, 4) \
            if isinstance(nd, _Port) else nd.arange(12).reshape(3, 4)
        row = a[1]
        a[0, 0] = 99.0
        b = nd.zeros(2, 2)
        b.putScalar(3, 7.0)
        return row, a, b, np.float32(a.getDouble(0, 0)), \
            np.float32(b.getDouble(3))
    _same(run)


def test_rows_columns_slice():
    def run(nd):
        a = nd.arange(12).reshape(3, 4)
        out = (a.getRow(1), a.getColumn(2), a.getRows(0, 2),
               a.getColumns(1, 3))
        a.putRow(0, nd.zeros(4))
        a.putColumn(3, nd.ones(3))
        return out + (a, a.slice(2), a.slice(1, dim=1))
    _same(run)


def test_tensor_along_dimension():
    def run(nd):
        a = nd.arange(24).reshape(2, 3, 4)
        return (np.int32(a.tensorsAlongDimension(2)),
                a.tensorAlongDimension(4, 2),
                np.int32(a.tensorsAlongDimension(1, 2)),
                a.tensorAlongDimension(1, 1, 2))
    _same(run)


def test_comparisons_and_equality():
    def run(nd):
        a = nd.create([1.0, 5.0, 3.0])
        b = nd.create([1.0, 4.0, 3.0])
        return (a.gt(2.0), a.gte(3.0), a.lt(b), a.lte(b), a.eq(b),
                a.neq(b), np.bool_(a.equalsWithEps(b, 1.0)),
                np.bool_(a.equalsWithEps(b, 0.5)), np.bool_(a.equals(a)),
                np.bool_(a.equals(nd.create([1.0, 5.0]))))
    _same(run)


def test_reductions_and_numbers():
    def run(nd):
        a = nd.create(np.arange(12, dtype=np.float32).reshape(3, 4) - 5)
        return (a.var(1), a.norm1(0), a.norm2(1), a.normMax(0),
                a.argMax(1), a.argMin(0), a.cumsum(1), a.cumsum(),
                np.float32(a.sumNumber()), np.float32(a.meanNumber()),
                np.float32(a.maxNumber()), np.float32(a.minNumber()),
                np.float32(a.stdNumber()), np.float32(a.varNumber(False)),
                np.float32(a.norm2()), np.int32(a.argMax()))
    _same(run)


def test_factory_members():
    def run(nd):
        a = nd.create([[1.0, 2.0], [3.0, 4.0]])
        return (nd.zerosLike(a), nd.onesLike(a), nd.valueArrayOf((2, 3), 2.5),
                nd.scalar(3.0), nd.eye(3), nd.arange(5), nd.linspace(0, 1, 5),
                nd.concat(0, a, a), nd.hstack(a, a), nd.vstack(a, a),
                nd.stack(1, a, a), nd.pile(a, a), nd.tile(a, 2, 1),
                nd.where(a.gt(2.0), a, nd.zerosLike(a)),
                nd.gemm(a, a, transposeA=True, alpha=2.0),
                nd.sort(nd.create([3.0, 1.0, 2.0]), descending=True),
                nd.argsort(nd.create([3.0, 1.0, 2.0])))
    _same(run)


def test_random_members_draw_their_laws():
    port = _Port()
    r = port.randint(0, 5, (4000,))
    b = port.bernoulli(0.3, (4000,))
    s = port.shuffle(port.arange(10))
    assert r.dataType() == DataType.INT and r.toNumpy().min() >= 0 \
        and r.toNumpy().max() <= 4
    assert abs(float(b.toNumpy().mean()) - 0.3) < 0.05
    assert sorted(s.toNumpy().tolist()) == list(range(10))


def test_txt_round_trip_crosses_packages(tmp_path):
    from deeplearning4j_tpu.ndarray import Nd4j as JNd4j

    for arr in (np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 7,
                np.array([[1, -2], [3, 4]], np.int32),
                np.array([True, False, True])):
        p, q = str(tmp_path / "p.txt"), str(tmp_path / "j.txt")
        Nd4j.writeTxt(Nd4j.create(arr, device="cpu"), p)
        JNd4j.writeTxt(JNd4j.create(arr), q)
        assert open(p).read() == open(q).read()
        got = Nd4j.readTxt(q, device="cpu").toNumpy()
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)


def test_put_rebinds_so_an_earlier_view_is_unchanged():
    a = Nd4j.create(np.arange(12, dtype=np.float32).reshape(3, 4),
                    device="cpu")
    held = a.torch
    view = a.get(NDArrayIndex.point(1), NDArrayIndex.all())
    row = a.getRow(2)
    a.put([NDArrayIndex.point(1), NDArrayIndex.all()], -1.0)
    a.putRow(2, Nd4j.zeros(4, device="cpu"))
    a.putScalar(0, 50.0)
    a[0, 1] = 60.0
    a.assign(a.add(1.0))
    np.testing.assert_array_equal(view.toNumpy(), [4, 5, 6, 7])
    np.testing.assert_array_equal(row.toNumpy(), [8, 9, 10, 11])
    assert a.torch is not held
    np.testing.assert_array_equal(held.numpy(), np.arange(12).reshape(3, 4))
    np.testing.assert_array_equal(a.toNumpy(), [[51, 61, 3, 4],
                                                [0, 0, 0, 0], [1, 1, 1, 1]])


def test_factories_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Nd4j.eye(2), lambda: Nd4j.arange(3),
                 lambda: Nd4j.valueArrayOf(2, 1.0), lambda: Nd4j.scalar(1.0),
                 lambda: Nd4j.linspace(0, 1, 3),
                 lambda: Nd4j.randint(0, 3, (2,)),
                 lambda: Nd4j.bernoulli(0.5, (2,)),
                 lambda: Nd4j.concat(0, np.ones(2), np.ones(2))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    a = NDArray(torch.ones(2, 2))
    assert Nd4j.concat(0, a, a).torch.device == torch.device("cpu")
