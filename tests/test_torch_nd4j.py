"""PyTorch port, ``Nd4j`` and ``NDArray`` (``deeplearning4j_tpu_torch/
ndarray``) and ops by name (``ops/registry.py``, ``Nd4j.exec``) against
``deeplearning4j_tpu/ndarray`` and ``deeplearning4j_tpu/ops/registry.py``
on the same numpy arrays at f32: 1e-6 (one or two f32 operations in
another library), npy files byte for byte.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ndarray import DataType, NDArray, Nd4j
from deeplearning4j_tpu_torch.ops import registry

RS = np.random.RandomState(3)


def _jax_nd4j():
    from deeplearning4j_tpu.ndarray import Nd4j as JaxNd4j

    return JaxNd4j


def _a(*shape):
    return RS.randn(*shape).astype(np.float32)


# ----------------------------------------------------------------- registry
def test_every_port_op_is_a_jax_op_of_the_same_name():
    import deeplearning4j_tpu.ops  # noqa: F401  (registers the JAX ops)
    from deeplearning4j_tpu.ops.registry import has_op as jax_has_op

    names = registry.list_ops()
    assert {"conv1x1_bn_stats", "conv3x3_bn_stats", "bn_relu_residual",
            "batch_norm", "relu", "cast"} <= set(names)
    assert [n for n in names if not jax_has_op(n)] == []


def test_the_port_registry_is_its_own():
    """Registering into the port never reaches the JAX registry (whose
    execution gate would then demand coverage of port names)."""
    from deeplearning4j_tpu.ops.registry import has_op as jax_has_op

    name = "_port_only_probe_op"
    registry.register_op(name)(lambda x: x)
    try:
        assert registry.has_op(name) and not jax_has_op(name)
        with pytest.raises(ValueError, match="already registered"):
            registry.register_op(name)(lambda x: x)
        with pytest.raises(KeyError, match="Unknown op 'no_such_op'"):
            registry.get_op("no_such_op")
        Nd4j.exec(name, torch.zeros(1))
        assert name in registry.executed_ops()
    finally:
        registry._REGISTRY.pop(name)
        registry._EXECUTED.discard(name)


@pytest.mark.parametrize("name, args, kw", [
    ("relu", [(3, 4)], {}),
    ("add", [(3, 4), (4,)], {}),
    ("sub", [(3, 4), (3, 4)], {}),
    ("mul", [(2, 3), (2, 3)], {}),
    ("div", [(2, 3), (3,)], {}),
    ("pow_pairwise", [(2, 3), (2, 3)], {}),
    ("matmul", [(3, 4), (5, 4)], {"transpose_b": True}),
    ("neg", [(4,)], {}),
    ("identity", [(4,)], {}),
    ("cast", [(2, 2)], {"dtype": "float32"}),
    ("reduce_sum", [(3, 4, 5)], {"dimensions": [0, 2], "keep_dims": True}),
    ("reduce_mean", [(3, 4)], {"dimensions": 1}),
    ("reduce_max", [(3, 4)], {}),
    ("reduce_min", [(3, 4)], {"dimensions": [0]}),
    ("reduce_std", [(3, 4)], {"dimensions": [1], "bias_corrected": False}),
    ("reduce_norm2", [(3, 4)], {"dimensions": [0], "keep_dims": True}),
    ("argmax", [(3, 4)], {"dimensions": 1}),
    ("reshape", [(3, 4)], {"shape": [2, -1]}),
    ("transpose", [(2, 3, 4)], {"permute": [2, 0, 1]}),
    ("batch_norm", [(2, 4, 4, 6), (6,), (6,), (6,), (6,)], {"eps": 1e-3}),
])
def test_exec_by_name_matches_jax(name, args, kw):
    """``Nd4j.exec`` on both sides with the same arrays and attrs."""
    JaxNd4j = _jax_nd4j()
    import deeplearning4j_tpu.ops  # noqa: F401

    arrays = [_a(*s) for s in args]
    if name in ("pow_pairwise",):
        arrays[0] = np.abs(arrays[0]) + 0.5
    if name == "batch_norm":
        arrays[4] = np.abs(arrays[4]) + 0.5          # var
    want = np.asarray(JaxNd4j.exec(name, *arrays, **kw))
    got = Nd4j.exec(name, *(Nd4j.create(a, device="cpu") for a in arrays),
                    **kw)
    assert isinstance(got, torch.Tensor)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_exec_cast_to_bfloat16_rounds_like_jax():
    import jax.numpy as jnp

    x = _a(64)
    got = Nd4j.exec("cast", torch.from_numpy(x), dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


# ------------------------------------------- reductions: axes and JAX's types
def _exact(got, want):
    """Same dtype, shape and values (NaN where JAX has NaN)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


_REDUCE_OPS = ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
               "reduce_std", "reduce_norm2"]


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("name", _REDUCE_OPS)
def test_exec_reduce_over_no_axis_matches_jax(name, dtype):
    """An empty ``dimensions`` reduces no axis, as JAX's ``_axes`` keeps
    ``()``: the sum is x itself, the norm2 sqrt(x * x), the bias-corrected
    std NaN (one element, one degree of freedom taken)."""
    JaxNd4j = _jax_nd4j()
    import deeplearning4j_tpu.ops  # noqa: F401

    x = np.arange(12, dtype=dtype).reshape(3, 4)
    for dims in ([], ()):
        want = JaxNd4j.exec(name, x, dimensions=dims)
        _exact(Nd4j.exec(name, torch.from_numpy(x), dimensions=dims), want)
    want = JaxNd4j.exec(name, x, dimensions=[], keep_dims=True)
    _exact(Nd4j.exec(name, torch.from_numpy(x), dimensions=[],
                     keep_dims=True), want)


@pytest.mark.parametrize("dims", [None, [0], (0, 1), 1])
@pytest.mark.parametrize("name", _REDUCE_OPS + ["argmax"])
def test_exec_reduce_int32_follows_jax_types(name, dims):
    """int32 input without x64: sums, max, min and argmax stay int32, the
    mean, std and norm2 are float32, with JAX's values."""
    JaxNd4j = _jax_nd4j()
    import deeplearning4j_tpu.ops  # noqa: F401

    if name == "argmax" and not isinstance(dims, int):
        dims = 0 if dims is None else dims[0]
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    want = JaxNd4j.exec(name, x, dimensions=dims)
    _exact(Nd4j.exec(name, torch.from_numpy(x), dimensions=dims), want)


def test_int32_sum_wraps_like_jax():
    """torch sums int32 into int64; the port casts back, so an overflowing
    int32 sum keeps its low 32 bits as ``jnp.sum`` does: 4 x 2^30 is 0,
    3 x 2^30 is -2^30, and so is 7 x 2^30."""
    import jax.numpy as jnp

    JaxNd4j = _jax_nd4j()
    import deeplearning4j_tpu.ops  # noqa: F401

    x = np.full((2, 4), 2 ** 30, np.int32)
    x[1, 3] = 0
    for dims in (None, [1]):
        want = jnp.sum(jnp.asarray(x), axis=None if dims is None
                       else tuple(dims))
        _exact(Nd4j.exec("reduce_sum", torch.from_numpy(x),
                         dimensions=dims), want)
        _exact(Nd4j.exec("reduce_sum", torch.from_numpy(x), dimensions=dims),
               JaxNd4j.exec("reduce_sum", x, dimensions=dims))
    np.testing.assert_array_equal(
        Nd4j.exec("reduce_sum", torch.from_numpy(x), dimensions=[1]).numpy(),
        [0, -2 ** 30])
    assert (Nd4j.create(x, device="cpu").sum() == JaxNd4j.create(x).sum()
            == -2 ** 30)


@pytest.mark.parametrize("method", ["sum", "mean", "prod", "max", "min",
                                    "std"])
def test_ndarray_int32_reductions_follow_jax_types(method):
    """``NDArray`` reductions of an int32 array, over an axis and over
    all: JAX's dtype and values (mean and std in float32)."""
    JaxNd4j = _jax_nd4j()
    x = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    ja, ta = JaxNd4j.create(x), Nd4j.create(x, device="cpu")
    for dims in ((0,), (1,)):
        _exact(getattr(ta, method)(*dims).toNumpy(),
               getattr(ja, method)(*dims).toNumpy())
    whole = getattr(ta, method)()
    assert type(whole) is type(getattr(ja, method)())
    assert whole == getattr(ja, method)()


@pytest.mark.parametrize("a_dtype, b", [
    ("float32", np.ones((3, 4))),
    ("float32", np.arange(4, dtype=np.int64)),
    ("int32", np.ones((3, 4), np.int64)),
    ("int32", np.full((3, 4), 0.5)),
])
@pytest.mark.parametrize("method", ["add", "sub", "mul", "rsub"])
def test_ndarray_numpy_operand_is_narrowed_like_jax(method, a_dtype, b):
    """A 64-bit numpy operand counts as its 32-bit type, as ``jnp.asarray``
    makes it: f32 + float64 ones is float32, int32 + int64 is int32."""
    JaxNd4j = _jax_nd4j()
    x = (np.arange(12) - 4).reshape(3, 4).astype(a_dtype)
    want = getattr(JaxNd4j.create(x), method)(b).toNumpy()
    _exact(getattr(Nd4j.create(x, device="cpu"), method)(b).toNumpy(), want)


# ------------------------------------------------------------------ NDArray
def test_ndarray_arithmetic_and_reductions_match_jax():
    JaxNd4j = _jax_nd4j()
    a, b, v = _a(3, 4), _a(3, 4), _a(4)
    ja, jb = JaxNd4j.create(a), JaxNd4j.create(b)
    ta, tb = Nd4j.create(a, device="cpu"), Nd4j.create(b, device="cpu")
    pairs = [
        (ja.add(jb), ta.add(tb)), (ja.sub(b), ta.sub(b)), (ja.rsub(2.0),
                                                           ta.rsub(2.0)),
        (ja.mul(jb), ta.mul(tb)), (ja.div(2.0), ta.div(2.0)),
        (ja.rdiv(1.0), ta.rdiv(1.0)), (ja.neg(), ta.neg()),
        (ja.addRowVector(v), ta.addRowVector(torch.from_numpy(v))),
        (ja.mulRowVector(v), ta.mulRowVector(torch.from_numpy(v))),
        (ja.subRowVector(v), ta.subRowVector(torch.from_numpy(v))),
        (ja.divRowVector(v), ta.divRowVector(torch.from_numpy(v))),
        (ja.mmul(jb.transpose()), ta.mmul(tb.transpose())),
        (ja.sum(0), ta.sum(0)), (ja.mean(1, keepdims=True),
                                 ta.mean(1, keepdims=True)),
        (ja.max(0, 1, keepdims=True), ta.max(0, 1, keepdims=True)),
        (ja.min(1), ta.min(1)), (ja.prod(0), ta.prod(0)),
        (ja.std(1), ta.std(1)), (ja.reshape(4, 3), ta.reshape(4, 3)),
        (ja.permute(1, 0), ta.permute(1, 0)), (ja.ravel(), ta.ravel()),
        (ja.castTo("bf16").castTo("float32"),
         ta.castTo("bf16").castTo("float32")),
        (ja.broadcast(2, 3, 4), ta.broadcast(2, 3, 4)),
        (ja.swapAxes(0, 1), ta.swapAxes(0, 1)),
        (ja + 1.0, ta + 1.0), (2.0 * ja, 2.0 * ta), (ja ** 2, ta ** 2),
        (1.0 - ja, 1.0 - ta), (ja @ jb.transpose(), ta @ tb.transpose()),
    ]
    for i, (j, t) in enumerate(pairs):
        assert isinstance(t, NDArray)
        assert t.shape() == j.shape(), i
        np.testing.assert_allclose(t.toNumpy(), j.toNumpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=str(i))
    for fn in ("sum", "mean", "max", "min", "prod"):
        assert getattr(ta, fn)() == pytest.approx(getattr(ja, fn)(), rel=1e-6)
    assert ta.std() == pytest.approx(ja.std(), rel=1e-6)
    assert ta.dot(tb) == pytest.approx(ja.dot(jb), rel=1e-6)
    for m in ("rank", "length", "rows", "columns", "isVector", "isMatrix",
              "isScalar", "isEmpty"):
        assert getattr(ta, m)() == getattr(ja, m)(), m
    assert ta.size(1) == ja.size(1) and ta.dataType() is DataType.FLOAT


def test_in_place_ops_rebind_like_jax():
    JaxNd4j = _jax_nd4j()
    a = _a(2, 3)
    ja, ta = JaxNd4j.create(a), Nd4j.create(a, device="cpu")
    for op, arg in (("addi", 1.5), ("subi", 0.5), ("muli", 3.0),
                    ("divi", 2.0), ("rsubi", 1.0), ("rdivi", 4.0)):
        assert getattr(ja, op)(arg) is ja and getattr(ta, op)(arg) is ta
    ja.negi()
    ta.negi()
    ja.mmuli(JaxNd4j.create(np.eye(3, dtype=np.float32)))
    ta.mmuli(Nd4j.create(np.eye(3, dtype=np.float32), device="cpu"))
    np.testing.assert_allclose(ta.toNumpy(), ja.toNumpy(), rtol=1e-6)
    d = ta.dup()
    d.addi(1.0)
    assert not np.allclose(d.toNumpy(), ta.toNumpy())


def test_create_zeros_ones_follow_jax_dtypes():
    JaxNd4j = _jax_nd4j()
    for data, dtype in (([[1.0, 2.0], [3.0, 4.0]], None), ([1, 2, 3], None),
                        (np.arange(4, dtype=np.float64), None),
                        (np.arange(6, dtype=np.float32), "bf16")):
        j = JaxNd4j.create(data, dtype=dtype)
        t = Nd4j.create(data, dtype=dtype, device="cpu")
        assert t.dataType().name == j.dataType().name, (data, dtype)
        np.testing.assert_allclose(t.toNumpy(), np.asarray(
            j.toNumpy(), np.float32))
    assert Nd4j.create(np.arange(6), shape=(2, 3), device="cpu").shape() == \
        (2, 3)
    for fn in ("zeros", "ones"):
        j = getattr(JaxNd4j, fn)(2, 3, dtype="int32")
        t = getattr(Nd4j, fn)((2, 3), dtype="int32", device="cpu")
        assert t.dataType() is DataType.INT and j.dataType().name == "INT"
        np.testing.assert_array_equal(t.toNumpy(), j.toNumpy())
    assert Nd4j.create(shape=(2, 2), device="cpu").sum() == 0.0


def test_random_draws_follow_the_seed_and_the_law():
    """The same laws as JAX's draws, not the same bits: reproducible from
    the seed, uniform on [0, 1) and standard normal."""
    Nd4j.setSeed(42)
    a = Nd4j.rand(1000, 100, device="cpu")
    b = Nd4j.randn(1000, 100, device="cpu")
    Nd4j.setSeed(42)
    assert torch.equal(Nd4j.rand(1000, 100, device="cpu").torch, a.torch)
    assert torch.equal(Nd4j.randn((1000, 100), device="cpu").torch, b.torch)
    assert Nd4j.getRandom().getSeed() == 42
    u, n = a.toNumpy(), b.toNumpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01 and abs(u.var() - 1 / 12) < 0.005
    assert abs(n.mean()) < 0.01 and abs(n.std() - 1.0) < 0.01
    assert b.dataType() is DataType.FLOAT
    assert Nd4j.rand(2, 2, dtype="bf16", device="cpu").dtype() == \
        torch.bfloat16


def test_matmul_matches_jax():
    JaxNd4j = _jax_nd4j()
    a, b = _a(3, 5), _a(5, 2)
    np.testing.assert_allclose(Nd4j.matmul(Nd4j.create(a, device="cpu"),
                                           torch.from_numpy(b)).toNumpy(),
                               JaxNd4j.matmul(a, b).toNumpy(), rtol=1e-6,
                               atol=1e-6)


# -------------------------------------------------------------- npy exchange
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool", "bfloat16"])
def test_npy_files_cross_both_ways(tmp_path, dtype):
    """``saveBinary`` / ``readBinary``: each package reads the other's
    files, and both write the same bytes. bfloat16 goes out as numpy's
    2-byte void of the bit patterns (what numpy writes for the JAX side's
    ``ml_dtypes`` arrays); the JAX side cannot read such a file back, the
    port can."""
    JaxNd4j = _jax_nd4j()
    a = RS.randn(3, 5).astype(np.float32)
    if dtype == "int32":
        a = (a * 10).astype(np.int32)
    elif dtype == "bool":
        a = a > 0
    j = JaxNd4j.create(a).castTo(dtype)
    t = Nd4j.create(a, device="cpu").castTo(dtype)
    jp, tp = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    JaxNd4j.saveBinary(j, jp)
    Nd4j.saveBinary(t, tp)
    if dtype == "bfloat16":
        # the same bit patterns; numpy marks the JAX side's ml_dtypes void
        # '<V2' and a plain 2-byte void '|V2'
        ja, ta = np.load(jp), np.load(tp)
        assert ja.dtype.kind == ta.dtype.kind == "V"
        assert ja.tobytes() == ta.tobytes() and ja.shape == ta.shape
    else:
        with open(jp, "rb") as f1, open(tp, "rb") as f2:
            assert f1.read() == f2.read()
    back = Nd4j.readBinary(jp, device="cpu")
    assert back.dataType() is DataType.from_any(dtype)
    np.testing.assert_array_equal(back.toNumpy(), t.toNumpy())
    if dtype != "bfloat16":
        np.testing.assert_array_equal(JaxNd4j.readBinary(tp).toNumpy(),
                                      t.toNumpy())


def test_dtype_names_and_aliases_match_jax():
    from deeplearning4j_tpu.ndarray.dtypes import DataType as JaxDataType

    assert [d.name for d in DataType] == [d.name for d in JaxDataType]
    assert [d.value for d in DataType] == [d.value for d in JaxDataType]
    for alias in ("bf16", "fp16", "f32", "single", "double", "float32",
                  "int8", "bool"):
        assert DataType.from_any(alias).name == JaxDataType.from_any(
            alias).name
    for d in DataType:
        assert DataType.from_any(d.torch) is d
        assert d.width_bytes() == JaxDataType[d.name].width_bytes()
        assert d.is_float() == JaxDataType[d.name].is_float()
        assert d.is_signed() == JaxDataType[d.name].is_signed()
    with pytest.raises(ValueError):
        DataType.from_any("complex64")
