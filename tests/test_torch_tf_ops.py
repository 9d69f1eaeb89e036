"""PyTorch port, the ops by name of the TensorFlow-import slice (ROADMAP
A10.2): the 112 names it registers (``ops/tf_compat.py``,
``tensor_array.py``, ``bitwise.py``, ``extra_math.py``, ``linalg.py`` and
six names of ``declarable_tail.py``), each held against the JAX package's
registry entry on the same numpy inputs
(``deeplearning4j_tpu_torch.tools.op_cases.tf_cases``).

- Every output's shape and dtype equal JAX's; integers and booleans
  exactly, floats within rtol 1e-5 / atol 1e-6 (NaNs in the same places),
  1e-4 for the decompositions and the special functions that JAX and
  torch compute by other algorithms (LAPACK calls in another order,
  series against continued fractions).
- Eigenvectors and QR factors are unique only up to the sign of each
  vector, which LAPACK builds choose differently: both sides are put in
  one sign convention first (:func:`_canonical`).
- Parameter names, kinds and defaults equal JAX's for every name.
- On the card (``cuda`` marker): every name on CUDA tensors against the
  CPU, results on the card, the CPU's dtypes and shapes, values within
  1e-4 of max(1, |x|), integers exact.
"""

import functools
import inspect

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.ops as port_ops
from deeplearning4j_tpu_torch.ops.jax_rules import on_device
from deeplearning4j_tpu_torch.ops.registry import get_op
from deeplearning4j_tpu_torch.tools import op_cases as oc

CASES = oc.tf_cases(0)
NAMES = sorted(CASES)
LOOSE = {"betainc", "igamma", "igammac", "polygamma", "zeta", "lgamma",
         "digamma", "erfinv", "cholesky", "qr", "svd", "eigh", "solve",
         "triangular_solve", "lstsq", "lu", "matrix_inverse", "pinv",
         "matrix_determinant", "log_matrix_determinant", "slogdet",
         "matrix_power", "eigvalsh", "expm", "cond_number", "multi_dot",
         "einsum", "batched_gemm", "tensormmul", "percentile", "quantile",
         "median"}
#: names whose JAX outputs are computed together, as one program
BATCH = 40


def _jax():
    import jax

    import deeplearning4j_tpu.ops  # noqa: F401  (registers the JAX ops)
    from deeplearning4j_tpu.ops.registry import get_op as jget

    return jax, jget


def _to_jax(a, jax):
    import jax.numpy as jnp

    if isinstance(a, (np.ndarray, np.generic)):
        return jnp.asarray(a)
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [jnp.asarray(v) for v in a]
    return a


@functools.lru_cache(maxsize=None)
def _jax_batch(i):
    """JAX's outputs (numpy) of the ``i``-th run of :data:`BATCH` names,
    by name: one compiled program a run where it traces, else case by
    case (an op that needs concrete values)."""
    jax, jget = _jax()
    out = {}
    calls = {}
    for name in NAMES[i * BATCH:(i + 1) * BATCH]:
        args, kwargs, _ = CASES[name]
        calls[name] = ([_to_jax(a, jax) for a in args],
                       {k: _to_jax(v, jax) for k, v in kwargs.items()})

    def run_all(*arrays):
        it = iter(arrays)
        return {n: jget(n)(*(next(it) if isinstance(x, jax.Array) else x
                              for x in a), **k)
                for n, (a, k) in calls.items()}

    try:
        res = jax.jit(run_all)(*(x for a, _ in calls.values() for x in a
                                 if isinstance(x, jax.Array)))
    except Exception:                   # noqa: BLE001 (case by case)
        res = {}
        for n, (a, k) in calls.items():
            try:
                res[n] = jax.jit(lambda *xs, n=n, a=a, k=k: jget(n)(
                    *_refill(a, xs, jax), **k))(
                    *(x for x in a if isinstance(x, jax.Array)))
            except Exception:           # noqa: BLE001 (concrete values)
                res[n] = jget(n)(*a, **k)
    for n, o in res.items():
        out[n] = [np.asarray(j) for j in oc.flat_outputs(o)]
    return out


def _refill(args, arrays, jax):
    it = iter(arrays)
    return [next(it) if isinstance(x, jax.Array) else x for x in args]


def _canonical(name, outs):
    """``eigh``: each eigenvector column with its largest entry positive;
    ``qr``: ``R``'s diagonal non-negative (``Q``'s columns flipped with
    ``R``'s rows)."""
    if name == "eigh":
        vals, vecs = outs
        big = np.take_along_axis(vecs, np.abs(vecs).argmax(0)[None], 0)
        return [vals, vecs * np.where(big < 0, -1, 1).astype(vecs.dtype)]
    if name == "qr":
        q, r = outs
        sg = np.where(np.diagonal(r) < 0, -1, 1).astype(q.dtype)
        return [q * sg[None, :], r * sg[:, None]]
    return outs


def _run_both(name):
    args, kwargs, kind = CASES[name]
    want = _jax_batch(NAMES.index(name) // BATCH)[name]
    with on_device("cpu"):
        pout = get_op(name)(*(oc.to_port(a, "cpu") for a in args),
                            **{k: oc.to_port(v, "cpu")
                               for k, v in kwargs.items()})
    got = [oc.as_numpy(p) for p in oc.flat_outputs(pout)]
    return _canonical(name, want), _canonical(name, got), kind


def test_the_slice_registers_112_names_beside_the_290():
    assert len(port_ops.list_ops()) == 402 + len(oc.onnx_cases(0))
    assert len(NAMES) == 112
    assert set(NAMES) <= set(port_ops.list_ops())


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax(name):
    want, got, kind = _run_both(name)
    assert len(got) == len(want), (len(got), len(want))
    for w, g in zip(want, got):
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        tol = 1e-4 if name in LOOSE else 1e-5
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol / 10,
                                       equal_nan=True)


def _same_default(a, b):
    if a is b or a == b:
        return True
    try:
        return np.dtype(a) == np.dtype(b)
    except TypeError:
        pass
    return callable(a) and callable(b) and a.__name__ == b.__name__


@pytest.mark.parametrize("name", NAMES)
def test_parameters_match_jax(name):
    _, jget = _jax()
    js = inspect.signature(inspect.unwrap(jget(name)))
    ps = inspect.signature(inspect.unwrap(get_op(name)))
    assert list(ps.parameters) == list(js.parameters)
    for k, jp in js.parameters.items():
        pp = ps.parameters[k]
        assert pp.kind == jp.kind, k
        assert _same_default(pp.default, jp.default), (k, pp.default,
                                                       jp.default)


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_tf_ops_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (args, kwargs, _) in sorted(oc.tf_cases(1).items()):
        outs = {}
        for dev in ("cpu", "cuda"):
            with on_device(dev):
                res = oc.flat_outputs(get_op(name)(
                    *(oc.to_port(a, dev) for a in args),
                    **{k: oc.to_port(v, dev) for k, v in kwargs.items()}))
            assert all(r.device.type == dev for r in res), name
            outs[dev] = _canonical(name, [oc.as_numpy(r) for r in res])
        for c, g in zip(outs["cpu"], outs["cuda"]):
            assert (g.dtype, g.shape) == (c.dtype, c.shape), name
            if c.dtype.kind in "biu":
                np.testing.assert_array_equal(g, c, err_msg=name)
            else:
                tol = 1e-4 * max(1.0, float(np.nanmax(np.abs(c)))
                                 if c.size else 1.0)
                np.testing.assert_allclose(g, c, rtol=1e-4, atol=tol,
                                           equal_nan=True, err_msg=name)
