"""PyTorch port, the ops by name of the SameDiff slice (ROADMAP A10.1):
the 233 names it registers, each held against the JAX package's registry
entry on the same numpy inputs.

- Inputs: ``tests/test_op_sweep.py``'s ``CASES`` / ``CASES2`` where they
  hold the name, else ``deeplearning4j_tpu_torch.tools.op_cases`` (the
  table ``chip_smoke.py`` also runs on the card), which adds
  out-of-range indices, duplicate scatter rows and top-k ties.
- Deterministic ops: every output's shape and dtype equal JAX's, values
  within rtol 1e-5 / atol 1e-6 (NaNs in the same places); 1e-4 for the
  recurrences, attention, convolutions and the CTC loss (f32 sums in
  another order).
- Random ops (the port takes a seed where JAX takes a key, so the draws
  differ): shape, dtype, support, and the two samples' means within six
  standard errors.
- Parameter names and defaults equal JAX's for every name.
- A graph JAX saved with these ops loads and runs in the port.
"""

import functools
import importlib.util
import inspect
import os

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.ops as port_ops
from deeplearning4j_tpu_torch.ops.jax_rules import on_device
from deeplearning4j_tpu_torch.ops.registry import get_op
from deeplearning4j_tpu_torch.tools import op_cases as oc

#: the names the port registered before this slice
PRIOR = {
    "add", "argmax", "avgpool2d", "batch_norm", "batch_norm_relu_train",
    "batch_norm_train", "bn_relu_residual", "cast", "conv1x1_bn_stats",
    "conv2d", "conv3x3_bn_stats", "cube", "div", "elu", "gelu",
    "global_avg_pool", "gt", "gte", "hardsigmoid", "hardtanh", "identity",
    "layer_norm", "leakyrelu", "lrn", "lt", "lte", "matmul", "maxpool2d",
    "mish", "mul", "neg", "pnormpool2d", "pow_pairwise", "rationaltanh",
    "rdiv", "recttanh", "reduce_max", "reduce_mean", "reduce_min",
    "reduce_norm2", "reduce_std", "reduce_sum", "relu", "relu6", "reshape",
    "rsub", "selu", "sigmoid", "softmax", "softplus", "softsign", "sub",
    "sumpool2d", "swish", "tanh", "thresholdedrelu", "transpose"}
#: the names of the TensorFlow- and ONNX-import slices
#: (tests/test_torch_tf_ops.py, tests/test_torch_onnx_ops.py)
LATER = set(oc.tf_cases(0)) | set(oc.onnx_cases(0))
NEW = sorted(set(port_ops.list_ops()) - PRIOR - LATER)
CASES = oc.cases(0)
LOOSE = {"ctc_loss", "conv1d", "conv3d", "deconv2d", "depthwise_conv2d",
         "separable_conv2d", "locally_connected1d", "locally_connected2d",
         "gru_layer", "gru_seq", "lstm_layer", "lstm_seq", "onnx_gru_seq",
         "onnx_lstm_seq", "onnx_rnn_seq", "simple_rnn_layer",
         "dot_product_attention", "multi_head_dot_product_attention",
         "flash_attention", "paged_attention", "tensordot", "batch_mmul",
         "xw_plus_b", "fused_adam_master_update", "im2col"}


@functools.lru_cache(maxsize=None)
def _sweep_module():
    spec = importlib.util.spec_from_file_location(
        "_op_sweep_cases", os.path.join(os.path.dirname(__file__),
                                        "test_op_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax():
    import jax

    import deeplearning4j_tpu.ops  # noqa: F401  (registers the JAX ops)
    from deeplearning4j_tpu.ops.registry import get_op as jget

    return jax, jget


def _from_sweep(name):
    """``(args, kwargs)`` of ``name`` from the JAX op sweep, as numpy (a
    JAX key as :data:`oc.RNG`), or None."""
    import jax

    sweep = _sweep_module()
    case = sweep.CASES.get(name) or sweep.CASES2.get(name)
    if case is None or len(case) != 4:
        return None
    args, kwargs = case[0], case[1]

    def conv(a):
        if isinstance(a, jax.Array) and jax.dtypes.issubdtype(
                a.dtype, jax.dtypes.prng_key):
            return oc.RNG
        if isinstance(a, jax.Array):
            return np.asarray(a)
        if isinstance(a, list):
            return [conv(v) for v in a]
        return a

    return tuple(conv(a) for a in args), {k: conv(v) for k, v in
                                           kwargs.items()}


def _to_jax(a, jax):
    import jax.numpy as jnp

    from deeplearning4j_tpu.learning.updaters import Adam

    if isinstance(a, str) and a == oc.RNG:
        return jax.random.key(0)
    if isinstance(a, str) and a == oc.ADAM:
        return Adam(1e-3)
    if isinstance(a, (np.ndarray, np.generic)):
        return jnp.asarray(a)
    if isinstance(a, dict) and "ops" not in a:
        return {k: _to_jax(v, jax) for k, v in a.items()}
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [_to_jax(v, jax) for v in a]
    return a


def _jit_call(jax, fn, args, kwargs):
    """``fn(*args, **kwargs)`` as one compiled program: the JAX arrays
    are its arguments, everything else is closed over (one compile a
    case, where eager dispatch compiles every primitive)."""
    arrays = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

    def call(*arrs):
        full = list(args)
        for i, a in zip(arrays, arrs):
            full[i] = a
        return fn(*full, **kwargs)

    try:
        return jax.jit(call)(*(args[i] for i in arrays))
    except (jax.errors.ConcretizationTypeError, TypeError,
            jax.errors.TracerIntegerConversionError):
        return fn(*args, **kwargs)      # an op that needs concrete values


def _inputs(name):
    """``(args, kwargs, kind)`` of ``name``: the sweep's inputs where it
    has the name, else the port's case table's."""
    args, kwargs, kind = CASES[name]
    found = _from_sweep(name)
    if found is not None:
        args, kwargs = found
    return args, kwargs, kind


#: names whose JAX outputs are computed together, as one program
BATCH = 40


@functools.lru_cache(maxsize=None)
def _jax_batch(i):
    """JAX's outputs (numpy) of the ``i``-th run of :data:`BATCH` names
    of :data:`NEW`, by name: one compiled program for the run (a compile
    a case took most of this file's time). A run that cannot be traced
    as one program goes case by case through :func:`_jit_call`."""
    jax, jget = _jax()
    calls = {}
    for name in NEW[i * BATCH:(i + 1) * BATCH]:
        args, kwargs, _ = _inputs(name)
        calls[name] = ([_to_jax(a, jax) for a in args],
                       {k: _to_jax(v, jax) for k, v in kwargs.items()})

    def run_all(*arrays):
        it = iter(arrays)
        return {n: jget(n)(*(next(it) if isinstance(x, jax.Array) else x
                              for x in a), **k)
                for n, (a, k) in calls.items()}

    try:
        outs = jax.jit(run_all)(*(x for a, _ in calls.values() for x in a
                                  if isinstance(x, jax.Array)))
    except Exception:                   # noqa: BLE001 (case by case)
        outs = {n: _jit_call(jax, jget(n), a, k)
                for n, (a, k) in calls.items()}
    return {n: [np.asarray(j) for j in oc.flat_outputs(o)]
            for n, o in outs.items()}


def _run_both(name):
    args, kwargs, kind = _inputs(name)
    want = _jax_batch(NEW.index(name) // BATCH)[name]
    with on_device("cpu"):
        pout = get_op(name)(*(oc.to_port(a, "cpu") for a in args),
                            **{k: oc.to_port(v, "cpu")
                               for k, v in kwargs.items()})
    return want, [oc.as_numpy(p) for p in oc.flat_outputs(pout)], kind


def test_the_slice_registers_233_names_beside_the_57():
    assert len(port_ops.list_ops()) == 290 + len(LATER)
    assert len(NEW) == 233
    assert set(CASES) == set(NEW)


@pytest.mark.parametrize("name", NEW)
def test_op_matches_jax(name):
    want, got, kind = _run_both(name)
    assert len(got) == len(want), (len(got), len(want))
    for w, g in zip(want, got):
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if kind == "random":
            _same_law(name, g, w)
            continue
        tol = 1e-4 if name in LOOSE else 1e-5
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol / 10,
                                       equal_nan=True)


def _same_law(name, g, w):
    """Two samples of one distribution: the same support, and means
    within six standard errors of each other (the difference of two means
    of n draws has a standard error of sqrt(2 / n) spreads)."""
    g64, w64 = g.astype(np.float64), w.astype(np.float64)
    assert np.isfinite(g64).all() == np.isfinite(w64).all()
    if name == "random_shuffle":
        np.testing.assert_array_equal(np.sort(g, 0), np.sort(w, 0))
        return
    if name == "random_cauchy":      # no mean: the medians, within 0.5
        assert abs(np.median(g64) - np.median(w64)) < 0.5
        return
    lo, hi = w64.min(), w64.max()
    span = max(hi - lo, 1e-6)
    assert g64.min() >= lo - 0.5 * span and g64.max() <= hi + 0.5 * span
    if np.unique(w).size <= 3:       # two or three values: the same ones
        assert set(np.unique(g)) <= set(np.unique(w)) | {0}
    spread = max(float(w64.std()), 1e-3)
    assert abs(g64.mean() - w64.mean()) <= 6 * spread / np.sqrt(w.size), \
        (g64.mean(), w64.mean())


def _same_default(a, b):
    if a is b or a == b:
        return True
    try:
        return np.dtype(a) == np.dtype(b)
    except TypeError:
        pass
    return callable(a) and callable(b) and a.__name__ == b.__name__


@pytest.mark.parametrize("name", NEW)
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


def test_unknown_impl_and_mode_raise_as_in_jax():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="unknown impl"):
        get_op("flash_attention")(q, q, q, impl="fast")
    for impl in ("auto", "xla", "library", "pallas", "blockwise"):
        assert get_op("flash_attention")(q, q, q, impl=impl).shape == q.shape
    with pytest.raises(ValueError, match="mode"):
        get_op("paged_attention")(q, {}, 0, None, None, mode="cuda")
    with pytest.raises(ValueError, match="scan"):
        get_op("lstm_layer")(torch.zeros(1, 2, 3), torch.zeros(3, 8),
                             torch.zeros(2, 8), torch.zeros(8), impl="x")


def test_jax_saved_graph_of_the_new_ops_runs_in_the_port(tmp_path):
    """A graph JAX built and saved (gather, top_k, take_along_axis,
    reduce_logsumexp, one_hot, log_softmax, embedding_lookup) loads in the
    port and gives JAX's outputs (1e-6)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSD

    from deeplearning4j_tpu_torch.autodiff import SameDiff

    rs = np.random.RandomState(3)
    table = rs.randn(11, 6).astype(np.float32)
    ids = rs.randint(0, 11, (3, 5)).astype(np.int32)
    sd = JSD()
    t = sd.var("table", table)
    x = sd.placeholder("ids", shape=(3, 5), dtype="int32")
    e = sd.nn.embedding_lookup(t, x)                        # [3, 5, 6]
    s = sd.math.reduce_sum(e, dimensions=[2])               # [3, 5]
    vals, idx = sd.invoke_op("top_k", [s], n_out=2, name="tk", k=2)
    picked = sd.invoke_op("take_along_axis", [s, idx], axis=1)
    lse = sd.math.reduce_logsumexp(sd.nn.log_softmax(e), dimensions=[2])
    hot = sd.nn.one_hot(x, depth=11)
    g = sd.math.gather(t, x, axis=0)
    sd.save(str(tmp_path / "g.zip"))
    names = [vals.name, idx.name, picked.name, lse.name, hot.name, g.name]
    want = sd.output({"ids": jnp.asarray(ids)}, names)
    port = SameDiff.load(str(tmp_path / "g.zip"), device="cpu")
    got = port.output({"ids": ids}, names)
    for n in names:
        w, p = np.asarray(want[n]), oc.as_numpy(got[n])
        assert p.dtype == w.dtype, n
        np.testing.assert_allclose(p, w, rtol=1e-6, atol=1e-6, err_msg=n)


def test_out_of_range_indices_follow_jax_and_never_reach_torch():
    """No index out of range reaches a torch kernel (on the card it would
    fire a device assert): gathers fill, index reads clamp, scatters and
    segments drop, as JAX does."""
    with on_device("cpu"):
        x = torch.arange(6.0).reshape(3, 2)
        g = get_op("gather")(x, torch.tensor([-1, 3, -4]))
        assert g[0].tolist() == [4.0, 5.0] and torch.isnan(g[1:]).all()
        gi = get_op("gather")(x.to(torch.int32), torch.tensor([3]))
        assert gi.tolist() == [[-2 ** 31, -2 ** 31]]
        assert get_op("gather_nd")(x, torch.tensor([[7, -9]])).tolist() \
            == [4.0]
        s = get_op("scatter_update")(x, torch.tensor([5, -1, -1]),
                                     torch.tensor([[9.0, 9.0], [1.0, 1.0],
                                                   [2.0, 2.0]]))
        assert s.tolist() == [[0, 1], [2, 3], [2, 2]]
        seg = get_op("segment_sum")(torch.ones(3), torch.tensor([0, -1, 9]),
                                    2)
        assert seg.tolist() == [1.0, 0.0]
        oh = get_op("one_hot")(torch.tensor([-1, 2]), 2)
        assert oh.tolist() == [[0.0, 0.0], [0.0, 0.0]]


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_sweep_matches_cpu():
    """Every name once on CUDA tensors against the CPU (chip_smoke's (d)):
    results on the card, the CPU's dtypes and shapes, values within 1e-4
    of max(1, |x|), integers exact; random draws by shape and type."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (args, kwargs, kind) in sorted(oc.cases(1).items()):
        outs = {}
        for dev in ("cpu", "cuda"):
            with on_device(dev):
                outs[dev] = oc.flat_outputs(get_op(name)(
                    *(oc.to_port(a, dev) for a in args),
                    **{k: oc.to_port(v, dev) for k, v in kwargs.items()}))
        for c, g in zip(outs["cpu"], outs["cuda"]):
            assert g.device.type == "cuda", name
            assert (g.dtype, g.shape) == (c.dtype, c.shape), name
            if kind == "random":
                continue
            cn, gn = oc.as_numpy(c), oc.as_numpy(g)
            if cn.dtype.kind in "biu":
                np.testing.assert_array_equal(gn, cn, err_msg=name)
            else:
                np.testing.assert_allclose(gn, cn, rtol=1e-4, atol=1e-4,
                                           equal_nan=True, err_msg=name)


def _grad_names():
    return sorted(n for n in _sweep_module().GRAD_CASES if n in NEW)


@pytest.mark.parametrize("name", ["celu", "group_norm", "hard_swish",
                                  "hinge_loss", "huber_loss",
                                  "instance_norm", "log_sigmoid",
                                  "poisson_nll_loss", "rms_norm"])
def test_gradient_matches_jax(name):
    """``tests/test_op_sweep.py``'s GRAD_CASES of this slice: the gradient
    of ``sum(sin(op(x, ...)))`` with respect to the first argument (the
    last with ``_swap``), the port's autograd against ``jax.grad``, within
    1e-5 of max(1, |grad|)."""
    import jax
    import jax.numpy as jnp

    assert name in _grad_names()
    args, kwargs = _sweep_module().GRAD_CASES[name]
    kwargs = dict(kwargs)
    swap = kwargs.pop("_swap", False)
    np_args = [np.asarray(a) for a in args]
    jfn = _jax()[1](name)

    def jloss(x0):
        rest = [jnp.asarray(a) for a in np_args[1:]]
        call = rest + [x0] if swap else [x0] + rest
        return jnp.sum(jnp.sin(jfn(*call, **kwargs)))

    want = np.asarray(_jit_call(jax, jax.grad(jloss),
                                [jnp.asarray(np_args[0])], {}))
    x0 = torch.from_numpy(np_args[0].copy()).requires_grad_(True)
    rest = [torch.from_numpy(a.copy()) for a in np_args[1:]]
    out = get_op(name)(*(rest + [x0] if swap else [x0] + rest), **kwargs)
    (got,) = torch.autograd.grad(torch.sum(torch.sin(out)), [x0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
