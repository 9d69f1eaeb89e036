"""PyTorch port, the ops by name of the ONNX-import slice (ROADMAP A10.2):
the 40 names it registers (``ops/onnx_compat.py``, ``image.py`` and
``compression.py``), each held against the JAX package's registry entry
on the same numpy inputs (``deeplearning4j_tpu_torch.tools.op_cases
.onnx_cases``).

- Every output's shape and dtype equal JAX's; integers and booleans
  exactly (the quantizer's half-to-even rounding and saturation, top-k
  and hardmax ties, non-max suppression), floats within rtol 1e-5 / atol
  1e-6.
- The four resizes against ``jax.image.resize`` (JAX's op) at upscales
  and downscales, odd sizes and one axis unchanged, in f32 and on int
  images; ``grid_sample`` in both modes, both paddings and both
  ``align_corners``.
- Parameter names, kinds and defaults equal JAX's for every name.
- On the card (``cuda`` marker): every name on CUDA tensors against the
  CPU, results on the card, the CPU's dtypes and shapes, values within
  1e-4 of max(1, |x|), integers exact.
"""

import inspect

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.ops as port_ops
from deeplearning4j_tpu_torch.ops.jax_rules import on_device
from deeplearning4j_tpu_torch.ops.registry import get_op
from deeplearning4j_tpu_torch.tools import op_cases as oc

CASES = oc.onnx_cases(0)
NAMES = sorted(CASES)


def _jax():
    import jax.numpy as jnp

    import deeplearning4j_tpu.ops  # noqa: F401  (registers the JAX ops)
    from deeplearning4j_tpu.ops.registry import get_op as jget

    return jnp, jget


def _jax_outputs(name, args, kwargs):
    jnp, jget = _jax()

    def tj(a):
        return jnp.asarray(a) if isinstance(a, (np.ndarray, np.generic)) \
            else a

    out = jget(name)(*(tj(a) for a in args),
                     **{k: tj(v) for k, v in kwargs.items()})
    return [np.asarray(o) for o in oc.flat_outputs(out)]


def _port_outputs(name, args, kwargs, device="cpu"):
    with on_device(device):
        out = get_op(name)(*(oc.to_port(a, device) for a in args),
                           **{k: oc.to_port(v, device)
                              for k, v in kwargs.items()})
    return oc.flat_outputs(out)


def _same(want, got, tol=1e-5, scale=1.0):
    """Shapes and dtypes equal; integers exact; floats within ``tol``
    relative and ``tol / 10`` times ``scale`` (the inputs' magnitude)."""
    assert len(got) == len(want), (len(got), len(want))
    for w, g in zip(want, got):
        g = oc.as_numpy(g)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol,
                                       atol=tol / 10 * scale, equal_nan=True)


def test_the_slice_registers_40_names_beside_the_402():
    assert len(NAMES) == 40
    assert set(NAMES) <= set(port_ops.list_ops())
    assert len(port_ops.list_ops()) == 442
    _, jget = _jax()
    mods = {n: inspect.unwrap(jget(n)).__module__ for n in NAMES}
    assert set(mods.values()) == {
        "deeplearning4j_tpu.ops.onnx_compat", "deeplearning4j_tpu.ops.image",
        "deeplearning4j_tpu.ops.compression"}


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax(name):
    args, kwargs, _ = CASES[name]
    _same(_jax_outputs(name, args, kwargs), _port_outputs(name, args,
                                                          kwargs))


_SIZES = [(13, 5), (5, 13), (3, 3), (16, 16), (8, 11), (1, 2), (2, 1),
          (7, 8)]


@pytest.mark.parametrize("name", ["resize_bilinear", "resize_nearest_neighbor",
                                  "resize_bicubic", "resize_area"])
def test_resizes_match_jax_image_at_up_and_downscales(name):
    """Each resize against JAX's op at upscales, downscales, odd sizes,
    an unchanged axis and the degenerate sizes 1 and 2, f32 and int
    (pixel values up to 255: the absolute tolerance scales with them)."""
    r = np.random.default_rng(3)
    img = r.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    ints = r.integers(0, 255, (1, 6, 9, 2)).astype(np.int32)
    for x in (img, ints):
        for size in _SIZES:
            _same(_jax_outputs(name, (x, list(size)), {}),
                  _port_outputs(name, (x, list(size)), {}),
                  scale=float(np.abs(x).max()))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(mode, padding_mode, align_corners):
    r = np.random.default_rng(4)
    x = r.normal(size=(2, 5, 6, 3)).astype(np.float32)
    grid = r.uniform(-1.3, 1.3, (2, 4, 7, 2)).astype(np.float32)
    grid[0, 0, :3] = [[-1, -1], [1, 1], [0, 0]]       # corners, centre
    kw = dict(mode=mode, padding_mode=padding_mode,
              align_corners=align_corners)
    _same(_jax_outputs("grid_sample", (x, grid), kw),
          _port_outputs("grid_sample", (x, grid), kw))


@pytest.mark.parametrize("padding", ["VALID", "SAME", [[1, 2], [0, 3]]])
def test_extract_image_patches_paddings_match_jax(padding):
    x = np.random.default_rng(5).normal(size=(2, 7, 9, 3)).astype(
        np.float32)
    for ks, st, rt in (((3, 2), (2, 1), (1, 2)), ((2, 3), (1, 2), (2, 1))):
        args, kw = (x, ks, st), dict(rates=rt, padding=padding)
        _same(_jax_outputs("extract_image_patches", args, kw),
              _port_outputs("extract_image_patches", args, kw))


def test_quantize_linear_rounds_half_to_even_and_saturates():
    x = np.asarray([-300.0, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 300.0],
                   np.float32)
    for zp, lo, hi in ((np.int8(0), -128, 127), (np.uint8(10), 0, 255),
                       (None, 0, 255)):
        args = (x, np.float32(1.0)) + ((zp,) if zp is not None else ())
        kw = dict(axis=0, qmin=lo, qmax=hi)
        _same(_jax_outputs("quantize_linear", args, kw),
              _port_outputs("quantize_linear", args, kw))
    got = oc.as_numpy(_port_outputs("quantize_linear", (x, np.float32(1.0),
                                                        np.int8(0)),
                                    dict(axis=0, qmin=-128, qmax=127))[0])
    np.testing.assert_array_equal(got, [-128, -2, -2, 0, 0, 2, 2, 4, 127])


def test_onnx_slice_takes_the_exporters_int64_ends():
    """INT64_MAX / INT64_MIN ends and negative steps, as exported
    ``x[::-1]`` and ``x[1:]`` slices carry them."""
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    big = 2 ** 63 - 1
    for starts, ends, axes, steps in (
            ([-1], [-big - 1], [2], [-1]), ([1], [big], [1], [1]),
            ([0, 3], [big, -big], [0, -1], [1, -2]), ([5], [9], [2], [1])):
        kw = dict(starts=starts, ends=ends, axes=axes, steps=steps)
        _same(_jax_outputs("onnx_slice", (x,), kw),
              _port_outputs("onnx_slice", (x,), kw))


def _same_default(a, b):
    if a is b or a == b:
        return True
    try:
        return np.dtype(a) == np.dtype(b)
    except TypeError:
        return False


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
def test_cuda_onnx_ops_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (args, kwargs, _) in sorted(oc.onnx_cases(1).items()):
        outs = {}
        for dev in ("cpu", "cuda"):
            res = _port_outputs(name, args, kwargs, dev)
            assert all(r.device.type == dev for r in res), name
            outs[dev] = [oc.as_numpy(r) for r in res]
        for c, g in zip(outs["cpu"], outs["cuda"]):
            assert (g.dtype, g.shape) == (c.dtype, c.shape), name
            if c.dtype.kind in "biu":
                np.testing.assert_array_equal(g, c, err_msg=name)
            else:
                tol = 1e-4 * max(1.0, float(np.nanmax(np.abs(c)))
                                 if c.size else 1.0)
                np.testing.assert_allclose(g, c, rtol=1e-4, atol=tol,
                                           equal_nan=True, err_msg=name)
