"""PyTorch port, serving quantization helpers:
``deeplearning4j_tpu_torch/nn/precision.py`` against the int8 and fp8
sections of ``deeplearning4j_tpu/nn/precision.py`` on the same numpy
inputs. Quantized values and scales must be bit-equal, including the
±448 clip, all-zero channels and pages, and the fp8 scale floor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import precision as jprec
from deeplearning4j_tpu_torch.nn import precision as tprec


def _u8(x):
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_quantize_int8_is_bit_equal(axis):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((24, 40)) * 0.05).astype(np.float32)
    w[3] = 0.0                            # an all-zero row
    w[:, 5] = 0.0                         # an all-zero column
    w[7, 9] = 2.5                         # an outlier
    want = jprec.quantize_int8(jnp.asarray(w), axis=axis)
    got = tprec.quantize_int8(torch.from_numpy(w), axis=axis)
    assert got["q"].dtype == torch.int8 and got["axis"] == want["axis"]
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert tprec.is_int8(got) and not tprec.is_int8({"q": torch.zeros(1)})
    np.testing.assert_array_equal(
        tprec.dequantize_int8(got).numpy(),
        np.asarray(jprec.dequantize_int8(want)))


def test_int8_matmul_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    jq = jprec.quantize_int8(jnp.asarray(w), axis=1)
    tq = tprec.quantize_int8(torch.from_numpy(w), axis=1)
    want = np.asarray(jprec.int8_matmul(jnp.asarray(x), jq, jnp.float32))
    got = tprec.int8_matmul(torch.from_numpy(x), tq, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    plain = tprec.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                              torch.float32)
    np.testing.assert_allclose(plain.numpy(), x @ w, rtol=1e-5, atol=1e-5)


def test_fp8_quantize_is_bit_equal_with_clip_zero_and_floor():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((6, 4, 64)) * 50).astype(np.float32)
    x[0] = 0.0                                        # a zero page
    x[1] *= 1e-4                                      # below the floor
    amax = np.abs(x).max(axis=-1)
    jsc = jprec.fp8_scale(jnp.asarray(amax))
    tsc = tprec.fp8_scale(torch.from_numpy(amax))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    assert float(tsc[0].min()) == np.float32(tprec.FP8_SCALE_FLOOR)
    # a scale far too small: everything clips to ±448, never NaN
    for scale in (tsc[..., None], torch.full((6, 4, 1), 1e-3)):
        want = jprec.quantize_fp8(jnp.asarray(x),
                                  jnp.asarray(scale.numpy()))
        got = tprec.quantize_fp8(torch.from_numpy(x), scale)
        assert got.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                      _u8(want))
        assert not torch.isnan(got.float()).any()
        np.testing.assert_array_equal(
            tprec.dequantize_fp8(got, scale).numpy(),
            np.asarray(jprec.dequantize_fp8(want,
                                            jnp.asarray(scale.numpy()))))
    assert float(tprec.quantize_fp8(torch.tensor([1e9]), 1.0).float()) \
        == tprec.FP8_E4M3_MAX
    assert (tprec.dequantize_fp8(tprec.quantize_fp8(
        torch.from_numpy(x[0]), tsc[0, :, None]), tsc[0, :, None]) == 0).all()


def test_fp8_cast_matches_jax_over_many_values():
    """2 M values across the whole e4m3 range, ties included."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(1 << 20) * 100,
                        rng.uniform(-448, 448, 1 << 20)]).astype(np.float32)
    want = jprec.quantize_fp8(jnp.asarray(x), 1.0)
    got = tprec.quantize_fp8(torch.from_numpy(x), 1.0)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), _u8(want))


@pytest.mark.parametrize("name, want", [
    (None, None), ("", None), ("bf16", None), ("native", None),
    ("fp8", "fp8_e4m3"), ("E4M3", "fp8_e4m3"),
    ("float8_e4m3fn", "fp8_e4m3")])
def test_resolve_kv_dtype_matches_jax(name, want):
    assert tprec.resolve_kv_dtype(name) == jprec.resolve_kv_dtype(name) \
        == want


def test_unknown_kv_dtype_raises():
    with pytest.raises(ValueError, match="kv_dtype"):
        tprec.resolve_kv_dtype("int4")
    assert tprec.fp8_kv_dtype() == torch.float8_e4m3fn
