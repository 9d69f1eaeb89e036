"""PyTorch port, paged attention: ``deeplearning4j_tpu_torch/ops/
paged_attention.py`` against the JAX op (``ops/paged_attention_pallas.py``)
on the same numpy inputs at f32.

The port's plain reference is held against the JAX package's XLA
reference (``mode="xla"``) and against the Pallas kernel run through the
Pallas interpreter (``mode="interpret"``), which is how the JAX
package's own tests run it on the CPU. Tolerance: 1e-5 absolute and
relative — the same formula in f32, only the summation order differs
(the kernel's online softmax reduces page by page).

The CUDA kernel itself runs only on the card: its test carries the
``cuda`` marker and skips without one. JAX is imported inside the tests
that compare with it, so the card's tests run where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_paged_attention.py``.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.ops import paged_attention as pa

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, Q, P, N=3, H=2, hd=8, ps=4, L=2):
    """Pools, queries, tables and qbase with: a shared page (row 1 reads
    row 0's first page), a null-page tail (row 2, P > 1), and qbase at 0
    (row 1) and at full context (row 0)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + N * P
    k = rng.standard_normal((L, n_pages, H, ps, hd)).astype(np.float32)
    v = rng.standard_normal((L, n_pages, H, ps, hd)).astype(np.float32)
    q = rng.standard_normal((N, H, Q, hd)).astype(np.float32)
    tables = (1 + np.arange(N * P).reshape(N, P)).astype(np.int32)
    tables[1, 0] = tables[0, 0]
    real = max(1, P - 1)
    tables[2, real:] = 0
    qbase = np.array([P * ps - Q, 0, max(0, real * ps - Q - 1)], np.int32)
    return q, k, v, tables, qbase


def _torch_args(q, k, v, tables, qbase):
    return (torch.from_numpy(q), {"k": torch.from_numpy(k),
                                  "v": torch.from_numpy(v)},
            torch.from_numpy(tables), torch.from_numpy(qbase))


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("Q", [1, 3])
def test_reference_matches_jax(Q, P, mode):
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.paged_attention_pallas import (
        paged_attention as jax_paged_attention)

    q, k, v, tables, qbase = _case(10 * Q + P, Q, P)
    layer = 1
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, layer,
        jnp.asarray(tables), jnp.asarray(qbase), mode=mode))
    tq, tkv, tt, tb = _torch_args(q, k, v, tables, qbase)
    got = pa.paged_attention_reference(tq, tkv, layer, tt, tb)
    assert got.dtype == torch.float32 and got.shape == (3, 2, Q, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mask_value_is_finfo_min_not_inf():
    """Trap: masked logits take ``finfo(dtype).min``, as in the JAX
    reference. A row whose every key is masked (qbase -1) then softmaxes
    to uniform weights, the mean of V; ``-inf`` would give NaN."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.paged_attention_pallas import (
        paged_attention as jax_paged_attention)

    q, k, v, tables, qbase = _case(5, 1, 2)
    qbase[:] = -1
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, 0,
        jnp.asarray(tables), jnp.asarray(qbase), mode="xla"))
    tq, tkv, tt, tb = _torch_args(q, k, v, tables, qbase)
    got = pa.paged_attention_reference(tq, tkv, 0, tt, tb).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got[0, :, 0], v[0, tables[0]].transpose(1, 0, 2, 3)
        .reshape(2, -1, 8).mean(axis=1), **TOL)


def test_cpu_dispatch_takes_reference_and_launches_nothing():
    q, k, v, tables, qbase = _case(0, 2, 3)
    args = _torch_args(q, k, v, tables, qbase)
    before = pa.launches
    got = pa.paged_attention(args[0], args[1], 0, args[2], args[3])
    want = pa.paged_attention_reference(args[0], args[1], 0, args[2], args[3])
    assert torch.equal(got, want)
    assert pa.launches == before


def test_first_position_only_returns_that_value():
    """qbase 0, Q 1: every key but flat position 0 is masked, so the
    context is exactly v at (first page, offset 0)."""
    q, k, v, tables, qbase = _case(3, 1, 3)
    tq, tkv, tt, tb = _torch_args(q, k, v, tables, qbase)
    out = pa.paged_attention_reference(tq, tkv, 0, tt, tb)
    np.testing.assert_allclose(out[1, :, 0].numpy(),
                               v[0, tables[1, 0], :, 0], atol=1e-6)


def test_fp8_tree_raises():
    q, k, v, tables, qbase = _case(0, 1, 1)
    tq, tkv, tt, tb = _torch_args(q, k, v, tables, qbase)
    tkv["k_scale"] = torch.ones(k.shape[:3])
    tkv["v_scale"] = torch.ones(k.shape[:3])
    with pytest.raises(NotImplementedError, match="fp8"):
        pa.paged_attention(tq, tkv, 0, tt, tb)
    with pytest.raises(NotImplementedError, match="fp8"):
        pa.paged_attention_kernel(tq, tkv, 0, tt, tb)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the kernel wrapper raises; it never computes the
    result another way."""
    tq, tkv, tt, tb = _torch_args(*_case(0, 1, 1))
    before = pa.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_attention_kernel(tq, tkv, 0, tt, tb)
    assert pa.launches == before


@pytest.mark.parametrize("bad, match", [
    (dict(q_dtype=torch.float16), "float32 or bfloat16"),
    (dict(pool_dtype=torch.bfloat16), "must match"),
    (dict(tables_dtype=torch.int64), "int32"),
    (dict(hd=48), "multiple of 32"),
    (dict(Q=33), "1..32 query rows"),
    (dict(layer=2), "outside the pool"),
    (dict(qbase_len=3), "qbase"),
    (dict(q_noncontig=True, Q=2), "contiguous"),
])
def test_kernel_argument_checks(bad, match):
    hd, Q = bad.get("hd", 32), bad.get("Q", 1)
    q = torch.zeros(2, 2, Q, hd, dtype=bad.get("q_dtype", torch.float32))
    if bad.get("q_noncontig"):
        q = torch.zeros(2, 2, hd, Q).transpose(2, 3)
    k = torch.zeros(2, 3, 2, 4, hd, dtype=bad.get("pool_dtype", q.dtype))
    tables = torch.zeros(2, 2, dtype=bad.get("tables_dtype", torch.int32))
    qbase = torch.zeros(bad.get("qbase_len", 2), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError), match=match):
        pa._check_kernel_args(q, k, k.clone(), bad.get("layer", 0), tables,
                              qbase)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises instead of leaving a half-made
    library."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build(["paged_attention"])
    assert not any(p.suffix == ".so" for p in tmp_path.rglob("*"))


def test_library_path_follows_source_and_flags(monkeypatch):
    a = native.library_path("paged_attention")
    assert a.startswith(native.BUILD_DIR) and a.endswith(".so")
    monkeypatch.setattr(native, "NVCC_FLAGS", native.NVCC_FLAGS + ("-G",))
    assert native.library_path("paged_attention") != a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Q", [1, 4])
def test_cuda_kernel_matches_reference(Q, dtype, tol):
    """On the card: kernel vs the plain version on the same inputs; bf16
    pools are held against the reference run at f32 on the bf16-rounded
    inputs (tolerance 2e-2, the bf16 output rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, tables, qbase = _case(7, Q, 5, N=3, H=4, hd=64, ps=16)
    tq, tkv, tt, tb = (x.cuda() if torch.is_tensor(x)
                       else {n: t.cuda() for n, t in x.items()}
                       for x in _torch_args(q, k, v, tables, qbase))
    lq = tq.to(dtype)
    lkv = {n: t.to(dtype) for n, t in tkv.items()}
    before = pa.launches
    got = pa.paged_attention(lq, lkv, 1, tt, tb)
    torch.cuda.synchronize()
    assert pa.launches == before + 1 and got.dtype == dtype
    want = pa.paged_attention_reference(
        lq.float(), {n: t.float() for n, t in lkv.items()}, 1, tt, tb)
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
