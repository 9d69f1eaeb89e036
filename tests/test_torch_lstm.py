"""PyTorch port, LSTM recurrence and layer: ``deeplearning4j_tpu_torch/ops/
lstm_recurrence.py`` and ``ops/nn.py::lstm_layer`` against
``deeplearning4j_tpu/ops/lstm_pallas.py`` and ``ops/nn.py::lstm_layer``
on the same numpy inputs at f32.

- The plain forward against the Pallas kernel run through the
  interpreter (``pallas_lstm_recurrence(..., interpret=True)``) and
  against the scan path of ``lstm_layer``: 1e-5 absolute (a few f32
  matmuls deep, different summation orders).
- The plain backward against ``jax.vjp`` through ``_recurrence`` (the
  Pallas forward with the cell stream, then ``_recurrence_bwd``): 1e-5 of
  max |grad|.
- ``lstm_layer`` forward and gradients, ``reverse`` on and off, against
  the JAX layer: 1e-5 of max |grad| (1e-5 absolute for values).

The CUDA kernels run only on the card: their tests carry the ``cuda``
marker, skip without one and import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_lstm.py``.
There f32 agrees with the plain version within 1e-5 (values) and 1e-4 of
max |grad| (gradients); bf16 within 2e-2 of the f32 plain version on the
bf16-rounded inputs.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr
from deeplearning4j_tpu_torch.ops import nn as tnn

ATOL = 1e-5


def _case(t, n, h, seed, nonzero_state=True, scale=0.5):
    rs = np.random.RandomState(seed)
    x_proj = (rs.randn(t, n, 4 * h) * scale).astype(np.float32)
    w_hh = (rs.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
    if nonzero_state:
        h0 = (rs.randn(n, h) * 0.5).astype(np.float32)
        c0 = (rs.randn(n, h) * 0.5).astype(np.float32)
    else:
        h0 = np.zeros((n, h), np.float32)
        c0 = np.zeros((n, h), np.float32)
    return x_proj, w_hh, h0, c0


def _t(*arrays, **kw):
    return [torch.from_numpy(np.array(a)).to(**kw) for a in arrays]


def _assert_rel(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


# ------------------------------------------------------- plain vs JAX (CPU)
@pytest.mark.parametrize("t, n, h", [(1, 3, 8), (7, 4, 16), (12, 2, 32)])
def test_plain_forward_matches_pallas_interpret(t, n, h):
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.lstm_pallas import pallas_lstm_recurrence

    case = _case(t, n, h, seed=t + n + h)
    want = pallas_lstm_recurrence(*(jnp.asarray(a) for a in case),
                                  interpret=True)
    got = lr.lstm_recurrence_reference(*_t(*case))
    for name, a, b in zip(("ys", "hT", "cT"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_plain_forward_matches_scan_and_streams_cells():
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.nn import lstm_layer as jax_lstm

    n, t, f, h = 3, 9, 5, 16
    rs = np.random.RandomState(1)
    x = rs.randn(n, t, f).astype(np.float32)
    w_ih = (rs.randn(f, 4 * h) * 0.3).astype(np.float32)
    w_hh = (rs.randn(h, 4 * h) * 0.2).astype(np.float32)
    b = (rs.randn(4 * h) * 0.1).astype(np.float32)
    h0 = rs.randn(n, h).astype(np.float32) * 0.3
    c0 = rs.randn(n, h).astype(np.float32) * 0.3
    ys_j, (hT_j, cT_j) = jax_lstm(*(jnp.asarray(a) for a in
                                    (x, w_ih, w_hh, b, h0, c0)),
                                  impl="scan")
    x_proj = (x.reshape(n * t, f) @ w_ih + b).reshape(n, t, 4 * h)
    x_proj = np.ascontiguousarray(x_proj.transpose(1, 0, 2))
    ys, hT, cT, cs = lr.lstm_recurrence_reference(
        *_t(x_proj, w_hh, h0, c0), collect_cell=True)
    np.testing.assert_allclose(ys.numpy().transpose(1, 0, 2),
                               np.asarray(ys_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hT_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(cT.numpy(), np.asarray(cT_j), atol=ATOL,
                               rtol=0)
    # the cell stream ends in cT and has one plane per step
    assert cs.shape == ys.shape
    np.testing.assert_array_equal(cs[-1].numpy(), cT.numpy())


@pytest.mark.parametrize("t, n, h, zero_state", [(1, 2, 8, False),
                                                 (6, 3, 16, False),
                                                 (10, 2, 24, True)])
def test_plain_backward_matches_jax_vjp(t, n, h, zero_state):
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.lstm_pallas import _recurrence

    case = _case(t, n, h, seed=10 + t, nonzero_state=not zero_state)
    rs = np.random.RandomState(99 + t)
    dys = rs.randn(t, n, h).astype(np.float32)
    dhT = rs.randn(n, h).astype(np.float32)
    dcT = rs.randn(n, h).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _recurrence(1, True, *a),
                     *(jnp.asarray(a) for a in case))
    want = vjp((jnp.asarray(dys), jnp.asarray(dhT), jnp.asarray(dcT)))
    ys, _, _, cs = lr.lstm_recurrence_reference(*_t(*case),
                                                collect_cell=True)
    got = lr.lstm_recurrence_backward_reference(
        *_t(*case), ys, cs, *_t(dys, dhT, dcT))
    for name, a, b in zip(("dx_proj", "dw_hh", "dh0", "dc0"), got, want):
        _assert_rel(a.numpy(), b, ATOL, name)


def test_backward_reference_defaults_to_zero_final_grads():
    case = _t(*_case(4, 2, 8, seed=3))
    ys, _, _, cs = lr.lstm_recurrence_reference(*case, collect_cell=True)
    dys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(0))
    a = lr.lstm_recurrence_backward_reference(*case, ys, cs, dys)
    b = lr.lstm_recurrence_backward_reference(
        *case, ys, cs, dys, torch.zeros(2, 8), torch.zeros(2, 8))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_autograd_op_runs_the_plain_backward_on_cpu():
    """On CPU tensors ``lstm_recurrence`` differentiates through
    ``lstm_recurrence_backward_reference`` and launches nothing."""
    case = _t(*_case(5, 3, 8, seed=4))
    leaves = [c.clone().requires_grad_(True) for c in case]
    before = (lr.fwd_launches, lr.bwd_launches)
    ys, hT, cT = lr.lstm_recurrence(*leaves)
    (ys.sum() + 2 * hT.sum() + 3 * cT.sum()).backward()
    assert (lr.fwd_launches, lr.bwd_launches) == before
    ys2, _, _, cs = lr.lstm_recurrence_reference(*case, collect_cell=True)
    torch.testing.assert_close(ys, ys2, rtol=0, atol=0)
    want = lr.lstm_recurrence_backward_reference(
        *case, ys2, cs, torch.ones_like(ys2), 2 * torch.ones(3, 8),
        3 * torch.ones(3, 8))
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)


def test_no_cell_stream_without_grad(monkeypatch):
    seen = []
    ref = lr.lstm_recurrence_reference

    def spy(*a, collect_cell=False):
        seen.append(collect_cell)
        return ref(*a, collect_cell=collect_cell)

    monkeypatch.setattr(lr, "lstm_recurrence_reference", spy)
    x, w, h0, c0 = _t(*_case(3, 2, 8, seed=5))
    w.requires_grad_(True)
    with torch.no_grad():
        lr.lstm_recurrence(x, w, h0, c0)
    lr.lstm_recurrence(x, w.detach(), h0, c0)
    lr.lstm_recurrence(x, w, h0, c0)
    assert seen == [False, False, True]


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax_forward_and_grads(reverse):
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.nn import lstm_layer as jax_lstm

    n, t, f, h = 3, 8, 6, 12
    rs = np.random.RandomState(7 + reverse)
    arrays = [rs.randn(n, t, f).astype(np.float32),
              (rs.randn(f, 4 * h) * 0.3).astype(np.float32),
              (rs.randn(h, 4 * h) * 0.2).astype(np.float32),
              (rs.randn(4 * h) * 0.1).astype(np.float32),
              (rs.randn(n, h) * 0.3).astype(np.float32),
              (rs.randn(n, h) * 0.3).astype(np.float32)]
    wy = rs.randn(n, t, h).astype(np.float32)
    wh, wc = rs.randn(n, h).astype(np.float32), rs.randn(n, h).astype(
        np.float32)

    def jloss(*a):
        ys, (hT, cT) = jax_lstm(*a, reverse=reverse, impl="pallas")
        return (jnp.sum(ys * wy) + jnp.sum(hT * wh) + jnp.sum(cT * wc),
                (ys, hT, cT))

    (jl, jout), jgrads = jax.value_and_grad(jloss, argnums=range(6),
                                            has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    ys, (hT, cT) = tnn.lstm_layer(*leaves[:4], h0=leaves[4], c0=leaves[5],
                                  reverse=reverse)
    loss = ((ys * torch.from_numpy(wy)).sum() + (hT * torch.from_numpy(
        wh)).sum() + (cT * torch.from_numpy(wc)).sum())
    loss.backward()
    for name, a, b in zip(("ys", "hT", "cT"), (ys, hT, cT), jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL, rtol=0, err_msg=name)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * max(
        1.0, abs(float(jl)))
    for name, leaf, g in zip(("x", "w_ih", "w_hh", "b", "h0", "c0"), leaves,
                             jgrads):
        _assert_rel(leaf.grad.numpy(), g, ATOL, name)


def test_lstm_layer_defaults_to_zero_state_and_time_major_projection():
    n, t, f, h = 2, 5, 3, 4
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, t, f, generator=g)
    w_ih = torch.randn(f, 4 * h, generator=g)
    w_hh = torch.randn(h, 4 * h, generator=g)
    b = torch.randn(4 * h, generator=g)
    ys, (hT, cT) = tnn.lstm_layer(x, w_ih, w_hh, b)
    xp = (x.reshape(n * t, f) @ w_ih + b).reshape(n, t, 4 * h).transpose(
        0, 1).contiguous()
    want = lr.lstm_recurrence_reference(xp, w_hh, torch.zeros(n, h),
                                        torch.zeros(n, h))
    torch.testing.assert_close(ys, want[0].transpose(0, 1), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(hT, want[1], rtol=1e-6, atol=1e-6)


def test_dropout_scales_kept_entries():
    x = torch.ones(2000)
    y = tnn.dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert 0.7 < float(kept.float().mean()) < 0.8
    assert tnn.dropout(x, 0.0) is x


def test_plain_bf16_carries_state_in_f32():
    """At bf16 the plain version keeps h and c in f32 between steps and
    rounds only what it stores (as the Pallas kernel does): its outputs
    are the f32 run's on the bf16-rounded inputs, rounded."""
    case = _t(*_case(6, 3, 16, seed=8))
    bf = [c.to(torch.bfloat16) for c in case]
    got = lr.lstm_recurrence_reference(*bf)
    assert all(o.dtype == torch.bfloat16 for o in got)
    ref = lr.lstm_recurrence_reference(*[c.float() for c in bf])
    for a, b in zip(got, ref):
        assert float((a.float() - b).abs().max()) <= 2e-2


# ------------------------------------------------------------ wrapper rules
@pytest.mark.parametrize("steps, n, h", [(0, 4, 8), (3, 0, 8), (3, 257, 8),
                                         (3, 4, 0), (3, 4, 513)])
def test_envelope_is_named_outside_it(steps, n, h):
    with pytest.raises(ValueError, match="the LSTM kernels take"):
        lr.check_envelope(steps, n, h)


def test_envelope_edges_are_inside():
    for shape in ((1, 1, 1), (1, 256, 512), (200, 256, 256)):
        lr.check_envelope(*shape)


@pytest.mark.parametrize("bad, err", [
    ("cpu", ValueError), ("f16", TypeError), ("mixed", TypeError),
    ("noncontig", ValueError), ("shape", ValueError)])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    x, w, h0, c0 = _t(*_case(3, 2, 8, seed=0))
    if bad == "f16":
        x, w, h0, c0 = (a.half() for a in (x, w, h0, c0))
    elif bad == "mixed":
        w = w.to(torch.bfloat16)
    elif bad == "noncontig":
        x = torch.cat([x, x], dim=2)[:, :, ::2]
    elif bad == "shape":
        h0 = torch.zeros(3, 8)
    before = lr.fwd_launches
    with pytest.raises(err):
        lr.lstm_recurrence_fwd(x, w, h0, c0)
    assert lr.fwd_launches == before


# ------------------------------------------------------------- on the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


CARD_SHAPES = [(1, 1, 256), (1, 256, 256), (50, 1, 256), (50, 256, 256),
               (1, 4, 256), (64, 4, 256), (7, 37, 40), (3, 5, 512),
               (200, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("t, n, h", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_forward_matches_plain(t, n, h, dtype):
    _need_card()
    case = [a.cuda().to(dtype) for a in _t(*_case(t, n, h, seed=t + n))]
    want = lr.lstm_recurrence_reference(*[a.float() for a in case],
                                        collect_cell=True)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for cells in (False, True):
        before = lr.fwd_launches
        got = lr.lstm_recurrence_fwd(*case, collect_cell=cells)
        torch.cuda.synchronize()
        assert lr.fwd_launches == before + 1
        assert len(got) == (4 if cells else 3)
        for a, b in zip(got, want):
            assert a.dtype == dtype and a.shape == b.shape
            err = float((a.float() - b).abs().max())
            assert err <= tol, f"{err:.3e} > {tol:g}"


@pytest.mark.cuda
@pytest.mark.parametrize("t, n, h", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain(t, n, h, dtype):
    _need_card()
    case = [a.cuda().to(dtype) for a in _t(*_case(t, n, h, seed=t + h))]
    g = torch.Generator(device="cuda").manual_seed(t)
    dys = torch.randn(t, n, h, generator=g, device="cuda").to(dtype)
    dhT = torch.randn(n, h, generator=g, device="cuda").to(dtype)
    dcT = torch.randn(n, h, generator=g, device="cuda").to(dtype)
    f32 = [a.float() for a in case]
    ys, _, _, cs = lr.lstm_recurrence_reference(*f32, collect_cell=True)
    want = lr.lstm_recurrence_backward_reference(
        *f32, ys, cs, dys.float(), dhT.float(), dcT.float())
    ys_k, _, _, cs_k = lr.lstm_recurrence_fwd(*case, collect_cell=True)
    before = lr.bwd_launches
    got = lr.lstm_recurrence_bwd(*case, ys_k, cs_k, dys, dhT, dcT)
    torch.cuda.synchronize()
    assert lr.bwd_launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("dx_proj", "dw_hh", "dh0", "dc0"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        err = float((a.float() - b).abs().max())
        scale = float(b.abs().max())
        assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} x {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("t, n, h", [(50, 256, 256), (64, 4, 256)])
def test_cuda_bf16_weight_grad_sums_f32_da(t, n, h):
    """At bf16 the weight gradient is the f32 sum of f32 da, cast once at
    the end (as ``_recurrence_bwd`` does): against the f32 plain backward
    over the kernel's own stored ys and cs it is off by no more than that
    last bf16 rounding."""
    _need_card()
    bf = torch.bfloat16
    case = [a.cuda().to(bf) for a in _t(*_case(t, n, h, seed=t))]
    g = torch.Generator(device="cuda").manual_seed(t + n)
    dys = torch.randn(t, n, h, generator=g, device="cuda").to(bf)
    ys, _, _, cs = lr.lstm_recurrence_fwd(*case, collect_cell=True)
    got = lr.lstm_recurrence_bwd(*case, ys, cs, dys)[1]
    want = lr.lstm_recurrence_backward_reference(
        *[a.float() for a in (*case, ys, cs, dys)])[1]
    err = float((got.float() - want).abs().max())
    assert err <= 2 ** -8 * float(want.abs().max())


@pytest.mark.cuda
def test_cuda_plans_are_cached_per_shape():
    """Launch plans are made once per shape and kept: going back to a
    shape after others (a larger shared-memory plan, then a smaller one)
    still launches and still matches the plain versions."""
    _need_card()
    for t, n, h in ((3, 5, 512), (4, 3, 40), (3, 5, 512), (4, 3, 40)):
        case = [a.cuda() for a in _t(*_case(t, n, h, seed=t + h))]
        got = lr.lstm_recurrence_fwd(*case)
        want = lr.lstm_recurrence_reference(*case)
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_layer_grads_match_cpu():
    """``lstm_layer`` on the card (both kernels) against the same layer
    on the CPU (both plain versions), f32, reverse on."""
    _need_card()
    rs = np.random.RandomState(3)
    n, t, f, h = 4, 30, 10, 64
    arrays = [rs.randn(n, t, f).astype(np.float32),
              (rs.randn(f, 4 * h) * 0.3).astype(np.float32),
              (rs.randn(h, 4 * h) * 0.1).astype(np.float32),
              (rs.randn(4 * h) * 0.1).astype(np.float32)]
    out = {}
    for dev in ("cpu", "cuda"):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_(True)
                  for a in arrays]
        ys, (hT, cT) = tnn.lstm_layer(*leaves, reverse=True)
        (ys.square().sum() + hT.sum() + cT.sum()).backward()
        out[dev] = [ys.detach().cpu()] + [l.grad.cpu() for l in leaves]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 257, 8), (3, 4, 513)])
def test_cuda_out_of_envelope_raises(shape):
    _need_card()
    t, n, h = shape
    x = torch.zeros(t, n, 4 * h, device="cuda")
    w = torch.zeros(h, 4 * h, device="cuda")
    s = torch.zeros(n, h, device="cuda")
    before = lr.fwd_launches
    with pytest.raises(ValueError, match="the LSTM kernels take"):
        lr.lstm_recurrence(x, w, s, s)
    with pytest.raises(ValueError, match="the LSTM kernels take"):
        lr.lstm_recurrence_fwd(x, w, s, s)
    assert lr.fwd_launches == before
