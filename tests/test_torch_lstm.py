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
- Mixed f32 / bf16 inputs (x_proj, w_hh, h0 and c0 in the three mixes
  the Pallas kernel is called with) through ``lstm_recurrence``: outputs
  and gradients in the JAX dtypes, within 1e-6 of the JAX values (of
  max |grad| for gradients; the same roundings on both sides).

The CUDA kernels run only on the card: their tests carry the ``cuda``
marker, skip without one and import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_lstm.py``.
There f32 agrees with the plain version within 1e-5 (values) and 1e-4 of
max |grad| (gradients); bf16 within 2e-2 of the f32 plain version on the
bf16-rounded inputs; mixed calls (the f32 grid route over widened inputs)
within 1e-5 of the plain version on the same mixed inputs (values; 2e-3
where a bf16 w_hh makes the recurrence round h, one bf16 step for bf16
values) and 1e-4 of max |grad|.
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


#: (x_proj, w_hh, h0 and c0) dtypes of the mixed calls
MIXES = [("f32", "bf16", "f32"), ("bf16", "f32", "bf16"),
         ("bf16", "bf16", "f32")]
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _mixed(case, mix, **kw):
    kinds = (mix[0], mix[1], mix[2], mix[2])
    return [torch.from_numpy(a).to(_TORCH[k]).to(**kw)
            for a, k in zip(case, kinds)]


@pytest.mark.parametrize("mix", MIXES, ids=["-".join(m) for m in MIXES])
def test_mixed_dtypes_match_jax(mix):
    """x_proj, w_hh and the state in different dtypes: the port's
    dispatcher (the plain versions on the CPU) against the Pallas kernel
    through the interpreter and ``jax.vjp`` through ``_recurrence``:
    output dtypes x_proj's, gradient dtypes their primals', values within
    1e-6 (of max |grad| for the gradients)."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.lstm_pallas import (_recurrence,
                                                     pallas_lstm_recurrence)

    jt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    t, n, h = 6, 3, 16
    case = _case(t, n, h, seed=21)
    rs = np.random.RandomState(22)
    cots = [rs.randn(t, n, h), rs.randn(n, h), rs.randn(n, h)]
    kinds = (mix[0], mix[1], mix[2], mix[2])
    jins = [jnp.asarray(a).astype(jt[k]) for a, k in zip(case, kinds)]
    want = pallas_lstm_recurrence(*jins, interpret=True)
    _, vjp = jax.vjp(lambda *a: _recurrence(1, True, *a), *jins)
    jcots = [jnp.asarray(c, jnp.float32).astype(jt[mix[0]]) for c in cots]
    want_grads = vjp(tuple(jcots))

    leaves = [a.requires_grad_(True) for a in _mixed(case, mix)]
    got = lr.lstm_recurrence(*leaves)
    for name, a, b in zip(("ys", "hT", "cT"), got, want):
        assert a.dtype == _TORCH[mix[0]], name
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), atol=1e-6,
                                   rtol=0, err_msg=name)
    torch.autograd.backward(got, [
        torch.from_numpy(np.asarray(c, np.float32)).to(a.dtype)
        for c, a in zip(jcots, got)])
    for name, leaf, g in zip(("x_proj", "w_hh", "h0", "c0"), leaves,
                             want_grads):
        assert leaf.grad.dtype == leaf.dtype, name
        _assert_rel(leaf.grad.float().numpy(), np.asarray(g, np.float32),
                    1e-6, name)


def _layer_grads_against_jax(arrays, dtype, jdtype, val_tol, grad_tol):
    """``lstm_layer`` of both packages (JAX through its Pallas kernel in
    the interpreter) on the same numpy inputs cast to one dtype: outputs
    within ``val_tol``, gradients of ``sum(ys * w)`` within ``grad_tol``
    of max |grad|, each in the primal's dtype."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.nn import lstm_layer as jax_lstm

    wy = np.random.RandomState(len(arrays[0])).randn(
        *arrays[0].shape[:2], arrays[2].shape[0]).astype(np.float32)

    def jloss(*a):
        ys, _ = jax_lstm(*a, impl="pallas")
        return jnp.sum(ys.astype(jnp.float32) * wy), ys

    (_, jys), jgrads = jax.value_and_grad(jloss, argnums=range(4),
                                          has_aux=True)(
        *(jnp.asarray(a).astype(jdtype) for a in arrays))
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in arrays]
    ys, _ = tnn.lstm_layer(*leaves)
    (ys.float() * torch.from_numpy(wy)).sum().backward()
    assert ys.dtype == dtype
    np.testing.assert_allclose(ys.detach().float().numpy(),
                               np.asarray(jys, np.float32), atol=val_tol,
                               rtol=0)
    for name, leaf, g in zip(("x", "w_ih", "w_hh", "b"), leaves, jgrads):
        assert leaf.grad.dtype == dtype, name
        _assert_rel(leaf.grad.float().numpy(), np.asarray(g, np.float32),
                    grad_tol, name)


def test_f16_lstm_layer_matches_jax():
    """f16 (C9): the port's plain path against the Pallas kernel at f16,
    outputs within 1e-3 (two f16 steps below 1), gradients within 2e-3 of
    max |grad| (f16 roundings of the sums at other points)."""
    rs = np.random.RandomState(11)
    n, t, f, h = 3, 8, 6, 12
    arrays = [rs.randn(n, t, f).astype(np.float32),
              (rs.randn(f, 4 * h) * 0.3).astype(np.float32),
              (rs.randn(h, 4 * h) * 0.2).astype(np.float32),
              (rs.randn(4 * h) * 0.1).astype(np.float32)]
    import jax.numpy as jnp

    _layer_grads_against_jax(arrays, torch.float16, jnp.float16, 1e-3, 2e-3)


def test_plain_bf16_wide_matches_pallas_interpret():
    """The wide route's width at bf16 (H=512): the plain versions against
    the Pallas kernel through the interpreter and ``jax.vjp`` through
    ``_recurrence`` on the same bf16 inputs; outputs and gradients bf16,
    within one bf16 step (2^-7) of the largest value (f32 sums of 512
    products in another order can flip a rounding)."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.lstm_pallas import (_recurrence,
                                                     pallas_lstm_recurrence)

    t, n, h = 3, 2, 512
    case = _case(t, n, h, seed=23)
    rs = np.random.RandomState(24)
    cots = [rs.randn(t, n, h), rs.randn(n, h), rs.randn(n, h)]
    jins = [jnp.asarray(a).astype(jnp.bfloat16) for a in case]
    want = pallas_lstm_recurrence(*jins, interpret=True)
    _, vjp = jax.vjp(lambda *a: _recurrence(1, True, *a), *jins)
    jgrads = vjp(tuple(jnp.asarray(c).astype(jnp.bfloat16) for c in cots))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in case]
    got = lr.lstm_recurrence_reference(*bf, collect_cell=True)
    for name, a, b in zip(("ys", "hT", "cT"), got, want):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b.astype(jnp.float32))
        err = float(np.abs(a.float().numpy() - b).max())
        assert err <= 2 ** -7 * max(1.0, float(np.abs(b).max())), name
    tcots = [torch.from_numpy(c.astype(np.float32)).to(torch.bfloat16)
             for c in cots]
    grads = lr.lstm_recurrence_backward_reference(*bf, got[0], got[3],
                                                  *tcots)
    for name, a, b in zip(("dx_proj", "dw_hh", "dh0", "dc0"), grads,
                          jgrads):
        assert a.dtype == torch.bfloat16, name
        _assert_rel(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                    2 ** -7, name)


def test_wide_lstm_layer_matches_jax():
    """N=300 and H=1024 (C10: the grid route's wide shapes) at f32,
    two steps: within 1e-5 (values) and 1e-5 of max |grad|."""
    rs = np.random.RandomState(12)
    n, t, f, h = 300, 2, 5, 1024
    arrays = [rs.randn(n, t, f).astype(np.float32),
              (rs.randn(f, 4 * h) * 0.3).astype(np.float32),
              (rs.randn(h, 4 * h) * 0.03).astype(np.float32),
              (rs.randn(4 * h) * 0.1).astype(np.float32)]
    import jax.numpy as jnp

    _layer_grads_against_jax(arrays, torch.float32, jnp.float32, ATOL, ATOL)


# ------------------------------------------------------------ wrapper rules
@pytest.mark.parametrize("steps, n, h", [(0, 4, 8), (3, 0, 8), (-1, 4, 8),
                                         (3, 4, 0), (3, 2 ** 20, 2 ** 10)])
def test_envelope_is_named_outside_it(steps, n, h):
    """The kernels take every T, N and H the reference's scan takes;
    only empty sizes and 32-bit overflow of a step's rows are outside."""
    with pytest.raises(ValueError, match="the LSTM kernels take"):
        lr.check_envelope(steps, n, h)


def test_envelope_edges_are_inside():
    for shape in ((1, 1, 1), (1, 256, 512), (200, 256, 256), (3, 257, 8),
                  (3, 4, 513), (200, 512, 1024), (2, 8, 2048)):
        lr.check_envelope(*shape)


@pytest.mark.parametrize("bad, err", [
    ("cpu", ValueError), ("f16", ValueError), ("mixed", ValueError),
    ("noncontig", ValueError), ("shape", ValueError)])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    """Every refusal raises before a launch. Mixed f32 / bf16 inputs and
    f16 are taken (the Pallas kernel takes them: the wrapper widens them
    to f32), so on CPU tensors those calls are refused for the device
    (ValueError)."""
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


# ------------------------------------------- backward routes (plain Python)
@pytest.mark.parametrize("h", [64, 128, 256])
def test_bf16_split3_gives_the_f32_product(h):
    """The cluster route's dh product: f32 da split into three bf16 terms,
    each term times a bf16 w_hh exactly, the three products summed in f32,
    is ``da @ w_hh.float().T`` to f32 rounding (against float64: within
    a few f32 ulps of the row's sum of |terms|, as the f32 product is)."""
    rs = np.random.RandomState(h)
    # da over several binades, as the recurrence's da is
    da = (rs.randn(16, 4 * h) * np.exp2(rs.randint(-12, 4, (16, 4 * h)))) \
        .astype(np.float32)
    w = torch.from_numpy((rs.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)) \
        .to(torch.bfloat16)
    t_da = torch.from_numpy(da)
    hi, mid, lo = lr.bf16_split3(t_da)
    # the split is exact to 2^-24 of |da| element by element
    rest = t_da.double() - hi.double() - mid.double() - lo.double()
    assert float((rest.abs() - 2.0 ** -24 * t_da.double().abs()).max()) <= 0
    wf = w.float()
    got = (hi.float() @ wf.T) + (mid.float() @ wf.T) + (lo.float() @ wf.T)
    f32 = t_da @ wf.T
    exact = t_da.double() @ wf.double().T
    mag = t_da.double().abs() @ wf.double().abs().T
    eps = 2.0 ** -24
    assert float(((got.double() - exact).abs() - 8 * 4 * h * eps * mag)
                 .max()) <= 0
    assert float(((got.double() - f32.double()).abs()
                  - 16 * 4 * h * eps * mag).max()) <= 0
    # one bf16 term alone is far off: the split is what carries f32
    single = hi.float() @ wf.T
    assert float((single.double() - exact).abs().max()) \
        > 100 * float((got.double() - exact).abs().max())


def _route_case(dtype, h, n=4, offset=False):
    x = torch.zeros(3, n, 4 * h, dtype=dtype)
    w = torch.zeros(h, 4 * h, dtype=dtype)
    h0 = torch.zeros(n, h, dtype=dtype)
    ys = torch.zeros(3 * n * h + 1, dtype=dtype)
    ys = (ys[1:] if offset else ys[:-1]).view(3, n, h)
    return x, w, h0, ys


@pytest.mark.parametrize("dtype, h, offset, want", [
    (torch.bfloat16, 256, False, "cluster"),   # the training shape's width
    (torch.bfloat16, 128, False, "cluster"),
    (torch.bfloat16, 64, False, "cluster"),
    (torch.bfloat16, 512, False, "wide"),      # past the cluster route
    (torch.bfloat16, 1024, False, "wide"),     # the JAX bench's wide width
    (torch.bfloat16, 2048, False, "grid"),     # past the wide envelope
    (torch.bfloat16, 200, False, "grid"),      # not a multiple of 64
    (torch.bfloat16, 40, False, "grid"),
    (torch.float32, 256, False, "grid"),       # f32 keeps the first design
    (torch.float32, 1024, False, "grid"),
    (torch.bfloat16, 256, True, "grid"),       # ys off a 16-byte boundary
    (torch.bfloat16, 1024, True, "grid"),
])
def test_bwd_route(dtype, h, offset, want):
    assert lr.bwd_route(*_route_case(dtype, h, offset=offset)) == want


def _fwd_route_case(dtype, h, n=4, offset=False):
    x = torch.zeros(3 * n * 4 * h + 8, dtype=dtype)
    x = (x[1:1 + 3 * n * 4 * h] if offset else x[:3 * n * 4 * h]) \
        .view(3, n, 4 * h)
    return (x, torch.zeros(h, 4 * h, dtype=dtype),
            torch.zeros(n, h, dtype=dtype))


@pytest.mark.parametrize("dtype, h, offset, want", [
    (torch.bfloat16, 256, False, "cluster"),   # the training shape's width
    (torch.bfloat16, 128, False, "cluster"),
    (torch.bfloat16, 64, False, "cluster"),
    (torch.bfloat16, 512, False, "wide"),      # past the cluster route
    (torch.bfloat16, 1024, False, "wide"),     # the JAX bench's wide width
    (torch.bfloat16, 2048, False, "grid"),     # past the wide envelope
    (torch.bfloat16, 200, False, "grid"),      # not a multiple of 64
    (torch.bfloat16, 40, False, "grid"),
    (torch.float32, 256, False, "grid"),       # f32 keeps the first design
    (torch.float32, 1024, False, "grid"),
    (torch.bfloat16, 256, True, "grid"),       # x_proj off a 16-byte boundary
    (torch.bfloat16, 1024, True, "grid"),
])
def test_fwd_route(dtype, h, offset, want):
    assert lr.fwd_route(*_fwd_route_case(dtype, h, offset=offset)) == want


def test_wide_envelope_edge():
    """The wide route's widths: the multiples of 64 past the cluster
    route's 256, up to the largest H whose H / 8 blocks (8 units each,
    their w_hh columns and rows held in registers) the H100's 132 SMs hold
    at once, one to an SM: 132 x 8 = 1056, so 1024."""
    assert lr.WIDE_MAX_HIDDEN == 1024 == 132 * lr.WIDE_UNITS // 64 * 64
    assert lr.WIDE_HIDDEN == tuple(range(320, 1025, 64))
    assert 512 in lr.WIDE_HIDDEN and 1024 in lr.WIDE_HIDDEN
    assert 1088 not in lr.WIDE_HIDDEN and 256 not in lr.WIDE_HIDDEN
    for h, want in ((1024, "wide"), (1088, "grid"), (320, "wide"),
                    (288, "grid")):
        assert lr.fwd_route(*_fwd_route_case(torch.bfloat16, h, n=1)) == want
    # the backward's scratch: dc and one dh partial per 512 da columns
    assert lr.wide_scratch_planes(1024, True) == 9
    assert lr.wide_scratch_planes(320, True) == 4
    assert lr.wide_scratch_planes(1024, False) == 1


@pytest.mark.parametrize("mix", MIXES, ids=["-".join(m) for m in MIXES])
def test_mixed_calls_take_the_grid_route(mix):
    """A call that mixes dtypes runs the grid route over widened inputs,
    in both directions, whatever its width."""
    x, w, h0, c0 = _mixed(_case(3, 4, 256, seed=1), mix)
    ys = torch.zeros(3, 4, 256, dtype=x.dtype)
    assert lr.fwd_route(x, w, h0, c0) == "grid"
    assert lr.bwd_route(x, w, h0, ys, c0) == "grid"
    # a bf16 call whose c0 alone is f32 is mixed too
    bf = [a.to(torch.bfloat16) for a in (x, w, h0)]
    assert lr.fwd_route(*bf) == "cluster"
    assert lr.fwd_route(*bf, c0.float()) == "grid"
    assert lr.bwd_route(*bf, ys.to(torch.bfloat16), c0.float()) == "grid"


def _probe_copies():
    from deeplearning4j_tpu_torch.tools import lstm_probe

    return [("split", lstm_probe.SPLIT)] + list(lstm_probe.VARIANTS.items())


@pytest.mark.parametrize("name, subs", _probe_copies(),
                         ids=[n for n, _ in _probe_copies()])
def test_lstm_probe_edits_find_their_anchors(name, subs):
    """``tools/lstm_probe.py`` measures edited copies of the kernel
    source: every text substitution must still find its anchor, once."""
    from deeplearning4j_tpu_torch.ops import native

    src = open(native._source("lstm_recurrence")).read()
    for old, new in subs:
        assert src.count(old) == 1, f"{name}: {old!r}"
        src = src.replace(old, new)


def _wide_probe_copies():
    from deeplearning4j_tpu_torch.tools import lstm_probe

    return ([("wide split", lstm_probe.WIDE_SPLIT)]
            + list(lstm_probe.WIDE_VARIANTS.items()))


@pytest.mark.parametrize("name, subs", _wide_probe_copies(),
                         ids=[n for n, _ in _wide_probe_copies()])
def test_lstm_probe_wide_edits_find_their_anchors(name, subs):
    """The wide mode's edits: each anchor is in the source (some stand in
    both wide kernels, and edit both); the split instruments every phase
    it names in both kernels."""
    from deeplearning4j_tpu_torch.ops import native
    from deeplearning4j_tpu_torch.tools import lstm_probe

    src = open(native._source("lstm_recurrence")).read()
    for old, new in subs:
        assert src.count(old) >= 1, f"{name}: {old!r}"
        src = src.replace(old, new)
    if name == "wide split":
        for i in range(len(lstm_probe.WIDE_BWD_PHASES)):
            assert f"prof[{i}] += now - last" in src


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


#: grid-route shapes with N > 256 or H > 512 (C10), with where the plan
#: keeps w_hh on the H100 (1 in shared memory, 0 read from L2)
#: in the forward and the backward; at N=512, H=1024 the forward's 128
#: blocks (one per unit tile, 146 KiB each) walk 4 batch tiles apiece
WIDE_SHAPES = [((3, 257, 8), (1, 1)), ((3, 4, 513), (1, 1)),
               ((3, 512, 1024), (1, 0)), ((2, 8, 2048), (0, 0))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, resident", WIDE_SHAPES,
                         ids=["x".join(map(str, s)) for s, _ in WIDE_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_out_of_envelope_raises(shape, resident, dtype):
    """Wide shapes (N > 256 or H > 512) compute on the grid route (forced
    for bf16 at H=1024, which takes the wide route by default), both
    directions, against the plain versions (f32 within
    1e-5 / 1e-4 of max |grad|, bf16 within 2e-2 of the f32 plain
    version): blocks walk several tiles (N=512 at H=1024, whose forward
    keeps w_hh in shared memory) or read w_hh from L2 (the backward at
    H=1024, both at H=2048, whose w_hh no block can keep)."""
    _need_card()
    t, n, h = shape
    case, ys, cs, dys, fin = _bwd_case(t, n, h, seed=n + h, dtype=dtype)
    # bf16 at H=1024 takes the wide route by default; the grid route is
    # forced here
    wide = dtype == torch.bfloat16 and h in lr.WIDE_HIDDEN
    assert lr.fwd_route(*case) == ("wide" if wide else "grid")
    want = lr.lstm_recurrence_reference(*[a.float() for a in case],
                                        collect_cell=True)
    before = (lr.fwd_launches, lr.bwd_launches)
    got = lr.lstm_recurrence_fwd(*case, route="grid")
    torch.cuda.synchronize()
    assert lr.last_plan[6] == resident[0]
    walks = {(3, 257, 8): 1, (3, 4, 513): 1, (3, 512, 1024): 4}.get(shape)
    assert walks is None or lr.last_plan[5] == walks
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a.float() - b).abs().max()) <= tol
    grads = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin, route="grid")
    torch.cuda.synchronize()
    assert lr.last_plan[6] == resident[1]
    assert (lr.fwd_launches, lr.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    _assert_bwd_matches_plain(case, ys, cs, dys, fin, grads,
                              1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t, n, h", [(3, 512, 256), (4, 300, 128),
                                     (2, 1000, 64)])
def test_cuda_cluster_routes_past_256_rows(t, n, h):
    """bf16 batches past 256 rows take the cluster routes, more clusters
    than the card holds at once (they wait for each other in no way):
    both directions against the plain versions, within 2e-2."""
    _need_card()
    case, ys, cs, dys, fin = _bwd_case(t, n, h, seed=n + h)
    assert lr.fwd_route(*case) == "cluster"
    assert lr.bwd_route(case[0], case[1], case[2], ys) == "cluster"
    want = lr.lstm_recurrence_reference(*[a.float() for a in case],
                                        collect_cell=True)
    got = lr.lstm_recurrence_fwd(*case, collect_cell=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert float((a.float() - b).abs().max()) <= 2e-2
    grads = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin)
    torch.cuda.synchronize()
    _assert_bwd_matches_plain(case, ys, cs, dys, fin, grads, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("h", [40, 256])
def test_cuda_f16_matches_plain(h, w_dtype):
    """f16 calls (C9): x_proj and the state f16, w_hh f16 or bf16, run
    the grid route at f32 over widened inputs with h rounded to w_hh's
    type before the product, as the plain version rounds it; outputs and
    gradients in the primal dtypes, values within 2e-3 (about two f16
    steps), gradients within 2e-3 of max |grad| (f16), or one bf16 step,
    2^-7 of it, for a bf16 w_hh's (each side rounds its f32 sum once)."""
    _need_card()
    f16 = torch.float16
    x, w, h0, c0 = _t(*_case(20, 6, h, seed=h), device="cuda")
    case = [x.to(f16), w.to(w_dtype), h0.to(f16), c0.to(f16)]
    leaves = [a.clone().requires_grad_(True) for a in case]
    got = lr.lstm_recurrence(*leaves)
    want = lr.lstm_recurrence_reference(*case)
    for a, b in zip(got, want):
        assert a.dtype == f16
        assert float((a.detach().float() - b.float()).abs().max()) <= 2e-3
    g = torch.Generator(device="cuda").manual_seed(h)
    cots = [torch.randn(o.shape, generator=g, device="cuda").to(f16)
            for o in got]
    torch.autograd.backward(got, cots)
    ys, _, _, cs = lr.lstm_recurrence_reference(*case, collect_cell=True)
    ref = lr.lstm_recurrence_backward_reference(*case, ys, cs, *cots)
    for leaf, b in zip(leaves, ref):
        assert leaf.grad.dtype == leaf.dtype
        err = float((leaf.grad.float() - b.float()).abs().max())
        tol = 2e-3 if leaf.dtype == f16 else 2.0 ** -7
        assert err <= tol * float(b.float().abs().max())


# ------------------------------------------- backward cluster route (card)
def _bwd_case(t, n, h, seed, finals=True, dtype=torch.bfloat16):
    case = [a.cuda().to(dtype) for a in _t(*_case(t, n, h, seed=seed))]
    g = torch.Generator(device="cuda").manual_seed(seed)
    dys = torch.randn(t, n, h, generator=g, device="cuda").to(dtype)
    finals = [torch.randn(n, h, generator=g, device="cuda").to(dtype)
              if finals else None for _ in range(2)]
    ys, _, _, cs = lr.lstm_recurrence_fwd(*case, collect_cell=True)
    return case, ys, cs, dys, finals


def _assert_bwd_matches_plain(case, ys, cs, dys, finals, got, tol):
    want = lr.lstm_recurrence_backward_reference(
        *[a.float() for a in (*case, ys, cs, dys)],
        *[None if f is None else f.float() for f in finals])
    for name, a, b in zip(("dx_proj", "dw_hh", "dh0", "dc0"), got, want):
        assert a.dtype == case[0].dtype and a.shape == b.shape, name
        err = float((a.float() - b).abs().max())
        scale = float(b.abs().max())
        assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} x {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("finals", [True, False])
@pytest.mark.parametrize("n", [1, 17, 256])
@pytest.mark.parametrize("t", [1, 2, 200])
def test_cuda_cluster_backward_matches_plain(t, n, finals):
    """The cluster route (bf16, H=256) against the f32 plain backward on
    the kernel's own ys and cs, within 2e-2 of max |grad|: the first and
    last steps (T=1, 2), ragged rows (N=1, 17) and the training shape,
    dhT and dcT given or None; d w_hh within 2^-8 of its f32 sum."""
    _need_card()
    case, ys, cs, dys, fin = _bwd_case(t, n, 256, seed=t + n, finals=finals)
    assert lr.bwd_route(case[0], case[1], case[2], ys) == "cluster"
    before = lr.bwd_launches
    got = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin)
    torch.cuda.synchronize()
    assert lr.bwd_launches == before + 1
    assert lr.last_plan[1] == 8          # clusters of 8 blocks
    _assert_bwd_matches_plain(case, ys, cs, dys, fin, got, 2e-2)
    same = lr.lstm_recurrence_backward_reference(
        *[a.float() for a in (*case, ys, cs, dys)],
        *[None if f is None else f.float() for f in fin])[1]
    err = float((got[1].float() - same).abs().max())
    assert err <= 2 ** -8 * float(same.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("t, n, h", [(5, 20, 128), (3, 33, 64),
                                     (9, 240, 256), (4, 250, 128)])
def test_cuda_cluster_backward_other_widths(t, n, h):
    """H=64 and 128 (clusters of 2 and 4), and batches on either side of
    what the card holds as 16-row clusters at once."""
    _need_card()
    case, ys, cs, dys, fin = _bwd_case(t, n, h, seed=t * n)
    got = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin, route="cluster")
    torch.cuda.synchronize()
    assert lr.last_plan[1] == h // 32
    _assert_bwd_matches_plain(case, ys, cs, dys, fin, got, 2e-2)


@pytest.mark.cuda
def test_cuda_cluster_backward_is_bit_equal():
    _need_card()
    case, ys, cs, dys, fin = _bwd_case(200, 256, 256, seed=5)
    a = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin)
    b = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, h, want", [
    (torch.float32, 256, "grid"), (torch.bfloat16, 512, "wide"),
    (torch.bfloat16, 256, "cluster")])
def test_cuda_route_chosen(dtype, h, want):
    """f32 takes the first design, bf16 at H=512 the wide route, the
    training shape (bf16, H=256) the cluster route; each launches and
    matches the plain version."""
    _need_card()
    n = 256 if h == 256 else 5
    case, ys, cs, dys, fin = _bwd_case(3, n, h, seed=h, dtype=dtype)
    assert lr.bwd_route(case[0], case[1], case[2], ys) == want
    got = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin)
    torch.cuda.synchronize()
    assert (lr.last_plan[1] == 8) == (want == "cluster")
    _assert_bwd_matches_plain(case, ys, cs, dys, fin, got,
                              1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
def test_cuda_grid_route_still_right_at_the_training_shape():
    """The first design stays reachable by route and right."""
    _need_card()
    case, ys, cs, dys, fin = _bwd_case(200, 256, 256, seed=9)
    got = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin, route="grid")
    torch.cuda.synchronize()
    assert lr.last_plan[1] in (1, 2, 4)  # rows per thread of that design
    _assert_bwd_matches_plain(case, ys, cs, dys, fin, got, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("route, err", [("cluster", RuntimeError),
                                        ("warp", ValueError)])
def test_cuda_cluster_route_refuses_what_it_does_not_take(route, err):
    """f32 forced onto the cluster route is refused by the C entry (a
    RuntimeError naming the route), an unknown route by the wrapper;
    neither counts a launch."""
    _need_card()
    case, ys, cs, dys, fin = _bwd_case(3, 4, 256, seed=1,
                                       dtype=torch.float32)
    before = lr.bwd_launches
    with pytest.raises(err, match="route"):
        lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin, route=route)
    assert lr.bwd_launches == before


# -------------------------------------------- forward cluster route (card)
def _fwd_case(t, n, h, seed, dtype=torch.bfloat16):
    return [a.cuda().to(dtype) for a in _t(*_case(t, n, h, seed=seed))]


@pytest.mark.cuda
@pytest.mark.parametrize("h", [64, 128, 256])
@pytest.mark.parametrize("n", [1, 4, 16, 17, 240, 256])
@pytest.mark.parametrize("t", [1, 50, 200])
def test_cuda_cluster_forward_matches_plain(t, n, h):
    """The forward's cluster route (bf16) against the f32 plain version on
    the bf16-rounded inputs, within 2e-2, with and without the cell
    stream: the first step (T=1), ragged rows (N=1, 17), both row tiles
    (N=240: 16-row clusters; 256: 32-row) and every cluster width."""
    _need_card()
    case = _fwd_case(t, n, h, seed=t + n + h)
    assert lr.fwd_route(*case) == "cluster"
    want = lr.lstm_recurrence_reference(*[a.float() for a in case],
                                        collect_cell=True)
    for cells in (False, True):
        before = lr.fwd_launches
        got = lr.lstm_recurrence_fwd(*case, collect_cell=cells)
        torch.cuda.synchronize()
        assert lr.fwd_launches == before + 1
        assert lr.last_plan[1] == h // 32          # blocks per cluster
        assert len(got) == (4 if cells else 3)
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16 and a.shape == b.shape
            err = float((a.float() - b).abs().max())
            assert err <= 2e-2, f"{err:.3e} > 2e-2"


@pytest.mark.cuda
def test_cuda_cluster_forward_is_bit_equal_and_agrees_with_grid():
    """Two cluster-route calls at the training shape are bit-equal; the
    grid route (forced) on the same inputs stays within 2e-2 of both the
    plain version and the cluster route."""
    _need_card()
    case = _fwd_case(200, 256, 256, seed=3)
    a = lr.lstm_recurrence_fwd(*case, collect_cell=True)
    b = lr.lstm_recurrence_fwd(*case, collect_cell=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    grid = lr.lstm_recurrence_fwd(*case, collect_cell=True, route="grid")
    torch.cuda.synchronize()
    assert lr.last_plan[1] in (1, 2, 4)   # rows per thread of that design
    want = lr.lstm_recurrence_reference(*[x.float() for x in case],
                                        collect_cell=True)
    for x, y, w in zip(a, grid, want):
        assert float((y.float() - w).abs().max()) <= 2e-2
        assert float((x.float() - y.float()).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("route, err", [("cluster", RuntimeError),
                                        ("warp", ValueError)])
def test_cuda_cluster_forward_refuses_what_it_does_not_take(route, err):
    """f32 and mixed calls forced onto the cluster route are refused by
    the C entry (a RuntimeError naming the route), an unknown route by the
    wrapper; none counts a launch."""
    _need_card()
    f32 = _fwd_case(3, 4, 256, seed=1, dtype=torch.float32)
    mixed = [f32[0].to(torch.bfloat16)] + f32[1:]
    before = lr.fwd_launches
    for case in (f32, mixed):
        with pytest.raises(err, match="route"):
            lr.lstm_recurrence_fwd(*case, route=route)
    assert lr.fwd_launches == before


# -------------------------------------------------- mixed dtypes (C6, card)
@pytest.mark.cuda
@pytest.mark.parametrize("t, n, h", [(7, 5, 256), (50, 256, 256),
                                     (4, 3, 40)])
@pytest.mark.parametrize("mix", MIXES, ids=["-".join(m) for m in MIXES])
def test_cuda_mixed_dtypes_match_plain(mix, t, n, h):
    """x_proj, w_hh and the state in different dtypes on the card (the
    grid route at f32 over widened inputs): forward outputs, their dtypes
    and the backward's gradients against the plain versions on the same
    mixed inputs, within 1e-5 (values; 2e-3 for f32 values under a bf16
    w_hh, one bf16 step for bf16 values) and 1e-4 of max |grad| (one bf16
    step for bf16 gradients)."""
    _need_card()
    case = _mixed(_case(t, n, h, seed=t + n), mix, device="cuda")
    assert lr.fwd_route(*case) == "grid"
    want = lr.lstm_recurrence_reference(*case, collect_cell=True)
    got = lr.lstm_recurrence_fwd(*case, collect_cell=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == case[0].dtype and a.shape == b.shape
        err = float((a.float() - b.float()).abs().max())
        # at bf16 storage an output may sit one bf16 step off; under a
        # bf16 w_hh the recurrence rounds h to bf16 before each product, so
        # a 1-ulp f32 difference can flip a rounding (up to 6.6e-4 at
        # T=200 in the plain version itself)
        if a.dtype == torch.bfloat16:
            tol = 2 ** -7 * max(1.0, float(b.float().abs().max()))
        else:
            tol = 2e-3 if case[1].dtype == torch.bfloat16 else 1e-5
        assert err <= tol, f"{err:.3e} > {tol:.3e}"
    ys, _, _, cs = want
    g = torch.Generator(device="cuda").manual_seed(t)
    dys, dhT, dcT = (torch.randn(s, generator=g, device="cuda").to(ys.dtype)
                     for s in ((t, n, h), (n, h), (n, h)))
    ref = lr.lstm_recurrence_backward_reference(*case, ys, cs, dys, dhT, dcT)
    before = lr.bwd_launches
    grads = lr.lstm_recurrence_bwd(*case, ys, cs, dys, dhT, dcT)
    torch.cuda.synchronize()
    assert lr.bwd_launches == before + 1
    for name, a, b, p in zip(("dx_proj", "dw_hh", "dh0", "dc0"), grads, ref,
                             case):
        assert a.dtype == b.dtype == p.dtype, name
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        tol = 1e-4 if a.dtype == torch.float32 else 2 ** -7
        assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} x {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("mix", MIXES, ids=["-".join(m) for m in MIXES])
def test_cuda_mixed_dtypes_through_autograd(mix):
    """``lstm_layer``'s dispatcher on the card with mixed inputs: the
    kernels launch once each way and the gradients reach every input in
    its own dtype."""
    _need_card()
    leaves = [a.requires_grad_(True) for a in
              _mixed(_case(9, 6, 64, seed=4), mix, device="cuda")]
    before = (lr.fwd_launches, lr.bwd_launches)
    ys, hT, cT = lr.lstm_recurrence(*leaves)
    (ys.float().square().sum() + hT.float().sum() + cT.float().sum()) \
        .backward()
    torch.cuda.synchronize()
    assert (lr.fwd_launches, lr.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    for leaf in leaves:
        assert leaf.grad.dtype == leaf.dtype
        assert bool(torch.isfinite(leaf.grad.float()).all())


# ------------------------------------------------------ wide route (card)
WIDE_CARD_SHAPES = [(1, 1, 512), (3, 5, 512), (7, 37, 1024),
                    (50, 256, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("t, n, h", WIDE_CARD_SHAPES)
def test_cuda_wide_route_matches_plain(t, n, h):
    """The wide route (bf16, H past 256) against the f32 plain versions on
    the bf16-rounded inputs, at the cluster route's bf16 tolerances: the
    forward (with and without the cell stream) within 2e-2, the backward
    within 2e-2 of max |grad|; one block per 8 units, and each call moves
    the wide counters by one."""
    _need_card()
    case = _fwd_case(t, n, h, seed=t + n + h)
    assert lr.fwd_route(*case) == "wide"
    want = lr.lstm_recurrence_reference(*[a.float() for a in case],
                                        collect_cell=True)
    for cells in (False, True):
        before = (lr.fwd_launches, lr.fwd_wide_launches)
        got = lr.lstm_recurrence_fwd(*case, collect_cell=cells)
        torch.cuda.synchronize()
        assert (lr.fwd_launches, lr.fwd_wide_launches) == (before[0] + 1,
                                                           before[1] + 1)
        assert lr.last_plan[0] == h // 8 and lr.last_plan[2] == 8
        assert len(got) == (4 if cells else 3)
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16 and a.shape == b.shape
            err = float((a.float() - b).abs().max())
            assert err <= 2e-2, f"{err:.3e} > 2e-2"
    ys, cs = got[0], got[3]
    g = torch.Generator(device="cuda").manual_seed(t + h)
    dys = torch.randn(t, n, h, generator=g, device="cuda").to(torch.bfloat16)
    fin = [torch.randn(n, h, generator=g, device="cuda").to(torch.bfloat16)
           for _ in range(2)]
    assert lr.bwd_route(case[0], case[1], case[2], ys) == "wide"
    before = (lr.bwd_launches, lr.bwd_wide_launches)
    grads = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin)
    torch.cuda.synchronize()
    assert (lr.bwd_launches, lr.bwd_wide_launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert lr.last_plan[6] == -(-h // 128) * (h // 64)   # dh blocks
    _assert_bwd_matches_plain(case, ys, cs, dys, fin, grads, 2e-2)


@pytest.mark.cuda
def test_cuda_wide_route_is_bit_equal():
    """Two wide-route calls at the JAX bench's width (T=50, N=256,
    H=1024) are bit-equal, forward and backward: every sum runs in a fixed
    order."""
    _need_card()
    case, ys, cs, dys, fin = _bwd_case(50, 256, 1024, seed=7)
    a = lr.lstm_recurrence_fwd(*case, collect_cell=True)
    b = lr.lstm_recurrence_fwd(*case, collect_cell=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin)
    b = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("t, n, h", [(4, 20, 256), (5, 3, 64), (2, 300, 320)])
def test_cuda_wide_route_forced_and_without_final_grads(t, n, h):
    """The wide route forced at widths it takes below its envelope (H=64
    and 256: one dh block), and N past 256 at H=320 (a ragged da slice),
    dhT and dcT None: both directions within 2e-2 of the plain versions."""
    _need_card()
    case, _, _, dys, fin = _bwd_case(t, n, h, seed=t * n + h, finals=False)
    got = lr.lstm_recurrence_fwd(*case, collect_cell=True, route="wide")
    torch.cuda.synchronize()
    want = lr.lstm_recurrence_reference(*[a.float() for a in case],
                                        collect_cell=True)
    for a, b in zip(got, want):
        assert float((a.float() - b).abs().max()) <= 2e-2
    grads = lr.lstm_recurrence_bwd(*case, got[0], got[3], dys, *fin,
                                   route="wide")
    torch.cuda.synchronize()
    _assert_bwd_matches_plain(case, got[0], got[3], dys, fin, grads, 2e-2)


@pytest.mark.cuda
def test_cuda_wide_route_widths_in_any_order():
    """Calls at H=1024, 512, 1024, 512 in one process, both directions,
    each within 2e-2 of the plain versions: a narrower width's launch
    must leave a wider one launchable (each kernel's shared-memory opt-in
    is the card's whole, set once)."""
    _need_card()
    for h in (1024, 512, 1024, 512):
        case, ys, cs, dys, fin = _bwd_case(2, 9, h, seed=h)
        assert lr.fwd_route(*case) == "wide"
        want = lr.lstm_recurrence_reference(*[a.float() for a in case],
                                            collect_cell=True)
        for a, b in zip((ys, cs), (want[0], want[3])):
            assert float((a.float() - b).abs().max()) <= 2e-2
        grads = lr.lstm_recurrence_bwd(*case, ys, cs, dys, *fin)
        torch.cuda.synchronize()
        _assert_bwd_matches_plain(case, ys, cs, dys, fin, grads, 2e-2)


@pytest.mark.cuda
def test_cuda_wide_route_refuses_what_it_does_not_take():
    """f32, and bf16 at a width that is not a multiple of 64, forced onto
    the wide route are refused by the C entry (a RuntimeError naming the
    route); neither counts a launch."""
    _need_card()
    f32 = _fwd_case(3, 4, 512, seed=1, dtype=torch.float32)
    odd = _fwd_case(3, 4, 200, seed=1)
    before = (lr.fwd_launches, lr.fwd_wide_launches)
    for case in (f32, odd):
        with pytest.raises(RuntimeError, match="wide route"):
            lr.lstm_recurrence_fwd(*case, route="wide")
    assert (lr.fwd_launches, lr.fwd_wide_launches) == before
