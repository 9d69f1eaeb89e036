"""PyTorch port, training-mode batch norm: ``deeplearning4j_tpu_torch/ops/
batch_norm.py`` and the registered ``batch_norm_train`` and
``batch_norm_relu_train`` of ``ops/nn.py`` against
``deeplearning4j_tpu/ops/nn.py`` on the same numpy inputs.

The JAX side runs its ops as they are: ``batch_norm_train`` (XLA's
autodiff of the shifted one-pass formula) and ``batch_norm_relu_train``
(its ``custom_vjp`` with the two-pass backward). The port's side runs its
plain versions (the CPU path). Tolerances, each beside its assert:

- f32: y within 8 f32 ulps of max |x * scale| (y is the difference of two
  terms that large, each from statistics a few ulps apart); the statistics within 1e-6 of max(1, max |stat|);
  gradients within 2e-6 x (1 + |mean| / spread) of max |grad| (a rounding
  of a term as large as the mean is amplified by mean / spread);
- bf16 (mean 0): y and the statistics within one bf16 rounding (2^-8
  relative); gradients within 4 bf16 units (2^-8) of the sums they come
  from (max |dx| at f32 for x, sum |g * xhat| for gamma, sum |g| for
  beta): each framework rounds at other points.

The CUDA kernels (``csrc/batch_norm.cu``) run only on the card: their
tests carry the ``cuda`` marker, skip without one and import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_batch_norm.py``.
There each kernel is held against its plain version on the same inputs:
(a) the statistics within 1e-5 of max(1, |mean|) and of max(1, var)
(f32 sums of a few thousand terms in another order: some 10^2 ulps at
worst); (b) the apply bit for bit, given the same
statistics; (c) the backward within 1e-5 of max |dx| (dx) and of the
largest partial sum (dgamma, dbeta) at f32, one rounding of x's dtype
(2^-8 bf16, 2^-10 f16) of max |dx| otherwise; two calls bit-equal; one
launch of each wrapper per call.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ndarray import Nd4j
from deeplearning4j_tpu_torch.ops import batch_norm as bn
from deeplearning4j_tpu_torch.ops import nn as tnn
from deeplearning4j_tpu_torch.ops.registry import get_op

OPS = ["batch_norm_train", "batch_norm_relu_train"]

#: (shape, mean, spread, dtype, axes)
CASES = {
    "nhwc": ((4, 5, 5, 6), 0.0, 1.0, "float32", None),
    "dense": ((16, 7), 3.0, 2.0, "float32", None),
    "large_mean": ((4, 5, 5, 6), 1000.0, 1.0, "float32", None),
    # two kept axes, gamma and beta of their shape (the JAX fused op's
    # backward gives dgamma that shape); of one size, since the JAX fused
    # op broadcasts its per-channel vectors by the first kept size
    "axes": ((4, 3, 5, 5), 0.5, 1.0, "float32", (0, 1)),
    "bf16": ((4, 5, 5, 6), 0.0, 1.0, "bfloat16", None),
}


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def _case(case, seed=7):
    shape, mean, spread, dtype, axes = CASES[case]
    rs = np.random.RandomState(seed)
    kept = [shape[a] for a in range(len(shape))
            if a not in (axes or range(len(shape) - 1))]
    x = (rs.randn(*shape) * spread + mean).astype(np.float32)
    g = (rs.rand(*kept) + 0.5).astype(np.float32)
    b = rs.randn(*kept).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32)
    wm = rs.randn(*kept).astype(np.float32)
    wv = rs.randn(*kept).astype(np.float32)
    return x, g, b, r, wm, wv


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("op", OPS)
def test_ops_match_jax(op, case):
    """Outputs and ``jax.grad`` of ``sum(y * r)``, plus, for
    ``batch_norm_train``, of ``sum(m * wm) + sum(v * wv)``: the returned
    statistics carry their gradients there (``batch_norm_relu_train``'s
    are ``stop_gradient``)."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops import nn as jn

    shape, mean, spread, dtype, axes = CASES[case]
    x, g, b, r, wm, wv = _case(case)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jd) for a in (x, g, b)]
    targs = [torch.from_numpy(_f32(a)).to(td).requires_grad_(True)
             for a in jargs]
    stats_grad = op == "batch_norm_train"

    def loss(*a):
        y, m, v = getattr(jn, op)(*a, axes=axes)
        out = jnp.sum(y.astype(jnp.float32) * r)
        if stats_grad:
            out = out + jnp.sum(m.astype(jnp.float32) * wm) \
                + jnp.sum(v.astype(jnp.float32) * wv)
        return out

    want = getattr(jn, op)(*jargs, axes=axes)
    got = get_op(op)(*targs, axes=axes)
    assert [t.dtype for t in got] == [td] * 3
    assert [tuple(t.shape) for t in got] == [tuple(w.shape) for w in want]
    assert got[1].requires_grad == got[2].requires_grad == stats_grad
    xs = _f32(jargs[0])
    red = tuple(axes or range(len(shape) - 1))
    if dtype == "float32":
        scale = np.abs(g) / np.sqrt(xs.var(red) + 1e-5)
        y_tol = 8 * 2.0 ** -23 * float(np.abs(xs * scale).max())
        assert float(np.abs(_f32(got[0]) - _f32(want[0])).max()) <= y_tol
        for t, w in zip(got[1:], want[1:]):
            w = _f32(w)
            assert float(np.abs(_f32(t) - w).max()) \
                <= 1e-6 * max(1.0, float(np.abs(w).max()))
    else:
        for t, w, what in zip(got, want, ("y", "mean", "var")):
            err = np.abs(_f32(t) - _f32(w))
            assert np.all(err <= 2.0 ** -8 * np.abs(_f32(w)) + 1e-30), what

    jg = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    tl = (got[0].float() * torch.from_numpy(r)).sum()
    if stats_grad:
        tl = tl + (got[1].float() * torch.from_numpy(wm)).sum() \
            + (got[2].float() * torch.from_numpy(wv)).sum()
    tl.backward()
    tg = [t.grad for t in targs]
    if dtype == "float32":
        tol = 2e-6 * (1 + abs(mean) / spread)
        for t, w, what in zip(tg, jg, ("dx", "dgamma", "dbeta")):
            err = float(np.abs(_f32(t) - _f32(w)).max())
            assert err <= tol * float(np.abs(_f32(w)).max()), (what, err)
    else:
        f32 = jax.grad(loss, argnums=(0, 1, 2))(
            *[a.astype(jnp.float32) for a in jargs])
        xhat = (xs - xs.mean(red)) / xs.std(red)
        sums = (float(np.abs(_f32(f32[0])).max()),
                float(np.abs(r * xhat).sum(red).max()),
                float(np.abs(r).sum(red).max()))
        for t, w, s, what in zip(tg, jg, sums, ("dx", "dgamma", "dbeta")):
            assert t.dtype == td
            err = float(np.abs(_f32(t) - _f32(w)).max())
            assert err <= 4 * 2.0 ** -8 * s, (what, err, s)


def test_relu_op_is_the_relu_of_the_train_op():
    x, g, b, *_ = _case("nhwc")
    args = [torch.from_numpy(a) for a in (x, g, b)]
    y, m, v = tnn.batch_norm_relu_train(*args)
    y2, m2, v2 = tnn.batch_norm_train(*args)
    assert torch.equal(y, torch.clamp(y2, min=0))
    assert torch.equal(m, m2) and torch.equal(v, v2)


def test_relu_op_backward_is_the_two_pass_formula():
    """On the CPU the fused op's gradient is ``bn_backward_reference``
    (the plain ``_bn_relu_bwd``) exactly, not autograd's."""
    x, g, b, r, *_ = _case("large_mean")
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    y, _, _ = tnn.batch_norm_relu_train(*leaves)
    y.backward(torch.from_numpy(r))
    xs = torch.from_numpy(x)
    m, v = bn.bn_stats_reference(xs, (0, 1, 2))
    want = bn.bn_backward_reference(xs, torch.from_numpy(r),
                                    torch.from_numpy(g), torch.from_numpy(b),
                                    m, v, 1e-5, True)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("case", ["nhwc", "large_mean", "axes"])
def test_plain_backward_with_stat_grads_is_autograd_of_the_formula(case):
    """``bn_backward_reference`` without the ReLU and with the gradients
    of the returned mean and variance (kernel (c)'s plain version for
    ``batch_norm_train``) against autograd through the plain formula:
    within 2e-6 x (1 + |mean| / spread) of max |grad|."""
    shape, mean, spread, _, axes = CASES[case]
    x, g, b, r, wm, wv = (torch.from_numpy(a) for a in _case(case, seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    y, m, v = tnn.batch_norm_train(*leaves, axes=axes)
    torch.autograd.backward((y, m, v), (r, wm, wv))
    red = tuple(axes or range(len(shape) - 1))
    ms, vs = bn.bn_stats_reference(x, red)
    got = bn.bn_backward_reference(x, r, g, b, ms, vs, 1e-5, False, red,
                                   wm, wv)
    tol = 2e-6 * (1 + abs(mean) / spread)
    for a, leaf in zip(got, leaves):
        w = leaf.grad
        assert float((a - w).abs().max()) <= tol * float(w.abs().max())


def _plain_kernels(monkeypatch):
    """Kernels (a)-(c) replaced by their plain versions (on any device),
    so the CUDA path's plumbing runs on the CPU."""
    monkeypatch.setattr(bn, "bn_stats_kernel",
                        lambda x2: bn.bn_stats_reference(x2, (0,)))
    monkeypatch.setattr(
        bn, "bn_apply_kernel",
        lambda x2, m, v, g, b, eps=1e-5, relu=False: bn.bn_apply_reference(
            x2, m, v, g, b, eps, relu, (0,)))
    monkeypatch.setattr(
        bn, "bn_backward_kernel",
        lambda x2, g2, m, v, g, b, eps=1e-5, relu=False, gm=None, gv=None:
        bn.bn_backward_reference(x2, g2, g.float(), b.float(), m, v, eps,
                                 relu, (0,), gm, gv))


@pytest.mark.parametrize("case", ["nhwc", "dense", "large_mean", "axes"])
@pytest.mark.parametrize("op", OPS)
def test_kernel_path_follows_the_plain_path(monkeypatch, op, case):
    """The CUDA path's plumbing (x as [rows, C], the autograd Function,
    the gradients of the returned statistics, the ReLU's detached
    statistics, the results laid out as x) on the CPU with its kernels
    replaced by their plain versions: the CPU path's outputs and
    gradients within 2e-6 x (1 + |mean| / spread) of max(1, |value|)
    (the same formulas; the f32 backward in place of autograd's)."""
    _plain_kernels(monkeypatch)
    shape, mean, spread, _, axes = CASES[case]
    arrays = [torch.from_numpy(a) for a in _case(case, seed=9)]
    relu = op == "batch_norm_relu_train"
    red = tuple(axes or range(len(shape) - 1))
    res = []
    for kernels in (True, False):
        x, g, b, r, wm, wv = (a.clone() for a in arrays)
        leaves = [t.requires_grad_(True) for t in (x, g, b)]
        if kernels:
            y, m, v = bn.kernel_path(*leaves, 1e-5, red, relu)
        else:
            y, m, v = get_op(op)(*leaves, axes=axes)
        assert m.requires_grad == v.requires_grad == (not relu)
        outs, cots = ([y], [r]) if relu else ([y, m, v], [r, wm, wv])
        torch.autograd.backward(outs, cots)
        res.append([y, m, v] + [t.grad for t in leaves])
    tol = 2e-6 * (1 + abs(mean) / spread)
    for a, w in zip(*res):
        assert a.shape == w.shape
        w = w.detach()
        assert float((a.detach() - w).abs().max()) \
            <= tol * max(1.0, float(w.abs().max()))


def test_registered_by_name():
    x, g, b, *_ = _case("dense")
    args = [torch.from_numpy(a) for a in (x, g, b)]
    assert get_op("batch_norm_relu_train") is tnn.batch_norm_relu_train
    via = Nd4j.exec("batch_norm_relu_train", *args)
    for a, w in zip(via, tnn.batch_norm_relu_train(*args)):
        assert torch.equal(a, w)


def test_fused_toggle_is_off_by_default_as_in_the_reference():
    from deeplearning4j_tpu.ops import nn as jn

    assert tnn.FUSED_BN_RELU_BWD is False
    assert jn.FUSED_BN_RELU_BWD is False


#: the distinct batch-norm shapes of ResNet-50 at batch 256 ([rows, C])
RESNET_ROWS = [(256 * 112 * 112, 64), (256 * 56 * 56, 64),
               (256 * 56 * 56, 256), (256 * 28 * 28, 128),
               (256 * 28 * 28, 512), (256 * 14 * 14, 256),
               (256 * 14 * 14, 1024), (256 * 7 * 7, 512),
               (256 * 7 * 7, 2048)]


def _pieces(kind, rows, c, itemsize):
    """The (row range, channel range) pieces a plan cuts ``[rows, c]``
    into, and the plan: (b)'s blocks (channel tile, row chunk), or (a)
    and (c)'s tiles of every item."""
    if kind == "apply":
        vec, tg, chunks, rpc = bn.launch_plan(rows, c, itemsize, True)
        per = 16 // itemsize if vec else 1
        width = tg * per
        return [((y * rpc, min(rows, (y + 1) * rpc)),
                 (x * width, min(c, (x + 1) * width)))
                for x in range(-(-c // width)) for y in range(chunks)], tg
    p = bn.reduce_plan(rows, c, itemsize, True)
    per = 16 // itemsize if p.vec else 1
    width = p.tg * per
    out = []
    for q in range(p.items):
        ct, rq = divmod(q, p.chunks)
        for r0 in range(rq * p.rpc, min(rows, (rq + 1) * p.rpc), p.rows):
            out.append(((r0, min(rows, r0 + p.rows)),
                        (ct * width, min(c, (ct + 1) * width))))
    return out, p.tg


@pytest.mark.parametrize("kind", ["apply", "reduce"])
@pytest.mark.parametrize("rows, c", RESNET_ROWS + [(7, 3), (5, 33), (1, 1)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_launch_plan_covers_every_row_and_channel(rows, c, itemsize, kind):
    """The grid holds every row and channel exactly once, in pieces none
    of them empty, every channel in 16-byte groups where C allows (one
    channel per thread otherwise). (b): a warp or less of groups per
    block row and at most about 512 blocks (a chunk per row lane at
    least). (a), (c): tiles of 4 rows per row lane, at most a block (256
    threads) of groups, whole tiles per chunk, about 132 items, a plan
    the C entries take."""
    per = 16 // itemsize
    pieces, _ = _pieces(kind, rows, c, itemsize)
    by_cols: dict = {}
    for r, cols in pieces:
        by_cols.setdefault(cols, []).append(r)
    for bounds in (sorted(by_cols), *(sorted(v) for v in by_cols.values())):
        # ranges that follow each other from 0 to the end, none empty
        assert bounds[0][0] == 0 and all(a < b for a, b in bounds)
        assert all(p[1] == n[0] for p, n in zip(bounds, bounds[1:]))
    assert sorted(by_cols)[-1][1] == c
    assert all(sorted(v)[-1][1] == rows for v in by_cols.values())
    if kind == "apply":
        vec, tg, chunks, rpc = bn.launch_plan(rows, c, itemsize, True)
        assert vec == int(c % per == 0)
        groups = c // per if vec else c
        assert 1 <= tg <= min(groups, bn.MAX_GROUPS)
        assert chunks * rpc >= rows > (chunks - 1) * rpc
        tiles = -(-groups // tg)
        assert tiles * chunks <= max(bn.TARGET_BLOCKS, tiles)
        assert bn.launch_plan(rows, c, itemsize, False)[0] == 0
        return
    p = bn.reduce_plan(rows, c, itemsize, True)
    assert p.vec == int(c % per == 0)
    groups = c // per if p.vec else c
    assert 1 <= p.tg <= min(groups, bn.THREADS)
    assert p.lanes == bn.THREADS // p.tg
    assert p.rows == bn.ROWS_PER_LANE * p.lanes
    assert p.ctiles * p.tg >= groups > (p.ctiles - 1) * p.tg
    assert p.chunks * p.rpc >= rows > (p.chunks - 1) * p.rpc
    assert p.items <= max(bn.TARGET_ITEMS, p.ctiles)
    assert len(pieces) == p.ctiles * -(-rows // p.rows)
    assert bn.reduce_plan(rows, c, itemsize, False).vec == 0


@pytest.mark.parametrize("rows, c", RESNET_ROWS + [(7, 3), (50, 2048)])
def test_reduce_plan_reads_no_card(monkeypatch, rows, c):
    """The sums' grouping comes from the shape alone: the same plan under
    any SM count the card reports (mocked), and the persistent grid's
    walk (block b takes items b, b + grid, ...) hands every item to one
    block for every grid size, so only the balance depends on the card."""
    want = bn.reduce_plan(rows, c, 2, True)

    class Props:
        def __init__(self, sms):
            self.multi_processor_count = sms
            self.name = "mocked"

    for sms in (1, 16, 114, 132, 264):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda *a, sms=sms: Props(sms))
        assert bn.reduce_plan(rows, c, 2, True) == want
        walk = sorted(q for b in range(min(sms, want.items))
                      for q in range(b, want.items, min(sms, want.items)))
        assert walk == list(range(want.items))


def test_bn_probe_split_edits_find_their_anchors():
    """``tools/bn_probe.py split`` edits a copy of ``csrc/batch_norm.cu``
    by text anchors, each of which must occur once."""
    from deeplearning4j_tpu_torch.tools import bn_probe

    text = bn_probe.edited(bn_probe.SPLIT)
    assert text.count("prof[") >= 10 and "dl4j_probe_read" in text
    assert "bn_reduce_kernel" not in bn_probe.read(bn_probe.TWO_LAUNCH)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """CPU tensors, f64 and non-[rows, C] tensors raise before a launch;
    the counters do not move."""
    x = torch.randn(8, 4)
    c = torch.ones(4)
    before = (bn.stats_launches, bn.apply_launches, bn.bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bn.bn_stats_kernel(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bn.bn_apply_kernel(x, c, c, c, c)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bn.bn_backward_kernel(x, x, c, c, c, c)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        bn.bn_stats_kernel(x.double())
    with pytest.raises(ValueError, match=r"\[rows, C\]"):
        bn.bn_stats_kernel(x.reshape(2, 4, 4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tnn.batch_norm_train(x.to("meta"), c.to("meta"), c.to("meta"))
    assert (bn.stats_launches, bn.apply_launches, bn.bwd_launches) == before


def test_cpu_path_launches_nothing():
    x, g, b, r, *_ = _case("nhwc")
    before = (bn.stats_launches, bn.apply_launches, bn.bwd_launches)
    for op in OPS:
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
        get_op(op)(*leaves)[0].backward(torch.from_numpy(r))
    assert (bn.stats_launches, bn.apply_launches, bn.bwd_launches) == before


# ---------------------------------------------------------------- on the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


#: [rows, C] shapes on the card: the 16-byte route (C a multiple of 8), one
#: channel per thread (C = 3, 33), a narrow C walking many rows, a wide C
CARD_ROWS = [(4096, 64), (3000, 256), (50, 2048), (7, 3), (1000, 33),
             (1, 8)]
TOLS = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8,
        torch.float16: 2.0 ** -10}


def _card_case(rows, c, dtype, mean=0.5, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed + rows + c)
    x = (torch.randn(rows, c, generator=g, device="cuda") * 2 + mean) \
        .to(dtype)
    dy = torch.randn(rows, c, generator=g, device="cuda").to(dtype)
    gamma = torch.rand(c, generator=g, device="cuda") + 0.5
    beta = torch.randn(c, generator=g, device="cuda")
    return x, dy, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", list(TOLS), ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("rows, c", CARD_ROWS)
def test_cuda_kernels_match_plain(rows, c, dtype, relu):
    _need_card()
    x, dy, gamma, beta = _card_case(rows, c, dtype)
    before = (bn.stats_launches, bn.apply_launches, bn.bwd_launches)
    m, v = bn.bn_stats_kernel(x)
    rm, rv = bn.bn_stats_reference(x, (0,))
    for a, w in ((m, rm), (v, rv)):
        assert a.dtype == torch.float32 and a.shape == (c,)
        assert float((a - w).abs().max()) \
            <= 1e-5 * max(1.0, float(w.abs().max()))
    # (b) bit for bit, on the same statistics
    y = bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, relu)
    assert torch.equal(y, bn.bn_apply_reference(x, m, v, gamma, beta, 1e-5,
                                                relu))
    dx, dg, db = bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, relu)
    torch.cuda.synchronize()
    assert (bn.stats_launches, bn.apply_launches, bn.bwd_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    wx, wg, wb = bn.bn_backward_reference(x, dy, gamma, beta, m, v, 1e-5,
                                          relu, (0,))
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    assert float((dx.float() - wx.float()).abs().max()) \
        <= TOLS[dtype] * float(wx.float().abs().max()) + 1e-30
    gsum = float(dy.float().abs().sum(0).max())
    xhat_sum = float((dy.float() * (x.float() - m) * torch.rsqrt(v + 1e-5))
                     .abs().sum(0).max())
    assert float((db - wb).abs().max()) <= 1e-5 * gsum
    assert float((dg - wg).abs().max()) <= 1e-5 * xhat_sum


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOLS), ids=["f32", "bf16", "f16"])
def test_cuda_stat_grads_match_plain(dtype):
    """Kernel (c) with the gradients of the returned mean and variance
    (``batch_norm_train``): the extra terms against the plain version."""
    _need_card()
    x, dy, gamma, beta = _card_case(2048, 64, dtype, mean=3.0)
    gm = torch.randn(64, device="cuda")
    gv = torch.randn(64, device="cuda")
    m, v = bn.bn_stats_kernel(x)
    dx = bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, False, gm,
                               gv)[0]
    want = bn.bn_backward_reference(x, dy, gamma, beta, m, v, 1e-5, False,
                                    (0,), gm, gv)[0]
    assert float((dx.float() - want.float()).abs().max()) \
        <= TOLS[dtype] * float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_two_calls_are_bit_equal(dtype):
    _need_card()
    x, dy, gamma, beta = _card_case(256 * 56 * 56 // 16, 256, dtype)
    first = [*bn.bn_stats_kernel(x)]
    first.append(bn.bn_apply_kernel(x, *first, gamma, beta, 1e-5, True))
    first += bn.bn_backward_kernel(x, dy, *first[:2], gamma, beta, 1e-5,
                                   True)
    again = [*bn.bn_stats_kernel(x)]
    again.append(bn.bn_apply_kernel(x, *again, gamma, beta, 1e-5, True))
    again += bn.bn_backward_kernel(x, dy, *again[:2], gamma, beta, 1e-5,
                                   True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


#: [rows, C] cases that reach every route of the statistics and the
#: backward (one launch each) on the card: rows, C, and an offset in
#: elements that moves every pointer off 16 bytes
ROUTE_CASES = {
    "resident": (4096, 64, 0),      # a block's tiles all stay in its ring
    "streamed": (65536, 256, 0),    # more tiles a block than ring stages
    "unaligned": (3000, 64, 1),     # one element a thread, no ring
    "odd_c": (1000, 33, 0),         # C not a multiple of the group
    "few_rows": (3, 16, 0),         # fewer rows than a tile's row lanes
}


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [False, True], ids=["", "stat_grads"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", list(TOLS), ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("route", list(ROUTE_CASES))
def test_cuda_reduce_routes_match_plain(route, dtype, relu, extra):
    """Kernels (a) and (c) on each route against their plain versions at
    the tolerances above (the statistics' gradients ``gm``, ``gv`` on and
    off), one launch of each wrapper per call, two calls bit-equal; the
    ring holds all of a block's tiles ("resident"), fewer ("streamed"),
    or is not used (one element a thread)."""
    _need_card()
    rows, c, off = ROUTE_CASES[route]
    x, dy, gamma, beta = _card_case(rows, c, dtype)
    if off:
        x, dy = (torch.cat([t.new_zeros(off), t.reshape(-1)])[off:]
                 .view(rows, c) for t in (x, dy))
    gm = torch.randn(c, device="cuda") if extra else None
    gv = torch.randn(c, device="cuda") if extra else None
    plan = bn.reduce_plan(rows, c, x.element_size(), off == 0)
    before = (bn.stats_launches, bn.bwd_launches)
    m, v = bn.bn_stats_kernel(x)
    dx, dg, db = bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, relu,
                                       gm, gv)
    torch.cuda.synchronize()
    assert (bn.stats_launches, bn.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    grid, stages, _, _ = bn.last_launch()
    per_block = -(-plan.items // grid) * plan.tpc
    if route == "resident":
        assert plan.vec and per_block <= stages
    elif route == "streamed":
        assert plan.vec and per_block > stages
    else:
        assert (plan.vec, stages) == (0, 0) or route == "few_rows"
    rm, rv = bn.bn_stats_reference(x, (0,))
    for a, w in ((m, rm), (v, rv)):
        assert float((a - w).abs().max()) \
            <= 1e-5 * max(1.0, float(w.abs().max()))
    wx, wg, wb = bn.bn_backward_reference(x, dy, gamma, beta, m, v, 1e-5,
                                          relu, (0,), gm, gv)
    assert dx.dtype == dtype
    assert float((dx.float() - wx.float()).abs().max()) \
        <= TOLS[dtype] * float(wx.float().abs().max()) + 1e-30
    gsum = float(dy.float().abs().sum(0).max())
    xhat_sum = float((dy.float() * (x.float() - m) * torch.rsqrt(v + 1e-5))
                     .abs().sum(0).max())
    assert float((db - wb).abs().max()) <= 1e-5 * gsum
    assert float((dg - wg).abs().max()) <= 1e-5 * xhat_sum
    again = (*bn.bn_stats_kernel(x),
             *bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, relu, gm,
                                    gv))
    assert all(torch.equal(a, b) for a, b in zip((m, v, dx, dg, db), again))


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", ["nhwc", "dense", "large_mean", "axes"])
def test_cuda_ops_match_cpu(op, case):
    """The registered ops on the card (the kernels, one launch of each per
    call and backward) against the CPU (the plain versions) from the same
    arrays at f32, gradients of the returned statistics included: values
    within 1e-5 x (1 + |mean|) of max(1, |value|)."""
    _need_card()
    shape, mean, spread, _, axes = CASES[case]
    arrays = _case(case, seed=5)
    res = []
    for dev in ("cuda", "cpu"):
        x, g, b, r, wm, wv = (torch.from_numpy(a).to(dev) for a in arrays)
        leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
        before = (bn.stats_launches, bn.apply_launches, bn.bwd_launches)
        y, m, v = get_op(op)(*leaves, axes=axes)
        outs, cots = [y], [r]
        if op == "batch_norm_train":
            outs, cots = [y, m, v], [r, wm, wv]
        torch.autograd.backward(outs, cots)
        launched = tuple(a - b for a, b in zip(
            (bn.stats_launches, bn.apply_launches, bn.bwd_launches), before))
        assert launched == ((1, 1, 1) if dev == "cuda" else (0, 0, 0))
        res.append([y, m, v] + [t.grad for t in leaves])
    tol = 1e-5 * (1 + abs(mean) / spread)
    for a, w in zip(*res):
        w = w.detach()
        assert float((a.detach().cpu() - w).abs().max()) \
            <= tol * max(1.0, float(w.abs().max()))
