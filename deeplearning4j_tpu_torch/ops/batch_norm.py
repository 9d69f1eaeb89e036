"""Training-mode batch norm: the reference's formulas and their Hopper
kernels (``csrc/batch_norm.cu``).

The JAX package leaves the batch norm to XLA; no Pallas kernel stands
behind it. These port its formulas (``deeplearning4j_tpu/ops/nn.py``):

- :func:`bn_stats_reference`: ``_bn_stats`` (``:390-409``), the one-pass
  f32 statistics over ``axes`` with the first sample as a detached
  per-channel shift;
- :func:`bn_apply_reference`: the scale-shift of ``batch_norm_train``
  (``:422-427``) and of ``_bn_relu_fwd`` (``:449-457``),
  ``x * scale.to(x.dtype) + shift.to(x.dtype)``, then ``max(y, 0)`` where
  ``relu``;
- :func:`bn_backward_reference`: the two-pass ``_bn_relu_bwd``
  (``:460-499``) in f32, dx cast to x's dtype at the end; without
  ``relu`` the same passes with ``g`` unmasked, plus the terms of the
  gradients that reach ``batch_norm_train``'s returned mean and variance.

The kernels (:func:`bn_stats_kernel`, :func:`bn_apply_kernel`,
:func:`bn_backward_kernel`) work on ``x`` laid out ``[rows, C]``: the
reduced axes flattened into rows, the kept ones into channels.
:func:`batch_norm_train` is the dispatcher the registered ops call: on
CPU tensors ``batch_norm_train`` is the plain formula under autograd (as
``jax.grad`` differentiates the reference's) and ``batch_norm_relu_train``
the plain forward with the plain two-pass backward (the reference's
``custom_vjp``); on CUDA tensors both run the three kernels inside
:class:`BatchNormKernels`, which launch or raise. No mode switch, no
fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.ops import native

#: kernel launches since the last reset, one per wrapper call (the
#: statistics and the backward each run a second small launch that sums
#: their partials); incremented only where the CUDA kernels launch
stats_launches = 0
apply_launches = 0
bwd_launches = 0

#: the dtypes the kernels take, by the number the C entries take
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

THREADS = 256          # threads per block (kThreads)
MAX_GROUPS = 32        # channel groups per block row (kMaxTg)
TARGET_BLOCKS = 512    # blocks a launch aims at (about 4 per SM on the H100)


# ------------------------------------------------------------ plain versions
def _bcast(c: torch.Tensor, x: torch.Tensor, axes: Sequence[int]):
    """A per-channel tensor (the kept axes' shape) broadcast over ``x``."""
    return c.reshape([1 if a in axes else x.shape[a] for a in range(x.dim())])


def _count(x: torch.Tensor, axes: Sequence[int]) -> int:
    n = 1
    for a in axes:
        n *= x.shape[a]
    return n


def bn_stats_reference(x, axes: Sequence[int]):
    """``_bn_stats``: one-pass f32 batch statistics over ``axes``,
    ``(mean, var)``. The shift (the first sample, outside the gradient)
    keeps ``E[d^2] - E[d]^2`` free of cancellation where the mean is large
    against the spread."""
    axes = tuple(axes)
    xf = x.float()
    shift = xf[tuple(0 for _ in axes)].detach()
    d = xf - shift
    md = torch.mean(d, dim=axes)
    v = torch.mean(d * d, dim=axes) - md * md
    return shift + md, torch.maximum(v, v.new_zeros(()))


def bn_apply_reference(x, mean, var, gamma, beta, eps: float = 1e-5,
                       relu: bool = False, axes: Optional[Sequence[int]] = None):
    """``x * scale + shift`` with ``scale = rsqrt(var + eps) * gamma`` and
    ``shift = beta - mean * scale`` in f32, each cast to x's dtype before
    the multiply-add; then ``max(y, 0)`` where ``relu``."""
    if axes is None:
        axes = tuple(range(x.dim() - 1))
    scale = torch.rsqrt(var + eps) * gamma.float()
    shift = beta.float() - mean * scale
    y = (x * _bcast(scale, x, axes).to(x.dtype)
         + _bcast(shift, x, axes).to(x.dtype))
    return torch.clamp(y, min=0) if relu else y


def bn_backward_reference(x, g, gamma, beta, mean, var, eps: float = 1e-5,
                          relu: bool = False,
                          axes: Optional[Sequence[int]] = None,
                          gm=None, gv=None):
    """The two-pass backward ``_bn_relu_bwd`` in f32: ``(dx, dgamma,
    dbeta)`` in the dtypes of x, gamma and beta. ``g`` is masked by the
    ReLU recomputed from x where ``relu``; ``gm`` and ``gv`` (the
    gradients of the returned mean and variance, None for none) add
    ``gm / count + gv * 2 (x - mean) / count``."""
    if axes is None:
        axes = tuple(range(x.dim() - 1))
    axes = tuple(axes)
    count = _count(x, axes)
    inv = torch.rsqrt(var + eps)
    gamma_f = gamma.float()
    m_b = _bcast(mean, x, axes)
    inv_b = _bcast(inv, x, axes)
    sc_b = _bcast(gamma_f * inv, x, axes)
    sh_b = _bcast(beta.float() - mean * gamma_f * inv, x, axes)

    def masked_pieces():
        xf = x.float()
        xhat = (xf - m_b) * inv_b
        gp = g.float()
        if relu:
            gp = torch.where(xf * sc_b + sh_b > 0, gp, torch.zeros_like(gp))
        return xf, xhat, gp

    # pass A: per-channel reductions
    _, xhat, gp = masked_pieces()
    s1 = torch.sum(gp, dim=axes)
    s2 = torch.sum(gp * xhat, dim=axes)
    # pass B: dx, the masked gradient recomputed
    xf, xhat, gp = masked_pieces()
    dx = sc_b * (gp - (_bcast(s1, x, axes) + xhat * _bcast(s2, x, axes))
                 / count)
    if gm is not None:
        dx = dx + (_bcast(gm.float() / count, x, axes)
                   + _bcast(gv.float() * 2.0 / count, x, axes) * (xf - m_b))
    return dx.to(x.dtype), s2.to(gamma.dtype), s1.to(beta.dtype)


# ------------------------------------------------------------------ kernels
def launch_plan(rows: int, channels: int, itemsize: int,
                aligned: bool) -> Tuple[int, int, int, int]:
    """The kernels' grid for ``[rows, channels]``: ``(vec, tg, chunks,
    rpc)``. ``vec`` is 1 where channels split into 16-byte groups (and
    every pointer is 16-byte aligned), ``tg`` the groups per block row (a
    warp wide at most), ``chunks`` the row chunks of ``rpc`` rows each,
    about :data:`TARGET_BLOCKS` blocks in all. From the shape alone, so
    the sums' grouping (and their bits) is the same on every card."""
    per = 16 // itemsize
    vec = int(aligned and channels % per == 0)
    groups = channels // per if vec else channels
    tg = min(groups, MAX_GROUPS)
    lanes = THREADS // tg
    tiles = -(-groups // tg)
    chunks = max(1, min(-(-rows // lanes), TARGET_BLOCKS // tiles))
    rpc = -(-rows // chunks)
    return vec, tg, -(-rows // rpc), rpc


def _lib():
    lib = native.load("batch_norm")
    if lib.dl4j_bn_stats.argtypes is None:
        vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
        lib.dl4j_bn_stats.argtypes = [i, vp, ll, i, i, i, i, ll, vp, vp, vp,
                                      vp]
        lib.dl4j_bn_apply.argtypes = [i, vp, vp, vp, vp, vp, f, i, ll, i, i,
                                      i, i, ll, vp, vp]
        lib.dl4j_bn_backward.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, f,
                                         i, ll, i, i, i, i, ll, vp, vp, vp,
                                         vp, vp]
        for fn in (lib.dl4j_bn_stats, lib.dl4j_bn_apply,
                   lib.dl4j_bn_backward):
            fn.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(name: str, t: torch.Tensor, like: Optional[torch.Tensor]):
    if t.dtype not in DTYPES:
        raise TypeError(f"the batch-norm kernels take float32, bfloat16 or "
                        f"float16, got {name} {t.dtype}")
    if t.dim() != 2 or t.numel() == 0 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous non-empty [rows, C], "
                         f"got {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got "
                         f"{t.device}")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name} must match x ({like.dtype} "
                         f"{tuple(like.shape)} on {like.device})")


def _vectors(x2, **vecs):
    """The per-channel vectors as contiguous f32 ``[C]`` on x's device."""
    c = x2.shape[1]
    out = []
    for name, t in vecs.items():
        if t.numel() != c or t.device != x2.device:
            raise ValueError(f"{name} must hold C = {c} values on "
                             f"{x2.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        out.append(t.reshape(c).float().contiguous())
    return out


def _plan(*ts):
    x2 = ts[0]
    rows, c = x2.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in ts)
    return (rows, c) + launch_plan(rows, c, x2.element_size(), aligned)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.dl4j_cuda_error_string(err).decode()
        raise RuntimeError(f"batch-norm {what} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def bn_stats_kernel(x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel (a) on a CUDA ``[rows, C]``: f32 ``(mean, var)`` ``[C]``,
    the shift the first row. Raises on what the kernel does not take, on
    a failed build and on a refused launch."""
    global stats_launches
    _check_rows("x", x2, None)
    rows, c, vec, tg, chunks, rpc = _plan(x2)
    part = torch.empty(2 * chunks * c, dtype=torch.float32, device=x2.device)
    mean = torch.empty(c, dtype=torch.float32, device=x2.device)
    var = torch.empty_like(mean)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.dl4j_bn_stats(DTYPES[x2.dtype], x2.data_ptr(), rows, c, vec,
                                tg, chunks, rpc, part.data_ptr(),
                                mean.data_ptr(), var.data_ptr(), _stream(x2))
    _raise_on(lib, err, "statistics")
    stats_launches += 1
    return mean, var


def bn_apply_kernel(x2, mean, var, gamma, beta, eps: float = 1e-5,
                    relu: bool = False) -> torch.Tensor:
    """Kernel (b) on a CUDA ``[rows, C]``: ``x * scale + shift`` in x's
    dtype (then ``max(y, 0)`` where ``relu``) from f32 statistics and any
    float ``gamma``, ``beta``. Raises like :func:`bn_stats_kernel`."""
    global apply_launches
    _check_rows("x", x2, None)
    vecs = _vectors(x2, mean=mean, var=var, gamma=gamma, beta=beta)
    y = torch.empty_like(x2)
    rows, c, vec, tg, chunks, rpc = _plan(x2, y)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.dl4j_bn_apply(DTYPES[x2.dtype], x2.data_ptr(),
                                *(t.data_ptr() for t in vecs), float(eps),
                                int(relu), rows, c, vec, tg, chunks, rpc,
                                y.data_ptr(), _stream(x2))
    _raise_on(lib, err, "apply")
    apply_launches += 1
    return y


def bn_backward_kernel(x2, g2, mean, var, gamma, beta, eps: float = 1e-5,
                       relu: bool = False, gm=None, gv=None):
    """Kernel (c) on CUDA ``[rows, C]`` x and upstream g (one dtype):
    ``(dx, dgamma, dbeta)``, dx in x's dtype, the others f32 ``[C]``.
    ``gm`` / ``gv`` (None for none) are the gradients of the returned
    mean and variance. Raises like :func:`bn_stats_kernel`."""
    global bwd_launches
    _check_rows("x", x2, None)
    _check_rows("g", g2, x2)
    vecs = _vectors(x2, mean=mean, var=var, gamma=gamma, beta=beta)
    extra = [None, None]
    if gm is not None or gv is not None:
        extra = _vectors(x2, gm=torch.zeros_like(mean) if gm is None else gm,
                         gv=torch.zeros_like(var) if gv is None else gv)
    dx = torch.empty_like(x2)
    rows, c, vec, tg, chunks, rpc = _plan(x2, g2, dx)
    part = torch.empty(2 * chunks * c, dtype=torch.float32, device=x2.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x2.device)
    dbeta = torch.empty_like(dgamma)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.dl4j_bn_backward(
            DTYPES[x2.dtype], x2.data_ptr(), g2.data_ptr(),
            *(t.data_ptr() for t in vecs),
            *(None if t is None else t.data_ptr() for t in extra),
            float(eps), int(relu), rows, c, vec, tg, chunks, rpc,
            part.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            dx.data_ptr(), _stream(x2))
    _raise_on(lib, err, "backward")
    bwd_launches += 1
    return dx, dgamma, dbeta


# -------------------------------------------------------------- autograd ops
class BatchNormKernels(torch.autograd.Function):
    """Kernels (a) and (b) forward, kernel (c) backward, on a CUDA
    ``[rows, C]``. Returns ``(y, mean, var)``, the statistics in x's
    dtype; under ``relu`` they carry no gradient (the reference's
    ``stop_gradient``), else their gradients reach x through (c)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, relu):
        m, v = bn_stats_kernel(x2)
        y = bn_apply_kernel(x2, m, v, gamma, beta, eps, relu)
        ctx.save_for_backward(x2, gamma, beta, m, v)
        ctx.eps, ctx.relu = eps, relu
        ctx.set_materialize_grads(False)
        mo, vo = m.to(x2.dtype), v.to(x2.dtype)
        if relu:
            ctx.mark_non_differentiable(mo, vo)
        return y, mo, vo

    @staticmethod
    def backward(ctx, gy, gm, gv):
        x2, gamma, beta, m, v = ctx.saved_tensors
        gy = torch.zeros_like(x2) if gy is None else gy.contiguous()
        dx, dg, db = bn_backward_kernel(x2, gy, m, v, gamma, beta, ctx.eps,
                                        ctx.relu, gm, gv)
        return dx, dg.to(gamma.dtype), db.to(beta.dtype), None, None


class _BnReluPlain(torch.autograd.Function):
    """``_bn_relu_core``'s ``custom_vjp`` on the CPU: the plain forward,
    and the plain two-pass backward instead of autograd's."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, axes):
        m, v = bn_stats_reference(x, axes)
        ctx.save_for_backward(x, gamma, beta, m, v)
        ctx.eps, ctx.axes = eps, axes
        return bn_apply_reference(x, m, v, gamma, beta, eps, True, axes)

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, m, v = ctx.saved_tensors
        dx, dg, db = bn_backward_reference(x, gy, gamma, beta, m, v, ctx.eps,
                                           True, ctx.axes)
        return dx, dg, db, None, None


def _rows(x, axes: Tuple[int, ...]):
    """``x`` as the kernels' contiguous ``[rows, C]`` and the function that
    lays a ``[rows, C]`` result out as x again: a reshape where ``axes``
    lead, else one copy with the kept axes permuted to the end."""
    kept = tuple(a for a in range(x.dim()) if a not in axes)
    perm = axes + kept
    rows = _count(x, axes)
    if perm == tuple(range(x.dim())):
        return x.contiguous().reshape(rows, -1), lambda t: t.reshape(x.shape)
    xp = x.permute(perm)
    shape = xp.shape
    back = [perm.index(a) for a in range(x.dim())]
    return (xp.contiguous().reshape(rows, -1),
            lambda t: t.reshape(shape).permute(back))


def kernel_path(x, gamma, beta, eps: float, axes: Tuple[int, ...],
                relu: bool):
    """The CUDA path of :func:`batch_norm_train`: x as ``[rows, C]``,
    :class:`BatchNormKernels`, the results laid out as x and the kept
    axes. Tensors of any device reach the kernel wrappers, which take CUDA
    ones only."""
    kept = [x.shape[a] for a in range(x.dim()) if a not in axes]
    x2, back = _rows(x, axes)
    y2, m, v = BatchNormKernels.apply(
        x2, torch.broadcast_to(gamma, kept).reshape(-1),
        torch.broadcast_to(beta, kept).reshape(-1), float(eps), bool(relu))
    return back(y2), m.reshape(kept), v.reshape(kept)


def batch_norm_train(x, gamma, beta, eps: float = 1e-5, axes=None,
                     relu: bool = False):
    """``(y, batch_mean, batch_var)`` over ``axes`` (default all but the
    last), the statistics in x's dtype; ``relu`` fuses the ReLU and
    detaches the statistics (``batch_norm_relu_train``). CPU tensors take
    the plain versions; CUDA tensors the kernels, or the call raises."""
    if axes is None:
        axes = tuple(range(x.dim() - 1))
    axes = tuple(int(a) % x.dim() for a in axes)
    kept = [x.shape[a] for a in range(x.dim()) if a not in axes]
    if x.device.type == "cuda":
        return kernel_path(x, gamma, beta, eps, axes, relu)
    if x.device.type != "cpu":
        raise ValueError(f"batch_norm_train runs on cpu or cuda, not "
                         f"{x.device}")
    if relu:
        y = _BnReluPlain.apply(x, torch.broadcast_to(gamma, kept),
                               torch.broadcast_to(beta, kept), float(eps),
                               axes)
        m, v = bn_stats_reference(x.detach(), axes)
        return y, m.to(x.dtype), v.to(x.dtype)
    m, v = bn_stats_reference(x, axes)
    y = bn_apply_reference(x, m, v, gamma, beta, eps, False, axes)
    return y, m.to(x.dtype), v.to(x.dtype)
