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
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.ops import native

#: kernel launches since the last reset, one per wrapper call (each is one
#: device launch); incremented only where the CUDA kernels launch
stats_launches = 0
apply_launches = 0
bwd_launches = 0

#: the dtypes the kernels take, by the number the C entries take
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

THREADS = 256          # threads per block of (b), consumers of (a), (c) (kThreads)
MAX_GROUPS = 32        # channel groups per block row of (b) (kMaxTg)
TARGET_BLOCKS = 512    # blocks an apply launch aims at (about 4 per SM on the H100)
ROWS_PER_LANE = 4      # rows of a reduce tile per row lane (kRowsPerLane)
#: work items (chunks) a reduce launch aims at: one for each of the H100's
#: 132 SMs. A constant, so the sums' grouping is the same on every card;
#: only the balance of the persistent grid depends on the card
TARGET_ITEMS = 132


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


class ReducePlan(NamedTuple):
    """The work of one statistics or backward launch: ``ctiles`` channel
    tiles of ``tg`` groups (16-byte groups where ``vec``, single channels
    otherwise) by ``chunks`` row chunks of ``tpc`` tiles of ``rows``
    (``ROWS_PER_LANE`` x ``lanes``) rows each. Item ``q`` is channel tile
    ``q // chunks``, row chunk ``q % chunks``; each item's sums are one
    partial, and the persistent grid's block ``b`` takes items ``b, b +
    grid, ...``."""
    vec: int
    tg: int
    lanes: int
    rows: int
    tpc: int
    chunks: int
    ctiles: int

    @property
    def items(self) -> int:
        return self.ctiles * self.chunks

    @property
    def rpc(self) -> int:
        """Rows per chunk."""
        return self.tpc * self.rows


def reduce_plan(rows: int, channels: int, itemsize: int,
                aligned: bool) -> ReducePlan:
    """The statistics' and the backward's cut of ``[rows, channels]`` into
    tiles and items, about :data:`TARGET_ITEMS` items. From the shape
    alone, never the card: the grid only decides which block sums which
    item, so the bits are the same on every card."""
    per = 16 // itemsize
    vec = int(aligned and channels % per == 0)
    groups = channels // per if vec else channels
    tg = min(groups, THREADS)
    lanes = THREADS // tg
    tile_rows = ROWS_PER_LANE * lanes
    ctiles = -(-groups // tg)
    tiles = -(-rows // tile_rows)
    tpc = -(-tiles // max(1, TARGET_ITEMS // ctiles))
    return ReducePlan(vec, tg, lanes, tile_rows, tpc, -(-tiles // tpc),
                      ctiles)


def _lib():
    lib = native.load("batch_norm")
    if lib.dl4j_bn_stats.argtypes is None:
        vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
        lib.dl4j_bn_stats.argtypes = [i, vp, ll, i, i, vp, vp, vp, vp, vp,
                                      vp, vp, vp, i, vp]
        lib.dl4j_bn_apply.argtypes = [i, vp, vp, vp, vp, vp, i, f, i, ll, i,
                                      i, i, i, ll, vp, i, vp]
        lib.dl4j_bn_backward.argtypes = [i, vp, vp, vp, vp, vp, vp, i, vp, vp,
                                         f, i, ll, i, i, vp, vp, vp, vp, vp,
                                         vp, vp, vp, vp, i, vp]
        for fn in (lib.dl4j_bn_stats, lib.dl4j_bn_apply,
                   lib.dl4j_bn_backward):
            fn.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(name: str, t: torch.Tensor, like: Optional[torch.Tensor]):
    if (t.dtype in DTYPES and t.is_cuda and t.dim() == 2
            and t.is_contiguous() and t.numel() and (
                like is None or (t.shape == like.shape
                                 and t.dtype == like.dtype
                                 and t.get_device() == like.get_device()))):
        return
    if t.dtype not in DTYPES:
        raise TypeError(f"the batch-norm kernels take float32, bfloat16 or "
                        f"float16, got {name} {t.dtype}")
    if t.dim() != 2 or t.numel() == 0 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous non-empty [rows, C], "
                         f"got {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got "
                         f"{t.device}")
    raise ValueError(f"{name} must match x ({like.dtype} "
                     f"{tuple(like.shape)} on {like.device})")


def _vectors(x2, *vecs):
    """The per-channel vectors ``(name, tensor)`` as contiguous f32 ``[C]``
    on x's device: the tensor itself where it is one already (the caller
    holds them until the launch is enqueued)."""
    c, dev = x2.shape[1], x2.get_device()
    out = []
    for name, t in vecs:
        if not (t.dtype is torch.float32 and t.dim() == 1
                and t.shape[0] == c and t.is_contiguous()
                and t.get_device() == dev):
            if t.numel() != c or t.device != x2.device:
                raise ValueError(f"{name} must hold C = {c} values on "
                                 f"{x2.device}, got {tuple(t.shape)} on "
                                 f"{t.device}")
            t = t.reshape(c).float().contiguous()
        out.append(t)
    return out


def _affine(x2, gamma, beta):
    """``(gamma, beta, their type's number)`` as the kernels read them:
    each as it is where both are contiguous ``[C]`` of one of the kernels'
    types on x's device (no cast before the launch), else both as f32
    (:func:`_vectors`)."""
    c, dev = x2.shape[1], x2.get_device()
    if (gamma.dtype in DTYPES and beta.dtype is gamma.dtype
            and all(t.dim() == 1 and t.shape[0] == c and t.is_contiguous()
                    and t.get_device() == dev for t in (gamma, beta))):
        return gamma, beta, DTYPES[gamma.dtype]
    return (*_vectors(x2, ("gamma", gamma), ("beta", beta)), 0)


#: apply plans by (rows, C, itemsize, aligned)
_apply_plans: Dict[tuple, tuple] = {}
#: reduce plans by (rows, C, itemsize, aligned): the plan and its six ints
#: as the C entries take them
_reduce_plans: Dict[tuple, tuple] = {}
#: (grid, ring stages, shared bytes, blocks per SM) of the last statistics
#: or backward launch, written by the C entry
_info = (ctypes.c_int * 4)()
#: the grid-barrier word and the partials scratch by (device, stream),
#: allocated once and grown to the largest call; the barrier leaves its
#: word's low bits zero, so it serves every launch as it is
_scratch: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def last_launch() -> Tuple[int, int, int, int]:
    """``(grid, ring stages, shared bytes, blocks per SM)`` of the last
    statistics or backward launch in this process."""
    return tuple(_info)


def _apply_plan(x2, ptrs: int):
    """(b)'s ``launch_plan`` of x, cached; ``ptrs`` the OR of the call's
    data pointers."""
    rows, c = x2.shape
    key = (rows, c, x2.dtype, ptrs & 15 == 0)
    got = _apply_plans.get(key)
    if got is None:
        got = _apply_plans[key] = launch_plan(rows, c, x2.element_size(),
                                              key[3])
    return got


def _reduce_args(x2, ptrs: int, dev: int):
    """``(plan, its ints, barrier word, partials, stream)`` of a reduce
    call on x (``ptrs`` the OR of the call's data pointers), the scratch
    on x's device and stream."""
    rows, c = x2.shape
    key = (rows, c, x2.dtype, ptrs & 15 == 0)
    got = _reduce_plans.get(key)
    if got is None:
        plan = reduce_plan(rows, c, x2.element_size(), key[3])
        got = _reduce_plans[key] = (plan, (ctypes.c_int * 6)(*plan[1:]))
    plan, ints = got
    stream = _stream(dev)
    floats = 2 * plan.chunks * c
    held = _scratch.get((dev, stream))
    if held is None or held[1].numel() < floats:
        bar = held[0] if held is not None else torch.zeros(
            1, dtype=torch.int32, device=x2.device)
        held = _scratch[(dev, stream)] = (bar, torch.empty(
            floats, dtype=torch.float32, device=x2.device))
    return plan, ints, held[0].data_ptr(), held[1].data_ptr(), stream


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.dl4j_cuda_error_string(err).decode()
        raise RuntimeError(f"batch-norm {what} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def _stream(dev: int) -> int:
    """PyTorch's current stream on CUDA device ``dev``, as a handle."""
    return torch._C._cuda_getCurrentRawStream(dev)


def bn_stats_kernel(x2, in_x_dtype: bool = False):
    """Kernel (a) on a CUDA ``[rows, C]``, one cooperative launch: f32
    ``(mean, var)`` ``[C]``, the shift the first row; with ``in_x_dtype``
    also the two rounded to x's dtype, written by the same launch
    (``(mean, var, mean_x, var_x)``; the f32 ones again for f32 x). Raises
    on what the kernel does not take, on a failed build and on a refused
    launch."""
    global stats_launches
    _check_rows("x", x2, None)
    rows, c = x2.shape
    dev, px = x2.get_device(), x2.data_ptr()
    plan, ints, bar, part, stream = _reduce_args(x2, px, dev)
    out = x2.new_empty((2, c), dtype=torch.float32)
    po = out.data_ptr()
    typed = (x2.new_empty((2, c)) if in_x_dtype
             and x2.dtype is not torch.float32 else None)
    pt = None if typed is None else typed.data_ptr()
    lib = _lib()
    err = lib.dl4j_bn_stats(DTYPES[x2.dtype], px, rows, c, plan.vec, ints,
                            part, bar, po, po + 4 * c, pt,
                            None if pt is None else pt + c * x2.element_size(),
                            _info, dev, stream)
    _raise_on(lib, err, "statistics")
    stats_launches += 1
    if not in_x_dtype:
        return out.unbind()
    return (*out.unbind(), *(out if typed is None else typed).unbind())


def bn_apply_kernel(x2, mean, var, gamma, beta, eps: float = 1e-5,
                    relu: bool = False) -> torch.Tensor:
    """Kernel (b) on a CUDA ``[rows, C]``: ``x * scale + shift`` in x's
    dtype (then ``max(y, 0)`` where ``relu``) from f32 statistics and any
    float ``gamma``, ``beta`` (read in their dtype where they share one of
    the kernels'). Raises like :func:`bn_stats_kernel`."""
    global apply_launches
    _check_rows("x", x2, None)
    vecs = _vectors(x2, ("mean", mean), ("var", var))
    ga, be, vdt = _affine(x2, gamma, beta)
    y = torch.empty_like(x2)
    rows, c = x2.shape
    dev, px, py = x2.get_device(), x2.data_ptr(), y.data_ptr()
    vec, tg, chunks, rpc = _apply_plan(x2, px | py)
    lib = _lib()
    err = lib.dl4j_bn_apply(DTYPES[x2.dtype], px,
                            *(t.data_ptr() for t in (*vecs, ga, be)), vdt,
                            float(eps), int(relu), rows, c, vec, tg, chunks,
                            rpc, py, dev, _stream(dev))
    _raise_on(lib, err, "apply")
    apply_launches += 1
    return y


def bn_backward_kernel(x2, g2, mean, var, gamma, beta, eps: float = 1e-5,
                       relu: bool = False, gm=None, gv=None):
    """Kernel (c) on CUDA ``[rows, C]`` x and upstream g (one dtype), one
    cooperative launch: ``(dx, dgamma, dbeta)``, dx in x's dtype, the
    others ``[C]`` in the dtype the kernel read gamma and beta in
    (:func:`_affine`: theirs where they share one of the kernels', else
    f32), rounded by the same launch. ``gm`` / ``gv`` (None for none) are
    the gradients of the returned mean and variance. Raises like
    :func:`bn_stats_kernel`."""
    global bwd_launches
    _check_rows("x", x2, None)
    _check_rows("g", g2, x2)
    vecs = _vectors(x2, ("mean", mean), ("var", var))
    ga, be, vdt = _affine(x2, gamma, beta)
    extra = [None, None]
    if gm is not None or gv is not None:
        extra = _vectors(
            x2, ("gm", torch.zeros_like(mean) if gm is None else gm),
            ("gv", torch.zeros_like(var) if gv is None else gv))
    dx = torch.empty_like(x2)
    rows, c = x2.shape
    dev, px, pg, pd = x2.get_device(), x2.data_ptr(), g2.data_ptr(), \
        dx.data_ptr()
    plan, ints, bar, part, stream = _reduce_args(x2, px | pg | pd, dev)
    out = x2.new_empty((2, c), dtype=torch.float32)
    po = out.data_ptr()
    typed = None if vdt == 0 else x2.new_empty((2, c), dtype=ga.dtype)
    pt = None if typed is None else typed.data_ptr()
    lib = _lib()
    err = lib.dl4j_bn_backward(DTYPES[x2.dtype], px, pg,
                               *(t.data_ptr() for t in (*vecs, ga, be)), vdt,
                               *(None if t is None else t.data_ptr()
                                 for t in extra),
                               float(eps), int(relu), rows, c, plan.vec, ints,
                               part, bar, po + 4 * c, po,
                               None if pt is None
                               else pt + c * typed.element_size(), pt, pd,
                               _info, dev, stream)
    _raise_on(lib, err, "backward")
    bwd_launches += 1
    res = out if typed is None else typed
    return dx, res[1], res[0]


# -------------------------------------------------------------- autograd ops
class BatchNormKernels(torch.autograd.Function):
    """Kernels (a) and (b) forward, kernel (c) backward, on a CUDA
    ``[rows, C]``. Returns ``(y, mean, var)``, the statistics in x's
    dtype; under ``relu`` they carry no gradient (the reference's
    ``stop_gradient``), else their gradients reach x through (c)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, relu):
        m, v, mo, vo = bn_stats_kernel(x2, in_x_dtype=True)
        y = bn_apply_kernel(x2, m, v, gamma, beta, eps, relu)
        ctx.save_for_backward(x2, gamma, beta, m, v)
        ctx.eps, ctx.relu = eps, relu
        ctx.set_materialize_grads(False)
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
