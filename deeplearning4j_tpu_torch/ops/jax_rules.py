"""JAX's rules for the ops by name, in one place.

The registered ops take their tensors, attributes and defaults from the
JAX package; where torch's behaviour differs from ``jax.numpy``'s, the
ops put JAX's rule into effect here first:

- **types**: JAX runs without x64, so 64-bit numbers narrow to 32 bits
  and integer results are int32 (:func:`int32`, :func:`as_tensor`);
- **out-of-range indices**: ``jnp.take`` and ``take_along_axis`` fill
  (NaN for floats, the lowest value for signed integers, the highest for
  unsigned ones, True for booleans: :func:`take_fill`); numpy-style
  indexing clamps (:func:`clamp_index`); ``.at[]`` scatters and
  ``jax.ops.segment_*`` drop the rows they do not hold (:func:`scatter`,
  :func:`segment_reduce`). Negative indices in range count from the end
  everywhere but in the segment ops. No torch index sees a value out of
  range, so no device-side assert fires on the card;
- **duplicates**: a scatter-set keeps the last update of a row, as XLA's
  CPU scatter does, and every scatter and segment reduction runs
  deterministically on the card (``index_put_`` accumulates by sorting;
  the min, max and product reductions do not depend on order but for
  rounding);
- **axes**: ``None`` is every axis and an empty tuple none
  (:func:`reduce_over`);
- **device**: an op that takes no tensor (``range``, ``fill``, the random
  draws) makes its result on :func:`op_device`: the device of the graph
  that runs it (:func:`on_device`), else the CUDA card.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray.dtypes import DataType
from deeplearning4j_tpu_torch.params import numpy_to_tensor_narrowed

_local = threading.local()


@contextlib.contextmanager
def on_device(device):
    """Ops that take no tensor make their results on ``device`` inside
    this block (a graph runs its ops inside one)."""
    prev = getattr(_local, "device", None)
    _local.device = torch.device(device)
    try:
        yield
    finally:
        _local.device = prev


def op_device(*tensors) -> torch.device:
    """The device of the first tensor among ``tensors``; with none, the
    running graph's device, else the CUDA card (or a raise without one)."""
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    dev = getattr(_local, "device", None)
    return dev if dev is not None else resolve_device(None)


def as_tensor(v, device=None, dtype=None) -> torch.Tensor:
    """An attribute or operand as a tensor on ``device`` (default:
    :func:`op_device`): numpy arrays and Python values narrowed to 32 bits
    as ``jnp.asarray`` narrows them."""
    if isinstance(v, torch.Tensor):
        t = v if device is None else v.to(device)
    else:
        if hasattr(v, "_buf"):                        # an NDArray
            return as_tensor(v._buf, device, dtype)
        t = numpy_to_tensor_narrowed(np.asarray(v)).to(
            device if device is not None else op_device())
    return t if dtype is None else t.to(dtype)


def index_tensor(idx, device) -> torch.Tensor:
    """Integer indices (a tensor, numpy array, list or int) as int64 on
    ``device``."""
    return as_tensor(idx, device).to(torch.int64)


#: what JAX without x64 makes of a 64-bit type
NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
          torch.uint64: torch.uint32, torch.complex128: torch.complex64}


@contextlib.contextmanager
def x64():
    """JAX's ``jax.enable_x64()`` inside this block: :func:`torch_dtype`
    keeps 64-bit types (the ONNX importer folds its integer constants
    so)."""
    prev = getattr(_local, "x64", False)
    _local.x64 = True
    try:
        yield
    finally:
        _local.x64 = prev


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """A JAX-side dtype spelling (string, numpy or torch dtype, DataType)
    as a torch dtype; 64-bit types narrow, as JAX makes them, but inside
    :func:`x64`."""
    if dtype is None:
        return None
    dt = DataType.from_any(dtype).torch
    if getattr(_local, "x64", False):
        return dt
    return NARROW.get(dt, dt)


def int32(t: torch.Tensor) -> torch.Tensor:
    """Integer and index results in JAX's int32."""
    return t.to(torch.int32) if t.dtype == torch.int64 else t


def fill_value(dtype: torch.dtype):
    """What ``jnp.take`` puts where an index is out of range."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def normalize_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Negative indices counted from the end (``-n <= i < 0``)."""
    return torch.where(idx < 0, idx + n, idx)


def clamp_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """numpy-style indexing as JAX gathers it: negatives from the end,
    then clamped into ``[0, n)``."""
    return normalize_index(idx, n).clamp(0, max(n - 1, 0))


def take_fill(x: torch.Tensor, idx, axis: int = 0) -> torch.Tensor:
    """``jnp.take(x, idx, axis)`` (mode "fill"): the output takes
    ``idx``'s shape in place of ``axis``; out-of-range entries hold
    :func:`fill_value`."""
    axis = axis % x.dim()
    n = x.shape[axis]
    idx = normalize_index(index_tensor(idx, x.device), n)
    ok = (idx >= 0) & (idx < n)
    flat = idx.clamp(0, max(n - 1, 0)).reshape(-1)
    out = torch.index_select(x, axis, flat)
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    okb = ok.reshape((1,) * axis + idx.shape
                     + (1,) * (x.dim() - axis - 1))
    # a select, not a host test of the mask: the card never waits here
    return torch.where(okb, out, torch.full((), fill_value(x.dtype),
                                            dtype=x.dtype, device=x.device))


def take_along_fill(x: torch.Tensor, idx, axis: int) -> torch.Tensor:
    """``jnp.take_along_axis`` (mode "fill"), broadcasting as it does."""
    axis = axis % x.dim()
    n = x.shape[axis]
    idx = normalize_index(index_tensor(idx, x.device), n)
    ok = (idx >= 0) & (idx < n)
    out = torch.take_along_dim(x, idx.clamp(0, max(n - 1, 0)), dim=axis)
    return torch.where(ok, out, torch.full((), fill_value(x.dtype),
                                           dtype=x.dtype, device=x.device))


def _rows(x: torch.Tensor, idx: torch.Tensor, upd) -> tuple:
    """Flattened row indices, each out-of-range one sent to row
    ``x.shape[0]`` (a padding row past the end), and the updates
    broadcast to one row each: ``[M]``, ``[M, *x.shape[1:]]``."""
    n = x.shape[0]
    idx = normalize_index(idx, n)
    upd = as_tensor(upd, x.device).to(x.dtype)
    upd = torch.broadcast_to(upd, idx.shape + x.shape[1:])
    flat = idx.reshape(-1)
    flat = torch.where((flat >= 0) & (flat < n), flat,
                       torch.full_like(flat, n))
    return flat, upd.reshape((-1,) + x.shape[1:])


def _padded(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` with one more row along axis 0, holding ``fill``."""
    return torch.cat([x, torch.full((1,) + x.shape[1:], fill, dtype=x.dtype,
                                    device=x.device)])


def scatter(x: torch.Tensor, indices, updates, mode: str) -> torch.Tensor:
    """``x.at[indices].<mode>(updates)`` along axis 0 (``set``, ``add``,
    ``mul``, ``div``, ``min``, ``max``): a new tensor, rows out of range
    dropped, a ``set`` keeping each row's last update. A dropped row is
    written into a padding row that is cut off after, so no boolean mask
    and no host read: the card never waits here."""
    n = x.shape[0]
    idx, upd = _rows(x, index_tensor(indices, x.device), updates)
    xp = _padded(x, 1 if mode in ("mul", "div") else 0)
    if mode == "set":
        order = torch.arange(idx.numel(), device=x.device)
        last = torch.full((n + 1,), -1, dtype=torch.int64,
                          device=x.device).scatter_reduce(
            0, idx, order, "amax")
        # an update that a later one overwrites goes to the padding row
        idx = torch.where(last[idx] == order, idx, torch.full_like(idx, n))
        return xp.index_put((idx,), upd)[:n]
    if mode == "add":
        return xp.index_put((idx,), upd, accumulate=True)[:n]
    if mode in ("mul", "div"):
        # a dropped factor of 1: a zero there would put 0 * inf in the
        # padding row's backward
        drop = (idx == n).reshape((-1,) + (1,) * (x.dim() - 1))
        upd = torch.where(drop, torch.ones((), dtype=x.dtype,
                                           device=x.device), upd)
    if mode == "div":
        mode, upd = "mul", 1 / upd
    reduce = {"mul": "prod", "min": "amin", "max": "amax"}[mode]
    full = idx.reshape((-1,) + (1,) * (x.dim() - 1)).expand(upd.shape)
    return xp.scatter_reduce(0, full, upd, reduce)[:n]


def scatter_nd(x: torch.Tensor, indices, updates, mode: str) -> torch.Tensor:
    """``x.at[tuple(moveaxis(indices, -1, 0))].<mode>(updates)``: each
    index row names the first ``k`` axes of ``x``; rows with any index out
    of range dropped."""
    idx = index_tensor(indices, x.device)
    k = idx.shape[-1]
    lead, tail = x.shape[:k], x.shape[k:]
    ok = torch.ones(idx.shape[:-1], dtype=torch.bool, device=x.device)
    flat = torch.zeros(idx.shape[:-1], dtype=torch.int64, device=x.device)
    for d in range(k):
        i = normalize_index(idx[..., d], lead[d])
        ok &= (i >= 0) & (i < lead[d])
        flat = flat * lead[d] + i
    # a dropped row goes past the end (a negative one would wrap), where
    # :func:`scatter` drops it
    flat = torch.where(ok, flat, torch.full_like(flat, int(np.prod(lead))))
    rows = x.reshape((-1,) + tail)
    upd = torch.broadcast_to(as_tensor(updates, x.device).to(x.dtype),
                             idx.shape[:-1] + tail)
    return scatter(rows, flat, upd, mode).reshape(x.shape)


def segment_reduce(data: torch.Tensor, ids, num_segments: int,
                   reduce: str) -> torch.Tensor:
    """``jax.ops.segment_<reduce>``: ``[num_segments, *data.shape[1:]]``,
    ids out of ``[0, num_segments)`` dropped (negatives too); an empty
    segment holds the reduction's identity (0, 1, the dtype's lowest or
    highest value)."""
    num_segments = int(num_segments)
    ids = index_tensor(ids, data.device)
    rows = data.reshape((ids.numel(),) + data.shape[ids.dim():])
    ids = ids.reshape(-1)
    # a dropped id goes to a padding segment past the end, cut off after
    ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                      torch.full_like(ids, num_segments))
    shape = (num_segments + 1,) + rows.shape[1:]
    if reduce == "sum":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device)
        return out.index_put((ids,), rows, accumulate=True)[:num_segments]
    if data.dtype.is_floating_point:
        lo, hi = float("-inf"), float("inf")
    elif data.dtype == torch.bool:
        lo, hi = False, True
    else:
        info = torch.iinfo(data.dtype)
        lo, hi = info.min, info.max
    init = {"max": lo, "min": hi, "prod": 1}[reduce]
    out = torch.full(shape, init, dtype=data.dtype, device=data.device)
    full = ids.reshape((-1,) + (1,) * (rows.dim() - 1)).expand(rows.shape)
    return out.scatter_reduce(0, full, rows,
                              {"max": "amax", "min": "amin",
                               "prod": "prod"}[reduce])[:num_segments]


def axes(dims, ndim: int):
    """JAX's axis argument as a tuple: None is every axis, an int one."""
    if dims is None:
        return tuple(range(ndim))
    if isinstance(dims, (int, np.integer)):
        return (int(dims),)
    return tuple(int(d) for d in dims)


def reduce_over(fn, x, dims, keep_dims, **kw):
    """``fn(x, dim=..., keepdim=...)`` over JAX's axes: an empty tuple
    reduces nothing (torch would reduce everything), a torch function
    that takes one axis at a time is applied axis by axis. An integer
    result comes back in int32."""
    ax = axes(dims, x.dim())
    if len(ax) == 0:
        out = fn(x.unsqueeze(-1), dim=-1, keepdim=False, **kw)
    elif getattr(fn, "_one_axis", False):
        out = x
        for d in sorted((a % x.dim() for a in ax), reverse=True):
            out = fn(out, dim=d, keepdim=keep_dims, **kw)
    else:
        out = fn(x, dim=ax, keepdim=keep_dims, **kw)
    return int32(out) if x.dtype != torch.int64 else out


def one_axis(fn):
    """Mark a torch reduction that takes a single ``dim``."""
    def call(x, dim, keepdim=False, **kw):
        return fn(x, dim=dim, keepdim=keepdim, **kw)

    call._one_axis = True
    return call


prod = one_axis(torch.prod)


def pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """The source position of each output position of an axis of ``n``
    padded by ``(lo, hi)`` in ``jnp.pad``'s non-constant ``mode``
    (reflect, symmetric, edge, wrap)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        p = 2 * (n - 1)
        j = torch.remainder(i, p)
        return torch.where(j < n, j, p - j)
    if mode == "symmetric":
        p = 2 * n
        j = torch.remainder(i, p)
        return torch.where(j < n, j, p - 1 - j)
    raise NotImplementedError(f"pad mode {mode!r}")


def pad_array(x, paddings, mode="constant", value=0.0):
    """``jnp.pad`` of ``x`` by ``(lo, hi)`` a side per axis."""
    paddings = [tuple(int(v) for v in p) for p in paddings]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(paddings):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, value=float(value))
    for d, (lo, hi) in enumerate(paddings):
        if lo or hi:
            x = torch.index_select(
                x, d, pad_index(x.shape[d], lo, hi, mode, x.device))
    return x


def top_k_stable(x, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest, ties lower
    index first (a stable descending sort); indices int32."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)
