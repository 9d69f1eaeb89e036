"""LSTM recurrence from a precomputed input projection.

Counterpart of ``deeplearning4j_tpu/ops/lstm_pallas.py``: for ``x_proj``
``[T, N, 4H]`` (input projection plus bias, gates i, f, g, o), ``w_hh``
``[H, 4H]`` and ``h0``, ``c0`` ``[N, H]``, returns ``(ys [T, N, H], hT, cT)``
with h and c carried in f32, h cast to ``w_hh``'s dtype for the dot, the
gates in f32 and everything stored in ``x_proj``'s dtype, as the Pallas
kernel does (``_kernel``, lstm_pallas.py:43-81).

- :func:`lstm_recurrence_reference` and
  :func:`lstm_recurrence_backward_reference`: the plain versions, the step
  loop of ``_kernel`` and a port of ``_recurrence_bwd`` (``:167-217``, the
  reverse-time recompute scan).
- :func:`lstm_recurrence_fwd` and :func:`lstm_recurrence_bwd`: the
  hand-written Hopper kernels of ``csrc/lstm_recurrence.cu`` (one
  persistent launch each); the backward's weight gradient is one f32
  ``torch.matmul`` over all ``T * N`` rows of the kernel's f32 ``da``
  after the kernel, as the JAX backward leaves that sum to XLA and casts
  only its result. Each has two routes, chosen by :func:`fwd_route` and
  :func:`bwd_route` from dtypes, shape and alignment: ``"cluster"``
  (bf16 at H in {64, 128, 256}: thread-block clusters per batch tile with
  a DSMEM exchange and tensor-core products) and ``"grid"`` (the first
  design, a cooperative launch with a grid-wide barrier, for the rest; it
  takes any T, N and H, walking several tiles per block, or reading
  ``w_hh`` from L2, where the card cannot hold them otherwise). A call
  that mixes f32 and bf16 among its inputs (as the Pallas kernel takes
  them), or holds any f16, runs the grid route at f32 over widened
  inputs, with h rounded to ``w_hh``'s type before the product where
  ``w_hh`` is bf16 or f16, and casts its outputs to the plain versions'
  dtypes.
- :class:`LSTMRecurrence` joins a forward and a backward into one
  differentiable op; its forward streams the cell states ``cs`` only when
  a gradient is needed (``collect_cell``, lstm_pallas.py:51-55, 161-164).
  :func:`lstm_recurrence` is the dispatcher: CPU tensors take the plain
  versions, CUDA tensors the kernels, which launch or raise. No mode
  switch, no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import native

#: launches of the forward / backward kernels since the last reset;
#: incremented only where :func:`lstm_recurrence_fwd` /
#: :func:`lstm_recurrence_bwd` launch them (one per call), and of those the
#: launches that took the cluster route
fwd_launches = 0
bwd_launches = 0
fwd_cluster_launches = 0
bwd_cluster_launches = 0

#: the kernels' envelope (``bad_shape`` in the CUDA source): every size
#: the reference's scan takes, within 32-bit offsets of a step's rows
ENVELOPE = "the LSTM kernels take T, N, H >= 1 with N * 4H < 2^31"

#: the launch plan of the last kernel call: blocks, rows per thread,
#: chunk, shared bytes, blocks per SM, tiles per block, w_hh in shared
#: memory (1) or read from L2 (0) (grid route); blocks, cluster size,
#: rows per cluster, shared bytes, clusters the card holds at once, 0, 0
#: (cluster route)
last_plan: Tuple[int, ...] = ()

#: the kernels' routes, by the number the C entries take
ROUTES = {"grid": 0, "cluster": 1}
#: the dtypes the wrappers take, in any mix
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: the storage types the kernels compute in; other calls (f16, or f32 and
#: bf16 mixed) run at f32 over widened inputs
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: ``round_h`` of the C entries: h rounded to ``w_hh``'s type before the
#: product, under f32 storage
ROUND_H = {torch.bfloat16: 1, torch.float16: 2}
#: hidden widths of the cluster route (a block owns 32 units; clusters of
#: H / 32 blocks, at most the portable 8)
CLUSTER_HIDDEN = (64, 128, 256)


# ------------------------------------------------------------ plain versions
def _gates(h, w_hh, w32, xp_t):
    hidden = w_hh.shape[0]
    a = h.to(w_hh.dtype).to(torch.float32) @ w32 + xp_t.to(torch.float32)
    i = torch.sigmoid(a[:, :hidden])
    f = torch.sigmoid(a[:, hidden:2 * hidden])
    g = torch.tanh(a[:, 2 * hidden:3 * hidden])
    o = torch.sigmoid(a[:, 3 * hidden:])
    return i, f, g, o


def lstm_recurrence_reference(x_proj, w_hh, h0, c0, collect_cell=False):
    """The step loop of the Pallas kernel: ``(ys, hT, cT)``, plus ``cs``
    (the per-step cell states) when ``collect_cell``."""
    steps = x_proj.shape[0]
    dt = x_proj.dtype
    w32 = w_hh.to(torch.float32)
    h = h0.to(torch.float32)
    c = c0.to(torch.float32)
    ys, cs = [], []
    for t in range(steps):
        i, f, g, o = _gates(h, w_hh, w32, x_proj[t])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(dt))
        if collect_cell:
            cs.append(c.to(dt))
    out = (torch.stack(ys), h.to(dt), c.to(dt))
    return out + (torch.stack(cs),) if collect_cell else out


def lstm_recurrence_backward_reference(x_proj, w_hh, h0, c0, ys, cs, dys,
                                       dhT=None, dcT=None):
    """``_recurrence_bwd``: the reverse-time scan that recomputes the gates
    from ``(h_{t-1}, x_proj[t])``, all in f32; returns ``(d x_proj,
    d w_hh, dh0, dc0)`` in the primal dtypes."""
    f32 = torch.float32
    steps, n, _ = x_proj.shape
    w32 = w_hh.to(f32)
    # the states entering each step; a mixed h0 / ys pair promotes, as
    # jnp.concatenate does
    h_prev = torch.cat([h0[None], ys[:-1]])
    c_prev = torch.cat([c0[None], cs[:-1]])
    dh = (torch.zeros_like(h0, dtype=f32) if dhT is None else dhT.to(f32))
    dc = (torch.zeros_like(c0, dtype=f32) if dcT is None else dcT.to(f32))
    dw = torch.zeros(w_hh.shape, dtype=f32, device=w_hh.device)
    das = torch.empty(x_proj.shape, dtype=f32, device=x_proj.device)
    for t in range(steps - 1, -1, -1):
        dh = dh + dys[t].to(f32)
        i, f, g, o = _gates(h_prev[t], w_hh, w32, x_proj[t])
        tanh_c = torch.tanh(cs[t].to(f32))
        do = dh * tanh_c
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        di = dc * g
        df = dc * c_prev[t].to(f32)
        dg = dc * i
        da = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                        dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        das[t] = da
        dw = dw + h_prev[t].to(f32).T @ da
        dh = da @ w32.T
        dc = dc * f
    return (das.to(x_proj.dtype), dw.to(w_hh.dtype), dh.to(h0.dtype),
            dc.to(c0.dtype))


def bf16_split3(x):
    """``x`` (f32) as three bf16 terms ``hi + mid + lo``, each the bf16
    rounding of what the terms before it leave (every difference is exact
    in f32): the cluster route's operands of ``da @ w_hh^T``, whose three
    products with a bf16 ``w_hh`` it sums in f32."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


# ------------------------------------------------------------------ kernels
def _lib():
    lib = native.load("lstm_recurrence")
    if lib.dl4j_lstm_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dl4j_lstm_fwd.argtypes = [i, i, i] + [vp] * 10 + [i, i, i, vp,
                                                              vp]
        lib.dl4j_lstm_fwd.restype = ctypes.c_int
        lib.dl4j_lstm_bwd.argtypes = [i, i, i] + [vp] * 15 + [i, i, i, vp,
                                                              vp]
        lib.dl4j_lstm_bwd.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_envelope(steps: int, n: int, hidden: int) -> None:
    """Raise ``ValueError`` naming the envelope unless the kernels take
    this shape."""
    if min(steps, n, hidden) < 1 or n * 4 * hidden >= 2 ** 31:
        raise ValueError(f"{ENVELOPE}; got T={steps}, N={n}, H={hidden}")


def _check_kernel_args(x_proj, w_hh, h0, c0) -> None:
    ts = (("x_proj", x_proj), ("w_hh", w_hh), ("h0", h0), ("c0", c0))
    for name, t in ts:
        if t.dtype not in DTYPES:
            raise TypeError(f"the LSTM kernels take float32, bfloat16 or "
                            f"float16, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x_proj.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(f"need x_proj [T, N, 4H] and w_hh [H, 4H], got "
                         f"{tuple(x_proj.shape)} / {tuple(w_hh.shape)}")
    steps, n, four_h = x_proj.shape
    hidden = w_hh.shape[0]
    if tuple(w_hh.shape) != (hidden, 4 * hidden) or four_h != 4 * hidden:
        raise ValueError(f"x_proj {tuple(x_proj.shape)} and w_hh "
                         f"{tuple(w_hh.shape)} disagree on 4H")
    for name, t in (("h0", h0), ("c0", c0)):
        if tuple(t.shape) != (n, hidden):
            raise ValueError(f"{name} must be [N, H] = {(n, hidden)}, got "
                             f"{tuple(t.shape)}")
    devs = {t.device for _, t in ts}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")
    if x_proj.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got "
                         f"{x_proj.device}")
    check_envelope(steps, n, hidden)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.dl4j_cuda_error_string(err).decode()
        raise RuntimeError(f"LSTM {what} kernel launch failed: {msg} "
                           f"(cudaError {err}); {ENVELOPE}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _storage(*ts) -> Optional[torch.dtype]:
    """The one dtype of the given tensors (None entries skipped), or None
    where they mix dtypes."""
    dtypes = {t.dtype for t in ts if t is not None}
    return dtypes.pop() if len(dtypes) == 1 else None


def _widened(w_hh, *ts) -> Optional[int]:
    """None where the kernels take the call as it is (one storage type,
    f32 or bf16); else the ``round_h`` of the widened f32 call."""
    if _storage(w_hh, *ts) in KERNEL_DTYPES:
        return None
    return ROUND_H.get(w_hh.dtype, 0)


def _cluster_fits(w_hh, storage, *aligned) -> bool:
    return (storage == torch.bfloat16 and w_hh.shape[0] in CLUSTER_HIDDEN
            and all(t.data_ptr() % 16 == 0 for t in aligned))


def fwd_route(x_proj, w_hh, h0, c0=None) -> str:
    """The forward kernel route a call takes, from dtypes, shapes and
    alignment alone (any device): ``"cluster"`` where ``x_proj``, ``w_hh``
    and ``h0`` (and ``c0``, where given) are all bf16, H is in
    :data:`CLUSTER_HIDDEN` and ``x_proj``, ``w_hh`` and ``h0`` are 16-byte
    aligned (the route's 16-byte copies), any T and N; ``"grid"``
    otherwise (float32, float16, mixed dtypes, other widths)."""
    storage = _storage(x_proj, w_hh, h0, c0)
    return ("cluster" if _cluster_fits(w_hh, storage, x_proj, w_hh, h0)
            else "grid")


def bwd_route(x_proj, w_hh, h0, ys, c0=None) -> str:
    """The backward kernel route a call takes, from dtypes, shapes and
    alignment alone (any device): ``"cluster"`` for bf16 ``x_proj``,
    ``w_hh``, ``h0`` and ``ys`` (and ``c0``, where given) with H in
    :data:`CLUSTER_HIDDEN` and ``w_hh``, ``h0`` and ``ys`` 16-byte aligned
    (the route's 16-byte copies), any T and N; ``"grid"`` otherwise
    (float32, float16, mixed dtypes, other widths)."""
    storage = _storage(x_proj, w_hh, h0, ys, c0)
    return "cluster" if _cluster_fits(w_hh, storage, w_hh, h0, ys) else "grid"


def _grid_scratch(route: str, n: int, hidden: int, device):
    """The grid route's barrier words and its f32 state scratch ``[2, N,
    H]`` (used where a block walks several tiles); None, None for the
    cluster route."""
    if route != "grid":
        return None, None
    return (torch.zeros(2, dtype=torch.int32, device=device),
            torch.empty(2 * n * hidden, dtype=torch.float32, device=device))


def _route_number(route: str) -> int:
    if route not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)}, got "
                         f"{route!r}")
    return ROUTES[route]


def lstm_recurrence_fwd(x_proj, w_hh, h0, c0, collect_cell: bool = False,
                        route: Optional[str] = None):
    """Launch the forward kernel on CUDA tensors, on PyTorch's current
    stream: ``(ys, hT, cT)``, plus ``cs`` when ``collect_cell``, all in
    ``x_proj``'s dtype. ``route`` (default :func:`fwd_route`'s) forces a
    route; the C entry refuses one the call does not fit. A call that
    mixes f32 and bf16, or holds any f16, runs the grid route at f32 over
    widened inputs (h rounded to ``w_hh``'s type before the product where
    ``w_hh`` is bf16 or f16) and casts its outputs. Raises on any argument the kernel does not take
    (``ValueError`` naming the envelope outside it), on a failed build and
    on a refused launch; never computes the result another way."""
    global fwd_launches, fwd_cluster_launches, last_plan
    _check_kernel_args(x_proj, w_hh, h0, c0)
    out_dtype = x_proj.dtype
    round_h = _widened(w_hh, x_proj, h0, c0)
    if round_h is not None:
        x_proj, w_hh, h0, c0 = (t.float() for t in (x_proj, w_hh, h0, c0))
    round_h = round_h or 0
    route = fwd_route(x_proj, w_hh, h0, c0) if route is None else route
    number = _route_number(route)
    steps, n, _ = x_proj.shape
    hidden = w_hh.shape[0]
    ys = torch.empty((steps, n, hidden), dtype=x_proj.dtype,
                     device=x_proj.device)
    cs = torch.empty_like(ys) if collect_cell else None
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    bar, state = _grid_scratch(route, n, hidden, x_proj.device)
    plan = (ctypes.c_int * 7)()
    lib = _lib()
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        err = lib.dl4j_lstm_fwd(
            int(x_proj.dtype == torch.bfloat16), number, round_h,
            x_proj.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            ys.data_ptr(), _ptr(cs), hT.data_ptr(), cT.data_ptr(), _ptr(bar),
            _ptr(state), steps, n, hidden, plan, stream)
    _raise_on(lib, err, f"forward ({route} route)")
    fwd_launches += 1
    fwd_cluster_launches += route == "cluster"
    last_plan = tuple(plan)
    out = (ys, hT, cT) + ((cs,) if collect_cell else ())
    return tuple(t.to(out_dtype) for t in out)


def lstm_recurrence_bwd(x_proj, w_hh, h0, c0, ys, cs, dys, dhT=None,
                        dcT=None, route: Optional[str] = None):
    """Launch the backward kernel on CUDA tensors, then take the weight
    gradient as one f32 ``[H, T*N] @ [T*N, 4H]`` matmul of ``h_{t-1}`` and
    the kernel's f32 ``da``: ``(d x_proj, d w_hh, dh0, dc0)`` in the primal
    dtypes. ``dhT`` / ``dcT`` of None are zero. ``route`` (default
    :func:`bwd_route`'s) forces a route; the C entry refuses one the call
    does not fit. Mixed dtypes and f16 run as in
    :func:`lstm_recurrence_fwd`.
    Raises like :func:`lstm_recurrence_fwd`."""
    global bwd_launches, bwd_cluster_launches, last_plan
    _check_kernel_args(x_proj, w_hh, h0, c0)
    steps, n, four_h = x_proj.shape
    hidden = w_hh.shape[0]
    for name, t in (("ys", ys), ("cs", cs), ("dys", dys)):
        if (tuple(t.shape) != (steps, n, hidden) or t.dtype not in DTYPES
                or t.device != x_proj.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 or bfloat16 "
                             f"{(steps, n, hidden)} on {x_proj.device}")
    for name, t in (("dhT", dhT), ("dcT", dcT)):
        if t is not None and (t.shape != h0.shape or t.dtype not in DTYPES
                              or not t.is_contiguous()
                              or t.device != h0.device):
            raise ValueError(f"{name} must be contiguous float32 or bfloat16 "
                             f"{tuple(h0.shape)} on {h0.device}")
    primal = [t.dtype for t in (x_proj, w_hh, h0, c0)]
    ins = [x_proj, w_hh, h0, c0, ys, cs, dys, dhT, dcT]
    round_h = _widened(w_hh, x_proj, h0, c0, ys, cs, dys, dhT, dcT)
    if round_h is not None:
        ins = [None if t is None else t.float() for t in ins]
    round_h = round_h or 0
    x_proj, w_hh, h0, c0, ys, cs, dys, dhT, dcT = ins
    route = bwd_route(x_proj, w_hh, h0, ys) if route is None else route
    number = _route_number(route)
    # da: f32 d x_proj, which is the result itself at f32
    da = torch.empty(x_proj.shape, dtype=torch.float32, device=x_proj.device)
    dxp = da if x_proj.dtype == torch.float32 else torch.empty_like(x_proj)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    bar, state = _grid_scratch(route, n, hidden, x_proj.device)
    plan = (ctypes.c_int * 7)()
    lib = _lib()
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        err = lib.dl4j_lstm_bwd(
            int(x_proj.dtype == torch.bfloat16), number, round_h,
            x_proj.data_ptr(),
            w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(), ys.data_ptr(),
            cs.data_ptr(), dys.data_ptr(), _ptr(dhT), _ptr(dcT),
            None if dxp is da else dxp.data_ptr(), da.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), _ptr(bar), _ptr(state), steps, n,
            hidden, plan, stream)
    _raise_on(lib, err, f"backward ({route} route)")
    bwd_launches += 1
    bwd_cluster_launches += route == "cluster"
    last_plan = tuple(plan)
    h_prev = torch.cat([h0[None], ys[:-1]]).to(torch.float32)
    dw = torch.matmul(h_prev.reshape(steps * n, hidden).T,
                      da.reshape(steps * n, four_h))
    return tuple(t.to(d) for t, d in zip((dxp, dw, dh0, dc0), primal))


# -------------------------------------------------------------- autograd op
class LSTMRecurrence(torch.autograd.Function):
    """A forward and a backward of one device kind: the kernels on CUDA
    tensors, the plain versions on CPU tensors. The forward keeps the
    cell stream only when ``grad`` (a gradient will be taken)."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0, grad):
        if x_proj.device.type == "cuda":
            out = lstm_recurrence_fwd(x_proj, w_hh, h0, c0, collect_cell=grad)
        else:
            out = lstm_recurrence_reference(x_proj, w_hh, h0, c0,
                                            collect_cell=grad)
        if grad:
            ys, hT, cT, cs = out
            ctx.save_for_backward(x_proj, w_hh, h0, c0, ys, cs)
        else:
            ys, hT, cT = out
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        # autograd hands zeros (not None) for outputs the loss did not use
        x_proj, w_hh, h0, c0, ys, cs = ctx.saved_tensors
        args = (x_proj, w_hh, h0, c0, ys, cs, dys.contiguous(),
                dhT.contiguous(), dcT.contiguous())
        if x_proj.device.type == "cuda":
            return lstm_recurrence_bwd(*args) + (None,)
        return lstm_recurrence_backward_reference(*args) + (None,)


def lstm_recurrence(x_proj, w_hh, h0, c0):
    """``(ys [T, N, H], hT, cT)``, differentiable in every input: the
    plain versions on CPU tensors, the CUDA kernels (forward and backward)
    on CUDA tensors."""
    dev = x_proj.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"the LSTM recurrence runs on cpu or cuda, not "
                         f"{x_proj.device}")
    ins = (x_proj, w_hh, h0, c0)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
    return LSTMRecurrence.apply(*(t.contiguous() for t in ins), grad)
