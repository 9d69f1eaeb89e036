"""Convolution + batch-norm statistics: counterpart of
``deeplearning4j_tpu/ops/conv_pallas.py`` (B4a ``conv1x1_bn_stats``,
B4b ``conv3x3_bn_stats``), registered under the same names.

Each op returns ``(y, mean, var)``: the raw stride-1 convolution output
in x's dtype, and per output channel the f32 mean and the single-pass
biased variance ``max(E[acc^2] - E[acc]^2, 0)`` of the f32 accumulator,
taken before the cast to y's dtype (conv_pallas.py:66-68, :107-112). The
single-pass form is the kernels' own: it is not ``torch.var_mean``.

Dispatch is by the device of the tensors and nothing else: CPU tensors
take the plain versions (:func:`conv1x1_bn_stats_reference`,
:func:`conv3x3_bn_stats_reference`); CUDA tensors take the hand-written
Hopper kernel ``csrc/conv_bn_stats.cu``, which launches or raises. Layouts
are the JAX package's: x NHWC (or ``[rows, Cin]`` for 1x1), w ``[Cin,
Cout]`` or HWIO ``[3, 3, Cin, Cout]``. Inside the kernel source,
:func:`kernel_route` picks one of three routes by dtype, shape and
alignment (never by retrying after a failure): ``"tc"``, the tensor-core
implicit GEMM, for bf16 with Cin and Cout multiples of 8 (Cin of 64 for the
3x3) on 16-byte aligned tensors; ``"wmma"``, the first bf16 design, for
the other bf16 shapes; ``"f32"`` for float32. x and w of different
dtypes, and f16, are computed as the reference computes them, an f32
product cast to x's dtype, on the ``"f32"`` route.

The reference is forward-only: interpret-mode ``pallas_call`` has no
transpose, so a gradient through these ops raises there. Here a call
whose x or w requires grad runs inside an autograd ``Function`` whose
backward raises too, so a gradient that would cross them fails loudly and
never comes back as a silent zero or ``None``; other calls skip the
``Function`` (its host cost) and give the same tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.ops.registry import register_op

#: kernel launches since the last reset; incremented only where the CUDA
#: kernel is launched (one per call: the conv pass and its stats reduction)
launches_1x1 = 0
launches_3x3 = 0

#: the reference's per-image VMEM budget for the 3x3 op (conv_pallas.py
#: :154-162), kept as the op's contract on every device
ENVELOPE_BYTES = 24 * 1024 * 1024

#: the kernel's routes, by the number its C entry point takes
ROUTES = {"f32": 0, "wmma": 1, "tc": 2}


def _stats(acc: torch.Tensor, rows: int):
    """Mean and clamped single-pass variance of f32 ``acc`` [rows, C]."""
    mean = acc.sum(0) / rows
    var = torch.clamp((acc * acc).sum(0) / rows - mean * mean, min=0.0)
    return mean, var


def conv1x1_bn_stats_reference(x, w):
    """Plain version of B4a: the f32 product by ``torch.matmul``."""
    shp = tuple(x.shape)
    rows = 1
    for d in shp[:-1]:
        rows *= d
    acc = torch.matmul(x.reshape(rows, shp[-1]).float(), w.float())
    mean, var = _stats(acc, rows)
    return acc.to(x.dtype).reshape(shp[:-1] + (w.shape[1],)), mean, var


def conv3x3_bn_stats_reference(x, w):
    """Plain version of B4b: ``F.conv2d`` at f32 over NCHW / OIHW permutes
    of the NHWC / HWIO tensors, stride 1, SAME (padding 1)."""
    n, h, wd, _ = x.shape
    cout = w.shape[3]
    acc = F.conv2d(x.permute(0, 3, 1, 2).float(),
                   w.permute(3, 2, 0, 1).float(), padding=1)
    acc = acc.permute(0, 2, 3, 1).reshape(n * h * wd, cout)
    mean, var = _stats(acc, n * h * wd)
    return acc.to(x.dtype).reshape(n, h, wd, cout), mean, var


def check_envelope(x, w) -> None:
    """The reference's guard (conv_pallas.py:154-162): the same
    ``ValueError`` for the same shapes. The kernel here has no VMEM limit;
    the guard is part of the op's contract."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    xb, wb = x.element_size(), w.element_size()
    block_bytes = ((h + 2) * (wd + 2) * cin * xb + 9 * cin * cout * wb
                   + h * wd * cout * (xb + 4))
    if block_bytes > ENVELOPE_BYTES:
        raise ValueError(
            f"conv3x3_bn_stats: per-image block needs ~{block_bytes >> 20}MB "
            f"VMEM for shape {tuple(x.shape)}->{cout}ch; the kernel's "
            "envelope is the ResNet-50 3x3 shapes (<=58x58x64 ... 9x9x512). "
            "Use the XLA conv path (ops.nn.conv2d + batch-norm) for this "
            "shape.")


def _lib():
    lib = native.load("conv_bn_stats")
    fn = lib.dl4j_conv_bn_stats
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong, i, i, i,
                       i, i, i, vp]
        fn.restype = ctypes.c_int
        lib.dl4j_conv_bn_stats_scratch.argtypes = [ctypes.c_longlong, i, i,
                                                   i, i, i, i]
        lib.dl4j_conv_bn_stats_scratch.restype = ctypes.c_longlong
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _geometry(x, w, taps: int):
    """(rows, h, wd, cin, cout) of a call, after checking that x and w
    fit the op."""
    if taps == 1:
        if w.dim() != 2 or x.shape[-1] != w.shape[0]:
            raise ValueError(f"1x1: x {tuple(x.shape)} and w "
                             f"{tuple(w.shape)} do not match")
        h = wd = 1
    elif taps == 9:
        if (x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3)
                or x.shape[3] != w.shape[2]):
            raise ValueError(f"3x3: x {tuple(x.shape)} and w "
                             f"{tuple(w.shape)} are not NHWC and HWIO")
        h, wd = int(x.shape[1]), int(x.shape[2])
    else:
        raise ValueError(f"taps must be 1 or 9, got {taps}")
    cin, cout = int(x.shape[-1]), int(w.shape[-1])
    rows = x.numel() // cin if cin else 0
    if rows == 0 or cout == 0:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    return rows, h, wd, cin, cout


def kernel_route(x, w, taps: int) -> str:
    """The kernel route a call takes, from dtypes, shapes and alignment
    alone (any device): ``"tc"`` for bf16 x and w whose Cin and Cout are
    multiples of 8 (Cin a multiple of 64 for the 3x3, so that a 64-deep K
    stage never crosses a tap), both 16-byte aligned, with fewer than 2^31
    rows; ``"wmma"`` for the other bf16 calls; ``"f32"`` otherwise
    (float32, float16, or mixed dtypes, computed at f32)."""
    rows, _, _, cin, cout = _geometry(x, w, taps)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return "f32"
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if (cin % 8 == 0 and cout % 8 == 0 and aligned and rows < 2 ** 31
            and (taps == 1 or cin % 64 == 0)):
        return "tc"
    return "wmma"


def scratch_floats(rows: int, h: int, wd: int, cin: int, cout: int,
                   taps: int, route: str) -> int:
    """Floats of partial statistics the kernel needs for this shape and
    route on the current CUDA device, as the kernel source works it out
    (``dl4j_conv_bn_stats_scratch``)."""
    lib = _lib()
    n = lib.dl4j_conv_bn_stats_scratch(rows, h, wd, cin, cout, taps,
                                       ROUTES[route])
    if n < 0:
        msg = lib.dl4j_cuda_error_string(int(-n)).decode()
        raise RuntimeError(f"conv + BN-stats scratch size refused: {msg}")
    return int(n)


def conv_bn_stats_kernel(x, w, taps: int, route: str | None = None):
    """Launch ``csrc/conv_bn_stats.cu`` on CUDA tensors, on PyTorch's
    current stream: ``taps`` 1 (x ``[..., Cin]``, w ``[Cin, Cout]``) or 9
    (x ``[N, H, W, Cin]``, w ``[3, 3, Cin, Cout]``). Returns ``(y, mean,
    var)``. ``route`` defaults to :func:`kernel_route`; a route the call
    does not fit is refused by the kernel source. x and w of different
    dtypes (float32, bfloat16 or float16), and f16 x and w, are multiplied
    at f32 and y is cast to x's dtype, as the reference's
    ``preferred_element_type=f32`` product and ``astype(x.dtype)`` do. Raises on any argument the kernel does not
    take, on a failed build and on a refused launch; never computes the
    result another way."""
    global launches_1x1, launches_3x3
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"the CUDA kernel needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    kinds = (torch.float32, torch.bfloat16, torch.float16)
    if x.dtype not in kinds or w.dtype not in kinds:
        raise TypeError(f"x and w must be float32, bfloat16 or float16, got "
                        f"{x.dtype} and {w.dtype}")
    rows, h, wd, cin, cout = _geometry(x, w, taps)
    out_dtype = x.dtype
    if w.dtype != x.dtype or x.dtype == torch.float16:
        x, w = x.float(), w.float()
    x = x.contiguous()
    w = w.contiguous()
    if route is None:
        route = kernel_route(x, w, taps)
    if (route == "f32") != (x.dtype == torch.float32):
        raise ValueError(f"route {route!r} does not take {x.dtype}")
    y = torch.empty(tuple(x.shape[:-1]) + (cout,), dtype=x.dtype,
                    device=x.device)
    mean = torch.empty(cout, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    lib = _lib()
    with torch.cuda.device(x.device):
        partial = torch.empty(
            scratch_floats(rows, h, wd, cin, cout, taps, route),
            dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dl4j_conv_bn_stats(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), partial.data_ptr(),
            mean.data_ptr(), var.data_ptr(), rows, h, wd, cin, cout, taps,
            ROUTES[route], stream)
    if err != 0:
        msg = lib.dl4j_cuda_error_string(err).decode()
        raise RuntimeError(f"conv + BN-stats kernel launch failed ({route} "
                           f"route): {msg} (cudaError {err})")
    if taps == 1:
        launches_1x1 += 1
    else:
        launches_3x3 += 1
    return y.to(out_dtype), mean, var


def _op_name(taps: int) -> str:
    return "conv1x1_bn_stats" if taps == 1 else "conv3x3_bn_stats"


def _forward(x, w, taps: int):
    """The plain version on the CPU, the kernel on the card."""
    if x.device.type == "cpu":
        ref = (conv1x1_bn_stats_reference if taps == 1
               else conv3x3_bn_stats_reference)
        return ref(x, w)
    if x.device.type == "cuda":
        return conv_bn_stats_kernel(x, w, taps)
    raise ValueError(f"{_op_name(taps)} runs on cpu or cuda, not {x.device}")


class _ConvBnStats(torch.autograd.Function):
    """Forward: :func:`_forward`. Backward: raises, as the reference does
    (forward-only)."""

    @staticmethod
    def forward(ctx, x, w, taps):
        ctx.op = _op_name(taps)
        return _forward(x, w, taps)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.op} is forward-only, as in the reference (its Pallas "
            f"kernel has no transpose): no gradient flows through it")


def conv1x1_bn_stats(x, w, bm: int = 512, bn: int = 256):
    """x ``[N, H, W, Cin]`` (or ``[rows, Cin]``), w ``[Cin, Cout]`` ->
    ``(y, mean [Cout], var [Cout])``. ``bm`` and ``bn`` are the
    reference's block caps; they are accepted and change nothing (the
    kernel masks ragged tiles instead of choosing divisors)."""
    return _apply(x, w, 1)


def conv3x3_bn_stats(x, w):
    """3x3 stride-1 SAME conv + fused BN stats: x ``[N, H, W, Cin]``, w
    ``[3, 3, Cin, Cout]`` -> ``(y [N, H, W, Cout], mean, var)``. Shapes
    outside the reference's envelope raise ``ValueError``."""
    check_envelope(x, w)
    return _apply(x, w, 9)


def _apply(x, w, taps: int):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ConvBnStats.apply(x, w, taps)
    return _forward(x, w, taps)


@register_op("conv1x1_bn_stats")
def conv1x1_bn_stats_op(x, w, bm=512, bn=256):
    return conv1x1_bn_stats(x, w, bm=bm, bn=bn)


@register_op("conv3x3_bn_stats")
def conv3x3_bn_stats_op(x, w):
    return conv3x3_bn_stats(x, w)
