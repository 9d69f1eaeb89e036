"""Residual-block tail: counterpart of
``deeplearning4j_tpu/ops/residual_tail_pallas.py`` (B3), registered as
``bn_relu_residual``.

``relu((x - mean) * rsqrt(var + eps) * gamma + beta + res)`` in one pass
over ``[..., C]``: x and res in f32 or bf16, the per-channel vectors in
f32, the output in x's dtype.

Dispatch is by the device of the tensors and nothing else: CPU tensors
take :func:`residual_tail_reference` (``_ref_formula``,
residual_tail_pallas.py:77-81); CUDA tensors take the hand-written Hopper
kernel ``csrc/residual_tail.cu``, which launches or raises. Both run
inside an autograd ``Function`` whose backward recomputes through the
plain formula with torch autograd, as the reference's ``_bwd`` does
(:104-109), so gradients reach all six inputs, the batch statistics
included.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.ops.registry import register_op

#: kernel launches since the last reset; incremented only where
#: :func:`residual_tail_kernel` launches the CUDA kernel
launches = 0

#: channels the kernel stages in shared memory (16 bytes each, within the
#: 227 KB a block may use)
MAX_CHANNELS = 12288


def residual_tail_reference(x, res, mean, var, gamma, beta, eps=1e-5):
    """Plain version, op for op ``_ref_formula``."""
    inv = torch.rsqrt(var.float() + eps)
    z = (x.float() - mean) * inv * gamma + beta + res.float()
    return torch.clamp(z, min=0.0).to(x.dtype)


def _lib():
    lib = native.load("residual_tail")
    fn = lib.dl4j_residual_tail
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def residual_tail_kernel(x, res, mean, var, gamma, beta, eps=1e-5):
    """Launch ``csrc/residual_tail.cu`` on CUDA tensors, on PyTorch's
    current stream. The per-channel vectors are taken as f32 (as
    ``_tail_kernel`` casts them). Raises on any argument the kernel does
    not take, on a failed build and on a refused launch; never computes
    the result another way."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or res.dtype != x.dtype:
        raise TypeError(f"x and res must both be float32 or bfloat16, got "
                        f"{x.dtype} and {res.dtype}")
    if res.shape != x.shape or x.dim() == 0:
        raise ValueError(f"x {tuple(x.shape)} and res {tuple(res.shape)} "
                         f"must share one shape [..., C]")
    c = int(x.shape[-1])
    vecs = [t.to(torch.float32).contiguous() for t in (mean, var, gamma,
                                                          beta)]
    for name, t in zip(("mean", "var", "gamma", "beta"), vecs):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be [{c}], got {tuple(t.shape)}")
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"C must be in 1..{MAX_CHANNELS}, got {c}")
    if any(t.device != x.device for t in (res, *vecs)):
        raise ValueError("all tensors must be on one device")
    x = x.contiguous()
    res = res.contiguous()
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dl4j_residual_tail(
            x.data_ptr(), res.data_ptr(), *(t.data_ptr() for t in vecs),
            out.data_ptr(), x.numel(), c, float(eps),
            int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.dl4j_cuda_error_string(err).decode()
        raise RuntimeError(f"residual tail kernel launch failed: {msg} "
                           f"(cudaError {err})")
    launches += 1
    return out


class _BnReluResidual(torch.autograd.Function):
    """Forward: the plain version on the CPU, the kernel on the card.
    Backward: torch autograd of the plain formula, recomputed."""

    @staticmethod
    def forward(ctx, x, res, mean, var, gamma, beta, eps):
        ctx.save_for_backward(x, res, mean, var, gamma, beta)
        ctx.eps = eps
        if x.device.type == "cpu":
            return residual_tail_reference(x, res, mean, var, gamma, beta,
                                           eps)
        if x.device.type == "cuda":
            return residual_tail_kernel(x, res, mean, var, gamma, beta, eps)
        raise ValueError(f"bn_relu_residual runs on cpu or cuda, not "
                         f"{x.device}")

    @staticmethod
    def backward(ctx, g):
        saved = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = residual_tail_reference(*saved, ctx.eps)
        grads = torch.autograd.grad(out, saved, g, allow_unused=True)
        return (*grads, None)


def bn_relu_residual(x, res, mean, var, gamma, beta, eps=1e-5):
    """``relu(batchnorm_apply(x; mean, var, gamma, beta) + res)`` in one
    pass. x, res: ``[..., C]``; the statistics and parameters: ``[C]``."""
    return _BnReluResidual.apply(x, res, mean, var, gamma, beta, eps)


@register_op("bn_relu_residual")
def _op(x, res, mean, var, gamma, beta, eps=1e-5):
    return bn_relu_residual(x, res, mean, var, gamma, beta, eps)
