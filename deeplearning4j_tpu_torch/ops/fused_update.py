"""Fused Adam master update over a flat f32 buffer.

Counterpart of ``deeplearning4j_tpu/ops/fused_update_pallas.py``: the
loss-scale unscale, the global-norm clip and the bias-corrected Adam
update in one elementwise pass over flat f32 master, m, v and grad::

    g       = grad * gscale
    m'      = beta1 * m + (1 - beta1) * g
    v'      = beta2 * v + (1 - beta2) * g * g
    master' = master - alpha * m' / (sqrt(v') + eps)

with ``[gscale, alpha]`` from :func:`adam_update_scalars`.

Dispatch is by the device of the tensors and nothing else: CPU tensors
take :func:`adam_update_reference`, a plain copy of ``_formula``
(fused_update_pallas.py:101-107); CUDA tensors take the hand-written
Hopper kernel ``csrc/fused_update.cu`` (:func:`fused_adam_update`),
which either launches or raises.

Both paths write master, m and v **in place** and return them: the JAX
train step donates these buffers (transformer.py:372), and the port's
flat train step owns them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.ops import native

#: kernel launches since the last reset; incremented only where
#: :func:`fused_adam_update` launches the CUDA kernel
launches = 0


def adam_update_scalars(updater: Adam, step, inv_scale=None, clip_norm=None,
                        grad_norm=None) -> torch.Tensor:
    """``[gscale, alpha]`` as an f32 tensor of two (fused_update_pallas.py
    :63-97): ``gscale`` is the loss-scale unscale ``inv_scale`` times the
    clip coefficient ``min(1, clip_norm / ||grad * inv_scale||)``, each 1
    when its feature is off; ``alpha`` is Adam's bias-corrected step size
    at ``t = step + 1``. ``grad_norm`` is the norm of the still-scaled
    gradient and is required with ``clip_norm``. The scalars live where
    ``grad_norm`` lives (the CPU when it is not given)."""
    f32 = torch.float32
    dev = grad_norm.device if torch.is_tensor(grad_norm) else None
    gscale = torch.tensor(1.0, dtype=f32, device=dev)
    inv = None
    if inv_scale is not None:
        inv = torch.as_tensor(inv_scale, dtype=f32, device=dev)
        gscale = gscale * inv
    if clip_norm is not None:
        if grad_norm is None:
            raise ValueError("clip_norm requires grad_norm")
        unscaled = torch.as_tensor(grad_norm, dtype=f32, device=dev)
        if inv is not None:
            unscaled = unscaled * inv
        clip = torch.as_tensor(clip_norm, dtype=f32, device=dev)
        gscale = gscale * torch.clamp(clip / torch.clamp(unscaled, min=1e-12),
                                      max=1.0)
    alpha = updater.bias_corrected_lr(step)
    return torch.stack([gscale, alpha.to(gscale.device)])


def adam_update_reference(master, m, v, grad, gscale, alpha, beta1: float,
                          beta2: float, eps: float):
    """Plain PyTorch version, op for op ``_formula``; returns new
    ``(master', m', v')`` and leaves the inputs alone."""
    g = grad.to(torch.float32) * gscale
    m2 = beta1 * m + (1 - beta1) * g
    v2 = beta2 * v + (1 - beta2) * g * g
    upd = alpha * m2 / (torch.sqrt(v2) + eps)
    return master - upd.to(master.dtype), m2, v2


def _lib():
    lib = native.load("fused_update")
    fn = lib.dl4j_fused_adam_update
    if fn.argtypes is None:
        vp, f, d = ctypes.c_void_p, ctypes.c_float, ctypes.c_double
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, f, f, d, d, f, vp]
        fn.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_args(master, m, v, grad) -> None:
    ts = (("master", master), ("m", m), ("v", v), ("grad", grad))
    for name, t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be a flat vector, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.numel() for _, t in ts}) != 1:
        raise ValueError(f"master, m, v and grad differ in length: "
                         f"{[t.numel() for _, t in ts]}")
    devs = {t.device for _, t in ts}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")
    ptrs = {t.data_ptr() for _, t in ts[:3]}
    if len(ptrs) != 3 and master.numel():
        raise ValueError("master, m and v must be distinct buffers")


def fused_adam_update(master, m, v, grad, gscale: float, alpha: float, *,
                      beta1: float, beta2: float, eps: float):
    """Launch ``csrc/fused_update.cu`` on CUDA tensors, on PyTorch's
    current stream, updating ``master``, ``m`` and ``v`` in place. The
    scalars are plain floats, passed to the kernel by value. Raises on
    any argument the kernel does not take, on a failed build and on a
    refused launch; never computes the result another way."""
    global launches
    if master.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{master.device}")
    _check_kernel_args(master, m, v, grad)
    lib = _lib()
    with torch.cuda.device(master.device):
        stream = torch.cuda.current_stream(master.device).cuda_stream
        err = lib.dl4j_fused_adam_update(
            master.data_ptr(), m.data_ptr(), v.data_ptr(), grad.data_ptr(),
            master.numel(), float(gscale), float(alpha), float(beta1),
            float(beta2), float(eps), stream)
    if err != 0:
        msg = lib.dl4j_cuda_error_string(err).decode()
        raise RuntimeError(f"fused Adam kernel launch failed: {msg} "
                           f"(cudaError {err})")
    launches += 1
    return master, m, v


def adam_segment_update(master, m, v, grad, scalars, *, beta1: float,
                        beta2: float, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused update over a flat segment, in place: the plain version
    on CPU tensors, the CUDA kernel on CUDA tensors. ``scalars`` is
    ``[gscale, alpha]`` (:func:`adam_update_scalars`); the kernel takes
    them by value, so scalars that live on the card are read back first.
    Returns ``(master, m, v)``."""
    if master.device.type == "cpu":
        new = adam_update_reference(master, m, v, grad, scalars[0],
                                    scalars[1], beta1, beta2, eps)
        with torch.no_grad():
            for buf, val in zip((master, m, v), new):
                buf.copy_(val)
        return master, m, v
    if master.device.type == "cuda":
        gscale, alpha = (float(x) for x in scalars.tolist())
        return fused_adam_update(master, m, v, grad, gscale, alpha,
                                 beta1=beta1, beta2=beta2, eps=eps)
    raise ValueError(f"the fused update runs on cpu or cuda, not "
                     f"{master.device}")


def require_adam(updater) -> None:
    """Raise ``TypeError`` unless ``updater`` is exactly :class:`Adam`,
    the only formula the fused update implements."""
    if type(updater) is not Adam:
        raise TypeError(
            f"the fused update implements the Adam formula; got "
            f"{type(updater).__name__}")


def fused_master_update(master, m, v, grad, step, updater: Adam,
                        inv_scale=None, clip_norm=None, grad_norm=None):
    """Scalars and segment update in one call (fused_update_pallas.py
    :186-204), in place. Raises ``TypeError`` on any updater but
    :class:`Adam`."""
    require_adam(updater)
    if clip_norm is not None and grad_norm is None:
        grad_norm = torch.sqrt(torch.sum(grad.to(torch.float32) ** 2))
    sc = adam_update_scalars(updater, step, inv_scale=inv_scale,
                             clip_norm=clip_norm, grad_norm=grad_norm)
    return adam_segment_update(master, m, v, grad, sc, beta1=updater.beta1,
                               beta2=updater.beta2, eps=updater.epsilon)
