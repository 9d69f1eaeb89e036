"""Flash attention for the transformer encoder.

Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``; q, k and v
are ``[N, H, T, dh]``, the optional mask is a key-padding mask ``[N, Tk]``
(or ``[N, 1, 1, Tk]``; > 0 attends), ``causal`` admits key j for query i
iff ``i >= j``.

- :func:`blockwise_attention`: the plain version, op for op the JAX
  module's online-softmax scan over key blocks (``:45-101``).
- :func:`xla_attention`: a plain copy of ``_xla_attention`` (``:262-277``),
  for the tests.
- :func:`flash_attention_fwd` and :func:`flash_attention_bwd`: the
  hand-written Hopper kernels of ``csrc/flash_attention.cu``, joined into
  one differentiable op by :class:`FlashAttention`.
- :func:`attention`: the dispatcher. CPU tensors take
  :func:`blockwise_attention`, which is what the JAX dispatcher picks off
  the TPU (``:306-307``); CUDA tensors take :class:`FlashAttention`, which
  launches the kernels or raises. No mode switch, no fallback.

Masked scores are ``-1e30``, never ``-inf``, everywhere. A row whose
every key is masked therefore spreads its weight evenly. The kernel, like
the Pallas kernel, spreads it over the ``Tk`` real keys and returns the
mean of v; :func:`blockwise_attention` pads the keys to a multiple of
``block_k`` and its padded keys take part too, so on such a row it
returns ``sum(v) / padded_length`` unless ``block_k`` divides ``Tk``.
Rows with at least one attended key agree either way.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import native

_NEG_INF = -1e30  # large but finite: a fully masked row stays NaN-free

#: launches of the forward / backward kernels since the last reset;
#: incremented only where :func:`flash_attention_fwd` /
#: :func:`flash_attention_bwd` launch them (one per call; the backward
#: call runs three ``__global__`` functions)
fwd_launches = 0
bwd_launches = 0

_HEAD_DIMS = (32, 64, 96, 128)


def _key_mask(mask):
    if mask is not None and mask.dim() == 4:
        mask = mask[:, 0, 0, :]
    return mask


# ------------------------------------------------------------ plain versions
def blockwise_attention(q, k, v, mask=None, causal: bool = False,
                        block_k: int = 256, scale: Optional[float] = None):
    """Online-softmax attention scanning K/V in blocks of ``block_k``,
    op for op ``blockwise_attention`` of the JAX module: q is scaled in
    its own dtype before the f32 cast, the keys are zero-padded to a
    multiple of ``block_k`` with their padding masked, and the output is
    ``acc / max(l, 1e-30)`` in q's dtype."""
    n, h, tq, dh = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    orig_dtype = q.dtype
    f32 = torch.float32
    qf = (q * scale).to(f32)
    kf = k.to(f32)
    vf = v.to(f32)
    pad = (-tk) % block_k
    if pad:
        kf = F.pad(kf, (0, 0, 0, pad))
        vf = F.pad(vf, (0, 0, 0, pad))
    nblk = (tk + pad) // block_k
    mask = _key_mask(mask)
    key_valid = (torch.ones((n, tk), dtype=f32, device=q.device)
                 if mask is None else mask.to(f32))
    if pad:
        key_valid = F.pad(key_valid, (0, pad))
    q_pos = torch.arange(tq, device=q.device)[:, None]

    m = torch.full((n, h, tq, 1), _NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((n, h, tq, 1), dtype=f32, device=q.device)
    acc = torch.zeros((n, h, tq, dh), dtype=f32, device=q.device)
    for bi in range(nblk):
        sl = slice(bi * block_k, (bi + 1) * block_k)
        kb, vb, valid = kf[:, :, sl], vf[:, :, sl], key_valid[:, sl]
        s = torch.einsum("nhqd,nhkd->nhqk", qf, kb)
        s = torch.where(valid[:, None, None, :] > 0, s, _NEG_INF)
        if causal:
            k_pos = bi * block_k + torch.arange(block_k,
                                                device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("nhqk,nhkd->nhqd", p, vb)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(orig_dtype)


def xla_attention(q, k, v, mask=None, causal: bool = False):
    """Plain softmax attention, op for op ``_xla_attention``: the scale
    ``1/sqrt(dh)`` is rounded to q's dtype and applied to the logits,
    masked logits are ``-1e30`` in the logits' dtype, and the causal mask
    is ``tril`` with offset ``Tk - Tq``."""
    dh = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=q.dtype, device=q.device))
    logits = torch.einsum("nhqd,nhkd->nhqk", q, k) * scale
    neg = torch.tensor(_NEG_INF, dtype=logits.dtype, device=q.device)
    if mask is not None:
        m4 = mask if mask.dim() == 4 else mask[:, None, None, :]
        logits = torch.where(m4.bool(), logits, neg)
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        cm = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                   device=q.device), diagonal=tk - tq)
        logits = torch.where(cm[None, None], logits, neg)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("nhqk,nhkd->nhqd", w, v)


# ------------------------------------------------------------------ kernels
def _lib():
    lib = native.load("flash_attention")
    if lib.dl4j_flash_attention_fwd.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dl4j_flash_attention_fwd.argtypes = [
            i, vp, vp, vp, vp, vp, vp, i, i, i, i, i, f, i, vp]
        lib.dl4j_flash_attention_fwd.restype = ctypes.c_int
        lib.dl4j_flash_attention_bwd.argtypes = [
            i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, f,
            i, vp]
        lib.dl4j_flash_attention_bwd.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_layout(name: str, t, aligned: bool = True) -> None:
    """Contiguous, and 16-byte aligned where the kernels move 16 bytes at
    a time (every tensor of rows; the mask is read element by element)."""
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_kernel_args(q, k, v, mask) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash-attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k and v ({k.dtype}, {v.dtype}) must match q's "
                        f"dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [N,H,Tq,hd] and k, v [N,H,Tk,hd], got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    n, h, _, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (n, h, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in N, H or hd")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim must be a multiple of 32 up to 128, "
                         f"got {hd}")
    tensors = [("q", q), ("k", k), ("v", v)]
    if mask is not None:
        if mask.dtype != torch.float32 or tuple(mask.shape) != (n, k.shape[2]):
            raise ValueError(f"the kernel's key mask is float32 [N, Tk] = "
                             f"{(n, k.shape[2])}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        tensors.append(("mask", mask))
    devs = {t.device for _, t in tensors}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")
    for name, t in tensors:
        _check_layout(name, t, aligned=name != "mask")
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.dl4j_cuda_error_string(err).decode()
        raise RuntimeError(f"flash-attention {what} kernel launch failed: "
                           f"{msg} (cudaError {err})")


def _mask_ptr(mask) -> Optional[int]:
    return None if mask is None else mask.data_ptr()


def flash_attention_fwd(q, k, v, mask=None, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors, on PyTorch's current
    stream. ``mask`` is f32 ``[N, Tk]`` or None. Returns ``out`` (q's
    shape and dtype) and the row statistics f32 ``[2, N*H, Tq]`` (row
    max, row sum) for :func:`flash_attention_bwd`. Raises on any argument
    the kernel does not take, on a failed build and on a refused launch;
    never computes the result another way."""
    global fwd_launches
    _check_kernel_args(q, k, v, mask)
    n, h, tq, hd = q.shape
    out = torch.empty_like(q)
    stats = torch.empty((2, n * h, tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_flash_attention_fwd(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _mask_ptr(mask), out.data_ptr(), stats.data_ptr(),
            n, h, tq, k.shape[2], hd, 1.0 / math.sqrt(hd), int(causal), stream)
    _raise_on(lib, err, "forward")
    fwd_launches += 1
    return out, stats


def flash_attention_bwd(q, k, v, out, dout, stats, mask=None,
                        causal: bool = False):
    """Launch the backward kernels on CUDA tensors: ``(dq, dk, dv)`` of
    the forward's ``out`` under the upstream gradient ``dout``, from the
    forward's row ``stats``. Raises like :func:`flash_attention_fwd`."""
    global bwd_launches
    _check_kernel_args(q, k, v, mask)
    n, h, tq, hd = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q ({q.dtype} "
                             f"{tuple(q.shape)}), got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        _check_layout(name, t)
    if (stats.dtype != torch.float32 or tuple(stats.shape) != (2, n * h, tq)
            or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be contiguous float32 "
                         f"{(2, n * h, tq)} on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    drow = torch.empty((n * h, tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_flash_attention_bwd(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _mask_ptr(mask), out.data_ptr(), dout.data_ptr(),
            stats.data_ptr(), drow.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), n, h, tq, k.shape[2], hd, 1.0 / math.sqrt(hd),
            int(causal), stream)
    _raise_on(lib, err, "backward")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel, and the backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, stats = flash_attention_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, out, stats, mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats, mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         stats, mask, ctx.causal)
        return dq, dk, dv, None, None


def attention(q, k, v, mask=None, causal: bool = False):
    """Flash attention: :func:`blockwise_attention` on CPU tensors, the
    CUDA kernels (forward and backward) on CUDA tensors."""
    if q.device.type == "cpu":
        return blockwise_attention(q, k, v, mask, causal=causal)
    if q.device.type == "cuda":
        mask = _key_mask(mask)
        if mask is not None:
            mask = mask.to(torch.float32).contiguous()
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), mask, bool(causal))
    raise ValueError(f"attention runs on cpu or cuda, not {q.device}")
