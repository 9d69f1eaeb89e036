"""Linear-algebra ops: counterpart of ``deeplearning4j_tpu/ops/linalg.py``
(:19-198), every name it registers, with its parameters.

JAX's conventions where torch's differ: a decomposition that fails
(Cholesky of a matrix that is not positive definite, the inverse of a
singular one) gives NaNs or infinities instead of raising, read from the
``_ex`` variants' info by a select (no host read); ``eigh`` and
``eigvalsh`` symmetrize their input first; ``pinv``'s cutoff is JAX's
``10 * max(m, n) * eps``; integer results are int32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


def _nan_where(info: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` with NaN in every batch entry whose ``info`` is non-zero."""
    bad = (info != 0).reshape(info.shape + (1,) * (t.dim() - info.dim()))
    return torch.where(bad, torch.full_like(t, math.nan), t)


@register_op("batched_gemm")
def batched_gemm(a, b, alpha=1.0, beta=0.0, c=None):
    out = alpha * (a @ b)
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


@register_op("tensormmul")
def tensormmul(a, b, axes_a, axes_b):
    """Tensor contraction over ``axes_a`` of ``a`` and ``axes_b`` of
    ``b``."""
    return torch.tensordot(a, b, dims=(list(axes_a), list(axes_b)))


@register_op("outer")
def outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


@register_op("cholesky")
def cholesky(x):
    """Lower Cholesky factor; NaN for a matrix that is not positive
    definite."""
    lo, info = torch.linalg.cholesky_ex(x)
    return _nan_where(info, lo)


@register_op("qr")
def qr(x, full_matrices=False):
    return tuple(torch.linalg.qr(x, mode="complete" if full_matrices
                                 else "reduced"))


@register_op("svd")
def svd(x, full_matrices=False, compute_uv=True):
    if not compute_uv:
        return torch.linalg.svdvals(x)
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def _sym(x):
    return (x + x.transpose(-1, -2).conj()) / 2


@register_op("eigh")
def eigh(x):
    """Symmetric eigendecomposition: (eigenvalues ascending,
    eigenvectors)."""
    return tuple(torch.linalg.eigh(_sym(x)))


@register_op("solve")
def solve(a, b):
    return torch.linalg.solve(a, b)


@register_op("triangular_solve")
def triangular_solve(a, b, lower=True, adjoint=False):
    """``solve_triangular(a, b, lower, trans="T" if adjoint)``; a 1-D
    ``b`` is one right-hand side."""
    vec = b.dim() == 1
    bb = b.unsqueeze(-1) if vec else b
    aa = a.transpose(-1, -2) if adjoint else a
    upper = lower if adjoint else not lower
    out = torch.linalg.solve_triangular(aa, bb, upper=upper)
    return out.squeeze(-1) if vec else out


@register_op("lstsq")
def lstsq(a, b, rcond=None):
    """The least-squares solution; a 1-D ``b`` is one right-hand side."""
    vec = b.dim() == 1
    bb = b.unsqueeze(-1) if vec else b
    out = torch.linalg.lstsq(a, bb, rcond=rcond).solution
    return out.squeeze(-1) if vec else out


@register_op("lu")
def lu(x):
    """``(p, l, u)`` with ``x = p @ l @ u``."""
    return tuple(torch.linalg.lu(x))


@register_op("matrix_inverse")
def matrix_inverse(x):
    """The inverse; a singular matrix gives infinities and NaNs, not a
    raise."""
    inv, info = torch.linalg.inv_ex(x)
    return torch.where((info != 0).reshape(info.shape + (1, 1)),
                       torch.full_like(inv, math.inf), inv)


@register_op("pinv")
def pinv(x):
    rtol = 10.0 * max(x.shape[-2], x.shape[-1]) * torch.finfo(x.dtype).eps
    return torch.linalg.pinv(x, rtol=rtol)


@register_op("matrix_determinant")
def matrix_determinant(x):
    return torch.linalg.det(x)


@register_op("log_matrix_determinant")
def log_matrix_determinant(x):
    sign, logdet = torch.linalg.slogdet(x)
    return sign, logdet


@register_op("matrix_band_part")
def matrix_band_part(x, num_lower, num_upper):
    """Keep the band ``-num_lower <= j - i <= num_upper`` of the last two
    axes (a negative bound keeps that whole triangle)."""
    m, n = x.shape[-2], x.shape[-1]
    i = torch.arange(m, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=x.device)
    if num_lower >= 0:
        keep = keep & (i - j <= num_lower)
    if num_upper >= 0:
        keep = keep & (j - i <= num_upper)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


@register_op("tri")
def tri(n, m=None, k=0, dtype=np.float32):
    """Ones at and below the ``k``-th diagonal of an ``n x m`` matrix."""
    m = n if m is None else m
    return torch.ones((n, m), dtype=jr.torch_dtype(dtype),
                      device=jr.op_device()).tril(k)


@register_op("triu")
def triu(x, k=0):
    return torch.triu(x, k)


@register_op("tril")
def tril(x, k=0):
    return torch.tril(x, k)


@register_op("cross")
def cross(a, b, axis=-1):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=axis)


@register_op("kron")
def kron(a, b):
    return torch.kron(a, b)


@register_op("norm_fro")
def norm_fro(x):
    """The 2-norm of all the elements."""
    return torch.linalg.vector_norm(x)


@register_op("l2_normalize")
def l2_normalize(x, axis=-1, eps=1e-12):
    return x * torch.rsqrt(torch.clamp_min(
        torch.sum(x * x, dim=axis, keepdim=True), eps))


@register_op("slogdet")
def slogdet(x):
    """(sign, log |det|)."""
    sign, logabs = torch.linalg.slogdet(x)
    return sign, logabs


@register_op("matrix_power")
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


@register_op("matrix_rank")
def matrix_rank(x, tol=None):
    """Singular values above ``max(m, n) * eps * s_max``, or above the
    ABSOLUTE ``tol`` (numpy's meaning); int32."""
    s = torch.linalg.svdvals(x)
    if tol is None:
        tol = s.amax(-1, keepdim=True) * max(x.shape[-2], x.shape[-1]) \
            * torch.finfo(x.dtype).eps
    return torch.sum(s > tol, dim=-1).to(torch.int32)


@register_op("eigvalsh")
def eigvalsh(x):
    return torch.linalg.eigvalsh(_sym(x))


@register_op("expm")
def expm(x):
    """The matrix exponential."""
    return torch.linalg.matrix_exp(x)


@register_op("cond_number")
def cond_number(x, p=None):
    return torch.linalg.cond(x, p=p)


@register_op("multi_dot")
def multi_dot(mats):
    return torch.linalg.multi_dot(list(mats))


@register_op("adjoint")
def adjoint(x):
    return x.transpose(-1, -2).conj()
