"""Neural-net ops the layer framework calls: counterpart of the part of
``deeplearning4j_tpu/ops/nn.py`` that the ported layers reach.

Only :func:`lstm_layer` (``:592-651``), :func:`dropout` (``:558-564``)
and :func:`batch_norm` (``:383-387``, registered under its JAX name) are
ported. Layouts stay the JAX package's: ``x`` ``[N, T, in]``,
``w_ih`` ``[in, 4H]``, ``w_hh`` ``[H, 4H]``, ``b`` ``[4H]``, gates i, f, g,
o, so a parameter tree from the JAX side loads unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.lstm_recurrence import lstm_recurrence
from deeplearning4j_tpu_torch.ops.registry import register_op


@register_op("batch_norm")
def batch_norm(x, gamma, beta, mean, var, eps=1e-5):
    """Inference-mode batch norm over the trailing channel axis, in the
    JAX op's order: ``(x - mean) * rsqrt(var + eps) * gamma + beta``."""
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * gamma + beta


def dropout(x, rate: float, generator: Optional[torch.Generator] = None):
    """Inverted dropout: each entry is kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``. The draws come from ``generator``
    (the same distribution as ``jax.random.bernoulli``, not the same
    bits)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def lstm_layer(x, w_ih, w_hh, b, h0=None, c0=None, reverse: bool = False):
    """LSTM over time: ``(outputs [N, T, H], (hT, cT))``.

    One input projection for all timesteps, ``x @ w_ih + b`` as a single
    ``[T*N, in] @ [in, 4H]`` product (a library matmul: the JAX layer
    leaves it to XLA outside any Pallas kernel), taken in time-major row
    order so the recurrence reads it without a transpose; then
    :func:`~deeplearning4j_tpu_torch.ops.lstm_recurrence.lstm_recurrence`
    (the hand kernels on the card, the plain versions on the CPU).
    ``reverse`` runs the recurrence from the last timestep to the first
    and returns the outputs in input order."""
    n, t, _ = x.shape
    hidden = w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((n, hidden), dtype=x.dtype, device=x.device)
    xt = x.transpose(0, 1).reshape(t * n, -1)
    x_proj = (xt @ w_ih + b).reshape(t, n, 4 * hidden)      # [T, N, 4H]
    if reverse:
        x_proj = torch.flip(x_proj, dims=(0,))
    ys, hT, cT = lstm_recurrence(x_proj, w_hh, h0, c0)
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys.transpose(0, 1), (hT, cT)
