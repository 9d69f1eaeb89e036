"""The declarable-op tail: counterpart of
``deeplearning4j_tpu/ops/declarable_tail.py``, the six names of it that
the TensorFlow importer reaches (``l2_loss`` :33,
``sparse_softmax_cross_entropy`` :53, ``invert_permutation`` :364,
``space_to_batch_nd`` :448, ``batch_to_space_nd`` :471, ``zeta`` :625),
with their parameters. The file's other 77 names are still to be ported
(ROADMAP A10.1b).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


@register_op("l2_loss")
def l2_loss(x):
    """``sum(x ** 2) / 2`` (TF's ``tf.nn.l2_loss``)."""
    return torch.sum(torch.square(x)) / 2


@register_op("sparse_softmax_cross_entropy")
def sparse_softmax_cross_entropy(logits, labels):
    """Integer-label softmax cross-entropy per example; a label out of
    range gives NaN, as ``jnp.take_along_axis`` fills."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = jr.take_along_fill(
        logp, labels.unsqueeze(-1).to(torch.int32), -1)[..., 0]
    return -picked


@register_op("invert_permutation")
def invert_permutation(p):
    """The inverse permutation (``jnp.argsort``, stable), int32."""
    return torch.argsort(p, stable=True).to(torch.int32)


@register_op("space_to_batch_nd")
def space_to_batch_nd(x, block_shape, paddings):
    """TF's N-D SpaceToBatch: pad the ``m`` spatial axes after the batch,
    then move each block's offsets to the batch, offset-major."""
    block = [int(b) for b in block_shape]
    m = len(block)
    pads = [(0, 0)] + [(int(a), int(b)) for a, b in paddings] + \
        [(0, 0)] * (x.dim() - 1 - m)
    x = jr.pad_array(x, pads)
    n = x.shape[0]
    rest = list(x.shape[1 + m:])
    shp = [n]
    for i in range(m):
        shp += [x.shape[1 + i] // block[i], block[i]]
    x = x.reshape(shp + rest)
    perm = [2 * i + 2 for i in range(m)] + [0] + \
        [2 * i + 1 for i in range(m)] + list(range(1 + 2 * m, x.dim()))
    x = x.permute(*perm)
    out_n = n * int(np.prod(block))
    out_sp = [x.shape[m + 1 + i] for i in range(m)]
    return x.reshape([out_n] + out_sp + rest)


@register_op("batch_to_space_nd")
def batch_to_space_nd(x, block_shape, crops):
    """The inverse of :func:`space_to_batch_nd`, then the crops."""
    block = [int(b) for b in block_shape]
    m = len(block)
    n = x.shape[0] // int(np.prod(block))
    sp = list(x.shape[1:1 + m])
    rest = list(x.shape[1 + m:])
    x = x.reshape(block + [n] + sp + rest)
    perm = [m]
    for i in range(m):
        perm += [m + 1 + i, i]
    perm += list(range(2 * m + 1, x.dim()))
    x = x.permute(*perm)
    x = x.reshape([n] + [sp[i] * block[i] for i in range(m)] + rest)
    for i in range(m):
        c0, c1 = int(crops[i][0]), int(crops[i][1])
        x = x.narrow(1 + i, c0, max(0, x.shape[1 + i] - c1 - c0))
    return x


@register_op("zeta")
def zeta(x, q):
    """The Hurwitz zeta function."""
    x, q = (t if isinstance(t, torch.Tensor) else jr.as_tensor(t)
            for t in (x, q))
    dt = torch.promote_types(x.dtype, q.dtype)
    dt = dt if dt.is_floating_point else torch.float32
    return torch.special.zeta(x.to(dt), q.to(x.device, dt))
