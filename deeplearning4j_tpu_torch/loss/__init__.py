"""Loss functions: counterpart of ``deeplearning4j_tpu/loss/__init__.py``.

Every loss takes ``(labels, output)`` and returns the per-example loss
``[N]``; :func:`compute_loss` applies the activation, the fused stable
paths (softmax + MCXENT, sigmoid + XENT on pre-activations), the mask and
the reduction exactly as the JAX function does. :class:`LossFunction`
keeps every name of the JAX enum, each with the JAX formula
(loss/__init__.py:23-152).
"""

from __future__ import annotations

import enum
from typing import Callable

import torch

from deeplearning4j_tpu_torch.ops.transforms import jax_abs, jax_clip


def _feature_dims(x):
    return tuple(range(1, x.dim()))


def mse(labels, output):
    """Per-example mean of squared errors (reference: LossMSE)."""
    d = output - labels
    return torch.mean(d * d, dim=_feature_dims(output))


def l2(labels, output):
    d = output - labels
    return torch.sum(d * d, dim=_feature_dims(output))


def l1(labels, output):
    return torch.sum(jax_abs(output - labels), dim=_feature_dims(output))


def mae(labels, output):
    return torch.mean(jax_abs(output - labels), dim=_feature_dims(output))


def mcxent(labels, probs, eps=1e-7):
    """Multi-class cross-entropy on probabilities (post-softmax)."""
    p = jax_clip(probs, eps, 1.0)
    return -torch.sum(labels * torch.log(p), dim=_feature_dims(probs))


def softmax_xent_logits(labels, logits):
    """Fused, numerically stable cross-entropy on logits: the path the
    trainer takes when the output activation is softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(labels * logp, dim=_feature_dims(logits))


def xent_binary(labels, probs, eps=1e-7):
    p = jax_clip(probs, eps, 1 - eps)
    loss = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    return torch.sum(loss, dim=_feature_dims(probs))


def sigmoid_xent_logits(labels, logits):
    """``max(z, 0) - z y + log1p(exp(-|z|))`` with JAX's gradients at the
    kink z == 0 (C13): ``jnp.maximum`` splits a tie and ``jnp.abs`` takes
    slope 1 there, so the gradient at 0 is ``-y`` (``torch.clamp`` and
    ``torch.abs`` would give ``1 - y``)."""
    loss = (jax_clip(logits, lo=0.0) - logits * labels
            + torch.log1p(torch.exp(-jax_abs(logits))))
    return torch.sum(loss, dim=_feature_dims(logits))


def hinge(labels, output):
    """Labels in {-1, 1} (reference: LossHinge)."""
    return torch.sum(jax_clip(1.0 - labels * output, lo=0.0),
                     dim=_feature_dims(output))


def squared_hinge(labels, output):
    return torch.sum(jax_clip(1.0 - labels * output, lo=0.0) ** 2,
                     dim=_feature_dims(output))


def kl_divergence(labels, probs, eps=1e-7):
    p = jax_clip(probs, eps, 1.0)
    lc = jax_clip(labels, eps, 1.0)
    return torch.sum(labels * (torch.log(lc) - torch.log(p)),
                     dim=_feature_dims(probs))


def poisson(labels, output, eps=1e-7):
    return torch.sum(output - labels * torch.log(output + eps),
                     dim=_feature_dims(output))


def cosine_proximity(labels, output, eps=1e-8):
    ln = labels / (torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
                   + eps)
    on = output / (torch.linalg.vector_norm(output, dim=-1, keepdim=True)
                   + eps)
    return -torch.sum(ln * on, dim=_feature_dims(output))


def huber(labels, output, delta=1.0):
    d = jax_abs(output - labels)
    quad = 0.5 * d * d
    lin = delta * d - 0.5 * delta * delta
    return torch.sum(torch.where(d <= delta, quad, lin),
                     dim=_feature_dims(output))


def mape(labels, output, eps=1e-7):
    return torch.mean(100.0 * jax_abs((labels - output)
                                      / (jax_abs(labels) + eps)),
                      dim=_feature_dims(output))


def msle(labels, output, eps=1e-7):
    d = (torch.log1p(jax_clip(output, lo=-1 + eps))
         - torch.log1p(jax_clip(labels, lo=-1 + eps)))
    return torch.mean(d * d, dim=_feature_dims(output))


def sparse_mcxent(labels, logits):
    """Integer labels variant (reference: LossSparseMCXENT)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def wasserstein(labels, output):
    """Reference: LossWasserstein, ``mean(labels * output)``; the labels
    are the critic's +1 / -1 signs."""
    return torch.mean(labels * output, dim=_feature_dims(output))


def reconstruction_crossentropy(labels, output):
    """Reference: LossReconstructionCrossEntropy: binary cross-entropy of
    activated outputs with the reference's wider 1e-5 clamp."""
    return xent_binary(labels, output, eps=1e-5)


_LOSS_ALIASES = {
    "categorical_crossentropy": "MCXENT",
    "sparse_categorical_crossentropy": "SPARSE_MCXENT",
    "binary_crossentropy": "XENT",
    "mean_squared_error": "MSE",
    "mean_absolute_error": "MAE",
    "kld": "KL_DIVERGENCE",
    "kullback_leibler_divergence": "KL_DIVERGENCE",
    "nll": "NEGATIVELOGLIKELIHOOD",
}


class LossFunction(enum.Enum):
    """Reference: LossFunctions.LossFunction enum names."""

    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    MAE = "mae"
    XENT = "xent"
    MCXENT = "mcxent"
    SPARSE_MCXENT = "sparse_mcxent"
    KL_DIVERGENCE = "kl_divergence"
    POISSON = "poisson"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    COSINE_PROXIMITY = "cosine_proximity"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mape"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "msle"
    HUBER = "huber"
    WASSERSTEIN = "wasserstein"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"

    @property
    def fn(self) -> Callable:
        return _FNS[self]

    @staticmethod
    def resolve(l) -> "LossFunction":
        if isinstance(l, LossFunction):
            return l
        if isinstance(l, str):
            key = _LOSS_ALIASES.get(l.lower(), l)
            if key.upper() in LossFunction.__members__:
                return LossFunction[key.upper()]
            try:
                return LossFunction(key.lower())
            except ValueError:
                raise ValueError(
                    f"Unknown loss {l!r}; valid: "
                    f"{sorted(LossFunction.__members__)}") from None
        raise ValueError(f"Cannot resolve loss: {l!r}")


_FNS = {
    LossFunction.MSE: mse,
    LossFunction.L1: l1,
    LossFunction.L2: l2,
    LossFunction.MAE: mae,
    LossFunction.XENT: xent_binary,
    LossFunction.MCXENT: mcxent,
    LossFunction.SPARSE_MCXENT: sparse_mcxent,
    LossFunction.KL_DIVERGENCE: kl_divergence,
    LossFunction.POISSON: poisson,
    LossFunction.HINGE: hinge,
    LossFunction.SQUARED_HINGE: squared_hinge,
    LossFunction.COSINE_PROXIMITY: cosine_proximity,
    LossFunction.NEGATIVELOGLIKELIHOOD: mcxent,
    LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR: mape,
    LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR: msle,
    LossFunction.HUBER: huber,
    LossFunction.WASSERSTEIN: wasserstein,
    LossFunction.RECONSTRUCTION_CROSSENTROPY: reconstruction_crossentropy,
}


#: losses whose per-example value is a MEAN over feature axes (all
#: others SUM): the masked divisor keeps an all-ones mask equal to no mask
_MEAN_REDUCED_LOSSES = frozenset({
    LossFunction.MSE, LossFunction.MAE, LossFunction.WASSERSTEIN,
    LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR,
    LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR,
})


def compute_loss(loss_fn: LossFunction, labels, preoutput, activation,
                 mask=None):
    """Activation-aware loss on pre-activations (``compute_loss``,
    loss/__init__.py:226-280).

    Unmasked, the result is the mean over examples of the per-example
    loss, which for ``[N, T, C]`` outputs sums over T and C (so it grows
    with T). A per-timestep mask (``labels.shape[:-1]``, or with a
    trailing 1) folds time into the example axis; masked entries add 0
    and the divisor is what the unmasked reduction would use: N for
    sum-reduced losses, ``per_ex.numel()`` for mean-reduced ones and for
    unfolded masks."""
    from deeplearning4j_tpu_torch.activations import Activation

    act = Activation.resolve(activation)
    n_examples = labels.shape[0]
    folded = False
    if mask is not None:
        if mask.dim() == labels.dim() and mask.shape[-1] == 1:
            mask = mask[..., 0]
        if mask.dim() >= 2 and tuple(mask.shape) == tuple(labels.shape[:-1]):
            labels = labels.reshape(-1, labels.shape[-1])
            preoutput = preoutput.reshape(-1, preoutput.shape[-1])
            mask = mask.reshape(-1)
            folded = True
        elif mask.dim() == 2 and mask.shape[1] == 1:
            mask = mask[:, 0]
    if loss_fn in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD) \
            and act is Activation.SOFTMAX:
        per_ex = softmax_xent_logits(labels, preoutput)
    elif loss_fn is LossFunction.SPARSE_MCXENT and act is Activation.SOFTMAX:
        per_ex = sparse_mcxent(labels, preoutput)
    elif loss_fn is LossFunction.XENT and act is Activation.SIGMOID:
        per_ex = sigmoid_xent_logits(labels, preoutput)
    else:
        per_ex = loss_fn.fn(labels, act.fn(preoutput))
    if mask is not None:
        per_ex = per_ex * mask.reshape(per_ex.shape)
        if folded and loss_fn not in _MEAN_REDUCED_LOSSES:
            divisor = n_examples
        else:
            divisor = per_ex.numel()
        return torch.sum(per_ex) / divisor
    return torch.mean(per_ex)


__all__ = ["LossFunction", "compute_loss", "softmax_xent_logits",
           "sigmoid_xent_logits", "mse", "l1", "l2", "mae", "mcxent",
           "xent_binary", "sparse_mcxent", "kl_divergence", "poisson",
           "hinge", "squared_hinge", "cosine_proximity", "huber", "mape",
           "msle", "wasserstein", "reconstruction_crossentropy"]
