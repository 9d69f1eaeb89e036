"""Loss functions: counterpart of ``deeplearning4j_tpu/loss/__init__.py``.

Every loss takes ``(labels, output)`` and returns the per-example loss
``[N]``; :func:`compute_loss` applies the activation, the fused stable
paths (softmax + MCXENT, sigmoid + XENT on pre-activations), the mask and
the reduction exactly as the JAX function does. :class:`LossFunction`
keeps every name of the JAX enum; the losses not ported yet raise
``NotImplementedError`` when used.
"""

from __future__ import annotations

import enum
from typing import Callable

import torch


def _feature_dims(x):
    return tuple(range(1, x.dim()))


def mse(labels, output):
    """Per-example mean of squared errors (reference: LossMSE)."""
    d = output - labels
    return torch.mean(d * d, dim=_feature_dims(output))


def mcxent(labels, probs, eps=1e-7):
    """Multi-class cross-entropy on probabilities (post-softmax)."""
    p = torch.clamp(probs, eps, 1.0)
    return -torch.sum(labels * torch.log(p), dim=_feature_dims(probs))


def softmax_xent_logits(labels, logits):
    """Fused, numerically stable cross-entropy on logits: the path the
    trainer takes when the output activation is softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(labels * logp, dim=_feature_dims(logits))


def xent_binary(labels, probs, eps=1e-7):
    p = torch.clamp(probs, eps, 1 - eps)
    loss = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    return torch.sum(loss, dim=_feature_dims(probs))


def sigmoid_xent_logits(labels, logits):
    loss = (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.sum(loss, dim=_feature_dims(logits))


def sparse_mcxent(labels, logits):
    """Integer labels variant (reference: LossSparseMCXENT)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


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
        fns = {
            LossFunction.MSE: mse,
            LossFunction.XENT: xent_binary,
            LossFunction.MCXENT: mcxent,
            LossFunction.SPARSE_MCXENT: sparse_mcxent,
            LossFunction.NEGATIVELOGLIKELIHOOD: mcxent,
        }
        if self not in fns:
            raise NotImplementedError(
                f"loss {self.value!r} is not ported to "
                f"deeplearning4j_tpu_torch yet")
        return fns[self]

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


__all__ = ["LossFunction", "compute_loss", "softmax_xent_logits", "mcxent",
           "mse"]
