"""SameDiff training: counterpart of
``deeplearning4j_tpu/autodiff/training.py`` (:27-240):
``TrainingConfig`` (with its serde tag), ``History``, ``fit`` and
``evaluate``.

JAX compiles one step per feed signature (forward, ``value_and_grad``,
updater, parameter update, buffers donated). The port runs the same
arithmetic eagerly on the graph's device: the trainable arrays become
autograd leaves, one backward pass gives their gradients, the port's
updater (``learning/updaters.py`` ``apply_updater``) runs under
``no_grad``, and each parameter is replaced by ``p - update``. The loss
is the sum of every loss variable's elements, sign-flipped when
``minimize`` is False, then the l1 and l2 penalties over every trainable
variable (in that order, so a maximised score still pays for large
weights); the l1 term takes ``|v|`` with ``jnp.abs``'s slope 1 at 0.
Each step's loss is read back to the host, as ``float(loss)`` reads it
in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.learning.updaters import (IUpdater, Sgd,
                                                        apply_updater)
from deeplearning4j_tpu_torch.ndarray.ndarray import _unwrap
from deeplearning4j_tpu_torch.ops.transforms import jax_abs


@serializable
@dataclasses.dataclass
class TrainingConfig:
    """Reference: TrainingConfig.Builder: the updater, the placeholders
    fed from a DataSet's features and labels, l1 / l2 and the direction."""

    updater: IUpdater = dataclasses.field(default_factory=lambda: Sgd(0.01))
    data_set_feature_mapping: Sequence[str] = ()
    data_set_label_mapping: Sequence[str] = ()
    l1: float = 0.0
    l2: float = 0.0
    minimize: bool = True


class History:
    """Reference: org/nd4j/autodiff/listeners/records/History."""

    def __init__(self):
        self.loss_curve: List[float] = []
        self.epoch_losses: List[float] = []
        self.validation_losses: List[float] = []  # one per epoch

    def lossCurve(self) -> List[float]:
        return self.loss_curve

    def finalTrainingLoss(self) -> float:
        return self.loss_curve[-1] if self.loss_curve else float("nan")

    def finalValidationLoss(self) -> float:
        return self.validation_losses[-1] if self.validation_losses \
            else float("nan")


def _ds_feeds(cfg: TrainingConfig, ds, include_labels: bool = True):
    """A DataSet's arrays as placeholder feeds, by the config's
    mappings."""
    feeds = {}
    feats = ds.features if isinstance(ds.features, (list, tuple)) \
        else [ds.features]
    for name, arr in zip(cfg.data_set_feature_mapping, feats):
        feeds[name] = _unwrap(arr)
    if include_labels:
        labs = ds.labels if isinstance(ds.labels, (list, tuple)) \
            else [ds.labels]
        for name, arr in zip(cfg.data_set_label_mapping, labs):
            feeds[name] = _unwrap(arr)
    return feeds


def train_step(sd, cfg: TrainingConfig, feeds: Dict[str, Any]) -> float:
    """One step: loss, gradients, updater, parameters replaced; returns
    the loss as a host float."""
    names = sd.trainable_names()
    leaves = {n: sd._arrays[n].detach().requires_grad_(True) for n in names}
    total = sd._total_loss({**sd._arrays, **leaves, **sd._feeds(feeds)})
    with torch.enable_grad():
        if not cfg.minimize:
            total = -total
        if cfg.l1:
            for v in leaves.values():
                total = total + cfg.l1 * torch.sum(jax_abs(v))
        if cfg.l2:
            for v in leaves.values():
                total = total + 0.5 * cfg.l2 * torch.sum(v * v)
    grads = sd._grads(total, leaves)
    with torch.no_grad():
        params = {n: sd._arrays[n] for n in names}
        updates, sd._updater_state = apply_updater(
            cfg.updater, sd._updater_state, grads, params, sd._iteration)
        for n in names:
            sd._arrays[n] = params[n] - updates[n]
    sd._last_grads = dict(grads)
    return float(total.detach())


def _batches(data):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.multi_dataset import MultiDataSet

    if isinstance(data, (DataSet, MultiDataSet)):
        return [data]
    if hasattr(data, "reset") or hasattr(data, "hasNext"):
        return data          # an iterator: resettable through __iter__
    return list(data)        # a one-shot iterable, kept for every epoch


def fit(sd, data, epochs: int = 1, validation_data=None,
        listeners: Sequence[Any] = ()) -> History:
    """Reference: SameDiff#fit(DataSetIterator, epochs)."""
    cfg = sd.training_config
    if cfg is None:
        raise ValueError("Call setTrainingConfig() before fit()")
    if not cfg.data_set_feature_mapping:
        raise ValueError("TrainingConfig needs data_set_feature_mapping")
    sd._loss_name()

    history = History()
    batches = _batches(data)
    if sd._updater_state is None:
        sd._updater_state = cfg.updater.init_state(
            {n: sd._arrays[n] for n in sd.trainable_names()})
    val_batches = None if validation_data is None \
        else _batches(validation_data)

    def _validation_loss():
        """The example-weighted mean loss over ``validation_data`` with
        the parameters fixed, in the training curve's sign: a scalar loss
        is taken as a mean over examples (weighted by their count), a
        non-scalar one as per-example values (summed)."""
        if val_batches is None:
            return None
        total, n_ex = 0.0, 0
        loss_names = tuple(sd._loss_variables)
        for ds in val_batches:
            feats = ds.features[0] if isinstance(ds.features,
                                                 (list, tuple)) \
                else ds.features
            n = int(_unwrap(feats).shape[0])
            outs = sd.output(_ds_feeds(cfg, ds), list(loss_names))
            for nm in loss_names:
                v = outs[nm]
                total += n * float(v) if v.dim() == 0 \
                    else float(torch.sum(v))
            n_ex += n
        if n_ex == 0:
            raise ValueError("validation_data produced no batches")
        v = total / n_ex
        return v if cfg.minimize else -v

    for _ in range(epochs):
        epoch_loss, nb = 0.0, 0
        for ds in batches:
            lv = train_step(sd, cfg, _ds_feeds(cfg, ds))
            history.loss_curve.append(lv)
            epoch_loss += lv
            nb += 1
            sd._iteration += 1
            for lst in listeners:
                if hasattr(lst, "iterationDone"):
                    lst.iterationDone(sd, sd._iteration, sd._epoch)
        sd._epoch += 1
        history.epoch_losses.append(epoch_loss / max(nb, 1))
        vl = _validation_loss()
        if vl is not None:
            history.validation_losses.append(vl)
    return history


def evaluate(sd, iterator, output_name: str, evaluation=None):
    """Reference: SameDiff#evaluate(DataSetIterator, outputVariable,
    Evaluation): inference over the iterator into the evaluation."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.evaluation import Evaluation

    cfg = sd.training_config
    if cfg is None or not cfg.data_set_feature_mapping:
        raise ValueError("setTrainingConfig() with feature mappings first")
    ev = evaluation if evaluation is not None else Evaluation()
    if isinstance(iterator, DataSet):
        iterator = [iterator]
    for ds in iterator:
        feeds = _ds_feeds(cfg, ds, include_labels=False)
        out = sd.output(feeds, [output_name])[output_name]
        ev.eval(ds.labels, out, mask=ds.labels_mask)
    return ev
