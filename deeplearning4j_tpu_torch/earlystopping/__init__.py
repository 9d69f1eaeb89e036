"""Early stopping: counterpart of
``deeplearning4j_tpu/earlystopping/__init__.py``. Train an epoch, score
it, keep the best model, stop when a condition fires: the termination
conditions, the four score calculators (loss, classification metric,
regression metric, AUC), ``InMemoryModelSaver`` and
``LocalFileModelSaver`` (on ``ModelSerializer.writeModel``), and
``EarlyStoppingTrainer`` for ``MultiLayerNetwork`` and
``ComputationGraph`` alike. Host control flow around ``fit``; a score
reads one number back from the device per epoch.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch


# ----------------------------------------------------------------------
# termination conditions
# ----------------------------------------------------------------------
class EpochTerminationCondition:
    """Checked after each epoch (ref: EpochTerminationCondition).

    ``requires_score``: score-based conditions are only consulted on
    epochs where the score calculator actually ran (otherwise a stale
    score would, e.g., count phantom no-improvement epochs)."""

    requires_score = True

    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    requires_score = False

    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        return epoch + 1 >= self.max_epochs

    def __repr__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no improvement greater than min_improvement
    (ref: ScoreImprovementEpochTerminationCondition)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.max_epochs_without_improvement = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._best: Optional[float] = None
        self._epochs_since = 0

    def initialize(self) -> None:
        self._best = None
        self._epochs_since = 0

    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        if self._best is None:
            self._best = score
            return False
        improvement = ((self._best - score) if minimize
                       else (score - self._best))
        if improvement > self.min_improvement:
            self._best = score
            self._epochs_since = 0
            return False
        self._epochs_since += 1
        return self._epochs_since >= self.max_epochs_without_improvement


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least as good as a target value."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = best_expected_score

    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        if minimize:
            return score < self.best_expected_score
        return score > self.best_expected_score


class IterationTerminationCondition:
    """Checked after each iteration (ref: IterationTerminationCondition)."""

    def initialize(self) -> None:
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self) -> None:
        self._start = time.time()

    def terminate(self, last_score: float) -> bool:
        if self._start is None:
            self._start = time.time()
        return (time.time() - self._start) > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if the minibatch loss explodes past a bound."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score: float) -> bool:
        return last_score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score: float) -> bool:
        return math.isnan(last_score) or math.isinf(last_score)


# ----------------------------------------------------------------------
# score calculators
# ----------------------------------------------------------------------
class ScoreCalculator:
    """Computes the validation score for model selection
    (ref: org/deeplearning4j/earlystopping/scorecalc/ScoreCalculator)."""

    def calculate_score(self, model) -> float:
        raise NotImplementedError

    def minimize_score(self) -> bool:
        return True


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a validation iterator
    (ref: DataSetLossCalculator — average flag)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        for ds in self.iterator:
            k = ds.numExamples()
            total += model.score(ds) * k
            n += k
        if n == 0:
            return float("nan")
        return total / n if self.average else total


class ClassificationScoreCalculator(ScoreCalculator):
    """Maximize a classification metric (accuracy/f1/precision/recall)
    (ref: ClassificationScoreCalculator + Evaluation.Metric)."""

    def __init__(self, metric: str, iterator):
        self.metric = metric.lower()
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        self.iterator.reset()
        ev = model.evaluate(self.iterator)
        return float(getattr(ev, self.metric)())

    def minimize_score(self) -> bool:
        return False


class RegressionScoreCalculator(ScoreCalculator):
    """Minimize a regression metric (mse/mae/rmse) over validation data."""

    def __init__(self, metric: str, iterator):
        self.metric = metric.lower()
        self.iterator = iterator

    _METHODS = {"mse": "meanSquaredError", "mae": "meanAbsoluteError",
                "rmse": "rootMeanSquaredError"}

    def calculate_score(self, model) -> float:
        self.iterator.reset()
        ev = model.evaluateRegression(self.iterator)
        return float(getattr(ev, self._METHODS[self.metric])())


class ROCScoreCalculator(ScoreCalculator):
    """Maximize AUROC on validation data (ref: ROCScoreCalculator)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        from deeplearning4j_tpu_torch.evaluation import ROC

        roc = ROC()
        self.iterator.reset()
        for ds in self.iterator:
            out = model.output(ds.features)
            roc.eval(ds.labels, out)
        return float(roc.calculateAUC())

    def minimize_score(self) -> bool:
        return False


# ----------------------------------------------------------------------
# model savers
# ----------------------------------------------------------------------
class EarlyStoppingModelSaver:
    def save_best_model(self, model, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, model, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    """Keeps deep copies in memory (ref: InMemoryModelSaver)."""

    def __init__(self):
        self._best = None
        self._latest = None

    @staticmethod
    def _snapshot(model):
        """A clone holding copies of the tensors: training the model on
        does not reach the snapshot."""
        from deeplearning4j_tpu_torch.params import tree_map

        snap = model.clone()
        copy = lambda tree: tree_map(torch.clone, tree)
        if hasattr(model, "params_map"):       # ComputationGraph
            snap.params_map = copy(model.params_map)
            snap.states_map = copy(model.states_map)
        else:                                   # MultiLayerNetwork
            snap.params_list = copy(model.params_list)
            snap.states_list = copy(model.states_list)
        snap.opt_states = copy(model.opt_states)
        return snap

    def save_best_model(self, model, score: float) -> None:
        self._best = self._snapshot(model)

    def save_latest_model(self, model, score: float) -> None:
        self._latest = self._snapshot(model)

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """``bestModel.bin`` and ``latestModel.bin`` under ``directory``,
    written by ``ModelSerializer.writeModel`` (atomic: a crash mid-save
    leaves the previous best whole) and restored on the device the model
    was saved from."""

    def __init__(self, directory: str):
        self.directory = directory
        self._device = None
        os.makedirs(directory, exist_ok=True)

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "bestModel.bin")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, "latestModel.bin")

    def _write(self, model, path: str) -> None:
        from deeplearning4j_tpu_torch.util.model_serializer import (
            ModelSerializer)

        self._device = model.device
        ModelSerializer.writeModel(model, path)

    def save_best_model(self, model, score: float) -> None:
        self._write(model, self.best_path)

    def save_latest_model(self, model, score: float) -> None:
        self._write(model, self.latest_path)

    def _restore(self, path):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            ModelSerializer)

        # restore() reads the model type from the zip
        return (ModelSerializer.restore(path, device=self._device)
                if os.path.exists(path) else None)

    def get_best_model(self):
        return self._restore(self.best_path)

    def get_latest_model(self):
        return self._restore(self.latest_path)


# ----------------------------------------------------------------------
# configuration + result + trainer
# ----------------------------------------------------------------------
@dataclass
class EarlyStoppingConfiguration:
    """Ref: EarlyStoppingConfiguration.Builder."""

    score_calculator: ScoreCalculator
    epoch_termination_conditions: Sequence[EpochTerminationCondition] = ()
    iteration_termination_conditions: Sequence[
        IterationTerminationCondition] = ()
    model_saver: EarlyStoppingModelSaver = field(
        default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


class TerminationReason:
    ERROR = "Error"
    ITERATION_TERMINATION = "IterationTerminationCondition"
    EPOCH_TERMINATION = "EpochTerminationCondition"


@dataclass
class EarlyStoppingResult:
    """Ref: EarlyStoppingResult — same fields."""

    termination_reason: str
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


class _IterationStopListener:
    """Hooks the model's listener chain to check iteration conditions on
    every minibatch without a second loss computation."""

    def __init__(self, conditions):
        self.conditions = conditions
        self.fired: Optional[IterationTerminationCondition] = None
        self.last_score = float("nan")

    def iterationDone(self, model, iteration, epoch):
        if not self.conditions:
            # score() forces a device->host sync; don't pay it per step
            # unless an iteration condition actually needs the value
            return
        self.last_score = model.score()
        for c in self.conditions:
            if c.terminate(self.last_score):
                self.fired = c
                raise _StopIteration()

    def onEpochEnd(self, model):
        pass


class _StopIteration(Exception):
    pass


class EarlyStoppingTrainer:
    """Drives fit-one-epoch → score → maybe-save → maybe-stop
    (ref: BaseEarlyStoppingTrainer#fit)."""

    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_iterator):
        self.config = config
        self.model = model
        self.train_iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        minimize = cfg.score_calculator.minimize_score()
        iter_listener = _IterationStopListener(
            cfg.iteration_termination_conditions)
        saved_listeners = self.model.getListeners()
        self.model.addListeners(iter_listener)

        score_vs_epoch: dict = {}
        best_score = float("inf") if minimize else -float("inf")
        best_epoch = -1
        last_score = best_score
        epoch = 0
        reason = TerminationReason.EPOCH_TERMINATION
        details = ""
        try:
            while True:
                try:
                    self.train_iterator.reset()
                    self.model.fit(self.train_iterator)
                except _StopIteration:
                    reason = TerminationReason.ITERATION_TERMINATION
                    details = (f"{type(iter_listener.fired).__name__} fired at"
                               f" score {iter_listener.last_score}")
                    break
                evaluated = (epoch % cfg.evaluate_every_n_epochs) == 0
                if evaluated:
                    score = cfg.score_calculator.calculate_score(self.model)
                    score_vs_epoch[epoch] = score
                    last_score = score
                    improved = (score < best_score if minimize
                                else score > best_score)
                    if improved:
                        best_score, best_epoch = score, epoch
                        cfg.model_saver.save_best_model(self.model, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.model, last_score)
                # score-free conditions (MaxEpochs) are checked every
                # epoch; score-based ones only when a FRESH score exists
                stop = False
                for c in cfg.epoch_termination_conditions:
                    if c.requires_score and not evaluated:
                        continue
                    if c.terminate(epoch, last_score, minimize):
                        details = f"{c!r} fired at epoch {epoch}"
                        stop = True
                        break
                epoch += 1
                if stop:
                    break
        except (KeyboardInterrupt, SystemExit):
            raise       # an operator's stop reaches the caller
        except Exception as e:                      # noqa: BLE001
            # ref: BaseEarlyStoppingTrainer catches and reports Error
            reason = TerminationReason.ERROR
            details = f"{type(e).__name__}: {e}"
        finally:
            self.model._listeners = saved_listeners
        best_model = cfg.model_saver.get_best_model()
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=score_vs_epoch, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch,
            best_model=best_model if best_model is not None else self.model)


# ref: EarlyStoppingGraphTrainer — identical logic; ComputationGraph
# exposes the same fit/score/evaluate surface here.
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
