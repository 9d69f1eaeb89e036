"""Training-loop support: listeners (``optimize.listeners``); early
stopping is ``earlystopping``."""

from deeplearning4j_tpu_torch.optimize.listeners import (
    CheckpointListener, CollectScoresListener, EvaluativeListener,
    PerformanceListener, ScoreIterationListener, TelemetryListener,
    TimeIterationListener, TrainingListener)

__all__ = [
    "TrainingListener", "ScoreIterationListener", "PerformanceListener",
    "CheckpointListener", "EvaluativeListener", "TimeIterationListener",
    "CollectScoresListener", "TelemetryListener",
]
