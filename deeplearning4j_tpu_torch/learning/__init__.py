"""Updaters (optimizers) and learning-rate schedules of the port."""

from deeplearning4j_tpu_torch.learning.schedules import (
    CosineSchedule, ExponentialSchedule, InverseSchedule, ISchedule,
    MapSchedule, PolySchedule, ScheduleType, SigmoidSchedule, StepSchedule,
    WarmupSchedule)
from deeplearning4j_tpu_torch.learning.updaters import (
    AdaDelta, AdaGrad, AdaMax, Adam, AdamW, AMSGrad, IUpdater, Nadam,
    Nesterovs, NoOp, RmsProp, Sgd)

__all__ = [
    "ISchedule", "ExponentialSchedule", "InverseSchedule", "MapSchedule",
    "PolySchedule", "SigmoidSchedule", "StepSchedule", "CosineSchedule",
    "WarmupSchedule", "ScheduleType",
    "IUpdater", "Sgd", "Adam", "AdamW", "AdaMax", "Nadam", "AMSGrad",
    "Nesterovs", "AdaGrad", "AdaDelta", "RmsProp", "NoOp",
]
