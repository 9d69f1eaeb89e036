"""SameDiff graph engine: counterpart of ``deeplearning4j_tpu/autodiff``
(graph building, by-name execution, control flow, autograd gradients,
training, validation, save and load)."""

from deeplearning4j_tpu_torch.autodiff import ops_math  # noqa: F401 (registers ops)
from deeplearning4j_tpu_torch.autodiff import control_flow  # noqa: F401 (registers ops)
from deeplearning4j_tpu_torch.autodiff.samediff import (SameDiff, SDVariable,
                                                        VariableType)
from deeplearning4j_tpu_torch.autodiff.training import History, TrainingConfig
from deeplearning4j_tpu_torch.autodiff.validation import (GradCheckUtil,
                                                          OpValidation,
                                                          TestCase)

__all__ = [
    "SameDiff", "SDVariable", "VariableType", "TrainingConfig", "History",
    "GradCheckUtil", "OpValidation", "TestCase",
]
