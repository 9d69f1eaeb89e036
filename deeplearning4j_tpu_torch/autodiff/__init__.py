"""SameDiff graph engine: counterpart of ``deeplearning4j_tpu/autodiff``
(graph building, by-name execution, autograd gradients, save and load).
Training (``fit``), control flow and export wait (ROADMAP A10)."""

from deeplearning4j_tpu_torch.autodiff import ops_math  # noqa: F401 (registers ops)
from deeplearning4j_tpu_torch.autodiff.samediff import (SameDiff, SDVariable,
                                                        VariableType)

__all__ = ["SameDiff", "SDVariable", "VariableType"]
