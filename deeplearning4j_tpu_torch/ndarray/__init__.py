"""Eager NDArray core: counterpart of ``deeplearning4j_tpu/ndarray``
(``DataType``, ``NDArray``, ``Nd4j``) over torch tensors."""

from deeplearning4j_tpu_torch.ndarray.dtypes import DataType
from deeplearning4j_tpu_torch.ndarray.factory import Nd4j
from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray

__all__ = ["DataType", "NDArray", "Nd4j"]
