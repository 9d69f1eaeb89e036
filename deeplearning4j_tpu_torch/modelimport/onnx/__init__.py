"""ONNX import: counterpart of ``deeplearning4j_tpu/modelimport/onnx``.
No ``onnx`` package is needed: the wire format is decoded by the port's
own ``onnx_proto`` and mapped into the port's ``SameDiff``
(``onnx_import``)."""

from deeplearning4j_tpu_torch.modelimport.onnx.onnx_import import (
    OnnxImport, OnnxImportError, OnnxOpMappingRegistry,
)
from deeplearning4j_tpu_torch.modelimport.onnx.onnx_proto import decode_model

__all__ = ["OnnxImport", "OnnxImportError", "OnnxOpMappingRegistry",
           "decode_model"]
