"""TensorFlow frozen-graph import: counterpart of
``deeplearning4j_tpu/modelimport/tensorflow/``, with the same exported
names. Reads GraphDefs with its own wire decoder (``graphdef_wire``), so
it needs no ``tensorflow`` package."""

from deeplearning4j_tpu_torch.modelimport.tensorflow.tf_import import (
    OpMappingRegistry, TFGraphMapper,
)

__all__ = ["TFGraphMapper", "OpMappingRegistry"]
