"""``ComputationGraph`` and its configuration (the ported subset)."""

from deeplearning4j_tpu_torch.nn.graph.config import (
    ComputationGraphConfiguration, GraphBuilder, GraphNode)
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.graph.vertices import (
    ElementWiseVertex, GraphVertex, LayerVertex, MergeVertex,
    PreprocessorVertex)

__all__ = ["ComputationGraph", "ComputationGraphConfiguration",
           "GraphBuilder", "GraphNode", "GraphVertex", "LayerVertex",
           "MergeVertex", "ElementWiseVertex", "PreprocessorVertex"]
