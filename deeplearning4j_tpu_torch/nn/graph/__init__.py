"""``ComputationGraph``, its configuration and its vertices."""

from deeplearning4j_tpu_torch.nn.graph.config import (
    ComputationGraphConfiguration, GraphBuilder, GraphNode)
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.graph.vertices import (
    DotProductAttentionVertex, DuplicateToTimeSeriesVertex, ElementWiseVertex,
    FrozenVertex, GraphVertex, L2NormalizeVertex, L2Vertex,
    LastTimeStepVertex, LayerVertex, MergeVertex, PoolHelperVertex,
    PreprocessorVertex, ReshapeVertex, ReverseTimeSeriesVertex, ScaleVertex,
    ShiftVertex, StackVertex, SubsetVertex, UnstackVertex)

__all__ = ["ComputationGraph", "ComputationGraphConfiguration",
           "GraphBuilder", "GraphNode", "GraphVertex", "LayerVertex",
           "MergeVertex", "ElementWiseVertex", "PreprocessorVertex",
           "ScaleVertex", "L2NormalizeVertex", "SubsetVertex",
           "LastTimeStepVertex", "DuplicateToTimeSeriesVertex",
           "ReverseTimeSeriesVertex", "StackVertex", "UnstackVertex",
           "ShiftVertex", "ReshapeVertex", "L2Vertex", "FrozenVertex",
           "PoolHelperVertex", "DotProductAttentionVertex"]
