"""Graph vertices: counterpart of ``deeplearning4j_tpu/nn/graph/vertices.py``
(``:21-106`` and the preprocessor vertex ``:250-271``).

A vertex is a node of a ``ComputationGraph`` that takes one or more
input tensors: :class:`LayerVertex` wraps a layer configuration (the
common case), :class:`MergeVertex` concatenates along the last (channel
or feature) axis, :class:`ElementWiseVertex` combines its inputs
elementwise (ResNet's residual sum) and :class:`PreprocessorVertex`
carries the reshape that ``GraphBuilder.build`` places between an image
and a dense layer. Their signatures follow the port's layers:

    init_params(generator, input_types, dtype, device) -> param dict
    init_state(input_types, dtype, device)             -> state dict
    apply(params, state, inputs, train, generator)     -> (out, new_state)

The other vertex classes of the JAX package are registered under their
names so that a configuration naming one fails with the ROADMAP item
(A3) that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.nn.conf.builder import (
    apply_preprocessor, preprocessor_output_type)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType


@dataclasses.dataclass
class GraphVertex:
    def output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def init_params(self, generator, input_types, dtype, device) -> dict:
        return {}

    def init_state(self, input_types, dtype, device) -> dict:
        return {}

    def apply(self, params, state, inputs: list, train: bool, generator):
        raise NotImplementedError


@serializable
@dataclasses.dataclass
class LayerVertex(GraphVertex):
    """A layer configuration as a single-input vertex."""

    layer: object = None

    def output_type(self, input_types):
        return self.layer.output_type(input_types[0])

    def init_params(self, generator, input_types, dtype, device):
        return self.layer.init_params(generator, input_types[0], dtype,
                                      device)

    def init_state(self, input_types, dtype, device):
        return self.layer.init_state(input_types[0], dtype, device)

    def apply(self, params, state, inputs, train, generator):
        return self.layer.apply(params, state, inputs[0], train, generator)


@serializable
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenation along the last axis (channels of NHWC, features of
    NTF)."""

    def output_type(self, its):
        it = its[0]
        if it.kind == "convolutional":
            return InputType.convolutional(it.height, it.width,
                                           sum(i.channels for i in its))
        if it.kind == "recurrent":
            return InputType.recurrent(sum(i.size for i in its),
                                       it.timeseries_length)
        return InputType.feedForward(sum(i.size for i in its))

    def apply(self, params, state, inputs, train, generator):
        return torch.cat(inputs, dim=-1), state


@serializable
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Elementwise combination: Add, Subtract (first minus second),
    Product, Average, Max or Min."""

    op: str = "Add"

    def apply(self, params, state, inputs, train, generator):
        op = self.op.lower()
        out = inputs[0]
        if op == "add":
            for x in inputs[1:]:
                out = out + x
        elif op == "subtract":
            out = inputs[0] - inputs[1]
        elif op == "product":
            for x in inputs[1:]:
                out = out * x
        elif op == "average":
            out = sum(inputs) / len(inputs)
        elif op == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        elif op == "min":
            for x in inputs[1:]:
                out = torch.minimum(out, x)
        else:
            raise ValueError(f"Unknown elementwise op: {self.op}")
        return out, state


@serializable
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """A reshape by preprocessor tag (``"flatten"``, ``"to_conv:H,W,C"``)."""

    tag: str = "flatten"

    def output_type(self, its):
        return preprocessor_output_type(self.tag, its[0])

    def apply(self, params, state, inputs, train, generator):
        return apply_preprocessor(self.tag, inputs[0]), state


def _unported_vertex(name: str) -> type:
    """A registered stand-in for a JAX vertex class not ported yet:
    building it, or reading a configuration that names it, raises."""

    def refuse(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to deeplearning4j_tpu_torch yet "
            f"(ROADMAP.md A3)")

    return serializable(dataclasses.make_dataclass(
        name, [], bases=(GraphVertex,), namespace={"__init__": refuse},
        init=False))


_NOT_PORTED = ("ScaleVertex", "L2NormalizeVertex", "SubsetVertex",
               "LastTimeStepVertex", "DuplicateToTimeSeriesVertex",
               "ReverseTimeSeriesVertex", "StackVertex", "UnstackVertex",
               "ShiftVertex", "ReshapeVertex", "L2Vertex", "FrozenVertex",
               "PoolHelperVertex", "DotProductAttentionVertex")
globals().update({n: _unported_vertex(n) for n in _NOT_PORTED})

__all__ = ["GraphVertex", "LayerVertex", "MergeVertex", "ElementWiseVertex",
           "PreprocessorVertex", *_NOT_PORTED]
