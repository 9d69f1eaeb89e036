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

The other vertices of the JAX package (``:109-389``) are ported with
it: scale, shift, L2 normalisation and distance, subsets, reshapes, the
recurrent ones that seq2seq graphs use (:class:`LastTimeStepVertex`,
:class:`DuplicateToTimeSeriesVertex`, :class:`ReverseTimeSeriesVertex`),
batch stacking, :class:`FrozenVertex`, :class:`PoolHelperVertex` and
:class:`DotProductAttentionVertex`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.nn.conf.builder import (
    apply_preprocessor, preprocessor_output_type)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops import nn as nnops
from deeplearning4j_tpu_torch.params import tree_map


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


@serializable
@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    """``x * scale``."""

    scale: float = 1.0

    def apply(self, params, state, inputs, train, generator):
        return inputs[0] * self.scale, state


@serializable
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """Each example divided by its L2 norm over all its non-batch axes
    jointly, ``sqrt(max(sum x^2, eps))``."""

    eps: float = 1e-10

    def apply(self, params, state, inputs, train, generator):
        x = inputs[0]
        axes = tuple(range(1, x.dim()))
        n = torch.sqrt(torch.clamp(torch.sum(x * x, dim=axes, keepdim=True),
                                   min=self.eps))
        return x / n, state


@serializable
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """The last axis sliced ``[frm, to]``, both ends included."""

    frm: int = 0
    to: int = 0

    def output_type(self, its):
        it = its[0]
        n = self.to - self.frm + 1
        if it.kind == "recurrent":
            return InputType.recurrent(n, it.timeseries_length)
        if it.kind == "convolutional":
            return InputType.convolutional(it.height, it.width, n)
        return InputType.feedForward(n)

    def apply(self, params, state, inputs, train, generator):
        return inputs[0][..., self.frm:self.to + 1], state


@serializable
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertex):
    """``[N, T, F]`` to ``[N, F]``: the last step, or with an ``[N, T]``
    mask wired as a second input each row's last nonzero step (not the
    mask's sum minus one, which a mask with an interior gap would send to
    a masked step; the last step where a row has none)."""

    def output_type(self, its):
        return InputType.feedForward(its[0].size)

    def apply(self, params, state, inputs, train, generator):
        x = inputs[0]
        if len(inputs) > 1 and inputs[1] is not None:
            t = x.shape[1]
            # the first maximum, as jnp.argmax takes it: the last nonzero
            # step counted from the end
            rev_first = torch.argmax(torch.flip(
                inputs[1].to(torch.int32), dims=(1,)), dim=1)
            idx = torch.clamp(t - 1 - rev_first, min=0)
            return x[torch.arange(x.shape[0], device=x.device), idx], state
        return x[:, -1], state


@serializable
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """``[N, F]`` to ``[N, T, F]``, T from the second (recurrent) input:
    a stride-0 view, whose gradient is the sum over T."""

    def output_type(self, its):
        return InputType.recurrent(its[0].size, its[1].timeseries_length)

    def apply(self, params, state, inputs, train, generator):
        feat, ref = inputs[0], inputs[1]
        return feat[:, None, :].expand(feat.shape[0], ref.shape[1],
                                       feat.shape[1]), state


@serializable
@dataclasses.dataclass
class ReverseTimeSeriesVertex(GraphVertex):
    """The time axis reversed."""

    def apply(self, params, state, inputs, train, generator):
        return torch.flip(inputs[0], dims=(1,)), state


@serializable
@dataclasses.dataclass
class StackVertex(GraphVertex):
    """The inputs concatenated along the batch axis."""

    def apply(self, params, state, inputs, train, generator):
        return torch.cat(inputs, dim=0), state


@serializable
@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Segment ``from_index`` of ``stack_size`` equal batch segments (the
    inverse of :class:`StackVertex`)."""

    from_index: int = 0
    stack_size: int = 1

    def apply(self, params, state, inputs, train, generator):
        x = inputs[0]
        if not 0 <= self.from_index < self.stack_size:
            raise ValueError(
                f"from_index {self.from_index} not in [0, "
                f"{self.stack_size})")
        if x.shape[0] % self.stack_size != 0:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by "
                f"stack_size {self.stack_size}")
        n = x.shape[0] // self.stack_size
        return x[self.from_index * n:(self.from_index + 1) * n], state


@serializable
@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    """``x + shift``."""

    shift: float = 0.0

    def apply(self, params, state, inputs, train, generator):
        return inputs[0] + self.shift, state


@serializable
@dataclasses.dataclass
class ReshapeVertex(GraphVertex):
    """Each example reshaped to ``shape`` (the batch axis kept)."""

    shape: Optional[List[int]] = None

    def output_type(self, its):
        s = list(self.shape)
        if len(s) == 1:
            return InputType.feedForward(s[0])
        if len(s) == 2:
            return InputType.recurrent(s[1], s[0])
        if len(s) == 3:
            return InputType.convolutional(s[0], s[1], s[2])
        if len(s) == 4:
            return InputType.convolutional3D(s[0], s[1], s[2], s[3])
        raise ValueError(f"ReshapeVertex: bad shape {self.shape}")

    def apply(self, params, state, inputs, train, generator):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape)), state


@serializable
@dataclasses.dataclass
class L2Vertex(GraphVertex):
    """The L2 distance between two inputs per example, ``[N, 1]``:
    ``sqrt(sum (a - b)^2 + eps)``."""

    eps: float = 1e-8

    def output_type(self, its):
        return InputType.feedForward(1)

    def apply(self, params, state, inputs, train, generator):
        a, b = inputs[0], inputs[1]
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True)
                          + self.eps), state


@serializable
@dataclasses.dataclass
class FrozenVertex(GraphVertex):
    """A vertex whose parameters take no gradient (detached) and which
    runs in inference mode (no dropout, running batch-norm statistics);
    ``ComputationGraph.init`` gives it the ``NoOp`` updater, and a
    training step leaves its parameters out of the gradient and the
    updater. Where no input carries a gradient it records no autograd
    graph."""

    vertex: object = None

    def output_type(self, its):
        return self.vertex.output_type(its)

    def init_params(self, generator, its, dtype, device):
        return self.vertex.init_params(generator, its, dtype, device)

    def init_state(self, its, dtype, device):
        return self.vertex.init_state(its, dtype, device)

    def apply(self, params, state, inputs, train, generator):
        frozen = tree_map(lambda t: t.detach(), params)
        record = torch.is_grad_enabled() and any(
            torch.is_tensor(x) and x.requires_grad for x in inputs)
        with torch.set_grad_enabled(record):
            return self.vertex.apply(frozen, state, inputs, False, generator)


@serializable
@dataclasses.dataclass
class PoolHelperVertex(GraphVertex):
    """The first row and column of an NHWC image dropped."""

    def output_type(self, its):
        it = its[0]
        return InputType.convolutional(it.height - 1, it.width - 1,
                                       it.channels)

    def apply(self, params, state, inputs, train, generator):
        return inputs[0][:, 1:, 1:, :], state


@serializable
@dataclasses.dataclass
class DotProductAttentionVertex(GraphVertex):
    """Scaled dot-product attention of the inputs (query, key, value[,
    mask]) through the plain ``ops.nn.dot_product_attention``; the mask
    ``[N, S]`` (1 attends) masks keys. No parameters."""

    def output_type(self, its):
        q, v = its[0], its[2] if len(its) > 2 else its[-1]
        return InputType.recurrent(v.size, q.timeseries_length)

    def apply(self, params, state, inputs, train, generator):
        q, k, v = inputs[0], inputs[1], inputs[2]
        mask = inputs[3] if len(inputs) > 3 else None
        return nnops.dot_product_attention(
            q, k, v, mask=mask[:, None, :] if mask is not None else None), \
            state


__all__ = ["GraphVertex", "LayerVertex", "MergeVertex", "ElementWiseVertex",
           "PreprocessorVertex", "ScaleVertex", "L2NormalizeVertex",
           "SubsetVertex", "LastTimeStepVertex",
           "DuplicateToTimeSeriesVertex", "ReverseTimeSeriesVertex",
           "StackVertex", "UnstackVertex", "ShiftVertex", "ReshapeVertex",
           "L2Vertex", "FrozenVertex", "PoolHelperVertex",
           "DotProductAttentionVertex"]
