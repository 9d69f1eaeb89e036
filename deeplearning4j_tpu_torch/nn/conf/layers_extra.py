"""The ported part of ``deeplearning4j_tpu/nn/conf/layers_extra.py``:
:class:`DepthwiseConvolution2D` (``:264-294``) and
:class:`SpaceToDepthLayer` (``:325-341``, YOLO2's passthrough reorg).
The module's other layers are not ported yet (ROADMAP A1); a
configuration naming one raises ``NotImplementedError`` with its name.

Same contract as ``nn/conf/layers.py``: serializable dataclasses with the
JAX names and fields, plain functions of NHWC tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer, Layer,
                                                     _act)
from deeplearning4j_tpu_torch.nn.weights import WeightInit, init_weights
from deeplearning4j_tpu_torch.ops import nn as nnops
from deeplearning4j_tpu_torch.ops import shape as shapeops


@serializable
@dataclasses.dataclass
class DepthwiseConvolution2D(ConvolutionLayer):
    """Depthwise convolution (``ops.nn.depthwise_conv2d``): ``W`` ``[kh,
    kw, C_in, depth_multiplier]``, ``b`` ``[C_in * depth_multiplier]``; the
    output has ``n_in * depth_multiplier`` channels whatever ``n_out``
    says."""

    depth_multiplier: int = 1

    def output_type(self, it: InputType) -> InputType:
        base = super().output_type(it)
        return InputType.convolutional(base.height, base.width,
                                       self.n_in * self.depth_multiplier)

    def init_params(self, generator, it, dtype, device) -> dict:
        kh, kw = self.kernel_size
        fan = kh * kw * self.n_in
        p = {"W": init_weights(self.weight_init or WeightInit.XAVIER,
                               generator,
                               (kh, kw, self.n_in, self.depth_multiplier),
                               fan, fan * self.depth_multiplier, dtype,
                               device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_in * self.depth_multiplier,),
                                 dtype=dtype, device=device)
        return p

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        pad = "SAME" if self.convolution_mode == "Same" else self.padding
        out = nnops.depthwise_conv2d(x, params["W"], params.get("b"),
                                     strides=self.stride, padding=pad,
                                     dilation=self.dilation)
        return _act(self.activation or "identity").fn(out), state


@serializable
@dataclasses.dataclass
class SpaceToDepthLayer(Layer):
    """``ops.shape.space_to_depth`` by ``block_size``: ``[N, H, W, C]`` to
    ``[N, H / b, W / b, C * b * b]``."""

    block_size: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        bs = self.block_size
        return InputType.convolutional(it.height // bs, it.width // bs,
                                       it.channels * bs * bs)

    def apply(self, params, state, x, train, generator):
        return shapeops.space_to_depth(x, self.block_size), state


__all__ = ["DepthwiseConvolution2D", "SpaceToDepthLayer"]
