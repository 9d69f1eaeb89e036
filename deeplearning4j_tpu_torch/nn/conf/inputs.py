"""Input types: counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``.

The same tagged union with the same fields, so a configuration written
by the JAX side parses, and the same geometry. Images are NHWC, as in
the JAX package: ``convolutionalFlat`` is a flat ``[N, H*W*C]`` vector
that a ``"to_conv:H,W,C"`` preprocessor reshapes to ``[N, H, W, C]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_tpu_torch.common.serde import serializable


@serializable
@dataclasses.dataclass
class InputType:
    """kind in {feedforward, recurrent, convolutional, convolutional3d,
    convolutionalFlat}; shapes exclude the batch dimension."""

    kind: str = "feedforward"
    size: int = 0           # feedforward width / recurrent feature size
    height: int = 0
    width: int = 0
    channels: int = 0
    depth: int = 0          # 3D convolutional only
    timeseries_length: int = -1  # -1 = variable

    @staticmethod
    def feedForward(size: int) -> "InputType":
        return InputType(kind="feedforward", size=size)

    @staticmethod
    def recurrent(size: int, timeseries_length: int = -1) -> "InputType":
        return InputType(kind="recurrent", size=size,
                         timeseries_length=timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="convolutional", height=height, width=width,
                         channels=channels)

    @staticmethod
    def convolutional3D(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        """NDHWC volumetric input."""
        return InputType(kind="convolutional3d", depth=depth, height=height,
                         width=width, channels=channels)

    @staticmethod
    def convolutionalFlat(height: int, width: int,
                          channels: int) -> "InputType":
        return InputType(kind="convolutionalFlat", height=height,
                         width=width, channels=channels)

    # -- geometry -------------------------------------------------------
    def arrayElementsPerExample(self) -> int:
        if self.kind == "feedforward":
            return self.size
        if self.kind == "recurrent":
            return self.size * max(self.timeseries_length, 1)
        if self.kind == "convolutional3d":
            return self.depth * self.height * self.width * self.channels
        return self.height * self.width * self.channels

    def example_shape(self) -> Tuple[int, ...]:
        """Per-example array shape in the canonical layout (NHWC
        images)."""
        if self.kind == "feedforward":
            return (self.size,)
        if self.kind == "recurrent":
            return (max(self.timeseries_length, 1), self.size)
        if self.kind == "convolutional":
            return (self.height, self.width, self.channels)
        if self.kind == "convolutional3d":
            return (self.depth, self.height, self.width, self.channels)
        if self.kind == "convolutionalFlat":
            return (self.height * self.width * self.channels,)
        raise ValueError(self.kind)

    def flat_size(self) -> int:
        return self.arrayElementsPerExample()
