"""Input types: counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``.

The same tagged union with the same fields, so a configuration written
by the JAX side parses. Only ``feedForward`` and ``recurrent`` inputs
reach a ported layer; the image kinds parse but no ported layer takes
them yet, and the geometry helpers wait for the layers that need them.
"""

from __future__ import annotations

import dataclasses
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
