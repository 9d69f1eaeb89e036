"""Elementwise transforms: counterpart of the part of
``deeplearning4j_tpu/ops/transforms.py`` that the by-name path reaches.
Only ``relu`` (:29-31) is ported; the rest waits (ROADMAP A1)."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.registry import register_op


@register_op("relu")
def relu(x):
    return torch.relu(x)
