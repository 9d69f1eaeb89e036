"""VGG19: counterpart of ``deeplearning4j_tpu/zoo/vgg19.py`` (VGG16 with
four convolutions in each of the last three stages)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.zoo.vgg16 import VGG16


class VGG19(VGG16):
    plan = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
