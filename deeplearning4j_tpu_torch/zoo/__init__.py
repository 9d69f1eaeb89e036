"""Model zoo (the ported subset): ``TextGenerationLSTM``, ``LeNet``,
``ResNet50`` and ``AlexNet``."""

from deeplearning4j_tpu_torch.zoo.alexnet import AlexNet
from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.resnet50 import ResNet50
from deeplearning4j_tpu_torch.zoo.textgen_lstm import TextGenerationLSTM

__all__ = ["ZooModel", "TextGenerationLSTM", "LeNet", "ResNet50", "AlexNet"]
