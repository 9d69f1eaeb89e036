"""Model zoo (the ported subset): ``TextGenerationLSTM``, ``LeNet``,
``ResNet50``, ``AlexNet``, and the vision zoo ``SimpleCNN``, ``VGG16``,
``VGG19``, ``Darknet19``, ``TinyYOLO``, ``YOLO2``, ``SqueezeNet``,
``UNet``, ``Xception``, ``InceptionResNetV1``, ``FaceNetNN4Small2`` and
``NASNet``, as architectures: ``initPretrained()`` takes a local zip,
since nothing is downloaded."""

from deeplearning4j_tpu_torch.zoo.alexnet import AlexNet
from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.darknet19 import Darknet19
from deeplearning4j_tpu_torch.zoo.inception_resnet import (
    FaceNetNN4Small2, InceptionResNetV1)
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.nasnet import NASNet
from deeplearning4j_tpu_torch.zoo.resnet50 import ResNet50
from deeplearning4j_tpu_torch.zoo.simplecnn import SimpleCNN
from deeplearning4j_tpu_torch.zoo.squeezenet import SqueezeNet
from deeplearning4j_tpu_torch.zoo.textgen_lstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.zoo.tinyyolo import TinyYOLO
from deeplearning4j_tpu_torch.zoo.unet import UNet
from deeplearning4j_tpu_torch.zoo.vgg16 import VGG16
from deeplearning4j_tpu_torch.zoo.vgg19 import VGG19
from deeplearning4j_tpu_torch.zoo.xception import Xception
from deeplearning4j_tpu_torch.zoo.yolo2 import YOLO2

__all__ = ["ZooModel", "TextGenerationLSTM", "LeNet", "ResNet50", "AlexNet",
           "SimpleCNN", "VGG16", "VGG19", "Darknet19", "TinyYOLO", "YOLO2",
           "SqueezeNet", "UNet", "Xception", "InceptionResNetV1",
           "FaceNetNN4Small2", "NASNet"]
