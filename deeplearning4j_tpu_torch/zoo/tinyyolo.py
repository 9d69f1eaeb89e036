"""Tiny YOLOv2: counterpart of ``deeplearning4j_tpu/zoo/tinyyolo.py``
(DL4J's TinyYOLO: a 9-conv Darknet backbone, conv + batch norm + leaky
ReLU, and ``Yolo2OutputLayer`` with 5 anchors on a 13x13 grid for VOC's
20 classes; NHWC images) through ``MultiLayerNetwork``."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    BatchNormalization, ConvolutionLayer, InputType, NeuralNetConfiguration,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.base import ZooModel

#: VOC anchor priors in grid units (TinyYOLO.java's DEFAULT_PRIORS)
DEFAULT_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                   (9.42, 5.11), (16.62, 10.52))


class TinyYOLO(ZooModel):
    def __init__(self, num_classes: int = 20, seed: int = 42, updater=None,
                 in_shape=(416, 416, 3), anchors=DEFAULT_ANCHORS):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Adam(1e-3)
        self.in_shape = in_shape
        self.anchors = anchors

    def conf(self):
        h, w, c = self.in_shape
        lb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(self.updater).weightInit("relu").list())
        filters = [16, 32, 64, 128, 256, 512]
        for i, f in enumerate(filters):
            lb.layer(ConvolutionLayer(n_out=f, kernel_size=(3, 3),
                                      convolution_mode="Same",
                                      activation="identity", has_bias=False))
            lb.layer(BatchNormalization(activation="leakyrelu"))
            # the sixth pool keeps the resolution (stride 1), as in the
            # reference
            stride = (2, 2) if i < 5 else (1, 1)
            lb.layer(SubsamplingLayer(kernel_size=(2, 2), stride=stride,
                                      convolution_mode="Same"))
        for f in (1024, 1024):
            lb.layer(ConvolutionLayer(n_out=f, kernel_size=(3, 3),
                                      convolution_mode="Same",
                                      activation="identity", has_bias=False))
            lb.layer(BatchNormalization(activation="leakyrelu"))
        depth = len(self.anchors) * (5 + self.num_classes)
        lb.layer(ConvolutionLayer(n_out=depth, kernel_size=(1, 1),
                                  activation="identity"))
        lb.layer(Yolo2OutputLayer(anchors=self.anchors))
        return lb.setInputType(InputType.convolutional(h, w, c)).build()

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()
