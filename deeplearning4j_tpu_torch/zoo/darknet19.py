"""Darknet-19: counterpart of ``deeplearning4j_tpu/zoo/darknet19.py``
(DL4J's Darknet19, the YOLOv2 backbone: conv + batch norm + leaky ReLU
stacks with 1x1 bottlenecks, a 1x1 classifier conv, global average
pooling and a softmax loss; NHWC images) through ``MultiLayerNetwork``.
``zoo.yolo2`` builds its backbone from the same ``_ARCH`` table."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn.conf import (
    BatchNormalization, ConvolutionLayer, GlobalPoolingLayer, InputType,
    LossLayer, NeuralNetConfiguration, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.base import ZooModel

#: (filters, kernel) per conv; "M" a 2x2 max pool (table 6 of the
#: YOLO9000 paper, as Darknet19.java has it)
_ARCH = [(32, 3), "M", (64, 3), "M", (128, 3), (64, 1), (128, 3), "M",
         (256, 3), (128, 1), (256, 3), "M",
         (512, 3), (256, 1), (512, 3), (256, 1), (512, 3), "M",
         (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)]


class Darknet19(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 42,
                 updater=None, in_shape=(224, 224, 3)):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Nesterovs(1e-3, momentum=0.9)
        self.in_shape = in_shape

    def conf(self):
        h, w, c = self.in_shape
        lb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(self.updater).weightInit("relu").list())
        for item in _ARCH:
            if item == "M":
                lb.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            else:
                f, k = item
                lb.layer(ConvolutionLayer(
                    n_out=f, kernel_size=(k, k), convolution_mode="Same",
                    activation="identity", has_bias=False))
                lb.layer(BatchNormalization(activation="leakyrelu"))
        lb.layer(ConvolutionLayer(n_out=self.num_classes, kernel_size=(1, 1),
                                  activation="identity"))
        lb.layer(GlobalPoolingLayer(pooling_type="avg"))
        # the reference ends in the pool and a softmax loss (no dense)
        lb.layer(LossLayer(activation="softmax", loss="mcxent"))
        return lb.setInputType(InputType.convolutional(h, w, c)).build()

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()
