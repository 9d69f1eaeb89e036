"""LeNet-5: counterpart of ``deeplearning4j_tpu/zoo/lenet.py`` (DL4J's
LeNet: conv 5x5 x20, max pool, conv 5x5 x50, max pool, dense 500,
softmax; NHWC images) through ``MultiLayerNetwork``."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer, DenseLayer, InputType, NeuralNetConfiguration,
    OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class LeNet(ZooModel):
    def __init__(self, num_classes: int = 10, seed: int = 1234,
                 updater=None, in_shape=(28, 28, 1)):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)
        self.in_shape = in_shape

    def conf(self):
        h, w, c = self.in_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater)
                .weightInit("xavier")
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        stride=(1, 1), convolution_mode="Same",
                                        activation="relu"))
                .layer(SubsamplingLayer(pooling_type="max",
                                        kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        stride=(1, 1), convolution_mode="Same",
                                        activation="relu"))
                .layer(SubsamplingLayer(pooling_type="max",
                                        kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()
