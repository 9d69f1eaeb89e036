"""SimpleCNN: counterpart of ``deeplearning4j_tpu/zoo/simplecnn.py``
(DL4J's SimpleCNN: three conv + batch-norm stages, two max pools, a dense
layer of 128 with dropout and a softmax head; NHWC images) through
``MultiLayerNetwork``."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    BatchNormalization, ConvolutionLayer, DenseLayer, DropoutLayer,
    InputType, NeuralNetConfiguration, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class SimpleCNN(ZooModel):
    def __init__(self, num_classes: int = 10, seed: int = 1234,
                 updater=None, in_shape=(48, 48, 3)):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)
        self.in_shape = in_shape

    def conf(self):
        h, w, c = self.in_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self.updater).weightInit("relu")
                .list()
                .layer(ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                        convolution_mode="Same",
                                        activation="identity"))
                .layer(BatchNormalization(activation="relu"))
                .layer(ConvolutionLayer(n_out=32, kernel_size=(3, 3),
                                        convolution_mode="Same",
                                        activation="identity"))
                .layer(BatchNormalization(activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                        convolution_mode="Same",
                                        activation="identity"))
                .layer(BatchNormalization(activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=128, activation="relu"))
                .layer(DropoutLayer(rate=0.5))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()
