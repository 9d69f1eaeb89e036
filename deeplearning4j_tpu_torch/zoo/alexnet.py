"""AlexNet: counterpart of ``deeplearning4j_tpu/zoo/alexnet.py`` (DL4J's
AlexNet, the one-weird-trick variant with local response normalization:
five convolutions, two LRN layers, three max pools, two dense layers of
4096 with dropout, and a softmax head; NHWC images) through
``MultiLayerNetwork``. At 224 x 224 x 3 and 1000 classes it holds
62,378,344 parameters, as the JAX model does."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer, DenseLayer, DropoutLayer, InputType,
    LocalResponseNormalization, NeuralNetConfiguration, OutputLayer,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class AlexNet(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 42,
                 updater=None, in_shape=(224, 224, 3)):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Nesterovs(learning_rate=1e-2, momentum=0.9)
        self.in_shape = in_shape

    def conf(self):
        h, w, c = self.in_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self.updater).weightInit("relu")
                .l2(5e-4)
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                        stride=(4, 4), convolution_mode="Same",
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                        convolution_mode="Same",
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="Same",
                                        activation="relu"))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="Same",
                                        activation="relu"))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                        convolution_mode="Same",
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(DropoutLayer(rate=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(DropoutLayer(rate=0.5))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()
