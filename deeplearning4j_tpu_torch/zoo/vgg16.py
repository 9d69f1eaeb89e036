"""VGG16: counterpart of ``deeplearning4j_tpu/zoo/vgg16.py`` (DL4J's
VGG16: five stages of 3x3 SAME convolutions with ReLU, each closed by a
2x2 max pool, two dense layers of 4096 and a softmax head; NHWC images)
through ``MultiLayerNetwork``. At 224 x 224 x 3 and 1000 classes it
holds 138,357,544 parameters."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer, DenseLayer, InputType, NeuralNetConfiguration,
    OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class VGG16(ZooModel):
    #: the stages, (width, convolutions); VGG19 overrides it
    plan = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

    def __init__(self, num_classes: int = 1000, seed: int = 42,
                 updater=None, in_shape=(224, 224, 3)):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Nesterovs(learning_rate=1e-2, momentum=0.9)
        self.in_shape = in_shape

    def conf(self):
        h, w, c = self.in_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .list())
        for n_out, reps in self.plan:
            for _ in range(reps):
                b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                         convolution_mode="Same",
                                         activation="relu"))
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        b.layer(DenseLayer(n_out=4096, activation="relu"))
        b.layer(DenseLayer(n_out=4096, activation="relu"))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss="mcxent"))
        return b.setInputType(InputType.convolutional(h, w, c)).build()

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()
