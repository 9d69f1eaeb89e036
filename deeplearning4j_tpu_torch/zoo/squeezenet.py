"""SqueezeNet v1.1: counterpart of ``deeplearning4j_tpu/zoo/squeezenet.py``
(DL4J's SqueezeNet: fire modules, a 1x1 squeeze then 1x1 and 3x3 expands
concatenated by a ``MergeVertex``, and a global-pool classifier; NHWC
images) through ``ComputationGraph``."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer, DropoutLayer, GlobalPoolingLayer, InputType, LossLayer,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, MergeVertex)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class SqueezeNet(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 42,
                 updater=None, in_shape=(227, 227, 3)):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Adam(1e-3)
        self.in_shape = in_shape

    def _fire(self, b, name, inp, squeeze, expand):
        b.addLayer(f"{name}_sq",
                   ConvolutionLayer(n_out=squeeze, kernel_size=(1, 1),
                                    activation="relu"), inp)
        b.addLayer(f"{name}_e1",
                   ConvolutionLayer(n_out=expand, kernel_size=(1, 1),
                                    activation="relu"), f"{name}_sq")
        b.addLayer(f"{name}_e3",
                   ConvolutionLayer(n_out=expand, kernel_size=(3, 3),
                                    convolution_mode="Same",
                                    activation="relu"), f"{name}_sq")
        b.addVertex(f"{name}_cat", MergeVertex(), f"{name}_e1", f"{name}_e3")
        return f"{name}_cat"

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.in_shape
        b = (ComputationGraphConfiguration.graphBuilder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        b.addLayer("conv1", ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                             stride=(2, 2),
                                             activation="relu"), "input")
        b.addLayer("pool1", SubsamplingLayer(kernel_size=(3, 3),
                                             stride=(2, 2)), "conv1")
        x = self._fire(b, "fire2", "pool1", 16, 64)
        x = self._fire(b, "fire3", x, 16, 64)
        b.addLayer("pool3", SubsamplingLayer(kernel_size=(3, 3),
                                             stride=(2, 2)), x)
        x = self._fire(b, "fire4", "pool3", 32, 128)
        x = self._fire(b, "fire5", x, 32, 128)
        b.addLayer("pool5", SubsamplingLayer(kernel_size=(3, 3),
                                             stride=(2, 2)), x)
        x = self._fire(b, "fire6", "pool5", 48, 192)
        x = self._fire(b, "fire7", x, 48, 192)
        x = self._fire(b, "fire8", x, 64, 256)
        x = self._fire(b, "fire9", x, 64, 256)
        b.addLayer("drop", DropoutLayer(rate=0.5), x)
        b.addLayer("conv10", ConvolutionLayer(n_out=self.num_classes,
                                              kernel_size=(1, 1),
                                              activation="relu"), "drop")
        b.addLayer("gap", GlobalPoolingLayer(pooling_type="avg"), "conv10")
        b.addLayer("out", LossLayer(activation="softmax", loss="mcxent"),
                   "gap")
        return b.setOutputs("out").build()

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()
