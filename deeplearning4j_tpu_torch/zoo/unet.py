"""U-Net: counterpart of ``deeplearning4j_tpu/zoo/unet.py`` (DL4J's UNet:
an encoder-decoder ``ComputationGraph`` of double 3x3 convolutions, max
pools on the way down, ``Upsampling2D`` and a 2x2 conv on the way up,
``MergeVertex`` skips, and a 1-channel sigmoid head under a per-pixel
binary cross-entropy; NHWC images)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    CnnLossLayer, ConvolutionLayer, InputType, SubsamplingLayer,
    Upsampling2D)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, MergeVertex)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class UNet(ZooModel):
    def __init__(self, seed: int = 42, updater=None,
                 in_shape=(512, 512, 3), base_filters: int = 64,
                 depth: int = 4):
        self.seed = seed
        self.updater = updater or Adam(1e-4)
        self.in_shape = in_shape
        self.base_filters = base_filters
        self.depth = depth

    def _double_conv(self, b, name, inp, n_out):
        b.addLayer(f"{name}_c1",
                   ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                    convolution_mode="Same",
                                    activation="relu"), inp)
        b.addLayer(f"{name}_c2",
                   ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                    convolution_mode="Same",
                                    activation="relu"), f"{name}_c1")
        return f"{name}_c2"

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.in_shape
        b = (ComputationGraphConfiguration.graphBuilder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        skips = []
        x = "input"
        f = self.base_filters
        for d in range(self.depth):
            x = self._double_conv(b, f"enc{d}", x, f * (2 ** d))
            skips.append(x)
            b.addLayer(f"pool{d}",
                       SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
                       x)
            x = f"pool{d}"
        x = self._double_conv(b, "bottom", x, f * (2 ** self.depth))
        for d in reversed(range(self.depth)):
            b.addLayer(f"up{d}", Upsampling2D(size=2), x)
            b.addLayer(f"upc{d}",
                       ConvolutionLayer(n_out=f * (2 ** d),
                                        kernel_size=(2, 2),
                                        convolution_mode="Same",
                                        activation="relu"), f"up{d}")
            b.addVertex(f"skip{d}", MergeVertex(), skips[d], f"upc{d}")
            x = self._double_conv(b, f"dec{d}", f"skip{d}", f * (2 ** d))
        b.addLayer("head",
                   ConvolutionLayer(n_out=1, kernel_size=(1, 1),
                                    activation="identity"), x)
        b.addLayer("out", CnnLossLayer(loss="xent", activation="sigmoid"),
                   "head")
        return b.setOutputs("out").build()

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()
