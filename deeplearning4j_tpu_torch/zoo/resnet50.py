"""ResNet-50: counterpart of ``deeplearning4j_tpu/zoo/resnet50.py``
(DL4J's ResNet50: a ``ComputationGraph`` of bottleneck blocks joined by
``ElementWiseVertex`` adds; NHWC images), with the same block builders
and node names (``stem``, ``res2a_2a``, ..., ``fc``), so a JAX graph's
parameters load by name."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn.conf import (
    ActivationLayer, BatchNormalization, ConvolutionLayer,
    GlobalPoolingLayer, InputType, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, ElementWiseVertex)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class ResNet50(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 42,
                 updater=None, in_shape=(224, 224, 3), precision=None):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Nesterovs(learning_rate=1e-1, momentum=0.9)
        self.in_shape = in_shape
        #: the precision policy (a preset name or an
        #: ``nn.precision.PrecisionPolicy``)
        self.precision = precision

    # -- block builders --------------------------------------------------
    def _conv_bn(self, b, name, inp, n_out, kernel, stride=(1, 1),
                 mode="Same", act="relu"):
        b.addLayer(f"{name}_conv",
                   ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                                    stride=stride, convolution_mode=mode,
                                    activation="identity", has_bias=False),
                   inp)
        b.addLayer(f"{name}_bn",
                   BatchNormalization(activation=act), f"{name}_conv")
        return f"{name}_bn"

    def _bottleneck(self, b, name, inp, filters, stride, downsample):
        f1, f2, f3 = filters
        x = self._conv_bn(b, f"{name}_2a", inp, f1, (1, 1), stride)
        x = self._conv_bn(b, f"{name}_2b", x, f2, (3, 3))
        x = self._conv_bn(b, f"{name}_2c", x, f3, (1, 1), act="identity")
        if downsample:
            short = self._conv_bn(b, f"{name}_1", inp, f3, (1, 1), stride,
                                  act="identity")
        else:
            short = inp
        b.addVertex(f"{name}_add", ElementWiseVertex(op="Add"), x, short)
        b.addLayer(f"{name}_out", ActivationLayer(activation="relu"),
                   f"{name}_add")
        return f"{name}_out"

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.in_shape
        b = (ComputationGraphConfiguration.graphBuilder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .l2(1e-4).precision(self.precision)
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        # stem
        x = self._conv_bn(b, "stem", "input", 64, (7, 7), (2, 2))
        b.addLayer("stem_pool",
                   SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                    convolution_mode="Same"), x)
        x = "stem_pool"
        # stages: (filters, blocks, first stride)
        stages = [((64, 64, 256), 3, (1, 1)),
                  ((128, 128, 512), 4, (2, 2)),
                  ((256, 256, 1024), 6, (2, 2)),
                  ((512, 512, 2048), 3, (2, 2))]
        for si, (filters, blocks, stride) in enumerate(stages, start=2):
            for bi in range(blocks):
                blk = f"res{si}{chr(ord('a') + bi)}"
                x = self._bottleneck(b, blk, x, filters,
                                     stride if bi == 0 else (1, 1),
                                     downsample=(bi == 0))
        b.addLayer("avg_pool", GlobalPoolingLayer(pooling_type="avg"), x)
        b.addLayer("fc", OutputLayer(n_out=self.num_classes,
                                     activation="softmax", loss="mcxent"),
                   "avg_pool")
        return b.setOutputs("fc").build()

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()


def cut_resnet_conf() -> ComputationGraphConfiguration:
    """ResNet-50 cut to one stage of two blocks, for parity runs at a small
    size: 32 x 32 x 3 input, the stem (7x7/2 conv at 8 channels, batch
    norm, ReLU, the 3x3/2 max pool), one projection block of stride 2 and
    one identity block (filters 8, 8, 32), global average pooling and a
    4-class softmax head; the zoo model's block builders, seed 3,
    ``weightInit("relu")``, ``l2(1e-4)`` and ``Nesterovs(0.05, 0.9)``."""
    z = ResNet50()
    filters = (8, 8, 32)
    b = (ComputationGraphConfiguration.graphBuilder()
         .seed(3).updater(Nesterovs(0.05, 0.9))
         .weightInit("relu").l2(1e-4).addInputs("input")
         .setInputTypes(InputType.convolutional(32, 32, 3)))
    x = z._conv_bn(b, "stem", "input", filters[0], (7, 7), (2, 2))
    b.addLayer("stem_pool", SubsamplingLayer(kernel_size=(3, 3),
                                             stride=(2, 2),
                                             convolution_mode="Same"), x)
    x = z._bottleneck(b, "res2a", "stem_pool", filters, (2, 2), True)
    x = z._bottleneck(b, "res2b", x, filters, (1, 1), False)
    b.addLayer("avg_pool", GlobalPoolingLayer(pooling_type="avg"), x)
    b.addLayer("fc", OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"), "avg_pool")
    return b.setOutputs("fc").build()
