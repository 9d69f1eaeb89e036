"""YOLOv2: counterpart of ``deeplearning4j_tpu/zoo/yolo2.py`` (DL4J's
YOLO2: the Darknet-19 backbone of ``zoo.darknet19._ARCH`` as a
``ComputationGraph``, two 3x3 head convolutions, the passthrough route
(the stage-5 map before the last pool through a 1x1 conv to 64 channels,
``SpaceToDepthLayer(2)`` to the head's grid, concatenated with the head
by a ``MergeVertex``), a 3x3 conv, the detection conv and
``Yolo2OutputLayer`` with COCO's anchor priors; NHWC images). At 608 x
608 x 3 the grid is 19 x 19 and the output 19 x 19 x 425 for 80
classes."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn.conf import (
    BatchNormalization, ConvolutionLayer, InputType, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers_extra import SpaceToDepthLayer
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, MergeVertex)
from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.darknet19 import _ARCH

#: COCO anchor priors in grid units (YOLO2.java's DEFAULT_PRIORS)
DEFAULT_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253),
                   (3.33843, 5.47434), (7.88282, 3.52778),
                   (9.77052, 9.16828))


class YOLO2(ZooModel):
    def __init__(self, num_classes: int = 80, seed: int = 42,
                 updater=None, in_shape=(608, 608, 3),
                 anchors=DEFAULT_ANCHORS):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Nesterovs(1e-3, momentum=0.9)
        self.in_shape = in_shape
        self.anchors = anchors

    def _conv_bn(self, b, name, inp, n_out, kernel):
        b.addLayer(f"{name}_conv",
                   ConvolutionLayer(n_out=n_out,
                                    kernel_size=(kernel, kernel),
                                    convolution_mode="Same",
                                    activation="identity",
                                    has_bias=False), inp)
        b.addLayer(f"{name}_bn",
                   BatchNormalization(activation="leakyrelu"),
                   f"{name}_conv")
        return f"{name}_bn"

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.in_shape
        b = (ComputationGraphConfiguration.graphBuilder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        # the backbone; the passthrough taps the conv before the LAST pool
        last_pool = max(i for i, it in enumerate(_ARCH) if it == "M")
        x = "input"
        passthrough = None
        ci = pi = 0
        for i, item in enumerate(_ARCH):
            if item == "M":
                if i == last_pool:
                    passthrough = x
                pi += 1
                b.addLayer(f"p{pi}", SubsamplingLayer(
                    kernel_size=(2, 2), stride=(2, 2)), x)
                x = f"p{pi}"
            else:
                f, k = item
                ci += 1
                x = self._conv_bn(b, f"c{ci}", x, f, k)
        # the detection head's convolutions 19-20
        x = self._conv_bn(b, "c19", x, 1024, 3)
        x = self._conv_bn(b, "c20", x, 1024, 3)
        # passthrough: a 1x1 conv to 64 channels, then the reorg to the
        # head's grid
        pt = self._conv_bn(b, "c21_pt", passthrough, 64, 1)
        b.addLayer("reorg", SpaceToDepthLayer(block_size=2), pt)
        b.addVertex("route", MergeVertex(), "reorg", x)
        x = self._conv_bn(b, "c22", "route", 1024, 3)
        n_anchors = len(self.anchors)
        b.addLayer("det_conv",
                   ConvolutionLayer(
                       n_out=n_anchors * (5 + self.num_classes),
                       kernel_size=(1, 1), activation="identity"), x)
        b.addLayer("yolo",
                   Yolo2OutputLayer(anchors=self.anchors), "det_conv")
        return b.setOutputs("yolo").build()

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()
