"""Xception: counterpart of ``deeplearning4j_tpu/zoo/xception.py`` (DL4J's
Xception: depthwise-separable convolutions with linear residual
shortcuts in an entry, a middle and an exit flow; NHWC images) through
``ComputationGraph``. Each ``SeparableConvolution2D`` runs
``ops.nn.separable_conv2d``: a grouped (depthwise) cuDNN convolution,
then a 1x1 one."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    ActivationLayer, BatchNormalization, ConvolutionLayer,
    GlobalPoolingLayer, InputType, OutputLayer, SeparableConvolution2D,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, ElementWiseVertex)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class Xception(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 42,
                 updater=None, in_shape=(299, 299, 3),
                 middle_blocks: int = 8):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Adam(1e-3)
        self.in_shape = in_shape
        self.middle_blocks = middle_blocks

    def _conv_bn(self, b, name, inp, n_out, kernel, stride=(1, 1),
                 act="relu"):
        b.addLayer(f"{name}", ConvolutionLayer(
            n_out=n_out, kernel_size=kernel, stride=stride,
            convolution_mode="Same", activation="identity",
            has_bias=False), inp)
        b.addLayer(f"{name}_bn", BatchNormalization(activation=act),
                   name)
        return f"{name}_bn"

    def _sep_bn(self, b, name, inp, n_out, act="relu"):
        # n_in comes from the upstream input type at build()
        b.addLayer(name, SeparableConvolution2D(
            n_out=n_out, kernel_size=(3, 3),
            convolution_mode="Same", activation="identity",
            has_bias=False), inp)
        b.addLayer(f"{name}_bn", BatchNormalization(activation=act), name)
        return f"{name}_bn"

    def _entry_block(self, b, name, inp, n_out, first_relu=True):
        x = inp
        if first_relu:
            b.addLayer(f"{name}_pre", ActivationLayer(activation="relu"), x)
            x = f"{name}_pre"
        x = self._sep_bn(b, f"{name}_s1", x, n_out)
        x = self._sep_bn(b, f"{name}_s2", x, n_out, act="identity")
        b.addLayer(f"{name}_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode="Same"), x)
        short = self._conv_bn(b, f"{name}_short", inp, n_out, (1, 1),
                              (2, 2), act="identity")
        b.addVertex(f"{name}_add", ElementWiseVertex(op="Add"),
                    f"{name}_pool", short)
        return f"{name}_add", n_out

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.in_shape
        b = (ComputationGraphConfiguration.graphBuilder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        # the entry flow's stem
        x = self._conv_bn(b, "stem1", "input", 32, (3, 3), (2, 2))
        x = self._conv_bn(b, "stem2", x, 64, (3, 3))
        for name, n_out in [("entry1", 128), ("entry2", 256),
                            ("entry3", 728)]:
            x, _ = self._entry_block(b, name, x, n_out,
                                     first_relu=(name != "entry1"))
        # the middle flow: residual blocks of three separable convs at 728
        for i in range(self.middle_blocks):
            inp = x
            y = x
            for j in range(3):
                b.addLayer(f"mid{i}_relu{j}",
                           ActivationLayer(activation="relu"), y)
                y = self._sep_bn(b, f"mid{i}_s{j}", f"mid{i}_relu{j}",
                                 728, act="identity")
            b.addVertex(f"mid{i}_add", ElementWiseVertex(op="Add"), y, inp)
            x = f"mid{i}_add"
        # the exit flow
        b.addLayer("exit_pre", ActivationLayer(activation="relu"), x)
        y = self._sep_bn(b, "exit_s1", "exit_pre", 728)
        y = self._sep_bn(b, "exit_s2", y, 1024, act="identity")
        b.addLayer("exit_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode="Same"), y)
        short = self._conv_bn(b, "exit_short", x, 1024, (1, 1), (2, 2),
                              act="identity")
        b.addVertex("exit_add", ElementWiseVertex(op="Add"),
                    "exit_pool", short)
        y = self._sep_bn(b, "exit_s3", "exit_add", 1536)
        y = self._sep_bn(b, "exit_s4", y, 2048)
        b.addLayer("avg_pool", GlobalPoolingLayer(pooling_type="avg"), y)
        b.addLayer("fc", OutputLayer(n_out=self.num_classes,
                                     activation="softmax", loss="mcxent"),
                   "avg_pool")
        return b.setOutputs("fc").build()

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()
