"""NASNet-A: counterpart of ``deeplearning4j_tpu/zoo/nasnet.py`` (DL4J's
NASNet, Zoph et al. 2018, the Mobile layout: a ``ComputationGraph`` of
normal and reduction cells; each cell adjusts its two inputs (the last
two hidden states) to its width with a 1x1 conv and batch norm, sums
five pairs of branches (stacks of ReLU, ``SeparableConvolution2D`` 3x3,
5x5 or 7x7 and batch norm, 3x3 pools, identities) and concatenates the
sums; reduction cells stride their first branches by 2; NHWC images).
Three stages of ``num_cells`` normal cells at 1x, 2x and 4x
``penultimate_filters // 24`` channels (44 at the default 1056), with a
reduction cell between stages."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    ActivationLayer, BatchNormalization, ConvolutionLayer,
    GlobalPoolingLayer, InputType, OutputLayer, SeparableConvolution2D,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, ElementWiseVertex,
    MergeVertex)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class NASNet(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 42,
                 updater=None, in_shape=(224, 224, 3), num_cells: int = 4,
                 penultimate_filters: int = 1056, stem_filters: int = 32):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Adam(1e-3)
        self.in_shape = in_shape
        self.num_cells = num_cells
        # NASNet-A mobile: penultimate = 24 * filters
        self.filters = max(penultimate_filters // 24, 4)
        self.stem_filters = stem_filters

    # -- branches ----------------------------------------------------------
    def _sep(self, b, name, inp, n_out, kernel, stride=(1, 1)):
        """ReLU, separable conv, batch norm (ReLU), separable conv, batch
        norm: NASNet's separable stack."""
        b.addLayer(f"{name}_relu", ActivationLayer(activation="relu"), inp)
        b.addLayer(f"{name}_s1", SeparableConvolution2D(
            n_out=n_out, kernel_size=kernel, stride=stride,
            convolution_mode="Same", activation="identity", has_bias=False),
            f"{name}_relu")
        b.addLayer(f"{name}_bn1", BatchNormalization(activation="relu"),
                   f"{name}_s1")
        b.addLayer(f"{name}_s2", SeparableConvolution2D(
            n_out=n_out, kernel_size=kernel, stride=(1, 1),
            convolution_mode="Same", activation="identity", has_bias=False),
            f"{name}_bn1")
        b.addLayer(f"{name}_bn2", BatchNormalization(), f"{name}_s2")
        return f"{name}_bn2"

    def _adjust(self, b, name, inp, n_out, stride=(1, 1)):
        """ReLU, 1x1 conv and batch norm to the cell's width."""
        b.addLayer(f"{name}_relu", ActivationLayer(activation="relu"), inp)
        b.addLayer(f"{name}_conv", ConvolutionLayer(
            n_out=n_out, kernel_size=(1, 1), stride=stride,
            convolution_mode="Same", activation="identity", has_bias=False),
            f"{name}_relu")
        b.addLayer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
        return f"{name}_bn"

    def _avgpool(self, b, name, inp, stride=(1, 1)):
        b.addLayer(name, SubsamplingLayer(
            pooling_type="avg", kernel_size=(3, 3), stride=stride,
            convolution_mode="Same"), inp)
        return name

    def _maxpool(self, b, name, inp, stride=(1, 1)):
        b.addLayer(name, SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=stride,
            convolution_mode="Same"), inp)
        return name

    def _add(self, b, name, x1, x2):
        b.addVertex(name, ElementWiseVertex(op="Add"), x1, x2)
        return name

    # -- cells -------------------------------------------------------------
    def _normal_cell(self, b, name, h, h_prev, f):
        hp = self._adjust(b, f"{name}_adj", h, f)
        pp = self._adjust(b, f"{name}_adjp", h_prev, f)
        b1 = self._add(b, f"{name}_b1",
                       self._sep(b, f"{name}_b1l", hp, f, (5, 5)),
                       self._sep(b, f"{name}_b1r", pp, f, (3, 3)))
        b2 = self._add(b, f"{name}_b2",
                       self._sep(b, f"{name}_b2l", pp, f, (5, 5)),
                       self._sep(b, f"{name}_b2r", pp, f, (3, 3)))
        b3 = self._add(b, f"{name}_b3",
                       self._avgpool(b, f"{name}_b3l", hp), pp)
        b4 = self._add(b, f"{name}_b4",
                       self._avgpool(b, f"{name}_b4l", pp),
                       self._avgpool(b, f"{name}_b4r", pp))
        b5 = self._add(b, f"{name}_b5",
                       self._sep(b, f"{name}_b5l", hp, f, (3, 3)), hp)
        b.addVertex(f"{name}_out", MergeVertex(), b1, b2, b3, b4, b5)
        return f"{name}_out"

    def _reduction_cell(self, b, name, h, h_prev, f):
        hp = self._adjust(b, f"{name}_adj", h, f)
        pp = self._adjust(b, f"{name}_adjp", h_prev, f, stride=(2, 2))
        b1 = self._add(b, f"{name}_b1",
                       self._sep(b, f"{name}_b1l", hp, f, (5, 5), (2, 2)),
                       self._sep(b, f"{name}_b1r", hp, f, (7, 7), (2, 2)))
        b2 = self._add(b, f"{name}_b2",
                       self._maxpool(b, f"{name}_b2l", hp, (2, 2)),
                       self._sep(b, f"{name}_b2r", hp, f, (7, 7), (2, 2)))
        b3 = self._add(b, f"{name}_b3",
                       self._avgpool(b, f"{name}_b3l", hp, (2, 2)),
                       self._sep(b, f"{name}_b3r", hp, f, (5, 5), (2, 2)))
        # the second stage's branches at the reduced resolution
        b4 = self._add(b, f"{name}_b4",
                       self._maxpool(b, f"{name}_b4l", hp, (2, 2)),
                       self._sep(b, f"{name}_b4r", b1, f, (3, 3)))
        b5 = self._add(b, f"{name}_b5",
                       self._avgpool(b, f"{name}_b5l", b1), pp)
        b.addVertex(f"{name}_out", MergeVertex(), b2, b3, b4, b5)
        return f"{name}_out"

    # -- the graph ---------------------------------------------------------
    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.in_shape
        f = self.filters
        b = (ComputationGraphConfiguration.graphBuilder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        b.addLayer("stem_conv", ConvolutionLayer(
            n_out=self.stem_filters, kernel_size=(3, 3), stride=(2, 2),
            convolution_mode="Same", activation="identity", has_bias=False),
            "input")
        b.addLayer("stem_bn", BatchNormalization(), "stem_conv")
        prev, cur = "stem_bn", "stem_bn"
        # num_cells normal cells per stage at 1x, 2x and 4x the width, a
        # reduction cell between stages
        for stage in range(3):
            mult = 2 ** stage
            for i in range(self.num_cells):
                nxt = self._normal_cell(b, f"s{stage}_n{i}", cur, prev,
                                        f * mult)
                prev, cur = cur, nxt
            if stage < 2:
                nxt = self._reduction_cell(b, f"s{stage}_r", cur, prev,
                                           f * mult * 2)
                # both inputs of the next cell at the new resolution: the
                # reduction's output twice
                prev, cur = nxt, nxt
        b.addLayer("final_relu", ActivationLayer(activation="relu"), cur)
        b.addLayer("avg_pool", GlobalPoolingLayer(pooling_type="avg"),
                   "final_relu")
        b.addLayer("fc", OutputLayer(n_out=self.num_classes,
                                     activation="softmax", loss="mcxent"),
                   "avg_pool")
        return b.setOutputs("fc").build()

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()
