"""InceptionResNetV1 and FaceNetNN4Small2: counterpart of
``deeplearning4j_tpu/zoo/inception_resnet.py`` (DL4J's FaceNet embedding
models: a stem, 5 block35 (scale 0.17), reduction A, 10 block17 (0.10),
reduction B, 5 block8 (0.20), average pooling, a bottleneck embedding
L2-normalized by an ``L2NormalizeVertex``, and an optional softmax
classifier; inception branches joined by ``MergeVertex``, scaled
residuals by ``ScaleVertex`` and ``ElementWiseVertex``; NHWC images)
through ``ComputationGraph``."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    GlobalPoolingLayer, InputType, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, ElementWiseVertex,
    L2NormalizeVertex, MergeVertex, ScaleVertex)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class InceptionResNetV1(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 42,
                 updater=None, in_shape=(160, 160, 3),
                 embedding_size: int = 128,
                 blocks35: int = 5, blocks17: int = 10, blocks8: int = 5):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Adam(1e-3)
        self.in_shape = in_shape
        self.embedding_size = embedding_size
        self.blocks = (blocks35, blocks17, blocks8)

    def _cb(self, b, name, inp, n_out, kernel, stride=(1, 1), mode="Same",
            act="relu"):
        b.addLayer(name, ConvolutionLayer(
            n_out=n_out, kernel_size=kernel, stride=stride,
            convolution_mode=mode, activation="identity",
            has_bias=False), inp)
        b.addLayer(f"{name}_bn", BatchNormalization(activation=act), name)
        return f"{name}_bn"

    def _residual(self, b, name, inp, branch_out, n_channels, scale):
        """The merged branches' 1x1 projection, scaled, added to the
        input, then a ReLU."""
        up = self._cb(b, f"{name}_up", branch_out, n_channels, (1, 1),
                      act="identity")
        b.addVertex(f"{name}_scale", ScaleVertex(scale=scale), up)
        b.addVertex(f"{name}_add", ElementWiseVertex(op="Add"),
                    inp, f"{name}_scale")
        b.addLayer(f"{name}_out", ActivationLayer(activation="relu"),
                   f"{name}_add")
        return f"{name}_out"

    def _block35(self, b, name, inp):
        a = self._cb(b, f"{name}_b0", inp, 32, (1, 1))
        c1 = self._cb(b, f"{name}_b1a", inp, 32, (1, 1))
        c1 = self._cb(b, f"{name}_b1b", c1, 32, (3, 3))
        c2 = self._cb(b, f"{name}_b2a", inp, 32, (1, 1))
        c2 = self._cb(b, f"{name}_b2b", c2, 32, (3, 3))
        c2 = self._cb(b, f"{name}_b2c", c2, 32, (3, 3))
        b.addVertex(f"{name}_cat", MergeVertex(), a, c1, c2)
        return self._residual(b, name, inp, f"{name}_cat", 256, 0.17)

    def _block17(self, b, name, inp):
        a = self._cb(b, f"{name}_b0", inp, 128, (1, 1))
        c = self._cb(b, f"{name}_b1a", inp, 128, (1, 1))
        c = self._cb(b, f"{name}_b1b", c, 128, (1, 7))
        c = self._cb(b, f"{name}_b1c", c, 128, (7, 1))
        b.addVertex(f"{name}_cat", MergeVertex(), a, c)
        return self._residual(b, name, inp, f"{name}_cat", 896, 0.10)

    def _block8(self, b, name, inp):
        a = self._cb(b, f"{name}_b0", inp, 192, (1, 1))
        c = self._cb(b, f"{name}_b1a", inp, 192, (1, 1))
        c = self._cb(b, f"{name}_b1b", c, 192, (1, 3))
        c = self._cb(b, f"{name}_b1c", c, 192, (3, 1))
        b.addVertex(f"{name}_cat", MergeVertex(), a, c)
        return self._residual(b, name, inp, f"{name}_cat", 1792, 0.20)

    def _reduction_a(self, b, inp):
        p = "redA_pool"
        b.addLayer(p, SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)),
                   inp)
        c1 = self._cb(b, "redA_b1", inp, 384, (3, 3), (2, 2),
                      mode="Truncate")
        c2 = self._cb(b, "redA_b2a", inp, 192, (1, 1))
        c2 = self._cb(b, "redA_b2b", c2, 192, (3, 3))
        c2 = self._cb(b, "redA_b2c", c2, 256, (3, 3), (2, 2),
                      mode="Truncate")
        b.addVertex("redA_cat", MergeVertex(), p, c1, c2)
        return "redA_cat"

    def _reduction_b(self, b, inp):
        p = "redB_pool"
        b.addLayer(p, SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)),
                   inp)
        c1 = self._cb(b, "redB_b1a", inp, 256, (1, 1))
        c1 = self._cb(b, "redB_b1b", c1, 384, (3, 3), (2, 2),
                      mode="Truncate")
        c2 = self._cb(b, "redB_b2a", inp, 256, (1, 1))
        c2 = self._cb(b, "redB_b2b", c2, 256, (3, 3), (2, 2),
                      mode="Truncate")
        c3 = self._cb(b, "redB_b3a", inp, 256, (1, 1))
        c3 = self._cb(b, "redB_b3b", c3, 256, (3, 3))
        c3 = self._cb(b, "redB_b3c", c3, 256, (3, 3), (2, 2),
                      mode="Truncate")
        b.addVertex("redB_cat", MergeVertex(), p, c1, c2, c3)
        return "redB_cat"

    def conf(self, classifier: bool = True) -> ComputationGraphConfiguration:
        h, w, c = self.in_shape
        b = (ComputationGraphConfiguration.graphBuilder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        # the stem
        x = self._cb(b, "stem1", "input", 32, (3, 3), (2, 2),
                     mode="Truncate")
        x = self._cb(b, "stem2", x, 32, (3, 3), mode="Truncate")
        x = self._cb(b, "stem3", x, 64, (3, 3))
        b.addLayer("stem_pool", SubsamplingLayer(kernel_size=(3, 3),
                                                 stride=(2, 2)), x)
        x = self._cb(b, "stem4", "stem_pool", 80, (1, 1), mode="Truncate")
        x = self._cb(b, "stem5", x, 192, (3, 3), mode="Truncate")
        x = self._cb(b, "stem6", x, 256, (3, 3), (2, 2), mode="Truncate")
        n35, n17, n8 = self.blocks
        for i in range(n35):
            x = self._block35(b, f"b35_{i}", x)
        x = self._reduction_a(b, x)
        for i in range(n17):
            x = self._block17(b, f"b17_{i}", x)
        x = self._reduction_b(b, x)
        for i in range(n8):
            x = self._block8(b, f"b8_{i}", x)
        b.addLayer("avg_pool", GlobalPoolingLayer(pooling_type="avg"), x)
        b.addLayer("bottleneck",
                   DenseLayer(n_out=self.embedding_size,
                              activation="identity"), "avg_pool")
        b.addVertex("embeddings", L2NormalizeVertex(), "bottleneck")
        if classifier:
            b.addLayer("out", OutputLayer(n_out=self.num_classes,
                                          activation="softmax",
                                          loss="mcxent"), "embeddings")
            return b.setOutputs("out").build()
        return b.setOutputs("embeddings").build()

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()


class FaceNetNN4Small2(ZooModel):
    """DL4J's FaceNetNN4Small2, the compact NN4 FaceNet: InceptionResNetV1's
    block builders with 2 block35, 4 block17 and 2 block8, at 96 x 96 x 3
    with a 128-d L2-normalized embedding."""

    def __init__(self, num_classes: int = 1000, seed: int = 42,
                 updater=None, in_shape=(96, 96, 3),
                 embedding_size: int = 128):
        self.inner = InceptionResNetV1(
            num_classes=num_classes, seed=seed, updater=updater,
            in_shape=in_shape, embedding_size=embedding_size,
            blocks35=2, blocks17=4, blocks8=2)
        self.num_classes = num_classes
        self.seed = seed
        self.updater = self.inner.updater
        self.in_shape = in_shape
        self.embedding_size = embedding_size

    def conf(self, classifier: bool = True):
        return self.inner.conf(classifier=classifier)

    def init(self, device=None) -> ComputationGraph:
        return self.inner.init(device=device)
