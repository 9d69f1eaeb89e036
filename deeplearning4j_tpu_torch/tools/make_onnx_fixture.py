"""The committed ResNet-50 ONNX fixture of the ONNX importer, and how to
make it again.

``resnet50.onnx.gz`` (beside the importer) is torchvision's ResNet-50
architecture (built here inline: 25,557,032 parameters, 1,000 classes)
exported by ``torch.onnx.export`` at opset 13, without constant folding,
with a dynamic batch axis on ``input`` ``[N, 3, 224, 224]`` and
``logits`` ``[N, 1000]``: 175 nodes and 267 initializers under their
state-dict keys, every float initializer emptied (the whole model is
~102 MB). ``onnx_proto.seeded_model(fixture, SEED)`` fills them with
``onnx_proto.seeded_initializers``' draws and gives the whole model back.

Before the export every batch norm's statistics and affine parameters
are drawn at random: the exporter merges initializers of equal value
(the default ones and zeros) and renames them, which would lose the
state-dict keys.

``resnet50.golden.npz`` holds torch's own eval-mode run of the seeded
model on :func:`golden_input` (2 x 3 x 224 x 224): the logits, each
row's sum, and the counts of nodes, initializers and whole-model bytes.

Regenerate both (torch with its ONNX exporter; nothing is downloaded)::

    python -m deeplearning4j_tpu_torch.tools.make_onnx_fixture

This is the one module of the port that imports ``torch.onnx``, inside
:func:`main`; the rest of it only builds the module and reads the files.
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import torch
from torch import nn

HERE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "modelimport", "onnx")
FIXTURE = os.path.join(HERE, "resnet50.onnx.gz")
GOLDEN = os.path.join(HERE, "resnet50.golden.npz")
#: the seed of the fixture's weights and of the golden input
SEED = 23
BATCH, HW, CLASSES = 2, 224, 1000


class Bottleneck(nn.Module):
    """torchvision.models.resnet.Bottleneck (stride on the 3x3)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + idn)


class ResNet50(nn.Module):
    """torchvision.models.resnet50's architecture and state-dict keys."""

    def __init__(self, num_classes: int = CLASSES):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for i, (planes, blocks, stride) in enumerate(
                ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, planes, stride if b == 0 else 1))
                cin = planes * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.fc(torch.flatten(self.avgpool(x), 1))


def golden_input(seed: int = SEED) -> np.ndarray:
    """The golden batch: ``default_rng([seed, 1])`` normals, NCHW."""
    return np.random.default_rng([seed, 1]).standard_normal(
        (BATCH, 3, HW, HW), dtype=np.float32)


def load_fixture() -> tuple:
    """``(the emptied model's bytes, the golden arrays by name)``."""
    with gzip.open(FIXTURE, "rb") as f:
        small = f.read()
    with np.load(GOLDEN, allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    return small, golden


def main() -> int:
    import io

    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    from deeplearning4j_tpu_torch.modelimport.onnx import onnx_proto

    # the TorchScript exporter needs the `onnx` package only to splice
    # onnxscript functions into the proto; this model has none
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, opsets: \
        model_bytes
    torch.manual_seed(SEED)
    model = ResNet50().eval()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2)
                mod.running_var.uniform_(0.6, 1.4)
                mod.weight.uniform_(0.8, 1.2)
                mod.bias.uniform_(-0.1, 0.1)
    buf = io.BytesIO()
    with torch.no_grad():
        torch.onnx.export(
            model, (torch.zeros(BATCH, 3, HW, HW),), buf, dynamo=False,
            opset_version=13, do_constant_folding=False,
            input_names=["input"], output_names=["logits"],
            dynamic_axes={"input": {0: "batch"}, "logits": {0: "batch"}})
    whole = buf.getvalue()
    small = onnx_proto.empty_initializers(whole)
    with open(FIXTURE, "wb") as fh:
        with gzip.GzipFile(fileobj=fh, mode="wb", mtime=0) as z:
            z.write(small)

    weights = onnx_proto.seeded_initializers(small, SEED)
    state = model.state_dict()
    assert set(weights) <= set(state), sorted(set(weights) - set(state))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()}, strict=False)
    full = onnx_proto.fill_initializers(small, weights)
    g = onnx_proto.decode_model(full).graph
    x = golden_input()
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    np.savez(GOLDEN, logits=logits.astype(np.float32),
             row_sums=logits.sum(-1, dtype=np.float64).astype(np.float32),
             input=np.asarray(g.inputs[0].name),
             output=np.asarray(g.outputs[0].name), seed=np.asarray(SEED),
             nodes=np.asarray(len(g.nodes)),
             initializers=np.asarray(len(g.initializers)),
             whole_bytes=np.asarray(len(full), np.int64))
    print(f"{len(g.nodes)} nodes, {len(g.initializers)} initializers "
          f"({len(weights)} seeded); {len(small)} B "
          f"({os.path.getsize(FIXTURE)} B gzipped), {len(full)} B whole; "
          f"logits {logits.shape}, max |logit| {np.abs(logits).max():.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
