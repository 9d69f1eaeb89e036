"""YOLOv2 detection: counterpart of ``deeplearning4j_tpu/nn/conf/objdetect.py``
(all of it): :class:`Yolo2OutputLayer` (``:34-143``), the loss head of
``zoo.TinyYOLO`` and ``zoo.YOLO2``, and the decoding of its activations
into :class:`DetectedObject` lists by :class:`YoloUtils`
(``:159-267``).

Layouts as in the JAX package (NHWC): activations ``[N, H, W, B * (5 +
C)]``, labels ``[N, H, W, 4 + C]`` with the 4 the box corners (x1, y1,
x2, y2) in grid units and the C the one-hot class of the cell's object
(all zero: no object). The loss is plain PyTorch: no Pallas kernel
computes it in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LossLayer
from deeplearning4j_tpu_torch.ops.image import non_max_suppression


@serializable
@dataclasses.dataclass
class Yolo2OutputLayer(LossLayer):
    """Parameterless YOLOv2 loss head (a ``LossLayer``, so both networks
    take it as their terminal, and an f32 island under the mixed
    precision policies). ``anchors`` are (w, h) pairs in grid units; C
    comes from the labels' depth."""

    anchors: Tuple = ()
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    def __post_init__(self):
        super().__post_init__()
        self.anchors = tuple(tuple(a) for a in self.anchors)

    def output_type(self, it: InputType) -> InputType:
        return it

    def apply(self, params, state, x, train, generator):
        return x, state

    def _anchors(self, x) -> torch.Tensor:
        """``[B, 2]`` in x's dtype, on x's device."""
        return torch.tensor(self.anchors, dtype=x.dtype, device=x.device)

    # -- decoding --------------------------------------------------------
    def _decode(self, x, n_classes: int):
        """``[N, H, W, B * (5 + C)]`` -> (xy ``[N, H, W, B, 2]`` absolute
        grid coordinates: sigmoid offsets plus the cell's corner; wh
        ``[N, H, W, B, 2]`` in grid units: exp times the anchor; the
        objectness ``[N, H, W, B]`` after a sigmoid; the class logits
        ``[N, H, W, B, C]``)."""
        n, h, w, _ = x.shape
        b = len(self.anchors)
        x = x.reshape(n, h, w, b, 5 + n_classes)
        cy = torch.arange(h, dtype=x.dtype, device=x.device).reshape(
            1, h, 1, 1)
        cx = torch.arange(w, dtype=x.dtype, device=x.device).reshape(
            1, 1, w, 1)
        px = torch.sigmoid(x[..., 0]) + cx
        py = torch.sigmoid(x[..., 1]) + cy
        anchors = self._anchors(x)
        pw = torch.exp(x[..., 2]) * anchors[:, 0]
        ph = torch.exp(x[..., 3]) * anchors[:, 1]
        conf = torch.sigmoid(x[..., 4])
        return (torch.stack([px, py], -1), torch.stack([pw, ph], -1), conf,
                x[..., 5:])

    @staticmethod
    def _iou(xy1, wh1, xy2, wh2):
        """IoU of center-format boxes; broadcasts."""
        mins1, maxs1 = xy1 - wh1 / 2, xy1 + wh1 / 2
        mins2, maxs2 = xy2 - wh2 / 2, xy2 + wh2 / 2
        inter_min = torch.maximum(mins1, mins2)
        inter_max = torch.minimum(maxs1, maxs2)
        inter = torch.prod(torch.clamp(inter_max - inter_min, min=0.0), -1)
        a1 = torch.prod(wh1, -1)
        a2 = torch.prod(wh2, -1)
        return inter / torch.clamp(a1 + a2 - inter, min=1e-9)

    # -- the YOLOv2 loss -------------------------------------------------
    def loss_value(self, params, state, x, labels, mask=None):
        """The four YOLOv2 terms summed over the batch and divided by N:
        ``lambda_coord`` times the squared error of the centres and of the
        square roots of the sizes, the objectness against the live IoU
        (detached) on the responsible box and ``lambda_no_obj`` times the
        objectness squared on every other, and the class cross-entropy on
        the responsible box. The responsible box of a cell with an object
        is the anchor whose shape has the highest IoU with the object's
        (the first on a tie), a constant one-hot. A mask raises."""
        n, h, w, d = labels.shape
        n_classes = d - 4
        b = len(self.anchors)
        if x.shape[-1] != b * (5 + n_classes):
            raise ValueError(
                f"Yolo2OutputLayer: activations depth {x.shape[-1]} != "
                f"B*(5+C) = {b}*(5+{n_classes})")
        if mask is not None:
            raise NotImplementedError("Yolo2OutputLayer does not use masks")
        pxy, pwh, pconf, pcls = self._decode(x, n_classes)

        cls_1hot = labels[..., 4:]                          # [N,H,W,C]
        obj = (torch.sum(cls_1hot, -1) > 0).to(x.dtype)     # [N,H,W]
        x1, y1, x2, y2 = (labels[..., i] for i in range(4))
        gxy = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2], -1)
        gwh = torch.stack([torch.clamp(x2 - x1, min=1e-6),
                           torch.clamp(y2 - y1, min=1e-6)], -1)

        # anchor responsibility: IoU of the anchor shapes with the object's
        # shape, wherever it lies (as in the paper)
        anchors = self._anchors(x)
        zeros = torch.zeros_like(gwh)[..., None, :]         # [N,H,W,1,2]
        a_iou = self._iou(zeros, anchors.expand(gwh.shape[:-1] + (b, 2)),
                          zeros, gwh[..., None, :])
        resp = F.one_hot(torch.argmax(a_iou, -1), b).to(x.dtype) \
            * obj[..., None]                                # [N,H,W,B]

        # coordinates (square roots of the sizes, as in the paper)
        dxy = torch.sum((pxy - gxy[..., None, :]) ** 2, -1)
        dwh = torch.sum((torch.sqrt(pwh) - torch.sqrt(gwh[..., None, :]))
                        ** 2, -1)
        coord = self.lambda_coord * torch.sum(resp * (dxy + dwh))

        # objectness: the responsible box against its live IoU, the rest 0
        live_iou = self._iou(pxy, pwh, gxy[..., None, :],
                             gwh[..., None, :].expand(pwh.shape)).detach()
        conf_obj = torch.sum(resp * (pconf - live_iou) ** 2)
        conf_noobj = self.lambda_no_obj * torch.sum((1.0 - resp)
                                                    * pconf ** 2)

        # classes: softmax cross-entropy on the responsible box
        logp = F.log_softmax(pcls, -1)
        ce = -torch.sum(cls_1hot[..., None, :] * logp, -1)  # [N,H,W,B]
        cls_loss = torch.sum(resp * ce)

        return (coord + conf_obj + conf_noobj + cls_loss) / n


class DetectedObject:
    """One decoded detection. Coordinates are in grid units, as in the
    reference; multiply by a cell's size in pixels for image
    coordinates."""

    def __init__(self, center_x: float, center_y: float, width: float,
                 height: float, predicted_class: int, confidence: float,
                 class_probabilities=None):
        self.center_x = float(center_x)
        self.center_y = float(center_y)
        self.width = float(width)
        self.height = float(height)
        self.predicted_class = int(predicted_class)
        self.confidence = float(confidence)
        self.class_probabilities = class_probabilities

    def getCenterX(self):
        return self.center_x

    def getCenterY(self):
        return self.center_y

    def getWidth(self):
        return self.width

    def getHeight(self):
        return self.height

    def getPredictedClass(self):
        return self.predicted_class

    def getConfidence(self):
        return self.confidence

    def getTopLeftXY(self):
        return (self.center_x - self.width / 2,
                self.center_y - self.height / 2)

    def getBottomRightXY(self):
        return (self.center_x + self.width / 2,
                self.center_y + self.height / 2)

    def __repr__(self):
        return (f"DetectedObject(cls={self.predicted_class}, "
                f"conf={self.confidence:.3f}, xy=({self.center_x:.2f},"
                f"{self.center_y:.2f}), wh=({self.width:.2f},"
                f"{self.height:.2f}))")


class YoloUtils:
    """Detection decoding (the reference's ``YoloUtils``)."""

    @staticmethod
    def getPredictedObjects(layer: Yolo2OutputLayer, network_output,
                            conf_threshold: float = 0.5,
                            nms_threshold: float = 0.4,
                            max_objects: int = 50, device=None):
        """Per-image lists of :class:`DetectedObject` from raw ``[N, H, W,
        B * (5 + C)]`` activations: the sigmoid/exp decode, the objectness
        threshold (the threshold and ``confidence`` are the objectness, not
        objectness times the class probability, as in the reference), and
        greedy NMS per image (``ops.image.non_max_suppression`` over the
        whole batch at once), on the tensor's device (an array goes to
        ``device``: the CUDA card unless named); the results come to the
        host at the end."""
        if torch.is_tensor(network_output):
            x = network_output
        else:
            x = torch.as_tensor(network_output, device=resolve_device(device))
        n, h, w, d = x.shape
        b = len(layer.anchors)
        n_classes = d // b - 5
        if n_classes < 1 or d != b * (5 + n_classes):
            raise ValueError(
                f"output depth {d} is not B*(5+C) for B={b} anchors "
                f"(got C={n_classes}) — check the layer's anchors match "
                "the network")
        xy, wh, conf, cls_logits = layer._decode(x, n_classes)
        cls_prob = torch.softmax(cls_logits, dim=-1)

        xyf = xy.reshape(n, -1, 2)
        whf = wh.reshape(n, -1, 2)
        scf = conf.reshape(n, -1)
        boxes = torch.stack([xyf[..., 1] - whf[..., 1] / 2,   # y1
                             xyf[..., 0] - whf[..., 0] / 2,   # x1
                             xyf[..., 1] + whf[..., 1] / 2,   # y2
                             xyf[..., 0] + whf[..., 0] / 2],  # x2
                            dim=-1)                            # [N,HWB,4]
        sels, counts = non_max_suppression(boxes, scf, max_objects,
                                           nms_threshold, conf_threshold)
        # to the host in two copies: the floats, then the integers
        m = xyf.shape[1]
        f = torch.cat([xyf, whf, scf[..., None],
                       cls_prob.reshape(n, m, n_classes)], -1)
        f = f.to(torch.float32).cpu().numpy()
        xy_n, wh_n, score_n, prob_n = f[..., :2], f[..., 2:4], f[..., 4], \
            f[..., 5:]
        cls = torch.argmax(cls_prob, dim=-1).reshape(n, m)
        k = torch.cat([cls, sels.to(cls.dtype), counts[:, None].to(cls.dtype)],
                      -1).cpu().numpy()
        cls_n, sels_n, counts_n = k[:, :m], k[:, m:-1], k[:, -1]

        results = []
        for i in range(n):
            dets = []
            for j in sels_n[i][:int(counts_n[i])]:
                dets.append(DetectedObject(
                    xy_n[i, j, 0], xy_n[i, j, 1],
                    wh_n[i, j, 0], wh_n[i, j, 1],
                    int(cls_n[i, j]), float(score_n[i, j]),
                    prob_n[i, j].copy()))
            results.append(dets)
        return results


__all__ = ["Yolo2OutputLayer", "DetectedObject", "YoloUtils"]
