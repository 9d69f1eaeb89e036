"""Image ops of the vision zoo: the part of
``deeplearning4j_tpu/ops/image.py`` (``:203-235``) that YOLO decoding
runs. Not registered by name (the port's registry holds them under
A10)."""

from __future__ import annotations

import torch


def non_max_suppression(boxes, scores, max_output_size: int,
                        iou_threshold: float = 0.5,
                        score_threshold: float = float("-inf")):
    """Greedy non-maximum suppression with a fixed output size.

    ``boxes`` ``[..., B, 4]`` as (y1, x1, y2, x2), ``scores`` ``[..., B]``;
    the leading axes are a batch of independent images. Returns
    ``(selected [..., K] int32, count [...] int32)``, ``K =
    max_output_size``, the unused slots -1. Each of the ``K`` steps takes
    the live box of highest score (the first index on a tie), keeps it if
    its score is above ``score_threshold`` (strictly), and kills every
    box whose IoU with it is above ``iou_threshold`` (and itself); once a
    step keeps nothing, nothing after it is kept. The reference's
    ``fori_loop`` as a Python loop of device ops over the whole batch:
    nothing in it waits for the device."""
    lead = boxes.shape[:-2]
    b = boxes.shape[-2]
    bx = boxes.reshape(-1, b, 4)
    sc = scores.reshape(-1, b).to(torch.float32)
    n, dev = bx.shape[0], bx.device
    rows = torch.arange(n, device=dev)
    area = torch.clamp(bx[..., 2] - bx[..., 0], min=0) \
        * torch.clamp(bx[..., 3] - bx[..., 1], min=0)
    sel = torch.full((n, max_output_size), -1, dtype=torch.int32,
                     device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    live = torch.ones((n, b), dtype=torch.bool, device=dev)
    neg = torch.tensor(float("-inf"), device=dev)
    for k in range(max_output_size):
        best = torch.argmax(torch.where(live, sc, neg), dim=-1)   # first max
        ok = live[rows, best] & (sc[rows, best] > score_threshold)
        sel[:, k] = torch.where(ok, best.to(torch.int32), -1)
        count += ok.to(torch.int32)
        top = bx[rows, best][:, None, :]                         # [n, 1, 4]
        y1 = torch.maximum(top[..., 0], bx[..., 0])
        x1 = torch.maximum(top[..., 1], bx[..., 1])
        y2 = torch.minimum(top[..., 2], bx[..., 2])
        x2 = torch.minimum(top[..., 3], bx[..., 3])
        inter = torch.clamp(y2 - y1, min=0) * torch.clamp(x2 - x1, min=0)
        iou = inter / torch.clamp(area[rows, best][:, None] + area - inter,
                                  min=1e-9)
        live = live & (iou <= iou_threshold)
        live[rows, best] = False
        live = live & ok[:, None]
    return sel.reshape(*lead, max_output_size), count.reshape(lead)


__all__ = ["non_max_suppression"]
