"""Image ops (NHWC throughout): counterpart of
``deeplearning4j_tpu/ops/image.py`` (all 26 names), the reference's
resize family, crop_and_resize, non_max_suppression, colour-space
conversions, patches, flips and the bounding-box ops.

The resizes compute ``jax.image.resize``'s function, which
``F.interpolate`` does not: half-pixel sample centres, the triangle
kernel for bilinear and Keys' cubic kernel with a = -0.5 for bicubic
(torch's uses -0.75), no antialiasing but for ``resize_area`` (where the
kernel widens by the downscale factor), and nearest as ``floor((i + 0.5)
* in / out)`` in f32 (torch's ``nearest`` is the asymmetric rule). Each
resized axis gets ``jax.image``'s weight matrix (:func:`_weight_mat`,
``scale_and_translate``'s, in f32) and one contraction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.nn import _spatial_pads
from deeplearning4j_tpu_torch.ops.registry import register_op

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., 0., out)


def _weight_mat(in_size: int, out_size: int, kernel, antialias: bool,
                device) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for a plain resize: the
    ``[in, out]`` weights of each output sample, columns normalised to
    sum to one, zero where the sample falls outside the input."""
    f32 = dict(dtype=torch.float32, device=device)
    scale = out_size / in_size if out_size else 1.0
    inv_scale = torch.tensor(1. / scale, **f32)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, **f32)[:, None])
    if antialias:
        x = x / torch.clamp(inv_scale, min=1.)
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000. * _F32_EPS,
                    w / torch.where(total != 0, total, 1.), 0.)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.)


def _resize_axis(x, d: int, out_size: int, kernel, antialias: bool):
    w = _weight_mat(x.shape[d], out_size, kernel, antialias,
                    x.device).to(x.dtype)
    return torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)


def _resize_nearest(x, size):
    for d, n in ((1, int(size[0])), (2, int(size[1]))):
        m = x.shape[d]
        if m == n:
            continue
        off = (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) \
            * m / n
        idx = torch.floor(off).to(torch.int64).clamp(0, m - 1)
        x = torch.index_select(x, d, idx)
    return x


def _resize(x, size, kernel, antialias=False):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for d, n in ((1, int(size[0])), (2, int(size[1]))):
        if x.shape[d] != n:
            x = _resize_axis(x, d, n, kernel, antialias)
    return x


@register_op("resize_bilinear")
def resize_bilinear(x, size):
    return _resize(x, size, _triangle)


@register_op("resize_nearest_neighbor")
def resize_nearest_neighbor(x, size):
    return _resize_nearest(x, size)


@register_op("resize_bicubic")
def resize_bicubic(x, size):
    return _resize(x, size, _keys_cubic)


@register_op("resize_area")
def resize_area(x, size):
    """The triangle kernel widened by the downscale factor (``jax.image``
    linear with antialiasing), as JAX approximates TF's area kernel."""
    return _resize(x, size, _triangle, antialias=True)


@register_op("crop_and_resize")
def crop_and_resize(image, boxes, box_indices, crop_size,
                    method="bilinear"):
    """image [N,H,W,C]; boxes [B,4] normalized (y1,x1,y2,x2);
    box_indices [B] -> [B, ch, cw, C] (reference: crop_and_resize.cpp);
    every box at once, as JAX's ``vmap`` computes each."""
    h, w = image.shape[1], image.shape[2]
    ch, cw = int(crop_size[0]), int(crop_size[1])
    dev = image.device
    y1, x1, y2, x2 = (boxes[:, k:k + 1] for k in range(4))
    ry = torch.arange(ch, device=dev) / max(ch - 1, 1)
    rx = torch.arange(cw, device=dev) / max(cw - 1, 1)
    ys = y1 * (h - 1) + ry[None] * (y2 - y1) * (h - 1)           # [B, ch]
    xs = x1 * (w - 1) + rx[None] * (x2 - x1) * (w - 1)           # [B, cw]
    bi = jr.clamp_index(jr.index_tensor(box_indices, dev),
                        image.shape[0])[:, None, None]

    def pick(yi, xi):
        return image[bi, yi[:, :, None], xi[:, None, :]]

    if method == "nearest":
        yi = torch.clamp(torch.round(ys), 0, h - 1).to(torch.int64)
        xi = torch.clamp(torch.round(xs), 0, w - 1).to(torch.int64)
        return pick(yi, xi)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1).to(torch.int64)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1).to(torch.int64)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    top = pick(y0, x0) * (1 - wx) + pick(y0, x1i) * wx
    bot = pick(y1i, x0) * (1 - wx) + pick(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


@register_op("extract_image_patches")
def extract_image_patches(x, ksizes, strides, rates=(1, 1),
                          padding="VALID"):
    """[N,H,W,C] -> [N,OH,OW,kh*kw*C] (reference:
    extract_image_patches.cpp), each patch in (row, col, channel) order."""
    kh, kw = (int(k) for k in ksizes)
    s = tuple(int(v) for v in strides)
    r = tuple(int(v) for v in rates)
    (hl, hh), (wl, wh) = _spatial_pads(padding, x, (kh, kw), s, r)
    xc = F.pad(x.permute(0, 3, 1, 2), (wl, wh, hl, hh))
    cols = F.unfold(xc, (kh, kw), dilation=r, stride=s)  # [N, C*kh*kw, L]
    n, c = x.shape[0], x.shape[3]
    oh = (xc.shape[2] - (kh - 1) * r[0] - 1) // s[0] + 1
    ow = (xc.shape[3] - (kw - 1) * r[1] - 1) // s[1] + 1
    return cols.reshape(n, c, kh * kw, oh, ow).permute(0, 3, 4, 2, 1) \
        .reshape(n, oh, ow, kh * kw * c)


@register_op("image_flip_left_right")
def flip_left_right(x):
    return torch.flip(x, dims=(2,))


@register_op("image_flip_up_down")
def flip_up_down(x):
    return torch.flip(x, dims=(1,))


@register_op("adjust_brightness")
def adjust_brightness(x, delta):
    return x + delta


@register_op("adjust_contrast")
def adjust_contrast(x, factor):
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    return (x - mean) * factor + mean


@register_op("adjust_saturation")
def adjust_saturation(x, factor):
    h, s, v = _rgb_to_hsv_tuple(x)
    return _hsv_to_rgb_tuple(h, torch.clamp(s * factor, 0.0, 1.0), v)


@register_op("adjust_hue")
def adjust_hue(x, delta):
    h, s, v = _rgb_to_hsv_tuple(x)
    return _hsv_to_rgb_tuple(torch.remainder(h + delta, 1.0), s, v)


def _rgb_to_hsv_tuple(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.where(d == 0, 1.0, d)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(d == 0, 0.0, h) / 6.0
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return h, s, mx


def _hsv_to_rgb_tuple(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


@register_op("rgb_to_hsv")
def rgb_to_hsv(x):
    h, s, v = _rgb_to_hsv_tuple(x)
    return torch.stack([h, s, v], dim=-1)


@register_op("hsv_to_rgb")
def hsv_to_rgb(x):
    return _hsv_to_rgb_tuple(x[..., 0], x[..., 1], x[..., 2])


@register_op("rgb_to_grayscale")
def rgb_to_grayscale(x):
    w = torch.tensor([0.2989, 0.5870, 0.1140], dtype=x.dtype, device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


@register_op("rgb_to_yuv")
def rgb_to_yuv(x):
    m = torch.tensor([[0.299, -0.14714119, 0.61497538],
                      [0.587, -0.28886916, -0.51496512],
                      [0.114, 0.43601035, -0.10001026]], dtype=x.dtype,
                     device=x.device)
    return x @ m


@register_op("yuv_to_rgb")
def yuv_to_rgb(x):
    m = torch.tensor([[1.0, 1.0, 1.0],
                      [0.0, -0.394642334, 2.03206185],
                      [1.13988303, -0.58062185, 0.0]], dtype=x.dtype,
                     device=x.device)
    return x @ m


@register_op("non_max_suppression")
def non_max_suppression(boxes, scores, max_output_size,
                        iou_threshold=0.5, score_threshold=float("-inf")):
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
    max_output_size = int(max_output_size)
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


@register_op("central_crop")
def central_crop(img, fraction):
    """Keep the central fraction of H/W (TF semantics: trim
    int((d - d*fraction)/2) from each side, so odd extents keep the
    extra row/col)."""
    h, w = img.shape[-3], img.shape[-2]
    top = int((h - h * fraction) / 2)
    left = int((w - w * fraction) / 2)
    return img[..., top:h - top, left:w - left, :]


@register_op("per_image_standardization")
def per_image_standardization(img):
    axes = tuple(range(img.dim() - 3, img.dim()))
    m = torch.mean(img, dim=axes, keepdim=True)
    n = 1
    for a in axes:
        n *= img.shape[a]
    s = torch.std(img, dim=axes, keepdim=True, unbiased=False)
    floor = 1.0 / torch.sqrt(torch.tensor(float(n), dtype=s.dtype,
                                          device=s.device))
    return (img - m) / torch.maximum(s, floor)


@register_op("image_gradients")
def image_gradients(img):
    """(dy, dx) with zero last row/col, NHWC (TF parity)."""
    dy = F.pad(img[:, 1:] - img[:, :-1], (0, 0, 0, 0, 0, 1))
    dx = F.pad(img[:, :, 1:] - img[:, :, :-1], (0, 0, 0, 1))
    return dy, dx


@register_op("sobel_edges")
def sobel_edges(img):
    """[N,H,W,C,2] sobel (dy, dx) per channel, on the image reflect-padded
    by one (TF's rule)."""
    ky = torch.tensor([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=img.dtype,
                      device=img.device)
    c = img.shape[-1]
    # output channel 2 * ch + t holds input channel ch under kernel t
    k = torch.stack([ky, ky.T]).repeat(c, 1, 1)[:, None]      # [2C,1,3,3]
    padded = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    out = F.conv2d(padded, k, groups=c).permute(0, 2, 3, 1)
    return out.reshape(img.shape[:-1] + (c, 2))


@register_op("pad_to_bounding_box")
def pad_to_bounding_box(img, offset_h, offset_w, target_h, target_w):
    h, w = img.shape[-3], img.shape[-2]
    return F.pad(img, (0, 0, offset_w, target_w - w - offset_w,
                       offset_h, target_h - h - offset_h))


@register_op("crop_to_bounding_box")
def crop_to_bounding_box(img, offset_h, offset_w, target_h, target_w):
    return img[..., offset_h:offset_h + target_h,
               offset_w:offset_w + target_w, :]


@register_op("adjust_gamma")
def adjust_gamma(img, gamma=1.0, gain=1.0):
    return gain * img ** gamma


@register_op("image_translate")
def image_translate(img, dy, dx):
    """Integer translate with zero fill (host-static offsets)."""
    out = torch.roll(torch.roll(img, dy, dims=-3), dx, dims=-2)
    h, w = img.shape[-3], img.shape[-2]
    rows = torch.arange(h, device=img.device)
    cols = torch.arange(w, device=img.device)
    rmask = (rows >= dy) & (rows < h + dy) if dy >= 0 else \
        (rows < h + dy)
    cmask = (cols >= dx) & (cols < w + dx) if dx >= 0 else \
        (cols < w + dx)
    m = rmask[:, None] & cmask[None, :]
    return out * m[..., None].to(img.dtype)


__all__ = [
    "resize_bilinear", "resize_nearest_neighbor", "resize_bicubic",
    "resize_area", "crop_and_resize", "extract_image_patches",
    "flip_left_right", "flip_up_down", "adjust_brightness",
    "adjust_contrast", "adjust_saturation", "adjust_hue", "rgb_to_hsv",
    "hsv_to_rgb", "rgb_to_grayscale", "rgb_to_yuv", "yuv_to_rgb",
    "non_max_suppression", "central_crop", "per_image_standardization",
    "image_gradients", "sobel_edges", "pad_to_bounding_box",
    "crop_to_bounding_box", "adjust_gamma", "image_translate"]
