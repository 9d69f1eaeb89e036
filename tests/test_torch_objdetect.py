"""PyTorch port, YOLOv2 detection (``nn/conf/objdetect.py``,
``ops/image.py``): ``Yolo2OutputLayer``'s loss and its gradient,
``non_max_suppression`` and ``YoloUtils.getPredictedObjects`` against
the JAX package's on the same numpy inputs at f32, and the errors both
raise.

Tolerances: the loss and its gradient 1e-5 of max(1, max |value|) (sums
over the grid in another order; exp, sqrt and log-softmax of f32 values);
NMS and the decoding exact in what they select (the same indices in the
same order, the same count and classes; a planted tie takes the first
index in both), the decoded centres, sizes and confidences within 1e-6
(the same sigmoid and exp of f32 values).

The cuda-marked tests at the end hold the card against the CPU at f32
and import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_objdetect.py``.
"""

import numpy as np
import pytest
import torch

try:  # the JAX package is the CPU tests' reference; the card's machine
    #   has none, and runs only this file's cuda tests
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.conf.objdetect import (
        Yolo2OutputLayer as JYolo, YoloUtils as JYoloUtils)
    from deeplearning4j_tpu.ops.image import non_max_suppression as jnms
except ModuleNotFoundError:
    jax = None

from deeplearning4j_tpu_torch.nn.conf import (DetectedObject, Yolo2OutputLayer,
                                              YoloUtils)
from deeplearning4j_tpu_torch.ops.image import non_max_suppression

TOL, DECODE_TOL = 1e-5, 1e-6

#: the JAX tests' anchors; a pair whose shapes tie with a square object
#: (equal IoU: the first is responsible); YOLO2's COCO priors
ANCHORS = {"two": ((1.0, 1.5), (3.0, 2.0)),
           "tie": ((1.0, 2.0), (2.0, 1.0)),
           "coco": ((0.57273, 0.677385), (1.87446, 2.06253),
                    (3.33843, 5.47434), (7.88282, 3.52778),
                    (9.77052, 9.16828))}


def _close(got, want, tol=TOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _labels(kind, n=2, h=4, w=4, c=3, seed=0):
    """``[n, h, w, 4 + c]``: "one" the JAX tests' object in cell (1, 2) of
    every image (the other cells empty); "tie" a square object, whose
    shape ties between the "tie" anchors; "many" objects of random boxes
    and classes in about a third of the cells."""
    rs = np.random.RandomState(seed)
    lab = np.zeros((n, h, w, 4 + c), np.float32)
    if kind in ("one", "tie"):
        bw, bh = (2.8, 2.2) if kind == "one" else (1.5, 1.5)
        for i in range(n):
            lab[i, 1, 2, :4] = [2.5 - bw / 2, 1.5 - bh / 2, 2.5 + bw / 2,
                                1.5 + bh / 2]
            lab[i, 1, 2, 4 + rs.randint(c)] = 1.0
        return lab
    for i in range(n):
        for y in range(h):
            for x in range(w):
                if rs.rand() < 0.35:
                    cx, cy = x + rs.rand(), y + rs.rand()
                    bw, bh = rs.uniform(0.2, 4.0, 2)
                    lab[i, y, x, :4] = [cx - bw / 2, cy - bh / 2,
                                        cx + bw / 2, cy + bh / 2]
                    lab[i, y, x, 4 + rs.randint(c)] = 1.0
    return lab


LOSS_CASES = [("two", "one"), ("tie", "tie"), ("coco", "many"),
              ("two", "many"), ("coco", "empty")]


@pytest.mark.parametrize("anchors, labels", LOSS_CASES,
                         ids=[f"{a}-{b}" for a, b in LOSS_CASES])
def test_yolo2_loss_and_gradient_match_jax(anchors, labels):
    anchors = ANCHORS[anchors]
    c, b = 3, len(anchors)
    y = (_labels(labels, c=c) if labels != "empty"
         else np.zeros((2, 4, 4, 4 + c), np.float32))
    x = (np.random.RandomState(1).randn(2, 4, 4, b * (5 + c)) * 1.5).astype(
        np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda a: JYolo(
        anchors=anchors).loss_value({}, {}, a, jnp.asarray(y))))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = Yolo2OutputLayer(anchors=anchors).loss_value(
        {}, {}, xt, torch.from_numpy(y))
    (g,) = torch.autograd.grad(loss, xt)
    _close(loss, jl, what="loss")
    _close(g, jg, what="gradient")


def test_anchor_tie_takes_the_first_anchor():
    """A square object ties between anchors (1, 2) and (2, 1): the first
    is responsible, so only its box carries the class and coordinate
    gradients."""
    y = _labels("tie", n=1)
    x = (np.random.RandomState(2).randn(1, 4, 4, 2 * 8) * 0.5).astype(
        np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    Yolo2OutputLayer(anchors=ANCHORS["tie"]).loss_value(
        {}, {}, xt, torch.from_numpy(y)).backward()
    g = xt.grad.reshape(1, 4, 4, 2, 8)[0, 1, 2]
    assert torch.count_nonzero(g[0, [0, 1, 2, 3, 5, 6, 7]]) == 7
    assert torch.count_nonzero(g[1, [0, 1, 2, 3, 5, 6, 7]]) == 0


def test_yolo2_errors_match_jax():
    layer, jlayer = Yolo2OutputLayer(anchors=ANCHORS["two"]), \
        JYolo(anchors=ANCHORS["two"])
    y = _labels("one")
    bad = np.zeros((2, 4, 4, 7), np.float32)
    for fn, arr in ((layer.loss_value, torch.from_numpy),
                    (jlayer.loss_value, jnp.asarray)):
        with pytest.raises(ValueError, match="depth"):
            fn({}, {}, arr(bad), arr(y))
    good = np.zeros((2, 4, 4, 16), np.float32)
    for fn, arr in ((layer.loss_value, torch.from_numpy),
                    (jlayer.loss_value, jnp.asarray)):
        with pytest.raises(NotImplementedError, match="mask"):
            fn({}, {}, arr(good), arr(y), arr(np.ones((2, 4, 4))))
    for utils, arr, lay in ((YoloUtils, torch.from_numpy, layer),
                            (JYoloUtils, np.asarray, jlayer)):
        with pytest.raises(ValueError, match="depth"):
            utils.getPredictedObjects(lay, arr(bad))


def test_yolo2_layer_config_round_trips_with_jax():
    from deeplearning4j_tpu.common import serde as jserde
    from deeplearning4j_tpu_torch.common import serde

    layer = Yolo2OutputLayer(anchors=ANCHORS["coco"], lambda_coord=4.0)
    jlayer = JYolo(anchors=ANCHORS["coco"], lambda_coord=4.0)
    assert serde.to_json(layer) == jserde.to_json(jlayer)
    back = serde.from_json(jserde.to_json(jlayer))
    assert back == layer and back.anchors == ANCHORS["coco"]


# -------------------------------------------------------------------- NMS
def _boxes(n, b, seed, tied=False):
    """``[n, b, 4]`` (y1, x1, y2, x2) boxes clustered so that many overlap,
    and ``[n, b]`` scores; ``tied``: scores drawn from three values, and
    some boxes repeated exactly."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(0, 10, (n, b, 2))
    hw = rs.uniform(0.5, 4.0, (n, b, 2))
    boxes = np.concatenate([c - hw / 2, c + hw / 2], -1).astype(np.float32)
    if tied:
        boxes[:, 1::4] = boxes[:, 0:1]
        scores = rs.choice([0.3, 0.6, 0.9], (n, b)).astype(np.float32)
    else:
        scores = rs.rand(n, b).astype(np.float32)
    return boxes, scores


NMS_CASES = [(20, 10, 0.5, float("-inf"), False),
             (40, 50, 0.4, 0.5, False), (30, 8, 0.3, 0.2, True),
             (25, 30, 0.5, float("-inf"), True), (10, 3, 0.7, 0.95, False)]


@pytest.mark.parametrize("b, k, iou, thr, tied", NMS_CASES,
                         ids=[str(c) for c in NMS_CASES])
def test_nms_matches_jax(b, k, iou, thr, tied):
    """Three images at once in the port, one call each in JAX: the same
    indices in the same order and the same counts."""
    boxes, scores = _boxes(3, b, seed=b + k, tied=tied)
    sel, count = non_max_suppression(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), k, iou, thr)
    assert sel.dtype == count.dtype == torch.int32
    assert tuple(sel.shape) == (3, k) and tuple(count.shape) == (3,)
    for i in range(3):
        jsel, jcount = jnms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                            k, iou, thr)
        assert sel[i].tolist() == np.asarray(jsel).tolist()
        assert int(count[i]) == int(jcount)
    one, n1 = non_max_suppression(torch.from_numpy(boxes[0]),
                                  torch.from_numpy(scores[0]), k, iou, thr)
    assert tuple(one.shape) == (k,) and one.tolist() == sel[0].tolist()
    assert n1.dim() == 0 and int(n1) == int(count[0])


def test_nms_tie_takes_the_first_index():
    boxes = torch.tensor([[0, 0, 1, 1], [5, 5, 6, 6], [0, 0, 1, 1.0]])
    sel, count = non_max_suppression(boxes, torch.tensor([0.5, 0.5, 0.5]),
                                     3, 0.5)
    assert sel.tolist() == [0, 1, -1] and int(count) == 2


# --------------------------------------------------------------- decoding
def _planted(n=1, h=4, w=4, anchors=((1.0, 1.0), (2.0, 2.0)), c=3):
    """The JAX test's activations: -8 everywhere, one confident detection
    in cell (1, 2), anchor 0, class 2, and an overlapping duplicate in
    anchor 1 that NMS suppresses."""
    b = len(anchors)
    x = np.full((n, h, w, b * (5 + c)), -8.0, np.float32)
    xr = x.reshape(n, h, w, b, 5 + c)
    xr[:, 1, 2, 0, :5] = [0.0, 0.0, 0.0, 0.0, 8.0]
    xr[:, 1, 2, 0, 5 + 2] = 8.0
    xr[:, 1, 2, 1, :5] = [0.0, 0.0, -0.7, -0.7, 6.0]
    xr[:, 1, 2, 1, 5 + 2] = 6.0
    return x


def _same_detections(dets, jdets):
    assert len(dets) == len(jdets)
    for objs, jobjs in zip(dets, jdets):
        assert len(objs) == len(jobjs)
        for o, j in zip(objs, jobjs):
            assert isinstance(o, DetectedObject)
            assert o.getPredictedClass() == j.getPredictedClass()
            got = [o.getCenterX(), o.getCenterY(), o.getWidth(),
                   o.getHeight(), o.getConfidence()]
            want = [j.getCenterX(), j.getCenterY(), j.getWidth(),
                    j.getHeight(), j.getConfidence()]
            np.testing.assert_allclose(got, want, rtol=DECODE_TOL,
                                       atol=DECODE_TOL)
            np.testing.assert_allclose(o.class_probabilities,
                                       j.class_probabilities,
                                       rtol=DECODE_TOL, atol=DECODE_TOL)


DECODE_CASES = ["planted", "random", "low"]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_get_predicted_objects_matches_jax(case):
    """The JAX test's planted detection (one object after NMS, class 2,
    centre (2.5, 1.5), width 1); random activations over a 6 x 5 grid at
    COCO's anchors (several detections per image); and the JAX test's
    low-confidence activations (none)."""
    if case == "planted":
        anchors, x = ((1.0, 1.0), (2.0, 2.0)), _planted()
        kw = dict(conf_threshold=0.5, nms_threshold=0.4)
    elif case == "random":
        anchors = ANCHORS["coco"]
        x = np.random.RandomState(3).randn(3, 6, 5, 5 * 9).astype(
            np.float32)
        kw = dict(conf_threshold=0.6, nms_threshold=0.3, max_objects=8)
    else:
        anchors = ((1.0, 1.0),)
        x = np.full((2, 3, 3, 7), -8.0, np.float32)
        kw = dict(conf_threshold=0.5)
    dets = YoloUtils.getPredictedObjects(Yolo2OutputLayer(anchors=anchors),
                                         torch.from_numpy(x), **kw)
    jdets = JYoloUtils.getPredictedObjects(JYolo(anchors=anchors), x, **kw)
    _same_detections(dets, jdets)
    if case == "planted":
        (top,) = dets[0]
        assert top.getPredictedClass() == 2
        assert abs(top.getCenterX() - 2.5) < 0.05
        assert abs(top.getWidth() - 1.0) < 0.05
    elif case == "random":
        assert sum(len(d) for d in dets) >= 6
    else:
        assert [len(d) for d in dets] == [0, 0]


def test_get_predicted_objects_takes_arrays_on_the_named_device(monkeypatch):
    """A numpy array goes to ``device``; without one and without a card the
    call raises, as every entry point of the port does."""
    x = _planted()
    layer = Yolo2OutputLayer(anchors=((1.0, 1.0), (2.0, 2.0)))
    assert len(YoloUtils.getPredictedObjects(layer, x, device="cpu")[0]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        YoloUtils.getPredictedObjects(layer, x)


# ---------------------------------------------------------------- the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("anchors, labels", LOSS_CASES,
                         ids=[f"{a}-{b}" for a, b in LOSS_CASES])
def test_cuda_yolo2_loss_matches_the_cpu(anchors, labels):
    _needs_card()
    anchors = ANCHORS[anchors]
    b = len(anchors)
    y = (_labels(labels) if labels != "empty"
         else np.zeros((2, 4, 4, 7), np.float32))
    x = (np.random.RandomState(1).randn(2, 4, 4, b * 8) * 1.5).astype(
        np.float32)
    out = []
    for dev in ("cuda", "cpu"):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        loss = Yolo2OutputLayer(anchors=anchors).loss_value(
            {}, {}, xt, torch.from_numpy(y).to(dev))
        (g,) = torch.autograd.grad(loss, xt)
        out.append((loss.detach().cpu(), g.cpu()))
    _close(out[0][0], out[1][0].numpy(), what="loss")
    _close(out[0][1], out[1][1].numpy(), what="gradient")


@pytest.mark.cuda
@pytest.mark.parametrize("b, k, iou, thr, tied", NMS_CASES,
                         ids=[str(c) for c in NMS_CASES])
def test_cuda_nms_matches_the_cpu(b, k, iou, thr, tied):
    _needs_card()
    boxes, scores = _boxes(3, b, seed=b + k, tied=tied)
    card = non_max_suppression(torch.from_numpy(boxes).cuda(),
                               torch.from_numpy(scores).cuda(), k, iou, thr)
    cpu = non_max_suppression(torch.from_numpy(boxes),
                              torch.from_numpy(scores), k, iou, thr)
    assert card[0].cpu().tolist() == cpu[0].tolist()
    assert card[1].cpu().tolist() == cpu[1].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["planted", "random"])
def test_cuda_get_predicted_objects_matches_the_cpu(case):
    _needs_card()
    if case == "planted":
        anchors, x = ((1.0, 1.0), (2.0, 2.0)), _planted(n=4)
    else:
        anchors = ANCHORS["coco"]
        x = np.random.RandomState(3).randn(3, 6, 5, 45).astype(np.float32)
    layer = Yolo2OutputLayer(anchors=anchors)
    card = YoloUtils.getPredictedObjects(layer, x, 0.6, 0.3, 8)
    cpu = YoloUtils.getPredictedObjects(layer, x, 0.6, 0.3, 8, device="cpu")
    _same_detections(card, cpu)
