"""PyTorch port, the vision zoo (``zoo/``): the twelve builders' configurations
against the JAX package's JSON at their full default sizes (nothing is
initialised), and five models written by the JAX ModelSerializer and
restored by the port (weights carried across, never re-initialised):
YOLO2 (128 x 128, 3 classes), Xception (71 x 71, one middle block),
NASNet (32 x 32, one cell a stage), UNet (32 x 32, base 4, depth 2) and
TinyYOLO (64 x 64, 3 classes, 2 anchors). Each gives JAX's output, then
follows JAX's losses and parameters over three training steps.

Tolerances: outputs 1e-4 of max(1, max |value|), losses 1e-4 relative,
parameters 1e-3 absolute. Every model trains with Nesterovs, which moves
a weight by lr times its gradient (Adam divides a gradient by its own
size: where one cancels to ~1e-8, f32 rounding becomes an lr-sized step;
TinyYOLO and UNet showed 3.9e-3 and 4.4e-3 on a weight with Adam), at a
rate that keeps the three steps where a relative difference of the loss
means something: NASNet and UNet at 1e-3; Xception at 1e-4 (at 1e-3 it
fits the two images to a loss of 0.09 by the third step, 3.7e-4 apart);
TinyYOLO at 1e-4; YOLO2 at 1e-8: at initialisation its 22 batch norms
over two images make each backbone gradient a small difference of large
terms, so at f32 either framework holds it to only 1e-2-2e-1 of itself
(measured against the port at f64; Darknet19 alone shows the same), and
at the zoo's 1e-3 that decides the second loss (21.36 in JAX, 21.34
here). At 1e-8 a step moves YOLO2's loss by about 0.5 and the losses
still follow JAX to 1e-4, which holds the gradients' size to a few per
cent; its detection head's gradients agree to 1e-4 (measured).

C13, the faults this slice found, each with its test here: the CPU
convolution's backward on a channels_last input corrupted the heap at
NASNet's shapes (the cut NASNet aborted in 4 runs of 4), and the
activations and losses with a kink took PyTorch's gradient at the kink
where JAX's differs (``clamp`` and ``abs`` against ``jnp.clip``,
``jnp.maximum`` and ``jnp.abs``): the UNet's head, where dead columns
give logits of exactly 0, moved its bias the other way from JAX's.

The JAX networks draw their initial weights from numpy (the
``numpy_weights`` fixture): the JAX package's own draws compile once per
weight shape, 20-30 s a model on the CPU, and the weights go across in
the zip, so how they were drawn does not matter to the comparison.
"""

import math
import os

import numpy as np
import pytest
import torch

try:  # the JAX package is the CPU tests' reference
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.conf import layers as jlayers
    from deeplearning4j_tpu.nn.conf import layers_extra as jextra
    from deeplearning4j_tpu.nn.weights import WeightInit as JWeightInit
    from deeplearning4j_tpu import zoo as jzoo
    from deeplearning4j_tpu.learning import Adam as JAdam
    from deeplearning4j_tpu.learning import Nesterovs as JNesterovs
    from deeplearning4j_tpu.util import ModelSerializer as JSerializer
except ModuleNotFoundError:
    jax = None

from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

OUT_TOL, LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4, 1e-3

BUILDERS = ["SimpleCNN", "VGG16", "VGG19", "Darknet19", "TinyYOLO", "YOLO2",
            "SqueezeNet", "UNet", "Xception", "InceptionResNetV1",
            "FaceNetNN4Small2", "NASNet"]


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_conf_matches_jax(name):
    conf = getattr(zoo, name)().conf()
    jconf = getattr(jzoo, name)().conf()
    assert conf.to_json() == jconf.to_json()
    back = type(conf).from_json(jconf.to_json())
    assert back.to_json() == jconf.to_json()


def test_yolo2_passthrough_route_is_wired():
    conf = zoo.YOLO2().conf()
    nodes = {n.name: n for n in conf.nodes}
    assert set(nodes["route"].inputs) == {"reorg", "c20_bn"}
    assert nodes["reorg"].inputs == ["c21_pt_bn"]
    assert nodes["c21_pt_conv"].inputs == ["c13_bn"]
    types = dict(zip(conf.network_inputs, conf.input_types))
    for node in conf.nodes:
        types[node.name] = node.vertex.output_type(
            [types[s] for s in node.inputs])
    assert (types["yolo"].height, types["yolo"].width,
            types["yolo"].channels) == (19, 19, 425)
    assert types["route"].channels == 256 + 1024


def test_init_pretrained_raises_and_restores_a_local_zip(tmp_path):
    with pytest.raises(RuntimeError, match="no network egress"):
        zoo.YOLO2().initPretrained()
    net = zoo.TinyYOLO(num_classes=3, in_shape=(64, 64, 3),
                       anchors=((1.0, 1.0), (2.0, 2.0))).init(device="cpu")
    path = os.path.join(tmp_path, "tiny.zip")
    ModelSerializer.writeModel(net, path)
    back = zoo.TinyYOLO().initPretrained(path, device="cpu")
    assert isinstance(back, MultiLayerNetwork)
    assert back.numParams() == net.numParams()


def test_the_builders_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = zoo.UNet(in_shape=(16, 16, 3), base_filters=2, depth=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        z.init()
    assert z.init(device="cpu").device == torch.device("cpu")


def test_yolo_head_is_an_f32_island_under_mixed_bf16():
    """The Yolo2OutputLayer has ``loss_value``, so under mixed_bfloat16 it
    computes in f32 (its input is cast before ``_decode``), as the loss
    heads of the JAX policy do; its loss is finite and the step runs."""
    conf = zoo.TinyYOLO(num_classes=3, in_shape=(64, 64, 3),
                        anchors=((1.0, 1.0), (2.0, 2.0))).conf()
    conf.precision = "mixed_bfloat16"
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert net._compute_dtypes[len(conf.layers) - 1] == torch.float32
    assert net._compute_dtypes[0] == torch.bfloat16
    seen = []
    layer = conf.layers[-1]
    plain = layer.loss_value

    def spy(p, s, x, y, m=None):
        seen.append(x.dtype)
        return plain(p, s, x, y, m)

    layer.loss_value = spy
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    y = np.zeros((2, 2, 2, 7), np.float32)
    y[:, 0, 1, :4] = [1.2, 0.1, 1.9, 0.8]
    y[:, 0, 1, 5] = 1.0
    net.fit(x, y)
    assert seen == [torch.float32] and np.isfinite(net.score())
    assert net.output(x).dtype == torch.float32


# ------------------------------------------------ five models from JAX zips
@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads for the port's many small eager ops: the suite
    runs several workers on the machine's cores at once, and the port's
    default (a thread a core in every worker) oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_weights(monkeypatch):
    """The JAX layers' ``init_weights`` drawing from a numpy generator:
    He normal for the "relu" scheme, Glorot normal otherwise."""
    rs = np.random.RandomState(11)

    def init_weights(scheme, key, shape, fan_in, fan_out, dtype=None,
                     gain=1.0):
        relu = JWeightInit.resolve(scheme) in (JWeightInit.RELU,
                                               JWeightInit.HE_NORMAL)
        std = math.sqrt(2.0 / (fan_in if relu else fan_in + fan_out))
        return jnp.asarray(rs.standard_normal(shape) * std,
                           dtype or jnp.float32)

    for mod in (jlayers, jextra):
        monkeypatch.setattr(mod, "init_weights", init_weights)


def _yolo_labels(n, g, c):
    y = np.zeros((n, g, g, 4 + c), np.float32)
    y[:, 1, 1, :4] = (0.3, 0.3, 0.6, 0.6)
    y[:, 1, 1, 4] = 1.0
    y[n - 1, 2, 3, :4] = (2.9, 1.8, 3.7, 2.9)
    y[n - 1, 2, 3, 4 + c - 1] = 1.0
    return y


def _case(name):
    """(JAX network, x, y) of one model at its cut size."""
    rs = np.random.RandomState(0)
    if name == "YOLO2":
        jnet = jzoo.YOLO2(num_classes=3, in_shape=(128, 128, 3),
                          updater=JNesterovs(1e-8, 0.9)).init()
        x = rs.normal(size=(2, 128, 128, 3)).astype(np.float32)
        return jnet, x, _yolo_labels(2, 4, 3)
    if name == "TinyYOLO":
        jnet = jzoo.TinyYOLO(num_classes=3, in_shape=(64, 64, 3),
                             anchors=((1.0, 1.0), (2.0, 2.0)),
                             updater=JNesterovs(1e-4, 0.9)).init()
        x = rs.rand(2, 64, 64, 3).astype(np.float32)
        y = np.zeros((2, 2, 2, 7), np.float32)
        y[:, 0, 1, :4] = [1.2, 0.1, 1.9, 0.8]
        y[:, 0, 1, 5] = 1.0
        return jnet, x, y
    if name == "Xception":
        jnet = jzoo.Xception(num_classes=5, in_shape=(71, 71, 3),
                             middle_blocks=1,
                             updater=JNesterovs(1e-4, 0.9)).init()
        x = rs.rand(2, 71, 71, 3).astype(np.float32)
        return jnet, x, np.eye(5, dtype=np.float32)[[0, 3]]
    if name == "NASNet":
        jnet = jzoo.NASNet(num_classes=3, in_shape=(32, 32, 3), num_cells=1,
                           penultimate_filters=96, stem_filters=8,
                           updater=JNesterovs(1e-3, 0.9)).init()
        x = rs.rand(2, 32, 32, 3).astype(np.float32)
        return jnet, x, np.eye(3, dtype=np.float32)[[0, 1]]
    jnet = jzoo.UNet(in_shape=(32, 32, 3), base_filters=4, depth=2,
                     updater=JNesterovs(1e-3, 0.9)).init()
    x = rs.rand(2, 32, 32, 3).astype(np.float32)
    return jnet, x, (rs.rand(2, 32, 32, 1) > 0.5).astype(np.float32)


def _single(out):
    out = out[0] if isinstance(out, (list, tuple)) else out
    return np.asarray(out.jax if hasattr(out, "jax") else out)


def _f32(t):
    return t.detach().float().numpy()


def _tree(net):
    return net.params_map if hasattr(net, "params_map") else dict(
        enumerate(net.params_list))


@pytest.mark.parametrize("name", ["YOLO2", "Xception", "NASNet", "UNet",
                                  "TinyYOLO"])
def test_model_from_a_jax_zip_follows_jax(tmp_path, numpy_weights, name):
    jnet, x, y = _case(name)
    path = os.path.join(tmp_path, f"{name}.zip")
    # no updater state: it is zero before the first step on both sides,
    # and the JAX writer's deflate takes seconds per 100 MB
    JSerializer.writeModel(jnet, path, save_updater=False)
    net = ModelSerializer.restore(path, device="cpu")
    assert isinstance(net, MultiLayerNetwork if name == "TinyYOLO"
                      else ComputationGraph)
    want = _single(jnet.output(x))
    got = _f32(_single_t(net.output(x)))
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= OUT_TOL * scale
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        lj, lt = float(jnet.score()), net.score()
        assert np.isfinite(lt) and abs(lt - lj) <= LOSS_RTOL * abs(lj), \
            (lt, lj)
    jtree = jax.device_get(jnet.params_map if name != "TinyYOLO"
                           else dict(enumerate(jnet.params_list)))
    tree = _tree(net)
    assert sorted(map(str, tree)) == sorted(map(str, jtree))
    for key, p in jtree.items():
        for k, v in p.items():
            err = float(np.abs(_f32(tree[key][k]) - np.asarray(v)).max())
            assert err <= PARAM_ATOL, (key, k, err)


def _single_t(out):
    return out[0] if isinstance(out, list) else out


def test_graph_conf_json_of_a_restored_model_reads_back(tmp_path):
    """The restored graph's configuration is the JAX graph's, through the
    port's own JSON round trip."""
    conf = zoo.NASNet(num_classes=3, in_shape=(32, 32, 3), num_cells=1,
                      penultimate_filters=96, stem_filters=8).conf()
    back = ComputationGraphConfiguration.from_json(conf.to_json())
    assert back.to_json() == conf.to_json()
    assert [n.name for n in back.nodes] == [n.name for n in conf.nodes]


# --------------------------------------------------------------------- C13
#: points at every kink of the activations (0, +-1, +-2.5, 6) and between
KINKS = np.array([0.0, 1.0, -1.0, 2.5, -2.5, 6.0, 3.0, -3.0, 0.5, -0.5,
                  7.0], np.float32)


@pytest.mark.parametrize("name", [a.value for a in __import__(
    "deeplearning4j_tpu_torch.activations", fromlist=["Activation"])
    .Activation])
def test_activation_gradients_at_the_kinks_match_jax(name):
    from deeplearning4j_tpu.activations import Activation as JAct
    from deeplearning4j_tpu_torch.activations import Activation

    x = torch.from_numpy(KINKS).requires_grad_(True)
    y = Activation.resolve(name).fn(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    jfn = JAct.resolve(name).fn
    jy, jg = jax.value_and_grad(lambda a: jnp.sum(jfn(a)))(jnp.asarray(KINKS))
    # f32 rounding of the smooth parts stays within 1e-5; a kink's
    # difference is a half or a whole of the slope
    np.testing.assert_allclose(y.sum().item(), float(jy), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


LOSS_KINKS = [("xent", "sigmoid"), ("hinge", "identity"),
              ("squared_hinge", "identity"), ("l1", "identity"),
              ("mae", "identity"), ("huber", "identity"),
              ("mcxent", "identity"), ("kl_divergence", "identity"),
              ("mape", "identity"), ("msle", "identity")]


@pytest.mark.parametrize("loss, act", LOSS_KINKS,
                         ids=[f"{a}-{b}" for a, b in LOSS_KINKS])
def test_loss_gradients_at_the_kinks_match_jax(loss, act):
    """Outputs exactly at each loss's kinks (a logit of 0, a margin of 0,
    an output equal to its label, a probability of exactly 1) beside
    ordinary ones: the port's gradient is JAX's."""
    from deeplearning4j_tpu.loss import LossFunction as JLoss
    from deeplearning4j_tpu.loss import compute_loss as jloss
    from deeplearning4j_tpu_torch.loss import LossFunction, compute_loss

    labels = np.array([[1.0, 0.0, 1.0, 0.0], [0.0, 1.0, -1.0, 0.5]],
                      np.float32)
    out = np.array([[0.0, 0.0, 1.0, 0.25], [1.0, 0.0, -1.0, 0.5]],
                   np.float32)
    if loss in ("hinge", "squared_hinge"):
        labels = np.array([[1.0, -1.0, 1.0, -1.0], [-1.0, 1.0, 1.0, 1.0]],
                          np.float32)
    x = torch.from_numpy(out).requires_grad_(True)
    v = compute_loss(LossFunction.resolve(loss), torch.from_numpy(labels), x,
                     act)
    (g,) = torch.autograd.grad(v, x)
    jv, jg = jax.value_and_grad(lambda a: jloss(
        JLoss.resolve(loss), jnp.asarray(labels), a, act))(jnp.asarray(out))
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


def test_cpu_convolution_takes_an_nchw_copy(monkeypatch):
    """On the CPU ``conv2d`` hands the library a contiguous NCHW input (the
    channels_last view's backward corrupted the heap, C13)."""
    from deeplearning4j_tpu_torch.ops import nn as tnn

    seen, plain = [], tnn.F.conv2d

    def spy(x, *a):
        seen.append(x.is_contiguous())
        return plain(x, *a)

    monkeypatch.setattr(tnn.F, "conv2d", spy)
    x = torch.randn(2, 9, 9, 4)
    tnn.conv2d(x, torch.randn(3, 3, 4, 8), strides=2)
    tnn.depthwise_conv2d(x, torch.randn(3, 3, 4, 2))
    assert seen == [True, True]


def test_cut_nasnet_trains_on_the_cpu_without_corrupting_the_heap():
    """The reproduction of C13's heap corruption, in its own process: two
    cut NASNets (32 x 32, one cell a stage) built and trained three steps
    each on the CPU (it aborted with "corrupted size vs. prev_size" in 4
    runs of 4 before the fix)."""
    import subprocess
    import sys

    code = (
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from deeplearning4j_tpu_torch import zoo\n"
        "from deeplearning4j_tpu_torch.learning.updaters import Adam\n"
        "rs = np.random.RandomState(0)\n"
        "for _ in range(2):\n"
        "    net = zoo.NASNet(num_classes=3, in_shape=(32, 32, 3),\n"
        "                     num_cells=1, penultimate_filters=96,\n"
        "                     stem_filters=8,\n"
        "                     updater=Adam(1e-3)).init(device='cpu')\n"
        "    x = rs.rand(2, 32, 32, 3).astype(np.float32)\n"
        "    y = np.eye(3, dtype=np.float32)[[0, 1]]\n"
        "    for _ in range(3):\n"
        "        net.fit(x, y)\n"
        "    assert np.isfinite(net.score())\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0 and done.stdout.strip() == "ok", \
        done.stderr[-2000:]
