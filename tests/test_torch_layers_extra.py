"""PyTorch port, the rest of ``nn/conf/layers_extra.py`` and its ops,
against the JAX package on the same numpy inputs and weights at f32.

- The ops: ``conv1d``, ``conv3d``, ``deconv2d`` and ``deconv3d`` (odd
  sizes, SAME, VALID and integer padding; ``lax.conv_transpose``
  correlates with the kernel as it is), ``upsampling3d``, the four 1D
  pools and the two 3D pools (SAME pads the odd cell high), ``im2col``,
  ``locally_connected1d`` / ``2d``, ``space_to_batch`` /
  ``batch_to_space`` and ``prelu``: values and the gradients of a
  weighted sum with respect to every input.
- Every layer of the 1D, 2D-extra, 3D, misc, capsule and structural
  families: parameter names and shapes, output and gradients, output
  type, and the JSON after ``init_params`` (the fields some layers infer
  there) equal to JAX's.
- Networks restored from the JAX zip (configuration and weights) and
  trained three Adam steps beside the JAX network: the 1D, 2D (with the
  locally connected layer) and 3D (with ``Deconvolution3D``) stacks, the
  misc and structural layers under ``CenterLossOutputLayer``, and CapsNet
  at the JAX test's cut widths.
- The builder: ``dropOut(keep)``, the 3D input check, the flatten
  preprocessor from a volume, ``n_in`` from a volume's channels; every
  JAX layer tag parses; ``LambdaLayer``.
- The kinks, each planted: ``prelu`` at 0, ties in the max pools,
  ``jnp.abs`` at 0 in ``pnormpool1d`` and (C16) ``pnormpool2d``.

Tolerances: outputs, losses and gradients within 1e-5 of max(1, max
|value|) (sums in another order), parameters within 1e-4 absolute after
three steps, losses within 1e-5 relative; layout ops bit for bit.

The cuda-marked tests at the end hold the card (cuDNN, TF32 off) against
the CPU and import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_layers_extra.py``.
"""

import numpy as np
import pytest
import torch

from torch_twins import (card_vs_cpu, close, numpy_weights,  # noqa: F401
                         pair, pkg, trajectory, two_threads, twins)

from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.nn.conf import InputType
from deeplearning4j_tpu_torch.ops import nn as tnn
from deeplearning4j_tpu_torch.ops import shape as tshape
from deeplearning4j_tpu_torch.ops import transforms as ttr

TOL, LOSS_RTOL, PARAM_ATOL, STEPS = 1e-5, 1e-5, 1e-4, 3


def _jops():
    from deeplearning4j_tpu.ops import declarable_tail, nn, shape, transforms

    return nn, declarable_tail, shape, transforms


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ------------------------------------------------------------------- ops
#: (name, port function, JAX function by its modules, array shapes)
OP_CASES = [
    ("conv1d same s2 d2", lambda x, w: tnn.conv1d(x, w, None, 2, "SAME", 2),
     lambda J: lambda x, w: J[0].conv1d(x, w, None, 2, "SAME", 2),
     [(2, 11, 3), (3, 3, 5)]),
    ("conv1d valid", lambda x, w, b: tnn.conv1d(x, w, b, 1, "VALID"),
     lambda J: lambda x, w, b: J[0].conv1d(x, w, b, 1, "VALID"),
     [(2, 10, 3), (4, 3, 5), (5,)]),
    ("conv1d pad 1 s2", lambda x, w: tnn.conv1d(x, w, None, 2, 1),
     lambda J: lambda x, w: J[0].conv1d(x, w, None, 2, 1),
     [(2, 9, 2), (3, 2, 4)]),
    ("conv3d same", lambda x, w, b: tnn.conv3d(x, w, b, (2, 1, 2), "SAME"),
     lambda J: lambda x, w, b: J[0].conv3d(x, w, b, (2, 1, 2), "SAME"),
     [(2, 5, 4, 5, 2), (3, 2, 3, 2, 3), (3,)]),
    ("conv3d valid", lambda x, w: tnn.conv3d(x, w, None, 1, "VALID"),
     lambda J: lambda x, w: J[0].conv3d(x, w, None, 1, "VALID"),
     [(2, 4, 5, 3, 2), (2, 3, 2, 2, 3)]),
    ("conv3d pad (1,0,2)", lambda x, w: tnn.conv3d(x, w, None, (1, 2, 1),
                                                   (1, 0, 2)),
     lambda J: lambda x, w: J[0].conv3d(x, w, None, (1, 2, 1), (1, 0, 2)),
     [(1, 3, 5, 4, 2), (3, 3, 3, 2, 2)]),
    ("upsampling3d", lambda x: tnn.upsampling3d(x, 2),
     lambda J: lambda x: J[1].upsampling3d(x, 2), [(2, 2, 3, 2, 3)]),
    ("im2col valid", lambda x: tnn.im2col(x, (3, 2), (2, 1)),
     lambda J: lambda x: J[0].im2col(x, (3, 2), (2, 1)), [(2, 7, 6, 3)]),
    ("im2col same", lambda x: tnn.im2col(x, (3, 3), (2, 2), "SAME"),
     lambda J: lambda x: J[0].im2col(x, (3, 3), (2, 2), "SAME"),
     [(2, 6, 7, 2)]),
    ("im2col pad 1", lambda x: tnn.im2col(x, 2, 1, 1),
     lambda J: lambda x: J[0].im2col(x, 2, 1, 1), [(1, 4, 5, 2)]),
    ("locally_connected2d",
     lambda x, w, b: tnn.locally_connected2d(x, w, b, (3, 3), (2, 2)),
     lambda J: lambda x, w, b: J[0].locally_connected2d(x, w, b, (3, 3),
                                                       (2, 2)),
     [(2, 7, 6, 3), (6, 27, 4), (3, 2, 4)]),
    ("locally_connected1d",
     lambda x, w, b: tnn.locally_connected1d(x, w, b, 3, 2),
     lambda J: lambda x, w, b: J[0].locally_connected1d(x, w, b, 3, 2),
     [(2, 11, 3), (5, 9, 4), (5, 4)]),
    ("space_to_batch",
     lambda x: tshape.space_to_batch(x, (2, 3), ((1, 0), (1, 1))),
     lambda J: lambda x: J[2].space_to_batch(x, (2, 3), ((1, 0), (1, 1))),
     [(2, 5, 7, 3)]),
    ("batch_to_space",
     lambda x: tshape.batch_to_space(x, (2, 3), ((1, 0), (1, 2))),
     lambda J: lambda x: J[2].batch_to_space(x, (2, 3), ((1, 0), (1, 2))),
     [(12, 3, 4, 2)]),
    ("prelu", lambda x, a: ttr.prelu(x, a),
     lambda J: lambda x, a: J[3].prelu(x, a), [(3, 4, 5), (5,)]),
]
#: deconvolutions at odd sizes: (input H, W, k, stride, padding)
DECONV_CASES = [(7, 9, 3, 2, "SAME"), (7, 9, 3, 2, "VALID"),
                (5, 6, 2, 2, "SAME"), (5, 5, 5, 2, "SAME"),
                (6, 7, 3, 3, "VALID"), (5, 4, 4, 1, "SAME"),
                (7, 5, 3, 2, 1), (6, 6, 5, 3, (2, 1)), (4, 5, 1, 2, "SAME")]
#: 3D deconvolutions: (stride, padding)
DECONV3D_CASES = [((2, 1, 3), "SAME"), ((2, 2, 1), "VALID"),
                  ((1, 2, 2), [(1, 2), (0, 0), (2, 1)]),
                  ((2, 2, 2), [(1, 1), (1, 1), (1, 1)])]
POOL1D_CASES = [(f, pad) for f in ("maxpool1d", "avgpool1d", "sumpool1d",
                                   "pnormpool1d")
                for pad in ("SAME", "VALID", 1)]
POOL3D_CASES = [(f, pad) for f in ("maxpool3d", "avgpool3d")
                for pad in ("SAME", "VALID", (1, 0, 1))]


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_op_matches_jax(case):
    _, fn, jfn, shapes = case
    arrays = [_rand(*s, seed=i) for i, s in enumerate(shapes)]
    pair(fn, jfn(_jops()), arrays, TOL)


@pytest.mark.parametrize("case", DECONV_CASES,
                         ids=[str(c) for c in DECONV_CASES])
def test_deconv2d_matches_jax(case):
    h, w, k, s, pad = case
    x, wt, b = _rand(2, h, w, 3), _rand(k, k, 3, 4, seed=1), _rand(4, seed=2)
    jnn = _jops()[0]
    pair(lambda x, wt, b: tnn.deconv2d(x, wt, b, (s, s), pad),
         lambda x, wt, b: jnn.deconv2d(x, wt, b, (s, s), pad), [x, wt, b],
         TOL)


@pytest.mark.parametrize("case", DECONV3D_CASES,
                         ids=[str(c) for c in DECONV3D_CASES])
def test_deconv3d_matches_jax(case):
    s, pad = case
    x, wt = _rand(2, 4, 5, 3, 2), _rand(3, 2, 3, 2, 3, seed=1)
    jd = _jops()[1]
    pair(lambda x, wt: tnn.deconv3d(x, wt, s, pad),
         lambda x, wt: jd.deconv3d(x, wt, s, pad), [x, wt], TOL)


def test_deconv_weight_is_the_gradient_convolutions_flipped():
    """JAX's own golden (``tests/test_layers_extra.py:416-438``) for the
    port: torch's ``conv_transpose3d`` weight maps to
    ``flip_spatial(permute(w))``."""
    x, wt = _rand(2, 3, 4, 5, 2, seed=11), _rand(2, 4, 3, 3, 3, seed=12)
    want = torch.nn.functional.conv_transpose3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(wt),
        stride=(2, 1, 2), padding=1).permute(0, 2, 3, 4, 1)
    w = np.flip(wt.transpose(2, 3, 4, 0, 1), (0, 1, 2)).copy()
    got = tnn.deconv3d(torch.from_numpy(x), torch.from_numpy(w), (2, 1, 2),
                       [(1, 1)] * 3)
    close(got, want, TOL)


@pytest.mark.parametrize("case", POOL1D_CASES,
                         ids=[f"{f}-{p}" for f, p in POOL1D_CASES])
def test_pool1d_matches_jax(case):
    f, pad = case
    jnn = _jops()[0]
    pair(lambda x: getattr(tnn, f)(x, 3, 2, pad),
         lambda x: getattr(jnn, f)(x, 3, 2, pad), [_rand(2, 11, 3)], TOL)


@pytest.mark.parametrize("case", POOL3D_CASES,
                         ids=[f"{f}-{p}" for f, p in POOL3D_CASES])
def test_pool3d_matches_jax(case):
    f, pad = case
    jnn = _jops()[0]
    pair(lambda x: getattr(tnn, f)(x, (2, 3, 2), (2, 2, 1), pad),
         lambda x: getattr(jnn, f)(x, (2, 3, 2), (2, 2, 1), pad),
         [_rand(2, 5, 7, 4, 2)], TOL)


def test_layout_ops_are_exact():
    x = _rand(2, 6, 4, 3)
    jnn, jd, js, _ = _jops()
    got = tshape.space_to_batch(torch.from_numpy(x), (2, 2), ((0, 0), (0, 0)))
    assert np.array_equal(got.numpy(), np.asarray(
        js.space_to_batch(x, (2, 2), ((0, 0), (0, 0)))))
    back = tshape.batch_to_space(got, (2, 2), ((0, 0), (0, 0)))
    assert torch.equal(back, torch.from_numpy(x))
    y = _rand(1, 2, 3, 2, 2)
    assert np.array_equal(tnn.upsampling3d(torch.from_numpy(y), 3).numpy(),
                          np.asarray(jd.upsampling3d(y, 3)))


# ----------------------------------------------------------------- kinks
def _kink_x(shape, seed):
    """Inputs whose windows hold ties and zeros: integers in [-1, 1]."""
    return np.random.RandomState(seed).randint(-1, 2, shape).astype(
        np.float32)


@pytest.mark.parametrize("what", ["prelu", "maxpool1d", "maxpool3d",
                                  "pnormpool1d", "pnormpool2d"])
def test_kinks_take_jax_gradients(what):
    """Planted kinks: ``prelu`` at x = 0 (the gradient goes to x), ties in
    a max pool's window (to the first maximum, as ``select_and_scatter``
    gives it), and ``jnp.abs`` at 0 (slope 1) under a p-norm of 1 (C16:
    ``pnormpool2d`` took ``torch.abs``'s 0)."""
    jnn, _, _, jtr = _jops()
    if what == "prelu":
        x = _kink_x((4, 6), 0)
        assert (x == 0).sum() > 2
        pair(ttr.prelu, jtr.prelu, [x, _rand(6, seed=1)], 0.0)
    elif what == "maxpool1d":
        x = _kink_x((2, 12, 3), 1)
        pair(lambda x: tnn.maxpool1d(x, 3, 2, "SAME"),
             lambda x: jnn.maxpool1d(x, 3, 2, "SAME"), [x], 0.0)
    elif what == "maxpool3d":
        x = _kink_x((2, 4, 5, 4, 2), 2)
        pair(lambda x: tnn.maxpool3d(x, 2, 2, "SAME"),
             lambda x: jnn.maxpool3d(x, 2, 2, "SAME"), [x], 0.0)
    elif what == "pnormpool1d":
        x = _kink_x((2, 9, 3), 3)
        pair(lambda x: tnn.pnormpool1d(x, 3, 3, "VALID", 1),
             lambda x: jnn.pnormpool1d(x, 3, 3, "VALID", 1), [x], TOL)
    else:
        x = _kink_x((2, 6, 6, 3), 4)
        pair(lambda x: tnn.pnormpool2d(x, 2, 2, "VALID", 1),
             lambda x: jnn.pnormpool2d(x, 2, 2, "VALID", 1), [x], TOL)
        g = torch.from_numpy(x).requires_grad_(True)
        tnn.pnormpool2d(g, 2, 2, "VALID", 1).sum().backward()
        assert torch.all(g.grad[torch.from_numpy(x) == 0] == 1.0)


# ---------------------------------------------------------------- layers
def _it(p, kind, dims):
    it = p.C.InputType
    return {"rnn": lambda: it.recurrent(*dims), "ff": lambda: it.feedForward(
        *dims), "img": lambda: it.convolutional(*dims),
        "vol": lambda: it.convolutional3D(*dims)}[kind]()


#: (class, fields, input kind, input dims without the batch)
LAYER_CASES = [
    ("Convolution1D", dict(n_in=3, n_out=4, kernel_size=3, stride=2,
                           convolution_mode="Same", activation="relu"),
     "rnn", (3, 11)),
    ("Convolution1D", dict(n_in=3, n_out=5, kernel_size=2, padding=1,
                           dilation=2, has_bias=False), "rnn", (3, 9)),
    ("Subsampling1DLayer", dict(kernel_size=3, stride=2,
                                convolution_mode="Same"), "rnn", (3, 11)),
    ("Subsampling1DLayer", dict(pooling_type="avg", kernel_size=3, stride=2,
                                padding=1), "rnn", (3, 10)),
    ("Subsampling1DLayer", dict(pooling_type="sum", kernel_size=2), "rnn",
     (2, 9)),
    ("Subsampling1DLayer", dict(pooling_type="pnorm", kernel_size=2,
                                pnorm=3), "rnn", (2, 8)),
    ("Upsampling1D", dict(size=3), "rnn", (3, 5)),
    ("Cropping1D", dict(crop=(1, 2)), "rnn", (3, 8)),
    ("ZeroPadding1DLayer", dict(pad=(2, 1)), "rnn", (3, 5)),
    ("LocallyConnected1D", dict(n_in=3, n_out=4, kernel_size=3, stride=2,
                                activation="tanh"), "rnn", (3, 11)),
    ("Deconvolution2D", dict(n_in=3, n_out=4, kernel_size=(3, 3),
                             stride=(2, 2), convolution_mode="Same",
                             activation="relu"), "img", (5, 6, 3)),
    ("Deconvolution2D", dict(n_in=2, n_out=3, kernel_size=(3, 2),
                             stride=(2, 1), padding=(1, 0)), "img",
     (4, 5, 2)),
    ("Cropping2D", dict(crop=(1, 2, 0, 1)), "img", (6, 5, 2)),
    ("SpaceToBatchLayer", dict(block_size=2, padding=((1, 0), (0, 1))),
     "img", (5, 5, 2)),
    ("LocallyConnected2D", dict(n_in=2, n_out=3, kernel_size=(3, 2),
                                stride=(2, 1), activation="relu"), "img",
     (7, 5, 2)),
    ("Convolution3D", dict(n_in=2, n_out=3, kernel_size=(3, 2, 3),
                           stride=(2, 1, 2), convolution_mode="Same",
                           activation="relu"), "vol", (5, 4, 5, 2)),
    ("Convolution3D", dict(n_in=2, n_out=3, kernel_size=2, padding=1,
                           dilation=(1, 2, 1)), "vol", (3, 4, 3, 2)),
    ("Deconvolution3D", dict(n_in=2, n_out=3, kernel_size=(3, 3, 3),
                             stride=(2, 1, 2), padding=(1, 1, 1)), "vol",
     (3, 4, 3, 2)),
    ("Deconvolution3D", dict(n_in=2, n_out=3, kernel_size=2, stride=2,
                             convolution_mode="Same", activation="tanh"),
     "vol", (2, 3, 2, 2)),
    ("Subsampling3DLayer", dict(kernel_size=2, stride=2,
                                convolution_mode="Same"), "vol",
     (5, 7, 5, 2)),
    ("Subsampling3DLayer", dict(pooling_type="avg", kernel_size=(1, 2, 2),
                                stride=(1, 2, 2), padding=(0, 1, 1)), "vol",
     (3, 4, 5, 2)),
    ("Upsampling3D", dict(size=2), "vol", (2, 3, 2, 2)),
    ("Cropping3D", dict(crop=(1, 0, 1, 1, 0, 2)), "vol", (3, 4, 4, 2)),
    ("ZeroPadding3DLayer", dict(pad=(1, 2, 0)), "vol", (2, 2, 3, 2)),
    ("PReLULayer", dict(), "ff", (5,)),
    ("PReLULayer", dict(), "img", (3, 4, 3)),
    ("ElementWiseMultiplicationLayer", dict(activation="tanh"), "ff", (5,)),
    ("RepeatVector", dict(n=4), "ff", (5,)),
    ("MaskLayer", dict(), "rnn", (3, 4)),
    ("PrimaryCapsules", dict(n_in=3, capsule_dimensions=4, channels=2,
                             kernel_size=(3, 3), stride=(2, 2)), "img",
     (9, 8, 3)),
    ("CapsuleLayer", dict(capsules=3, capsule_dimensions=4, routings=3),
     "rnn", (5, 6)),
    ("CapsuleStrengthLayer", dict(), "rnn", (4, 3)),
    ("PermuteLayer", dict(dims=(2, 1)), "rnn", (3, 5)),
    ("PermuteLayer", dict(dims=(3, 1, 2)), "img", (2, 4, 3)),
    ("ReshapeLayer", dict(target_shape=(3, 4)), "ff", (12,)),
]


def _layer_pair(kind, kw):
    t, j = pkg(False), pkg(True)
    return getattr(t.X, kind)(**kw), getattr(j.X, kind)(**kw)


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LAYER_CASES)])
def test_layer_matches_jax(case):
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.common import serde as jserde

    kind, kw, ik, dims = case
    layer, jlayer = _layer_pair(kind, kw)
    it, jit = _it(pkg(False), ik, dims), _it(pkg(True), ik, dims)
    # the parameters' shapes (and the fields init writes) without JAX's
    # draws, which would compile
    jp = jax.eval_shape(lambda k: jlayer.init_params(k, jit, jnp.float32),
                        jax.random.key(0))
    p = layer.init_params(torch.Generator().manual_seed(0), it,
                          torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    # the fields a layer infers at init are written alike
    assert serde.to_json(layer) == jserde.to_json(jlayer)
    names = sorted(jp)
    x = _rand(2, *(dims[::-1] if ik == "rnn" else dims), seed=7)
    arrays = [x] + [_rand(*np.shape(jp[k]), seed=8 + i, scale=0.5)
                    for i, k in enumerate(names)]

    def port(x, *ps):
        return layer.apply(dict(zip(names, ps)), {}, x, False, None)[0]

    def ref(x, *ps):
        return jlayer.apply(dict(zip(names, ps)), {}, x, False, None)[0]

    pair(port, ref, arrays, TOL)
    out_t = layer.output_type(it)
    assert serde.to_json(out_t) == jserde.to_json(jlayer.output_type(jit))
    y = port(*[torch.from_numpy(a) for a in arrays])
    want = (x.shape[0],) + out_t.example_shape()
    if kind == "SpaceToBatchLayer":
        want = (x.shape[0] * kw["block_size"] ** 2,) + want[1:]
    assert tuple(y.shape) == want


def test_squash_keeps_lengths_below_one():
    from deeplearning4j_tpu_torch.nn.conf.layers_extra import _squash

    v = _squash(torch.tensor([[10.0, 0.0, 0.0]]))
    assert 0.97 < float(torch.linalg.norm(v)) < 1.0
    assert float(torch.linalg.norm(_squash(torch.tensor([[1e-3, 0.0,
                                                          0.0]])))) < 1e-3


# -------------------------------------------------------------- networks
def _labels(n, k, seed=1):
    return np.eye(k, dtype=np.float32)[
        np.random.default_rng(seed).integers(0, k, n)]


def _net_1d(p):
    X, Ly = p.X, p.Ly
    return [X.ZeroPadding1DLayer(pad=(1, 1)),
            X.Convolution1D(n_out=8, kernel_size=3, activation="relu"),
            X.Subsampling1DLayer(kernel_size=2, stride=2),
            X.Upsampling1D(size=2), X.Cropping1D(crop=(1, 1)),
            X.LocallyConnected1D(n_out=6, kernel_size=3),
            Ly.GlobalPoolingLayer(pooling_type="avg"),
            Ly.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def _net_2d(p):
    X, Ly = p.X, p.Ly
    return [Ly.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                activation="relu"),
            X.Deconvolution2D(n_out=3, kernel_size=(2, 2), stride=(2, 2),
                              convolution_mode="Same", activation="tanh"),
            X.Cropping2D(crop=(1, 1, 0, 2)),
            X.LocallyConnected2D(n_out=4, kernel_size=(3, 3),
                                 stride=(2, 2), activation="relu"),
            Ly.DenseLayer(n_out=8, activation="relu"),
            Ly.OutputLayer(n_out=2, activation="softmax", loss="mcxent")]


def _net_3d(p):
    X, Ly = p.X, p.Ly
    return [X.ZeroPadding3DLayer(pad=(1, 1, 1)),
            X.Convolution3D(n_out=4, kernel_size=(3, 3, 3),
                            activation="relu"),
            X.Subsampling3DLayer(kernel_size=(2, 2, 2), stride=(2, 2, 2)),
            X.Upsampling3D(size=2), X.Cropping3D(crop=(1, 1, 1, 1, 1, 1)),
            X.Deconvolution3D(n_out=2, kernel_size=(2, 2, 2),
                              stride=(2, 2, 2), convolution_mode="Same",
                              activation="relu"),
            X.Subsampling3DLayer(pooling_type="avg", kernel_size=(2, 2, 2),
                                 stride=(1, 1, 1), convolution_mode="Same"),
            Ly.DenseLayer(n_out=8, activation="relu"),
            Ly.OutputLayer(n_out=2, activation="softmax", loss="mcxent")]


def _net_misc(p):
    """The misc and structural layers, and the center-loss head."""
    X, Ly = p.X, p.Ly
    return [Ly.DenseLayer(n_out=6, activation="identity"), X.PReLULayer(),
            X.ElementWiseMultiplicationLayer(activation="tanh"),
            X.RepeatVector(n=4), X.MaskLayer(), X.PermuteLayer(dims=(2, 1)),
            Ly.GlobalPoolingLayer(pooling_type="max"),
            Ly.DenseLayer(n_out=12, activation="relu"),
            X.ReshapeLayer(target_shape=(3, 4)),
            X.Subsampling1DLayer(pooling_type="pnorm", kernel_size=2,
                                 stride=1),
            Ly.GlobalPoolingLayer(pooling_type="sum"),
            X.CenterLossOutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent", lambda_=0.5)]


def _net_capsnet(p):
    """JAX's ``tests/test_layers_extra.py:248-265`` (CapsNetMNISTTest)."""
    X, Ly = p.X, p.Ly
    return [Ly.ConvolutionLayer(n_out=8, kernel_size=(5, 5),
                                activation="relu"),
            X.PrimaryCapsules(capsule_dimensions=4, channels=2,
                              kernel_size=(5, 5), stride=(2, 2)),
            X.CapsuleLayer(capsules=3, capsule_dimensions=6, routings=2),
            X.CapsuleStrengthLayer(),
            Ly.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]


#: (name, layers, input type, x shape, classes)
NET_CASES = [
    ("1d", _net_1d, lambda it: it.recurrent(4, 16), (5, 16, 4), 3),
    ("2d", _net_2d, lambda it: it.convolutional(9, 9, 2), (4, 9, 9, 2), 2),
    ("3d", _net_3d, lambda it: it.convolutional3D(6, 5, 6, 2),
     (3, 6, 5, 6, 2), 2),
    ("misc", _net_misc, lambda it: it.feedForward(5), (9, 5), 3),
    ("capsnet", _net_capsnet, lambda it: it.convolutional(20, 20, 1),
     (4, 20, 20, 1), 3),
]


@pytest.mark.parametrize("case", NET_CASES, ids=[c[0] for c in NET_CASES])
def test_network_follows_jax(case, tmp_path):
    """The JAX network's zip restored in the port: outputs, then three
    Adam steps (losses and parameters)."""
    name, layers, it, shape, k = case
    jnet, net = twins(layers, it, tmp_path, name)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    y = _labels(shape[0], k)
    close(net.output(x), np.asarray(jnet.output(x)), TOL, "output")
    losses = trajectory(jnet, net, x, y, STEPS, LOSS_RTOL, PARAM_ATOL,
                        lambda m: m.params_list)
    assert all(np.isfinite(losses))
    if name == "capsnet":
        # every capsule of the routing layer is shorter than 1
        caps = net.feedForward(x)[3]
        assert float(torch.linalg.norm(caps, dim=-1).max()) < 1.0
    if name == "misc":
        # the centers moved, by the shared updater, as JAX's did
        assert float(net.params_list[-1]["centers"].abs().max()) > 0


def test_center_loss_value_matches_jax():
    import jax.numpy as jnp

    t, j = _layer_pair("CenterLossOutputLayer",
                       dict(n_in=4, n_out=3, lambda_=0.3, activation="softmax",
                            loss="mcxent"))
    names = ["W", "b", "centers"]
    arrays = [_rand(6, 4), _rand(4, 3, seed=1), _rand(3, seed=2),
              _rand(3, 4, seed=3)]
    y = _labels(6, 3)
    got = t.loss_value(dict(zip(names, [torch.from_numpy(a)
                                        for a in arrays[1:]])), {},
                       torch.from_numpy(arrays[0]), torch.from_numpy(y))
    want = j.loss_value(dict(zip(names, [jnp.asarray(a)
                                         for a in arrays[1:]])), {},
                        jnp.asarray(arrays[0]), jnp.asarray(y))
    close(got, np.asarray(want), TOL)


# --------------------------------------------------------- configuration
#: one instance of every serializable class of layers_extra, as JAX's
#: serde round trip lists them
def _all_layers(p):
    X, Ly = p.X, p.Ly
    return [X.GRU(n_in=3, n_out=4, recurrent_bias=True),
            X.Convolution1D(n_in=2, n_out=3), X.Subsampling1DLayer(),
            X.Upsampling1D(), X.Cropping1D(crop=(1, 2)),
            X.ZeroPadding1DLayer(), X.Deconvolution2D(n_in=2, n_out=3),
            X.DepthwiseConvolution2D(n_in=2, depth_multiplier=2),
            X.Cropping2D(crop=(1, 1, 2, 2)), X.SpaceToDepthLayer(),
            X.SpaceToBatchLayer(), X.Convolution3D(n_in=1, n_out=2),
            X.Deconvolution3D(n_in=1, n_out=2), X.Subsampling3DLayer(),
            X.Upsampling3D(), X.Cropping3D(crop=(1, 1, 1, 1, 1, 1)),
            X.ZeroPadding3DLayer(), X.LocallyConnected1D(n_in=2, n_out=3),
            X.LocallyConnected2D(n_in=2, n_out=3), X.PReLULayer(n_in=4),
            X.ElementWiseMultiplicationLayer(n_in=3, n_out=3),
            X.RepeatVector(n=5), X.MaskLayer(),
            X.MaskZeroLayer(layer=Ly.LSTM(n_in=2, n_out=3), mask_value=0.0),
            X.CenterLossOutputLayer(n_in=4, n_out=2),
            X.PrimaryCapsules(n_in=2), X.CapsuleLayer(),
            X.CapsuleStrengthLayer(), X.GravesBidirectionalLSTM(n_in=2,
                                                                n_out=3),
            X.PermuteLayer(dims=(2, 1)), X.ReshapeLayer(target_shape=(2, 3))]


def test_every_jax_layer_json_parses_and_round_trips():
    from deeplearning4j_tpu.common import serde as jserde

    for jl, tl in zip(_all_layers(pkg(True)), _all_layers(pkg(False))):
        j = jserde.to_json(jl)
        back = serde.from_json(j)
        assert type(back).__name__ == type(jl).__name__
        assert serde.to_json(back) == j == serde.to_json(tl)


def test_builder_drop_out_default_matches_jax():
    def layers(p):
        return [p.Ly.DenseLayer(n_out=6, activation="relu"),
                p.Ly.DenseLayer(n_out=5, dropout=0.1),
                p.Ly.Bidirectional(layer=p.Ly.LSTM(n_out=3)),
                p.Ly.GlobalPoolingLayer(),
                p.Ly.OutputLayer(n_out=2)]

    def it(t):
        return t.recurrent(4, 7)

    from torch_twins import mln_conf

    conf = mln_conf(pkg(False), layers, it, dropout=0.8)
    assert conf.to_json() == mln_conf(pkg(True), layers, it,
                                      dropout=0.8).to_json()
    assert [l.dropout for l in conf.layers] == [
        1.0 - 0.8, 0.1, 1.0 - 0.8, 1.0 - 0.8, 1.0 - 0.8]
    assert conf.layers[2].layer.dropout == 1.0 - 0.8
    off = mln_conf(pkg(False), layers, it, dropout=0.0)
    assert [l.dropout for l in off.layers] == [None, 0.1, None, None, None]
    assert off.to_json() == mln_conf(pkg(True), layers, it,
                                     dropout=0.0).to_json()


def test_builder_drop_out_keeps_its_fraction_in_training():
    """The distribution contract: a Dense layer's input under
    ``dropOut(0.75)`` keeps 0.75 of its entries in a training forward
    (within 7 standard deviations of the draws) and scales them by 4/3."""
    from torch_twins import mln_conf

    conf = mln_conf(pkg(False), lambda p: [
        p.Ly.DenseLayer(n_out=4), p.Ly.OutputLayer(n_out=2)],
        lambda t: t.feedForward(64), dropout=0.75)
    layer = conf.layers[0]
    x = torch.ones((256, 64))
    out = layer._maybe_dropout(x, True, torch.Generator().manual_seed(3))
    kept = float((out != 0).float().mean())
    sigma = (0.75 * 0.25 / x.numel()) ** 0.5
    assert abs(kept - 0.75) <= 7 * sigma
    assert torch.allclose(out[out != 0], torch.tensor(1 / 0.75))
    assert torch.equal(layer._maybe_dropout(x, False, None), x)


def test_builder_volume_rules_match_jax():
    """``_CNN3D_LAYERS`` need a volume (JAX's message), a dense layer after
    a volume gets the flatten preprocessor and a volume's channels are
    the next layer's ``n_in``."""
    from torch_twins import mln_conf

    def layers(p):
        return [p.X.Convolution3D(n_out=3, kernel_size=2),
                p.X.Subsampling3DLayer(), p.Ly.DenseLayer(n_out=4),
                p.Ly.OutputLayer(n_out=2)]

    def vol(t):
        return t.convolutional3D(4, 6, 6, 2)

    conf = mln_conf(pkg(False), layers, vol)
    assert conf.to_json() == mln_conf(pkg(True), layers, vol).to_json()
    assert conf.layers[0].n_in == 2
    assert conf.preprocessors == {2: "flatten"}
    assert conf.layers[2].n_in == 1 * 2 * 2 * 3
    for p in (pkg(False), pkg(True)):
        with pytest.raises(ValueError, match="needs 3D image input"):
            mln_conf(p, layers, lambda t: t.convolutional(6, 6, 2))


def test_builder_flat_image_before_the_new_image_layers():
    from torch_twins import mln_conf

    for make in (lambda p: p.X.Cropping2D(crop=1),
                 lambda p: p.X.SpaceToBatchLayer(),
                 lambda p: p.X.LocallyConnected2D(n_out=2),
                 lambda p: p.X.PrimaryCapsules(capsule_dimensions=2,
                                               channels=2,
                                               kernel_size=(3, 3))):
        def layers(p):
            return [make(p), p.Ly.OutputLayer(n_out=2)]

        conf = mln_conf(pkg(False), layers,
                        lambda t: t.convolutionalFlat(8, 8, 1))
        assert conf.preprocessors[0] == "to_conv:8,8,1"
        assert conf.to_json() == mln_conf(
            pkg(True), layers, lambda t: t.convolutionalFlat(8, 8, 1)
        ).to_json()


def test_lambda_layer_applies_trains_and_refuses_json():
    from deeplearning4j_tpu_torch.nn.conf import LambdaLayer
    from torch_twins import mln_conf

    conf = mln_conf(pkg(False), lambda p: [
        p.Ly.DenseLayer(n_out=8, activation="identity"),
        LambdaLayer(fn=lambda x: torch.tanh(x) * 2.0),
        p.Ly.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
        lambda t: t.feedForward(4))
    net = pkg(False).MLN(conf, device="cpu").init()
    rs = np.random.RandomState(0)
    x = rs.randn(32, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    net.fit(x, y)
    s0 = net.score()
    for _ in range(20):
        net.fit(x, y)
    assert net.score() < s0
    acts = net.feedForward(x)
    close(acts[2], np.tanh(np.asarray(acts[1].detach())) * 2.0, TOL)
    with pytest.raises(TypeError, match="LambdaLayer"):
        conf.to_json()
    with pytest.raises(ValueError, match="fn"):
        LambdaLayer().apply({}, {}, torch.ones((2, 3)), False, None)


def test_deconvolution3d_refuses_dilation_like_jax():
    for p in (pkg(False), pkg(True)):
        with pytest.raises(ValueError, match="dilation"):
            p.X.Deconvolution3D(n_in=1, n_out=1, dilation=2)


def test_permute_reshape_and_lc1d_refuse_what_jax_refuses():
    import jax

    for p in (pkg(False), pkg(True)):
        with pytest.raises(ValueError, match="unsupported"):
            p.X.PermuteLayer(dims=(2, 1)).output_type(
                p.C.InputType.feedForward(3))
        with pytest.raises(ValueError, match="unsupported"):
            p.X.ReshapeLayer(target_shape=(1, 2, 3, 4)).output_type(
                p.C.InputType.feedForward(24))
    it = InputType.recurrent(2)
    with pytest.raises(ValueError, match="fixed sequence length"):
        pkg(False).X.LocallyConnected1D(n_in=2, n_out=2).init_params(
            torch.Generator(), it, torch.float32, "cpu")
    with pytest.raises(ValueError, match="fixed sequence length"):
        pkg(True).X.LocallyConnected1D(n_in=2, n_out=2).init_params(
            jax.random.key(0), pkg(True).C.InputType.recurrent(2), None)


# -------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    # full f32 on the card: cuDNN would take TF32 for f32 convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


@pytest.mark.cuda
@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_cuda_op_matches_the_cpu(card, case):
    _, fn, _, shapes = case
    card_vs_cpu(fn, [_rand(*s, seed=i) for i, s in enumerate(shapes)], card,
                TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECONV_CASES + POOL1D_CASES + POOL3D_CASES,
                         ids=[str(c) for c in DECONV_CASES + POOL1D_CASES
                              + POOL3D_CASES])
def test_cuda_deconv_and_pools_match_the_cpu(card, case):
    if len(case) == 5:
        h, w, k, s, pad = case
        card_vs_cpu(lambda x, wt: tnn.deconv2d(x, wt, None, (s, s), pad),
                    [_rand(2, h, w, 3), _rand(k, k, 3, 4, seed=1)], card,
                    TOL)
    elif case[0].endswith("1d"):
        f, pad = case
        card_vs_cpu(lambda x: getattr(tnn, f)(x, 3, 2, pad),
                    [_rand(2, 11, 3)], card, TOL)
    else:
        f, pad = case
        card_vs_cpu(lambda x: getattr(tnn, f)(x, (2, 3, 2), (2, 2, 1), pad),
                    [_rand(2, 5, 7, 4, 2)], card, TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["maxpool1d", "maxpool3d"])
def test_cuda_max_pool_ties_go_to_the_first_maximum(card, what):
    x = _kink_x((2, 4, 6, 4, 2) if what == "maxpool3d" else (2, 12, 3), 2)
    fn = (lambda x: tnn.maxpool3d(x, 2, 2, "SAME")) if what == "maxpool3d" \
        else (lambda x: tnn.maxpool1d(x, 3, 2, "SAME"))
    card_vs_cpu(fn, [x], card, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LAYER_CASES)])
def test_cuda_layer_matches_the_cpu(card, case):
    kind, kw, ik, dims = case
    t = pkg(False)
    layer = getattr(t.X, kind)(**kw)
    p = layer.init_params(torch.Generator().manual_seed(0),
                          _it(t, ik, dims), torch.float32, "cpu")
    names = sorted(p)
    arrays = [_rand(2, *(dims[::-1] if ik == "rnn" else dims), seed=7)] + [
        _rand(*p[k].shape, seed=8 + i, scale=0.5)
        for i, k in enumerate(names)]
    card_vs_cpu(lambda x, *ps: layer.apply(dict(zip(names, ps)), {}, x,
                                           False, None)[0], arrays, card,
                TOL)
