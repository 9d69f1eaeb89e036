"""PyTorch port, the activations (``activations/__init__.py`` through
``ops/transforms.py``) and the losses (``loss/__init__.py``) against the
JAX package's on the same numpy inputs at f32: every one of the 20
activations and 18 losses, value and gradient, the parametrised
activations through ``ActivationLayer(alpha=...)``, and the loss's fused
softmax/sigmoid cases and mask semantics (``compute_loss``: per-example
``[N]`` and ``[N, 1]`` masks, per-timestep ``[N, T]`` and ``[N, T, 1]``
masks on ``[N, T, C]`` outputs).

Tolerances: values and gradients 1e-6 absolute plus 1e-5 relative (f32
elementwise formulas; the two frameworks' transcendental functions and
reductions round in another order). Gradients are ``torch.autograd``'s
against ``jax.grad``'s of the same scalar (a weighted sum of the
activation; the loss itself), with respect to the input or the
pre-activation.
"""

import zlib

import numpy as np
import pytest
import torch

try:  # the JAX package is the CPU tests' reference; the card's machine
    #   has none, and runs only this file's cuda tests
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.activations import Activation as JActivation
    from deeplearning4j_tpu.loss import LossFunction as JLoss
    from deeplearning4j_tpu.loss import compute_loss as jax_compute_loss
    from deeplearning4j_tpu.nn.conf import layers as jlayers
except ModuleNotFoundError:
    jax = None

from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.loss import LossFunction, compute_loss
from deeplearning4j_tpu_torch.nn.conf import ActivationLayer
from deeplearning4j_tpu_torch.ops import registry

ATOL, RTOL = 1e-6, 1e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# ---------------------------------------------------------- activations
@pytest.mark.parametrize("name", [a.value for a in Activation])
def test_activation_value_and_gradient_match_jax(name):
    assert Activation.resolve(name).value == name
    rs = np.random.RandomState(zlib.crc32(name.encode()))
    # away from the kinks (0, +-1, 6) where the subgradients may differ
    x = rs.uniform(-3, 3, (6, 7)).astype(np.float32)
    x = np.where(np.abs(x) < 0.05, 0.3, x)
    x = np.where(np.abs(np.abs(x) - 1) < 0.05, 1.4, x).astype(np.float32)
    w = rs.randn(6, 7).astype(np.float32)
    fn, jfn = Activation.resolve(name).fn, JActivation.resolve(name).fn
    t = torch.from_numpy(x).requires_grad_(True)
    y = fn(t)
    _close(y.detach().numpy(), jfn(jnp.asarray(x)))
    (g,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)), t)
    jg = jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x))
    _close(g.numpy(), jg)


@pytest.mark.parametrize("name", ["sigmoid", "tanh", "gelu", "softplus",
                                  "swish", "softmax"])
def test_activation_in_bf16_keeps_the_dtype(name):
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    y = Activation.resolve(name).fn(torch.from_numpy(x).to(torch.bfloat16))
    jy = JActivation.resolve(name).fn(jnp.asarray(x, jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), atol=2 ** -7,
                               rtol=2 ** -7)


@pytest.mark.parametrize("name, alpha", [("leakyrelu", 0.2), ("elu", 0.5),
                                         ("thresholdedrelu", 0.3)])
def test_activation_layer_alpha_matches_jax(name, alpha):
    x = np.random.RandomState(2).uniform(-2, 2, (5, 6)).astype(np.float32)
    layer = ActivationLayer(activation=name, alpha=alpha)
    jlayer = jlayers.ActivationLayer(activation=name, alpha=alpha)
    out, _ = layer.apply({}, {}, torch.from_numpy(x), False, None)
    jout, _ = jlayer.apply({}, {}, jnp.asarray(x), False, None)
    _close(out.numpy(), jout)
    # the alpha changes the function
    plain, _ = ActivationLayer(activation=name).apply(
        {}, {}, torch.from_numpy(x), False, None)
    assert not torch.equal(plain, out)


def test_activations_are_the_port_registrys_under_the_jax_names():
    import deeplearning4j_tpu.ops  # noqa: F401  (registers the JAX ops)
    from deeplearning4j_tpu.ops.registry import has_op as jax_has_op

    assert {a.value for a in Activation} == {a.value for a in JActivation}
    for a in Activation:
        if a is Activation.IDENTITY:
            continue
        assert registry.has_op(a.value) and jax_has_op(a.value)
        assert a.fn is registry.get_op(a.value)


# --------------------------------------------------------------- losses
def _labels(loss: str, shape, rs):
    """Labels in each loss's domain."""
    if loss == "sparse_mcxent":
        return rs.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    if loss in ("hinge", "squared_hinge", "wasserstein"):
        return np.where(rs.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)
    if loss in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        return np.eye(shape[-1], dtype=np.float32)[
            rs.randint(0, shape[-1], shape[:-1])]
    if loss in ("xent", "reconstruction_crossentropy"):
        return (rs.rand(*shape) < 0.5).astype(np.float32)
    if loss == "poisson":
        return rs.poisson(2.0, shape).astype(np.float32)
    return rs.randn(*shape).astype(np.float32)


#: each loss with the activations it is used with: the fused pairs first
_LOSS_ACTS = {
    "mse": ("identity", "tanh"), "l1": ("identity",), "l2": ("identity",),
    "mae": ("identity",), "xent": ("sigmoid", "softmax"),
    "mcxent": ("softmax", "sigmoid"), "sparse_mcxent": ("softmax",),
    "kl_divergence": ("softmax",), "poisson": ("softplus",),
    "hinge": ("identity",), "squared_hinge": ("identity",),
    "cosine_proximity": ("identity",),
    "negativeloglikelihood": ("softmax", "sigmoid"), "mape": ("identity",),
    "msle": ("relu", "identity"), "huber": ("identity",),
    "wasserstein": ("identity",), "reconstruction_crossentropy":
        ("sigmoid",)}
_CASES = [(l, a) for l, acts in _LOSS_ACTS.items() for a in acts]


def test_every_loss_is_covered():
    assert set(_LOSS_ACTS) == {l.value for l in JLoss} == {
        l.value for l in LossFunction}


def _loss_pair(loss, act, labels, pre, mask=None):
    lt = torch.from_numpy(labels)
    pt = torch.from_numpy(pre).requires_grad_(True)
    mt = torch.from_numpy(mask) if mask is not None else None
    v = compute_loss(LossFunction.resolve(loss), lt, pt, act, mt)
    (g,) = torch.autograd.grad(v, pt)
    jm = jnp.asarray(mask) if mask is not None else None

    def f(p):
        return jax_compute_loss(JLoss.resolve(loss), jnp.asarray(labels), p,
                                act, jm)

    jv, jg = jax.value_and_grad(f)(jnp.asarray(pre))
    return (float(v), g.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("loss, act", _CASES)
def test_loss_value_and_gradient_match_jax(loss, act):
    rs = np.random.RandomState(len(loss) * 7 + len(act))
    pre = rs.randn(6, 5).astype(np.float32)
    (v, g), (jv, jg) = _loss_pair(loss, act, _labels(loss, (6, 5), rs), pre)
    assert np.isfinite(v)
    _close(v, jv)
    _close(g, jg)


_MASKED = [(l, a, m) for l, a in (("mcxent", "softmax"), ("mse", "identity"),
                                  ("xent", "sigmoid"),
                                  ("sparse_mcxent", "softmax"),
                                  ("huber", "identity"), ("mape", "identity"),
                                  ("kl_divergence", "softmax"))
           for m in ("example", "example_col", "step", "step_col")
           # sparse labels [N] take no mask beside an [N, C] output
           if not (l == "sparse_mcxent" and m.startswith("example"))]


@pytest.mark.parametrize("loss, act, mask_kind", _MASKED)
def test_masked_loss_matches_jax(loss, act, mask_kind):
    """Masks on ``[N, T, C]`` outputs: per example (``[N]``, ``[N, 1]``)
    or per timestep (``[N, T]``, ``[N, T, 1]``, folded into the example
    axis)."""
    rs = np.random.RandomState(3)
    n, t, c = 4, 5, 3
    if mask_kind.startswith("example"):
        pre = rs.randn(n, c).astype(np.float32)
        labels = _labels(loss, (n, c), rs)
        mask = (rs.rand(n) < 0.7).astype(np.float32)
        if mask_kind == "example_col":
            mask = mask[:, None]
    else:
        pre = rs.randn(n, t, c).astype(np.float32)
        labels = _labels(loss, (n, t, c), rs)
        mask = (rs.rand(n, t) < 0.7).astype(np.float32)
        if mask_kind == "step_col":
            mask = mask[..., None]
    (v, g), (jv, jg) = _loss_pair(loss, act, labels, pre, mask)
    _close(v, jv)
    _close(g, jg)


@pytest.mark.parametrize("loss, act", [("mcxent", "softmax"),
                                       ("mse", "identity")])
def test_all_ones_mask_equals_no_mask(loss, act):
    rs = np.random.RandomState(4)
    pre = rs.randn(3, 4, 5).astype(np.float32)
    labels = _labels(loss, (3, 4, 5), rs)
    (v, _), _ = _loss_pair(loss, act, labels, pre)
    (vm, _), _ = _loss_pair(loss, act, labels, pre,
                            np.ones((3, 4), np.float32))
    assert abs(v - vm) <= 1e-6 * abs(v)


def test_loss_aliases_resolve_as_jax():
    for alias in ("categorical_crossentropy",
                  "sparse_categorical_crossentropy",
                  "binary_crossentropy", "mean_squared_error",
                  "mean_absolute_error", "kld", "kullback_leibler_divergence",
                  "nll", "MCXENT", "mape", "msle"):
        assert LossFunction.resolve(alias).value == JLoss.resolve(alias).value
    with pytest.raises(ValueError, match="Unknown loss"):
        LossFunction.resolve("no_such_loss")


# ---------------------------------------------------------------- the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [a.value for a in Activation])
def test_cuda_activation_matches_the_cpu(name):
    """Each activation on a CUDA tensor against the same function on the
    CPU: value and gradient."""
    _needs_card()
    rs = np.random.RandomState(zlib.crc32(name.encode()))
    x = rs.uniform(-3, 3, (64, 33)).astype(np.float32)
    x = np.where(np.abs(x) < 0.05, 0.3, x)
    x = np.where(np.abs(np.abs(x) - 1) < 0.05, 1.4, x).astype(np.float32)
    w = rs.randn(64, 33).astype(np.float32)
    fn = Activation.resolve(name).fn
    out = []
    for dev in ("cuda", "cpu"):
        t = torch.from_numpy(x).to(dev).requires_grad_(True)
        y = fn(t)
        (g,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(w).to(dev)),
                                   t)
        out.append((y.detach().cpu().numpy(), g.cpu().numpy()))
    _close(out[0][0], out[1][0])
    _close(out[0][1], out[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("loss, act", _CASES)
def test_cuda_loss_matches_the_cpu(loss, act):
    """Each loss on CUDA tensors against the CPU, a per-timestep mask
    included: value and gradient."""
    _needs_card()
    rs = np.random.RandomState(len(loss) * 7 + len(act))
    pre = rs.randn(4, 6, 5).astype(np.float32)
    labels = _labels(loss, (4, 6, 5), rs)
    mask = (rs.rand(4, 6) < 0.7).astype(np.float32)
    out = []
    for dev in ("cuda", "cpu"):
        pt = torch.from_numpy(pre).to(dev).requires_grad_(True)
        v = compute_loss(LossFunction.resolve(loss),
                         torch.from_numpy(labels).to(dev), pt, act,
                         torch.from_numpy(mask).to(dev))
        (g,) = torch.autograd.grad(v, pt)
        out.append((float(v), g.cpu().numpy()))
    _close(out[0][0], out[1][0])
    _close(out[0][1], out[1][1])
