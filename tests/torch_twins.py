"""Helpers of the layer framework's parity tests
(``tests/test_torch_layers_extra.py``, ``test_torch_gru.py``,
``test_torch_attention_layers.py``): the framework of either package as
one namespace, so one function builds the same configuration in both;
twin networks, the JAX one and the port's restored from its
ModelSerializer zip (configuration and weights carried, never
re-initialised); training trajectories; closeness relative to max(1,
max |value|). JAX is imported inside the functions that reach it, so the
card's cuda tests (which have no JAX) import this module too.
"""

import math
import os
import types

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def numpy_weights(monkeypatch):
    """The JAX layers' ``init_weights`` drawing Glorot normal weights from
    numpy (a module that imports this fixture uses it in every test): the
    JAX package's own draws compile once per weight shape on the CPU, and
    the weights go across to the port, so how they were drawn does not
    matter to the comparison. Without JAX (the card's machine), nothing."""
    try:
        import jax.numpy as jnp
        from deeplearning4j_tpu.nn.conf import layers, layers_extra
    except ModuleNotFoundError:
        return
    rs = np.random.RandomState(11)

    def init_weights(scheme, key, shape, fan_in, fan_out, dtype=None,
                     gain=1.0):
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return jnp.asarray(rs.standard_normal(shape) * std,
                           dtype or jnp.float32)

    for mod in (layers, layers_extra):
        monkeypatch.setattr(mod, "init_weights", init_weights)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def close(got, want, tol, what=""):
    """``|got - want| <= tol * max(1, max |want|)`` everywhere."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def pkg(jax_side: bool):
    """The layer framework of one package: learning (``L``), ``nn.conf``
    (``C``), its ``layers`` (``Ly``) and ``layers_extra`` (``X``),
    ``nn.graph`` (``G``) and ``MultiLayerNetwork`` (``MLN``)."""
    if jax_side:
        from deeplearning4j_tpu import learning as L
        from deeplearning4j_tpu.nn import conf as C
        from deeplearning4j_tpu.nn import graph as G
        from deeplearning4j_tpu.nn.conf import layers as Ly
        from deeplearning4j_tpu.nn.conf import layers_extra as X
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as M
    else:
        from deeplearning4j_tpu_torch import learning as L
        from deeplearning4j_tpu_torch.nn import conf as C
        from deeplearning4j_tpu_torch.nn import graph as G
        from deeplearning4j_tpu_torch.nn.conf import layers as Ly
        from deeplearning4j_tpu_torch.nn.conf import layers_extra as X
        from deeplearning4j_tpu_torch.nn.multilayer import (
            MultiLayerNetwork as M)
    return types.SimpleNamespace(L=L, C=C, G=G, Ly=Ly, X=X, MLN=M)


def mln_conf(p, layers, input_type, seed=7, updater=None, dropout=None):
    """A ``MultiLayerConfiguration`` of ``layers(p)`` in package ``p``
    (Adam at lr 1e-3 unless ``updater(p)`` says otherwise)."""
    b = p.C.NeuralNetConfiguration.builder().seed(seed).updater(
        updater(p) if updater else p.L.Adam(learning_rate=1e-3))
    if dropout is not None:
        b = b.dropOut(dropout)
    lb = b.list()
    for layer in layers(p):
        lb = lb.layer(layer)
    return lb.setInputType(input_type(p.C.InputType)).build()


def twins(layers, input_type, tmp_path, name="twin", **kw):
    """The JAX network and the port's twin: the port's builder must give
    JAX's JSON, before ``init()`` and after it (where layers write the
    fields they infer), and the port's network is the JAX zip restored."""
    from deeplearning4j_tpu.util import ModelSerializer as JSerializer
    from deeplearning4j_tpu_torch.util.model_serializer import \
        ModelSerializer

    jconf = mln_conf(pkg(True), layers, input_type, **kw)
    conf = mln_conf(pkg(False), layers, input_type, **kw)
    assert conf.to_json() == jconf.to_json()
    jnet = pkg(True).MLN(jconf).init()
    own = pkg(False).MLN(conf, device="cpu").init()
    assert own.conf.to_json() == jnet.conf.to_json()
    path = os.path.join(str(tmp_path), f"{name}.zip")
    JSerializer.writeModel(jnet, path)
    net = ModelSerializer.restore(path, device="cpu")
    assert net.conf.to_json() == jnet.conf.to_json()
    return jnet, net


def params_close(got, want, atol, what="params"):
    """Two parameter trees (dicts, lists) equal within ``atol``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
        for k in want:
            params_close(got[k], want[k], atol, f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            params_close(g, w, atol, f"{what}/{i}")
    else:
        np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=atol,
                                   err_msg=what)


def trajectory(jnet, net, x, y, steps, loss_rtol, param_atol, params_of):
    """``steps`` fits of both networks on one batch: each loss within
    ``loss_rtol`` relative, then the parameters (``params_of(model)``)
    within ``param_atol``. Returns the port's losses."""
    import jax

    losses = []
    for _ in range(steps):
        jnet.fit(x, y)
        net.fit(x, y)
        lj, lt = jnet.score(), net.score()
        assert abs(lt - lj) <= loss_rtol * max(1.0, abs(lj)), (lt, lj)
        losses.append(lt)
    params_close(params_of(net), jax.device_get(params_of(jnet)),
                 param_atol)
    return losses


def pair(fn, jfn, arrays, tol):
    """``fn`` (torch) and ``jfn`` (JAX) on the same numpy arrays: the
    values and the gradients of ``sum(out * r)`` with respect to every
    floating array."""
    import jax
    import jax.numpy as jnp

    ts = [torch.from_numpy(a).requires_grad_(a.dtype.kind == "f")
          for a in arrays]
    out = fn(*ts)
    r = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    idx = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)),
                                [ts[i] for i in idx])

    def f(*a):
        o = jfn(*a)
        return jnp.sum(o * r), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(idx), has_aux=True))(
        *[jnp.asarray(a) for a in arrays])
    close(out, jout, tol, "value")
    for i, g, jg in zip(idx, grads, jgrads):
        close(g, jg, tol, f"gradient {i}")


def card_vs_cpu(fn, arrays, device, tol):
    """``fn`` forward and backward (of ``sum(out * r)``) on the card and on
    the CPU from the same arrays, within ``tol``."""
    res = []
    for dev in (device, "cpu"):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True)
              for a in arrays]
        out = fn(*ts)
        r = torch.from_numpy(np.random.RandomState(9).randn(
            *out.shape).astype(np.float32)).to(dev)
        res.append([out] + list(torch.autograd.grad(torch.sum(out * r),
                                                    ts)))
    for i, (a, b) in enumerate(zip(*res)):
        close(a, b, tol, f"value {i}")
