"""PyTorch port, layerwise pretraining and its layers
(``nn/conf/variational.py``, ``nn/conf/ocnn.py``, ``pretrainLayer`` /
``pretrain`` / ``reconstructionLogProbability`` of both networks) against
the JAX package.

The noise has a seam: the VAE's reparameterisation draws ``eps`` and the
autoencoder's corruption mask ``keep`` are arguments of the port's loss
functions, so each test hands the port JAX's own draws (``jax.random``
from the key JAX's loss is given) and holds the loss and its gradients to
JAX's within 1e-5 (relative to max(1, |value|)). Pretrain trajectories
over three steps (losses 1e-5 relative, parameters 1e-4 absolute) run
where the layer is deterministic (the autoencoder at corruption 0) and
for the VAE with JAX's draws carried into the step through the seam.
OCNN's hinge takes JAX's gradient at a tie (half), planted here.
"""

import math
import os

import numpy as np
import pytest
import torch

try:  # the JAX package is the CPU tests' reference
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.learning import Adam as JAdam
    from deeplearning4j_tpu.learning import Sgd as JSgd
    from deeplearning4j_tpu.nn.conf import InputType as JInputType
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.nn.conf import ocnn as jocnn
    from deeplearning4j_tpu.nn.conf import variational as jvar
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraphConfiguration as JCGC)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.util import ModelSerializer as JSerializer
    JAX_INIT_MODULES = (jl, jvar, jocnn)
except ModuleNotFoundError:
    jax = None

from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf import ocnn as tocnn
from deeplearning4j_tpu_torch.nn.conf import variational as tvar
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.params import cg_params_from_numpy
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

RTOL, LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def numpy_weights(monkeypatch):
    """The JAX layers' ``init_weights`` drawing Glorot normal weights from
    numpy: the JAX package's own draws compile once per weight shape on
    the CPU, and the weights go across to the port, so how they were drawn
    does not matter to the comparison."""
    if jax is None:
        return
    rs = np.random.RandomState(11)

    def init_weights(scheme, key, shape, fan_in, fan_out, dtype=None,
                     gain=1.0):
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return jnp.asarray(rs.standard_normal(shape) * std,
                           dtype or jnp.float32)

    for mod in JAX_INIT_MODULES:
        monkeypatch.setattr(mod, "init_weights", init_weights)


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, (err, scale)


def _vae_kw(dist):
    return dict(n_in=6, n_out=3, encoder_layer_sizes=(7, 5),
                decoder_layer_sizes=(5,), reconstruction_distribution=dist,
                activation="tanh", pzx_activation="identity",
                reconstruction_activation=("sigmoid" if dist == "gaussian"
                                           else "identity"),
                num_samples=3, weight_init="xavier")


def _layer_params(jlayer, seed=0):
    it = JInputType.feedForward(jlayer.n_in)
    return jax.device_get(jlayer.init_params(jax.random.PRNGKey(seed), it,
                                             jnp.float32))


def _torch_params(p):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True)
            for k, v in p.items()}


def _x(n=8, d=6, seed=1, unit=True):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, d) if unit else rs.randn(n, d)).astype(np.float32)


def _compare_grads(jgrads, params):
    for k, v in jgrads.items():
        assert params[k].grad is not None, k
        _close(_np(params[k].grad), v)


# ------------------------------------------------------------------- VAE
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_vae_elbo_and_gradients_match_jax(dist):
    jlayer = jvar.VariationalAutoencoder(**_vae_kw(dist))
    layer = tvar.VariationalAutoencoder(**_vae_kw(dist))
    p = _layer_params(jlayer)
    x = _x()
    key = jax.random.PRNGKey(5)
    eps = jax.random.normal(key, (3, 8, 3), jnp.float32)
    want, jg = jax.jit(jax.value_and_grad(
        lambda q: jlayer.unsupervised_loss(q, jnp.asarray(x), key)))(p)
    tp = _torch_params(p)
    got = layer.unsupervised_loss(tp, torch.from_numpy(x), None,
                                  eps=torch.from_numpy(np.array(eps)))
    got.backward()
    _close(float(got.detach()), float(want))
    _compare_grads(jax.device_get(jg), tp)
    # the supervised path: the latent mean through pzx_activation
    out, _ = layer.apply(tp, {}, torch.from_numpy(x), False, None)
    jout, _ = jlayer.apply(p, {}, jnp.asarray(x), False, None)
    _close(_np(out), jout)


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_vae_reconstruction_log_prob_matches_jax(dist):
    jlayer = jvar.VariationalAutoencoder(**_vae_kw(dist))
    layer = tvar.VariationalAutoencoder(**_vae_kw(dist))
    p = _layer_params(jlayer, seed=2)
    x = _x(seed=3)
    key = jax.random.PRNGKey(9)
    eps = jax.random.normal(key, (16, 8, 3), jnp.float32)
    want = jax.jit(lambda q: jlayer.reconstruction_log_prob(
        q, jnp.asarray(x), key, 16))(p)
    jg = jax.jit(jax.grad(lambda q: jnp.sum(jlayer.reconstruction_log_prob(
        q, jnp.asarray(x), key, 16))))(p)
    tp = _torch_params(p)
    got = layer.reconstruction_log_prob(tp, torch.from_numpy(x), None, 16,
                                        eps=torch.from_numpy(np.array(eps)))
    assert got.shape == (8,)
    _close(_np(got), want)
    got.sum().backward()
    _compare_grads(jax.device_get(jg), tp)


def test_vae_draws_from_the_generator():
    layer = tvar.VariationalAutoencoder(**_vae_kw("bernoulli"))
    p = {k: torch.from_numpy(np.array(v)) for k, v in _layer_params(
        jvar.VariationalAutoencoder(**_vae_kw("bernoulli"))).items()}
    x = torch.from_numpy(_x())
    a = layer.unsupervised_loss(p, x, torch.Generator().manual_seed(1))
    b = layer.unsupervised_loss(p, x, torch.Generator().manual_seed(1))
    c = layer.unsupervised_loss(p, x, torch.Generator().manual_seed(2))
    assert float(a) == float(b) and float(a) != float(c)
    with pytest.raises(ValueError, match="reconstruction_distribution"):
        tvar.VariationalAutoencoder(n_in=2, n_out=1,
                                    reconstruction_distribution="poisson"
                                    )._dist_size()


# ----------------------------------------------------------- autoencoder
AE_CASES = [dict(corruption_level=0.3, sparsity=0.0, activation="sigmoid",
                 loss="mse"),
            dict(corruption_level=0.0, sparsity=0.1, activation="identity",
                 loss="mse"),
            dict(corruption_level=0.0, sparsity=0.2, activation="sigmoid",
                 loss="xent")]


@pytest.mark.parametrize("kw", AE_CASES, ids=["mse", "sparse-tie", "xent"])
def test_autoencoder_loss_and_gradients_match_jax(kw):
    jlayer = jvar.AutoEncoder(n_in=6, n_out=4, **kw)
    layer = tvar.AutoEncoder(n_in=6, n_out=4, **kw)
    p = _layer_params(jlayer, seed=4)
    x = _x(seed=5)
    if kw["sparsity"] and kw["activation"] == "identity":
        # a hidden unit at exactly 0 for the first example: the sparsity
        # term's |h| takes JAX's slope (1) there
        x[0] = 0.0
        x[0, 0] = 1.0
        p = dict(p, b=np.array(p["b"]))
        p["b"][0] = -np.asarray(p["W"])[0, 0]
    key = jax.random.PRNGKey(11)
    keep = jax.random.bernoulli(key, 1.0 - kw["corruption_level"], x.shape)
    want, jg = jax.jit(jax.value_and_grad(
        lambda q: jlayer.unsupervised_loss(q, jnp.asarray(x), key)))(p)
    tp = _torch_params(p)
    got = layer.unsupervised_loss(tp, torch.from_numpy(x), None,
                                  keep=torch.from_numpy(np.array(keep)))
    got.backward()
    _close(float(got.detach()), float(want))
    _compare_grads(jax.device_get(jg), tp)


# -------------------------------------------------------------- networks
def _ae_conf():
    return (JNNC.builder().seed(3).updater(JAdam(1e-2)).l2(1e-3).l1(1e-3)
            .gradientNormalization("ClipL2PerLayer", 0.5).list()
            .layer(jl.DenseLayer(n_out=6, activation="tanh"))
            .layer(jvar.AutoEncoder(n_out=4, corruption_level=0.0,
                                    sparsity=0.05))
            .layer(jl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .setInputType(JInputType.feedForward(5)).build())


def _restored(jnet, tmp_path, name):
    path = os.path.join(tmp_path, f"{name}.zip")
    JSerializer.writeModel(jnet, path)
    return ModelSerializer.restore(path, device="cpu")


def _snap(tree):
    return {(str(a), b): _np(v).copy() for a, p in tree.items()
            for b, v in p.items()}


def test_mln_autoencoder_pretrain_follows_jax(tmp_path):
    jnet = JMLN(_ae_conf()).init()
    net = _restored(jnet, tmp_path, "ae")
    assert type(net.conf.layers[1]).__name__ == "AutoEncoder"
    x = _x(n=12, d=5, unit=False)
    others = _snap({i: net.params_list[i] for i in (0, 2)})
    opt_others = [net.opt_states[i] for i in (0, 2)]
    for step in range(3):
        jnet.pretrainLayer(1, x)
        net.pretrainLayer(1, x)
        lj, lt = float(jnet.score()), net.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (step, lt, lj)
    assert net.getIterationCount() == jnet.getIterationCount() == 3
    for k, v in jax.device_get(jnet.params_list[1]).items():
        err = float(np.abs(_np(net.params_list[1][k]) - v).max())
        assert err <= PARAM_ATOL, (k, err)
    # pretraining touches its layer only
    for k, v in _snap({i: net.params_list[i] for i in (0, 2)}).items():
        assert np.array_equal(v, others[k]), k
    assert [net.opt_states[i] for i in (0, 2)] == opt_others
    # pretrain() runs every pretrainable layer: here the one
    net.pretrain(x)
    jnet.pretrain(x)
    _close(net.score(), float(jnet.score()), LOSS_RTOL)


def test_graph_autoencoder_pretrain_follows_jax():
    def conf():
        return (JCGC.graphBuilder().seed(4).updater(JSgd(0.2)).l2(1e-3)
                .addInputs("in")
                .addLayer("fe", jl.DenseLayer(n_out=6, activation="tanh"),
                          "in")
                .addLayer("ae", jvar.AutoEncoder(n_out=3,
                                                 corruption_level=0.0),
                          "fe")
                .addLayer("out", jl.OutputLayer(n_out=2, loss="mcxent",
                                                activation="softmax"), "ae")
                .setOutputs("out").setInputTypes(JInputType.feedForward(5))
                .build())

    jg = JCG(conf()).init()
    g = ComputationGraph(ComputationGraphConfiguration.from_json(
        jg.conf.to_json()), device="cpu").init()
    g.params_map = cg_params_from_numpy(g.conf.nodes,
                                        jax.device_get(jg.params_map),
                                        device="cpu")
    x = _x(n=10, d=5, unit=False)
    fe = _snap({"fe": g.params_map["fe"]})
    for _ in range(3):
        jg.pretrainLayer("ae", x)
        g.pretrainLayer("ae", [x])
        lj, lt = float(jg.score()), g.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    for k, v in jax.device_get(jg.params_map["ae"]).items():
        err = float(np.abs(_np(g.params_map["ae"][k]) - v).max())
        assert err <= PARAM_ATOL, (k, err)
    for k, v in _snap({"fe": g.params_map["fe"]}).items():
        assert np.array_equal(v, fe[k])
    g.pretrain(x)
    assert g.getIterationCount() == 4


def _vae_net_conf():
    return (JNNC.builder().seed(5).updater(JAdam(1e-3)).l2(1e-4).list()
            .layer(jvar.VariationalAutoencoder(
                n_out=3, encoder_layer_sizes=(8, 8),
                decoder_layer_sizes=(8, 8), activation="leakyrelu",
                reconstruction_distribution="bernoulli",
                pzx_activation="identity", num_samples=2))
            .layer(jl.OutputLayer(n_out=2, loss="mcxent",
                                  activation="softmax"))
            .setInputType(JInputType.feedForward(6)).build())


def test_mln_vae_pretrain_follows_jax_with_its_draws(tmp_path, monkeypatch):
    """Three VAE pretrain steps of the network with JAX's draws handed to
    the port through the ``eps`` seam, then the anomaly score."""
    jnet = JMLN(_vae_net_conf()).init()
    net = _restored(jnet, tmp_path, "vae")
    x = _x(n=10)
    draws = []
    real = tvar.VariationalAutoencoder.unsupervised_loss

    def with_jax_eps(self, params, xx, generator, eps=None):
        return real(self, params, xx, generator, eps=draws.pop(0))

    monkeypatch.setattr(tvar.VariationalAutoencoder, "unsupervised_loss",
                        with_jax_eps)
    for _ in range(3):
        _, sub = jax.random.split(jnet._rng_key)
        draws.append(torch.from_numpy(np.array(jax.random.normal(
            sub, (2, 10, 3), jnp.float32))))
        jnet.pretrainLayer(0, x)
        net.pretrainLayer(0, x)
        lj, lt = float(jnet.score()), net.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    for k, v in jax.device_get(jnet.params_list[0]).items():
        err = float(np.abs(_np(net.params_list[0][k]) - v).max())
        assert err <= PARAM_ATOL, (k, err)
    # the score: importance sampling over 16 draws of the generator;
    # finite, per example, and within the spread of JAX's own estimate
    s = net.reconstructionLogProbability(0, x, num_samples=16)
    js = np.asarray(jnet.reconstructionLogProbability(0, x, 16).jax)
    assert s.shape == (10,) and torch.all(torch.isfinite(s))
    assert float(np.abs(_np(s) - js).max()) <= 0.5 * float(np.abs(js).max())


def test_not_pretrainable_errors_match_jax():
    jnet = JMLN(_vae_net_conf()).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    x = _x(n=4)
    for n in (jnet, net):
        with pytest.raises(ValueError, match=r"layer 1 \(OutputLayer\) is "
                                             r"not pretrainable"):
            n.pretrainLayer(1, x)
        with pytest.raises(ValueError, match="not a VariationalAutoencoder"):
            n.reconstructionLogProbability(1, x)
    g = ComputationGraph(ComputationGraphConfiguration.graphBuilder()
                         .addInputs("in")
                         .addLayer("out", net.conf.layers[1], "in")
                         .setOutputs("out")
                         .setInputTypes(net.conf.input_type).build(),
                         device="cpu").init()
    with pytest.raises(ValueError, match="'out' is not pretrainable"):
        g.pretrainLayer("out", x)


# ------------------------------------------------------------------ OCNN
def test_ocnn_loss_and_gradient_at_a_tie_match_jax():
    jlayer = jocnn.OCNNOutputLayer(n_in=5, hidden_size=4, nu=0.1)
    layer = tocnn.OCNNOutputLayer(n_in=5, hidden_size=4, nu=0.1)
    p = _layer_params(jlayer, seed=6)
    assert p["r"].dtype == np.float32 and p["r"].shape == ()
    x = _x(n=6, d=5, unit=False)
    s = np.maximum(x @ np.asarray(p["V"]), 0) @ np.asarray(p["W"])
    p = dict(p, r=np.float32(s[2]))            # a tie: r == score
    y = np.zeros((6, 1), np.float32)
    want, jg = jax.jit(jax.value_and_grad(lambda q: jlayer.loss_value(
        q, {}, jnp.asarray(x), jnp.asarray(y))))(p)
    tp = _torch_params(p)
    got = layer.loss_value(tp, {}, torch.from_numpy(x), torch.from_numpy(y))
    got.backward()
    _close(float(got.detach()), float(want))
    _compare_grads(jax.device_get(jg), tp)
    out, _ = layer.apply(tp, {}, torch.from_numpy(x), False, None)
    jout, _ = jlayer.apply(p, {}, jnp.asarray(x), False, None)
    assert out.shape == (6, 1)
    _close(_np(out), jout)


def test_ocnn_fit_follows_jax(tmp_path):
    jnet = JMLN(JNNC.builder().seed(6).updater(JSgd(0.05)).list()
                .layer(jl.DenseLayer(n_out=5, activation="tanh"))
                .layer(jocnn.OCNNOutputLayer(hidden_size=6, nu=0.2))
                .setInputType(JInputType.feedForward(4)).build()).init()
    net = _restored(jnet, tmp_path, "ocnn")
    assert net.params_list[1]["r"].dtype == torch.float32
    x = _x(n=12, d=4, unit=False)
    y = np.zeros((12, 1), np.float32)
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        lj, lt = float(jnet.score()), net.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    for i, p in enumerate(jax.device_get(jnet.params_list)):
        for k, v in p.items():
            err = float(np.abs(_np(net.params_list[i][k]) - v).max())
            assert err <= PARAM_ATOL, (i, k, err)


@pytest.mark.parametrize("which", ["vae", "ae", "ocnn"])
def test_jax_zip_of_each_layer_restores(tmp_path, which):
    layer = {"vae": jvar.VariationalAutoencoder(n_out=2,
                                                encoder_layer_sizes=(5,),
                                                decoder_layer_sizes=(4,)),
             "ae": jvar.AutoEncoder(n_out=3),
             "ocnn": jocnn.OCNNOutputLayer(hidden_size=3)}[which]
    b = JNNC.builder().seed(8).list().layer(layer)
    if which != "ocnn":
        b.layer(jl.OutputLayer(n_out=2, loss="mcxent", activation="softmax"))
    jnet = JMLN(b.setInputType(JInputType.feedForward(4)).build()).init()
    net = _restored(jnet, tmp_path, which)
    assert net.conf.to_json() == jnet.conf.to_json()
    assert net.summary() == jnet.summary()
    x = _x(n=5, d=4)
    _close(_np(net.output(x)), np.asarray(jnet.output(x).jax))


# ---------------------------------------------------------------- the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_cuda_vae_loss_and_gradients_match_the_cpu(dist):
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    layer = tvar.VariationalAutoencoder(**_vae_kw(dist))
    g = torch.Generator().manual_seed(0)
    p = layer.init_params(g, None, torch.float32, "cpu")
    x = torch.from_numpy(_x())
    eps = torch.randn((3, 8, 3), generator=g)
    got = []
    for dev in ("cuda", "cpu"):
        tp = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        loss = layer.unsupervised_loss(tp, x.to(dev), None, eps=eps.to(dev))
        grads = torch.autograd.grad(loss, list(tp.values()))
        got.append((float(loss), [_np(t) for t in grads]))
    _close(got[0][0], got[1][0])
    for a, b in zip(got[0][1], got[1][1]):
        _close(a, b)


@pytest.mark.cuda
def test_cuda_ocnn_and_autoencoder_losses_match_the_cpu():
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    x = torch.from_numpy(_x(n=16, d=5, unit=False))
    oc = tocnn.OCNNOutputLayer(n_in=5, hidden_size=4)
    ae = tvar.AutoEncoder(n_in=5, n_out=3, corruption_level=0.0,
                          sparsity=0.1)
    po = oc.init_params(g, None, torch.float32, "cpu")
    pa = ae.init_params(g, None, torch.float32, "cpu")
    vals = []
    for dev in ("cuda", "cpu"):
        lo = oc.loss_value({k: v.to(dev) for k, v in po.items()}, {},
                           x.to(dev), None)
        la = ae.unsupervised_loss({k: v.to(dev) for k, v in pa.items()},
                                  x.to(dev), None)
        vals.append((float(lo), float(la)))
    _close(vals[0][0], vals[1][0])
    _close(vals[0][1], vals[1][1])
