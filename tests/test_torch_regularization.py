"""PyTorch port, the per-layer regularisation configs
(``nn/conf/dropout.py``, ``weightnoise.py``, ``constraint.py``) against the
JAX package.

The constraints are deterministic: each is held to JAX's result within
1e-6. The stochastic configs keep JAX's distribution, not its threefry
draws, so each is held to its distribution: on 131,072 entries the kept
fraction and the mean within seven standard deviations of the values the
config promises (for the number of independent draws: one an entry, one
a channel for ``SpatialDropout``), the mean of a noise within 0.02 and
its variance within 5 %, and JAX's own draws meet the same bounds on the
same input. A layer
holding an ``IDropout``, weight noise or constraints trains through
``MultiLayerNetwork`` and ``ComputationGraph``; where the step is
deterministic (constraints, inference) its trajectory follows JAX's over
three steps (losses 1e-5 relative, parameters 1e-4 absolute). Every config
round-trips to JAX's JSON, so the stand-in that refused the three fields
is gone.

C14: the l1 term took ``torch.abs``'s gradient (0) at a weight of exactly
0, where ``jnp.abs`` takes slope 1; its test plants such weights.
"""

import math

import numpy as np
import pytest
import torch

try:  # the JAX package is the CPU tests' reference
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.learning import Sgd as JSgd
    from deeplearning4j_tpu.nn.conf import InputType as JInputType
    from deeplearning4j_tpu.nn.conf import (
        NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.conf import constraint as jc
    from deeplearning4j_tpu.nn.conf import dropout as jd
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.nn.conf import weightnoise as jw
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraphConfiguration as JCGC)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    JAX_INIT_MODULES = (jl,)
except ModuleNotFoundError:
    jax = None

from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration, constraint as tc, dropout as td,
    weightnoise as tw)
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, DropoutLayer
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.params import (cg_params_from_numpy,
                                             mln_params_from_numpy)

CONSTRAINT_ATOL = 1e-6
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
MEAN_ATOL, VAR_RTOL, SIGMAS = 0.02, 0.05, 7.0
SHAPE = (32, 8, 8, 64)      # 131,072 entries

CONSTRAINTS = [("MaxNormConstraint", dict(max_norm=1.5)),
               ("MinMaxNormConstraint", dict(min_norm=0.8, max_norm=1.2,
                                             rate=0.7)),
               ("MinMaxNormConstraint", dict(min_norm=0.5, max_norm=3.0)),
               ("UnitNormConstraint", {}),
               ("NonNegativeConstraint", {})]


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


# ------------------------------------------------------------ constraints
@pytest.mark.parametrize("name, kw", CONSTRAINTS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(CONSTRAINTS)])
def test_constraint_matches_jax(name, kw):
    rs = np.random.RandomState(0)
    params = {"W": rs.randn(6, 5).astype(np.float32),
              "b": rs.randn(5).astype(np.float32),
              "dW": (rs.randn(3, 3, 4, 7) * 0.3).astype(np.float32),
              "gamma": rs.randn(5).astype(np.float32)}
    params["W"][:, 2] = 0.0     # a unit of norm 0
    got = getattr(tc, name)(**kw).apply(
        {k: torch.from_numpy(v) for k, v in params.items()})
    want = getattr(jc, name)(**kw).apply(
        {k: jnp.asarray(v) for k, v in params.items()})
    for k in params:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=CONSTRAINT_ATOL, err_msg=k)
    for k in ("b", "gamma"):        # only weights are constrained
        assert np.array_equal(_np(got[k]), params[k])


def test_apply_constraints_in_order_and_without_any():
    layer = DenseLayer(n_in=4, n_out=3, constraints=[
        tc.NonNegativeConstraint(), tc.UnitNormConstraint()])
    w = torch.tensor(np.random.RandomState(1).randn(4, 3), dtype=torch.float32)
    out = tc.apply_constraints(layer, {"W": w})["W"]
    assert torch.all(out >= 0)
    np.testing.assert_allclose(_np(torch.linalg.norm(out, dim=0)), 1.0,
                               atol=1e-6)
    p = {"W": w}
    assert tc.apply_constraints(DenseLayer(n_in=4, n_out=3), p) is p


# ------------------------------------------------- the dropout family
def _input(kind):
    rs = np.random.RandomState(2)
    if kind == "ones":
        return np.ones(SHAPE, np.float32)
    return rs.randn(*SHAPE).astype(np.float32)


#: (config name, kwargs, input, what to check)
DROPOUTS = [("Dropout", dict(rate=0.3), "ones"),
            ("Dropout", dict(rate=0.8), "ones"),
            ("SpatialDropout", dict(rate=0.4), "ones"),
            ("GaussianDropout", dict(rate=0.4), "ones"),
            ("GaussianNoise", dict(stddev=0.25), "normal"),
            ("AlphaDropout", dict(rate=0.2), "normal")]


def _within(value, want, var, n):
    """``value``, a mean of ``n`` independent draws of variance ``var``,
    within ``SIGMAS`` standard deviations of ``want``."""
    assert abs(value - want) <= SIGMAS * (var / n) ** 0.5, (value, want)


def _dropout_contract(name, kw, x, out):
    """The distribution an ``IDropout`` promises, on ``out`` = its output
    for ``x`` (numpy arrays)."""
    if name in ("Dropout", "SpatialDropout"):
        keep = 1.0 - kw["rate"]
        kept = out != 0
        if name == "SpatialDropout":   # whole channels: constant over H, W
            assert np.all(kept == kept[:, :1, :1, :])
            kept = kept[:, 0, 0, :]
        _within(kept.mean(), keep, keep * (1 - keep), kept.size)
        np.testing.assert_allclose(out[out != 0], 1.0 / keep, rtol=1e-6)
        _within(out.mean(), 1.0, (1 - keep) / keep, kept.size)
    elif name == "GaussianDropout":
        r = kw["rate"]
        assert abs(out.mean() - 1.0) <= MEAN_ATOL
        assert abs(out.var() / (r / (1 - r)) - 1.0) <= VAR_RTOL
    elif name == "GaussianNoise":
        d = out - x
        assert abs(d.mean()) <= MEAN_ATOL
        assert abs(d.std() / kw["stddev"] - 1.0) <= VAR_RTOL
    else:                               # AlphaDropout on N(0, 1) input
        keep = 1.0 - kw["rate"]
        a = (keep + td._ALPHA_PRIME ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * td._ALPHA_PRIME * (1 - keep)
        dropped = np.isclose(out, a * td._ALPHA_PRIME + b, atol=1e-6)
        _within(1.0 - dropped.mean(), keep, keep * (1 - keep), out.size)
        assert abs(out.mean()) <= MEAN_ATOL
        assert abs(out.var() - 1.0) <= VAR_RTOL


@pytest.mark.parametrize("name, kw, kind", DROPOUTS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(DROPOUTS)])
def test_idropout_keeps_the_distribution_jax_draws(name, kw, kind):
    x = _input(kind)
    g = torch.Generator().manual_seed(3)
    out = _np(getattr(td, name)(**kw).apply(torch.from_numpy(x), g))
    _dropout_contract(name, kw, x, out)
    # JAX's own draws meet the same contract on the same input
    jout = np.asarray(getattr(jd, name)(**kw).apply(
        jnp.asarray(x), jax.random.PRNGKey(3)))
    _dropout_contract(name, kw, x, jout)


def test_resolve_dropout():
    assert td.resolve_dropout(None) is None
    assert td.resolve_dropout(0.25) == td.Dropout(rate=0.25)
    d = td.AlphaDropout(0.1)
    assert td.resolve_dropout(d) is d


def test_dropout_layer_takes_an_idropout():
    x = torch.from_numpy(_input("ones"))
    g = torch.Generator().manual_seed(4)
    layer = DropoutLayer(rate=td.SpatialDropout(0.5))
    assert not layer.has_params()
    out, _ = layer.apply({}, {}, x, True, g)
    _dropout_contract("SpatialDropout", dict(rate=0.5), _np(x), _np(out))
    same, _ = layer.apply({}, {}, x, False, g)
    assert same is x


# ---------------------------------------------------------- weight noise
WEIGHT_NOISES = [("DropConnect", dict(rate=0.4)),
                 ("WeightNoise", dict(stddev=0.2)),
                 ("WeightNoise", dict(mean=1.0, stddev=0.3,
                                      additive=False))]


def _noise_contract(name, kw, params, out):
    assert set(out) == set(params)
    for k in ("b", "gamma"):          # never a bias or a norm scale
        assert np.array_equal(out[k], params[k])
    for k in ("W", "RW"):
        w, o = params[k], out[k]
        if name == "DropConnect":
            keep = 1.0 - kw["rate"]
            kept = o != 0
            _within(kept.mean(), keep, keep * (1 - keep), kept.size)
            np.testing.assert_allclose(o[kept], w[kept] / keep, rtol=1e-6)
        elif kw.get("additive", True):
            d = o - w
            assert abs(d.mean() - kw.get("mean", 0.0)) <= MEAN_ATOL
            assert abs(d.std() / kw["stddev"] - 1.0) <= VAR_RTOL
        else:                           # w = 1: the noise itself
            assert abs(o.mean() - kw["mean"]) <= MEAN_ATOL
            assert abs(o.std() / kw["stddev"] - 1.0) <= VAR_RTOL


@pytest.mark.parametrize("name, kw", WEIGHT_NOISES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(WEIGHT_NOISES)])
def test_weight_noise_keeps_the_distribution_jax_draws(name, kw):
    rs = np.random.RandomState(5)
    multiplicative = not kw.get("additive", True)
    params = {"W": (np.ones((256, 512), np.float32) if multiplicative
                    else rs.randn(256, 512).astype(np.float32)),
              "RW": (np.ones((512, 256), np.float32) if multiplicative
                     else rs.randn(512, 256).astype(np.float32)),
              "b": rs.randn(512).astype(np.float32),
              "gamma": rs.randn(512).astype(np.float32)}
    g = torch.Generator().manual_seed(6)
    out = getattr(tw, name)(**kw).apply(
        {k: torch.from_numpy(v) for k, v in params.items()}, g)
    _noise_contract(name, kw, params, {k: _np(v) for k, v in out.items()})
    jout = getattr(jw, name)(**kw).apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        jax.random.PRNGKey(6))
    _noise_contract(name, kw, params,
                    {k: np.asarray(v) for k, v in jout.items()})


def test_weight_keys_are_jax_keys():
    assert tw.WEIGHT_KEYS == jw.WEIGHT_KEYS


# --------------------------------------------------------------- serde
CONFIGS = [("dropout", "Dropout", dict(rate=0.2)),
           ("dropout", "SpatialDropout", dict(rate=0.3)),
           ("dropout", "GaussianDropout", dict(rate=0.1)),
           ("dropout", "GaussianNoise", dict(stddev=0.05)),
           ("dropout", "AlphaDropout", dict(rate=0.15)),
           ("weight_noise", "DropConnect", dict(rate=0.25)),
           ("weight_noise", "WeightNoise", dict(mean=0.5, stddev=0.2,
                                                additive=False)),
           ("constraints", "MaxNormConstraint", dict(max_norm=3.0)),
           ("constraints", "MinMaxNormConstraint", dict(min_norm=0.1,
                                                        max_norm=0.9,
                                                        rate=0.5)),
           ("constraints", "UnitNormConstraint", {}),
           ("constraints", "NonNegativeConstraint", {})]



def _jax_config(field, name, kw):
    mod = {"dropout": jd, "weight_noise": jw, "constraints": jc}[field]
    cfg = getattr(mod, name)(**kw)
    return [cfg] if field == "constraints" else cfg


@pytest.mark.parametrize("field, name, kw", CONFIGS,
                         ids=[n for _, n, _ in CONFIGS])
def test_config_round_trips_to_jax_json(field, name, kw):
    """A JAX configuration whose layer holds the config parses in the port
    (the stand-in that refused it is gone) and writes JAX's JSON back; the
    port's own object writes the same."""
    jconf = (JNNC.builder().seed(3).list()
             .layer(jl.DenseLayer(n_out=4, activation="tanh",
                                  **{field: _jax_config(field, name, kw)}))
             .layer(jl.DropoutLayer(rate=jd.GaussianNoise(0.1)))
             .layer(jl.OutputLayer(n_out=2, loss="mse",
                                   activation="identity"))
             .setInputType(JInputType.feedForward(3)).build())
    text = jconf.to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert conf.to_json() == text
    held = getattr(conf.layers[0], field)
    mod = {"dropout": td, "weight_noise": tw, "constraints": tc}[field]
    own = getattr(mod, name)(**kw)
    assert (held == [own]) if field == "constraints" else held == own
    assert isinstance(conf.layers[1].rate, td.GaussianNoise)


def test_jax_zip_holding_each_config_restores(tmp_path):
    """A JAX ModelSerializer zip whose layers hold an ``IDropout``, a
    weight noise and constraints restores in the port: its configuration
    reads back to JAX's JSON and its inference output is JAX's."""
    import os

    from deeplearning4j_tpu.util import ModelSerializer as JSerializer
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer)

    jnet = JMLN(_mln_conf(True, noise=jw.DropConnect(0.2),
                          drop=jd.AlphaDropout(0.1))).init()
    path = os.path.join(tmp_path, "configs.zip")
    JSerializer.writeModel(jnet, path)
    net = ModelSerializer.restore(path, device="cpu")
    assert net.conf.to_json() == jnet.conf.to_json()
    layer = net.conf.layers[1]
    assert isinstance(layer.dropout, td.AlphaDropout)
    assert isinstance(layer.weight_noise, tw.DropConnect)
    assert isinstance(net.conf.layers[0].constraints[0],
                      tc.MaxNormConstraint)
    x, _ = _data()
    np.testing.assert_allclose(_np(net.output(x)),
                               np.asarray(jnet.output(x).jax), atol=1e-6)


# ----------------------------------------------------- through networks
def _mln_conf(jax_side, constrained=True, noise=None, drop=None, l1=0.0):
    """The JAX configuration of a small MLP whose first layer may hold
    ``MaxNormConstraint(0.5)`` and whose second layer ``NonNegative``,
    weight noise or dropout; the port parses its JSON."""
    mods = (jc, jw, jd, jl, JNNC, JInputType, JSgd)
    c, w, d, l, nnc, it, sgd = mods
    jconf = (nnc.builder().seed(7).updater(sgd(0.5)).l1(l1).list()
             .layer(l.DenseLayer(n_out=6, activation="tanh",
                                 constraints=([c.MaxNormConstraint(0.5)]
                                              if constrained else None)))
             .layer(l.DenseLayer(n_out=5, activation="sigmoid",
                                 constraints=([c.NonNegativeConstraint()]
                                              if constrained else None),
                                 weight_noise=noise, dropout=drop))
             .layer(l.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
             .setInputType(it.feedForward(4)).build())
    return jconf if jax_side else MultiLayerConfiguration.from_json(
        jconf.to_json())


def _data(n=16, seed=8):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return x, y


def _follow(jnet, net, x, y, steps=3):
    for _ in range(steps):
        jnet.fit(x, y)
        net.fit(x, y)
        lj, lt = float(jnet.score()), net.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)


def _close_trees(jtree, tree):
    for key, p in jtree.items():
        for k, v in p.items():
            err = float(np.abs(_np(tree[key][k]) - np.asarray(v)).max())
            assert err <= PARAM_ATOL, (key, k, err)


def test_constrained_mln_follows_jax():
    jnet = JMLN(_mln_conf(True)).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    net.params_list = mln_params_from_numpy(
        jax.device_get(jnet.params_list), device="cpu")
    x, y = _data()
    _follow(jnet, net, x, y)
    _close_trees(dict(enumerate(jax.device_get(jnet.params_list))),
                 dict(enumerate(net.params_list)))
    w0 = net.params_list[0]["W"]
    assert float(torch.linalg.norm(w0, dim=0).max()) <= 0.5 + 1e-6
    assert float(net.params_list[1]["W"].min()) >= 0.0


def _graph_conf(jax_side):
    c, l = (jc, jl)
    b = (JCGC.graphBuilder().seed(9).updater(JSgd(0.5)).addInputs("in")
         .addLayer("h", l.DenseLayer(n_out=6, activation="tanh",
                                     constraints=[c.UnitNormConstraint()]),
                   "in")
         .addLayer("out", l.OutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent",
                                        constraints=[c.MaxNormConstraint(
                                            0.3)]), "h")
         .setOutputs("out").setInputTypes(JInputType.feedForward(4)))
    jconf = b.build()
    return jconf if jax_side else ComputationGraphConfiguration.from_json(
        jconf.to_json())


def test_constrained_graph_follows_jax():
    jg = JCG(_graph_conf(True)).init()
    g = ComputationGraph(_graph_conf(False), device="cpu").init()
    g.params_map = cg_params_from_numpy(
        g.conf.nodes, jax.device_get(jg.params_map), device="cpu")
    x, y = _data()
    _follow(jg, g, x, y)
    _close_trees(jax.device_get(jg.params_map), g.params_map)
    np.testing.assert_allclose(
        _np(torch.linalg.norm(g.params_map["h"]["W"], dim=0)), 1.0,
        atol=1e-5)


@pytest.mark.parametrize("which", ["dropout", "weight_noise"])
def test_stochastic_configs_train_both_networks(which):
    """A layer with ``GaussianDropout`` or ``DropConnect`` trains through
    both networks: the loss stays finite and falls, the noise moves the
    training loss off the inference one, and inference output equals
    JAX's on the same weights (the noise is training-only)."""
    kw = ({"drop": jd.GaussianDropout(0.3)} if which == "dropout"
          else {"noise": jw.DropConnect(0.3)})
    jconf = _mln_conf(True, constrained=False, **kw)
    jnet = JMLN(jconf).init()
    x, y = _data(64)
    nets = [MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()]
    gconf = _graph_of(jconf)
    nets.append(ComputationGraph(gconf, device="cpu").init())
    nets[0].params_list = mln_params_from_numpy(
        jax.device_get(jnet.params_list), device="cpu")
    nets[1].params_map = {str(i): p for i, p in
                          enumerate(nets[0].params_list)}
    want = np.asarray(jnet.output(x).jax)
    for net in nets:
        got = net.output(x)
        got = got[0] if isinstance(got, list) else got
        np.testing.assert_allclose(_np(got), want, atol=1e-6)
        losses = []
        for _ in range(30):
            net.fit(x, y)
            losses.append(net.score())
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def _graph_of(jconf):
    """The port graph of an MLP's layers, named "0", "1", ..."""
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    b = (ComputationGraphConfiguration.graphBuilder().seed(conf.seed)
         .updater(conf.updater).addInputs("in"))
    prev = "in"
    for i, layer in enumerate(conf.layers):
        b.addLayer(str(i), layer, prev)
        prev = str(i)
    return b.setOutputs(prev).setInputTypes(conf.input_type).build()


def test_weight_noise_only_in_training(monkeypatch):
    """The networks hand the layer's weight noise its generator in a
    training forward only: ``output`` and ``score(dataset)`` see the clean
    weights."""
    conf = _mln_conf(False, constrained=False, noise=jw.WeightNoise(
        stddev=0.1))
    net = MultiLayerNetwork(conf, device="cpu").init()
    calls = []
    real = tw.WeightNoise.apply

    def spy(self, params, generator):
        calls.append(generator)
        return real(self, params, generator)

    monkeypatch.setattr(tw.WeightNoise, "apply", spy)
    x, y = _data()
    net.output(x)
    assert calls == []
    net.fit(x, y)
    assert len(calls) == 1 and calls[0] is net._generator


def test_l1_at_a_zero_weight_takes_jax_slope():
    """C14: l1 on weights planted at exactly 0 moves them as JAX's step
    does (``jnp.abs`` has slope 1 there; ``torch.abs`` had 0)."""
    jnet = JMLN(_mln_conf(True, constrained=False, l1=0.05)).init()
    params = jax.tree_util.tree_map(np.array, jax.device_get(
        jnet.params_list))
    params[0]["W"][:2] = 0.0
    params[1]["W"][:, 0] = 0.0
    jnet.params_list = jax.tree_util.tree_map(jnp.asarray, params)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    net.params_list = mln_params_from_numpy(params, device="cpu")
    x, y = _data()
    _follow(jnet, net, x, y, steps=1)
    _close_trees(dict(enumerate(jax.device_get(jnet.params_list))),
                 dict(enumerate(net.params_list)))
    assert float(net.params_list[0]["W"][:2].abs().min()) > 0.0


# ---------------------------------------------------------------- the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name, kw, kind", DROPOUTS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(DROPOUTS)])
def test_cuda_idropout_keeps_the_distribution(name, kw, kind):
    _needs_card()
    x = _input(kind)
    g = torch.Generator(device="cuda").manual_seed(3)
    out = getattr(td, name)(**kw).apply(torch.from_numpy(x).cuda(), g)
    assert out.is_cuda
    _dropout_contract(name, kw, x, _np(out))


@pytest.mark.cuda
@pytest.mark.parametrize("name, kw", CONSTRAINTS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(CONSTRAINTS)])
def test_cuda_constraint_matches_the_cpu(name, kw):
    _needs_card()
    w = torch.from_numpy(np.random.RandomState(0).randn(300, 200).astype(
        np.float32))
    c = getattr(tc, name)(**kw)
    np.testing.assert_allclose(_np(c.apply({"W": w.cuda()})["W"]),
                               _np(c.apply({"W": w})["W"]),
                               atol=CONSTRAINT_ATOL, rtol=0)
