"""PyTorch port, the precision policies (``nn/precision.py``): the policy
object, its casts and the dynamic loss scale, and ``MultiLayerNetwork`` /
``ComputationGraph`` under ``mixed_bfloat16`` and ``mixed_float16``
against the JAX package on the same numpy inputs and weights (the JAX
network's weights carried across, never re-initialised); the
``lossScaleState.npz`` member of the model zip both ways; and C12, the
zip reader's ``__as__`` keys.

Exact: the policy objects and their JSON, the compute dtypes, every
loss-scale state (scale and counters) over a scripted sequence, after a
forced overflow and after a growth, the skipped step (parameters and
updater state bit-equal), the iteration counts, the master and updater
dtypes (f32), the zip members.

Tolerances, each with its cause:

- a dense + batch-norm network, 3 Adam steps at lr 1e-2: losses 1e-4
  relative, parameters 1e-3, outputs 5e-4 absolute (measured 1.0e-6,
  2.7e-4, 1.3e-4). XLA's CPU compiler keeps excess precision: it drops
  f32 -> bf16 -> f32 conversion pairs inside its fusions, so JAX rounds
  fewer intermediates to bf16 than PyTorch's one rounding per op; with
  ``--xla_allow_excess_precision=false`` the cut ResNet below agrees
  with the port to 5.3e-6
  (``test_cut_resnet_bf16_matches_jax_rounding_per_op``).
  Under f16 (measured 5.6e-7, 4.4e-5, 3.0e-5) an f32-level difference in
  an f32 island (the batch norm's formula in another order) moves the
  next layer's input by one f16 step where it crosses a rounding
  boundary.
- the char-LSTM (truncated BPTT, 3 Nesterovs fits): losses 5e-4
  relative, parameters 1e-2, ``rnnTimeStep`` outputs 2e-3, two bf16
  steps of a probability in [0.25, 0.5) (measured 1.2e-4, 3.3e-3,
  1.6e-4; the graph's ``rnnTimeStep`` 1.1e-3). The port's recurrence
  carries h and c in f32 within a sequence (the Pallas kernel's
  semantics, which B5 keeps); the JAX network's scan carries them in the
  compute dtype.
- gradients of external errors (``backpropGradient``) under bf16: 8e-3,
  two bf16 steps at 1 (measured 3.9e-3): the first item's cause, in the
  backward.
- the C12 zips: parameters and updater state bit-equal; outputs of the
  same f32 parameters 1e-6 (measured 6e-8: XLA's and PyTorch's f32
  kernels round in another order).
- the cut ResNet under f16 at default XLA flags, 3 Nesterovs steps:
  losses 1e-2 relative, parameters 2e-2, outputs 5e-2 (measured 4.7e-3,
  7.8e-3, 1.9e-2): the f16 steps of the first item, spread by eleven
  batch norms over a batch of 8. The same tolerances hold the card
  against the CPU in ``chip_smoke.py`` phase 19 and in this file's cuda
  tests (measured on an H100 under bf16: 1.0e-3, 4.8e-3, 1.3e-2; under
  f16: 3.4e-3, 5.1e-3, 7.7e-3), with the char-LSTM's beside them.
"""

import dataclasses
import io
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

try:  # the JAX package is the CPU tests' reference; the card's machine
    #   has none, and runs only this file's cuda tests
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn import precision as JP
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer as JDense, InputType as JIT, NeuralNetConfiguration as JNNC,
        OutputLayer as JOut)
    from deeplearning4j_tpu.nn.conf import layers as jlayers
    from deeplearning4j_tpu.nn.conf.builder import (
        MultiLayerConfiguration as JMLC)
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraphConfiguration as JCGC)
    from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.multilayer.network import (
        MultiLayerNetwork as JMLN)
    from deeplearning4j_tpu.nn.precision import PrecisionPolicy as JPolicy
    from deeplearning4j_tpu.util import ModelSerializer as JSerializer
    from deeplearning4j_tpu.util import model_serializer as jms
    from deeplearning4j_tpu.zoo.resnet50 import ResNet50 as JResNet50
    from deeplearning4j_tpu.zoo.textgen_lstm import (
        TextGenerationLSTM as JTextGen)
except ModuleNotFoundError:
    jax = None

from deeplearning4j_tpu_torch.learning import Adam, Nesterovs
from deeplearning4j_tpu_torch.nn import precision as P
from deeplearning4j_tpu_torch.nn.conf import (
    LSTM, ActivationLayer, BatchNormalization, DenseLayer, InputType,
    LayerNormalization, LocalResponseNormalization, LossLayer,
    MultiLayerConfiguration, NeuralNetConfiguration, OutputLayer,
    RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy
from deeplearning4j_tpu_torch.params import (cg_params_from_numpy,
                                             mln_params_from_numpy,
                                             tree_leaves)
from deeplearning4j_tpu_torch.util.model_serializer import (ModelSerializer,
                                                            read_npz)
from deeplearning4j_tpu_torch.zoo import ResNet50, TextGenerationLSTM
from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

MIXED = ("mixed_bfloat16", "mixed_float16")
DENSE_TOL = (1e-4, 1e-3, 5e-4)        # loss rel, params, outputs
LSTM_TOL = (5e-4, 1e-2, 2e-3)
#: gradients of external errors through a bf16 network: two bf16 steps at 1
GRAD_TOL = 8e-3
#: f32 outputs of the same parameters in the two frameworks
F32_OUT_TOL = 1e-6
RESNET_TOL = (1e-2, 2e-2, 5e-2)
STRICT_TOL = (1e-6, 2e-5, 1e-5)
OVERFLOW_X = np.full((32, 10), 1e7, np.float32)   # inf once staged in f16


# ------------------------------------------------------------------ helpers
def _data(n=32, fin=10, classes=3, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, fin).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)]


def _char_batch(n=4, t=30, vocab=11, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, t))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, 1)]


def _dense_conf(precision, updater=None):
    return (NeuralNetConfiguration.builder().seed(7)
            .updater(updater or Adam(1e-2)).precision(precision).list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(BatchNormalization())
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .setInputType(InputType.feedForward(10)).build())


def _dense_graph_conf(precision):
    return (ComputationGraphConfiguration.graphBuilder().seed(7)
            .updater(Adam(1e-2)).precision(precision).addInputs("in")
            .addLayer("d1", DenseLayer(n_out=16, activation="relu"), "in")
            .addLayer("bn", BatchNormalization(), "d1")
            .addLayer("out", OutputLayer(n_out=3, activation="softmax",
                                         loss="mcxent"), "bn")
            .setOutputs("out").setInputTypes(InputType.feedForward(10))
            .build())


def _pair_mln(conf):
    """The JAX network of the port configuration ``conf`` (through its
    JSON) and the port's with the JAX network's weights."""
    jnet = JMLN(JMLC.from_json(conf.to_json())).init()
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.params_list = mln_params_from_numpy(jax.device_get(jnet.params_list),
                                            device="cpu")
    return net, jnet


def _pair_cg(conf):
    jg = JCG(JCGC.from_json(conf.to_json())).init()
    g = ComputationGraph(conf, device="cpu").init()
    g.params_map = cg_params_from_numpy(conf.nodes,
                                        jax.device_get(jg.params_map),
                                        device="cpu")
    return g, jg


def _leaves_np(tree):
    return [np.asarray(a, np.float32)
            for a in jax.tree_util.tree_leaves(jax.device_get(tree))]


def _port_leaves(tree):
    return [t.detach().float().cpu().numpy() for t in tree_leaves(tree)]


def _graph_leaves(tree):
    """A tree's leaves in the JAX order (dict keys sorted, as
    ``jax.tree_util`` orders them)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _graph_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _graph_leaves(v)]
    return [tree.detach().float().cpu().numpy()]


def _max_diff(a, b) -> float:
    assert len(a) == len(b)
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _float_dtypes(tree) -> set:
    return {t.dtype for t in tree_leaves(tree)
            if torch.is_tensor(t) and t.is_floating_point()}


def _ls(state) -> dict:
    """A loss-scale state as Python numbers (either package)."""
    return {k: float(np.asarray(jax.device_get(v)) if not torch.is_tensor(v)
                     else v) for k, v in state.items()}


def _policy_dict(p):
    d = dataclasses.asdict(p)
    d["fp32_layer_types"] = tuple(d["fp32_layer_types"])
    return d


# -------------------------------------------------------------- the policy
@pytest.mark.parametrize("name", ["float32", "f32", "mixed_bfloat16",
                                  "mixed_bf16", "mixed_float16", "MIXED_FP16"])
def test_preset_matches_jax(name):
    assert _policy_dict(PrecisionPolicy.of(name)) == _policy_dict(
        JPolicy.of(name))


def test_unknown_preset_raises():
    for name in ("mixed_int8", "bfloat16x"):
        with pytest.raises(ValueError, match="Unknown precision"):
            PrecisionPolicy.of(name)


@pytest.mark.parametrize("case", [
    (None, "float32"), (None, "bfloat16"), ("float32", "float32"),
    ("mixed_bfloat16", "float32"), ("mixed_float16", "bfloat16"),
    (dict(name="u", param_dtype="bfloat16", compute_dtype="bfloat16",
          output_dtype="bfloat16"), "float32"),
    (dict(name="u", param_dtype="bfloat16", compute_dtype="bfloat16",
          output_dtype="bfloat16", fp32_layer_types=(),
          fp32_loss_head=False), "float32"),
    (dict(name="o", layer_overrides={0: "float32"}), "float32")])
def test_resolve_and_identity_match_jax(case):
    prec, dtype = case
    mine = PrecisionPolicy(**prec) if isinstance(prec, dict) else prec
    theirs = JPolicy(**prec) if isinstance(prec, dict) else prec
    p, q = PrecisionPolicy.resolve(mine, dtype), JPolicy.resolve(theirs,
                                                                 dtype)
    assert _policy_dict(p) == _policy_dict(q)
    assert p.is_identity == q.is_identity
    if isinstance(mine, PrecisionPolicy):
        assert PrecisionPolicy.resolve(mine, dtype) is mine


@pytest.mark.parametrize("layer", [
    "DenseLayer", "BatchNormalization", "LocalResponseNormalization",
    "LayerNormalization", "OutputLayer", "RnnOutputLayer", "LossLayer",
    "LSTM", "ActivationLayer"])
@pytest.mark.parametrize("policy", MIXED)
def test_layer_compute_dtype_matches_jax(layer, policy):
    ours = {"DenseLayer": DenseLayer, "BatchNormalization":
            BatchNormalization, "LocalResponseNormalization":
            LocalResponseNormalization, "LayerNormalization":
            LayerNormalization, "OutputLayer": OutputLayer,
            "RnnOutputLayer": RnnOutputLayer, "LossLayer": LossLayer,
            "LSTM": LSTM, "ActivationLayer": ActivationLayer}[layer]
    got = PrecisionPolicy.of(policy).layer_compute_dtype(ours(), 1)
    want = JPolicy.of(policy).layer_compute_dtype(getattr(jlayers, layer)(),
                                                  1)
    assert str(got).split(".")[1] == jnp.dtype(want).name


def test_layer_overrides_by_index_and_name():
    kw = dict(name="c", compute_dtype="bfloat16",
              layer_overrides={0: "float32", "att": "float16"})
    p, q = PrecisionPolicy(**kw), JPolicy(**kw)
    for layer, key in ((DenseLayer(n_out=4), 0), (DenseLayer(n_out=4), "att"),
                       (DenseLayer(n_out=4, name="att"), 5),
                       (DenseLayer(n_out=4), 5)):
        jl = jlayers.DenseLayer(n_out=4, name=layer.name)
        assert str(p.layer_compute_dtype(layer, key)).split(".")[1] == \
            jnp.dtype(q.layer_compute_dtype(jl, key)).name


_POLICIES = ["mixed_bfloat16", "mixed_float16",
             dict(name="c", compute_dtype="bfloat16",
                  layer_overrides={1: "float32", "out": "float16"},
                  growth_interval=7, initial_loss_scale=1024.0)]


def _build_mln(nnc, dense, out, it, prec):
    return (nnc.builder().precision(prec).list()
            .layer(dense(n_out=4, activation="relu"))
            .layer(out(n_out=2, activation="softmax", loss="mcxent"))
            .setInputType(it.feedForward(3)).build())


@pytest.mark.parametrize("prec", _POLICIES)
def test_mln_policy_json_both_ways(prec):
    mine = PrecisionPolicy(**prec) if isinstance(prec, dict) else prec
    theirs = JPolicy(**prec) if isinstance(prec, dict) else prec
    conf = _build_mln(NeuralNetConfiguration, DenseLayer, OutputLayer,
                      InputType, mine)
    jconf = _build_mln(JNNC, JDense, JOut, JIT, theirs)
    assert conf.to_json() == jconf.to_json()
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert back.precision == mine
    assert JMLC.from_json(conf.to_json()).precision == theirs
    if isinstance(mine, PrecisionPolicy):
        assert set(back.precision.layer_overrides) == {1, "out"}


@pytest.mark.parametrize("prec", _POLICIES)
def test_graph_policy_json_both_ways(prec):
    mine = PrecisionPolicy(**prec) if isinstance(prec, dict) else prec
    theirs = JPolicy(**prec) if isinstance(prec, dict) else prec
    conf = _dense_graph_conf(mine)
    jconf = JCGC.from_json(conf.to_json())
    assert jconf.precision == theirs
    assert ComputationGraphConfiguration.from_json(
        jconf.to_json()).to_json() == conf.to_json()


def test_update_loss_scale_matches_jax_exactly():
    """A scripted sequence of finite and non-finite steps, then the floor
    and the ceiling: every state equal to JAX's, field by field."""
    kw = dict(name="s", compute_dtype="float16", loss_scaling=True,
              growth_interval=3, initial_loss_scale=8.0, max_loss_scale=64.0,
              min_loss_scale=2.0)
    p, q = PrecisionPolicy(**kw), JPolicy(**kw)
    st, jst = P.init_loss_scale(p), JP.init_loss_scale(q)
    assert st["scale"].dtype == torch.float32
    assert {st[k].dtype for k in ("good_steps", "overflows",
                                  "skipped_steps")} == {torch.int32}
    for finite in (1, 1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                   1, 1, 1, 1, 1, 1, 0, 1, 1):
        st = P.update_loss_scale(p, st, torch.tensor(bool(finite)))
        jst = JP.update_loss_scale(q, jst, jnp.asarray(bool(finite)))
        assert _ls(st) == _ls(jst)
    assert _ls(st)["overflows"] == _ls(st)["skipped_steps"] == 6


def test_cast_helpers_match_jax():
    rs = np.random.RandomState(1)
    tree = {"W": rs.randn(3, 4).astype(np.float32),
            "b": rs.randn(4).astype(np.float32),
            "i": np.arange(4, dtype=np.int32)}
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    j = {k: jnp.asarray(v) for k, v in tree.items()}
    c, jc = P.cast_tree(t, torch.bfloat16), JP.cast_tree(j, jnp.bfloat16)
    assert {k: str(v.dtype).split(".")[1] for k, v in c.items()} == \
        {k: v.dtype.name for k, v in jc.items()}
    assert P.count_casts(t, torch.float16) == JP.count_casts(
        j, jnp.float16) == 2
    st = P.init_loss_scale(PrecisionPolicy.of("mixed_float16"))
    jst = JP.init_loss_scale(JPolicy.of("mixed_float16"))
    g = P.unscale_grads({k: c[k] for k in ("W", "b")}, st)
    jg = JP.unscale_grads({k: jc[k] for k in ("W", "b")}, jst)
    for k in g:
        assert g[k].dtype == torch.float32
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(jg[k]))
    bad = dict(t, b=torch.tensor([1.0, float("inf"), 0.0, 0.0]))
    for tr, jtr in ((t, j), (bad, {k: jnp.asarray(v.numpy())
                                   for k, v in bad.items()})):
        assert bool(P.all_finite(tr)) == bool(JP.all_finite(jtr))
    old = {k: v + 1 for k, v in t.items()}
    for pred in (True, False):
        sel = P.select(torch.tensor(pred), t, old)
        want = t if pred else old
        assert all(torch.equal(sel[k], want[k]) for k in t)


def test_scaled_value_and_grad_matches_jax():
    rs = np.random.RandomState(2)
    w0 = rs.randn(5, 3).astype(np.float32)
    x = rs.randn(4, 5).astype(np.float32)
    pol, jpol = PrecisionPolicy.of("mixed_float16"), JPolicy.of(
        "mixed_float16")
    st, jst = P.init_loss_scale(pol), JP.init_loss_scale(jpol)

    def loss(p):
        y = torch.from_numpy(x) @ p["w"]
        return torch.sum(y * y), y

    def jloss(p):
        y = jnp.asarray(x) @ p["w"]
        return jnp.sum(y * y), y

    w = {"w": torch.from_numpy(w0).requires_grad_(True)}
    (sl, _), g, fin = P.scaled_value_and_grad(loss, st, w)
    (jsl, _), jg, jfin = JP.scaled_value_and_grad(jloss, jst,
                                                  {"w": jnp.asarray(w0)})
    assert bool(fin) and bool(jfin)
    np.testing.assert_allclose(float(sl), float(jsl), rtol=1e-6)
    np.testing.assert_allclose(g["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-6, atol=1e-6)
    guarded = P.guard_scaled_step(pol, st, torch.tensor(False),
                                  [(g, {"w": w["w"].detach()})])
    assert torch.equal(guarded[0]["w"], w["w"].detach())
    assert _ls(guarded[1]) == _ls(JP.update_loss_scale(
        jpol, jst, jnp.asarray(False)))


# ---------------------------------------------------- MultiLayerNetwork
@pytest.mark.parametrize("policy", MIXED)
def test_mln_mixed_matches_jax(policy):
    net, jnet = _pair_mln(_dense_conf(policy))
    x, y = _data()
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        lj = float(jnet.score())
        assert abs(net.score() - lj) <= DENSE_TOL[0] * abs(lj)
    assert net.getIterationCount() == jnet.getIterationCount() == 3
    assert _float_dtypes(net.params_list) == _float_dtypes(
        net.opt_states) == {torch.float32}
    assert _max_diff(_port_leaves(net.params_list),
                     _leaves_np(jnet.params_list)) <= DENSE_TOL[1]
    assert _max_diff(_port_leaves(net.states_list),
                     _leaves_np(jnet.states_list)) <= DENSE_TOL[1]
    out = net.output(x)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x).jax),
                               atol=DENSE_TOL[2], rtol=0)
    acts, jacts = net.feedForward(x), jnet.feedForward(x)
    assert [str(a.dtype).split(".")[1] for a in acts] == \
        [a.jax.dtype.name for a in jacts]
    if net._loss_scale_state is not None:
        assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state)


def test_mln_float32_policy_is_bit_identical_to_none():
    x, y = _data()
    a = MultiLayerNetwork(_dense_conf(None), device="cpu").init()
    b = MultiLayerNetwork(_dense_conf("float32"), device="cpu").init()
    b.params_list = [dict(p) for p in a.params_list]
    for _ in range(3):
        a.fit(x, y)
        b.fit(x, y)
    assert not b._mixed and b._loss_scale_state is None
    for p, q in zip(tree_leaves(a.params_list), tree_leaves(b.params_list)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("policy", MIXED)
def test_char_lstm_tbptt_mixed_matches_jax(policy):
    conf = TextGenerationLSTM(vocab_size=11, hidden=16, tbptt_length=10,
                              precision=policy,
                              updater=Nesterovs(0.05, 0.9)).conf()
    net, jnet = _pair_mln(conf)
    x, y = _char_batch()
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        lj = float(jnet.score())
        assert abs(net.score() - lj) <= LSTM_TOL[0] * abs(lj)
    assert net.getIterationCount() == jnet.getIterationCount() == 9
    assert _float_dtypes(net.params_list) == {torch.float32}
    assert _max_diff(_port_leaves(net.params_list),
                     _leaves_np(jnet.params_list)) <= LSTM_TOL[1]
    for t in range(3):
        out, jout = net.rnnTimeStep(x[:, t]), jnet.rnnTimeStep(x[:, t])
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(jout.jax),
                                   atol=LSTM_TOL[2], rtol=0)
    # the carries are in the LSTMs' compute dtype, as JAX makes them
    h, c = net.rnnGetPreviousState(0)
    assert h.dtype == c.dtype == torch.bfloat16 if policy.endswith(
        "bfloat16") else h.dtype == torch.float16
    assert str(h.dtype).split(".")[1] == jnet.rnnGetPreviousState(
        0)[0].dtype.name
    if net._loss_scale_state is not None:
        assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state)


def test_mln_forced_overflow_skips_the_step_as_jax_does():
    net, jnet = _pair_mln(_dense_conf("mixed_float16"))
    x, y = _data()
    net.fit(x, y)
    jnet.fit(x, y)
    s0 = _ls(net._loss_scale_state)
    p0 = [t.clone() for t in tree_leaves(net.params_list)]
    o0 = [t.clone() for t in tree_leaves(net.opt_states)]
    st0 = [t.clone() for t in tree_leaves(net.states_list)]
    net.fit(OVERFLOW_X, y)
    jnet.fit(OVERFLOW_X, y)
    s1 = _ls(net._loss_scale_state)
    assert s1 == _ls(jnet._loss_scale_state)
    assert s1["scale"] == s0["scale"] * 0.5
    assert s1["overflows"] == s1["skipped_steps"] == 1
    for a, b in ((p0, net.params_list), (o0, net.opt_states),
                 (st0, net.states_list)):
        assert all(torch.equal(u, v) for u, v in zip(a, tree_leaves(b)))
    # the skipped step counts, as in JAX: the next step's Adam step is 2
    assert net.getIterationCount() == jnet.getIterationCount() == 2
    net.fit(x, y)
    jnet.fit(x, y)
    assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state)
    assert _max_diff(_port_leaves(net.params_list),
                     _leaves_np(jnet.params_list)) <= DENSE_TOL[1]


def test_mln_scale_grows_after_the_interval_as_jax():
    kw = dict(name="g", compute_dtype="float16", loss_scaling=True,
              growth_interval=3)
    net, jnet = _pair_mln(_dense_conf(PrecisionPolicy(**kw)))
    jnet.conf.precision = JPolicy(**kw)
    x, y = _data()
    s0 = _ls(net._loss_scale_state)["scale"]
    for _ in range(3):
        net.fit(x, y)
        jnet.fit(x, y)
        assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state)
    assert _ls(net._loss_scale_state)["scale"] == 2 * s0


def test_mln_output_dtype_and_layer_override():
    x, y = _data()
    pol = PrecisionPolicy(name="c", compute_dtype="bfloat16",
                          output_dtype="bfloat16")
    net, jnet = _pair_mln(_dense_conf(pol))
    assert net.output(x).dtype == torch.bfloat16
    assert jnet.output(x).jax.dtype == jnp.bfloat16
    pol = PrecisionPolicy(name="c", compute_dtype="bfloat16",
                          layer_overrides={0: "float32"})
    net, jnet = _pair_mln(_dense_conf(pol))
    net.fit(x, y)
    jnet.fit(x, y)
    assert net._compute_dtypes == [torch.float32, torch.float32,
                                   torch.float32]
    assert [d.name for d in jnet._compute_dtypes] == ["float32"] * 3
    assert abs(net.score() - float(jnet.score())) <= 1e-5 * float(
        jnet.score())


@pytest.mark.parametrize("policy", MIXED)
def test_mln_backprop_gradient_mixed_matches_jax(policy):
    net, jnet = _pair_mln(_dense_conf(policy))
    x, _ = _data(n=8)
    err = np.random.RandomState(5).randn(8, 3).astype(np.float32)
    g, eps = net.backpropGradient(x, err, train=False)
    jg, jeps = jnet.backpropGradient(x, err, train=False)
    assert _float_dtypes(g) == {torch.float32}
    assert eps.dtype == net._input_dtype
    assert str(eps.dtype).split(".")[1] == jeps.jax.dtype.name
    assert _max_diff(_port_leaves(g), _leaves_np(jg)) <= GRAD_TOL


def test_mln_clone_keeps_the_loss_scale_state():
    net = MultiLayerNetwork(_dense_conf("mixed_float16"), device="cpu").init()
    x, y = _data()
    net.fit(x, y)
    net.fit(OVERFLOW_X, y)
    m = net.clone()
    assert _ls(m._loss_scale_state) == _ls(net._loss_scale_state)
    assert m._ls_seen == net._ls_seen


# ------------------------------------------------------ ComputationGraph
@pytest.mark.parametrize("policy", MIXED)
def test_cg_mixed_matches_jax(policy):
    g, jg = _pair_cg(_dense_graph_conf(policy))
    x, y = _data()
    for _ in range(3):
        jg.fit(x, y)
        g.fit(x, y)
        lj = float(jg.score())
        assert abs(g.score() - lj) <= DENSE_TOL[0] * abs(lj)
    assert _float_dtypes(g.params_map) == _float_dtypes(
        g.opt_states) == {torch.float32}
    assert _max_diff(_graph_leaves(g.params_map),
                     _leaves_np(jg.params_map)) <= DENSE_TOL[1]
    out = g.output(x)[0]
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jg.output(x)[0].jax),
                               atol=DENSE_TOL[2], rtol=0)
    if g._loss_scale_state is not None:
        assert _ls(g._loss_scale_state) == _ls(jg._loss_scale_state)


def test_cg_forced_overflow_skips_the_step_as_jax_does():
    g, jg = _pair_cg(_dense_graph_conf("mixed_float16"))
    x, y = _data()
    g.fit(x, y)
    jg.fit(x, y)
    before = [t.clone() for t in tree_leaves([g.params_map, g.opt_states,
                                              g.states_map])]
    g.fit(OVERFLOW_X, y)
    jg.fit(OVERFLOW_X, y)
    assert _ls(g._loss_scale_state) == _ls(jg._loss_scale_state)
    assert _ls(g._loss_scale_state)["skipped_steps"] == 1
    after = tree_leaves([g.params_map, g.opt_states, g.states_map])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert g.getIterationCount() == jg.getIterationCount() == 2
    m = g.clone()
    assert _ls(m._loss_scale_state) == _ls(g._loss_scale_state)


def test_cut_resnet_f16_matches_jax():
    conf = cut_resnet_conf()
    conf.precision = "mixed_float16"
    g, jg = _pair_cg(conf)
    rs = np.random.RandomState(0)
    x = rs.randn(8, 32, 32, 3).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 8)]
    for _ in range(3):
        jg.fit(x, y)
        g.fit(x, y)
        lj = float(jg.score())
        assert abs(g.score() - lj) <= RESNET_TOL[0] * abs(lj)
    assert _max_diff(_graph_leaves(g.params_map),
                     _leaves_np(jg.params_map)) <= RESNET_TOL[1]
    np.testing.assert_allclose(g.output(x)[0].numpy(),
                               np.asarray(jg.output(x)[0].jax),
                               atol=RESNET_TOL[2], rtol=0)
    assert _ls(g._loss_scale_state) == _ls(jg._loss_scale_state)


_STRICT_JAX = r"""
import sys
import numpy as np
import jax
from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu.nn.graph.graph import ComputationGraph

conf = ComputationGraphConfiguration.from_json(open(sys.argv[1]).read())
g = ComputationGraph(conf).init()
rs = np.random.RandomState(0)
x = rs.randn(8, 32, 32, 3).astype(np.float32)
y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 8)]
out = {"p0/" + n + "/" + k: np.asarray(v)
       for n, p in jax.device_get(g.params_map).items()
       for k, v in p.items()}
losses = []
for _ in range(3):
    g.fit(x, y)
    losses.append(float(g.score()))
out.update({"p3/" + n + "/" + k: np.asarray(v)
            for n, p in jax.device_get(g.params_map).items()
            for k, v in p.items()})
out["losses"] = np.asarray(losses)
out["output"] = np.asarray(g.output(x)[0].jax)
np.savez(sys.argv[2], **out)
"""


def test_cut_resnet_bf16_matches_jax_rounding_per_op(tmp_path):
    """The cut ResNet under mixed_bfloat16 against the JAX package run in
    a process whose XLA rounds every bf16 op as PyTorch does
    (``--xla_allow_excess_precision=false``): losses, parameters after 3
    Nesterovs steps and the inference output at f32 parity."""
    conf = cut_resnet_conf()
    conf.precision = "mixed_bfloat16"
    cpath, rpath = str(tmp_path / "conf.json"), str(tmp_path / "ref.npz")
    with open(cpath, "w") as f:
        f.write(conf.to_json())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, "-c", _STRICT_JAX, cpath, rpath],
                   env=env, check=True, timeout=600)
    ref = np.load(rpath)
    tree = {n.name: {} for n in conf.nodes}
    for key in ref.files:
        if key.startswith("p0/"):
            _, n, k = key.split("/")
            tree.setdefault(n, {})[k] = ref[key]
    g = ComputationGraph(conf, device="cpu").init()
    g.params_map = cg_params_from_numpy(conf.nodes, tree, device="cpu")
    rs = np.random.RandomState(0)
    x = rs.randn(8, 32, 32, 3).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 8)]
    losses = []
    for _ in range(3):
        g.fit(x, y)
        losses.append(g.score())
    np.testing.assert_allclose(losses, ref["losses"], rtol=STRICT_TOL[0])
    err = max(float(np.abs(g.params_map[n][k].numpy()
                           - ref[f"p3/{n}/{k}"]).max())
              for n in g.params_map for k in g.params_map[n])
    assert err <= STRICT_TOL[1], err
    np.testing.assert_allclose(g.output(x)[0].numpy(), ref["output"],
                               atol=STRICT_TOL[2], rtol=0)


def _recurrent_graph_conf(policy):
    return (ComputationGraphConfiguration.graphBuilder().seed(5)
            .updater(Nesterovs(0.05, 0.9)).precision(policy)
            .addInputs("in").setInputTypes(InputType.recurrent(6))
            .addLayer("lstm", LSTM(n_out=8), "in")
            .addLayer("out", RnnOutputLayer(n_out=4, activation="softmax",
                                            loss="mcxent"), "lstm")
            .setOutputs("out").build())


@pytest.mark.parametrize("policy", MIXED)
def test_graph_rnn_time_step_mixed_matches_jax(policy):
    g, jg = _pair_cg(_recurrent_graph_conf(policy))
    rs = np.random.RandomState(3)
    x = rs.randn(3, 5, 6).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (3, 5))]
    g.fit(x, y)
    jg.fit(x, y)
    for t in range(5):
        out, jout = g.rnnTimeStep(x[:, t])[0], jg.rnnTimeStep(x[:, t])[0]
        assert out.dtype == torch.float32 and jout.jax.dtype == jnp.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(jout.jax),
                                   atol=LSTM_TOL[2], rtol=0)
    assert str(g.rnnGetPreviousState("lstm")[0].dtype).split(".")[1] == \
        jg.rnnGetPreviousState("lstm")[0].dtype.name


@pytest.mark.parametrize("policy", MIXED)
def test_cg_external_errors_at_the_output_dtype(policy):
    g, jg = _pair_cg(_dense_graph_conf(policy))
    x, _ = _data(n=8)
    err = np.random.RandomState(6).randn(8, 3).astype(np.float32)
    grads, eps = g.backpropGradient([x], [err], train=False)
    jgrads, jeps = jg.backpropGradient([x], [err], train=False)
    assert _float_dtypes(grads) == {torch.float32}
    assert str(eps["in"].dtype).split(".")[1] == jeps["in"].jax.dtype.name
    assert _max_diff(_graph_leaves(grads), _leaves_np(jgrads)) <= GRAD_TOL


# ----------------------------------------------------------------- zips
def test_jax_f16_zip_restores_the_loss_scale_state(tmp_path):
    jnet = JMLN(JMLC.from_json(_dense_conf("mixed_float16").to_json())).init()
    x, y = _data()
    jnet.fit(x, y)
    jnet.fit(OVERFLOW_X, y)
    path = str(tmp_path / "m.zip")
    JSerializer.writeModel(jnet, path)
    net = ModelSerializer.restoreMultiLayerNetwork(path, load_updater=True,
                                                   device="cpu")
    assert net._policy.loss_scaling
    assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state)
    assert net._ls_seen == (1, 1)
    assert net._loss_scale_state["good_steps"].dtype == torch.int32
    net.fit(x, y)
    jnet.fit(x, y)
    assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state)


def test_port_f16_zip_restores_in_jax(tmp_path):
    net = MultiLayerNetwork(_dense_conf("mixed_float16"), device="cpu").init()
    x, y = _data()
    net.fit(x, y)
    net.fit(OVERFLOW_X, y)
    path = str(tmp_path / "m.zip")
    ModelSerializer.writeModel(net, path)
    jnet = JSerializer.restoreMultiLayerNetwork(path)
    assert _ls(jnet._loss_scale_state) == _ls(net._loss_scale_state)
    assert jnet._ls_seen == (1, 1)
    g = ComputationGraph(_dense_graph_conf("mixed_float16"),
                         device="cpu").init()
    g.fit(x, y)
    gpath = str(tmp_path / "g.zip")
    ModelSerializer.writeModel(g, gpath)
    jg = JSerializer.restoreComputationGraph(gpath)
    assert _ls(jg._loss_scale_state) == _ls(g._loss_scale_state)
    back = ModelSerializer.restoreComputationGraph(gpath, device="cpu")
    assert _ls(back._loss_scale_state) == _ls(g._loss_scale_state)


def test_bf16_policy_zip_has_no_scale_member(tmp_path):
    x, y = _data()
    net = MultiLayerNetwork(_dense_conf("mixed_bfloat16"), device="cpu").init()
    net.fit(x, y)
    path = str(tmp_path / "m.zip")
    ModelSerializer.writeModel(net, path)
    with zipfile.ZipFile(path) as zf:
        assert "lossScaleState.npz" not in zf.namelist()
    m = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    assert m._policy.compute_dtype == "bfloat16"
    assert _float_dtypes(m.params_list) == {torch.float32}
    jm = JSerializer.restoreMultiLayerNetwork(path)
    assert jm._policy.compute_dtype == "bfloat16"


# ------------------------------------------------------------------ C12
def _as_graph_conf():
    """A graph whose layer vertex is named ``enc__as__dec``: its npz keys
    hold ``__as__`` without naming a dtype."""
    return (ComputationGraphConfiguration.graphBuilder().seed(9)
            .updater(Adam(1e-2)).addInputs("in")
            .addLayer("enc__as__dec", DenseLayer(n_out=6, activation="tanh"),
                      "in")
            .addLayer("out", OutputLayer(n_out=3, activation="softmax",
                                         loss="mcxent"), "enc__as__dec")
            .setOutputs("out").setInputTypes(InputType.feedForward(10))
            .build())


def test_jax_zip_with_an_as_vertex_restores(tmp_path):
    jg = JCG(JCGC.from_json(_as_graph_conf().to_json())).init()
    x, y = _data()
    jg.fit(x, y)
    path = str(tmp_path / "g.zip")
    JSerializer.writeModel(jg, path)
    with zipfile.ZipFile(path) as zf:
        assert "enc__as__dec/W" in read_npz(zf, "coefficients.npz")
    g = ModelSerializer.restoreComputationGraph(path, device="cpu")
    for port, jax_tree in ((g.params_map, jg.params_map),
                           (g.opt_states, jg.opt_states)):
        assert _max_diff(_graph_leaves(port), _leaves_np(jax_tree)) == 0.0
    np.testing.assert_allclose(g.output(x)[0].numpy(),
                               np.asarray(jg.output(x)[0].jax),
                               atol=F32_OUT_TOL, rtol=0)


def test_port_zip_with_an_as_vertex_round_trips_bit_equal(tmp_path):
    g = ComputationGraph(_as_graph_conf(), device="cpu").init()
    x, y = _data()
    g.fit(x, y)
    path = str(tmp_path / "g.zip")
    ModelSerializer.writeModel(g, path)
    back = ModelSerializer.restoreComputationGraph(path, device="cpu")
    for a, b in zip(tree_leaves([g.params_map, g.opt_states, g.states_map]),
                    tree_leaves([back.params_map, back.opt_states,
                                 back.states_map])):
        assert torch.equal(a, b)
    assert torch.equal(back.output(x)[0], g.output(x)[0])
    jg = JSerializer.restoreComputationGraph(path)
    assert _max_diff(_graph_leaves(g.params_map),
                     _leaves_np(jg.params_map)) == 0.0
    np.testing.assert_allclose(np.asarray(jg.output(x)[0].jax),
                               g.output(x)[0].numpy(), atol=F32_OUT_TOL,
                               rtol=0)


def _npz(arrays) -> zipfile.ZipFile:
    """A zip holding one npz member ``m.npz`` of ``arrays`` as the JAX
    writer encodes them: a type numpy cannot hold as a same-width uint
    view under ``<key>__as__<dtype>``."""
    buf = io.BytesIO()
    enc = {}
    for k, a in arrays.items():
        if a.dtype.type.__module__ == "numpy":
            enc[k] = a
        else:
            enc[f"{k}__as__{a.dtype.name}"] = a.view(
                {1: np.uint8, 2: np.uint16}[a.dtype.itemsize])
    with zipfile.ZipFile(buf, "w") as zf:
        b = io.BytesIO()
        np.savez(b, **enc)
        zf.writestr("m.npz", b.getvalue())
    buf.seek(0)
    return zipfile.ZipFile(buf)


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2",
                                   "bfloat16"])
def test_tagged_members_read_bit_equal_to_jax(dtype):
    """fp8 and bf16 members decode as the JAX reader decodes them, bit for
    bit, from the same-width uint view JAX's writer stores."""
    import ml_dtypes

    vals = np.random.RandomState(7).randn(5, 4).astype(np.float32) * 8
    a = vals.astype(getattr(ml_dtypes, dtype))
    zf = _npz({"layer/W": a, "enc__as__dec/b": vals[0]})
    assert f"layer/W__as__{dtype}" in np.load(
        io.BytesIO(zf.read("m.npz"))).files
    got = read_npz(zf, "m.npz")
    want = jms._read_npz(zf, "m.npz")
    assert set(got) == set(want) == {"layer/W", "enc__as__dec/b"}
    t = got["layer/W"]
    assert t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        t.view(torch.uint8 if t.element_size() == 1 else torch.int16)
        .numpy().view(np.uint8 if t.element_size() == 1 else np.uint16),
        want["layer/W"].view(np.uint8 if t.element_size() == 1
                             else np.uint16))
    np.testing.assert_array_equal(got["enc__as__dec/b"].numpy(),
                                  want["enc__as__dec/b"])


def test_an_ml_dtypes_type_torch_lacks_raises_naming_it():
    import ml_dtypes

    a = np.arange(6, dtype=np.int8).astype(ml_dtypes.int4)
    zf = _npz({"q": a})
    assert "q" in jms._read_npz(zf, "m.npz")
    with pytest.raises(NotImplementedError, match="int4"):
        read_npz(zf, "m.npz")


# ------------------------------------------------------------------ zoo
@pytest.mark.parametrize("prec", [None, "float32", "mixed_bfloat16",
                                  "mixed_float16", "policy"])
@pytest.mark.parametrize("model", ["TextGenerationLSTM", "ResNet50"])
def test_zoo_models_take_a_policy_as_jax(model, prec):
    kw = dict(name="c", compute_dtype="bfloat16",
              layer_overrides={"fc": "float32", 0: "float32"})
    mine = PrecisionPolicy(**kw) if prec == "policy" else prec
    theirs = JPolicy(**kw) if prec == "policy" else prec
    ours, jax_cls = ((TextGenerationLSTM, JTextGen)
                     if model == "TextGenerationLSTM"
                     else (ResNet50, JResNet50))
    assert ours(precision=mine).conf().to_json() == \
        jax_cls(precision=theirs).conf().to_json()


# ---------------------------------------------------------------- the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_and_cpu(make):
    """The model ``make(device)`` on the card with the CPU twin's
    parameters."""
    cpu = make("cpu")
    card = make("cuda")
    if hasattr(cpu, "params_map"):
        card.params_map = {n: {k: v.to("cuda") for k, v in p.items()}
                           for n, p in cpu.params_map.items()}
    else:
        card.params_list = [{k: v.to("cuda") for k, v in p.items()}
                            for p in cpu.params_list]
    return card, cpu


@pytest.fixture
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


@pytest.mark.cuda
@pytest.mark.parametrize("policy", MIXED)
def test_cuda_char_lstm_mixed_matches_the_cpu(policy, _no_tf32):
    """The char-LSTM at hidden 64 (a cluster width of B5), 3 Nesterovs
    steps card against CPU: under mixed_bfloat16 every B5 launch on the
    cluster route (the carries made in the compute dtype), f32 masters."""
    _needs_card()
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    def make(dev):
        conf = TextGenerationLSTM(vocab_size=11, hidden=64, tbptt_length=10,
                                  precision=policy,
                                  updater=Nesterovs(0.05, 0.9)).conf()
        return MultiLayerNetwork(conf, device=dev).init()

    card, cpu = _card_and_cpu(make)
    x, y = _char_batch(n=8, t=30)
    before = (lr.fwd_launches, lr.bwd_launches, lr.fwd_cluster_launches,
              lr.bwd_cluster_launches)
    for _ in range(3):
        card.fit(x, y)
        cpu.fit(x, y)
        assert abs(card.score() - cpu.score()) <= LSTM_TOL[0] * cpu.score()
    launched = [a - b for a, b in zip((lr.fwd_launches, lr.bwd_launches,
                                       lr.fwd_cluster_launches,
                                       lr.bwd_cluster_launches), before)]
    assert launched[:2] == [18, 18]          # 3 fits x 3 segments x 2
    if policy == "mixed_bfloat16":
        assert launched[2:] == launched[:2]
    assert _float_dtypes(card.params_list) == _float_dtypes(
        card.opt_states) == {torch.float32}
    assert _max_diff(_port_leaves(card.params_list),
                     _port_leaves(cpu.params_list)) <= LSTM_TOL[1]
    np.testing.assert_allclose(card.rnnTimeStep(x[:, 0]).cpu().numpy(),
                               cpu.rnnTimeStep(x[:, 0]).numpy(),
                               atol=LSTM_TOL[2], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", MIXED)
def test_cuda_cut_resnet_mixed_matches_the_cpu(policy, _no_tf32):
    """The cut ResNet, 3 Nesterovs steps card against CPU; the batch-norm
    kernels launched on f32 inputs (the islands)."""
    _needs_card()
    from deeplearning4j_tpu_torch.ops import batch_norm as bn

    def make(dev):
        conf = cut_resnet_conf()
        conf.precision = policy
        return ComputationGraph(conf, device=dev).init()

    card, cpu = _card_and_cpu(make)
    seen, plain = set(), bn.bn_stats_kernel

    def stats(x2, *a, **k):
        seen.add(x2.dtype)
        return plain(x2, *a, **k)

    bn.bn_stats_kernel = stats
    try:
        rs = np.random.RandomState(0)
        x = rs.randn(8, 32, 32, 3).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 8)]
        for _ in range(3):
            card.fit(x, y)
            cpu.fit(x, y)
            assert abs(card.score() - cpu.score()) <= RESNET_TOL[0] * \
                cpu.score()
    finally:
        bn.bn_stats_kernel = plain
    assert seen == {torch.float32}
    assert _max_diff(_graph_leaves(card.params_map),
                     _graph_leaves(cpu.params_map)) <= RESNET_TOL[1]
    np.testing.assert_allclose(card.output(x)[0].cpu().numpy(),
                               cpu.output(x)[0].numpy(),
                               atol=RESNET_TOL[2], rtol=0)
    if policy == "mixed_float16":
        assert _ls(card._loss_scale_state) == _ls(cpu._loss_scale_state)


@pytest.mark.cuda
def test_cuda_forced_overflow_skips_the_step(tmp_path):
    """On the card: the overflowing step leaves parameters, updater state
    and layer state bit-equal, the scale halves, the state equals the
    CPU's; the zip written there restores on the CPU with it."""
    _needs_card()

    def make(dev):
        return MultiLayerNetwork(_dense_conf("mixed_float16"),
                                 device=dev).init()

    card, cpu = _card_and_cpu(make)
    x, y = _data()
    card.fit(x, y)
    cpu.fit(x, y)
    before = [t.clone() for t in tree_leaves(
        [card.params_list, card.opt_states, card.states_list])]
    card.fit(OVERFLOW_X, y)
    cpu.fit(OVERFLOW_X, y)
    after = tree_leaves([card.params_list, card.opt_states,
                         card.states_list])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert _ls(card._loss_scale_state) == _ls(cpu._loss_scale_state)
    assert _ls(card._loss_scale_state)["skipped_steps"] == 1
    path = str(tmp_path / "m.zip")
    ModelSerializer.writeModel(card, path)
    back = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    assert _ls(back._loss_scale_state) == _ls(card._loss_scale_state)
