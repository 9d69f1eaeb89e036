"""PyTorch port, the updaters and learning-rate schedules: ``NoOp``,
``AdamW``, ``AdaMax``, ``Nadam``, ``AMSGrad``, ``AdaGrad``, ``AdaDelta``
and ``RmsProp`` (``learning/updaters.py``), the eight ``ISchedule``
classes and ``resolve_lr`` (``learning/schedules.py``), against the JAX
package's on the same numpy gradients.

Tolerances:
- f32 trajectories (five steps of ``apply_updater``, parameters and state)
  within rtol 1e-6 / atol 1e-7 (the same f32 formulas; XLA fuses some
  into one rounding);
- bf16 parameters with f32 state: the state within rtol 1e-6, the bf16
  parameters within one bf16 rounding (2^-8 of the value) at each step;
- the step-300 bias correction: the update within 2e-2 relative of an f64
  reference of the same math (JAX's own test) and within 1e-6 of JAX;
- schedules: the rates JAX's ``resolve_lr`` gives inside ``jit`` over
  steps 0-50, bit for bit for the schedules without a transcendental
  (``StepSchedule``, ``MapSchedule``) and within 1e-6 relative for the
  others (XLA's f32 ``pow``, ``exp`` and ``cos``);
- the JSON letter for letter both ways.
"""

import zlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import learning as tl
from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.learning.updaters import apply_updater

NEW = ("NoOp", "AdamW", "AdaMax", "Nadam", "AMSGrad", "AdaGrad", "AdaDelta",
       "RmsProp")
#: constructor arguments beside the learning rate
KW = {"AdamW": {"weight_decay": 0.05}, "AdaDelta": {"rho": 0.9},
      "RmsProp": {"rms_decay": 0.9}, "AdaGrad": {"epsilon": 1e-6}}
LR = {"NoOp": None, "AdaDelta": None}


def _make(pkg, name, lr=1e-2):
    kw = dict(KW.get(name, {}))
    if LR.get(name, 0) is not None:
        kw["learning_rate"] = lr
    return getattr(pkg, name)(**kw)


def _jax():
    import deeplearning4j_tpu.learning as jl

    return jl


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def _params(rs):
    return {"W": rs.randn(3, 4).astype(np.float32),
            "layer": {"b": rs.randn(4).astype(np.float32)}}


def _trees(got, want, what, rtol=1e-6, atol=1e-7):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _trees(got[k], want[k], f"{what}/{k}", rtol, atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _trees(g, w, f"{what}/{i}", rtol, atol)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol, err_msg=what)


def _trajectory(name, dtype, steps=5, lr=1e-2):
    """Both packages' ``apply_updater`` over ``steps`` steps from the same
    parameters and gradients; yields (port params, state, JAX params,
    state) after each step."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.learning.updaters import apply_updater as japply

    rs = np.random.RandomState(zlib.crc32(name.encode()) % 1000)
    p0 = _params(rs)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), p0)
    tp = {"W": torch.from_numpy(p0["W"]).to(tdt),
          "layer": {"b": torch.from_numpy(p0["layer"]["b"]).to(tdt)}}
    ju, tu = _make(_jax(), name, lr), _make(tl, name, lr)
    js, ts = ju.init_state(jp), tu.init_state(tp)
    for step in range(steps):
        g = _params(rs)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), g)
        tg = {"W": torch.from_numpy(g["W"]).to(tdt),
              "layer": {"b": torch.from_numpy(g["layer"]["b"]).to(tdt)}}
        jup, js = japply(ju, js, jg, jp, jnp.asarray(step))
        jp = jax.tree_util.tree_map(lambda a, u: a - u, jp, jup)
        tup, ts = apply_updater(tu, ts, tg, tp, step)
        tp = {"W": tp["W"] - tup["W"],
              "layer": {"b": tp["layer"]["b"] - tup["layer"]["b"]}}
        yield tp, ts, jax.device_get(jp), jax.device_get(js)


@pytest.mark.parametrize("name", NEW)
def test_five_steps_match_jax_at_f32(name):
    for step, (tp, ts, jp, js) in enumerate(_trajectory(name, "float32")):
        _trees(tp, jp, f"{name} params, step {step}")
        _trees(ts, js, f"{name} state, step {step}")


@pytest.mark.parametrize("name", NEW)
def test_five_steps_match_jax_with_bf16_parameters(name):
    """bf16 parameters, f32 state (``zeros_f32``), the update math in f32
    and the update cast to bf16."""
    for step, (tp, ts, jp, js) in enumerate(_trajectory(name, "bfloat16")):
        assert {t.dtype for t in (tp["W"], tp["layer"]["b"])} == {
            torch.bfloat16}
        for leaf in (ts if isinstance(ts, tuple) else
                     [v for d in ts.values() for v in
                      (d["W"], d["layer"]["b"])]):
            assert leaf.dtype == torch.float32, name
        _trees(ts, js, f"{name} state, step {step}")
        for got, want in ((tp["W"], jp["W"]),
                          (tp["layer"]["b"], jp["layer"]["b"])):
            got, want = _f32(got), _f32(want)
            assert np.all(np.abs(got - want)
                          <= 2.0 ** -8 * np.abs(want) + 1e-30), (name, step)


def test_optimizer_state_is_f32_for_bf16_params():
    """JAX's ``test_optimizer_state_is_f32_for_bf16_params`` on the port,
    for every stateful updater."""
    params = {"W": torch.ones(4, 4, dtype=torch.bfloat16)}
    for name in NEW:
        st = _make(tl, name).init_state(params)
        for d in (st.values() if isinstance(st, dict) else ()):
            assert d["W"].dtype == torch.float32, name


@pytest.mark.parametrize("name", ["Adam", "Nadam", "AMSGrad"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_bias_correction_is_f32_for_low_precision_params(name, dtype):
    """JAX's step-300 case: one step from zero state at step 300 with
    half-precision parameters; ``1 - beta^t`` in f32 (in half precision
    beta2^301 rounds to 1 and the update blows up). The update within 2e-2
    of an f64 reference and within 1e-6 of the JAX updater's."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.learning.updaters import apply_updater as japply

    upd = getattr(tl, name)(learning_rate=0.1)
    step, g64 = 300, np.full((4,), 0.01, np.float64)
    params = {"W": torch.ones(4, dtype=dtype)}
    state = upd.init_state(params)
    updates, state = apply_updater(upd, state, {
        "W": torch.from_numpy(g64).to(dtype)}, params, step)
    assert state["m"]["W"].dtype == state["v"]["W"].dtype == torch.float32
    b1, b2, eps, t = upd.beta1, upd.beta2, upd.epsilon, step + 1
    m, v = (1 - b1) * g64, (1 - b2) * g64 * g64
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    if name == "Nadam":
        want = 0.1 / bc1 * (b1 * m + (1 - b1) * g64) / (np.sqrt(v / bc2)
                                                         + eps)
    else:
        want = 0.1 * np.sqrt(bc2) / bc1 * m / (np.sqrt(v) + eps)
    got = _f32(updates["W"])
    np.testing.assert_allclose(got, want, rtol=2e-2)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    ju = getattr(_jax(), name)(learning_rate=0.1)
    jparams = {"W": jnp.ones(4, jdt)}
    jup, _ = japply(ju, ju.init_state(jparams),
                    {"W": jnp.asarray(g64, jdt)}, jparams, jnp.asarray(step))
    np.testing.assert_allclose(got, _f32(jup["W"]), rtol=1e-6)


@pytest.mark.parametrize("name", ["Adam", "Nadam", "AMSGrad", "AdaMax"])
def test_step_300_matches_jax_at_f32(name):
    """The JAX round's step-300 goldens: one f32 update at step 300 from a
    moved state (the moments of three earlier gradients)."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.learning.updaters import apply_updater as japply

    rs = np.random.RandomState(3)
    p = {"W": rs.randn(5, 3).astype(np.float32)}
    ju, tu = getattr(_jax(), name)(3e-3), getattr(tl, name)(3e-3)
    js = ju.init_state({"W": jnp.asarray(p["W"])})
    ts = tu.init_state({"W": torch.from_numpy(p["W"])})
    for step in (297, 298, 299, 300):
        g = rs.randn(5, 3).astype(np.float32)
        jup, js = japply(ju, js, {"W": jnp.asarray(g)},
                         {"W": jnp.asarray(p["W"])}, jnp.asarray(step))
        tup, ts = apply_updater(tu, ts, {"W": torch.from_numpy(g)},
                                {"W": torch.from_numpy(p["W"])}, step)
    _trees(tup, jup, f"{name} update")
    _trees(ts, js, f"{name} state")


def test_adamw_decay_reads_the_parameters():
    """``apply_updater`` calls AdamW's ``apply_with_params``: at a zero
    gradient the update is ``lr * weight_decay * p``; bf16 parameters
    promote to f32 in that product, as JAX's f32 rate makes them."""
    upd = tl.AdamW(learning_rate=0.1, weight_decay=0.5)
    for dtype in (torch.float32, torch.bfloat16):
        p = {"W": torch.full((3,), 2.0, dtype=dtype)}
        u, _ = apply_updater(upd, upd.init_state(p),
                             {"W": torch.zeros(3, dtype=dtype)}, p, 0)
        assert u["W"].dtype == dtype
        np.testing.assert_allclose(_f32(u["W"]), 0.1 * 0.5 * 2.0,
                                   rtol=2.0 ** -8)


def test_noop_leaves_parameters_and_freezes_a_graph_vertex():
    """``NoOp`` gives a zero update; a ``FrozenVertex`` takes ``NoOp``
    whatever the graph's updater (AdamW would decay it at a zero
    gradient), as the JAX graph's ``init`` gives it."""
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer, InputType,
                                                  OutputLayer)
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph, ComputationGraphConfiguration, FrozenVertex,
        LayerVertex)

    u, st = apply_updater(tl.NoOp(), (), {"W": torch.ones(2)},
                          {"W": torch.ones(2)}, 0)
    assert st == () and float(u["W"].abs().sum()) == 0
    conf = (ComputationGraphConfiguration.graphBuilder().seed(2)
            .updater(tl.AdamW(1e-2, weight_decay=0.5)).addInputs("x")
            .setInputTypes(InputType.feedForward(3))
            .addVertex("frozen", FrozenVertex(vertex=LayerVertex(
                layer=DenseLayer(n_in=3, n_out=4, activation="tanh"))), "x")
            .addLayer("out", OutputLayer(n_out=2, loss="mse",
                                         activation="identity"), "frozen")
            .setOutputs("out").build())
    g = ComputationGraph(conf, device="cpu").init()
    assert isinstance(g._updaters["frozen"], tl.NoOp)
    before = {k: v.clone() for k, v in g.params_map["frozen"].items()}
    out_before = {k: v.clone() for k, v in g.params_map["out"].items()}
    rs = np.random.RandomState(4)
    g.fit(rs.randn(5, 3).astype(np.float32),
          rs.randn(5, 2).astype(np.float32))
    for k, v in before.items():
        assert torch.equal(g.params_map["frozen"][k], v)
    assert not torch.equal(g.params_map["out"]["W"], out_before["W"])


@pytest.mark.parametrize("name", NEW + ("Sgd", "Nesterovs", "Adam"))
def test_updater_json_matches_jax_both_ways(name):
    from deeplearning4j_tpu.common import serde as jserde

    js = jserde.to_json(_make(_jax(), name))
    assert serde.to_json(_make(tl, name)) == js
    assert serde.from_json(js) == _make(tl, name)
    assert jserde.to_json(jserde.from_json(serde.to_json(_make(tl, name)))) \
        == js


# --------------------------------------------------------------- schedules
SCHEDULES = [
    ("ExponentialSchedule", {"initial_value": 0.1, "gamma": 0.97}),
    ("InverseSchedule", {"initial_value": 0.1, "gamma": 0.05, "power": 1.5}),
    ("InverseSchedule", {"initial_value": 0.2, "gamma": 0.1, "power": 1.0}),
    ("StepSchedule", {"initial_value": 0.1, "decay_rate": 0.5,
                      "step": 7.0}),
    ("PolySchedule", {"initial_value": 0.1, "power": 2.0, "max_iter": 40}),
    ("PolySchedule", {"initial_value": 0.1, "power": 0.7, "max_iter": 33}),
    ("SigmoidSchedule", {"initial_value": 0.1, "gamma": 0.3,
                         "step_size": 20}),
    ("MapSchedule", {"values": {0: 0.1, 10: 0.05, 30: 0.01}}),
    ("CosineSchedule", {"initial_value": 0.1, "max_iter": 40,
                        "final_value": 0.003}),
    ("WarmupSchedule", {"warmup_steps": 10}),
]
EXACT = ("StepSchedule", "MapSchedule")


def _schedule(pkg, name, kw):
    if name == "WarmupSchedule":
        return pkg.WarmupSchedule(base=pkg.ExponentialSchedule(0.1, 0.95),
                                  **kw)
    return getattr(pkg, name)(**kw)


@pytest.mark.parametrize("name, kw", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_schedule_matches_jax_resolve_lr(name, kw):
    """Steps 0-50 against ``resolve_lr`` inside ``jit`` (a traced int32
    step, as the JAX training step passes it)."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.learning.schedules import resolve_lr as jres

    js, ts = _schedule(_jax(), name, kw), _schedule(tl, name, kw)
    f = jax.jit(lambda s: jres(js, s))
    want = np.array([float(f(jnp.asarray(s))) for s in range(51)])
    got = np.array([tl.schedules.resolve_lr(ts, s) for s in range(51)])
    assert all(isinstance(tl.schedules.resolve_lr(ts, s), float)
               for s in (0, 7))
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert ts.schedule_type is tl.ScheduleType.ITERATION


def test_float_learning_rate_resolves_to_its_f32_value():
    from deeplearning4j_tpu_torch.learning.schedules import resolve_lr

    assert resolve_lr(0.1, 5) == float(np.float32(0.1))
    assert resolve_lr(tl.ExponentialSchedule(0.5, 0.5), torch.tensor(2)) \
        == 0.125


def test_map_schedule_needs_step_zero_and_reads_string_keys():
    with pytest.raises(ValueError, match="step 0"):
        tl.MapSchedule(values={5: 0.1})
    s = tl.MapSchedule(values={"0": 0.1, "4": 0.01})
    assert s.value_at(3) == float(np.float32(0.1))
    assert s.value_at(4) == float(np.float32(0.01))


@pytest.mark.parametrize("name, kw", SCHEDULES[:3] + SCHEDULES[7:],
                         ids=["exp", "inv", "inv1", "map", "cos", "warmup"])
def test_schedule_json_matches_jax_both_ways(name, kw):
    from deeplearning4j_tpu.common import serde as jserde

    js = jserde.to_json(_jax().Adam(_schedule(_jax(), name, kw)))
    assert serde.to_json(tl.Adam(_schedule(tl, name, kw))) == js
    assert serde.to_json(serde.from_json(js)) == js
    assert jserde.to_json(jserde.from_json(js)) == js


def _epoch_net(pkg_jax):
    if pkg_jax:
        import deeplearning4j_tpu.learning as L
        from deeplearning4j_tpu.nn import conf as C
    else:
        L = tl
        from deeplearning4j_tpu_torch.nn import conf as C
    sched = L.ExponentialSchedule(initial_value=0.5, gamma=0.25,
                                  type="epoch")
    return (C.NeuralNetConfiguration.builder().seed(3)
            .updater(L.Sgd(sched)).list()
            .layer(C.DenseLayer(n_out=5, activation="tanh"))
            .layer(C.OutputLayer(n_out=2, activation="softmax",
                                 loss="mcxent"))
            .setInputType(C.InputType.feedForward(4)).build())


def test_epoch_schedule_follows_the_epoch_count_on_both_networks():
    """An epoch-typed schedule reads the epoch count: two epochs of three
    batches through ``fit(iterator, epochs=2)`` equal the JAX network's
    (the rate 0.5, then 0.125), on the MLN and on a graph of the same
    layers."""
    import jax
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JList)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.learning.schedules import (
        uses_epoch_schedule)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy

    jnet = JMLN(_epoch_net(True)).init()
    net = MultiLayerNetwork(_epoch_net(False), device="cpu").init()
    assert uses_epoch_schedule(net._updaters[0])
    net.params_list = mln_params_from_numpy(jax.device_get(jnet.params_list),
                                            device="cpu")
    rs = np.random.RandomState(5)
    batches = [(rs.randn(4, 4).astype(np.float32),
                np.eye(2, dtype=np.float32)[rs.randint(0, 2, 4)])
               for _ in range(3)]
    jnet.fit(JList([JDataSet(x, y) for x, y in batches]), epochs=2)
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]),
            epochs=2)
    assert net.getEpochCount() == jnet.getEpochCount() == 2
    _trees(net.params_list, jax.device_get(jnet.params_list), "params",
           rtol=1e-5, atol=1e-6)

    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    def graph(pkg_jax):
        if pkg_jax:
            import deeplearning4j_tpu.learning as L
            from deeplearning4j_tpu.nn import conf as C
            from deeplearning4j_tpu.nn import graph as G
        else:
            L = tl
            from deeplearning4j_tpu_torch.nn import conf as C
            from deeplearning4j_tpu_torch.nn import graph as G
        sched = L.ExponentialSchedule(initial_value=0.5, gamma=0.25,
                                      type="epoch")
        return (G.ComputationGraphConfiguration.graphBuilder().seed(3)
                .updater(L.Sgd(sched)).addInputs("x")
                .setInputTypes(C.InputType.feedForward(4))
                .addLayer("h", C.DenseLayer(n_out=5, activation="tanh"), "x")
                .addLayer("o", C.OutputLayer(n_out=2, activation="softmax",
                                             loss="mcxent"), "h")
                .setOutputs("o").build())

    from deeplearning4j_tpu_torch.params import cg_params_from_numpy

    jg = JCG(graph(True)).init()
    g = ComputationGraph(graph(False), device="cpu").init()
    g.params_map = cg_params_from_numpy(g.conf.nodes,
                                        jax.device_get(jg.params_map),
                                        device="cpu")
    jg.fit(JList([JDataSet(x, y) for x, y in batches]), epochs=2)
    g.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]),
          epochs=2)
    assert g.getEpochCount() == jg.getEpochCount() == 2
    _trees(g.params_map, jax.device_get(jg.params_map), "graph params",
           rtol=1e-5, atol=1e-6)
