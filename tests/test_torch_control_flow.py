"""PyTorch port, SameDiff control flow and validation
(``deeplearning4j_tpu_torch/autodiff/control_flow.py``, ``validation.py``):
the cases of ``tests/test_control_flow_validation.py``, each graph built
through the same API in both packages and the port held against JAX.

- Branches, counted and dynamic loops, dead iterations, the static
  trip-count analysis (the stamped ``max_trip_count`` equals JAX's):
  outputs and gradients within 1e-6 of JAX's.
- A gradient through a dynamically-terminated loop raises JAX's
  documented ValueError, word for word, from ``calculateGradients`` and
  from ``fit``; a loop with only integer state, or off the gradient path,
  trains in both.
- Control-flow graphs cross between the packages through the zip, both
  ways.
- ``GradCheckUtil`` and ``OpValidation`` agree with JAX's verdicts; the
  gradient check gives the graph back the very tensor it held.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.autodiff import (GradCheckUtil, OpValidation,
                                               SameDiff, TestCase,
                                               TrainingConfig)
from deeplearning4j_tpu_torch.autodiff import control_flow as cf
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning.updaters import Sgd


def _jax():
    import deeplearning4j_tpu.ops  # noqa: F401  (registers the JAX ops)
    from deeplearning4j_tpu import autodiff as jad

    return jad


def _both():
    """(port graph, JAX graph)."""
    return SameDiff(device="cpu"), _jax().SameDiff()


def _close(got, want, tol=1e-6):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _out(sd, feeds, names):
    return sd.output(feeds, names)


def _max_trip(sd):
    return next(n for n in sd._ops
                if n.op_name == "while_loop").attrs["max_trip_count"]


# ------------------------------------------------------------- branches
@pytest.mark.parametrize("pred", [True, False])
def test_branch_selection(pred):
    for sd in _both():
        x = sd.placeholder("x", shape=(None,))
        p = sd.placeholder("p", shape=())
        out = sd.ifCond(p, [x], lambda sub, a: a * 2.0,
                        lambda sub, a: a + 100.0)
        r = _out(sd, {"x": np.ones(3, np.float32), "p": np.asarray(pred)},
                 [out.name])[out.name]
        _close(r, np.full(3, 2.0 if pred else 101.0))


def test_multi_output_branches_match_jax():
    got = []
    for sd in _both():
        x = sd.placeholder("x", shape=(2,))
        p = sd.placeholder("p", shape=())
        a, b = sd.ifCond(p, [x], lambda sub, v: [v + 1.0, v * 3.0],
                         lambda sub, v: [v - 1.0, v / 2.0])
        o = _out(sd, {"x": np.full(2, 4.0, np.float32),
                      "p": np.asarray(False)}, [a.name, b.name])
        got.append((o[a.name], o[b.name]))
    for g, w in zip(got[0], got[1]):
        _close(g, w)


def test_branch_arity_mismatch():
    for sd in _both():
        x = sd.placeholder("x", shape=(2,))
        p = sd.placeholder("p", shape=())
        with pytest.raises(ValueError, match="arity"):
            sd.ifCond(p, [x], lambda sub, v: [v, v], lambda sub, v: v)


@pytest.mark.parametrize("pred,want", [(True, [4.0, 6.0]),
                                       (False, [1.0, 1.0])])
def test_grad_through_cond(pred, want):
    for sd in _both():
        w = sd.var("w", np.asarray([2.0, 3.0], np.float32))
        p = sd.placeholder("p", shape=())
        out = sd.ifCond(p, [w], lambda sub, v: (v * v).sum(),
                        lambda sub, v: v.sum())
        sd.setLossVariables(out.name)
        _close(sd.calculateGradients({"p": np.asarray(pred)})["w"], want)


@pytest.mark.parametrize("index", [0, 1, 2, 7, -1])
def test_case_graph_out_of_range_runs_the_last_branch(index):
    """TF's rule in both packages: an index out of range, negatives
    included, runs the last branch."""
    from deeplearning4j_tpu.ops.registry import get_op as jget

    from deeplearning4j_tpu_torch.ops.registry import get_op
    from deeplearning4j_tpu_torch.tools.op_cases import subgraph

    branches = [subgraph(lambda s, a: a + 1.0, 1),
                subgraph(lambda s, a: a * 3.0, 1),
                subgraph(lambda s, a: a - 5.0, 1)]
    x = np.arange(4, dtype=np.float32)
    want = jget("case_graph")(np.int32(index), x, branches=branches)
    before = cf.host_reads
    got = get_op("case_graph")(torch.tensor(index, dtype=torch.int32),
                               torch.from_numpy(x), branches=branches)
    assert cf.host_reads == before + 1
    _close(got, want)


# ---------------------------------------------------------------- loops
def test_countdown_sum():
    for sd in _both():
        i0 = sd.placeholder("i0", shape=())
        acc0 = sd.placeholder("acc0", shape=())
        i_f, acc_f = sd.whileLoop(
            [i0, acc0], cond_fn=lambda sub, i, acc: i < 5.0,
            body_fn=lambda sub, i, acc: [i + 1.0, acc + i])
        o = _out(sd, {"i0": np.float32(0.0), "acc0": np.float32(0.0)},
                 [i_f.name, acc_f.name])
        assert float(o[i_f.name]) == 5.0 and float(o[acc_f.name]) == 10.0


def test_vector_state():
    for sd in _both():
        x = sd.placeholder("x", shape=(3,))
        k = sd.placeholder("n", shape=())
        _, x_f = sd.whileLoop([k, x], cond_fn=lambda sub, k, v: k > 0.0,
                              body_fn=lambda sub, k, v: [k - 1.0, v * 2.0])
        _close(_out(sd, {"x": np.ones(3, np.float32), "n": np.float32(3.0)},
                    [x_f.name])[x_f.name], np.full(3, 8.0))


def test_body_arity_checked():
    for sd in _both():
        x = sd.placeholder("x", shape=())
        with pytest.raises(ValueError, match="body"):
            sd.whileLoop([x], cond_fn=lambda sub, v: v > 0.0,
                         body_fn=lambda sub, v: [v, v])


def _loop_graph(sd):
    i0 = sd.placeholder("i0", shape=())
    acc0 = sd.placeholder("acc0", shape=())
    _, acc_f = sd.whileLoop(
        [i0, acc0], cond_fn=lambda sub, i, acc: i < 4.0,
        body_fn=lambda sub, i, acc: [i + 1.0, acc + i * i])
    acc_f.rename("result")


@pytest.mark.parametrize("direction", ["port->port", "jax->port",
                                       "port->jax"])
def test_serde_roundtrip_control_flow(tmp_path, direction):
    jad = _jax()
    src = SameDiff(device="cpu") if direction.startswith("port") \
        else jad.SameDiff()
    _loop_graph(src)
    p = str(tmp_path / "cf.sdz")
    src.save(p)
    dst = jad.SameDiff.load(p) if direction.endswith("jax") \
        else SameDiff.load(p, device="cpu")
    out = dst.output({"i0": np.float32(0.0), "acc0": np.float32(0.0)},
                     ["result"])["result"]
    assert float(out) == 0 + 1 + 4 + 9


# -------------------------------------------------------- trainable loops
def _counted_loop(sd):
    x = sd.var("x", np.asarray([2.0, 3.0], np.float32))
    i0 = sd.constant("i0", np.int32(0))
    return sd.whileLoop(
        [i0, x],
        cond_fn=lambda sub, i, a: sub._op(
            "lt", [i.name, sub.constant("n", np.int32(3)).name]),
        body_fn=lambda sub, i, a: (
            sub._op("add", [i.name, sub.constant("one", np.int32(1)).name]),
            sub._op("mul", [a.name,
                            sub.constant("two", np.float32(2.0)).name])))


def test_counted_loop_trains_as_in_jax():
    res = []
    for sd in _both():
        outs = _counted_loop(sd)
        assert _max_trip(sd) == 3
        loss = sd._op("reduce_sum", [outs[1].name])
        sd.setLossVariables(loss.name)
        res.append((sd.calculateGradients({}, ["x"])["x"], outs[1].eval()))
    _close(res[0][0], np.full(2, 8.0))
    _close(res[0][1], [16.0, 24.0])
    for g, w in zip(res[0], res[1]):
        _close(g, w)


def test_masked_scan_matches_while_semantics():
    for sd in _both():
        x = sd.var("x", np.float32(1.0))
        i0 = sd.constant("i0", np.int32(0))
        outs = sd.whileLoop(
            [i0, x],
            cond_fn=lambda sub, i, a: sub._op(
                "lte", [i.name, sub.constant("n", np.int32(5)).name]),
            body_fn=lambda sub, i, a: (
                sub._op("add", [i.name,
                                sub.constant("two", np.int32(2)).name]),
                sub._op("add", [a.name,
                                sub.constant("one", np.float32(1.0)).name])))
        assert _max_trip(sd) == 3
        assert float(outs[1].eval()) == 4.0


def _dynamic_loop(sd):
    x = sd.var("x", np.asarray([1.5], np.float32))
    outs = sd.whileLoop(
        [x],
        cond_fn=lambda sub, a: sub._op(
            "lt", [sub._op("reduce_sum", [a.name]).name,
                   sub.constant("b", np.float32(100.0)).name]),
        body_fn=lambda sub, a: (
            sub._op("mul", [a.name,
                            sub.constant("two", np.float32(2.0)).name]),))
    return outs if isinstance(outs, tuple) else (outs,)


def test_dynamic_loop_grad_fails_loudly_with_jax_words():
    msgs = []
    for sd in _both():
        outs = _dynamic_loop(sd)
        assert _max_trip(sd) is None
        _close(outs[0].eval(), [192.0])        # the forward still runs
        loss = sd._op("reduce_sum", [outs[0].name])
        sd.setLossVariables(loss.name)
        with pytest.raises(ValueError, match="inference-only") as e:
            sd.calculateGradients({}, ["x"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_integer_state_dynamic_loop_grads_fine():
    res = []
    for sd in _both():
        w = sd.var("w", np.float32(1.5))
        seed = sd._op("cast", [sd._op("mul", [w.name, sd.constant(
            "zero", np.float32(0.0)).name]).name], dtype="int32")
        outs = sd.whileLoop(
            [seed],
            cond_fn=lambda sub, i: sub._op(
                "lt", [i.name, sub.constant("n", np.int32(3)).name]),
            body_fn=lambda sub, i: (
                sub._op("add", [i.name,
                                sub.constant("one", np.int32(1)).name]),))
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert _max_trip(sd) is None
        stepsf = sd._op("cast", [outs[0].name], dtype="float32")
        loss = sd._op("reduce_sum", [sd._op("mul", [w.name,
                                                    stepsf.name]).name])
        sd.setLossVariables(loss.name)
        res.append(sd.calculateGradients({}, ["w"])["w"])
    _close(res[0], 3.0)
    _close(res[0], res[1])


def test_dynamic_loop_off_grad_path_is_fine():
    res = []
    for sd in _both():
        sd.var("x", np.asarray([1.0, 2.0], np.float32))
        c = sd.constant("c", np.float32(1.5))
        outs = sd.whileLoop(
            [c],
            cond_fn=lambda sub, a: sub._op(
                "lt", [a.name, sub.constant("b", np.float32(50.0)).name]),
            body_fn=lambda sub, a: (
                sub._op("mul", [a.name,
                                sub.constant("two", np.float32(2.0)).name]),))
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert _max_trip(sd) is None
        loss = sd._op("reduce_sum", [sd._op("mul", [outs[0].name,
                                                    "x"]).name])
        sd.setLossVariables(loss.name)
        res.append(sd.calculateGradients({}, ["x"])["x"])
    _close(res[0], np.full(2, 96.0))
    _close(res[0], res[1])


def test_fit_gets_the_loud_error_too():
    jad = _jax()
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.learning.updaters import Sgd as JSgd

    msgs = []
    for sd, TC, DS, S in ((SameDiff(device="cpu"), TrainingConfig, DataSet,
                           Sgd), (jad.SameDiff(), jad.TrainingConfig,
                                  JDataSet, JSgd)):
        x0 = sd.placeholder("x0", shape=(2,))
        sd.var("w", np.asarray([1.0, 1.0], np.float32))
        seeded = sd._op("mul", [x0.name, "w"])
        outs = sd.whileLoop(
            [seeded],
            cond_fn=lambda sub, a: sub._op(
                "lt", [sub._op("reduce_sum", [a.name]).name,
                       sub.constant("b", np.float32(40.0)).name]),
            body_fn=lambda sub, a: (
                sub._op("mul", [a.name,
                                sub.constant("two", np.float32(2.0)).name]),))
        outs = outs if isinstance(outs, tuple) else (outs,)
        sd.setLossVariables(sd._op("reduce_sum", [outs[0].name]).name)
        sd.setTrainingConfig(TC(updater=S(0.01),
                                data_set_feature_mapping=["x0"]))
        with pytest.raises(ValueError, match="inference-only") as e:
            sd.fit(DS(np.ones(2, np.float32), None), epochs=1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_tighter_conjunct_wins():
    for sd in _both():
        x = sd.var("x", np.float32(2.0))
        i0 = sd.constant("i0", np.int32(0))
        k0 = sd.constant("k0", np.float32(0.0))

        def cond(sub, i, k, a):
            lt = sub._op("lt", [i.name, sub.constant("n", np.int32(5)).name])
            lt2 = sub._op("lt", [k.name,
                                 sub.constant("m", np.float32(3.0)).name])
            return sub._op("logical_and", [lt.name, lt2.name])

        def body(sub, i, k, a):
            return (
                sub._op("add", [i.name, sub.constant("one",
                                                     np.int32(1)).name]),
                sub._op("add", [k.name, sub.constant(
                    "one_k", np.float32(1.0)).name]),
                sub._op("mul", [a.name, sub.constant(
                    "two", np.float32(2.0)).name]))

        outs = sd.whileLoop([i0, k0, x], cond_fn=cond, body_fn=body)
        assert _max_trip(sd) == 3
        assert float(outs[2].eval()) == 16.0


def test_dead_iterations_do_not_poison_grads():
    res = []
    for sd in _both():
        x = sd.var("x", np.float32(2.0))
        i0 = sd.constant("i0", np.int32(0))
        k0 = sd.constant("k0", np.float32(0.0))
        p0 = sd.constant("p0", np.float32(1.0))

        def cond(sub, i, k, p, a):
            lt = sub._op("lt", [i.name, sub.constant("n", np.int32(5)).name])
            gt = sub._op("gt", [p.name, sub.constant(
                "eps", np.float32(0.005)).name])
            return sub._op("logical_and", [lt.name, gt.name])

        def body(sub, i, k, p, a):
            den = sub._op("sub", [sub.constant(
                "three", np.float32(3.0)).name, k.name])
            inv = sub._op("div", [sub.constant(
                "one_f", np.float32(1.0)).name, den.name])
            return (
                sub._op("add", [i.name, sub.constant("one",
                                                     np.int32(1)).name]),
                sub._op("add", [k.name, sub.constant(
                    "one_k", np.float32(1.0)).name]),
                sub._op("mul", [p.name, sub.constant(
                    "tenth", np.float32(0.1)).name]),
                sub._op("mul", [a.name, inv.name]))

        outs = sd.whileLoop([i0, k0, p0, x], cond_fn=cond, body_fn=body)
        assert _max_trip(sd) == 5
        np.testing.assert_allclose(float(outs[3].eval()), 2.0 / 6.0,
                                   rtol=1e-6)
        sd.setLossVariables(sd._op("reduce_sum", [outs[3].name]).name)
        res.append(sd.calculateGradients({}, ["x"])["x"])
    _close(res[0], 1.0 / 6.0)
    _close(res[0], res[1])


def test_decreasing_counter_derives():
    for sd in _both():
        x = sd.var("x", np.float32(0.0))
        i0 = sd.constant("i0", np.int32(10))
        outs = sd.whileLoop(
            [i0, x],
            cond_fn=lambda sub, i, a: sub._op(
                "gt", [i.name, sub.constant("n", np.int32(4)).name]),
            body_fn=lambda sub, i, a: (
                sub._op("sub", [i.name,
                                sub.constant("two", np.int32(2)).name]),
                sub._op("add", [a.name,
                                sub.constant("one", np.float32(1.0)).name])))
        assert _max_trip(sd) == 3
        assert float(outs[1].eval()) == 3.0
        sd.setLossVariables(sd._op("reduce_sum", [outs[1].name]).name)
        sd.calculateGradients({}, ["x"])


def test_loop_host_reads_are_counted():
    """One read of the condition per iteration, the failing one
    included."""
    sd = SameDiff(device="cpu")
    i0 = sd.placeholder("i0", shape=())
    (i_f,) = (sd.whileLoop([i0], cond_fn=lambda sub, i: i < 5.0,
                           body_fn=lambda sub, i: [i + 1.0]),)
    before = cf.host_reads
    sd.output({"i0": np.float32(0.0)}, [i_f.name])
    assert cf.host_reads - before == 6


def test_sub_graphs_are_built_once_per_dict_and_device():
    """A branch run on every step builds its sub-graph (and copies its
    arrays to the device) once; a new dict of the same content, as a
    loaded graph holds, builds its own."""
    sd = SameDiff(device="cpu")
    x = sd.placeholder("x", shape=(None,))
    p = sd.placeholder("p", shape=())
    out = sd.ifCond(p, [x], lambda sub, a: a * 2.0, lambda sub, a: a + 1.0)
    node = next(n for n in sd._ops if n.op_name == "if_cond")
    true_graph = node.attrs["true_graph"]
    fn = cf.subgraph_fn(true_graph, torch.device("cpu"))
    for pred, want in ((True, 6.0), (False, 4.0), (True, 6.0)):
        r = sd.output({"x": np.full(2, 3.0, np.float32),
                       "p": np.asarray(pred)}, [out.name])[out.name]
        _close(r, np.full(2, want))
    assert cf.subgraph_fn(true_graph, torch.device("cpu")) is fn
    assert cf.subgraph_fn(dict(true_graph), torch.device("cpu")) is not fn


# ------------------------------------------------------------ validation
def test_gradcheck_passes_and_restores_the_held_tensor():
    jad = _jax()
    rs = np.random.default_rng(0)
    w0 = (rs.normal(size=(3, 2)) * 0.5).astype(np.float32)
    feeds = {"x": rs.normal(size=(4, 3)).astype(np.float32)}
    verdicts = []
    for sd, G in ((SameDiff(device="cpu"), GradCheckUtil),
                  (jad.SameDiff(), jad.GradCheckUtil)):
        x = sd.placeholder("x", shape=(4, 3))
        w = sd.var("w", w0)
        b = sd.var("b", np.zeros(2, np.float32))
        out = sd.nn.sigmoid(x @ w + b)
        sd.setLossVariables((out * out).mean().name)
        held = sd._arrays["w"]
        verdicts.append(G.checkGradients(sd, feeds, eps=1e-2,
                                         max_rel_error=0.08))
        if isinstance(held, torch.Tensor):
            assert sd._arrays["w"] is held
    assert verdicts == [True, True]


def test_gradcheck_catches_a_stopped_gradient():
    jad = _jax()
    for sd, G in ((SameDiff(device="cpu"), GradCheckUtil),
                  (jad.SameDiff(), jad.GradCheckUtil)):
        w = sd.var("w", np.asarray([1.0, 2.0], np.float32))
        sd.setLossVariables(sd.math.stop_gradient(w * w).sum().name)
        assert not G.checkGradients(sd, {}, eps=1e-2, print_failures=False)


def test_op_validation_forward_grad_and_attrs():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(3, 4)).astype(np.float32),
            rng.normal(size=(4, 2)).astype(np.float32))
    OpValidation.validate(TestCase("matmul", args=[a, b],
                                   expected=lambda a, b: a @ b,
                                   grad_eps=1e-2, grad_rtol=0.08,
                                   device="cpu"))
    OpValidation.validate(TestCase("reduce_mean", args=[a],
                                   attrs={"dimensions": [1]},
                                   expected=lambda a: a.mean(axis=1),
                                   grad_eps=1e-2, grad_rtol=0.08,
                                   device="cpu"))
    with pytest.raises(AssertionError):
        OpValidation.validate(TestCase(
            "add", args=[np.ones(2, np.float32), np.ones(2, np.float32)],
            expected=lambda a, b: a * 5, grad_check=False, device="cpu"))
    rep = OpValidation.coverage_report()
    assert rep["total"] == 442 and "matmul" in rep["validated"]
    assert "add" not in rep["validated"]
    OpValidation.mark_validated("add")
    assert "add" in OpValidation.coverage_report()["validated"]


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_counted_loop_trains_as_on_the_cpu():
    """The counted loop carrying float state, 3 ``fit`` steps on the card
    and on the CPU (1e-5); a dynamic loop's ``fit`` raises on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = []
    for dev in ("cuda", "cpu"):
        sd = SameDiff(device=dev)
        outs = _counted_loop(sd)
        sd.setLossVariables(sd._op("reduce_sum", [outs[1].name]).name)
        sd.setTrainingConfig(TrainingConfig(updater=Sgd(0.01),
                                            data_set_feature_mapping=["x0"]))
        sd.placeholder("x0", shape=(1,))
        h = sd.fit([DataSet(np.ones(1, np.float32), None)] * 3)
        res.append((h.lossCurve(), sd._arrays["x"].cpu()))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-5)
    _close(res[0][1], res[1][1], 1e-5)
    sd = SameDiff(device="cuda")
    outs = _dynamic_loop(sd)
    sd.setLossVariables(sd._op("reduce_sum", [outs[0].name]).name)
    with pytest.raises(ValueError, match="inference-only"):
        sd.calculateGradients({}, ["x"])
