"""PyTorch port, graph vertices: the fourteen vertices of
``deeplearning4j_tpu/nn/graph/vertices.py`` that seq2seq, siamese,
attention and transfer-learning graphs use, against the JAX vertices on
the same numpy inputs: outputs, output types, JSON, and the gradients of
every float input (``jax.vjp`` against ``torch.autograd`` with the same
cotangent).

Tolerances: outputs and gradients within 1e-6 of max(1, max |value|) at
f32 (sums over at most a few dozen terms in another order); integer
selections (the last real step) exact.

The cuda-marked tests at the end hold the card against the CPU and import
no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_rnn_vertices.py``.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.nn.conf import DenseLayer, InputType
from deeplearning4j_tpu_torch.nn.graph import vertices as tv

TOL = 1e-6


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _rs(seed=0):
    return np.random.RandomState(seed)


def _mask():
    """[3, 5]: a full row, a row with an interior gap, a row of one."""
    return np.array([[1, 1, 1, 1, 1], [1, 0, 1, 1, 0], [1, 0, 0, 0, 0]],
                    np.float32)


# name, kwargs, inputs (numpy), input types (for output_type)
CASES = [
    ("ScaleVertex", {"scale": 2.5}, lambda: [_rs(1).randn(3, 4)],
     [InputType.feedForward(4)]),
    ("L2NormalizeVertex", {}, lambda: [_rs(2).randn(3, 2, 2, 3)],
     [InputType.convolutional(2, 2, 3)]),
    ("SubsetVertex", {"frm": 1, "to": 3}, lambda: [_rs(3).randn(3, 5, 6)],
     [InputType.recurrent(6, 5)]),
    ("LastTimeStepVertex", {}, lambda: [_rs(4).randn(3, 5, 4)],
     [InputType.recurrent(4, 5)]),
    ("LastTimeStepVertex", {}, lambda: [_rs(5).randn(3, 5, 4), _mask()],
     [InputType.recurrent(4, 5), InputType.feedForward(5)]),
    ("DuplicateToTimeSeriesVertex", {},
     lambda: [_rs(6).randn(3, 4), _rs(7).randn(3, 6, 2)],
     [InputType.feedForward(4), InputType.recurrent(2, 6)]),
    ("ReverseTimeSeriesVertex", {}, lambda: [_rs(8).randn(3, 5, 4)],
     [InputType.recurrent(4, 5)]),
    ("StackVertex", {}, lambda: [_rs(9).randn(2, 4), _rs(10).randn(2, 4)],
     [InputType.feedForward(4)] * 2),
    ("UnstackVertex", {"from_index": 1, "stack_size": 3},
     lambda: [_rs(11).randn(6, 4)], [InputType.feedForward(4)]),
    ("ShiftVertex", {"shift": -0.75}, lambda: [_rs(12).randn(3, 4)],
     [InputType.feedForward(4)]),
    ("ReshapeVertex", {"shape": [2, 3, 2]}, lambda: [_rs(13).randn(3, 12)],
     [InputType.feedForward(12)]),
    ("ReshapeVertex", {"shape": [4, 3]}, lambda: [_rs(14).randn(3, 12)],
     [InputType.feedForward(12)]),
    ("L2Vertex", {}, lambda: [_rs(15).randn(3, 2, 3),
                              _rs(16).randn(3, 2, 3)],
     [InputType.recurrent(3, 2)] * 2),
    ("PoolHelperVertex", {}, lambda: [_rs(17).randn(2, 4, 5, 3)],
     [InputType.convolutional(4, 5, 3)]),
    ("DotProductAttentionVertex", {},
     lambda: [_rs(18).randn(2, 3, 4), _rs(19).randn(2, 5, 4),
              _rs(20).randn(2, 5, 6)],
     [InputType.recurrent(4, 3), InputType.recurrent(4, 5),
      InputType.recurrent(6, 5)]),
    ("DotProductAttentionVertex", {},
     lambda: [_rs(21).randn(2, 3, 4), _rs(22).randn(2, 5, 4),
              _rs(23).randn(2, 5, 6),
              np.array([[1, 1, 0, 1, 0], [1, 1, 1, 1, 1]], np.float32)],
     [InputType.recurrent(4, 3), InputType.recurrent(4, 5),
      InputType.recurrent(6, 5), InputType.feedForward(5)]),
]
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]


def _jax_vertex(name, kw):
    from deeplearning4j_tpu.nn.graph import vertices as jv

    return getattr(jv, name)(**kw)


def _jax_type(it):
    from deeplearning4j_tpu.nn.conf import InputType as JIt

    return JIt(**{k: getattr(it, k) for k in ("kind", "size", "height",
                                              "width", "channels", "depth",
                                              "timeseries_length")})


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("name, kw, make, types", CASES, ids=IDS)
def test_vertex_forward_and_type_match_jax(name, kw, make, types):
    xs = [np.asarray(a, np.float32) for a in make()]
    want, _ = _jax_vertex(name, kw).apply({}, {}, xs, False, None)
    v = getattr(tv, name)(**kw)
    got, _ = v.apply({}, {}, [torch.from_numpy(x) for x in xs], False, None)
    _close(got, want, TOL, name)
    jt = _jax_vertex(name, kw).output_type([_jax_type(t) for t in types])
    assert serde.to_dict(v.output_type(types)) == {
        "@class": "InputType", **{k: getattr(jt, k) for k in (
            "kind", "size", "height", "width", "channels", "depth",
            "timeseries_length")}}


@pytest.mark.parametrize("name, kw, make, types", CASES, ids=IDS)
def test_vertex_gradients_match_jax_vjp(name, kw, make, types):
    """``jax.vjp`` of the JAX vertex against autograd through the port's,
    with the same cotangent, for every float input but a mask."""
    import jax
    import jax.numpy as jnp

    xs = [np.asarray(a, np.float32) for a in make()]
    n_diff = 1 if name == "LastTimeStepVertex" else (
        3 if name == "DotProductAttentionVertex" else len(xs))
    jvx = _jax_vertex(name, kw)

    def jfn(*args):
        return jvx.apply({}, {}, list(args) + [jnp.asarray(x) for x in
                                               xs[n_diff:]], False, None)[0]

    out, vjp = jax.vjp(jfn, *[jnp.asarray(x) for x in xs[:n_diff]])
    cot = _rs(99).randn(*out.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(x).requires_grad_(i < n_diff)
          for i, x in enumerate(xs)]
    got, _ = getattr(tv, name)(**kw).apply({}, {}, ts, False, None)
    got.backward(torch.from_numpy(cot))
    for i in range(n_diff):
        # an input the output does not read (the reference series of
        # DuplicateToTimeSeries) gets no gradient here, zeros from JAX
        g = ts[i].grad if ts[i].grad is not None else torch.zeros_like(
            ts[i])
        _close(g, want[i], TOL, f"{name} d input {i}")


def test_duplicate_to_time_series_gradient_is_the_sum_over_time():
    """The broadcast is a stride-0 view; its gradient sums the decoder's
    input gradient over T, as ``jax.vjp`` of ``broadcast_to`` does."""
    feat = torch.from_numpy(_rs(30).randn(3, 4).astype(np.float32))
    feat.requires_grad_(True)
    ref = torch.zeros(3, 7, 2)
    out, _ = tv.DuplicateToTimeSeriesVertex().apply({}, {}, [feat, ref],
                                                    False, None)
    assert out.shape == (3, 7, 4) and out.stride(1) == 0
    cot = torch.from_numpy(_rs(31).randn(3, 7, 4).astype(np.float32))
    out.backward(cot)
    _close(feat.grad, cot.sum(1), TOL, "sum over T")


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64])
def test_last_time_step_takes_the_last_nonzero_step(dtype):
    """The mask's last nonzero step, not its sum minus one (an interior
    gap), in any mask dtype; a row of zeros takes the last step, as JAX's
    argmax of an all-zero row (index 0 of the flipped row) gives it."""
    from deeplearning4j_tpu.nn.graph import LastTimeStepVertex as JLast

    x = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    mask = np.array([[1, 0, 1, 0], [0, 0, 0, 0]], dtype)
    want, _ = JLast().apply({}, {}, [x, mask], False, None)
    got, _ = tv.LastTimeStepVertex().apply(
        {}, {}, [torch.from_numpy(x), torch.from_numpy(mask)], False, None)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(_f32(got), x[[0, 1], [2, 3]])


def test_unstack_vertex_errors_match_jax():
    from deeplearning4j_tpu.nn.graph import UnstackVertex as JUn

    for kw, x, match in (({"from_index": 0, "stack_size": 3},
                          np.ones((10, 4), np.float32), "divisible"),
                         ({"from_index": 2, "stack_size": 2},
                          np.ones((4, 4), np.float32), "from_index")):
        with pytest.raises(ValueError, match=match) as jerr:
            JUn(**kw).apply({}, {}, [x], False, None)
        with pytest.raises(ValueError, match=match) as terr:
            tv.UnstackVertex(**kw).apply({}, {}, [torch.from_numpy(x)],
                                         False, None)
        assert str(terr.value) == str(jerr.value)


def test_reshape_vertex_refuses_a_rank_five_shape():
    with pytest.raises(ValueError, match="bad shape"):
        tv.ReshapeVertex(shape=[1, 2, 3, 4, 5]).output_type(
            [InputType.feedForward(120)])


def test_frozen_vertex_passes_no_gradient_to_its_parameters():
    """A frozen dense layer: its output equals the JAX frozen vertex's, its
    parameters get no gradient (JAX: zeros through ``stop_gradient``) and
    the input's gradient still flows; inference mode inside."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.conf import DenseLayer as JDense
    from deeplearning4j_tpu.nn.graph import FrozenVertex as JFrozen
    from deeplearning4j_tpu.nn.graph import LayerVertex as JLayerVertex

    rs = _rs(40)
    p = {"W": rs.randn(4, 3).astype(np.float32),
         "b": rs.randn(3).astype(np.float32)}
    x = rs.randn(5, 4).astype(np.float32)
    jv = JFrozen(vertex=JLayerVertex(layer=JDense(n_in=4, n_out=3,
                                                  activation="tanh",
                                                  dropout=0.5)))

    def jfn(pp, xx):
        return jv.apply(pp, {}, [xx], True, jax.random.key(0))[0]

    out, vjp = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray, p),
                       jnp.asarray(x))
    cot = rs.randn(5, 3).astype(np.float32)
    jp, jx = vjp(jnp.asarray(cot))
    assert all(float(jnp.abs(g).max()) == 0 for g in jax.tree_util
               .tree_leaves(jp))
    v = tv.FrozenVertex(vertex=tv.LayerVertex(layer=DenseLayer(
        n_in=4, n_out=3, activation="tanh", dropout=0.5)))
    tp = {k: torch.from_numpy(a).requires_grad_(True) for k, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got, _ = v.apply(tp, {}, [tx], True, torch.Generator())
    _close(got, out, TOL, "frozen forward (dropout off inside)")
    got.backward(torch.from_numpy(cot))
    assert all(t.grad is None for t in tp.values())
    _close(tx.grad, jx, TOL, "d input")


def test_frozen_vertex_graph_from_a_jax_zip_trains_like_jax(tmp_path):
    """A graph with a frozen dense vertex under AdamW, written by the JAX
    ModelSerializer (the frozen vertex's parameters under its node name,
    its ``NoOp`` state empty): three steps in the port follow JAX's
    losses and parameters, and the frozen parameters stay as written."""
    import os

    import jax
    from deeplearning4j_tpu.learning import AdamW as JAdamW
    from deeplearning4j_tpu.nn.conf import DenseLayer as JDense
    from deeplearning4j_tpu.nn.conf import InputType as JIt
    from deeplearning4j_tpu.nn.conf import OutputLayer as JOut
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration \
        as JCGC
    from deeplearning4j_tpu.nn.graph import FrozenVertex as JFrozen
    from deeplearning4j_tpu.nn.graph import LayerVertex as JLayerVertex
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer
    from deeplearning4j_tpu_torch.learning import NoOp
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer)

    jconf = (JCGC.graphBuilder().seed(5)
             .updater(JAdamW(1e-2, weight_decay=0.1)).addInputs("x")
             .setInputTypes(JIt.feedForward(4))
             .addVertex("frozen", JFrozen(vertex=JLayerVertex(layer=JDense(
                 n_in=4, n_out=6, activation="tanh"))), "x")
             .addLayer("out", JOut(n_out=3, activation="softmax",
                                   loss="mcxent"), "frozen")
             .setOutputs("out").build())
    jg = JCG(jconf).init()
    path = os.path.join(tmp_path, "frozen.zip")
    JaxSerializer.writeModel(jg, path, save_updater=True)
    g = ModelSerializer.restoreComputationGraph(path, device="cpu")
    assert isinstance(g._updaters["frozen"], NoOp)
    assert g.opt_states["frozen"] == ()
    frozen = {k: v.clone() for k, v in g.params_map["frozen"].items()}
    rs = _rs(60)
    x = rs.randn(8, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    for _ in range(3):
        jg.fit(x, y)
        g.fit(x, y)
        assert abs(g.score() - float(jg.score())) <= 1e-5 * abs(
            float(jg.score()))
    want = jax.device_get(jg.params_map)
    for n in want:
        for k in want[n]:
            np.testing.assert_allclose(_f32(g.params_map[n][k]), want[n][k],
                                       rtol=1e-5, atol=1e-6)
    for k, v in frozen.items():
        assert torch.equal(g.params_map["frozen"][k], v)


def test_dot_product_attention_op_matches_jax():
    """The plain op the attention vertex calls (the reference's
    ``ops/nn.py`` ``dot_product_attention``), with a mask over a 4-D
    batch and an explicit scale."""
    from deeplearning4j_tpu.ops.nn import dot_product_attention as jdpa
    from deeplearning4j_tpu_torch.ops.nn import dot_product_attention

    rs = _rs(50)
    q, k, v = (rs.randn(2, 3, 4, 8).astype(np.float32) for _ in range(3))
    m = (rs.rand(2, 3, 4, 4) > 0.3).astype(np.float32)
    for scale in (None, 0.3):
        want = jdpa(q, k, v, mask=m, scale=scale)
        got = dot_product_attention(*(torch.from_numpy(a) for a in
                                      (q, k, v)), mask=torch.from_numpy(m),
                                    scale=scale)
        _close(got, want, TOL, f"scale {scale}")


@pytest.mark.parametrize("name, kw, make, types", CASES[:1] + CASES[2:3]
                         + CASES[8:11] + CASES[12:13],
                         ids=["Scale", "Subset", "Unstack", "Shift",
                              "Reshape", "L2"])
def test_vertex_json_matches_jax(name, kw, make, types):
    from deeplearning4j_tpu.common import serde as jserde

    js = jserde.to_json(_jax_vertex(name, kw))
    assert serde.to_json(getattr(tv, name)(**kw)) == js
    assert serde.to_json(serde.from_json(js)) == js


def test_frozen_vertex_json_round_trips_through_jax():
    from deeplearning4j_tpu.common import serde as jserde

    v = tv.FrozenVertex(vertex=tv.LayerVertex(layer=DenseLayer(n_in=2,
                                                               n_out=3)))
    js = serde.to_json(v)
    assert jserde.to_json(jserde.from_json(js)) == js
    assert serde.from_json(js) == v


# ---------------------------------------------------------------- the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_last_time_step_vertex_on_the_card(dtype):
    """``torch.argmax`` over the flipped mask on the card picks the first
    maximum, as on the CPU (int32 masks too)."""
    _need_card()
    x = torch.arange(3 * 6 * 2, dtype=torch.float32).reshape(3, 6, 2)
    mask = torch.tensor([[1, 0, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1],
                         [0, 0, 0, 0, 0, 0]], dtype=dtype)
    cpu, _ = tv.LastTimeStepVertex().apply({}, {}, [x, mask], False, None)
    card, _ = tv.LastTimeStepVertex().apply(
        {}, {}, [x.cuda(), mask.cuda()], False, None)
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(cpu, x[[0, 1, 2], [3, 5, 5]])


@pytest.mark.cuda
@pytest.mark.parametrize("name, kw, make, types", CASES, ids=IDS)
def test_vertices_on_the_card_match_the_cpu(name, kw, make, types):
    _need_card()
    xs = [torch.from_numpy(np.asarray(a, np.float32)) for a in make()]
    v = getattr(tv, name)(**kw)
    cpu, _ = v.apply({}, {}, xs, False, None)
    card, _ = v.apply({}, {}, [x.cuda() for x in xs], False, None)
    _close(card, cpu, 1e-6, name)
