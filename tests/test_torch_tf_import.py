"""PyTorch port, the TensorFlow importer (ROADMAP A10.2), on the JAX
package's import graphs (``tests/test_tf_import.py``): the golden battery,
the basic and regression graphs, the round-4 tail, ``CF_BATTERY`` in both
frozen forms (TF1 frames and functional ops), the NCHW stack, the Keras
CNN and the v1 dynamic RNN (``tests/torch_tf_cases.py``) go, as the same
GraphDef bytes, through JAX's ``TFGraphMapper`` and the port's on the CPU.

- Each output of the port within the battery's tolerance of TF's (rtol
  1e-4 / atol 1e-5; 2e-4 / 2e-5 for the golden battery; 1e-3 / 1e-4 for
  convolutions, attention and the Keras net, as there), and within
  rtol 1e-5 / atol 1e-6 of JAX's (the case's own where TF's is looser);
  dtypes equal JAX's.
- The dynamic RNN trains through its imported TF1 frame: the trip count
  is stamped statically, as JAX stamps it, and the gradients equal
  JAX's through its own import (1e-5).
- A loop bound from a dynamic dim stamps no trip count; an unknown op, a
  broken frame, an op missing from the output table and an import
  without a card raise; an imported, trained graph saves, loads and
  resumes bit-equal.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import test_tf_import as ti  # noqa: E402  (the JAX package's graphs)
import torch_tf_cases as tc  # noqa: E402

from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    TFGraphMapper,
)
from deeplearning4j_tpu_torch.modelimport.tensorflow.tf_import import (  # noqa: E402,E501
    TFImportError,
)


@pytest.mark.parametrize("name", tc.IMPORT_NAMES)
def test_import_matches_tf_and_jax(name):
    tc.check(name)


def test_frame_forms_hold_their_ops():
    """The lowered freeze really emits TF1 frames, the functional one
    keeps While and its library."""
    ops = {n.op for n in tc.case("cf:while_counter:v1_frames")[1].node}
    assert {"Enter", "Exit", "Merge", "Switch", "NextIteration",
            "LoopCond"} <= ops
    gd = tc.case("cf:while_counter:functional")[1]
    assert any(n.op in ("While", "StatelessWhile") for n in gd.node)
    assert len(gd.library.function) >= 2


def test_imported_dynamic_rnn_trains_as_jax():
    """Gradients flow through the imported TF1 frame: the loop carries
    JAX's static trip count (6), the gradients of sum(y^2) with respect
    to the promoted weights equal JAX's through its own import (1e-5),
    and a fit descends."""
    from deeplearning4j_tpu.modelimport.tensorflow import (
        TFGraphMapper as JaxMapper,
    )

    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Sgd

    gd, ins, outs, (x,), ref = tc._gru_graph(["rnn_out"])
    grads = {}
    for side, mapper in (("port", TFGraphMapper), ("jax", JaxMapper)):
        sd = mapper.importGraph(gd.SerializeToString(), device="cpu") \
            if side == "port" else mapper.importGraph(gd)
        node = next(n for n in sd._ops if n.op_name == "while_loop")
        assert node.attrs["max_trip_count"] == 6
        sd.convertConstantsToVariables("Wz", "Wh")
        y = sd.getVariable("rnn_out")
        loss = sd._op("reduce_sum", [sd._op("mul", [y.name, y.name]).name])
        sd.setLossVariables(loss.name)
        g = sd.calculateGradients({"x": x}, ["Wz", "Wh"])
        grads[side] = {k: np.asarray(v) for k, v in g.items()}
        if side == "port":
            port_sd = sd
    for k in ("Wz", "Wh"):
        np.testing.assert_allclose(grads["port"][k], grads["jax"][k],
                                   rtol=1e-5, atol=1e-6)
    port_sd.setTrainingConfig(TrainingConfig(
        updater=Sgd(1e-3), data_set_feature_mapping=["x"], minimize=True))
    hist = port_sd.fit(DataSet(x, None), epochs=3)
    assert hist.loss_curve[-1] < hist.loss_curve[0]


def test_dynamic_shape_bound_stamps_no_trip_count():
    """A loop bound from a dynamic placeholder dim is no constant: no
    max_trip_count, and the graph answers TF's result at two batch
    sizes."""
    def fn(a):
        n = tf.shape(a)[0]
        return tf.while_loop(
            lambda i, acc: i < n,
            lambda i, acc: (i + 1, acc + tf.reduce_sum(a) * 0.1),
            [tf.constant(0), tf.constant(0.0)])[1]

    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    conc = tf.function(fn).get_concrete_function(
        tf.TensorSpec([None, 3], tf.float32))
    frozen = convert_variables_to_constants_v2(conc, lower_control_flow=True)
    gd = frozen.graph.as_graph_def()
    in_name = frozen.inputs[0].name.split(":")[0]
    out_name = frozen.outputs[0].name.split(":")[0]
    sd = TFGraphMapper.importGraph(gd.SerializeToString(), device="cpu")
    node = next(n for n in sd._ops if n.op_name == "while_loop")
    assert node.attrs["max_trip_count"] is None
    for b in (2, 5):
        x = np.ones((b, 3), np.float32)
        got = float(sd.output({in_name: x}, [out_name])[out_name])
        ref = tc._as_list(frozen(tf.constant(x)))[0]
        np.testing.assert_allclose(got, float(ref), rtol=1e-5)


def test_unknown_op_and_broken_frame_raise():
    """An op with no mapper raises TFImportError (JAX's "no mapper"), as
    does a lone Enter without frame structure; a function body op
    missing from the output-argument table raises too."""
    gd, *_ = ti._freeze(lambda x: tf.raw_ops.MatrixSquareRoot(input=x),
                        tf.TensorSpec([3, 3], tf.float32))
    with pytest.raises(TFImportError, match="no mapper"):
        TFGraphMapper.importGraph(gd.SerializeToString(), device="cpu")
    from tensorflow.core.framework import graph_pb2

    bad = graph_pb2.GraphDef()
    n = bad.node.add()
    n.name, n.op = "x", "Placeholder"
    n.attr["dtype"].type = 1
    e = bad.node.add()
    e.name, e.op = "enter", "Enter"
    e.input.append("x")
    e.attr["frame_name"].s = b"broken_frame"
    with pytest.raises(TFImportError):
        TFGraphMapper.importGraph(bad.SerializeToString(), device="cpu")
    from deeplearning4j_tpu_torch.modelimport.tensorflow import (
        graphdef_wire as gw,
    )
    with pytest.raises(TFImportError, match="no OpDef"):
        gw.output_arg_offset(gw.NodeDef("n", "MatrixSquareRoot"), "output")


def test_an_import_without_a_card_raises():
    """No quiet CPU fallback: without ``device`` the import goes to the
    card, and raises where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFGraphMapper.importGraph(tc.case("mapper:Add")[0])


def test_imported_graph_saves_loads_and_resumes(tmp_path):
    """An imported graph, promoted and trained with Adam, saves with its
    updater state; the loaded graph gives the same outputs and resumes
    with bit-equal losses."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Adam

    w = np.random.default_rng(3).normal(size=(6, 4)).astype(np.float32) * .4
    x = np.random.default_rng(4).normal(size=(5, 6)).astype(np.float32)
    gd, ins, outs, _ = ti._freeze(lambda t: tf.nn.log_softmax(
        tf.matmul(t, w)), tf.TensorSpec([None, 6], tf.float32))
    sd = TFGraphMapper.importGraph(gd.SerializeToString(), device="cpu")
    sd.convertConstantsToVariables(*[
        v.name for v in sd.variables() if v.vtype.value == "CONSTANT"
        and sd._arrays[v.name].dim() == 2])
    y = sd.placeholder("y", shape=(None,))
    oh = sd.math.one_hot(y, depth=4)
    loss = -(oh * sd.getVariable(outs[0])).sum(-1).mean()
    sd.setLossVariables(loss.name)
    sd.setTrainingConfig(TrainingConfig(
        updater=Adam(5e-2), data_set_feature_mapping=[ins[0]],
        data_set_label_mapping=["y"]))
    labels = np.random.default_rng(5).integers(0, 4, 5).astype(np.int32)
    sd.fit(DataSet(x, labels), epochs=3)
    p = str(tmp_path / "imported.sdz")
    sd.save(p, save_updater_state=True)
    sd2 = SameDiff.load(p, device="cpu")
    o1 = sd.output({ins[0]: x}, [outs[0]])[outs[0]]
    o2 = sd2.output({ins[0]: x}, [outs[0]])[outs[0]]
    assert bool((o1 == o2).all())
    h1 = sd.fit(DataSet(x, labels), epochs=2).loss_curve
    h2 = sd2.fit(DataSet(x, labels), epochs=2).loss_curve
    assert h1 == h2
