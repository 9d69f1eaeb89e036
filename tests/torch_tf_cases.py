"""The TensorFlow graphs of the port's importer tests
(``tests/test_torch_graphdef_wire.py``, ``test_torch_tf_import.py``):
each graph of the JAX package's TF batteries, frozen once per process,
with TF's outputs, and the runs of both importers on its bytes.

- ``tests/test_tf_mapper_battery.py``'s ``BATTERY`` (one graph per
  mapper), its functional If/Case/PartitionedCall and TensorArrayV3
  graphs: the ``mapper:``, ``functional:``, ``call:`` and
  ``tensorarray_v3`` names (:data:`BATTERY_NAMES`);
- ``tests/test_tf_import.py``'s golden ``BATTERY``, basic and regression
  graphs, the round-4 tail, ``CF_BATTERY`` in both frozen forms (TF1
  frames and functional ops), the NCHW stack, the Keras CNN and the v1
  dynamic RNN: the rest (:data:`IMPORT_NAMES`).

Graphs are traced without autograph (they use TF's ops for their control
flow; tracing is several times quicker). Importing this module imports
``tensorflow``: test files import it after ``pytest.importorskip``.
"""

import functools

import numpy as np
import pytest
import tensorflow as tf

import test_tf_import as ti  # the JAX package's graphs
import test_tf_mapper_battery as tb

from deeplearning4j_tpu_torch.modelimport.tensorflow import TFGraphMapper

tf1 = tf.compat.v1
_SPEC34 = tf.TensorSpec([3, 4], tf.float32)


def _as_list(r):
    return [np.asarray(x) for x in (r if isinstance(r, (list, tuple))
                                    else [r])]


def _frozen_fn(fn, feeds, lower=None, specs=None):
    """``(graph_def, inputs, outputs, TF's outputs)`` of ``fn`` frozen at
    the feeds' shapes, or at ``specs`` (``lower``: the control-flow
    form)."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    specs = specs or [tf.TensorSpec(v.shape, tf.as_dtype(v.dtype))
                      for v in feeds]
    # no autograph: the graphs use TF's ops for their control flow, and
    # tracing without it is several times quicker
    conc = tf.function(fn, autograph=False).get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(conc) if lower is None \
        else convert_variables_to_constants_v2(conc,
                                               lower_control_flow=lower)
    gd = frozen.graph.as_graph_def()
    ins = [t.name.split(":")[0] for t in frozen.inputs]
    outs = [t.name.split(":")[0] for t in frozen.outputs]
    ref = _as_list(frozen(*[tf.constant(v) for v in feeds]))
    return gd, ins, outs, ref


def _session_graph(build, out_names, feeds, v1_flow=False):
    """A v1 Session graph frozen by ``graph_util``: ``build(ph)`` returns
    the output tensors; ``v1_flow`` builds with control-flow v2 off (the
    TensorArrayV3 family exists only there)."""
    if v1_flow:
        tf1.disable_control_flow_v2()
    try:
        g = tf.Graph()
        with g.as_default():
            refs = build()
            with tf1.Session(graph=g) as sess:
                sess.run(tf1.global_variables_initializer())
                ref = sess.run(refs, {f"{k}:0": v for k, v in feeds.items()})
                frozen = tf1.graph_util.convert_variables_to_constants(
                    sess, g.as_graph_def(), out_names)
    finally:
        if v1_flow:
            tf1.enable_control_flow_v2()
    return frozen, list(feeds), list(out_names), list(feeds.values()), \
        _as_list(ref)


# ------------------------------------------------------------ extra graphs
def _basic_graphs():
    """The JAX package's basic, regression and round-4 tail graphs
    (``tests/test_tf_import.py``), ``name -> (fn, feeds, rtol, atol)``."""
    rng = np.random.default_rng

    w1 = rng(0).normal(size=(6, 8)).astype(np.float32)
    w2 = rng(1).normal(size=(8, 3)).astype(np.float32)
    k = rng(5).normal(size=(3, 3, 2, 4)).astype(np.float32) * 0.3
    ke = rng(20).normal(size=(3, 3, 2, 4)).astype(np.float32) * 0.3
    kd = rng(21).normal(size=(2, 2, 2, 1)).astype(np.float32) * 0.3
    table = rng(7).normal(size=(10, 4)).astype(np.float32)
    ar = rng(9)
    wq, wk, wv = (ar.normal(size=(8, 8)).astype(np.float32) * 0.3
                  for _ in range(3))
    wc = rng(9).normal(size=(3, 3, 1, 2)).astype(np.float32)

    def attention(x):
        d, h = 8, 2
        q, kk, v = (tf.transpose(tf.reshape(x @ w, [-1, 4, h, d // h]),
                                 [0, 2, 1, 3]) for w in (wq, wk, wv))
        att = tf.nn.softmax(tf.matmul(q, kk, transpose_b=True)
                            / np.sqrt(d // h))
        o = tf.reshape(tf.transpose(tf.matmul(att, v), [0, 2, 1, 3]),
                       [-1, 4, d])
        mu = tf.reduce_mean(o, axis=-1, keepdims=True)
        var = tf.reduce_mean(tf.math.squared_difference(o, mu), axis=-1,
                             keepdims=True)
        return (o - mu) * tf.math.rsqrt(var + 1e-6)

    def bincount(x):
        return (tf.raw_ops.DenseBincount(
            input=x, size=8, weights=tf.zeros([0], tf.int32),
            binary_output=False),
            tf.raw_ops.DenseBincount(
                input=x, size=8, weights=tf.zeros([0], tf.int32),
                binary_output=True))

    def mirror(x):
        r = tf.raw_ops.MirrorPad(input=x, paddings=[[1, 2], [2, 1]],
                                 mode="REFLECT")
        s = tf.raw_ops.MirrorPad(input=x, paddings=[[1, 1], [0, 2]],
                                 mode="SYMMETRIC")
        return r[:4, :4] + s[:4, :4]

    def roll_scatter(x):
        idx = tf.constant([[0], [2]])
        upd = tf.ones((2, 4), tf.float32)
        return (tf.roll(x, shift=[1, -2], axis=[0, 1])
                + tf.tensor_scatter_nd_update(x, idx, upd)
                + tf.tensor_scatter_nd_add(x, idx, upd))

    return {
        "mlp": (lambda x: tf.nn.softmax(tf.matmul(
            tf.nn.relu(tf.matmul(x, w1)), w2)),
            [rng(2).normal(size=(4, 6)).astype(np.float32)], 1e-4, 1e-5),
        "math_reductions_shapes": (lambda x: tf.sqrt(tf.reduce_sum(
            tf.square(tf.transpose(tf.reshape(x, [-1, 6]), [1, 0])
                      - tf.reduce_mean(tf.transpose(tf.reshape(
                          x, [-1, 6]), [1, 0]), axis=1, keepdims=True)),
            axis=[1]) + 1e-6),
            [rng(3).normal(size=(4, 3, 2)).astype(np.float32)], 1e-4, 1e-5),
        "concat_split_pad_slice": (lambda x: tf.strided_slice(tf.pad(
            tf.concat(tf.split(x, 2, axis=1)[::-1], axis=1),
            [[0, 0], [1, 1]]), [0, 1], [4, 7], [1, 1]),
            [rng(4).normal(size=(4, 6)).astype(np.float32)], 1e-4, 1e-5),
        "conv_pool": (lambda x: tf.nn.max_pool2d(tf.nn.relu(tf.nn.conv2d(
            x, k, strides=[1, 1, 1, 1], padding="SAME")), 2, 2, "VALID"),
            [rng(6).normal(size=(2, 8, 8, 2)).astype(np.float32)],
            1e-3, 1e-4),
        "explicit_padding_conv": (lambda x: (
            tf.nn.conv2d(x, ke, strides=[1, 1, 1, 1],
                         padding=[[0, 0], [1, 2], [0, 3], [0, 0]]),
            tf.nn.depthwise_conv2d(x, kd, strides=[1, 1, 1, 1],
                                   padding=[[0, 0], [2, 0], [1, 1],
                                            [0, 0]]),
            tf.nn.depthwise_conv2d(x, kd, strides=[1, 1, 1, 1],
                                   padding="SAME", dilations=[2, 2])),
            [rng(22).normal(size=(2, 6, 6, 2)).astype(np.float32)],
            1e-3, 1e-4),
        "bincount_binary_output": (
            bincount, [np.asarray([0, 2, 2, 5, 5, 5, 9], np.int32)],
            1e-4, 1e-5),
        "gather_onehot_argmax_cast": (lambda ids: tf.cast(tf.one_hot(
            tf.argmax(tf.gather(table, ids), axis=-1), 4), tf.float32)
            + tf.gather(table, ids),
            [rng(8).integers(0, 10, (3, 5)).astype(np.int32)], 1e-4, 1e-5),
        "attention_block": (attention, [ar.normal(size=(2, 4, 8)).astype(
            np.float32)], 1e-3, 1e-4),
        "strided_slice_last_element": (lambda x: x[-1] + x[:, -1][0], [
            rng(5).normal(size=(3, 4)).astype(np.float32)], 1e-4, 1e-5),
        "padv2_constant_values": (lambda x: tf.pad(
            x, [[1, 1], [0, 2]], constant_values=-3.5),
            [rng(6).normal(size=(2, 3)).astype(np.float32)], 1e-4, 1e-5),
        "one_hot_on_off_axis": (lambda x: tf.one_hot(tf.cast(tf.argmax(
            x, axis=-1), tf.int32), 5, on_value=2.0, off_value=-1.0)
            + tf.transpose(tf.one_hot(tf.cast(tf.argmax(x, axis=-1),
                                              tf.int32), 5, axis=0)),
            [rng(7).normal(size=(4, 5)).astype(np.float32)], 1e-4, 1e-5),
        "addn_single_input": (lambda x: tf.raw_ops.AddN(inputs=[x]), [
            rng(8).normal(size=(3, 2)).astype(np.float32)], 1e-4, 1e-5),
        "explicit_padding_conv_raw": (lambda x: tf.raw_ops.Conv2D(
            input=x, filter=tf.constant(wc), strides=[1, 1, 1, 1],
            padding="EXPLICIT", explicit_paddings=[0, 0, 1, 1, 1, 1, 0, 0]),
            [rng(10).normal(size=(1, 5, 5, 1)).astype(np.float32)],
            1e-4, 1e-5),
        "einsum": (lambda a, b: tf.einsum("ij,jk->ik", a, b)
                   + tf.einsum("ij->j", a)[None, :3],
                   [rng(20).normal(size=(2, 4)).astype(np.float32),
                    rng(25).normal(size=(4, 3)).astype(np.float32)],
                   1e-4, 1e-5),
        "mirror_pad_both_modes": (mirror, [rng(21).normal(
            size=(4, 4)).astype(np.float32)], 1e-4, 1e-5),
        "roll_and_tensor_scatter": (roll_scatter, [rng(22).normal(
            size=(3, 4)).astype(np.float32)], 1e-4, 1e-5),
        "prevent_gradient": (lambda x: tf.raw_ops.PreventGradient(
            input=x) * 2.0, [rng(23).normal(size=(2, 3)).astype(
                np.float32)], 1e-4, 1e-5),
        "reduce_all": (lambda x: tf.cast(tf.reduce_all(x > -1.0, axis=1),
                                         tf.float32),
                       [rng(26).normal(size=(3, 4)).astype(np.float32)],
                       1e-4, 1e-5),
        "sparse_softmax_cross_entropy": (
            lambda x: tf.nn.sparse_softmax_cross_entropy_with_logits(
                labels=tf.constant([0, 2], tf.int32), logits=x),
            [rng(24).normal(size=(2, 3)).astype(np.float32)], 1e-4, 1e-5),
    }


def _nchw_case():
    """The NCHW conv stack, its oracle the executed NHWC twin (TF's CPU
    kernels cannot run NCHW convolutions; freezing only traces)."""
    rng = np.random.default_rng(9)
    k = tf.constant(rng.normal(size=(3, 3, 2, 4)).astype(np.float32) * 0.3)
    kd = tf.constant(rng.normal(size=(3, 3, 4, 1)).astype(np.float32) * 0.3)
    bias, gamma, beta, mean = (tf.constant(rng.normal(size=(4,)).astype(
        np.float32)) for _ in range(4))
    var = tf.constant(rng.uniform(0.5, 2.0, (4,)).astype(np.float32))

    def stack(x, df):
        s = [1, 1, 2, 2] if df == "NCHW" else [1, 2, 2, 1]
        h = tf.nn.conv2d(x, k, strides=s, padding="SAME", data_format=df)
        h = tf.nn.bias_add(h, bias, data_format="NC.." if df == "NCHW"
                           else None)
        h = tf.raw_ops.FusedBatchNormV3(
            x=h, scale=gamma, offset=beta, mean=mean, variance=var,
            is_training=False, data_format=df)[0]
        h = tf.nn.max_pool2d(tf.nn.relu(h), 2, 2, "VALID", data_format=df)
        h = tf.nn.depthwise_conv2d(h, kd, strides=[1, 1, 1, 1],
                                   padding="SAME", data_format=df)
        return tf.nn.avg_pool2d(h, 2, 1, "VALID", data_format=df)

    x = rng.normal(size=(2, 2, 12, 12)).astype(np.float32)
    specs = tf.TensorSpec(x.shape, tf.float32)
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )
    frozen = convert_variables_to_constants_v2(tf.function(
        lambda t: stack(t, "NCHW")).get_concrete_function(specs))
    ref = np.transpose(np.asarray(stack(tf.constant(np.transpose(
        x, (0, 2, 3, 1))), "NHWC")), (0, 3, 1, 2))
    return (frozen.graph.as_graph_def(),
            [t.name.split(":")[0] for t in frozen.inputs],
            [t.name.split(":")[0] for t in frozen.outputs], [x], [ref])


def _keras_cnn_case():
    keras = tf.keras
    tf.keras.utils.set_random_seed(10)
    m = keras.Sequential([
        keras.layers.Input((8, 8, 1)),
        keras.layers.Conv2D(4, 3, padding="same", activation="relu"),
        keras.layers.BatchNormalization(),
        keras.layers.MaxPooling2D(2),
        keras.layers.Flatten(),
        keras.layers.Dense(3, activation="softmax"),
    ])
    x = np.random.default_rng(10).normal(size=(2, 8, 8, 1)).astype(
        np.float32)
    gd, ins, outs, ref = _frozen_fn(lambda t: m(t, training=False), [x])
    return gd, ins, outs, [x], ref


def _functional_cf(kind):
    """``tests/test_tf_mapper_battery.py``'s plain If / Case /
    StatelessCase graphs."""
    conc = lambda f: tf.function(  # noqa: E731
        f, autograph=False).get_concrete_function(_SPEC34)
    f34 = tb._F34
    if kind == "if":
        then_b, else_b = conc(lambda t: t * 2.0), conc(lambda t: t - 1.0)
        return lambda x: tf.raw_ops.If(
            cond=tf.reduce_sum(x) > 0.0, input=[x], Tout=[tf.float32],
            then_branch=then_b, else_branch=else_b)[0], [f34]
    if kind == "if_else":
        fn, _ = _functional_cf("if")
        return fn, [-np.abs(f34)]
    branches = [conc(lambda t: t * 2.0), conc(lambda t: t + 10.0),
                conc(lambda t: -t)]
    raw, n = (tf.raw_ops.Case, 3) if kind == "case" else \
        (tf.raw_ops.StatelessCase, 2)
    if kind == "stateless_case":
        branches = [conc(lambda t: t * 3.0), conc(lambda t: t + 5.0)]
    return lambda x: raw(branch_index=tf.cast(tf.math.floormod(tf.cast(
        tf.reduce_sum(x) * 100.0, tf.int32), n), tf.int32), input=[x],
        Tout=[tf.float32], branches=branches)[0], [f34]


def _partitioned_call(raw_name):
    body = tf.function(lambda t: tf.nn.relu(t) + 0.5,
                       autograph=False).get_concrete_function(_SPEC34)
    raw = getattr(tf.raw_ops, raw_name)

    def build():
        ph = tf1.placeholder(tf.float32, (3, 4), name="x")
        body.add_to_graph(tf1.get_default_graph())
        return [tf.identity(raw(args=[ph], Tout=[tf.float32], f=body)[0],
                            name="out")]

    return _session_graph(build, ["out"], {"x": tb._F34})


def _ta_v3():
    x = np.random.default_rng(11).normal(size=(4, 2, 3)).astype(np.float32)

    def build():
        ph = tf1.placeholder(tf.float32, (4, 2, 3), name="x")
        in_ta = tf.TensorArray(tf.float32, size=4,
                               element_shape=(2, 3)).unstack(ph)
        out_ta = tf.TensorArray(tf.float32, size=4, element_shape=(2, 3))

        def body(t, acc, ta):
            acc2 = acc + in_ta.read(t)
            return t + 1, acc2, ta.write(t, acc2)

        _, acc, out_ta = tf1.while_loop(lambda t, acc, ta: t < 4, body,
                                        [0, tf.zeros((2, 3)), out_ta])
        out = tf.identity(tf.transpose(out_ta.stack(), [1, 0, 2]),
                          name="cumsum")
        size = tf.identity(tf.cast(tf.raw_ops.TensorArraySizeV3(
            handle=out_ta.handle, flow_in=out_ta.flow), tf.float32),
            name="ta_size")
        return [out, size]

    return _session_graph(build, ["cumsum", "ta_size"], {"x": x},
                          v1_flow=True)


def _gru_graph(outputs):
    """``tests/test_tf_import.py``'s v1 Session GRU: a time-major
    recurrence through TensorArray read/write in a while frame."""
    x = np.random.default_rng(0).normal(size=(2, 6, 5)).astype(np.float32)

    def build():
        ph = tf1.placeholder(tf.float32, (2, 6, 5), name="x")
        wz = tf1.get_variable("Wz", (12, 7), initializer=tf1.initializers
                              .glorot_uniform(seed=1))
        wh = tf1.get_variable("Wh", (12, 7), initializer=tf1.initializers
                              .glorot_uniform(seed=2))
        in_ta = tf.TensorArray(tf.float32, size=6, element_shape=(2, 5)) \
            .unstack(tf.transpose(ph, [1, 0, 2]))
        out_ta = tf.TensorArray(tf.float32, size=6, element_shape=(2, 7))

        def body(t, h, ta):
            cat = tf.concat([in_ta.read(t), h], 1)
            z = tf.sigmoid(tf.matmul(cat, wz))
            h2 = (1.0 - z) * h + z * tf.tanh(tf.matmul(cat, wh))
            return t + 1, h2, ta.write(t, h2)

        _, h_t, out_ta = tf1.while_loop(lambda t, h, ta: t < 6, body,
                                        [0, tf.zeros((2, 7)), out_ta])
        return [tf.identity(tf.transpose(out_ta.stack(), [1, 0, 2]),
                            name="rnn_out"),
                tf.identity(h_t, name="h_final")][:len(outputs)]

    return _session_graph(build, outputs, {"x": x})


#: name -> (maker of (graph_def, inputs, outputs, feeds, TF's
#: outputs), rtol, atol) against TF
GRAPHS = {}


def _fn_case(fn, feeds, lower=None):
    def build():
        gd, ins, outs, ref = _frozen_fn(fn, feeds, lower)
        return gd, ins, outs, feeds, ref
    return build


for _n, (_fn, _feeds) in tb.BATTERY.items():
    GRAPHS[f"mapper:{_n}"] = (_fn_case(_fn, _feeds), 1e-4, 1e-5)
for _n, (_fn, _feeds) in ti.BATTERY.items():
    GRAPHS[f"golden:{_n}"] = (_fn_case(_fn, _feeds), 2e-4, 2e-5)
for _n, (_fn, _feeds, _rt, _at) in _basic_graphs().items():
    GRAPHS[f"basic:{_n}"] = (_fn_case(_fn, _feeds), _rt, _at)
for _n, (_fn, _feeds) in ti.CF_BATTERY.items():
    for _low, _tag in ((True, "v1_frames"), (False, "functional")):
        GRAPHS[f"cf:{_n}:{_tag}"] = (_fn_case(_fn, _feeds, _low), 1e-4,
                                       1e-5)
for _k in ("if", "if_else", "case", "stateless_case"):
    GRAPHS[f"functional:{_k}"] = (_fn_case(*_functional_cf(_k)), 1e-4,
                                    1e-5)
GRAPHS["nchw_conv_stack"] = (_nchw_case, 1e-3, 1e-4)


def _shape_reshape_case():
    """A reshape whose target folds from ``Shape`` of a dynamic batch
    (Shape -> StridedSlice -> Pack -> Reshape)."""
    x = np.random.default_rng(27).normal(size=(4, 6)).astype(np.float32)
    gd, ins, outs, ref = _frozen_fn(
        lambda t: tf.reshape(t, tf.stack([tf.shape(t)[0], 3, -1])) + 1.0,
        [x], specs=[tf.TensorSpec([None, 6], tf.float32)])
    return gd, ins, outs, [x], ref


GRAPHS["shape_folded_reshape"] = (_shape_reshape_case, 1e-4, 1e-5)
GRAPHS["keras_cnn"] = (_keras_cnn_case, 1e-3, 1e-4)
for _raw in ("PartitionedCall", "StatefulPartitionedCall"):
    GRAPHS[f"call:{_raw}"] = (lambda _raw=_raw: _partitioned_call(_raw),
                                1e-5, 1e-6)
GRAPHS["tensorarray_v3"] = (_ta_v3, 1e-5, 1e-6)
GRAPHS["v1_dynamic_rnn"] = (lambda: _gru_graph(["rnn_out", "h_final"]),
                              1e-4, 1e-5)
NAMES = sorted(GRAPHS)
BATTERY_NAMES = [n for n in NAMES if n.split(":")[0] in (
    "mapper", "functional", "call", "tensorarray_v3")]
IMPORT_NAMES = [n for n in NAMES if n not in BATTERY_NAMES]


@functools.lru_cache(maxsize=None)
def case(name):
    """The frozen graph of ``name``: ``(GraphDef bytes, TF GraphDef,
    inputs, outputs, feeds, TF's outputs)``."""
    build, _, _ = GRAPHS[name]
    gd, ins, outs, feeds, ref = build()
    return gd.SerializeToString(), gd, ins, outs, feeds, ref


@functools.lru_cache(maxsize=None)
def port(name):
    """The port's import of ``name`` on the CPU and its outputs."""
    data, _, ins, outs, feeds, _ = case(name)
    sd = TFGraphMapper.importGraph(data, device="cpu")
    got = sd.output(dict(zip(ins, feeds)), outs)
    return sd, [got[o] for o in outs]


def jax_outputs(name):
    """JAX's import of ``name`` and its outputs (numpy)."""
    from deeplearning4j_tpu.modelimport.tensorflow import TFGraphMapper as \
        JaxMapper

    _, gd, ins, outs, feeds, _ = case(name)
    jsd = JaxMapper.importGraph(gd)
    got = jsd.output(dict(zip(ins, feeds)), outs)
    return [np.asarray(got[o]) for o in outs]


def check(name):
    """The port's outputs of ``name`` against TF's at the case's
    tolerance and against JAX's at rtol 1e-5 / atol 1e-6 (the case's own
    where it is looser than 1e-4); dtypes and shapes equal JAX's. A
    mapper battery graph must hold its op (the battery's premise)."""
    _, rtol, atol = GRAPHS[name]
    _, gd, *_, ref = case(name)
    if name.startswith("mapper:"):
        ops = {n.op for n in gd.node} | {
            n.op for f in gd.library.function for n in f.node_def}
        assert name.split(":")[1] in ops, sorted(ops)
    _, got = port(name)
    want = jax_outputs(name)
    assert len(got) == len(ref) == len(want)
    jr, ja = (1e-5, 1e-6) if rtol <= 1e-4 else (rtol, atol)
    for g, r, w in zip(got, ref, want):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_allclose(g, r.astype(g.dtype), rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(g, w, rtol=jr, atol=ja)
