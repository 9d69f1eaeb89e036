"""PyTorch port, the TensorFlow importer on a real HuggingFace BERT graph
(ROADMAP A10.2; JAX's ``tests/test_tf_import.py:542-590``):
``TFBertForMaskedLM`` at 2 layers, hidden 32, 2 heads, vocab 100,
frozen at ``[None, 16]`` with three int32 inputs (random weights, nothing
downloaded), once per module.

- The port's walker ends with JAX's avals: the same variables, each
  with the same shapes under both probes and the same dtype (64-bit
  narrowed to 32 on both sides, as both run).
- Logits against TF (rtol 2e-3 / atol 2e-4, JAX's tolerance for this
  graph) and against JAX's import (1e-5).
- Fine-tuning as JAX's test does it (float constants of rank >= 2
  promoted, per-token cross-entropy over the vocabulary, Adam 1e-2,
  ``MultiDataSet``): the first three losses equal JAX's from the same
  promoted weights to 1e-4 relative; save with the updater state, load,
  and one more step is bit-equal between the two.
"""

import functools

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
transformers = pytest.importorskip("transformers")

from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    TFGraphMapper, graphdef_wire,
)

SEQ, VOCAB, BATCH = 16, 100, 4


@functools.lru_cache(maxsize=None)
def _bert():
    """``(GraphDef, bytes, inputs, output, TF's logits, feeds)``."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    tf.keras.utils.set_random_seed(0)
    cfg = transformers.BertConfig(
        num_hidden_layers=2, hidden_size=32, num_attention_heads=2,
        intermediate_size=64, vocab_size=VOCAB, max_position_embeddings=32)
    m = transformers.TFBertForMaskedLM(cfg)

    @tf.function
    def f(ids, mask, tt):
        return m(input_ids=ids, attention_mask=mask, token_type_ids=tt,
                 training=False).logits

    spec = [tf.TensorSpec([None, SEQ], tf.int32)] * 3
    frozen = convert_variables_to_constants_v2(f.get_concrete_function(
        *spec))
    gd = frozen.graph.as_graph_def()
    ins = [t.name.split(":")[0] for t in frozen.inputs]
    out = frozen.outputs[0].name.split(":")[0]
    rng = np.random.default_rng(1)
    feeds = [rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32),
             np.ones((BATCH, SEQ), np.int32),
             np.zeros((BATCH, SEQ), np.int32)]
    ref = np.asarray(frozen(*[tf.constant(v) for v in feeds])[0])
    return gd, gd.SerializeToString(), ins, out, ref, feeds


def _narrow(dt) -> str:
    name = str(dt).replace("torch.", "")
    return {"int64": "int32", "float64": "float32"}.get(name, name)


def test_walker_avals_equal_jax():
    from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSD
    from deeplearning4j_tpu.modelimport.tensorflow import tf_import as jti

    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.modelimport.tensorflow import tf_import

    gd, data, *_ = _bert()
    jw = jti._Walker(JSD(), pe=jti._PartialEval())
    jw.walk(list(gd.node))
    pw = tf_import._Walker(SameDiff(device="cpu"),
                           pe=tf_import._PartialEval())
    pw.walk(list(graphdef_wire.parse_graph_def(data).node))
    assert len(gd.node) > 300
    assert set(pw.avals) == set(jw.avals), (
        sorted(set(jw.avals) - set(pw.avals))[:10],
        sorted(set(pw.avals) - set(jw.avals))[:10])
    for name, (j2, j3) in jw.avals.items():
        p2, p3 = pw.avals[name]
        assert (tuple(p2.shape), tuple(p3.shape)) == \
            (tuple(j2.shape), tuple(j3.shape)), name
        assert _narrow(p2.dtype) == _narrow(j2.dtype), name
    assert pw.partials.keys() == jw.partials.keys()
    for k, v in jw.partials.items():
        np.testing.assert_array_equal(pw.partials[k], v, err_msg=k)


def test_logits_match_tf_and_jax():
    from deeplearning4j_tpu.modelimport.tensorflow import (
        TFGraphMapper as JaxMapper,
    )

    gd, data, ins, out, ref, feeds = _bert()
    got = TFGraphMapper.importGraph(data, device="cpu").output(
        dict(zip(ins, feeds)), [out])[out].numpy()
    want = np.asarray(JaxMapper.importGraph(gd).output(
        dict(zip(ins, feeds)), [out])[out])
    assert got.shape == (BATCH, SEQ, VOCAB) and got.dtype == want.dtype
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _fine_tune_graph(sd, out, ins, float_kind):
    """JAX's test's training graph on an imported ``sd``: float constants
    of rank >= 2 promoted, per-token cross-entropy, Adam 1e-2."""
    for v in list(sd.variables()):
        if v.vtype.value == "CONSTANT" and v.name in sd._arrays and \
                float_kind(sd._arrays[v.name]):
            sd.convertConstantsToVariables(v.name)
    y = sd.placeholder("y_ids", shape=(None, SEQ))
    oh = sd.math.one_hot(y, depth=VOCAB)
    logp = sd.nn.log_softmax(sd.getVariable(out))
    loss = -(oh * logp).sum(-1).mean()
    sd.setLossVariables(loss.name)
    return sd


def test_fine_tune_matches_jax_and_resumes_bit_equal(tmp_path):
    from deeplearning4j_tpu.autodiff import TrainingConfig as JTC
    from deeplearning4j_tpu.datasets.multi_dataset import MultiDataSet as JMD
    from deeplearning4j_tpu.learning.updaters import Adam as JAdam
    from deeplearning4j_tpu.modelimport.tensorflow import (
        TFGraphMapper as JaxMapper,
    )

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.datasets.multi_dataset import MultiDataSet
    from deeplearning4j_tpu_torch.learning.updaters import Adam

    gd, data, ins, out, _, feeds = _bert()
    targets = np.random.default_rng(2).integers(0, VOCAB, (BATCH, SEQ)) \
        .astype(np.int32)

    jsd = _fine_tune_graph(JaxMapper.importGraph(gd), out, ins, lambda a: (
        np.asarray(a).ndim >= 2 and np.asarray(a).dtype.kind == "f"))
    jsd.setTrainingConfig(JTC(updater=JAdam(1e-2),
                              data_set_feature_mapping=list(ins),
                              data_set_label_mapping=["y_ids"]))
    psd = _fine_tune_graph(TFGraphMapper.importGraph(data, device="cpu"),
                           out, ins, lambda a: (a.dim() >= 2
                                                and a.is_floating_point()))
    psd.setTrainingConfig(TrainingConfig(
        updater=Adam(1e-2), data_set_feature_mapping=list(ins),
        data_set_label_mapping=["y_ids"]))
    assert sorted(psd.trainable_names()) == sorted(jsd.trainable_names())
    want = jsd.fit(JMD(feeds, [targets]), epochs=3).loss_curve
    got = psd.fit(MultiDataSet(feeds, [targets]), epochs=3).loss_curve
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]

    path = str(tmp_path / "bert.sdz")
    psd.save(path, save_updater_state=True)
    loaded = SameDiff.load(path, device="cpu")
    a = psd.fit(MultiDataSet(feeds, [targets])).loss_curve
    b = loaded.fit(MultiDataSet(feeds, [targets])).loss_curve
    assert a == b
