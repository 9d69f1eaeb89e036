"""The committed BERT-base frozen-graph fixture of the TensorFlow importer,
and how to make it again.

``bert_base_mlm_s128.graphdef.gz`` (beside the importer) is HuggingFace's
``TFBertForMaskedLM(BertConfig())`` (12 layers, width 768, 12 heads,
vocabulary 30,522) frozen at ``[None, 128]`` with three int32 inputs
(ids, attention mask, token types), as the JAX package's
``tests/test_tf_import.py:503-521`` freezes it, with every float
``Const`` over 4 KB emptied: 3,053 nodes in ~45 KB gzipped, where the
whole graph is ~439 MB. ``graphdef_wire.seeded_consts(graph, SEED)``
fills the emptied constants with seeded normals (x 0.02, HF's
``initializer_range``) and gives the whole graph back.

``bert_base_mlm_s128.golden.npz`` holds TF's own run of that whole graph
on a fixed batch of 2 x 128: the inputs, ``logits[:, :4, :8]`` and each
row's sum over the vocabulary, with the names of the inputs and the
output.

Regenerate both (on a machine with ``tensorflow`` and ``transformers``;
nothing is downloaded: the model is built from its config)::

    python -m deeplearning4j_tpu_torch.tools.make_tf_fixture

This is the one module of the port that imports ``tensorflow`` and
``transformers``, inside :func:`main`; the rest of it only reads the
files (:func:`load_fixture`).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

HERE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "modelimport", "tensorflow")
FIXTURE = os.path.join(HERE, "bert_base_mlm_s128.graphdef.gz")
GOLDEN = os.path.join(HERE, "bert_base_mlm_s128.golden.npz")
#: the seed of the fixture's weights
SEED = 22
SEQ = 128
#: float constants above this many bytes are emptied
EMPTY_ABOVE = 4096


def load_fixture() -> tuple:
    """``(the emptied GraphDef's bytes, the golden arrays by name)``."""
    with gzip.open(FIXTURE, "rb") as f:
        small = f.read()
    with np.load(GOLDEN, allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    return small, golden


def main() -> int:
    import tensorflow as tf
    import transformers
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    from deeplearning4j_tpu_torch.modelimport.tensorflow import graphdef_wire

    cfg = transformers.BertConfig()
    model = transformers.TFBertForMaskedLM(cfg)

    @tf.function
    def f(ids, mask, tt):
        return model(input_ids=ids, attention_mask=mask, token_type_ids=tt,
                     training=False).logits

    spec = [tf.TensorSpec([None, SEQ], tf.int32)] * 3
    frozen = convert_variables_to_constants_v2(f.get_concrete_function(
        *spec))
    gd = frozen.graph.as_graph_def()
    ins = [t.name.split(":")[0] for t in frozen.inputs]
    out = frozen.outputs[0].name.split(":")[0]
    floats = {tf.float32.as_datatype_enum, tf.float16.as_datatype_enum,
              tf.bfloat16.as_datatype_enum, tf.float64.as_datatype_enum}
    emptied = 0
    for node in gd.node:
        if node.op != "Const":
            continue
        t = node.attr["value"].tensor
        n = int(np.prod([d.size for d in t.tensor_shape.dim]))
        if t.dtype not in floats:
            continue
        nbytes = n * tf.dtypes.as_dtype(t.dtype).size
        if nbytes <= EMPTY_ABOVE:
            # a small float constant keeps its values, so it must not
            # look emptied to seeded_consts
            assert len(t.tensor_content) or t.float_val or t.half_val or \
                t.double_val or n == 0, node.name
            continue
        t.ClearField("tensor_content")
        t.ClearField("float_val")
        t.ClearField("half_val")
        t.ClearField("double_val")
        emptied += 1
    small = gd.SerializeToString(deterministic=True)
    with open(FIXTURE, "wb") as fh:
        with gzip.GzipFile(fileobj=fh, mode="wb", mtime=0) as z:
            z.write(small)

    full = graphdef_wire.seeded_consts(small, SEED)
    whole = tf.compat.v1.GraphDef()
    whole.ParseFromString(full)
    g = tf.Graph()
    with g.as_default():
        tf.graph_util.import_graph_def(whole, name="")
    # the golden batch: ids from default_rng(0), an all-ones mask, zero
    # token types
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, SEQ))
    feeds = [ids.astype(np.int32), np.ones((2, SEQ), np.int32),
             np.zeros((2, SEQ), np.int32)]
    with tf.compat.v1.Session(graph=g) as sess:
        logits = sess.run(f"{out}:0", {f"{n}:0": v
                                       for n, v in zip(ins, feeds)})
    np.savez(GOLDEN, ids=feeds[0], mask=feeds[1], type_ids=feeds[2],
             logits_head=logits[:, :4, :8].astype(np.float32),
             row_sums=logits.sum(-1, dtype=np.float64).astype(np.float32),
             inputs=np.asarray(ins), output=np.asarray(out),
             seed=np.asarray(SEED), nodes=np.asarray(len(gd.node)),
             whole_bytes=np.asarray(len(full), np.int64))
    print(f"{len(gd.node)} nodes, {emptied} constants emptied; "
          f"{len(small)} B ({os.path.getsize(FIXTURE)} B gzipped), "
          f"{len(full)} B whole; inputs {ins}, output {out}; "
          f"logits {logits.shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
