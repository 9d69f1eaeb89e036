"""PyTorch port, the seq2seq encoder-decoder LSTM (``models/seq2seq.py``,
``Seq2SeqLSTM``) through ``ComputationGraph``: its configuration JSON, and
training from a JAX zip against the JAX graph's own steps, unmasked and
masked (a features mask on the encoder input, the same mask wired into
``LastTimeStepVertex``, a labels mask on the output), on the reversal
task of ``tests/test_seq2seq.py``; then the port's zip read back by the
JAX package, and the reversal task learned by the port alone.

Tolerances: the configuration JSON letter for letter; losses step by step
within 1e-5 relative; parameters and updater state after three Adam steps
within rtol 1e-5 / atol 1e-6 (sums over batch and time in another order);
outputs within 1e-6 of max(1, max |out|).

The cuda-marked test at the end holds the card against the CPU and
imports no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_seq2seq.py``.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (ArrayMultiDataSetIterator,
                                               MultiDataSet)
from deeplearning4j_tpu_torch.models import Seq2SeqLSTM
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

LOSS_RTOL, RTOL, ATOL, OUT_TOL = 1e-5, 1e-5, 1e-6, 1e-6
K, T = 8, 6


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, want, tol, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _trees(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _trees(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _trees(g, w, f"{what}/{i}")
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


def _host(tree):
    import jax

    return jax.device_get(tree)


def reversal(n=32, t=T, k=K, seed=0):
    """tests/test_seq2seq.py's task: one-hot sources, the reversed target,
    the decoder input shifted right behind a zero step."""
    rs = np.random.RandomState(seed)
    src = rs.randint(0, k, (n, t))
    eye = np.eye(k, dtype=np.float32)
    enc, out = eye[src], eye[src[:, ::-1]]
    dec = np.zeros_like(out)
    dec[:, 1:] = out[:, :-1]
    return enc, dec, out


def lengths_mask(n, t, lo=2, seed=1):
    lens = np.random.RandomState(seed).randint(lo, t + 1, n)
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def masked_conf(pkg: str, hidden=16, updater=None):
    """The seq2seq graph with a third input ``encoderMask`` wired into
    ``LastTimeStepVertex``, built by the JAX package (``pkg`` "jax") or
    the port with the same builder calls."""
    if pkg == "jax":
        from deeplearning4j_tpu.learning import Adam as A
        from deeplearning4j_tpu.nn.conf import LSTM, InputType, RnnOutputLayer
        from deeplearning4j_tpu.nn.graph import (
            ComputationGraphConfiguration as C, DuplicateToTimeSeriesVertex,
            LastTimeStepVertex, MergeVertex)
    else:
        from deeplearning4j_tpu_torch.learning import Adam as A
        from deeplearning4j_tpu_torch.nn.conf import (LSTM, InputType,
                                                      RnnOutputLayer)
        from deeplearning4j_tpu_torch.nn.graph import (
            ComputationGraphConfiguration as C, DuplicateToTimeSeriesVertex,
            LastTimeStepVertex, MergeVertex)
    b = (C.graphBuilder().seed(42).updater(updater or A(5e-3))
         .addInputs("encoderInput", "decoderInput", "encoderMask")
         .setInputTypes(InputType.recurrent(K, T), InputType.recurrent(K, T),
                        InputType.feedForward(T)))
    b.addLayer("encoder", LSTM(n_out=hidden, activation="tanh"),
               "encoderInput")
    b.addVertex("thought", LastTimeStepVertex(), "encoder", "encoderMask")
    b.addVertex("dup", DuplicateToTimeSeriesVertex(), "thought",
                "decoderInput")
    b.addVertex("decoderIn", MergeVertex(), "decoderInput", "dup")
    b.addLayer("decoder", LSTM(n_out=hidden, activation="tanh"),
               "decoderIn")
    b.addLayer("output", RnnOutputLayer(n_out=K, activation="softmax",
                                        loss="mcxent"), "decoder")
    return b.setOutputs("output").build()


def _from_jax_zip(jg, tmp_path, name="s2s.zip"):
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer

    path = os.path.join(tmp_path, name)
    JaxSerializer.writeModel(jg, path, save_updater=True)
    return ModelSerializer.restoreComputationGraph(path, device="cpu")


def _same_state(g, jg):
    _trees(g.params_map, _host(jg.params_map), "params")
    _trees(g.opt_states, _host(jg.opt_states), "updater")


# --------------------------------------------------------- configuration
@pytest.mark.parametrize("kw", [
    dict(in_features=16, out_features=16),
    dict(in_features=5, out_features=7, hidden=16, t_in=4, t_out=4),
    dict(in_features=8, out_features=8, hidden=64, t_in=6, t_out=9,
         seed=3)], ids=["defaults", "small", "t_out-9"])
def test_conf_json_equals_jax(kw):
    from deeplearning4j_tpu.models.seq2seq import Seq2SeqLSTM as JS2S

    js = JS2S(**kw).conf().to_json()
    assert Seq2SeqLSTM(**kw).conf().to_json() == js
    back = ComputationGraphConfiguration.from_json(js)
    assert back.to_json() == js
    assert [n.name for n in back.nodes] == ["encoder", "thought", "dup",
                                            "decoderIn", "decoder", "output"]


def test_masked_conf_json_equals_jax():
    assert masked_conf("port").to_json() == masked_conf("jax").to_json()


def test_seq2seq_is_exported_with_its_defaults():
    import deeplearning4j_tpu_torch.models as models

    m = models.Seq2SeqLSTM(16, 16)
    assert (m.hidden, m.t_in, m.t_out, m.seed) == (128, 12, 12, 42)
    assert m.updater.learning_rate == 5e-3
    assert models.__all__ == ["Seq2SeqLSTM"]
    with pytest.raises(AttributeError):
        models.NotAModel


def test_shapes_and_size_match_jax_at_default_widths():
    from deeplearning4j_tpu.models.seq2seq import Seq2SeqLSTM as JS2S

    jg = JS2S(16, 16).init()
    g = Seq2SeqLSTM(16, 16).init(device="cpu")
    want = {n: {k: tuple(v.shape) for k, v in p.items()}
            for n, p in _host(jg.params_map).items()}
    assert {n: {k: tuple(v.shape) for k, v in p.items()}
            for n, p in g.params_map.items()} == want
    assert g.numParams() == jg.numParams() == 216_080


# ---------------------------------------------------------------- training
def test_unmasked_trajectory_from_a_jax_zip(tmp_path):
    """A JAX graph after one step, through the JAX zip; three more steps
    on both follow the JAX losses, parameters and Adam state; then
    ``output`` and ``outputSingle``."""
    from deeplearning4j_tpu.models.seq2seq import Seq2SeqLSTM as JS2S

    enc, dec, out = reversal(seed=2)
    jg = JS2S(K, K, hidden=16, t_in=T, t_out=T).init()
    jg.fit([enc, dec], [out])
    g = _from_jax_zip(jg, tmp_path)
    assert g.getIterationCount() == 1
    _same_state(g, jg)
    enc, dec, out = reversal(seed=3)
    for _ in range(3):
        jg.fit([enc, dec], [out])
        g.fit([enc, dec], [out])
        lj, lt = float(jg.score()), g.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    _same_state(g, jg)
    want = np.asarray(jg.output(enc, dec)[0].jax)
    _close(g.output(enc, dec)[0], want, OUT_TOL, "output")
    _close(g.outputSingle(enc, dec), want, OUT_TOL, "outputSingle")


def test_masked_trajectory_from_a_jax_zip(tmp_path):
    """The masked graph: a features mask on the encoder input (its padded
    steps zeroed), the mask as ``LastTimeStepVertex``'s second input, a
    labels mask on the output, through ``fit(MultiDataSet)``; then
    ``output(..., feature_masks=)``."""
    from deeplearning4j_tpu.datasets.multi_dataset import (
        MultiDataSet as JMulti)
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG

    enc, dec, out = reversal(seed=4)
    mask = lengths_mask(len(enc), T, seed=5)
    jg = JCG(masked_conf("jax")).init()
    g = _from_jax_zip(jg, tmp_path)
    assert g.conf.to_json() == jg.conf.to_json()
    for step in range(3):
        xs, fms = [enc, dec, mask], [mask, None, None]
        jg.fit(JMulti(xs, [out], features_mask_arrays=fms,
                      labels_mask_arrays=[mask]))
        g.fit(MultiDataSet(xs, [out], features_mask_arrays=fms,
                           labels_mask_arrays=[mask]))
        lj, lt = float(jg.score()), g.score()
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (step, lt, lj)
    _same_state(g, jg)
    want = np.asarray(jg.output(enc, dec, mask,
                                feature_masks=[mask, None, None])[0].jax)
    got = g.output(enc, dec, mask, feature_masks=[mask, None, None])[0]
    _close(got, want, OUT_TOL, "masked output")
    # the mask changes the result: without it the padded steps count
    plain = g.output(enc, dec, np.ones_like(mask))[0]
    assert float((plain - got).abs().max()) > 1e-3


def test_fit_over_a_multi_dataset_iterator_matches_jax(tmp_path):
    """``fit(MultiDataSetIterator)`` over the encoder and decoder feeds
    for two epochs follows the JAX graph over the same batches."""
    from deeplearning4j_tpu.datasets.multi_dataset import (
        ArrayMultiDataSetIterator as JIter)
    from deeplearning4j_tpu.models.seq2seq import Seq2SeqLSTM as JS2S

    enc, dec, out = reversal(n=24, seed=6)
    jg = JS2S(K, K, hidden=16, t_in=T, t_out=T).init()
    g = _from_jax_zip(jg, tmp_path)
    jg.fit(JIter([enc, dec], [out], batch_size=8), epochs=2)
    g.fit(ArrayMultiDataSetIterator([enc, dec], [out], batch_size=8),
          epochs=2)
    assert g.getIterationCount() == jg.getIterationCount() == 6
    assert g.getEpochCount() == jg.getEpochCount() == 2
    _same_state(g, jg)


def test_the_ports_zip_reads_back_in_jax(tmp_path):
    """Trained by the port, written by the port: the JAX package restores
    the graph (configuration, parameters, Adam state, counters) and its
    output equals the port's."""
    from deeplearning4j_tpu.util import ModelSerializer as JaxSerializer

    enc, dec, out = reversal(seed=7)
    g = Seq2SeqLSTM(K, K, hidden=16, t_in=T, t_out=T).init(device="cpu")
    for _ in range(2):
        g.fit([enc, dec], [out])
    path = os.path.join(tmp_path, "port.zip")
    ModelSerializer.writeModel(g, path, save_updater=True)
    jg = JaxSerializer.restoreComputationGraph(path, load_updater=True)
    assert jg.getIterationCount() == 2
    _trees(g.params_map, _host(jg.params_map), "params")
    _trees(g.opt_states, _host(jg.opt_states), "updater")
    _close(g.output(enc, dec)[0], np.asarray(jg.output(enc, dec)[0].jax),
           OUT_TOL, "output")


def test_learns_the_reversal_task():
    """``tests/test_seq2seq.py::test_learns_reversal`` on the port at
    hidden 64: 60 fits halve the loss and reach 0.6 accuracy."""
    enc, dec, out = reversal(n=64)
    net = Seq2SeqLSTM(K, K, hidden=64, t_in=T, t_out=T).init(device="cpu")
    first = None
    for i in range(60):
        net.fit([enc, dec], [out])
        if i == 0:
            first = net.score()
    last = net.score()
    assert last < first * 0.5, (first, last)
    pred = net.output(enc, dec)[0].numpy()
    acc = (pred.argmax(-1) == out.argmax(-1)).mean()
    assert acc > 0.6, acc


def test_entry_point_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Seq2SeqLSTM(4, 4, hidden=8).init()


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_seq2seq_on_the_card_matches_the_cpu():
    """Three steps of the masked and unmasked graphs at f32 (TF32 off) on
    the card (B5 on both LSTMs, forward and backward) and on the CPU from
    the same weights: losses 1e-5 relative, parameters 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr
    from deeplearning4j_tpu_torch.params import tree_leaves

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        enc, dec, out = reversal(n=16, seed=8)
        mask = lengths_mask(16, T, seed=9)
        for conf, xs, fms, lms in (
                (Seq2SeqLSTM(K, K, hidden=32, t_in=T, t_out=T,
                             updater=Adam(5e-3, epsilon=1e-4)).conf(),
                 [enc, dec], None, None),
                (masked_conf("port", hidden=32,
                             updater=Adam(5e-3, epsilon=1e-4)),
                 [enc, dec, mask], [mask, None, None], [mask])):
            cpu = ComputationGraph(conf, device="cpu").init()
            card = ComputationGraph(conf, device="cuda").init()
            card.params_map = {n: {k: v.cuda() for k, v in p.items()}
                               for n, p in cpu.params_map.items()}
            before = lr.fwd_launches, lr.bwd_launches
            for _ in range(3):
                for g in (cpu, card):
                    g.fit(MultiDataSet(xs, [out], features_mask_arrays=fms,
                                       labels_mask_arrays=lms))
                assert abs(card.score() - cpu.score()) <= 1e-5 * abs(
                    cpu.score())
            assert (lr.fwd_launches - before[0],
                    lr.bwd_launches - before[1]) == (6, 6)
            for a, b in zip(tree_leaves(card.params_map),
                            tree_leaves(cpu.params_map)):
                np.testing.assert_allclose(_f32(a), _f32(b), atol=2e-5,
                                           rtol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
