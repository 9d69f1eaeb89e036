"""PyTorch port, SameDiff training (``deeplearning4j_tpu_torch/autodiff/
training.py``, ``serde.py``) against the JAX package.

- BERT MLM as a SameDiff graph (``chip_smoke.bert_mlm_graph``, the
  public API only) at 2 layers, d 64, built in JAX, saved and loaded in
  the port: the forward loss within 1e-6 relative, then 3 Adam steps of
  ``fit`` in both, the loss curves within 1e-5 relative and every
  parameter within 2e-6; on the CPU the port's graph gives
  ``TransformerEncoder``'s loss within 1e-5 relative and its gradients
  with a cosine of at least 0.9999 per parameter.
- l1, l2 and ``minimize=False``, validation losses and ``evaluate`` on a
  small classifier graph: losses within 1e-6 relative, parameters within
  1e-6, equal accuracies.
- ``updater_state.npz`` and the tagged ``TrainingConfig`` carry an exact
  resume both ways: JAX save -> port load -> one step equals JAX's next
  step, and port save -> JAX load likewise (1e-6).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.models.transformer import (TransformerEncoder,
                                                         init_params_numpy,
                                                         tiny_config)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

SEQ, BATCH, MASKED, CAP = 16, 4, 3, 3


def _jax():
    import deeplearning4j_tpu.ops  # noqa: F401  (registers the JAX ops)
    from deeplearning4j_tpu import autodiff as jad
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.learning import updaters as jup

    return jad, JDataSet, jup


def _cfg():
    return dataclasses.replace(tiny_config(vocab=97, max_len=32, d_model=64,
                                           n_layers=2, n_heads=4, d_ff=128),
                               dropout=0.0)


def _batch(seed):
    return chip_smoke.sd_mlm_batch(97, BATCH, SEQ, MASKED, 8, seed)


def _ds(DS, b):
    return DS([b[k] for k in chip_smoke.SD_FEEDS], None)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_bert_graph_from_jax_trains_as_in_jax(tmp_path):
    jad, JDS, jup = _jax()
    cfg, tree = _cfg(), init_params_numpy(_cfg(), seed=0)
    jsd = jad.SameDiff()
    loss = chip_smoke.bert_mlm_graph(jsd, tree, cfg, SEQ, CAP)
    jsd.setTrainingConfig(jad.TrainingConfig(
        updater=jup.Adam(1e-3), data_set_feature_mapping=list(
            chip_smoke.SD_FEEDS)))
    path = str(tmp_path / "bert.sdz")
    jsd.save(path)
    psd = SameDiff.load(path, device="cpu")
    assert isinstance(psd.training_config, TrainingConfig)
    b = _batch(1)
    want = float(jsd.outputSingle(b, loss.name))
    got = float(psd.outputSingle(b, "loss"))
    assert _rel(got, want) <= 1e-6, (got, want)
    batches = [_batch(s) for s in (2, 3, 4)]
    jl = jsd.fit([_ds(JDS, x) for x in batches]).lossCurve()
    pl = psd.fit([_ds(DataSet, x) for x in batches]).lossCurve()
    assert all(_rel(p, j) <= 1e-5 for p, j in zip(pl, jl)), (pl, jl)
    for n in psd.trainable_names():
        np.testing.assert_allclose(_np(psd._arrays[n]),
                                   np.asarray(jsd._arrays[n]),
                                   rtol=0, atol=2e-6, err_msg=n)


def test_bert_graph_matches_the_encoder_on_the_cpu():
    """The graph (key mask, type ids, capacity) against
    ``TransformerEncoder.encode`` + ``mlm_head_loss`` on the same tree."""
    cfg, tree = _cfg(), init_params_numpy(_cfg(), seed=0)
    sd = SameDiff(device="cpu")
    chip_smoke.bert_mlm_graph(sd, tree, cfg, SEQ, CAP)
    b = _batch(5)
    enc = TransformerEncoder(cfg, attn_impl="flash")
    from deeplearning4j_tpu_torch.params import params_from_jax

    params = params_from_jax(tree, device="cpu")
    leaves = chip_smoke._leaf_names(params)
    for t in leaves.values():
        t.requires_grad_(True)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    want = enc.mlm_head_loss(params, enc.encode(
        params, t["ids"], type_ids=t["type_ids"], mask=t["key_mask"]),
        t["labels"], t["mask_pos"], CAP)
    wg = dict(zip(leaves, torch.autograd.grad(want, list(leaves.values()))))
    got = float(sd.outputSingle(b, "loss"))
    assert _rel(got, float(want.detach())) <= 1e-5
    grads = sd.calculateGradients(b)
    assert set(grads) == set(wg)
    for n in wg:
        assert chip_smoke._cosine(grads[n], wg[n]) >= 0.9999, n


def _classifier(sd, rs_seed=0):
    rs = np.random.default_rng(rs_seed)
    x = sd.placeholder("x", shape=(None, 5))
    y = sd.placeholder("y", shape=(None, 3))
    w = sd.var("w", (rs.normal(size=(5, 3)) * 0.5).astype(np.float32))
    b = sd.var("b", np.zeros(3, np.float32))
    probs = sd.nn.softmax(x @ w + b, name="probs")
    ce = sd.math.reduce_mean(sd.math.reduce_sum(
        y * sd.math.log(probs), dimensions=[1]))
    sd.setLossVariables(-ce)
    return sd


def _data(n, seed):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.integers(0, 3, n)]
    return x, y


@pytest.mark.parametrize("l1,l2,minimize", [(0.0, 0.0, True),
                                            (1e-2, 0.0, True),
                                            (0.0, 1e-1, True),
                                            (1e-2, 1e-1, False)])
def test_penalties_direction_and_validation_match_jax(l1, l2, minimize):
    jad, JDS, jup = _jax()
    res = []
    for sd, TC, DS, S in ((SameDiff(device="cpu"), TrainingConfig, DataSet,
                           Sgd), (jad.SameDiff(), jad.TrainingConfig, JDS,
                                  jup.Sgd)):
        _classifier(sd)
        sd.setTrainingConfig(TC(updater=S(0.1),
                                data_set_feature_mapping=["x"],
                                data_set_label_mapping=["y"], l1=l1, l2=l2,
                                minimize=minimize))
        train = [DS(*_data(8, s)) for s in (1, 2)]
        val = [DS(*_data(6, 3)), DS(*_data(4, 4))]
        h = sd.fit(train, epochs=2, validation_data=val)
        res.append((h.lossCurve(), h.validation_losses,
                    _np(sd._arrays["w"]), _np(sd._arrays["b"])))
    (pl, pv, pw, pb), (jl, jv, jw, jb) = res
    assert len(pv) == len(jv) == 2
    for p, j in zip(pl + pv, jl + jv):
        assert _rel(p, j) <= 1e-6, (p, j)
    np.testing.assert_allclose(pw, jw, atol=1e-6)
    np.testing.assert_allclose(pb, jb, atol=1e-6)


def test_evaluate_matches_jax():
    jad, JDS, jup = _jax()
    acc = []
    for sd, TC, DS in ((SameDiff(device="cpu"), TrainingConfig, DataSet),
                       (jad.SameDiff(), jad.TrainingConfig, JDS)):
        _classifier(sd, rs_seed=2)
        sd.setTrainingConfig(TC(data_set_feature_mapping=["x"],
                                data_set_label_mapping=["y"]))
        ev = sd.evaluate([DS(*_data(20, 5)), DS(*_data(12, 6))], "probs")
        acc.append((ev.accuracy(), ev.f1()))
    assert acc[0] == pytest.approx(acc[1], abs=1e-12)


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_resume_from_updater_state_is_exact(tmp_path, direction):
    """Two Adam steps in one package, saved with the updater state; the
    other package loads it and takes the third step, which equals the
    first package's own third step."""
    jad, JDS, jup = _jax()
    pk = (SameDiff(device="cpu"), TrainingConfig, DataSet, Adam)
    jk = (jad.SameDiff(), jad.TrainingConfig, JDS, jup.Adam)
    src, dst = (jk, pk) if direction == "jax->port" else (pk, jk)
    sd, TC, DS, A = src
    _classifier(sd)
    sd.setTrainingConfig(TC(updater=A(0.05), data_set_feature_mapping=["x"],
                            data_set_label_mapping=["y"], l2=1e-2))
    sd.fit([DS(*_data(8, s)) for s in (1, 2)])
    path = str(tmp_path / "resume.sdz")
    sd.save(path)
    third = DS(*_data(8, 3))
    want = sd.fit(third).lossCurve()[0]
    want_w = _np(sd._arrays["w"])
    other = SameDiff.load(path, device="cpu") if dst is pk \
        else jad.SameDiff.load(path)
    assert other._iteration == 2
    got = other.fit(dst[2](*_data(8, 3))).lossCurve()[0]
    assert _rel(got, want) <= 1e-6, (got, want)
    np.testing.assert_allclose(_np(other._arrays["w"]), want_w, atol=1e-6)


def test_training_config_tag_round_trips_with_jax():
    jad, _, jup = _jax()
    from deeplearning4j_tpu.common import serde as jserde

    cfg = TrainingConfig(updater=Adam(3e-4), data_set_feature_mapping=["a"],
                         data_set_label_mapping=["b"], l2=1e-4,
                         minimize=False)
    j = jserde.from_dict(serde.to_dict(cfg))
    assert isinstance(j, jad.TrainingConfig) and j.l2 == 1e-4
    assert isinstance(j.updater, jup.Adam)
    back = serde.from_dict(jserde.to_dict(j))
    assert back == dataclasses.replace(cfg, data_set_feature_mapping=["a"],
                                       data_set_label_mapping=["b"])


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_bert_graph_fit_matches_the_cpu():
    """The 2-layer graph's 3 Adam steps on the card (B1 by name, 2
    forward and 2 backward launches a step) against the CPU: losses within
    1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tree = _cfg(), init_params_numpy(_cfg(), seed=0)
    curves = []
    for dev in ("cuda", "cpu"):
        sd = SameDiff(device=dev)
        chip_smoke.bert_mlm_graph(sd, tree, cfg, SEQ, CAP)
        sd.setTrainingConfig(TrainingConfig(
            updater=Adam(1e-3),
            data_set_feature_mapping=list(chip_smoke.SD_FEEDS)))
        before = (fa.fwd_launches, fa.bwd_launches)
        curves.append(sd.fit([_ds(DataSet, _batch(s))
                              for s in (2, 3, 4)]).lossCurve())
        launched = (fa.fwd_launches - before[0], fa.bwd_launches - before[1])
        assert launched == ((6, 6) if dev == "cuda" else (0, 0))
    assert all(_rel(a, b) <= 1e-5 for a, b in zip(*curves)), curves
