"""PyTorch port, normalizers: ``deeplearning4j_tpu_torch.datasets.normalizers``
against the JAX package's on the same numpy batches.

Tolerances: statistics, ``transform`` and ``revert`` within 1e-6 relative
(of max(1, max |value|)) at f32: the statistics are the same numpy sums,
the transform the same f32 arithmetic in torch instead of XLA. The
``normalizer.npz`` member a model zip carries, written by either package,
restores in the other and transforms alike.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                               ArrayMultiDataSetIterator,
                                               DataSet, MultiDataSet)
from deeplearning4j_tpu_torch.datasets import normalizers as tn
from deeplearning4j_tpu_torch.nn.conf import (DenseLayer, InputType,
                                              NeuralNetConfiguration,
                                              OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

RTOL = 1e-6


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: {err:.3e} > {RTOL} x {scale:.3e}"


def _batches(seed=0, n=30, f=4, t=None):
    rs = np.random.RandomState(seed)
    shape = (n, f) if t is None else (n, t, f)
    x = (rs.randn(*shape) * 3 + 5).astype(np.float32)
    y = (rs.randn(*shape[:-1], 2) * 2 - 1).astype(np.float32)
    return x, y


def _jax():
    from deeplearning4j_tpu.datasets import normalizers as jn
    return jn


def _pair(tds, jds, what):
    _close(tds.features, np.asarray(jds.features), what + " features")
    _close(tds.labels, np.asarray(jds.labels), what + " labels")


def _jax_ds(x, y):
    from deeplearning4j_tpu.datasets import DataSet as JD
    return JD(x, y)


def _jax_iter(x, y, b):
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JA
    return JA(x, y, b)


@pytest.mark.parametrize("fit_label", [False, True])
@pytest.mark.parametrize("t", [None, 5], ids=["2d", "3d"])
def test_standardize_matches_jax(t, fit_label):
    jn = _jax()
    x, y = _batches(t=t)
    tnorm = tn.NormalizerStandardize().fitLabel(fit_label)
    jnorm = jn.NormalizerStandardize().fitLabel(fit_label)
    tnorm.fit(ArrayDataSetIterator(x, y, 7))
    jnorm.fit(_jax_iter(x, y, 7))
    for k, v in jnorm.state_dict().items():
        _close(tnorm.state_dict()[k], v, k)
    td, jd = tnorm.transform(DataSet(x, y)), jnorm.transform(_jax_ds(x, y))
    assert torch.is_tensor(td.features)
    _pair(td, jd, "transform")
    _pair(tnorm.revert(td), jnorm.revert(jd), "revert")
    _close(tnorm.revertLabels(y), np.asarray(jnorm.revertLabels(y)),
           "revertLabels")


def test_min_max_image_vgg_and_composite_match_jax():
    jn = _jax()
    x, y = _batches(1)
    px = np.random.RandomState(2).randint(0, 256, (6, 5, 5, 3)).astype(
        np.uint8)
    py = np.zeros((6, 2), np.float32)
    cases = [
        (tn.NormalizerMinMaxScaler(-1.0, 2.0), jn.NormalizerMinMaxScaler(
            -1.0, 2.0), x, y),
        (tn.ImagePreProcessingScaler(0.0, 1.0), jn.ImagePreProcessingScaler(
            0.0, 1.0), px, py),
        (tn.VGG16ImagePreProcessor(), jn.VGG16ImagePreProcessor(), px, py),
        (tn.CompositeDataSetPreProcessor(tn.NormalizerMinMaxScaler(),
                                         tn.NormalizerStandardize()),
         jn.CompositeDataSetPreProcessor(jn.NormalizerMinMaxScaler(),
                                         jn.NormalizerStandardize()), x, y),
    ]
    for t, j, a, b in cases:
        name = type(t).__name__
        t.fit(ArrayDataSetIterator(a, b, 4))
        j.fit(_jax_iter(a, b, 4))
        td = t.preProcess(DataSet(a, b))
        jd = j.preProcess(_jax_ds(a, b))
        assert td.features.dtype == torch.float32, name
        _pair(td, jd, name)
    vt, vj = cases[2][0], cases[2][1]
    _close(vt.revert(DataSet(px.astype(np.float32), py)).features,
           np.asarray(vj.revert(_jax_ds(px.astype(np.float32), py))
                      .features), "vgg revert")


def test_multi_normalizers_match_jax():
    jn = _jax()
    from deeplearning4j_tpu.datasets import multi_dataset as jm

    x, y = _batches(3)
    x2 = x[:, :2] * 4
    for t, j in ((tn.MultiNormalizerStandardize().fitLabel(True),
                  jn.MultiNormalizerStandardize().fitLabel(True)),
                 (tn.MultiNormalizerMinMaxScaler(),
                  jn.MultiNormalizerMinMaxScaler())):
        t.fit(ArrayMultiDataSetIterator([x, x2], [y], 8))
        j.fit(jm.ArrayMultiDataSetIterator([x, x2], [y], 8))
        td = t.preProcess(MultiDataSet([x, x2], [y]))
        jd = j.preProcess(jm.MultiDataSet([x, x2], [y]))
        for a, b in zip(td.features + td.labels, jd.features + jd.labels):
            _close(a, np.asarray(b), type(t).__name__)
        with pytest.raises(ValueError, match="refusing to truncate"):
            t.transform(MultiDataSet([x], [y]))
    t.load_state_dict(j.state_dict())
    assert [m.shape for m in t.mins] == [(4,), (2,)]


def _mlp(nnc, dense, out, it):
    return (nnc.builder().seed(3).list()
            .layer(dense(n_out=5, activation="tanh"))
            .layer(out(n_out=2, activation="identity", loss="mse"))
            .setInputType(it.feedForward(4)).build())


def _composite(mod):
    return mod.CompositeDataSetPreProcessor(mod.NormalizerMinMaxScaler(),
                                            mod.NormalizerStandardize())


@pytest.mark.parametrize("kind", ["standardize", "composite"])
def test_normalizer_member_crosses_between_packages(tmp_path, kind):
    """A normalizer saved in a model zip by either package restores in the
    other and transforms the same batch alike."""
    jn = _jax()
    from deeplearning4j_tpu.nn.conf import (DenseLayer as JDense,
                                            InputType as JIT,
                                            NeuralNetConfiguration as JNNC,
                                            OutputLayer as JOut)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.util import ModelSerializer as JSer

    x, y = _batches(4)
    make = ((lambda m: m.NormalizerStandardize().fitLabel(True))
            if kind == "standardize" else _composite)
    tnorm, jnorm = make(tn), make(jn)
    tnorm.fit(DataSet(x, y))
    jnorm.fit(_jax_ds(x, y))
    net = MultiLayerNetwork(_mlp(NeuralNetConfiguration, DenseLayer,
                                 OutputLayer, InputType), device="cpu").init()
    jnet = JMLN(_mlp(JNNC, JDense, JOut, JIT)).init()
    pt, pj = str(tmp_path / "t.zip"), str(tmp_path / "j.zip")
    ModelSerializer.writeModel(net, pt, normalizer=tnorm)
    JSer.writeModel(jnet, pj, normalizer=jnorm)
    from_j = ModelSerializer.restoreNormalizer(pj)
    from_t = JSer.restoreNormalizer(pt)
    assert type(from_j).__name__ == type(from_t).__name__ == type(
        tnorm).__name__
    _pair(from_j.transform(DataSet(x, y)),
          from_t.transform(_jax_ds(x, y)), "restored")
    _pair(ModelSerializer.restoreNormalizer(pt).transform(DataSet(x, y)),
          jnorm.transform(_jax_ds(x, y)), "round trip")


def test_unrestorable_composites_are_refused_before_writing(tmp_path):
    net = MultiLayerNetwork(_mlp(NeuralNetConfiguration, DenseLayer,
                                 OutputLayer, InputType), device="cpu").init()
    path = tmp_path / "m.zip"
    nested = tn.CompositeDataSetPreProcessor(_composite(tn))
    with pytest.raises(ValueError, match="nested composites"):
        ModelSerializer.writeModel(net, str(path), normalizer=nested)
    assert not path.exists()
    ModelSerializer.writeModel(net, str(path))
    assert ModelSerializer.restoreNormalizer(str(path)) is None


def test_transform_runs_where_the_batch_is():
    x, y = _batches(5)
    norm = tn.NormalizerStandardize()
    norm.fit(DataSet(x, y))
    out = norm.transform(DataSet(torch.from_numpy(x).to(torch.bfloat16), y))
    # a bf16 batch less f32 statistics is f32, as in JAX
    assert out.features.dtype == torch.float32
    assert out.features.device == torch.device("cpu")
    assert isinstance(norm.state_dict()["mean"], np.ndarray)


@pytest.mark.cuda
def test_transform_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y = _batches(6)
    norm = tn.NormalizerStandardize().fitLabel(True)
    norm.fit(DataSet(x, y))
    card = norm.transform(DataSet(torch.from_numpy(x).cuda(),
                                  torch.from_numpy(y).cuda()))
    cpu = norm.transform(DataSet(x, y))
    assert card.features.device.type == "cuda"
    _pair(card, DataSet(cpu.features.numpy(), cpu.labels.numpy()), "card")
