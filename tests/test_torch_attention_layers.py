"""PyTorch port, the attention layers of ``nn/conf/layers.py``
(``SelfAttentionLayer``, ``LearnedSelfAttentionLayer``,
``RecurrentAttentionLayer``) and their op
``ops.nn.multi_head_dot_product_attention``, against the JAX package on
the same numpy inputs and weights at f32:

- the op with and without a ``[N, Tk]`` key-padding mask, and with JAX's
  default head count ``max(1, proj // 64)``: values and the gradients of
  a weighted sum with respect to every input;
- each layer's parameters, output and gradients, and its output type;
- the three layers stacked in a network restored from the JAX zip and
  trained three Adam steps beside it (the gradients through the
  network);
- the builder's ``n_out = n_in`` default, the JSON read from JAX, and
  ``RecurrentAttentionLayer``'s refusal of ``rnnTimeStep``.

Tolerances: outputs, losses and gradients within 1e-5 of max(1, max
|value|); parameters within 1e-4 absolute after three steps.

The cuda-marked tests at the end hold the card (TF32 off) against the CPU
and import no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_attention_layers.py``.
"""

import numpy as np
import pytest
import torch

from torch_twins import (card_vs_cpu, close, mln_conf,  # noqa: F401
                         numpy_weights, pair, pkg, trajectory, two_threads,
                         twins)

from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.ops import nn as tnn

TOL, LOSS_RTOL, PARAM_ATOL, STEPS = 1e-5, 1e-5, 1e-4, 3
N, T, D = 3, 6, 8


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


#: (key mask, heads, projection width)
MHA_CASES = [(False, 2, 8), (True, 2, 8), (True, None, 128),
             (False, 4, 16)]


@pytest.mark.parametrize("case", MHA_CASES, ids=[str(c) for c in MHA_CASES])
def test_multi_head_attention_matches_jax(case):
    from deeplearning4j_tpu.ops import nn as jnn

    masked, heads, proj = case
    arrays = [_rand(N, 5, D), _rand(N, 7, D, seed=1)] + [
        _rand(D, proj, seed=2 + i, scale=0.4) for i in range(3)] + [
        _rand(proj, 5, seed=5, scale=0.3)]
    if masked:
        m = (np.random.RandomState(6).rand(N, 7) > 0.4).astype(np.int32)
        m[:, 0] = 1
        arrays.append(m)
    pair(lambda *a: tnn.multi_head_dot_product_attention(
        *a[:6], mask=a[6] if masked else None, num_heads=heads),
        lambda *a: jnn.multi_head_dot_product_attention(
            *a[:6], mask=a[6] if masked else None, num_heads=heads),
        arrays, TOL)


#: (class, fields)
LAYER_CASES = [
    ("SelfAttentionLayer", dict(n_in=D, n_out=6, n_heads=2,
                                activation="tanh")),
    ("SelfAttentionLayer", dict(n_in=D, n_out=D, n_heads=1, head_size=5)),
    ("LearnedSelfAttentionLayer", dict(n_in=D, n_out=6, n_heads=2,
                                       n_queries=3)),
    ("RecurrentAttentionLayer", dict(n_in=D, n_out=6, n_heads=2)),
    ("RecurrentAttentionLayer", dict(n_in=D, n_out=4, n_heads=1,
                                     activation="relu")),
]


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LAYER_CASES)])
def test_attention_layer_matches_jax(case):
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.common import serde as jserde

    kind, kw = case
    t, j = pkg(False), pkg(True)
    layer, jlayer = getattr(t.Ly, kind)(**kw), getattr(j.Ly, kind)(**kw)
    assert serde.to_json(layer) == jserde.to_json(jlayer)
    it, jit = t.C.InputType.recurrent(D, T), j.C.InputType.recurrent(D, T)
    jp = jax.eval_shape(lambda k: jlayer.init_params(k, jit, jnp.float32),
                        jax.random.key(0))
    p = layer.init_params(torch.Generator().manual_seed(0), it,
                          torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    names = sorted(jp)
    arrays = [_rand(N, T, D)] + [_rand(*jp[k].shape, seed=1 + i, scale=0.4)
                                 for i, k in enumerate(names)]
    pair(lambda x, *ps: layer.apply(dict(zip(names, ps)), {}, x, False,
                                    None)[0],
         lambda x, *ps: jlayer.apply(dict(zip(names, ps)), {}, x, False,
                                     None)[0], arrays, TOL)
    assert serde.to_json(layer.output_type(it)) == jserde.to_json(
        jlayer.output_type(jit))


def _stack(p):
    Ly = p.Ly
    return [Ly.SelfAttentionLayer(n_heads=2, head_size=4, activation="tanh"),
            Ly.RecurrentAttentionLayer(n_out=6, n_heads=2),
            Ly.LearnedSelfAttentionLayer(n_heads=2, head_size=3,
                                         n_queries=2),
            Ly.GlobalPoolingLayer(pooling_type="avg"),
            Ly.OutputLayer(n_out=2, activation="softmax", loss="mcxent")]


def test_attention_stack_follows_jax(tmp_path):
    jnet, net = twins(_stack, lambda it: it.recurrent(D, T), tmp_path)
    # the builder's default: n_out = n_in where it is 0
    assert [(l.n_in, l.n_out) for l in net.conf.layers[:3]] == [
        (D, D), (D, 6), (6, 6)]
    x = _rand(5, T, D, seed=3)
    y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0, 1]]
    close(net.output(x), np.asarray(jnet.output(x)), TOL, "output")
    trajectory(jnet, net, x, y, STEPS, LOSS_RTOL, PARAM_ATOL,
               lambda m: m.params_list)
    for model in (net, jnet):
        with pytest.raises(NotImplementedError,
                           match="RecurrentAttentionLayer"):
            model.rnnTimeStep(x[:, :1])


@pytest.mark.parametrize("kind", ["SelfAttentionLayer",
                                  "LearnedSelfAttentionLayer",
                                  "RecurrentAttentionLayer"])
def test_builder_default_and_jax_json(kind):
    """``n_out`` of 0 becomes ``n_in`` in both builders; the JAX JSON reads
    into the port as it reads back into JAX. ``head_size`` is fixed at
    construction from ``n_out or n_in``: a layer built with neither keeps
    a ``head_size`` of 0 in both builders, and reading its JSON back sets
    it from the inferred widths, in both packages alike."""
    def layers(p):
        return [getattr(p.Ly, kind)(n_heads=2), p.Ly.GlobalPoolingLayer(),
                p.Ly.OutputLayer(n_out=2)]

    def it(t):
        return t.recurrent(D, T)

    jconf = mln_conf(pkg(True), layers, it)
    conf = mln_conf(pkg(False), layers, it)
    assert conf.layers[0].n_out == conf.layers[0].n_in == D
    assert conf.layers[0].head_size == jconf.layers[0].head_size == 0
    assert conf.to_json() == jconf.to_json()
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert type(back.layers[0]).__name__ == kind
    assert back.to_json() == type(jconf).from_json(jconf.to_json()).to_json()
    assert back.layers[0].head_size == D // 2
    built = mln_conf(pkg(False), lambda p: [getattr(p.Ly, kind)(
        n_heads=2, head_size=3), p.Ly.GlobalPoolingLayer(),
        p.Ly.OutputLayer(n_out=2)], it)
    assert MultiLayerConfiguration.from_json(built.to_json()) == built


# -------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LAYER_CASES)])
def test_cuda_attention_layer_matches_the_cpu(card, case):
    kind, kw = case
    t = pkg(False)
    layer = getattr(t.Ly, kind)(**kw)
    p = layer.init_params(torch.Generator().manual_seed(0),
                          t.C.InputType.recurrent(D, T), torch.float32,
                          "cpu")
    names = sorted(p)
    arrays = [_rand(N, T, D)] + [p[k].numpy() for k in names]
    card_vs_cpu(lambda x, *ps: layer.apply(dict(zip(names, ps)), {}, x,
                                           False, None)[0], arrays, card,
                TOL)


@pytest.mark.cuda
def test_cuda_masked_multi_head_attention_matches_the_cpu(card):
    m = (np.random.RandomState(6).rand(N, 7) > 0.4).astype(np.float32)
    m[:, 0] = 1.0
    arrays = [_rand(N, 5, D), _rand(N, 7, D, seed=1)] + [
        _rand(D, 8, seed=2 + i, scale=0.4) for i in range(4)]
    card_vs_cpu(lambda *a: tnn.multi_head_dot_product_attention(
        *a, mask=torch.from_numpy(m).to(a[0].device), num_heads=2), arrays,
        card, TOL)
