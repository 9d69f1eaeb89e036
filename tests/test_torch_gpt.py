"""PyTorch port, GPT model: ``deeplearning4j_tpu_torch/models/gpt.py``
against ``deeplearning4j_tpu/models/gpt.py`` at f32 on a tiny config,
with the JAX model's own parameters carried over by ``params_from_jax``.

Tolerances: logits 1e-4 (12 matmuls deep at f32, different summation
orders), K/V stacks 1e-5, greedy tokens identical. The trap tests pin
the places where a PyTorch default would quietly differ from the JAX
model: tanh GELU, layer-norm eps 1e-5, the scale rounded to the compute
dtype, argmax ties to the first index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.models.gpt import CausalLM as JaxCausalLM
from deeplearning4j_tpu.models.transformer import tiny_config as jax_tiny
from deeplearning4j_tpu_torch.models.gpt import (
    CausalLM, init_params_numpy, params_from_jax, params_to_numpy)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, tiny_config)

VOCAB = 13


def _cfgs():
    kw = dict(vocab=VOCAB, max_len=48, d_model=32, n_layers=2, n_heads=4,
              d_ff=64)
    jcfg, tcfg = jax_tiny(**kw), tiny_config(**kw)
    jcfg.dropout = tcfg.dropout = 0.0
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jm = JaxCausalLM(jcfg, compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.key(1))
    tm = CausalLM(tcfg, compute_dtype=torch.float32)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, tm, tp


def _ids(seed, n, t):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, t)) \
        .astype(np.int32)


def test_config_mirrors_jax():
    jcfg, tcfg = _cfgs()
    for f in ("vocab_size", "max_len", "d_model", "n_layers", "n_heads",
              "d_ff", "eps", "compute_dtype", "head_dim"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert TransformerConfig().head_dim == 64


def test_forward_logits_and_kv_match_jax(models):
    jm, jp, tm, tp = models
    ids = _ids(0, 3, 11)
    jl, jk, jv = jm.forward(jp, jnp.asarray(ids), return_kv=True)
    tl, tk, tv = tm.forward(tp, torch.from_numpy(ids), return_kv=True)
    assert tuple(tk.shape) == (2, 3, 4, 11, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)


def test_decode_one_matches_jax(models):
    jm, jp, tm, tp = models
    cfg = tm.cfg
    ids = _ids(1, 2, 7)
    _, jk, jv = jm.forward(jp, jnp.asarray(ids), return_kv=True)
    shape = (cfg.n_layers, 2, cfg.n_heads, cfg.max_len, cfg.head_dim)
    ck = np.zeros(shape, np.float32)
    cv = np.zeros(shape, np.float32)
    ck[:, :, :, :7] = np.asarray(jk)
    cv[:, :, :, :7] = np.asarray(jv)
    tok = np.array([3, 11], np.int32)
    jl, jck, jcv = jm._decode_one(jp, jnp.asarray(ck), jnp.asarray(cv), 7,
                                  jnp.asarray(tok))
    tl, tck, tcv = tm._decode_one(tp, torch.from_numpy(ck.copy()),
                                  torch.from_numpy(cv.copy()), 7,
                                  torch.from_numpy(tok))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tck.numpy(), np.asarray(jck), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("n, t0, new", [(1, 5, 9), (3, 8, 6)])
def test_greedy_generate_matches_jax(models, n, t0, new):
    jm, jp, tm, tp = models
    ids = _ids(2 + n, n, t0)
    want = np.asarray(jm.generate(jp, jnp.asarray(ids), new))
    got = tm.generate(tp, ids, new)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_loss_matches_jax(models):
    jm, jp, tm, tp = models
    ids = _ids(5, 2, 12)
    want = float(jm.lm_loss(jp, jnp.asarray(ids), train=False))
    got = float(tm.lm_loss(tp, torch.from_numpy(ids)))
    assert abs(got - want) < 1e-5


def test_sampled_generate_is_deterministic_per_seed(models):
    _, _, tm, tp = models
    ids = _ids(6, 2, 4)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tm.generate(tp, ids, 12, temperature=1.0, generator=g).numpy()

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < VOCAB


def test_generate_rejects_over_budget(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="max_len"):
        tm.generate(tp, _ids(0, 1, 40), 9)


def test_params_round_trip(models):
    _, jp, _, tp = models
    tree = jax.device_get(jp)
    back = params_to_numpy(params_from_jax(tree, device="cpu"))
    flat_a, _ = jax.tree_util.tree_flatten(tree)
    flat_b, _ = jax.tree_util.tree_flatten(back)
    assert len(flat_a) == len(flat_b) == 4 + 12 * 2
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    bf = params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert bf["layers"][1]["w2"].dtype == torch.bfloat16
    assert torch.equal(tp["layers"][1]["w2"], torch.from_numpy(
        np.array(tree["layers"][1]["w2"])))


def test_numpy_init_has_the_jax_layout(models):
    _, jp, _, _ = models
    _, tcfg = _cfgs()
    got = init_params_numpy(tcfg, seed=3)
    want = jax.device_get(jp)
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
    assert abs(float(got["tok_emb"].std()) - 0.02) < 0.005


# --------------------------------------------------------------- traps
def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    exact = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, want, atol=1e-6)
    assert np.abs(exact - want).max() > 1e-4      # the trap is real


def test_layer_norm_eps_is_1e5_not_cfg_eps(models):
    jm, _, tm, _ = models
    assert tm.cfg.eps == 1e-12
    # variance ~1e-6: eps 1e-5 vs 1e-12 changes the output ~5x
    x = (np.random.default_rng(0).standard_normal((3, 32)) * 1e-3) \
        .astype(np.float32)
    p = {"g": np.ones(32, np.float32), "b": np.zeros(32, np.float32)}
    want = np.asarray(jm._ln(jnp.asarray(x), {k: jnp.asarray(v)
                                              for k, v in p.items()}))
    got = tm._ln(torch.from_numpy(x), {k: torch.from_numpy(v)
                                       for k, v in p.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    assert got.std() < 0.5          # eps 1e-12 would normalize to std 1


def test_scale_is_rounded_to_the_compute_dtype():
    cfg = tiny_config(d_model=48 * 4, n_heads=4)        # head_dim 48
    m = CausalLM(cfg, compute_dtype=torch.bfloat16)
    want = 1.0 / jnp.sqrt(jnp.asarray(48, jnp.bfloat16))
    got = m._scale("cpu")
    assert got.dtype == torch.bfloat16
    assert float(got) == float(want) != 1.0 / np.sqrt(48.0)


def test_bf16_tied_head_is_cast_to_f32_after(models):
    _, jp, _, _ = models
    _, tcfg = _cfgs()
    m = CausalLM(tcfg, compute_dtype=torch.bfloat16)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    shape = (2, 1, 4, tcfg.max_len, 8)
    ck = torch.zeros(shape, dtype=torch.bfloat16)
    logits, _, _ = m._decode_one(tp, ck, ck.clone(), 0,
                                 torch.tensor([1], dtype=torch.int32))
    assert logits.dtype == torch.float32
    # values are bf16 numbers: the head ran in bf16 before the cast
    assert torch.equal(logits, logits.to(torch.bfloat16).float())


def test_argmax_ties_go_to_the_first_index():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0]])
    assert int(logits.argmax(dim=-1)) == 1
    assert int(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)[0]) == 1
