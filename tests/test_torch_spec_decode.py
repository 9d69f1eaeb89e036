"""PyTorch port, speculative decoding: ``deeplearning4j_tpu_torch/
serving/spec_decode.py`` against ``deeplearning4j_tpu/serving/
spec_decode.py``. The n-gram draft and greedy acceptance must equal
JAX's exactly; sampled acceptance draws from ``torch.Generator`` (not
JAX's keys), so it is held to the law instead: the first emitted token
follows the target distribution (the JAX package's own check,
tests/test_spec_decode.py:271)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import spec_decode as jsd
from deeplearning4j_tpu_torch.serving import spec_decode as tsd

VOCAB = 11


@pytest.mark.parametrize("match_len", [1, 2, 3])
def test_ngram_draft_matches_jax(match_len):
    rng = np.random.default_rng(match_len)
    a, b = tsd.NGramDraft(match_len), jsd.NGramDraft(match_len)
    for L in (1, 2, 5, 17, 40):
        h = rng.integers(0, 4, (L,)).astype(np.int32)
        for k in (1, 3, 6):
            np.testing.assert_array_equal(a.propose(h, k), b.propose(h, k))
    with pytest.raises(ValueError):
        tsd.NGramDraft(0)


def _case(seed, S=6, K=4):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((S, K + 1, VOCAB)).astype(np.float32)
    greedy = logits.argmax(-1)
    drafts = rng.integers(0, VOCAB, (S, K)).astype(np.int32)
    # slot 0 agrees everywhere, slot 1 for two drafts, slot 2 nowhere
    drafts[0] = greedy[0, :K]
    drafts[1, :2] = greedy[1, :2]
    drafts[2] = (greedy[2, :K] + 1) % VOCAB
    n_draft = np.array([K, K, K, 0, 2, K - 1], np.int32)[:S]
    return logits, drafts, n_draft


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_accept_matches_jax(seed):
    logits, drafts, n_draft = _case(seed)
    S = logits.shape[0]
    kd = np.asarray(jax.vmap(jax.random.key_data)(
        jax.vmap(jax.random.key)(jnp.arange(S))))
    out_j, nacc_j, _ = jsd.accept_tokens(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(n_draft),
        jnp.asarray(kd), jnp.zeros((S,), jnp.float32))
    out_t, nacc_t = tsd.accept_tokens(torch.from_numpy(logits), drafts,
                                      n_draft, np.zeros(S, np.float32))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(nacc_t.numpy(), np.asarray(nacc_j))
    assert nacc_t.tolist()[:4] == [5, 3, 1, 1]


def test_first_token_marginal_is_target_distribution():
    """A fixed draft token, many rows: the first emitted token's
    empirical distribution matches softmax(logits / T)."""
    V, K, N, T = 5, 1, 4000, 0.8
    rng = np.random.default_rng(0)
    row = rng.normal(0, 1, (V,)).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (N, K + 1, 1)))
    drafts = np.full((N, K), 3, np.int32)
    g = torch.Generator().manual_seed(0)
    out, nacc = tsd.accept_tokens(logits, drafts, np.full((N,), K),
                                  np.full((N,), T, np.float32), g)
    first = out[:, 0].numpy()
    want = np.asarray(jax.nn.softmax(jnp.asarray(row) / T))
    got = np.bincount(first, minlength=V) / N
    np.testing.assert_allclose(got, want, atol=0.05)
    assert set(nacc.tolist()) <= {1, 2}


def test_sampled_rows_replay_per_generator_and_greedy_rows_need_none():
    logits, drafts, n_draft = _case(5)
    S = logits.shape[0]
    temps = np.array([0.0, 0.7, 0.0, 1.2, 0.0, 0.9], np.float32)

    def run(seed):
        gens = [torch.Generator().manual_seed(seed + s) if temps[s] > 0
                else None for s in range(S)]
        return tsd.accept_tokens(torch.from_numpy(logits), drafts, n_draft,
                                 temps, gens)

    a, b = run(1), run(1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    greedy_rows = [0, 2, 4]
    want, nacc = tsd.accept_tokens(torch.from_numpy(logits), drafts, n_draft,
                                   np.zeros(S, np.float32))
    assert torch.equal(a[0][greedy_rows], want[greedy_rows])
    assert ((a[1] >= 1) & (a[1] <= torch.from_numpy(n_draft) + 1)).all()
    with pytest.raises(ValueError, match="no generator"):
        tsd.accept_tokens(torch.from_numpy(logits), drafts, n_draft, temps,
                          [None] * S)


def test_spec_config_validation():
    assert tsd.SpecConfig.resolve(4).make_draft().match_len == 3
    with pytest.raises(ValueError, match="k must be"):
        tsd.SpecConfig(k=0)
    with pytest.raises(ValueError, match="propose"):
        tsd.SpecConfig(draft=object()).make_draft()
    with pytest.raises(ValueError, match="cannot resolve"):
        tsd.SpecConfig.resolve(2.5)
