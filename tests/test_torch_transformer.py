"""PyTorch port, BERT encoder and classifier: ``deeplearning4j_tpu_torch/
models/transformer.py`` and ``models/bert_classifier.py`` against the JAX
package's models at f32 on a tiny config with dropout off, the JAX
model's own parameters carried over by ``params_from_jax``.

Both attention paths are compared with their JAX twins: ``"default"``
(plain softmax attention, ``finfo.min`` masking) and ``"flash"`` (on the
CPU the blockwise online softmax, ``-1e30`` masking; on the card the
port's CUDA kernels). Tolerances: hidden states and losses 1e-4
(several f32 matmuls deep, different summation orders), gradients 1e-5
absolute plus 1e-4 relative, parameters after three Adam steps (lr 1e-4)
1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning.updaters import Adam as JaxAdam
from deeplearning4j_tpu.models.bert_classifier import (
    BertSequenceClassifier as JaxClassifier)
from deeplearning4j_tpu.models.transformer import (
    TransformerEncoder as JaxEncoder, bert_base as jax_bert_base,
    tiny_config as jax_tiny)
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.models.bert_classifier import (
    BertSequenceClassifier)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerEncoder, bert_base, init_params_numpy,
    tiny_config)
from deeplearning4j_tpu_torch.params import (
    FlatParams, params_from_jax, params_to_numpy)

VOCAB, N, T = 64, 3, 16
KW = dict(vocab=VOCAB, max_len=32, d_model=32, n_layers=2, n_heads=4,
          d_ff=64)
IMPLS = ["default", "flash"]


def _cfgs():
    jcfg, tcfg = jax_tiny(**KW), tiny_config(**KW)
    jcfg.dropout = tcfg.dropout = 0.0
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return jax.device_get(JaxEncoder(jcfg).init_params(jax.random.key(1)))


def _models(impl):
    jcfg, tcfg = _cfgs()
    return JaxEncoder(jcfg, attn_impl=impl), TransformerEncoder(
        tcfg, attn_impl=impl)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (N, T)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (N, T)).astype(np.int32)
    mask_pos = np.zeros((N, T), np.float32)
    for r in range(N):
        mask_pos[r, rng.choice(T, 4, replace=False)] = 1.0
    pad = np.ones((N, T), np.float32)
    pad[0, 11:] = 0.0
    pad[2, 6:] = 0.0
    return ids, labels, mask_pos, pad


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_trees_close(got, want, atol, rtol=0.0):
    g, w = dict(_paths(got)), dict(_paths(want))
    assert g.keys() == w.keys()
    for p in w:
        a = got_np = g[p]
        if torch.is_tensor(a):
            got_np = a.detach().float().numpy()
        np.testing.assert_allclose(got_np, np.asarray(w[p]), atol=atol,
                                   rtol=rtol, err_msg=p)


def test_configs_mirror_jax():
    for j, t in ((jax_bert_base(), bert_base()), _cfgs()):
        for f in ("vocab_size", "max_len", "d_model", "n_layers", "n_heads",
                  "d_ff", "type_vocab", "eps", "dtype", "compute_dtype",
                  "head_dim"):
            assert getattr(t, f) == getattr(j, f), f
    assert bert_base().dropout == 0.1 and bert_base().eps == 1e-12


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(jax_params, impl, masked):
    jm, tm = _models(impl)
    ids, _, _, pad = _batch(1)
    mask = pad if masked else None
    want = np.asarray(jm.encode(jax_params, jnp.asarray(ids),
                                mask=None if mask is None
                                else jnp.asarray(mask)))
    got = tm.encode(params_from_jax(jax_params, device="cpu"),
                    torch.from_numpy(ids),
                    mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (N, T, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("capacity", [None, 5])
@pytest.mark.parametrize("impl", IMPLS)
def test_mlm_loss_matches_jax(jax_params, impl, capacity):
    jm, tm = _models(impl)
    ids, labels, mask_pos, _ = _batch(2)
    want = float(jm.mlm_loss(jax_params, *(jnp.asarray(a) for a in
                                           (ids, labels, mask_pos)),
                             train=False, masked_capacity=capacity))
    got = float(tm.mlm_loss(params_from_jax(jax_params, device="cpu"),
                            *(torch.from_numpy(a) for a in
                              (ids, labels, mask_pos)),
                            train=False, masked_capacity=capacity))
    assert abs(got - want) <= 1e-4 * abs(want)


@pytest.mark.parametrize("impl", IMPLS)
def test_grads_of_every_leaf_match_jax(jax_params, impl):
    """Including the tied ``tok_emb`` (lookup plus head) and the unused
    ``type_emb`` (zero in both)."""
    jm, tm = _models(impl)
    ids, labels, mask_pos, _ = _batch(3)
    jargs = [jnp.asarray(a) for a in (ids, labels, mask_pos)]
    want = jax.jit(jax.grad(lambda p: jm.mlm_loss(
        p, *jargs, train=False, masked_capacity=5)))(jax_params)
    flat = FlatParams(params_from_jax(jax_params, device="cpu"))
    loss = tm.mlm_loss(flat.tree, *(torch.from_numpy(a) for a in
                                    (ids, labels, mask_pos)), train=False,
                       masked_capacity=5)
    flat.gather_grads(loss)
    grads, off = [], 0
    for leaf in flat.leaves:
        grads.append(flat.grad[off:off + leaf.numel()].view(leaf.shape))
        off += leaf.numel()
    it = iter(grads)
    got = jax.tree_util.tree_map(lambda _: next(it),
                                 params_to_numpy(flat.tree))
    _assert_trees_close(got, want, atol=1e-5, rtol=1e-4)
    assert float(flat.grad.abs().max()) > 0
    assert not np.asarray(want["type_emb"]).any()


@pytest.mark.parametrize("impl", IMPLS)
def test_three_train_steps_match_jax(jax_params, impl):
    jm, tm = _models(impl)
    ids, labels, mask_pos, _ = _batch(4)
    jstep = jm.make_train_step(JaxAdam(1e-4), masked_capacity=5)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params)
    jopt = JaxAdam(1e-4).init_state(jp)
    flat = FlatParams(params_from_jax(jax_params, device="cpu"))
    upd = Adam(1e-4)
    opt = upd.init_state(flat.master)
    step = tm.make_train_step(upd, masked_capacity=5)
    targs = [torch.from_numpy(a) for a in (ids, labels, mask_pos)]
    for i in range(3):
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(i),
                             *(jnp.asarray(a) for a in (ids, labels,
                                                        mask_pos)), None)
        tl = step(flat, opt, i, *targs)
        assert tl.dtype == torch.float32 and tl.dim() == 0
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), i
    _assert_trees_close(flat.tree, jax.device_get(jp), atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_classifier_loss_and_step_with_padding_match_jax(impl):
    jcfg, tcfg = _cfgs()
    jc = JaxClassifier(jcfg, 3, attn_impl=impl)
    tc = BertSequenceClassifier(tcfg, 3, attn_impl=impl)
    jp = jax.device_get(jc.init_params(jax.random.key(2)))
    ids, _, _, pad = _batch(5)
    y = np.array([0, 2, 1], np.int32)
    jargs = [jnp.asarray(a) for a in (ids, y, pad)]
    want = float(jc.loss(jp, jargs[0], jargs[1], mask=jargs[2],
                         train=False))
    tp = params_from_jax(jp, device="cpu")
    targs = [torch.from_numpy(a) for a in (ids, y, pad)]
    got = float(tc.loss(tp, targs[0], targs[1], mask=targs[2], train=False))
    assert abs(got - want) <= 1e-4 * abs(want)
    np.testing.assert_array_equal(
        tc.predict(tp, targs[0], mask=targs[2]).numpy(),
        np.asarray(jc.predict(jp, jargs[0], mask=jargs[2])))

    jstep = jc.make_train_step(JaxAdam(1e-4))
    jp2 = jax.tree_util.tree_map(jnp.asarray, jp)
    jp2, _, jl = jstep(jp2, JaxAdam(1e-4).init_state(jp2), jnp.asarray(0),
                       *jargs, None)
    flat = FlatParams(tp)
    upd = Adam(1e-4)
    tl = tc.make_train_step(upd)(flat, upd.init_state(flat.master), 0,
                                 *targs)
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    _assert_trees_close(flat.tree, jax.device_get(jp2), atol=1e-5)


def test_encoder_params_round_trip(jax_params):
    back = params_to_numpy(params_from_jax(jax_params, device="cpu"))
    a, b = dict(_paths(jax_params)), dict(_paths(back))
    assert a.keys() == b.keys() and len(a) == 6 + 2 * 12
    for p in a:
        np.testing.assert_array_equal(np.asarray(a[p]), b[p])


def test_numpy_init_has_the_jax_layout(jax_params):
    got = init_params_numpy(_cfgs()[1], seed=3)
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(jax_params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax_params)):
        assert a.shape == b.shape and a.dtype == np.float32
    assert abs(float(got["tok_emb"].std()) - 0.02) < 0.005
    cls = BertSequenceClassifier(_cfgs()[1], 3).init_params_numpy(seed=0)
    jcls = jax.device_get(JaxClassifier(_cfgs()[0], 3).init_params(
        jax.random.key(0)))
    assert jax.tree_util.tree_structure(cls) \
        == jax.tree_util.tree_structure(jcls)


def test_moe_is_not_ported():
    cfg = tiny_config()
    cfg.n_experts = 4
    with pytest.raises(NotImplementedError, match="MoE"):
        TransformerEncoder(cfg)
    with pytest.raises(NotImplementedError, match="MoE"):
        init_params_numpy(cfg)


def test_flat_params_are_views_of_one_buffer():
    tree = {"a": torch.ones(2, 3), "b": [torch.full((4,), 2.0)],
            "unused": torch.zeros(5)}
    flat = FlatParams(tree)
    assert flat.numel == 15 and flat.master.shape == (15,)
    assert all(p._base is flat.master and p.requires_grad
               for p in flat.leaves)
    with torch.no_grad():
        flat.master.mul_(3.0)
    assert float(flat.tree["b"][0][0].detach()) == 6.0
    loss = (flat.tree["a"] * 2).sum() + flat.tree["b"][0].pow(2).sum()
    g = flat.gather_grads(loss)
    np.testing.assert_array_equal(
        g.numpy(), np.r_[np.full(6, 2.0), np.full(4, 12.0), np.zeros(5)])


def test_train_step_takes_only_adam():
    class NotAdam(Adam):
        pass

    with pytest.raises(TypeError, match="Adam"):
        TransformerEncoder(tiny_config()).make_train_step(NotAdam())


# --------------------------------------------------------------- traps
def test_encoder_ln_uses_cfg_eps_and_gamma_beta(jax_params):
    """Trap: the encoder's layer norm takes ``cfg.eps`` (1e-12), not the
    GPT's 1e-5, and its keys are gamma/beta."""
    jm, tm = _models("default")
    x = (np.random.default_rng(0).standard_normal((3, 32)) * 1e-3) \
        .astype(np.float32)
    p = {"gamma": np.ones(32, np.float32), "beta": np.zeros(32, np.float32)}
    want = np.asarray(jm._ln(jnp.asarray(x), {k: jnp.asarray(v)
                                              for k, v in p.items()}))
    got = tm._ln(torch.from_numpy(x), {k: torch.from_numpy(v)
                                       for k, v in p.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert abs(got.std() - 1.0) < 1e-3     # eps 1e-5 would shrink it ~5x


def test_masked_capacity_ties_go_to_the_lowest_index():
    """Trap: ``lax.top_k`` returns ties lowest index first; the port's
    stable descending sort does the same (``torch.topk`` promises no
    order)."""
    flags = np.array([[0, 1, 0, 1, 0, 0, 1, 0],
                      [1, 0, 0, 0, 0, 0, 0, 1]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(flags), 5)
    got = torch.sort(torch.from_numpy(flags), dim=1, descending=True,
                     stable=True).indices[:, :5]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mlm_logits_run_in_the_compute_dtype_then_f32(jax_params):
    cfg = _cfgs()[1]
    cfg.compute_dtype = "bfloat16"
    tm = TransformerEncoder(cfg)
    tp = params_from_jax(jax_params, device="cpu")
    hidden = tm.encode(tp, torch.from_numpy(_batch(0)[0]))
    assert hidden.dtype == torch.bfloat16
    logits = tm.mlm_logits(tp, hidden)
    assert logits.dtype == torch.bfloat16
    ids, labels, mask_pos, _ = _batch(0)
    loss = tm.mlm_loss(tp, *(torch.from_numpy(a) for a in
                             (ids, labels, mask_pos)), train=False)
    assert loss.dtype == torch.float32


def test_dropout_draws_from_the_generator(jax_params):
    cfg = _cfgs()[1]
    cfg.dropout = 0.1
    tm = TransformerEncoder(cfg, attn_impl="flash")
    tp = params_from_jax(jax_params, device="cpu")
    ids = torch.from_numpy(_batch(0)[0])

    def run(seed, train=True):
        g = torch.Generator().manual_seed(seed)
        return tm.encode(tp, ids, train=train, generator=g)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(0, train=False), tm.encode(tp, ids))
    assert not torch.equal(a, tm.encode(tp, ids))


def test_train_config_matches_bench():
    """The training cell's model: ``bert_base()`` has 108,922,170
    parameters in the JAX layout."""
    tm = TransformerEncoder(bert_base(), attn_impl="flash")
    shapes = jax.eval_shape(JaxEncoder(jax_bert_base()).init_params,
                            jax.random.key(0))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == 108_922_170
    assert isinstance(tm.cfg, TransformerConfig)
