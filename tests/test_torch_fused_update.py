"""PyTorch port, fused Adam master update and the Adam updater:
``deeplearning4j_tpu_torch/ops/fused_update.py`` and ``learning/
updaters.py`` against ``deeplearning4j_tpu/ops/fused_update_pallas.py``
and ``learning/updaters.py`` on the same numpy inputs at f32.

The golden is the JAX package's own (tests/test_update_sharding.py
``TestFusedKernelGolden``): step 300, a loss scale and a global-norm
clip, against JAX ``fused_master_update`` with ``mode="xla"`` (its
formula) and ``mode="interpret"`` (the Pallas kernel through the
interpreter). Tolerance rtol 1e-6, atol 1e-7, as the JAX golden states.

The CUDA kernel runs only on the card: its tests carry the ``cuda``
marker and skip without one, and import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_fused_update.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.learning.updaters import Adam, IUpdater
from deeplearning4j_tpu_torch.ops import fused_update as fu

GOLD = dict(rtol=1e-6, atol=1e-7)


def _golden_inputs(n=2000, seed=3):
    rs = np.random.RandomState(seed)
    master = rs.randn(n).astype(np.float32)
    m = (rs.randn(n) * 0.01).astype(np.float32)
    v = (np.abs(rs.randn(n)) * 1e-4).astype(np.float32)
    grad = (rs.randn(n) * 2 ** 12).astype(np.float32)
    return master, m, v, grad


def _port_update(master, m, v, grad, step=300, **kw):
    bufs = [torch.from_numpy(a.copy()) for a in (master, m, v, grad)]
    out = fu.fused_master_update(*bufs, step, Adam(3e-4), **kw)
    for o, b in zip(out, bufs):
        assert o is b                           # updated in place
    return [b.numpy() for b in bufs[:3]]


@pytest.mark.parametrize("mode", ["xla", "interpret"])
def test_step300_golden_matches_jax(mode):
    import jax.numpy as jnp

    from deeplearning4j_tpu.learning.updaters import Adam as JaxAdam
    from deeplearning4j_tpu.ops.fused_update_pallas import (
        fused_master_update as jax_fused)

    master, m, v, grad = _golden_inputs()
    want = jax_fused(*(jnp.asarray(a) for a in (master, m, v, grad)),
                     jnp.asarray(300), JaxAdam(3e-4),
                     inv_scale=jnp.asarray(2.0 ** -12), clip_norm=0.5,
                     mode=mode)
    got = _port_update(master, m, v, grad, inv_scale=2.0 ** -12,
                       clip_norm=0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **GOLD)


@pytest.mark.parametrize("inv_scale, clip", [(None, None), (2.0 ** -12, None),
                                             (None, 0.5), (2.0 ** -12, 0.5)])
@pytest.mark.parametrize("step", [0, 300])
def test_scalars_match_jax(step, inv_scale, clip):
    import jax.numpy as jnp

    from deeplearning4j_tpu.learning.updaters import Adam as JaxAdam
    from deeplearning4j_tpu.ops.fused_update_pallas import adam_update_scalars

    norm = 1234.5
    kw = dict(inv_scale=inv_scale, clip_norm=clip,
              grad_norm=None if clip is None else norm)
    want = np.asarray(adam_update_scalars(JaxAdam(3e-4), jnp.asarray(step),
                                          **kw))
    got = fu.adam_update_scalars(Adam(3e-4), step, **kw)
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


def test_alpha_uses_t_equal_step_plus_one_in_f32():
    """Trap: alpha = lr * sqrt(1 - b2^t) / (1 - b1^t) with t = step + 1,
    powers in f32."""
    upd = Adam(1e-4)
    alpha = float(fu.adam_update_scalars(upd, 0)[1])
    f = np.float32
    want = f(1e-4) * np.sqrt(f(1) - f(0.999) ** f(1)) / (f(1) - f(0.9) ** f(1))
    assert alpha == pytest.approx(float(want), rel=1e-7)
    # 1 - 0.999 in f32 is 0.99998713e-3: 7e-6 off the real value
    assert alpha == pytest.approx(1e-4 * 0.001 ** 0.5 / 0.1, rel=1e-4)
    assert np.isfinite(alpha)                # t = 0 would divide 0 by 0


@pytest.mark.parametrize("step", [0, 300])
def test_adam_apply_matches_jax(step):
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.learning.updaters import Adam as JaxAdam

    rng = np.random.default_rng(step)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": [{"b": rng.standard_normal(5).astype(np.float32)}]}
    grads = jax.tree_util.tree_map(lambda a: a * 0.1 + 0.01, tree)
    jadam, tadam = JaxAdam(1e-3), Adam(1e-3)
    jstate = jadam.init_state(tree)
    jstate = jax.tree_util.tree_map(lambda a: a + 0.5, jstate)
    tstate = {k: {"w": torch.from_numpy(np.array(s["w"])),
                  "layers": [{"b": torch.from_numpy(
                      np.array(s["layers"][0]["b"]))}]}
              for k, s in jstate.items()}
    tgrads = {"w": torch.from_numpy(grads["w"]),
              "layers": [{"b": torch.from_numpy(grads["layers"][0]["b"])}]}
    jupd, jnew = jadam.apply(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                            grads), step)
    tupd, tnew = tadam.apply(tstate, tgrads, step)
    for a, b in ((tupd["w"], jupd["w"]),
                 (tupd["layers"][0]["b"], jupd["layers"][0]["b"]),
                 (tnew["v"]["w"], jnew["v"]["w"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GOLD)


def test_init_state_is_zero_f32_and_distinct():
    p = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.ones(2, 2)]}
    st = Adam().init_state(p)
    assert st["m"]["a"].dtype == torch.float32
    assert float(st["m"]["a"].abs().sum() + st["v"]["b"][0].abs().sum()) == 0
    assert st["m"]["a"].data_ptr() != st["v"]["a"].data_ptr()


def test_rejects_non_adam():
    @dataclasses.dataclass
    class Sgd(IUpdater):
        learning_rate: float = 0.1

    z = torch.zeros(8)
    with pytest.raises(TypeError, match="Adam"):
        fu.fused_master_update(z, z.clone(), z.clone(), z.clone(), 0, Sgd())


def test_learning_rate_schedule_is_not_ported():
    class Schedule:
        def value_at(self, step):
            return 1e-3

    with pytest.raises(NotImplementedError, match="schedule"):
        Adam(learning_rate=Schedule()).bias_corrected_lr(0)


def test_cpu_path_is_the_reference_and_launches_nothing():
    master, m, v, grad = _golden_inputs(n=37)
    before = fu.launches
    got = _port_update(master, m, v, grad, step=4)
    sc = fu.adam_update_scalars(Adam(3e-4), 4)
    want = fu.adam_update_reference(*(torch.from_numpy(a) for a in
                                      (master, m, v, grad)), sc[0], sc[1],
                                    0.9, 0.999, 1e-8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
    assert fu.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros(8)
    before = fu.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fu.fused_adam_update(z, z.clone(), z.clone(), z.clone(), 1.0, 1e-3,
                             beta1=0.9, beta2=0.999, eps=1e-8)
    assert fu.launches == before


@pytest.mark.parametrize("bad, match", [
    (dict(dtype=torch.float64), "float32"),
    (dict(shape=(2, 4)), "flat vector"),
    (dict(m_len=7), "differ in length"),
    (dict(same=True), "distinct"),
    (dict(noncontig=True), "contiguous"),
])
def test_kernel_argument_checks(bad, match):
    master = torch.zeros(bad.get("shape", (8,)),
                         dtype=bad.get("dtype", torch.float32))
    m = torch.zeros(bad.get("m_len", master.shape[-1]))
    v = master if bad.get("same") else torch.zeros(8)
    g = torch.zeros(16)[::2] if bad.get("noncontig") else torch.zeros(8)
    with pytest.raises((TypeError, ValueError), match=match):
        fu._check_kernel_args(master, m, v, g)


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("n, offset", [(2000, 0), (1 << 20, 0),
                                       (1_000_003, 0), (4099, 1)])
def test_cuda_kernel_matches_reference(n, offset):
    """Kernel against the plain version on the same CUDA inputs, step 300
    with a loss scale and a clip. ``offset`` 1 misaligns every buffer by
    one element, which takes the kernel's scalar path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bufs = [torch.from_numpy(a).cuda()
            for a in _golden_inputs(n=n + offset)]
    master, m, v, grad = (b[offset:] for b in bufs)
    sc = fu.adam_update_scalars(Adam(3e-4), 300, inv_scale=2.0 ** -12,
                                clip_norm=0.5,
                                grad_norm=torch.linalg.vector_norm(grad))
    want = fu.adam_update_reference(master, m, v, grad, sc[0], sc[1],
                                    0.9, 0.999, 1e-8)
    before = fu.launches
    got = fu.adam_segment_update(master, m, v, grad, sc, beta1=0.9,
                                 beta2=0.999, eps=1e-8)
    torch.cuda.synchronize()
    assert fu.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GOLD)


@pytest.mark.cuda
def test_cuda_first_step_from_zero_moments():
    """Step 0 from m = v = 0, the train step's first call: v' is
    (1 - beta2) g^2 alone, so the kernel must round 1 - beta2 from the
    double, as the plain version does (from a rounded beta2 it is 1.3e-5
    off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    master, _, _, grad = (torch.from_numpy(a).cuda()
                          for a in _golden_inputs(n=1 << 16))
    m, v = torch.zeros_like(master), torch.zeros_like(master)
    sc = fu.adam_update_scalars(Adam(1e-4), 0)
    want = fu.adam_update_reference(master, m, v, grad, sc[0], sc[1],
                                    0.9, 0.999, 1e-8)
    got = fu.adam_segment_update(master, m, v, grad, sc, beta1=0.9,
                                 beta2=0.999, eps=1e-8)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GOLD)
