"""PyTorch port, serving: ``deeplearning4j_tpu_torch/serving/engine.py``
on the CPU (``device="cpu"``, where attention takes the plain
reference) against the JAX ``DecodeEngine(attn_mode="xla")`` and the
port's dense ``generate()``, at f32 on a tiny model with the JAX
model's parameters.

Greedy tokens must be identical across all three for mixed prompt and
decode lengths, staggered joins and an active ``eos_id``. Sampling is
held to determinism per seed (the two frameworks draw different random
numbers, so sampled tokens are not compared across them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.gpt import CausalLM as JaxCausalLM
from deeplearning4j_tpu.models.transformer import tiny_config as jax_tiny
from deeplearning4j_tpu.serving import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu_torch.models.gpt import CausalLM, params_from_jax
from deeplearning4j_tpu_torch.models.transformer import tiny_config
from deeplearning4j_tpu_torch.serving.engine import (CapacityRejected,
                                                      DecodeEngine)

VOCAB = 13
ENGINE_KW = dict(slots=3, page_size=4, max_context=32, max_chunk=4,
                 prefill_buckets=[8, 16])


@pytest.fixture(scope="module")
def models():
    kw = dict(vocab=VOCAB, max_len=48, d_model=32, n_layers=2, n_heads=4,
              d_ff=64)
    jcfg, tcfg = jax_tiny(**kw), tiny_config(**kw)
    jcfg.dropout = tcfg.dropout = 0.0
    jm = JaxCausalLM(jcfg, compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.key(1))
    tm = CausalLM(tcfg, compute_dtype=torch.float32)
    return jm, jp, tm, params_from_jax(jax.device_get(jp), device="cpu")


def _engine(models, **kw):
    _, _, tm, tp = models
    return DecodeEngine(tm, tp, device="cpu", **{**ENGINE_KW, **kw})


def _jobs():
    """(prompt, max_new) with mixed lengths: more requests than slots, so
    later ones join as earlier ones finish."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, VOCAB, (t0,)).astype(np.int32), new)
            for t0, new in ((6, 6), (9, 3), (3, 11), (12, 5), (4, 9),
                            (16, 7), (7, 2))]


def _serve(eng, jobs, eos=None, stagger=3):
    """Submit the first ``stagger`` jobs, wait for the first to finish,
    then submit the rest (staggered joins); return every result."""
    eos = eos or {}
    reqs = [eng.submit(p, n, eos_id=eos.get(i))
            for i, (p, n) in enumerate(jobs[:stagger])]
    reqs[0].result(timeout=120)
    reqs += [eng.submit(p, n, eos_id=eos.get(i + stagger))
             for i, (p, n) in enumerate(jobs[stagger:])]
    return [np.asarray(r.result(timeout=120)) for r in reqs]


def test_greedy_tokens_match_jax_engine_and_generate(models):
    jm, jp, tm, tp = models
    jobs = _jobs()
    solo = [tm.generate(tp, p[None], n)[0].numpy() for p, n in jobs]
    # eos on request 2 at its 4th token: it must stop there (inclusive)
    eos = {2: int(solo[2][3])}
    cut = list(solo[2]).index(eos[2]) + 1
    with _engine(models) as eng:
        got = _serve(eng, jobs, eos)
        stats = eng.stats()
    jeng = JaxDecodeEngine(jm, jp, attn_mode="xla", warm_start=False,
                           **ENGINE_KW)
    try:
        want = _serve(jeng, jobs, eos)
    finally:
        jeng.shutdown()
    for i, (g, w, s) in enumerate(zip(got, want, solo)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(g, s[:cut] if i == 2 else s,
                                      err_msg=f"request {i}")
    assert stats["completed"] == len(jobs)
    assert stats["tokens"] == sum(len(g) for g in got)
    assert stats["kv_pages"]["allocated"] == 0
    assert stats["decode_steps"] > 0 and stats["bursts"] > 0


def test_pool_drains_and_shutdown_stops_the_thread(models):
    eng = _engine(models)
    reqs = [eng.submit(p, n) for p, n in _jobs()]
    outs = [r.result(timeout=120) for r in reqs]
    assert [len(o) for o in outs] == [n for _, n in _jobs()]
    assert all(r.finish_reason == "length" for r in reqs)
    assert all(r.ttft_s is not None and r.latency_s >= r.ttft_s
               for r in reqs)
    eng.shutdown()
    assert not eng._thread.is_alive()
    assert eng.pool.allocated == 0 and eng.pool.high_water > 0
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(_jobs()[0][0], 2)


def test_shutdown_fails_queued_requests(models):
    eng = _engine(models, slots=1)
    reqs = [eng.submit(p, 30 - len(p) if len(p) < 16 else 10)
            for p, _ in _jobs()]
    eng.shutdown()
    failed = [r for r in reqs if r.finish_reason == "error"]
    assert failed, "a queued request outlived the engine"
    for r in failed:
        with pytest.raises(RuntimeError):
            r.result(timeout=1)
    assert eng.pool.allocated == 0


def test_engine_death_fails_pending(models, monkeypatch):
    eng = _engine(models)

    def boom():
        raise RuntimeError("injected decode failure")

    monkeypatch.setattr(eng, "_decode_step", boom)
    try:
        req = eng.submit(_jobs()[0][0], 4)
        with pytest.raises(RuntimeError, match="injected"):
            req.result(timeout=60)
        eng._thread.join(timeout=10)
        assert not eng._thread.is_alive()
        with pytest.raises(RuntimeError):
            eng.submit(_jobs()[0][0], 4)
    finally:
        eng.shutdown()
    assert eng.pool.allocated == 0


def test_stream_yields_the_result(models):
    p, n = _jobs()[3]
    with _engine(models) as eng:
        req = eng.submit(p, n)
        streamed = list(req.stream())
        assert streamed == list(req.result(timeout=60))
        assert np.array_equal(eng.generate(p, n), req.result())


@pytest.mark.parametrize("prompt, new, match", [
    (np.zeros((2, 4), np.int32), 3, "ONE sequence"),
    (np.zeros((0,), np.int32), 3, "empty prompt"),
    (np.zeros((4,), np.int32), 0, "max_new_tokens"),
    (np.zeros((20,), np.int32), 13, "exceeds max_context"),
])
def test_submit_validation(models, prompt, new, match):
    eng = _engine(models)
    try:
        with pytest.raises(ValueError, match=match):
            eng.submit(prompt, new)
    finally:
        eng.shutdown()


def test_admission_queue_is_bounded(models, monkeypatch):
    """max_queue bounds queued plus head-of-line-waiting requests; a
    scheduler that admits nothing makes the bound deterministic."""
    eng = _engine(models, max_queue=2)
    monkeypatch.setattr(eng, "_admit_waiting", lambda: None)
    try:
        reqs = [eng.submit(p, 2) for p, _ in _jobs()[:2]]
        with pytest.raises(CapacityRejected, match="queue full"):
            eng.submit(_jobs()[2][0], 2)
    finally:
        eng.shutdown()
    assert [r.finish_reason for r in reqs] == ["error", "error"]


def test_request_larger_than_pool_is_rejected(models):
    eng = _engine(models, n_pages=4)       # 3 usable pages of 4 positions
    try:
        with pytest.raises(ValueError, match="more KV pages"):
            eng.submit(np.zeros((8,), np.int32), 6)
        assert len(eng.submit(np.zeros((8,), np.int32), 4).result(60)) == 4
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw, match", [
    (dict(slots=0), "at least one slot"),
    (dict(max_chunk=3), "power of two"),
    (dict(prefill_buckets=[6]), "multiple of page_size"),
    (dict(max_context=2), "page_size"),
])
def test_engine_argument_validation(models, kw, match):
    with pytest.raises(ValueError, match=match):
        _engine(models, **kw)


def test_sampled_tokens_are_deterministic_per_seed(models):
    jobs = _jobs()[:4]

    def run(seeds, alone=False):
        with _engine(models) as eng:
            if alone:
                return [eng.submit(p, n, temperature=0.8,
                                   sample_seed=s).result(60)
                        for (p, n), s in zip(jobs, seeds)]
            reqs = [eng.submit(p, n, temperature=0.8, sample_seed=s)
                    for (p, n), s in zip(jobs, seeds)]
            return [r.result(60) for r in reqs]

    a = run([1, 2, 3, 4])
    b = run([1, 2, 3, 4], alone=True)      # other neighbours, same draws
    c = run([5, 6, 7, 8])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, z) for x, z in zip(a, c))
    assert all(x.min() >= 0 and x.max() < VOCAB for x in a)


def test_default_sample_seeds_follow_the_engine_seed(models):
    p, n = _jobs()[2]

    def run(seed):
        with _engine(models, seed=seed) as eng:
            return eng.submit(p, n, temperature=1.0).result(60)

    np.testing.assert_array_equal(run(3), run(3))
