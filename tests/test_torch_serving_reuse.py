"""PyTorch port, the rest of the serving engine: prefix cache, sticky
sessions, speculative decoding, int8 decode weights, fp8 KV pages and
cancellation in ``deeplearning4j_tpu_torch/serving/engine.py`` on the CPU
(``device="cpu"``: attention takes the plain reference), against the JAX
``DecodeEngine(attn_mode="xla", warm_start=False)`` with the same
options, at f32 on a tiny model (2 layers, d_model 64, 4 heads, page 4)
with the JAX model's parameters.

Greedy tokens must be identical to the JAX engine's, and — where the
option is exact (prefix cache, sessions, speculation) — to a cold solo
``generate()``. Requests are submitted one after another where the
order decides what the cache holds, so both engines see the same
history.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.gpt import CausalLM as JaxCausalLM
from deeplearning4j_tpu.models.transformer import tiny_config as jax_tiny
from deeplearning4j_tpu.serving import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu.serving.spec_decode import SpecConfig as JaxSpec
from deeplearning4j_tpu_torch.models.gpt import CausalLM, params_from_jax
from deeplearning4j_tpu_torch.models.transformer import tiny_config
from deeplearning4j_tpu_torch.serving import kv_pages
from deeplearning4j_tpu_torch.serving.engine import DecodeEngine
from deeplearning4j_tpu_torch.serving.spec_decode import SpecConfig

VOCAB = 13
ENGINE_KW = dict(slots=3, page_size=4, max_context=48, max_chunk=2,
                 prefill_buckets=[8, 16, 32])


@pytest.fixture(scope="module")
def models():
    kw = dict(vocab=VOCAB, max_len=48, d_model=64, n_layers=2, n_heads=4,
              d_ff=128)
    jcfg, tcfg = jax_tiny(**kw), tiny_config(**kw)
    jcfg.dropout = tcfg.dropout = 0.0
    jm = JaxCausalLM(jcfg, compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.key(3))
    tm = CausalLM(tcfg, compute_dtype=torch.float32)
    return jm, jp, tm, params_from_jax(jax.device_get(jp), device="cpu")


def _port(models, **kw):
    _, _, tm, tp = models
    return DecodeEngine(tm, tp, device="cpu", **{**ENGINE_KW, **kw})


def _jax(models, **kw):
    jm, jp, _, _ = models
    return JaxDecodeEngine(jm, jp, attn_mode="xla", warm_start=False,
                           **{**ENGINE_KW, **kw})


def _solo(models, prompt, n):
    _, _, tm, tp = models
    return tm.generate(tp, np.asarray(prompt)[None], n)[0].numpy()


def _run(eng, jobs, concurrent=False):
    """Serve ``jobs`` ((prompt, max_new, session_id) or (prompt,
    max_new)) and shut down; returns (tokens, stats before shutdown)."""
    try:
        if concurrent:
            reqs = [eng.submit(j[0], j[1]) for j in jobs]
            outs = [np.asarray(r.result(timeout=120)) for r in reqs]
        else:
            outs = []
            for j in jobs:
                sid = j[2] if len(j) > 2 else None
                outs.append(np.asarray(
                    eng.submit(j[0], j[1], session_id=sid).result(120)))
        stats = eng.stats()
    finally:
        eng.shutdown()
    return outs, stats


def _mk(rng, n):
    return rng.integers(0, VOCAB, (n,)).astype(np.int32)


def _mixed_jobs(seed=0):
    rng = np.random.default_rng(seed)
    return [(_mk(rng, t0), new) for t0, new in
            ((5, 9), (9, 4), (3, 14), (12, 2), (7, 11), (6, 6))]


# ----------------------------------------------- prefix cache + sessions
def test_prefix_cache_and_session_resume_match_jax_and_cold(models):
    """A full-page prefix hit, a mid-page copy-on-write hit and a
    two-turn session resume (the second turn starts mid-page): the same
    greedy tokens as the JAX engine and as cold generate(); the pool
    drains at shutdown."""
    rng = np.random.default_rng(0)
    shared = _mk(rng, 10)
    conv1 = _mk(rng, 9)
    jobs = [(np.concatenate([shared, _mk(rng, 3)]), 5, None),
            (np.concatenate([shared, _mk(rng, 2)]), 6, None),   # CoW
            (np.concatenate([shared[:8], [(shared[8] + 1) % VOCAB],
                             _mk(rng, 3)]).astype(np.int32), 5, None),
            (conv1, 6, "conv"),
            (_mk(rng, 6), 4, None)]
    reuse = dict(prefix_cache=True, session_capacity=2)
    port = _port(models, **reuse)
    got, st = _run(port, jobs)
    # second turn: the whole first turn, then new tokens
    turn2 = np.concatenate([conv1, got[3], _mk(rng, 4)])
    jobs2 = jobs + [(turn2, 7, "conv")]
    port = _port(models, **reuse)
    got, st = _run(port, jobs2)
    want, jst = _run(_jax(models, **reuse), jobs2)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(g, _solo(models, jobs2[i][0],
                                               jobs2[i][1]),
                                      err_msg=f"request {i} vs cold")
    ps = st["prefix_cache"]
    assert st["warm_admissions"] == 3      # CoW hit, full hit, resume
    assert ps["hits"] == 3 and ps["hit_tokens_total"] == 10 + 8 + 14
    assert ps["sessions"]["resumed_total"] == 1
    for k in ("hits", "misses", "hit_tokens_total", "inserted_pages"):
        assert ps[k] == jst["prefix_cache"][k], k
    assert port.pool.allocated == 0


def test_shared_pages_refcounts_and_eviction_under_pressure(models):
    """A pool too small for cache and session pins together: admission
    evicts cold cache leaves and the oldest session instead of
    starving; tokens still match cold generate()."""
    rng = np.random.default_rng(1)
    shared = _mk(rng, 8)
    jobs = [(np.concatenate([shared, _mk(rng, 4)]), 6, f"s{i}")
            for i in range(4)]
    eng = _port(models, prefix_cache=True, session_capacity=4, n_pages=12,
                slots=1)
    got, st = _run(eng, jobs)
    for (p, n, _), g in zip(jobs, got):
        np.testing.assert_array_equal(g, _solo(models, p, n))
    assert st["prefix_cache"]["hits"] >= 3
    assert st["kv_pages"]["high_water"] <= 11
    assert eng.pool.allocated == 0


# --------------------------------------------------- speculative decode
@pytest.mark.parametrize("k", [2, 4])
def test_spec_greedy_matches_jax_and_plain(models, k):
    jobs = _mixed_jobs()
    got, st = _run(_port(models, spec_decode=k), jobs, concurrent=True)
    want, jst = _run(_jax(models, spec_decode=k), jobs, concurrent=True)
    for i, ((p, n), g, w) in enumerate(zip(jobs, got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(g, _solo(models, p, n),
                                      err_msg=f"request {i} vs plain")
    assert st["spec"]["verify_dispatches"] > 0
    assert st["spec"]["proposed"] > 0


class _RejectedDraft:
    """Drafts the target never accepts: the true greedy continuation of
    the history, every token shifted by one. Each verify pass then
    emits only the correction and rewinds every draft's K/V."""

    def __init__(self, models):
        self.models = models

    def propose(self, history, k):
        true = _solo(self.models, np.asarray(history, np.int32), k)
        return ((true + 1) % VOCAB).astype(np.int32)


def test_spec_all_rejected_drafts_equal_plain(models):
    jobs = _mixed_jobs(1)
    spec = SpecConfig(k=3, draft=_RejectedDraft(models))
    got, st = _run(_port(models, spec_decode=spec), jobs, concurrent=True)
    for (p, n), g in zip(jobs, got):
        np.testing.assert_array_equal(g, _solo(models, p, n))
    spec = st["spec"]
    assert spec["proposed"] > 0 and spec["accepted"] == 0
    assert spec["tokens_per_dispatch"] == 1.0


def test_spec_opt_out_and_sampling_stay_in_range(models):
    jobs = _mixed_jobs(2)[:4]
    with _port(models, spec_decode=2) as eng:
        a = eng.submit(jobs[0][0], jobs[0][1], spec_decode=False)
        b = eng.submit(jobs[1][0], 12, temperature=0.9, sample_seed=4)
        outs = [a.result(60), b.result(60)]
    np.testing.assert_array_equal(outs[0], _solo(models, *jobs[0]))
    assert a.spec_proposed == 0
    assert len(outs[1]) == 12 and outs[1].max() < VOCAB
    with _port(models, spec_decode=2) as eng:
        again = eng.submit(jobs[1][0], 12, temperature=0.9,
                           sample_seed=4).result(60)
    np.testing.assert_array_equal(again, outs[1])


# ------------------------------------------------------- int8 and fp8
def test_int8_tree_is_jax_bit_for_bit_and_tokens_match(models):
    jobs = _mixed_jobs(3)
    port = _port(models, quantization="int8")
    jeng = _jax(models, quantization="int8")
    tq, jq = port._decode_params, jeng._decode_params
    for name, axis in (("tok_emb", 0),):
        np.testing.assert_array_equal(tq[name]["q"].numpy(),
                                      np.asarray(jq[name]["q"]))
        np.testing.assert_array_equal(tq[name]["s"].numpy(),
                                      np.asarray(jq[name]["s"]))
    for tl, jl in zip(tq["layers"], jq["layers"]):
        for w in ("wqkv", "wo", "w1", "w2"):
            assert tl[w]["q"].dtype == torch.int8
            np.testing.assert_array_equal(tl[w]["q"].numpy(),
                                          np.asarray(jl[w]["q"]))
            np.testing.assert_array_equal(tl[w]["s"].numpy(),
                                          np.asarray(jl[w]["s"]))
    got, st = _run(port, jobs, concurrent=True)
    want, _ = _run(jeng, jobs, concurrent=True)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert st["quantization"] == "int8"


def test_fp8_pools_and_tokens_match_jax(models):
    """fp8 KV pages: the same greedy tokens as the JAX fp8 engine, and
    after the run the same pool bytes and scale planes (page 0 aside).
    The K/V inputs agree to ~1e-7, far below an e4m3 step."""
    jobs = _mixed_jobs(4)
    port = _port(models, kv_dtype="fp8_e4m3")
    jeng = _jax(models, kv_dtype="fp8_e4m3")
    got, st = _run(port, jobs)
    want, _ = _run(jeng, jobs)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    jkv = jeng.pool.tree()
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            port.pool.tree()[name].view(torch.uint8)[:, 1:].numpy(),
            np.asarray(jkv[name]).view(np.uint8)[:, 1:], err_msg=name)
        np.testing.assert_array_equal(
            port.pool.tree()[name + "_scale"][:, 1:].numpy(),
            np.asarray(jkv[name + "_scale"])[:, 1:])
    assert st["kv_dtype"] == "fp8_e4m3"
    assert st["kv_pages"]["page_bytes"] == jeng.pool.bytes_per_page()
    assert port.pool.allocated == 0


# --------------------------------------------------------- cancellation
def test_cancel_mid_flight_frees_the_slot_and_spares_neighbours(models):
    """A client thread cancels one decoding request and one queued
    request while the scheduler is held inside a burst: the decoding one
    keeps its tokens so far, the queued one never runs, the neighbours'
    tokens equal solo generate(), and the pool drains to zero."""
    import threading

    jobs = _mixed_jobs(5)[:3] + [(np.arange(4, dtype=np.int32), 8)]
    victim_new = 30
    eng = _port(models, slots=3)
    held, released = threading.Event(), threading.Event()
    emit = eng._emit

    def gated_emit(s, token):
        emit(s, token)
        req = eng._slot_req[s]
        if req is victim and len(req.tokens) == 3 and not held.is_set():
            held.set()
            released.wait(30)

    eng._emit = gated_emit
    try:
        first = eng.submit(*jobs[0])
        victim = eng.submit(jobs[1][0], victim_new)
        third = eng.submit(*jobs[2])
        queued = eng.submit(*jobs[3])
        assert held.wait(60)
        assert victim.cancel() and queued.cancel()
        released.set()
        outs = [first.result(60), third.result(60)]
        assert victim.result(60).size >= 3 and queued.result(60).size == 0
        assert eng.drain(timeout=60)
        assert not victim.cancel()             # already finished
    finally:
        eng.shutdown()
    assert victim.finish_reason == "cancelled"
    assert queued.finish_reason == "cancelled"
    solo_v = _solo(models, jobs[1][0], victim_new)
    np.testing.assert_array_equal(victim.tokens, solo_v[:len(victim.tokens)])
    assert len(victim.tokens) < victim_new
    np.testing.assert_array_equal(outs[0], _solo(models, *jobs[0]))
    np.testing.assert_array_equal(outs[1], _solo(models, *jobs[2]))
    assert eng.pool.allocated == 0 and eng.idle


# ------------------------------------------------------ construction
def test_new_options_refuse_the_cpu_unless_asked(models, monkeypatch):
    _, _, tm, tp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tm, tp, prefix_cache=True, session_capacity=2,
                     spec_decode=2, quantization="int8",
                     kv_dtype="fp8_e4m3")


@pytest.mark.parametrize("kw, err, match", [
    (dict(handoff_threshold=8), NotImplementedError, "A7.6"),
    (dict(warm_source=object()), NotImplementedError, "A7.6"),
    (dict(quantization="int4"), ValueError, "quantization"),
    (dict(kv_dtype="fp4"), ValueError, "kv_dtype"),
    (dict(spec_decode="medusa"), ValueError, "spec_decode"),
])
def test_engine_option_validation(models, kw, err, match):
    with pytest.raises(err, match=match):
        _port(models, **kw)


def test_submit_prepared_and_stats_fields(models):
    eng = _port(models, prefix_cache=True, session_capacity=1, spec_decode=2)
    try:
        with pytest.raises(NotImplementedError, match="A7.6"):
            eng.submit_prepared(np.arange(3), 2)
        st = eng.stats()
        assert st["spec"]["k"] == 2 and st["prefix_cache"]["enabled"]
        assert eng.prefix_stats()["sessions_enabled"]
        assert not eng.release_session("absent")
        p = np.arange(9, dtype=np.int32) % VOCAB
        assert eng._shared_pages_hint(p, None) == 0
        eng.submit(p, 3).result(60)
        assert eng._shared_pages_hint(p, None) == 2
        assert kv_pages.pages_needed(12, 4) - eng._shared_pages_hint(
            p, None) == 1
    finally:
        eng.shutdown()
    assert eng.pool.allocated == 0


def test_spec_config_resolves_like_jax():
    for spec in (None, False, True, 3, "ngram", {"k": 5, "match_len": 2}):
        a, b = SpecConfig.resolve(spec), JaxSpec.resolve(spec)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.k, a.draft, a.match_len) == (b.k, b.draft, b.match_len)
