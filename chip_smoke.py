#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions;
2. build: ``csrc/paged_attention.cu``, ``csrc/flash_attention.cu``,
   ``csrc/fused_update.cu`` and ``csrc/lstm_recurrence.cu`` compiled from
   this checkout by ``nvcc`` for sm_90a, one ``nvcc`` per source, all
   started together;
3. kernel: the paged-attention kernel against its plain PyTorch version
   at the serving slice's shapes (N=8, H=12, hd=64, ps=16, P=32,
   Q in {1, 4}; f32 pools within 1e-5, bf16 pools within 2e-2 of the
   reference run at f32), then its time beside the plain version's,
   a page gather + ``scaled_dot_product_attention`` yardstick and the
   bound from the bytes it must move;
4. serve: the GPT-2-small-like model (12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 32000, max_len 512; random weights from a numpy
   seed in the JAX tree layout) behind ``DecodeEngine(slots=8,
   page_size=16, max_context=512)`` in bf16, serving 24 concurrent
   greedy requests; every decode step must have gone through the
   kernel. Then an f32 pass whose engine tokens must equal the dense
   ``CausalLM.generate()``;
5. train kernels: the flash-attention forward kernel against
   ``blockwise_attention`` (N=4, H=12, hd=64, T in {128, 77}; no mask,
   padded rows, padded rows plus one fully masked row; causal off and
   on; f32 within 2e-5, bf16 within 2e-2 of the f32 plain version on the
   bf16-rounded inputs), the backward kernels against autograd through
   ``blockwise_attention`` (f32 within 1e-4 of max |grad|, bf16 within
   2e-2), the fused Adam kernel against ``adam_update_reference`` (step
   300, loss scale and clip; n = 108,922,170 and an unaligned n; rtol
   1e-6, atol 1e-7); then, at the training shape (N=96, bf16), the
   forward and backward kernels against the f32 plain version again
   (within 2e-2, of max |grad| for the backward) and each kernel's time
   at the training shapes beside its plain version's, its bound and a
   library yardstick the port never calls;
6. train: BERT-base (``bert_base()``, 108.9 M parameters, random weights
   from a numpy seed in the JAX tree layout) with ``attn_impl="flash"``,
   bf16 compute and f32 masters in one flat buffer, MLM on a fixed batch
   of 96 x 128 tokens with 19 masked positions per row,
   ``masked_capacity=20``, dropout 0.1 from a seeded generator, Adam at
   lr 1e-4: 2 warm-up and 10 timed steps, every layer through the flash
   kernels and every step through one fused Adam launch; the loss must
   start near ln(vocab) and fall. Then a profiled window of 3 steps;
7. train parity: 2 layers at full width, batch 8 x 128, dropout 0, f32:
   3 MLM steps on the card (the kernels) and on the CPU (the plain
   versions) from the same numpy weights must agree (loss 1e-4
   relative, parameters 2e-5 absolute) and the card's update must have
   moved a parameter by at least half a step of lr, then one
   ``BertSequenceClassifier`` fine-tune step with a padding mask alike;
8. LSTM kernels: the recurrence forward and backward kernels against
   their plain versions (H=256, N in {1, 256}, T in {1, 50, 200}, and
   the sampling shapes T in {1, 64} at N=4; non-zero h0 and c0, with and
   without the cell stream; f32 within 1e-5, bf16 within 2e-2 of the f32
   plain version on the bf16-rounded inputs; the backward's d x_proj,
   d w_hh, dh0 and dc0 within 1e-4 (f32) and 2e-2 (bf16) of max |grad|,
   and the bf16 d w_hh within 2^-8 of max |grad| of the f32 sum over the
   kernel's own stored ys and cs), one shape outside the envelope that
   must raise, then at the char-LSTM training shape (N=256, T=200,
   H=256, bf16) each kernel's time beside its plain version's, its bound
   and a ``torch.nn.LSTM`` (cuDNN) yardstick the port never calls, with
   the port's projection matmul plus the kernel beside it (like with
   like);
9. char-LSTM training: ``TextGenerationLSTM(vocab_size=77, hidden=256)``
   (887,117 parameters, random weights from a numpy seed in the JAX
   layout) through ``MultiLayerNetwork.fit`` at ``bench_common.
   build_char_lstm``'s shape (batch 256 x 200 one-hot characters, labels
   the next character, bf16, standard BPTT, Adam 1e-3): 2 warm-up and 10
   timed steps, exactly 2 forward and 2 backward kernel launches per
   step, the per-character loss starting within 0.5 of ln 77 and falling;
   a profiled window of 3 steps; then the zoo's own tBPTT 50 at f32 on the
   same batch: one ``fit`` is 4 segments, 8 + 8 launches, 4 iterations;
10. LSTM parity: the zoo model (hidden 256, tBPTT 50, f32), 3 minibatches
   of 8 x 100 on the card (the kernels) and on the CPU (the plain
   versions) from the same numpy weights (loss 1e-5 relative, parameters
   2e-5 absolute, some parameter moved by at least lr/2); then, on the
   card, ``rnnTimeStep`` fed 64 characters one at a time (batch 4) equals
   ``output()`` over the sequence, and both equal the same network's
   ``output()`` on the CPU (the plain versions), within 1e-5; a changed
   batch size with stored state raises.

Prints progress lines, then a JSON line with every kernel's numbers, the
card's ``nvidia-smi`` line, and last the JSON result line.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.join(HERE, "deeplearning4j_tpu_torch")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the f32 rate
# outside the tensor cores and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# the training slice: bench.py's BERT-base MLM cell
TRAIN_BATCH, TRAIN_SEQ, MASKED_PER_ROW, MASKED_CAPACITY = 96, 128, 19, 20
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 2, 10, 3
KERNEL_SOURCES = ("paged_attention", "flash_attention", "fused_update",
                  "lstm_recurrence")

SLOTS, PAGE, HEADS, HEAD_DIM, LAYERS = 8, 16, 12, 64, 12
MAX_CONTEXT = 512
PAGES_PER_SLOT = MAX_CONTEXT // PAGE
DEVICE = "cuda"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------- device
def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    say("device", f"nvidia-smi: {line}")
    say("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"{torch.cuda.get_device_name(0)} x "
                  f"{torch.cuda.device_count()}")
    # state the f32 matmul precision: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


# ----------------------------------------------------------------- build
def phase_build() -> None:
    from deeplearning4j_tpu_torch.ops import native

    t0 = time.perf_counter()
    paths = native.build(KERNEL_SOURCES)
    say("build", f"{len(paths)} sources in {time.perf_counter() - t0:.2f} s")
    # ptxas -v for the instantiations the slices run: head_dim 64 is the
    # template argument 2 (vectors of 32) of paged attention and 64 of
    # flash attention; the Adam kernels have no template; the LSTM
    # kernels at one row per thread (the char-LSTM shape's plan)
    marks = {"paged_attention": "Li2E", "flash_attention": "Li64E",
             "fused_update": "", "lstm_recurrence": "Li1E"}
    for name in KERNEL_SOURCES:
        log = native.build_logs.get(name, {})
        say("build", f"{os.path.relpath(paths[name], HERE)}: "
                     f"{log.get('seconds', 0.0):.2f} s")
        lines = str(log.get("output", "")).splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and marks[name] in ln:
                found = re.search(r"(paged_attention_kernel|flash_fwd_kernel"
                                  r"|flash_bwd_[a-z]+_kernel"
                                  r"|fused_adam_(?:vec4|scalar)"
                                  r"|lstm_(?:fwd|bwd)_kernel)", ln)
                kind = "bf16" if "nv_bfloat16" in ln else "f32"
                info = [x.split(":", 1)[-1].strip()
                        for x in lines[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                say("build", f"  ptxas {found.group(1) if found else ln} "
                             f"({kind}): {'; '.join(info)}")


# ---------------------------------------------------------------- kernel
def kernel_case(Q: int, dtype: torch.dtype, seed: int, full: bool = False):
    """Pools [L, n_pages, H, ps, hd], queries and page tables at the
    slice's decode shapes. Mixed case: rows 0-1 share their first four
    pages (a shared prompt prefix), rows 2-3 end in null-page tails,
    row 0 attends at full context and row 1 at position 0. Full case:
    every row owns 32 distinct pages and attends at full context (the
    steady state of the timing)."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + SLOTS * PAGES_PER_SLOT
    shape = (LAYERS, n_pages, HEADS, PAGE, HEAD_DIM)
    kv = {n: torch.randn(shape, generator=g, device=dev).to(dtype)
          for n in ("k", "v")}
    q = torch.randn(SLOTS, HEADS, Q, HEAD_DIM, generator=g,
                    device=dev).to(dtype)
    tables = 1 + np.arange(SLOTS * PAGES_PER_SLOT, dtype=np.int32) \
        .reshape(SLOTS, PAGES_PER_SLOT)
    full_pos = PAGES_PER_SLOT * PAGE - Q
    if full:
        qbase = np.full((SLOTS,), full_pos, np.int32)
    else:
        rng = np.random.default_rng(seed)
        tables[1, :4] = tables[0, :4]
        real = {2: 5, 3: 1}
        for n, r in real.items():
            tables[n, r:] = 0
        qbase = rng.integers(0, full_pos + 1, SLOTS).astype(np.int32)
        qbase[0], qbase[1] = full_pos, 0
        for n, r in real.items():
            qbase[n] = rng.integers(0, r * PAGE - Q + 1)
    return (q, kv, torch.from_numpy(tables).to(dev),
            torch.from_numpy(qbase).to(dev))


def library_attention(q, kv, layer, tables, qbase):
    """Yardstick only, never called by the port: a page gather followed
    by ``scaled_dot_product_attention`` with the flat-position mask (two
    PyTorch calls, since no one library call walks a page table)."""
    N, H, Q, hd = q.shape
    P, ps = tables.shape[1], kv["k"].shape[3]

    def flat(pool):
        return pool[layer][tables.long()].permute(0, 2, 1, 3, 4) \
            .reshape(N, H, P * ps, hd)

    qpos = qbase.long()[:, None] + torch.arange(Q, device=q.device)
    mask = (torch.arange(P * ps, device=q.device)[None, None, None, :]
            <= qpos[:, None, :, None])
    return F.scaled_dot_product_attention(q, flat(kv["k"]), flat(kv["v"]),
                                          attn_mask=mask)


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(q, kv, tables, qbase):
    """(bound_ms, bound_by, bytes, flops) for one layer call on these
    inputs: each live K/V page read once (pages past the last query's
    position are masked and need not be read), q/tables/qbase read and
    the output written once; 4 * hd flops per admitted (query, key,
    head) in f32."""
    N, H, Q, hd = q.shape
    ps = kv["k"].shape[3]
    tab = tables.cpu().numpy()
    qb = qbase.cpu().numpy().astype(np.int64)
    live = set()
    admitted = 0
    for n in range(N):
        n_live = min(tab.shape[1], (int(qb[n]) + Q - 1) // ps + 1)
        live.update(int(p) for p in tab[n, :n_live])
        admitted += sum(min(int(qb[n]) + i + 1, tab.shape[1] * ps)
                        for i in range(Q))
    page_bytes = H * ps * hd * kv["k"].element_size()
    nbytes = (2 * len(live) * page_bytes + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + qbase.numel() * 4)
    flops = 4 * hd * H * admitted
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def phase_kernel() -> dict:
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    max_err = 0.0
    layer = 5
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for Q in (1, 4):
            for full in (False, True):
                q, kv, tables, qbase = kernel_case(Q, dtype, seed=Q,
                                                   full=full)
                got = pa.paged_attention(q, kv, layer, tables, qbase)
                want = pa.paged_attention_reference(
                    q.float(), {n: t.float() for n, t in kv.items()},
                    layer, tables, qbase)
                torch.cuda.synchronize()
                check(got.dtype == dtype and got.shape == q.shape,
                      f"kernel output {got.dtype} {tuple(got.shape)}")
                check(bool(torch.isfinite(got).all()),
                      "kernel output not finite")
                err = float((got.float() - want).abs().max())
                max_err = max(max_err, err)
                say("kernel", f"{str(dtype)[6:]} Q={Q} "
                              f"{'full' if full else 'mixed'}: max abs err "
                              f"{err:.3e} (tolerance {tol:g})")
                check(err <= tol, f"kernel disagrees with the reference: "
                                  f"{err:.3e} > {tol:g}")
    # the decode step's shape: bf16, Q=1, every slot at full context.
    # Launches cycle over the 12 layers (151 MB of pools, more than the
    # 50 MB L2) so each one reads its pages from HBM as a decode step does
    q, kv, tables, qbase = kernel_case(1, torch.bfloat16, seed=7, full=True)
    lib = library_attention(q, kv, 0, tables, qbase)
    ref = pa.paged_attention_reference(
        q.float(), {n: t.float() for n, t in kv.items()}, 0, tables, qbase)
    lib_err = float((lib.float() - ref).abs().max())
    say("kernel", f"yardstick gather+SDPA vs reference: max abs err "
                  f"{lib_err:.3e}")
    iters = 240
    kern_ms = cuda_ms(lambda i: pa.paged_attention_kernel(
        q, kv, i % LAYERS, tables, qbase), iters)
    plain_ms = cuda_ms(lambda i: pa.paged_attention_reference(
        q, kv, i % LAYERS, tables, qbase), iters)
    lib_ms = cuda_ms(lambda i: library_attention(
        q, kv, i % LAYERS, tables, qbase), iters)
    kern_ms2 = cuda_ms(lambda i: pa.paged_attention_kernel(
        q, kv, i % LAYERS, tables, qbase), iters)
    bound_ms, bound_by, nbytes, flops = attention_bound(q, kv, tables, qbase)
    say("kernel", f"decode shape N={SLOTS} H={HEADS} Q=1 hd={HEAD_DIM} "
                  f"ps={PAGE} P={PAGES_PER_SLOT} bf16, full context: "
                  f"kernel {kern_ms:.4f} / {kern_ms2:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library (gather + SDPA, two-call "
                  f"yardstick the port never calls) {lib_ms:.4f} ms")
    say("kernel", f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B at "
                  f"3.35 TB/s, {flops} flop at 67 TFLOP/s f32); kernel at "
                  f"{nbytes / (min(kern_ms, kern_ms2) * 1e-3) / 1e9:.1f} GB/s")
    return {"name": "paged_attention", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
            "replaces": "deeplearning4j_tpu/ops/paged_attention_pallas.py:203",
            "launches": 0, "max_abs_err": max_err,
            "ms": min(kern_ms, kern_ms2), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


# ----------------------------------------------------------------- serve
def tail_new_tokens(rng, lo: int, hi: int) -> int:
    """Truncated-exponential decode length over [lo, hi], the long tail
    of bench_gpt_decode.py's mixed traffic."""
    span = max(hi - lo, 0)
    return lo + int(min(rng.exponential(0.35 * span), span))


def serving_jobs(vocab: int, n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        t0 = int(rng.integers(16, 257))
        jobs.append((rng.integers(0, vocab, (t0,)).astype(np.int32),
                     tail_new_tokens(rng, 16, 128)))
    return jobs


def common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def serve_config():
    """The GPT-2-small-like configuration bench_gpt_decode.py serves."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=32000, max_len=MAX_CONTEXT,
                             d_model=768, n_layers=LAYERS, n_heads=HEADS,
                             d_ff=3072, dropout=0.0)


def device_profile(phase: str, what: str, run, focus) -> float:
    """Device busy share over ``run()`` from a torch.profiler trace: the
    kernels' device times summed over the window's wall time (one
    stream, so kernels do not overlap), the share of the kernels whose
    names hold each string of ``focus``, and the largest kernels by
    device time. Returns the busy milliseconds (0 when the profiler saw
    no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if busy_us == 0:
        say(phase, "torch.profiler saw no device time: device idle share "
                   "not measured")
        return 0.0
    say(phase, f"{what} in {wall_us / 1e3:.1f} ms: device busy "
               f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of the "
               f"window, idle {1 - busy_us / wall_us:.3f})")
    for key in focus:
        t = sum(v for n, v in by_name.items() if key in n)
        say(phase, f"  {key}*: {t / 1e3:.2f} ms ({t / busy_us:.3f} of "
                   f"device time)")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(phase, f"  {t / 1e3:9.2f} ms  {name[:100]}")
    return busy_us / 1e3


def profile_window(eng, jobs) -> None:
    """The device profile of one batch (prefill and decode) served by a
    running engine."""
    steps0 = eng.n_steps

    def run():
        for r in [eng.submit(p, n) for p, n in jobs]:
            r.result(timeout=600)

    device_profile("profile", f"{len(jobs)} requests", run,
                   ("paged_attention",))
    say("profile", f"  ({eng.n_steps - steps0} decode steps)")


def phase_serve(kernel_row: dict) -> None:
    from deeplearning4j_tpu_torch.models.gpt import (
        CausalLM, init_params_numpy, params_from_jax)
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg = serve_config()
    t0 = time.perf_counter()
    params = params_from_jax(init_params_numpy(cfg, seed=0), device=DEVICE)
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    say("serve", f"{CausalLM.num_params(params) / 1e6:.1f} M parameters "
                 f"(f32 master, bf16 compute) in "
                 f"{time.perf_counter() - t0:.1f} s")
    jobs = serving_jobs(cfg.vocab_size, 24)
    say("serve", f"{len(jobs)} greedy requests, prompts "
                 f"{min(len(p) for p, _ in jobs)}-"
                 f"{max(len(p) for p, _ in jobs)} tokens, max_new "
                 f"{min(n for _, n in jobs)}-{max(n for _, n in jobs)}")
    eng = DecodeEngine(model, params, slots=SLOTS, page_size=PAGE,
                       max_context=MAX_CONTEXT, device=DEVICE)
    with eng:
        say("serve", f"pool {eng.pool.n_pages} pages of "
                     f"{eng.pool.bytes_per_page()} B")
        eng.generate(jobs[0][0][:16], 4)          # first CUDA calls
        steps0, dec0 = eng.n_steps, eng.decode_seconds
        torch.cuda.synchronize()
        pa.launches = 0
        t0 = time.perf_counter()
        reqs = [eng.submit(p, n) for p, n in jobs]
        outs = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
        launches = pa.launches
        steps = eng.n_steps - steps0
        dec_s = eng.decode_seconds - dec0
        occupancy = eng.stats()["avg_occupancy"]
        profile_window(eng, serving_jobs(cfg.vocab_size, 8, seed=2))
    check(eng.pool.allocated == 0,
          f"pool did not drain: {eng.pool.allocated} pages allocated")
    for (p, n), out in zip(jobs, outs):
        check(len(out) == n, f"request returned {len(out)} of {n} tokens")
        check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
              "token outside the vocabulary")
    check(steps > 0 and launches == cfg.n_layers * steps,
          f"kernel launches {launches} != {cfg.n_layers} layers x "
          f"{steps} decode steps")
    kernel_row["launches"] = launches
    tokens = sum(len(o) for o in outs)
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    say("serve", f"{tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} "
                 f"tokens/s; TTFT p50 {np.percentile(ttft, 50):.1f} ms, "
                 f"p99 {np.percentile(ttft, 99):.1f} ms; decode "
                 f"{dec_s / steps * 1e3:.3f} ms/step over {steps} steps "
                 f"(avg occupancy {occupancy:.3f}); kernel launches "
                 f"{launches} = {cfg.n_layers} x {steps}")
    # bf16: agreement with the dense generate() is reported, not required
    # (one-ulp argmax ties on random weights are expected at bf16)
    same = agree = total = 0
    for (p, n), out in list(zip(jobs, outs))[:8]:
        dense = model.generate(params, p[None], n)[0].cpu().numpy()
        agree += common_prefix(out, dense)
        total += n
        same += int(np.array_equal(out, dense))
    say("serve", f"bf16 engine vs dense generate(): {same}/8 requests "
                 f"identical, common prefix {agree}/{total} tokens")

    # f32: engine tokens must equal the dense generate() exactly
    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    jobs32 = [(p, min(n, 32)) for p, n in jobs[:4]]
    with DecodeEngine(model32, params, slots=SLOTS, page_size=PAGE,
                      max_context=MAX_CONTEXT, device=DEVICE) as eng32:
        outs32 = [r.result(timeout=600)
                  for r in [eng32.submit(p, n) for p, n in jobs32]]
    check(eng32.pool.allocated == 0, "f32 pool did not drain")
    for i, ((p, n), out) in enumerate(zip(jobs32, outs32)):
        dense = model32.generate(params, p[None], n)[0].cpu().numpy()
        check(np.array_equal(out, dense),
              f"f32 request {i}: engine {out.tolist()} != generate() "
              f"{dense.tolist()}")
    say("serve", f"f32 engine == dense generate() for {len(jobs32)} "
                 f"requests ({sum(n for _, n in jobs32)} tokens)")


# --------------------------------------------------------- train kernels
BERT_BASE_PARAMS = 108_922_170


def bound(nbytes: int, flops: int, peak_flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate
    and the operations over ``peak_flops``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_case(N: int, T: int, dtype, mask_kind: str, seed: int):
    """q, k, v [N, 12, T, 64] and a key mask: none, padded (row n keeps
    its first T - 7n keys), or padded with the last row fully masked."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (torch.randn(N, HEADS, T, HEAD_DIM, generator=g,
                           device=DEVICE).to(dtype) for _ in range(3))
    mask = None
    if mask_kind != "none":
        keep = torch.tensor([max(1, T - 7 * n) for n in range(N)],
                            device=DEVICE)
        mask = (torch.arange(T, device=DEVICE)[None, :]
                < keep[:, None]).float()
        if mask_kind == "full_row":
            mask[-1] = 0.0
    return q, k, v, mask


def flash_plain(q, k, v, mask, causal):
    """The kernels' plain version at f32: ``blockwise_attention`` with one
    block spanning the keys, so that a fully masked row is the mean of v
    as in the kernel (a padded block would let its padding in)."""
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        blockwise_attention)

    return blockwise_attention(q.float(), k.float(), v.float(), mask,
                               causal=causal, block_k=k.shape[2])


def flash_bound(q, backward: bool):
    """(bound_ms, bound_by, bytes, flops) of one unmasked, non-causal call
    (the training path's): the forward reads q, k, v and writes out and
    the row statistics; the backward reads q, k, v, out, dout and the
    statistics and writes dq, dk, dv. Matmul operations only: 2 (QK^T,
    PV) or 5 (QK^T again, dV, dP, dQ, dK) products of 2 * T * T * hd per
    (sequence, head), at the tensor-core rate of the inputs' type."""
    N, H, T, hd = q.shape
    one = q.numel() * q.element_size()
    stats = 2 * N * H * T * 4
    products = 5 if backward else 2
    nbytes = (8 if backward else 4) * one + stats
    flops = products * 2 * N * H * T * T * hd
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    return (*bound(nbytes, flops, peak), nbytes, flops)


def flash_grads(q, k, v, mask, causal, dout, dtype, kernel: bool):
    """dq, dk, dv of attention at ``dtype``: through the kernels'
    autograd Function, or through the plain version at f32."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    work = torch.float32 if not kernel else dtype
    leaves = [t.to(dtype).to(work).clone().requires_grad_(True)
              for t in (q, k, v)]
    out = (fa.attention(*leaves, mask, causal) if kernel
           else flash_plain(*leaves, mask, causal))
    return torch.autograd.grad(out, leaves, dout.to(dtype).to(work))


def phase_flash() -> tuple:
    """Rows of ``flash_attention_fwd`` and ``flash_attention_bwd``:
    checks against the plain version, then times at the training shape."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    fwd_err = bwd_err = 0.0
    for T in (128, 77):
        for mask_kind in ("none", "padded", "full_row"):
            for causal in (False, True):
                q, k, v, m = flash_case(4, T, torch.float32, mask_kind,
                                        seed=T)
                dout = torch.randn_like(q)
                line = []
                for dtype, tol in ((torch.float32, 2e-5),
                                   (torch.bfloat16, 2e-2)):
                    lq, lk, lv = (x.to(dtype) for x in (q, k, v))
                    out, stats = fa.flash_attention_fwd(lq, lk, lv, m, causal)
                    want = flash_plain(lq, lk, lv, m, causal)
                    torch.cuda.synchronize()
                    check(out.dtype == dtype and out.shape == q.shape
                          and stats.shape == (2, 4 * HEADS, T),
                          f"forward output {out.dtype} {tuple(out.shape)}")
                    check(bool(torch.isfinite(out).all()),
                          "forward output not finite")
                    err = float((out.float() - want).abs().max())
                    fwd_err = max(fwd_err, err)
                    check(err <= tol, f"flash forward {dtype} T={T} "
                                      f"{mask_kind} causal={causal}: "
                                      f"{err:.3e} > {tol:g}")
                    line.append(f"fwd {str(dtype)[6:]} {err:.2e}")
                for dtype, tol in ((torch.float32, 1e-4),
                                   (torch.bfloat16, 2e-2)):
                    got = flash_grads(q, k, v, m, causal, dout, dtype, True)
                    want = flash_grads(q, k, v, m, causal, dout, dtype, False)
                    torch.cuda.synchronize()
                    for name, a, b in zip("qkv", got, want):
                        check(a.dtype == dtype and a.shape == b.shape,
                              f"d{name} {a.dtype} {tuple(a.shape)}")
                        err = float((a.float() - b).abs().max())
                        scale = float(b.abs().max())
                        bwd_err = max(bwd_err, err)
                        check(err <= tol * scale,
                              f"flash backward d{name} {dtype} T={T} "
                              f"{mask_kind} causal={causal}: {err:.3e} > "
                              f"{tol:g} x max |grad| {scale:.3e}")
                        line.append(f"d{name} {str(dtype)[6:]} "
                                    f"{err / scale:.2e}")
                say("flash", f"T={T} mask={mask_kind} causal={causal}: "
                             f"max abs err {', '.join(line[:2])}; bwd err "
                             f"/ max |grad| {', '.join(line[2:])}")

    # the training shape: bf16, N=96, H=12, T=128, hd=64, no key mask
    q, k, v, _ = flash_case(TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, "none",
                            seed=5)
    dout = torch.randn_like(q)
    out, stats = fa.flash_attention_fwd(q, k, v)
    err = float((out.float() - flash_plain(q, k, v, None, False)).abs().max())
    fwd_err = max(fwd_err, err)
    check(err <= 2e-2, f"flash forward bf16 at the training shape: "
                       f"{err:.3e} > 0.02")
    line = [f"fwd {err:.2e}"]
    got = flash_grads(q, k, v, None, False, dout, torch.bfloat16, True)
    want = flash_grads(q, k, v, None, False, dout, torch.bfloat16, False)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, want):
        err = float((a.float() - b).abs().max())
        scale = float(b.abs().max())
        bwd_err = max(bwd_err, err)
        check(err <= 2e-2 * scale, f"flash backward d{name} bf16 at the "
                                   f"training shape: {err:.3e} > 0.02 x max "
                                   f"|grad| {scale:.3e}")
        line.append(f"d{name} {err / scale:.2e}")
    del got, want
    say("flash", f"training shape N={TRAIN_BATCH} bf16 against the f32 plain "
                 f"version: max abs err {line[0]}; bwd err / max |grad| "
                 f"{', '.join(line[1:])}")
    key_mask = torch.ones(TRAIN_BATCH, 1, 1, TRAIN_SEQ, dtype=torch.bool,
                          device=DEVICE)
    plain_in = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = fa.blockwise_attention(*plain_in)
    lib_in = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=key_mask)
    lib_err = float((lib_out.detach().float() - out.float()).abs().max())
    say("flash", f"yardstick SDPA vs kernel at the training shape: max abs "
                 f"err {lib_err:.3e}")
    iters = 50

    def times():
        return (cuda_ms(lambda i: fa.flash_attention_fwd(q, k, v), iters),
                cuda_ms(lambda i: fa.flash_attention_bwd(
                    q, k, v, out, dout, stats), iters))

    kern1 = times()
    plain = (cuda_ms(lambda i: fa.blockwise_attention(q, k, v), iters),
             cuda_ms(lambda i: torch.autograd.grad(
                 plain_out, plain_in, dout, retain_graph=True), iters))
    lib = (cuda_ms(lambda i: F.scaled_dot_product_attention(
               q, k, v, attn_mask=key_mask), iters),
           cuda_ms(lambda i: torch.autograd.grad(
               lib_out, lib_in, dout, retain_graph=True), iters))
    kern2 = times()
    rows = []
    for j, (name, err) in enumerate((("flash_attention_fwd", fwd_err),
                                     ("flash_attention_bwd", bwd_err))):
        bound_ms, bound_by, nbytes, flops = flash_bound(q, backward=j == 1)
        ms = min(kern1[j], kern2[j])
        say("flash", f"{name} at N={TRAIN_BATCH} H={HEADS} T={TRAIN_SEQ} "
                     f"hd={HEAD_DIM} bf16: kernel {kern1[j]:.4f} / "
                     f"{kern2[j]:.4f} ms, plain {plain[j]:.4f} ms, library "
                     f"(SDPA with a boolean key mask, never called by the "
                     f"port) {lib[j]:.4f} ms; bound {bound_ms:.4f} ms by "
                     f"{bound_by} ({nbytes} B, {flops} flop at 989 TFLOP/s "
                     f"bf16); kernel at {nbytes / (ms * 1e-3) / 1e9:.1f} "
                     f"GB/s, {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        rows.append({"name": name, "route": "cuda",
                     "source": "deeplearning4j_tpu_torch/csrc/"
                               "flash_attention.cu",
                     "replaces": "deeplearning4j_tpu/ops/flash_attention.py:"
                                 + ("181" if j == 0 else "208"),
                     "launches": 0, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain[j], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib[j]})
    return tuple(rows)


def adam_case(n: int, offset: int, seed: int, fresh: bool = False):
    """Flat f32 master, m, v and grad of n elements at the JAX golden's
    scales, or with m = v = 0 (``fresh``, the first step's state);
    ``offset`` 1 starts every buffer one element into its allocation,
    which takes the kernel off its 16-byte vector path."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    bufs = []
    for scale, positive in ((1.0, False), (0.01, False), (1e-4, True),
                            (2.0 ** 12, False)):
        x = torch.randn(n + offset, generator=g, device=DEVICE)
        x = (x.abs() if positive else x).mul_(0.0 if fresh and scale < 1
                                                else scale)
        bufs.append(x[offset:])
    return bufs


def phase_adam() -> dict:
    """Row of ``fused_adam_update``: checks against the plain version at
    step 300 with a loss scale and a clip, and at step 0 from zero
    moments, then times at the full flat buffer of BERT-base."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    upd = Adam(3e-4)
    hyper = dict(beta1=upd.beta1, beta2=upd.beta2, eps=upd.epsilon)
    max_err = 0.0
    for n, offset, it in ((BERT_BASE_PARAMS, 0, 300), (1_000_003, 1, 300),
                          (1_000_003, 0, 0)):
        master, m, v, grad = adam_case(n, offset, seed=offset, fresh=it == 0)
        sc = fu.adam_update_scalars(upd, it, inv_scale=2.0 ** -12,
                                    clip_norm=0.5,
                                    grad_norm=torch.linalg.vector_norm(grad))
        want = fu.adam_update_reference(master, m, v, grad, sc[0], sc[1],
                                        upd.beta1, upd.beta2, upd.epsilon)
        got = fu.adam_segment_update(master, m, v, grad, sc, **hyper)
        torch.cuda.synchronize()
        for name, a, b in zip(("master", "m", "v"), got, want):
            err = (a - b).abs()
            worst = float((err - 1e-6 * b.abs()).max())
            max_err = max(max_err, float(err.max()))
            check(worst <= 1e-7, f"fused Adam {name} n={n} step {it}: "
                                 f"|err| exceeds 1e-7 + 1e-6 |want| by "
                                 f"{worst:.3e}")
        say("adam", f"n={n} offset={offset} step {it}: kernel == plain "
                    f"within rtol 1e-6, atol 1e-7 (max abs err so far "
                    f"{max_err:.3e})")
        del master, m, v, grad, want, got

    # the train step's call: the whole BERT-base flat buffer, scalars
    # from the host
    n = BERT_BASE_PARAMS
    master, m, v, grad = adam_case(n, 0, seed=2)
    gscale, alpha = fu.adam_update_scalars(Adam(1e-4), 300).tolist()
    iters = 20

    def kernel_ms():
        return cuda_ms(lambda i: fu.fused_adam_update(
            master, m, v, grad, gscale, alpha, **hyper), iters, warmup=3)

    kern1 = kernel_ms()
    plain_ms = cuda_ms(lambda i: fu.adam_update_reference(
        master, m, v, grad, gscale, alpha, upd.beta1, upd.beta2,
        upd.epsilon), iters, warmup=3)
    p = torch.nn.Parameter(master.clone())
    p.grad = grad.clone()
    opt = torch.optim.Adam([p], lr=1e-4, fused=True)
    lib_ms = cuda_ms(lambda i: opt.step(), iters, warmup=3)
    del p, opt
    kern2 = kernel_ms()
    ms = min(kern1, kern2)
    nbytes, flops = 28 * n, 12 * n    # reads 4 f32, writes 3; ~12 flop each
    bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
    say("adam", f"fused_adam_update at n={n}: kernel {kern1:.4f} / "
                f"{kern2:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"(torch.optim.Adam(fused=True), not the same function: its "
                f"eps comes after the bias correction) {lib_ms:.4f} ms; "
                f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B); kernel "
                f"at {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    del master, m, v, grad
    torch.cuda.empty_cache()
    return {"name": "fused_adam_update", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/fused_update.cu",
            "replaces": "deeplearning4j_tpu/ops/fused_update_pallas.py:147",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


# ----------------------------------------------------------------- train
def mlm_batch(vocab: int, batch: int, seq: int, seed: int):
    """bench.py's MLM batch from a numpy seed: random ids and labels,
    MASKED_PER_ROW masked positions per row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq))
    labels = rng.integers(0, vocab, (batch, seq))
    mask_pos = np.zeros((batch, seq), np.float32)
    for r in range(batch):
        mask_pos[r, rng.choice(seq, MASKED_PER_ROW, replace=False)] = 1.0
    return ids, labels, mask_pos


def reset_train_counts() -> None:
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    fa.fwd_launches = fa.bwd_launches = fu.launches = 0


def train_counts() -> tuple:
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    return fa.fwd_launches, fa.bwd_launches, fu.launches


def phase_train(rows: dict) -> None:
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerEncoder, bert_base, init_params_numpy)
    from deeplearning4j_tpu_torch.params import FlatParams, params_from_jax

    cfg = bert_base()
    model = TransformerEncoder(cfg, attn_impl="flash")
    t0 = time.perf_counter()
    flat = FlatParams(params_from_jax(init_params_numpy(cfg, seed=0),
                                      device=DEVICE))
    check(flat.numel == BERT_BASE_PARAMS,
          f"bert_base() has {flat.numel} parameters")
    upd = Adam(1e-4)
    opt = upd.init_state(flat.master)
    step = model.make_train_step(upd, masked_capacity=MASKED_CAPACITY)
    batch = [torch.from_numpy(a).to(DEVICE) for a in
             mlm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    say("train", f"bert_base(): {flat.numel} parameters in one flat f32 "
                 f"master, {cfg.compute_dtype} compute, attn_impl=flash, "
                 f"dropout {cfg.dropout}; batch {TRAIN_BATCH} x "
                 f"{TRAIN_SEQ}, {MASKED_PER_ROW} masked per row, "
                 f"masked_capacity {MASKED_CAPACITY}, Adam lr "
                 f"{upd.learning_rate}; set up in "
                 f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    losses = [step(flat, opt, i, *batch, generator=gen)
              for i in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP_STEPS, WARMUP_STEPS + TIMED_STEPS):
        losses.append(step(flat, opt, i, *batch, generator=gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd, adam = train_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    steps = WARMUP_STEPS + TIMED_STEPS
    check((fwd, bwd, adam) == (cfg.n_layers * steps, cfg.n_layers * steps,
                               steps),
          f"launches fwd {fwd}, bwd {bwd}, adam {adam} over {steps} steps "
          f"of {cfg.n_layers} layers")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 1.0,
          f"first loss {losses[0]:.4f} is not within 1.0 of ln(vocab) "
          f"{math.log(cfg.vocab_size):.4f}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = wall / TIMED_STEPS
    say("train", f"{TIMED_STEPS} timed steps: {step_s * 1e3:.2f} ms/step, "
                 f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} tokens/s; peak "
                 f"memory {peak} B ({peak / 2 ** 30:.2f} GiB); launches "
                 f"over {steps} steps: flash fwd {fwd}, flash bwd {bwd}, "
                 f"fused Adam {adam}")
    say("train", "losses " + " ".join(f"{x:.4f}" for x in losses))
    rows["flash_attention_fwd"]["launches"] = fwd
    rows["flash_attention_bwd"]["launches"] = bwd
    rows["fused_adam_update"]["launches"] = adam

    def run():
        for i in range(steps, steps + PROFILED_STEPS):
            step(flat, opt, i, *batch, generator=gen)

    busy_ms = device_profile("train", f"{PROFILED_STEPS} more steps", run,
                             ("flash_fwd", "flash_bwd", "fused_adam"))
    if busy_ms:
        per_step = busy_ms / PROFILED_STEPS
        say("train", f"device busy {per_step:.2f} ms per profiled step "
                     f"against {step_s * 1e3:.2f} ms per timed step "
                     f"(unprofiled): idle about "
                     f"{1 - per_step / (step_s * 1e3):.3f} of a step")


def run_steps(step, updater, tree, arrays, n_steps: int, device: str):
    """``n_steps`` of a flat train step from the numpy parameter tree on
    ``device``: the losses, the final flat master on the CPU, and the
    largest distance a parameter moved."""
    from deeplearning4j_tpu_torch.params import FlatParams, params_from_jax

    flat = FlatParams(params_from_jax(tree, device=device))
    start = flat.master.detach().cpu().clone()
    opt = updater.init_state(flat.master)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    losses = [float(step(flat, opt, i, *args)) for i in range(n_steps)]
    final = flat.master.detach().cpu()
    return losses, final, float((final - start).abs().max())


#: card-vs-CPU parameter limit: the sound runs differ by 1e-6 to 2e-6,
#: while one Adam step moves a parameter by up to lr = 1e-4, so a skipped
#: or wrong update fails it
PARITY_PARAM_ATOL = 2e-5


def compare_runs(what: str, card, cpu, lr: float) -> None:
    (lc, mc, moved), (lh, mh, _) = card, cpu
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    err = float((mc - mh).abs().max())
    say("parity", f"{what}: card losses {' '.join(f'{x:.6f}' for x in lc)}, "
                  f"CPU {' '.join(f'{x:.6f}' for x in lh)} (max relative "
                  f"diff {rel:.2e}, tolerance 1e-4); parameters max abs diff "
                  f"{err:.2e} (tolerance {PARITY_PARAM_ATOL:g}); the card "
                  f"moved a parameter by up to {moved:.3e}")
    check(rel <= 1e-4, f"{what}: card and CPU losses differ by {rel:.3e}")
    check(err <= PARITY_PARAM_ATOL,
          f"{what}: card and CPU parameters differ by {err:.3e}")
    check(moved >= 0.5 * lr, f"{what}: the card's update moved no parameter "
                             f"by half a step of lr {lr:g} ({moved:.3e})")


def phase_parity() -> None:
    """The training path through the kernels on the card against the
    same path through the plain versions on the CPU."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.models.bert_classifier import (
        BertSequenceClassifier)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerEncoder, bert_base, init_params_numpy)

    cfg = bert_base()
    cfg.n_layers, cfg.dropout, cfg.compute_dtype = 2, 0.0, "float32"
    tree = init_params_numpy(cfg, seed=3)
    batch = mlm_batch(cfg.vocab_size, 8, TRAIN_SEQ, seed=4)
    upd = Adam(1e-4)
    step = TransformerEncoder(cfg, attn_impl="flash").make_train_step(
        upd, masked_capacity=MASKED_CAPACITY)
    reset_train_counts()
    card = run_steps(step, upd, tree, batch, 3, DEVICE)
    check(train_counts() == (6, 6, 3),
          f"card MLM steps launched {train_counts()}, not (6, 6, 3)")
    cpu = run_steps(step, upd, tree, batch, 3, "cpu")
    check(train_counts() == (6, 6, 3), "the CPU steps launched a kernel")
    compare_runs("MLM, 2 layers, 3 steps", card, cpu, upd.learning_rate)

    clf = BertSequenceClassifier(cfg, 3, attn_impl="flash")
    ctree = clf.init_params_numpy(seed=5, encoder_params=tree)
    lens = np.array([128, 100, 77, 64, 33, 16, 5, 1])
    pad = (np.arange(TRAIN_SEQ)[None, :] < lens[:, None]).astype(np.float32)
    arrays = (batch[0], np.array([0, 1, 2, 0, 1, 2, 0, 1]), pad)
    cstep = clf.make_train_step(upd)
    reset_train_counts()
    card = run_steps(cstep, upd, ctree, arrays, 1, DEVICE)
    check(train_counts() == (2, 2, 1),
          f"card fine-tune step launched {train_counts()}, not (2, 2, 1)")
    compare_runs("BertSequenceClassifier, padding mask, 1 step", card,
                 run_steps(cstep, upd, ctree, arrays, 1, "cpu"),
                 upd.learning_rate)

# ------------------------------------------------------------ LSTM kernels
LSTM_HIDDEN, LSTM_VOCAB, LSTM_BATCH, LSTM_SEQ = 256, 77, 256, 200


def lstm_case(T: int, N: int, H: int, seed: int):
    """x_proj [T, N, 4H], w_hh [H, 4H] and non-zero h0, c0 [N, H] at the
    scales of a trained layer (f32, on the card)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x_proj = 0.5 * torch.randn(T, N, 4 * H, generator=g, device=DEVICE)
    w_hh = torch.randn(H, 4 * H, generator=g, device=DEVICE) / math.sqrt(H)
    h0 = 0.5 * torch.randn(N, H, generator=g, device=DEVICE)
    c0 = 0.5 * torch.randn(N, H, generator=g, device=DEVICE)
    return x_proj, w_hh, h0, c0


def lstm_bound(T: int, N: int, H: int, nbytes_el: int, backward: bool):
    """(bound_ms, bound_by, bytes, flops) of one call at the training
    shape: the forward reads x_proj, w_hh, h0, c0 and writes ys, the cell
    stream, hT, cT; its matmul is T steps of [N, H] @ [H, 4H]. The backward
    call reads x_proj, w_hh, h0, c0, ys, cs, dys, dhT, dcT and writes
    d x_proj, d w_hh, dh0, dc0; its matmuls are the gate recompute,
    da @ w_hh^T and the weight gradient, three of the forward's size."""
    xp = T * N * 4 * H * nbytes_el
    seq = T * N * H * nbytes_el
    w = H * 4 * H * nbytes_el
    state = N * H * nbytes_el
    one = 2 * T * N * H * 4 * H
    if backward:
        nbytes, flops = 2 * xp + 3 * seq + 2 * w + 6 * state, 3 * one
    else:
        nbytes, flops = xp + 2 * seq + w + 4 * state, one
    return (*bound(nbytes, flops, BF16_FLOPS), nbytes, flops)


def phase_lstm_kernels() -> tuple:
    """Rows of the LSTM forward and backward kernels: checks against the
    plain versions, one refused shape, then times at the training shape."""
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    H = LSTM_HIDDEN
    fwd_err = bwd_err = 0.0
    # the training shapes, then phase 10's sampling shapes: rnnTimeStep
    # (T=1) and output() over 64 characters, both at batch 4
    shapes = [(T, N) for T in (1, 50, 200) for N in (1, 256)]
    for T, N in shapes + [(1, 4), (64, 4)]:
        x_proj, w_hh, h0, c0 = lstm_case(T, N, H, seed=T + N)
        g = torch.Generator(device=DEVICE).manual_seed(T * N)
        dys = torch.randn(T, N, H, generator=g, device=DEVICE)
        dhT = torch.randn(N, H, generator=g, device=DEVICE)
        dcT = torch.randn(N, H, generator=g, device=DEVICE)
        line = []
        for dtype, tol, gtol in ((torch.float32, 1e-5, 1e-4),
                                 (torch.bfloat16, 2e-2, 2e-2)):
            ins = [t.to(dtype) for t in (x_proj, w_hh, h0, c0)]
            f32 = [t.float() for t in ins]
            want = lr.lstm_recurrence_reference(*f32, collect_cell=True)
            for cells in (False, True):
                got = lr.lstm_recurrence_fwd(*ins, collect_cell=cells)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    check(a.dtype == dtype and a.shape == b.shape,
                          f"LSTM forward output {a.dtype} "
                          f"{tuple(a.shape)}")
                    check(bool(torch.isfinite(a).all()),
                          "LSTM forward output not finite")
                    err = float((a.float() - b).abs().max())
                    fwd_err = max(fwd_err, err)
                    check(err <= tol, f"LSTM forward {dtype} T={T} N={N} "
                                      f"cells={cells}: {err:.3e} > "
                                      f"{tol:g}")
            line.append(f"fwd {str(dtype)[6:]} {err:.2e}")
            ys_k, _, _, cs_k = lr.lstm_recurrence_fwd(*ins,
                                                      collect_cell=True)
            up = [t.to(dtype) for t in (dys, dhT, dcT)]
            got = lr.lstm_recurrence_bwd(*ins, ys_k, cs_k, *up)
            ref = lr.lstm_recurrence_backward_reference(
                *f32, want[0], want[3], *(t.float() for t in up))
            torch.cuda.synchronize()
            for name, a, b in zip(("dx_proj", "dw_hh", "dh0", "dc0"),
                                  got, ref):
                check(a.dtype == dtype and a.shape == b.shape,
                      f"LSTM {name} {a.dtype} {tuple(a.shape)}")
                err = float((a.float() - b).abs().max())
                scale = float(b.abs().max())
                bwd_err = max(bwd_err, err)
                check(err <= gtol * scale,
                      f"LSTM backward {name} {dtype} T={T} N={N}: "
                      f"{err:.3e} > {gtol:g} x max |grad| {scale:.3e}")
                line.append(f"{name} {str(dtype)[6:]} {err / scale:.2e}")
            if dtype == torch.bfloat16:
                # d w_hh against the f32 sum over the kernel's own stored
                # ys and cs: the f32 da it sums must stay within the final
                # bf16 rounding; the sum of bf16-rounded da is printed
                # beside it
                same = lr.lstm_recurrence_backward_reference(
                    *f32, ys_k.float(), cs_k.float(),
                    *(t.float() for t in up))[1]
                h_prev = torch.cat([ins[2][None], ys_k[:-1]])
                rounded = (h_prev.reshape(T * N, H).T
                           @ got[0].reshape(T * N, 4 * H))
                scale = float(same.abs().max())
                e_f32 = float((got[1].float() - same).abs().max()) / scale
                e_bf16 = float((rounded.float() - same).abs().max()) / scale
                check(e_f32 <= 2 ** -8, f"LSTM bf16 dw_hh T={T} N={N} off "
                                        f"its f32 sum by {e_f32:.3e}")
                line.append(f"dw_hh bf16 on its own ys {e_f32:.2e} (from "
                            f"bf16 da {e_bf16:.2e})")
        say("lstm", f"H={H} T={T} N={N}: {', '.join(line)} (fwd: max "
                    f"abs err; bwd: err / max |grad|; plan "
                    f"{lr.last_plan})")
    try:
        lr.lstm_recurrence(*lstm_case(3, 257, H, seed=1))
    except ValueError as e:
        say("lstm", f"N=257 refused: {e}")
    else:
        raise RuntimeError("the LSTM wrapper took N=257, outside its "
                           "envelope")

    # the training shape: bf16, T=200, N=256, H=256
    T, N = LSTM_SEQ, LSTM_BATCH
    x_proj, w_hh, h0, c0 = (t.to(torch.bfloat16) for t in
                            lstm_case(T, N, H, seed=11))
    g = torch.Generator(device=DEVICE).manual_seed(12)
    dys = torch.randn(T, N, H, generator=g, device=DEVICE).to(torch.bfloat16)
    ys, hT, cT, cs = lr.lstm_recurrence_fwd(x_proj, w_hh, h0, c0,
                                            collect_cell=True)
    fwd_plan = lr.last_plan
    lr.lstm_recurrence_bwd(x_proj, w_hh, h0, c0, ys, cs, dys)
    bwd_plan = lr.last_plan
    iters = 20

    def kernels():
        return (cuda_ms(lambda i: lr.lstm_recurrence_fwd(
                    x_proj, w_hh, h0, c0, collect_cell=True), iters, 3),
                cuda_ms(lambda i: lr.lstm_recurrence_bwd(
                    x_proj, w_hh, h0, c0, ys, cs, dys), iters, 3))

    kern1 = kernels()
    plain = (cuda_ms(lambda i: lr.lstm_recurrence_reference(
                 x_proj, w_hh, h0, c0, collect_cell=True), 3, 1),
             cuda_ms(lambda i: lr.lstm_recurrence_backward_reference(
                 x_proj, w_hh, h0, c0, ys, cs, dys), 3, 1))
    lib, port_layer = lstm_yardstick(x_proj.shape, iters)
    kern2 = kernels()
    rows = []
    for j, (name, err, plan) in enumerate((("B5", fwd_err, fwd_plan),
                                           ("B5 bwd", bwd_err, bwd_plan))):
        bound_ms, bound_by, nbytes, flops = lstm_bound(T, N, H, 2, j == 1)
        ms = min(kern1[j], kern2[j])
        say("lstm", f"{name} at T={T} N={N} H={H} bf16 (plan {plan}): kernel "
                    f"{kern1[j]:.4f} / {kern2[j]:.4f} ms ({ms / T * 1e3:.2f} "
                    f"us per step), plain {plain[j]:.4f} ms, library "
                    f"(torch.nn.LSTM on cuDNN, projection included, never "
                    f"called by the port) {lib[j]:.4f} ms against the port's "
                    f"projection + kernel {port_layer[j]:.4f} ms; bound "
                    f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} "
                    f"flop at 989 TFLOP/s bf16); kernel at "
                    f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
                    f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        rows.append({"name": name, "route": "cuda",
                     "source": "deeplearning4j_tpu_torch/csrc/"
                               "lstm_recurrence.cu",
                     "replaces": "deeplearning4j_tpu/ops/lstm_pallas.py:123",
                     "launches": 0, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain[j], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib[j]})
    return tuple(rows)


def lstm_yardstick(shape, iters: int):
    """``torch.nn.LSTM`` (cuDNN) forward and backward over one layer with
    the port's weights transposed (``weight_ih = W^T``, ``weight_hh =
    RW^T``, ``bias_ih = b``, ``bias_hh = 0``), input width H, bf16 (f32 if
    cuDNN refuses bf16), and the port's own layer (projection matmul +
    kernels) on the same inputs: ``((lib_fwd, lib_bwd), (port_fwd,
    port_bwd))`` in ms. The two outputs' difference is printed first."""
    from deeplearning4j_tpu_torch.ops.nn import lstm_layer

    T, N, four_h = shape
    H = four_h // 4
    g = torch.Generator(device=DEVICE).manual_seed(13)
    bf = torch.bfloat16
    x = torch.randn(N, T, H, generator=g, device=DEVICE).to(bf)
    W = (torch.randn(H, 4 * H, generator=g, device=DEVICE)
         / math.sqrt(H)).to(bf)
    RW = (torch.randn(H, 4 * H, generator=g, device=DEVICE)
          / math.sqrt(H)).to(bf)
    b = (0.1 * torch.randn(4 * H, generator=g, device=DEVICE)).to(bf)
    dy = torch.randn(N, T, H, generator=g, device=DEVICE).to(bf)
    leaves = [t.clone().requires_grad_(True) for t in (x, W, RW, b)]
    port_out, _ = lstm_layer(*leaves)
    for lib_dtype in (bf, torch.float32):
        # cuDNN's RNN may refuse bf16; then the yardstick runs at f32
        cudnn = torch.nn.LSTM(H, H, batch_first=True).to(DEVICE, lib_dtype)
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(W.T)
            cudnn.weight_hh_l0.copy_(RW.T)
            cudnn.bias_ih_l0.copy_(b)
            cudnn.bias_hh_l0.zero_()
        cudnn.flatten_parameters()    # one weight buffer, as cuDNN wants
        lib_x = x.to(lib_dtype).requires_grad_(True)
        try:
            lib_out, _ = cudnn(lib_x)
            torch.cuda.synchronize()
            break
        except RuntimeError as e:
            say("lstm", f"cuDNN LSTM refused {lib_dtype}: {e}")
    lib_dy = dy.to(lib_dtype)
    err = float((lib_out.detach().float() - port_out.detach().float())
                .abs().max())
    say("lstm", f"yardstick cuDNN LSTM ({lib_dtype}) vs the port's bf16 "
                f"layer: max abs err {err:.3e}")
    lib = (cuda_ms(lambda i: cudnn(lib_x), iters, 3),
           cuda_ms(lambda i: torch.autograd.grad(
               lib_out, [lib_x, *cudnn.parameters()], lib_dy,
               retain_graph=True), iters, 3))
    port = (cuda_ms(lambda i: lstm_layer(*leaves), iters, 3),
            cuda_ms(lambda i: torch.autograd.grad(
                port_out, leaves, dy, retain_graph=True), iters, 3))
    return lib, port


# -------------------------------------------------------- char-LSTM train
def textgen_params_numpy(vocab: int, hidden: int, seed: int):
    """TextGenerationLSTM's parameters in the JAX layout from a numpy
    seed: Xavier-normal W [in, 4H], RW [H, 4H], zero b with the forget
    gate's slice at 1, and the head's W [H, vocab], b."""
    rng = np.random.default_rng(seed)

    def xavier(n_in, n_out):
        return (rng.standard_normal((n_in, n_out))
                * math.sqrt(2.0 / (n_in + n_out))).astype(np.float32)

    layers = []
    for n_in in (vocab, hidden):
        b = np.zeros(4 * hidden, np.float32)
        b[hidden:2 * hidden] = 1.0
        layers.append({"W": xavier(n_in, 4 * hidden),
                       "RW": xavier(hidden, 4 * hidden), "b": b})
    layers.append({"W": xavier(hidden, vocab),
                   "b": np.zeros(vocab, np.float32)})
    return layers


def char_batch(vocab: int, batch: int, seq: int, seed: int, dtype, device):
    """bench_common.build_char_lstm's batch: one-hot ids from
    ``np.random.default_rng(seed)``, labels the next character (rolled
    by one)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq))
    eye = np.eye(vocab, dtype=np.float32)
    return (torch.from_numpy(eye[ids]).to(device, dtype),
            torch.from_numpy(eye[np.roll(ids, -1, 1)]).to(device, dtype))


def textgen_net(dtype: str, tbptt: int, device, seed: int = 0):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    conf = TextGenerationLSTM(vocab_size=LSTM_VOCAB, hidden=LSTM_HIDDEN,
                              tbptt_length=tbptt).conf()
    conf.dtype = dtype
    net = MultiLayerNetwork(conf, device=device).init()
    net.params_list = mln_params_from_numpy(
        textgen_params_numpy(LSTM_VOCAB, LSTM_HIDDEN, seed), device=device,
        dtype=net._dtype)
    return net


def eval_loss_f32(params_list, x, y) -> float:
    """The network loss of ``params_list`` (cast to f32) on ``(x, y)`` at
    f32, through an f32 twin of the training network."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    net = textgen_net("float32", 0, x.device)
    net.params_list = [{k: v.float() for k, v in p.items()}
                       for p in params_list]
    return net.score(DataSet(x.float(), y.float()))


def lstm_counts() -> tuple:
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    return lr.fwd_launches, lr.bwd_launches


def reset_lstm_counts() -> None:
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    lr.fwd_launches = lr.bwd_launches = 0


def phase_lstm_train(rows: dict) -> None:
    net = textgen_net("bfloat16", 0, DEVICE)
    H, V = LSTM_HIDDEN, LSTM_VOCAB
    want = 4 * H * (V + H + 1) + 4 * H * (2 * H + 1) + H * V + V
    check(net.numParams() == want,     # 887,117 at V=77, H=256
          f"{net.numParams()} parameters, not {want}")
    x, y = char_batch(LSTM_VOCAB, LSTM_BATCH, LSTM_SEQ, 0, torch.bfloat16,
                      DEVICE)
    ln_v = math.log(LSTM_VOCAB)
    say("lstm-train", f"TextGenerationLSTM(vocab_size={LSTM_VOCAB}, hidden="
                      f"{LSTM_HIDDEN}): {net.numParams()} parameters, bf16, "
                      f"standard BPTT, Adam lr 1e-3; batch {LSTM_BATCH} x "
                      f"{LSTM_SEQ} one-hot characters")
    start = [dict(p) for p in net.params_list]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_lstm_counts()
    losses = []
    for _ in range(WARMUP_STEPS):
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = lstm_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + TIMED_STEPS
    per_char = [float(l) / LSTM_SEQ for l in losses]
    check((fwd, bwd) == (2 * steps, 2 * steps),
          f"LSTM launches fwd {fwd}, bwd {bwd} over {steps} steps of 2 "
          f"layers")
    check(all(math.isfinite(v) for v in per_char), f"losses {per_char}")
    check(abs(per_char[0] - ln_v) <= 0.5,
          f"first loss per character {per_char[0]:.4f} is not within 0.5 of "
          f"ln {LSTM_VOCAB} = {ln_v:.4f}")
    # the bf16 loss sums 200 steps (~870), where bf16 resolves only 4
    # (0.02 per character): the fall is held on an f32 evaluation of the
    # first and the last parameters on the same batch
    evals = [eval_loss_f32(p, x, y) / LSTM_SEQ
             for p in (start, net.params_list)]
    say("lstm-train", f"f32 evaluation of the batch, per character: before "
                      f"{evals[0]:.6f}, after {steps} steps {evals[1]:.6f}")
    check(evals[1] < evals[0], f"loss did not fall: {evals}")
    step_s = wall / TIMED_STEPS
    tokens_s = LSTM_BATCH * LSTM_SEQ / step_s
    say("lstm-train", f"{TIMED_STEPS} timed steps: {step_s * 1e3:.2f} "
                      f"ms/step, {tokens_s:.1f} tokens/s; peak memory {peak} "
                      f"B ({peak / 2 ** 30:.2f} GiB); launches over {steps} "
                      f"steps: fwd {fwd}, bwd {bwd}")
    say("lstm-train", "loss per character (the network's loss sums over "
                      "the 200 steps): " + " ".join(f"{v:.4f}"
                                                    for v in per_char))
    rows["B5"]["launches"] = fwd
    rows["B5 bwd"]["launches"] = bwd

    def run():
        for _ in range(PROFILED_STEPS):
            net.fit(x, y)

    busy_ms = device_profile("lstm-train", f"{PROFILED_STEPS} more steps", run,
                             ("lstm_fwd", "lstm_bwd"))
    if busy_ms:
        per_step = busy_ms / PROFILED_STEPS
        say("lstm-train", f"device busy {per_step:.2f} ms per profiled step "
                          f"against {step_s * 1e3:.2f} ms per timed step "
                          f"(unprofiled): idle about "
                          f"{1 - per_step / (step_s * 1e3):.3f} of a step")
    del net

    # the zoo's own truncated BPTT (50) at f32 on the same batch
    net = textgen_net("float32", 50, DEVICE)
    reset_lstm_counts()
    it0 = net.getIterationCount()
    net.fit(x.float(), y.float())
    torch.cuda.synchronize()
    counts = lstm_counts()
    check(counts == (8, 8), f"tBPTT 50 over 200 steps launched {counts}, "
                            f"not 4 segments x 2 layers (8, 8)")
    check(net.getIterationCount() - it0 == 4,
          f"tBPTT advanced {net.getIterationCount() - it0} iterations")
    say("lstm-train", f"tBPTT 50, f32: one fit = 4 segments, launches "
                      f"{counts}, iterations {it0} -> "
                      f"{net.getIterationCount()}, last segment loss per "
                      f"character {float(net._score) / 50:.4f}")


def phase_lstm_parity() -> None:
    """The zoo model on the card (the kernels) against the CPU (the plain
    versions), then stateful sampling against the full forward."""
    lr_ = 1e-3
    out = {}
    for dev in (DEVICE, "cpu"):
        net = textgen_net("float32", 50, dev, seed=5)
        start = [{k: v.detach().cpu().clone() for k, v in p.items()}
                 for p in net.params_list]
        reset_lstm_counts()
        losses = []
        for b in range(3):
            x, y = char_batch(LSTM_VOCAB, 8, 100, 10 + b, torch.float32, dev)
            net.fit(x, y)
            losses.append(float(net._score))
        counts = lstm_counts()
        final = [{k: v.detach().cpu() for k, v in p.items()}
                 for p in net.params_list]
        moved = max(float((final[i][k] - start[i][k]).abs().max())
                    for i in range(len(final)) for k in final[i])
        out[dev] = (losses, final, moved, counts)
    (lc, pc, moved, kc), (lh, ph, _, hc) = out[DEVICE], out["cpu"]
    check(kc == (12, 12) and hc == (0, 0),
          f"launches card {kc} (want 3 x 2 segments x 2 layers), CPU {hc}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    err = max(float((pc[i][k] - ph[i][k]).abs().max())
              for i in range(len(pc)) for k in pc[i])
    say("lstm-parity", f"3 minibatches of 8 x 100, tBPTT 50, f32: card "
                       f"losses {' '.join(f'{x:.6f}' for x in lc)}, CPU "
                       f"{' '.join(f'{x:.6f}' for x in lh)} (max relative "
                       f"diff {rel:.2e}, tolerance 1e-5); parameters max abs "
                       f"diff {err:.2e} (tolerance {PARITY_PARAM_ATOL:g}); "
                       f"the card moved a parameter by up to {moved:.3e}")
    check(rel <= 1e-5, f"card and CPU losses differ by {rel:.3e}")
    check(err <= PARITY_PARAM_ATOL,
          f"card and CPU parameters differ by {err:.3e}")
    check(moved >= 0.5 * lr_, f"the card's updates moved no parameter by "
                              f"half a step of lr {lr_:g} ({moved:.3e})")

    net = textgen_net("float32", 50, DEVICE, seed=6)
    x, _ = char_batch(LSTM_VOCAB, 4, 64, 20, torch.float32, DEVICE)
    reset_lstm_counts()
    full = net.output(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = torch.stack([net.rnnTimeStep(x[:, t]) for t in range(64)], 1)
    torch.cuda.synchronize()
    per_char = (time.perf_counter() - t0) / 64 * 1e3
    counts = lstm_counts()
    err = float((steps - full).abs().max())
    # the same network on the CPU (the plain versions): both card paths
    # run the kernels at N=4, so only this twin can tell a fault there
    plain = textgen_net("float32", 50, "cpu", seed=6).output(x.cpu())
    err_plain = max(float((a.cpu() - plain).abs().max())
                    for a in (full, steps))
    say("lstm-parity", f"rnnTimeStep x 64 (batch 4) vs output(): max abs err "
                       f"{err:.3e}; both vs the CPU twin's output() "
                       f"{err_plain:.3e} (tolerance 1e-5); {per_char:.3f} "
                       f"ms per character (host clock, 2 layers + head); "
                       f"launches {counts}")
    check(counts == (2 * 65, 0),
          f"sampling launched {counts}, not 2 layers x 65 calls")
    check(err <= 1e-5, f"rnnTimeStep differs from output() by {err:.3e}")
    check(err_plain <= 1e-5, f"card sampling differs from the CPU's plain "
                             f"versions by {err_plain:.3e}")
    try:
        net.rnnTimeStep(x[:2, 0])
    except ValueError as e:
        say("lstm-parity", f"batch 4 -> 2 with stored state refused: {e}")
    else:
        raise RuntimeError("rnnTimeStep took a new batch size with stored "
                           "state")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(PKG, "csrc")):
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({PKG})", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    paged = phase_kernel()
    phase_serve(paged)
    rows = {r["name"]: r for r in (paged, *phase_flash(), phase_adam())}
    phase_train(rows)
    phase_parity()
    rows.update((r["name"], r) for r in phase_lstm_kernels())
    phase_lstm_train(rows)
    phase_lstm_parity()
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
