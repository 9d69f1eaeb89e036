#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions;
2. build: ``csrc/paged_attention.cu`` compiled by ``nvcc`` for sm_90a
   from this checkout;
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
   ``CausalLM.generate()``.

Prints progress lines, then a JSON line with the kernel's numbers, the
card's ``nvidia-smi`` line, and last the JSON result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.join(HERE, "deeplearning4j_tpu_torch")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the f32 rate
# outside the tensor cores, which is what the kernel's arithmetic uses
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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
    paths = native.build(["paged_attention"])
    say("build", f"{os.path.relpath(paths['paged_attention'], HERE)} in "
                 f"{time.perf_counter() - t0:.2f} s")
    log = native.build_logs.get("paged_attention", {}).get("output", "")
    lines = log.splitlines()
    # ptxas -v for the instantiations the slice runs (head_dim 64)
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "Li2E" in ln:
            kind = "bf16" if "nv_bfloat16" in ln else "f32"
            info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            say("build", f"ptxas {kind} hd=64: {'; '.join(info)}")


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


def profile_window(eng, jobs) -> None:
    """Device busy share over one batch (prefill and decode) served by a
    running engine, from a torch.profiler trace: the kernels' device
    times summed over the window's wall time (one stream, so kernels do
    not overlap), and the largest kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps0 = eng.n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in [eng.submit(p, n) for p, n in jobs]:
            r.result(timeout=600)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = eng.n_steps - steps0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if busy_us == 0:
        say("profile", "torch.profiler saw no device time: device idle "
                       "share not measured")
        return
    attn_us = sum(t for n, t in by_name.items() if "paged_attention" in n)
    say("profile", f"{len(jobs)} requests, {steps} decode steps in "
                   f"{wall_us / 1e3:.1f} ms: device busy {busy_us / 1e3:.1f} "
                   f"ms ({busy_us / wall_us:.3f} of the window, idle "
                   f"{1 - busy_us / wall_us:.3f}); paged_attention "
                   f"{attn_us / 1e3:.2f} ms ({attn_us / busy_us:.3f} of "
                   f"device time)")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say("profile", f"  {t / 1e3:9.2f} ms  {name[:100]}")


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
    row = phase_kernel()
    phase_serve(row)
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
