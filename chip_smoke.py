#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions;
2. build: ``csrc/paged_attention.cu``, ``csrc/flash_attention.cu``,
   ``csrc/fused_update.cu``, ``csrc/lstm_recurrence.cu``,
   ``csrc/conv_bn_stats.cu`` and ``csrc/residual_tail.cu`` compiled from
   this checkout by ``nvcc`` for sm_90a, one ``nvcc`` per source, all
   started together;
3. kernel: the paged-attention kernel against its plain PyTorch version
   at every shape the serving paths give it (H=12, hd=64, ps=16, P=32):
   the decode step (N=8, Q=1; float pools and fp8 pools with f32 scale
   planes), the speculative verify (N=8, Q in {3, 5, 9}) and the prefix
   prefill (N=1, Q in {32, 64, 128, 512}, qbase page-aligned and
   mid-page), under f32 and bf16 queries; f32 queries within 1e-5, bf16
   within 2e-2 of the reference run at f32 on the same (dequantized)
   values; then its time at the decode (float and fp8), verify (Q=5) and
   prefix (N=1, Q=128) shapes beside the plain version's, a page gather
   (+ dequantization) + ``scaled_dot_product_attention`` yardstick and
   the bound from the bytes it must move;
4. serve: the GPT-2-small-like model (12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 32000, max_len 512; random weights from a numpy
   seed in the JAX tree layout) behind ``DecodeEngine(slots=8,
   page_size=16, max_context=512)`` in bf16, serving 24 concurrent
   greedy requests; every decode step must have gone through the
   kernel. Then an f32 pass whose engine tokens must equal the dense
   ``CausalLM.generate()``. The serving phases that follow use the same
   model and engine shape, and each checks that every decode step,
   verify pass and suffix prefill launched the kernel once per layer
   and that its pool drains:
   - fp8: phase 4's requests with ``kv_dtype="fp8_e4m3"`` (tokens/s,
     TTFT, bytes per page, agreement with the float engine, reported);
     at f32 the fp8 pages after prefill (within one e4m3 step at a
     rounding boundary) and the greedy tokens (equal) on the card
     against a CPU twin;
   - prefix: bench_gpt_decode.py's prefix_ab traffic (16 users, a
     192-token system prompt, 32-token user suffixes, 64 new tokens, one
     after another) cold and warm, then a second turn per user adding 80
     tokens, resumed from its sticky session (suffix bucket 128); at f32
     warm and resumed tokens equal cold ones;
   - spec: phase 4's requests with ``spec_decode`` k in {2, 4, 8}
     against plain (acceptance, tokens per verify, tokens/s); at f32 the
     tokens equal plain;
   - int8: phase 4's requests with ``quantization="int8"``; at f32 the
     card's tokens equal a CPU twin's;
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
   batch size with stored state raises;
11. conv / tail kernels: through ``Nd4j.exec`` by name, at batch 256 in
   bf16, the conv + BN-stats kernel (``csrc/conv_bn_stats.cu``) at the 9
   1x1 and 4 3x3 stride-1 shapes of ResNet-50's bottleneck stacks
   (bench_conv_pallas.py:23-37) and the residual-tail kernel
   (``csrc/residual_tail.cu``) at its 4 residual joins
   (bench_residual_tail.py:31-36), each against its plain version at f32
   on the same bf16 values (y and the tail within one bf16 rounding, 2^-8
   of the largest value; means within 1e-5 of max |y|, variances within
   1e-4 of max E[y^2]: f32 sums in another order), then each one's time
   beside its plain version's, a library yardstick the port never calls
   (``torch.matmul`` or ``F.conv2d`` + ``torch.var_mean``; ``F.batch_norm``
   + add + ``relu``) and its bound;
12. ResNet-50 blocks by name: the four identity bottleneck blocks
   (256->64->256 at 56x56, 512->128 at 28x28, 1024->256 at 14x14,
   2048->512 at 7x7; numpy He-normal weights from a seed) as ``SameDiff``
   graphs of ``conv1x1_bn_stats``, ``batch_norm``, ``relu``, ``cast``,
   ``conv3x3_bn_stats`` and ``bn_relu_residual``, at batch 256 in bf16:
   one ``output`` of each graph launches B4a 8, B4b 4 and B3 4 times in
   all; ms per block; a device profile; ``calculateGradients`` of the
   first block's last gamma and beta through B3 against the plain
   formula's f32 autograd (1e-4 of max |grad|); a gradient through B4
   must raise; the 7x7 graph saved and loaded gives the same output;
13. block parity: the four blocks at f32, batch 8, on the card (the
   kernels) against the CPU (the plain versions), within 1e-4 of max(1,
   max |out|).

Prints progress lines, then a JSON line with every kernel's numbers, the
card's ``nvidia-smi`` line, and last the JSON result line.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
                  "lstm_recurrence", "conv_bn_stats", "residual_tail")

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
             "fused_update": "", "lstm_recurrence": "Li1E",
             "conv_bn_stats": "nv_bfloat16", "residual_tail": "nv_bfloat16Lb1"}
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
                                  r"|lstm_(?:fwd|bwd)_kernel"
                                  r"|conv_bn_stats_kernel"
                                  r"|residual_tail_kernel)", ln)
                kind = ("bf16" if "nv_bfloat16" in ln else "f32") \
                    + (" queries, fp8 pools" if "Fp8E4M3" in ln else "")
                info = [x.split(":", 1)[-1].strip()
                        for x in lines[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                say("build", f"  ptxas {found.group(1) if found else ln} "
                             f"({kind}): {'; '.join(info)}")


# ---------------------------------------------------------------- kernel
#: (pool kind, query dtype) of the paged-attention checks: float pools in
#: the query's dtype, or fp8 pools with f32 scale planes under f32 or
#: bf16 queries
KINDS = {"f32": ("float", torch.float32), "bf16": ("float", torch.bfloat16),
         "fp8-f32": ("fp8", torch.float32),
         "fp8-bf16": ("fp8", torch.bfloat16)}
#: tolerance against the plain version run at f32 on the same (dequantized)
#: values: f32 queries 1e-5, bf16 queries 2e-2 (the bf16 output rounding)
KIND_TOL = {"f32": 1e-5, "bf16": 2e-2, "fp8-f32": 1e-5, "fp8-bf16": 2e-2}


def kernel_case(Q: int, kind: str, seed: int, full: bool = False,
                N: int = SLOTS, qbase=None):
    """Pools [L, n_pages, H, ps, hd] (fp8 kinds: quantized per page and
    head with the port's helpers, plus the scale planes), queries and
    page tables at the slice's shapes. With ``qbase`` given, N rows of
    32 distinct pages each query from that position (the prefix-prefill
    shape at N=1). Mixed case: rows 0-1 share their first four pages (a
    shared prompt prefix), rows 2-3 end in null-page tails, row 0 attends
    at full context and row 1 at position 0. Full case: every row owns 32
    distinct pages and attends at full context (the steady state of the
    timing)."""
    from deeplearning4j_tpu_torch.nn.precision import fp8_scale, quantize_fp8

    pool, qdtype = KINDS[kind]
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + SLOTS * PAGES_PER_SLOT
    shape = (LAYERS, n_pages, HEADS, PAGE, HEAD_DIM)
    kv = {}
    for n in ("k", "v"):
        x = torch.randn(shape, generator=g, device=dev)
        if pool == "fp8":
            sc = fp8_scale(x.abs().amax(dim=(3, 4)))
            kv[n], kv[n + "_scale"] = quantize_fp8(x, sc[..., None, None]), sc
        else:
            kv[n] = x.to(qdtype)
    q = torch.randn(N, HEADS, Q, HEAD_DIM, generator=g,
                    device=dev).to(qdtype)
    tables = 1 + np.arange(N * PAGES_PER_SLOT, dtype=np.int32) \
        .reshape(N, PAGES_PER_SLOT)
    full_pos = PAGES_PER_SLOT * PAGE - Q
    if qbase is not None:
        qbase = np.full((N,), qbase, np.int32)
    elif full:
        qbase = np.full((N,), full_pos, np.int32)
    else:
        rng = np.random.default_rng(seed)
        tables[1, :4] = tables[0, :4]
        real = {2: 5, 3: 1}
        for n, r in real.items():
            tables[n, r:] = 0
        qbase = rng.integers(0, full_pos + 1, N).astype(np.int32)
        qbase[0], qbase[1] = full_pos, 0
        for n, r in real.items():
            qbase[n] = rng.integers(0, max(1, r * PAGE - Q + 1))
    return (q, kv, torch.from_numpy(tables).to(dev),
            torch.from_numpy(qbase).to(dev))


def f32_tree(kv):
    """The pools at f32 on the same values: fp8 pages dequantized in f32
    (what the kernel computes on), float pools widened."""
    if "k_scale" in kv:
        return {n: kv[n].float() * kv[n + "_scale"][..., None, None]
                for n in ("k", "v")}
    return {n: t.float() for n, t in kv.items()}


def library_attention(q, kv, layer, tables, qbase):
    """Yardstick only, never called by the port: a page gather (and, for
    fp8 pools, the dequantization in the query's dtype) followed by
    ``scaled_dot_product_attention`` with the flat-position mask (no one
    library call walks a page table)."""
    N, H, Q, hd = q.shape
    P, ps = tables.shape[1], kv["k"].shape[3]
    t = tables.long()

    def flat(name):
        pool = kv[name]
        if "k_scale" in kv:
            pages = pool.view(torch.uint8)[layer][t].view(pool.dtype) \
                .to(q.dtype) * kv[name + "_scale"][layer][t][..., None, None] \
                .to(q.dtype)
        else:
            pages = pool[layer][t]
        return pages.permute(0, 2, 1, 3, 4).reshape(N, H, P * ps, hd)

    qpos = qbase.long()[:, None] + torch.arange(Q, device=q.device)
    mask = (torch.arange(P * ps, device=q.device)[None, None, None, :]
            <= qpos[:, None, :, None])
    return F.scaled_dot_product_attention(q, flat("k"), flat("v"),
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
    inputs: each live K/V page read once (pages past a row's last query
    position are masked and need not be read) with its two scales when
    fp8, q/tables/qbase read and the output written once; 4 * hd flops
    per admitted (query, key, head), plus one multiply per dequantized
    fp8 element, at the tensor-core rate of the queries' type (bf16) or
    the f32 rate, as :func:`flash_bound` counts."""
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
    if "k_scale" in kv:
        page_bytes += H * 4
    nbytes = (2 * len(live) * page_bytes + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + qbase.numel() * 4)
    flops = 4 * hd * H * admitted
    if "k_scale" in kv:
        flops += 2 * len(live) * H * ps * hd
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    return (*bound(nbytes, flops, peak), nbytes, flops)


def check_kernel(label: str, kind: str, q, kv, tables, qbase) -> float:
    """The kernel against the plain version at f32 on the same
    (dequantized) values, at a middle layer; returns the max abs
    error."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    layer = LAYERS // 2
    got = pa.paged_attention(q, kv, layer, tables, qbase)
    want = pa.paged_attention_reference(q.float(), f32_tree(kv), layer,
                                        tables, qbase)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"kernel output {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    err = float((got.float() - want).abs().max())
    tol = KIND_TOL[kind]
    say("kernel", f"{label} {kind}: max abs err {err:.3e} (tolerance "
                  f"{tol:g})")
    check(err <= tol, f"kernel disagrees with the reference at {label} "
                      f"{kind}: {err:.3e} > {tol:g}")
    return err


#: N=1 query positions of the prefix-prefill checks: page-aligned and
#: mid-page (a copy-on-write or session resume point)
PREFIX_QBASE = {32: (192, 200), 64: (192, 200), 128: (224, 287), 512: (0,)}


def time_row(name: str, label: str, q, kv, tables, qbase,
             max_err: float) -> dict:
    """The kernel's time at one shape beside its plain version's, the
    library yardstick's and the bound; launches cycle over the 12 layers
    (151 MB of float pools, more than the 50 MB L2) so each one reads its
    pages from HBM as the serving path does."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    lib = library_attention(q, kv, 0, tables, qbase)
    ref = pa.paged_attention_reference(q.float(), f32_tree(kv), 0, tables,
                                       qbase)
    lib_err = float((lib.float() - ref).abs().max())
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
    say("kernel", f"{label}: kernel {kern_ms:.4f} / {kern_ms2:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library (yardstick the port never "
                  f"calls; max abs err {lib_err:.3e} vs the reference) "
                  f"{lib_ms:.4f} ms")
    peak = "989 TFLOP/s bf16" if q.dtype == torch.bfloat16 \
        else "67 TFLOP/s f32"
    say("kernel", f"  bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B at "
                  f"3.35 TB/s, {flops} flop at {peak}); kernel at "
                  f"{nbytes / (min(kern_ms, kern_ms2) * 1e-3) / 1e9:.1f} GB/s")
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
            "replaces": "deeplearning4j_tpu/ops/paged_attention_pallas.py:203",
            "launches": 0, "max_abs_err": max_err,
            "ms": min(kern_ms, kern_ms2), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def phase_kernel() -> dict:
    """Every shape the serving paths give the kernel, then its times at
    the decode (float and fp8 pools), verify and prefix shapes. Returns
    the kernel rows by name."""
    errs = {"float": 0.0, "fp8": 0.0, "verify": 0.0, "prefix": 0.0}
    # decode: N=8, Q=1 (and the old Q=4 case), float and fp8 pools
    for kind in KINDS:
        for Q in ((1, 4) if kind in ("f32", "bf16") else (1,)):
            for full in (False, True):
                args = kernel_case(Q, kind, seed=Q, full=full)
                err = check_kernel(f"decode N={SLOTS} Q={Q} "
                                   f"{'full' if full else 'mixed'}", kind,
                                   *args)
                key = "fp8" if kind.startswith("fp8") else "float"
                errs[key] = max(errs[key], err)
    # verify: N=8, Q = k + 1 for k in {2, 4, 8}
    for Q in (3, 5, 9):
        for kind in KINDS:
            err = check_kernel(f"verify N={SLOTS} Q={Q}", kind,
                               *kernel_case(Q, kind, seed=10 + Q))
            errs["verify"] = max(errs["verify"], err)
    # prefix prefill: N=1, Q = the suffix bucket, page-aligned and mid-page
    for Q, bases in PREFIX_QBASE.items():
        for qb in bases:
            for kind in KINDS:
                err = check_kernel(f"prefix N=1 Q={Q} qbase={qb}", kind,
                                   *kernel_case(Q, kind, seed=20 + Q, N=1,
                                                qbase=qb))
                errs["prefix"] = max(errs["prefix"], err)
    rows = {}
    rows["paged_attention"] = time_row(
        "paged_attention", f"decode N={SLOTS} H={HEADS} Q=1 hd={HEAD_DIM} "
        f"ps={PAGE} P={PAGES_PER_SLOT} bf16, full context",
        *kernel_case(1, "bf16", seed=7, full=True), errs["float"])
    rows["paged_attention_fp8"] = time_row(
        "paged_attention_fp8", f"decode N={SLOTS} Q=1 fp8 pools, bf16 "
        f"queries, full context", *kernel_case(1, "fp8-bf16", seed=8,
                                               full=True), errs["fp8"])
    rows["paged_attention_verify"] = time_row(
        "paged_attention_verify", f"verify N={SLOTS} Q=5 bf16, full context",
        *kernel_case(5, "bf16", seed=9, full=True), errs["verify"])
    rows["paged_attention_prefix"] = time_row(
        "paged_attention_prefix", "prefix N=1 Q=128 qbase=287 bf16 (a "
        "resumed second turn)", *kernel_case(128, "bf16", seed=11, N=1,
                                             qbase=287), errs["prefix"])
    return rows


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


def profile_window(eng, jobs, phase: str = "profile",
                   sequential: bool = False) -> None:
    """The device profile of one batch (prefill and decode) served by a
    running engine."""
    steps0 = eng.n_steps

    def run():
        run_jobs(eng, jobs, sequential=sequential)

    device_profile(phase, f"{len(jobs)} requests", run,
                   ("paged_attention",))
    say(phase, f"  ({eng.n_steps - steps0} decode steps and verify passes)")


def reset_launches(eng) -> tuple:
    """Zero the kernel's counts just before a driven run; returns the
    engine's (decode steps, warm admissions, verify passes) so far."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    torch.cuda.synchronize()
    pa.launches = pa.multi_row_launches = 0
    return eng.n_steps, eng.n_warm_admissions, eng.n_verify_dispatches


def launch_check(tag: str, eng, since: tuple) -> tuple:
    """Every decode step, verify pass and suffix prefill since ``since``
    (from :func:`reset_launches`) went through the kernel, one launch
    per layer each: one-row launches are the decode steps (the engine
    counts a verify pass as a step too), multi-row ones the verify
    passes and warm admissions. Returns (launches, one-row launches,
    multi-row launches)."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    launches, multi = pa.launches, pa.multi_row_launches
    steps = eng.n_steps - since[0]
    warm = eng.n_warm_admissions - since[1]
    verify = eng.n_verify_dispatches - since[2]
    L = eng.model.cfg.n_layers
    check(steps > 0 and launches - multi == L * (steps - verify)
          and multi == L * (warm + verify),
          f"{tag}: kernel launches {launches - multi} one-row + {multi} "
          f"multi-row != {L} layers x ({steps - verify} decode steps) + "
          f"{L} x ({verify} verify passes + {warm} warm admissions)")
    return launches, launches - multi, multi


def run_jobs(eng, jobs, sequential: bool = False, **kw):
    """Serve ``jobs`` (prompt, max_new[, session_id]); returns (tokens,
    requests, wall seconds)."""
    t0 = time.perf_counter()
    if sequential:
        reqs = []
        for j in jobs:
            reqs.append(eng.submit(j[0], j[1], session_id=(
                j[2] if len(j) > 2 else None), **kw))
            reqs[-1].result(timeout=600)
    else:
        reqs = [eng.submit(j[0], j[1], **kw) for j in jobs]
    outs = [r.result(timeout=600) for r in reqs]
    return outs, reqs, time.perf_counter() - t0


def ttft_ms(reqs, q: float) -> float:
    return float(np.percentile([r.ttft_s for r in reqs], q) * 1e3)


def agreement(outs, ref) -> str:
    same = sum(int(np.array_equal(a, b)) for a, b in zip(outs, ref))
    agree = sum(common_prefix(a, b) for a, b in zip(outs, ref))
    return (f"{same}/{len(ref)} requests identical, common prefix "
            f"{agree}/{sum(len(b) for b in ref)} tokens")


def check_same(tag: str, outs, ref) -> None:
    for i, (a, b) in enumerate(zip(outs, ref)):
        check(np.array_equal(a, b), f"{tag}, request {i}: {a.tolist()} != "
                                    f"{b.tolist()}")


def phase_serve(rows: dict) -> dict:
    from deeplearning4j_tpu_torch.models.gpt import (
        CausalLM, init_params_numpy, params_from_jax)
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg = serve_config()
    t0 = time.perf_counter()
    tree = init_params_numpy(cfg, seed=0)
    params = params_from_jax(tree, device=DEVICE)
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
        page_bytes = eng.pool.bytes_per_page()
        say("serve", f"pool {eng.pool.n_pages} pages of {page_bytes} B")
        eng.generate(jobs[0][0][:16], 4)          # first CUDA calls
        steps0, dec0 = eng.n_steps, eng.decode_seconds
        since = reset_launches(eng)
        outs, reqs, wall = run_jobs(eng, jobs)
        launches, _, _ = launch_check("serve", eng, since)
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
    rows["paged_attention"]["launches"] = launches
    tokens = sum(len(o) for o in outs)
    say("serve", f"{tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} "
                 f"tokens/s; TTFT p50 {ttft_ms(reqs, 50):.1f} ms, "
                 f"p99 {ttft_ms(reqs, 99):.1f} ms; decode "
                 f"{dec_s / steps * 1e3:.3f} ms/step over {steps} steps "
                 f"(avg occupancy {occupancy:.3f}); kernel launches "
                 f"{launches} = {cfg.n_layers} x {steps}")
    # bf16: agreement with the dense generate() is reported, not required
    # (one-ulp argmax ties on random weights are expected at bf16)
    dense = [model.generate(params, p[None], n)[0].cpu().numpy()
             for p, n in jobs[:8]]
    say("serve", f"bf16 engine vs dense generate(): "
                 f"{agreement(outs[:8], dense)}")

    # f32: engine tokens must equal the dense generate() exactly
    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    jobs32 = [(p, min(n, 32)) for p, n in jobs[:4]]
    with DecodeEngine(model32, params, slots=SLOTS, page_size=PAGE,
                      max_context=MAX_CONTEXT, device=DEVICE) as eng32:
        outs32, _, _ = run_jobs(eng32, jobs32)
    check(eng32.pool.allocated == 0, "f32 pool did not drain")
    check_same("f32 engine vs generate()", outs32, [
        model32.generate(params, p[None], n)[0].cpu().numpy()
        for p, n in jobs32])
    say("serve", f"f32 engine == dense generate() for {len(jobs32)} "
                 f"requests ({sum(n for _, n in jobs32)} tokens)")
    return {"cfg": cfg, "tree": tree, "params": params, "jobs": jobs,
            "outs": outs, "tokens_per_s": tokens / wall,
            "page_bytes": page_bytes, "cpu_params": None}


def cpu_params(ctx: dict):
    """The same numpy weights on the CPU, for the twin engines (built
    once)."""
    from deeplearning4j_tpu_torch.models.gpt import params_from_jax

    if ctx["cpu_params"] is None:
        ctx["cpu_params"] = params_from_jax(ctx["tree"], device="cpu")
    return ctx["cpu_params"]


def fp8_code_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Steps between two float8_e4m3fn byte patterns along the number
    line (sign-magnitude: the low 7 bits order the magnitudes)."""
    sa, sb = (a >> 7).astype(np.int64), (b >> 7).astype(np.int64)
    ma, mb = (a & 0x7F).astype(np.int64), (b & 0x7F).astype(np.int64)
    va = np.where(sa == 1, -ma, ma)
    vb = np.where(sb == 1, -mb, mb)
    return np.abs(va - vb)


def phase_fp8(ctx: dict, rows: dict) -> None:
    """fp8 KV pages: phase 4's traffic at bf16 with kv_dtype="fp8_e4m3",
    then at f32 the pools after prefill and the greedy tokens on the card
    against a CPU twin (the plain versions)."""
    from deeplearning4j_tpu_torch.models.gpt import CausalLM
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg, params, jobs = ctx["cfg"], ctx["params"], ctx["jobs"]
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    eng = DecodeEngine(model, params, slots=SLOTS, page_size=PAGE,
                       max_context=MAX_CONTEXT, device=DEVICE,
                       kv_dtype="fp8_e4m3")
    with eng:
        eng.generate(jobs[0][0][:16], 4)
        steps0 = eng.n_steps
        since = reset_launches(eng)
        outs, reqs, wall = run_jobs(eng, jobs)
        launches, _, _ = launch_check("fp8", eng, since)
        steps = eng.n_steps - steps0
        fp8_bytes = eng.pool.bytes_per_page()
        profile_window(eng, serving_jobs(cfg.vocab_size, 8, seed=2), "fp8")
    check(eng.pool.allocated == 0, "fp8 pool did not drain")
    rows["paged_attention_fp8"]["launches"] = launches
    tokens = sum(len(o) for o in outs)
    say("fp8", f"{tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} "
               f"tokens/s (float pools {ctx['tokens_per_s']:.1f}); TTFT p50 "
               f"{ttft_ms(reqs, 50):.1f} ms, p99 {ttft_ms(reqs, 99):.1f} ms; "
               f"page {fp8_bytes} B against {ctx['page_bytes']} B bf16 "
               f"({fp8_bytes / ctx['page_bytes']:.4f}); kernel launches "
               f"{launches} = {cfg.n_layers} x {steps}")
    say("fp8", f"bf16 fp8 engine vs float engine (reported, not a gate): "
               f"{agreement(outs, ctx['outs'])}")

    # f32: the card against the CPU twin. Sessions pin each prompt's
    # pages after its prefill (one new token), so the pools hold them
    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    jobs32 = [(p, 24) for p, _ in jobs[:4]]
    snap, toks, pages = {}, {}, {}
    for dev, prm in ((DEVICE, params), ("cpu", cpu_params(ctx))):
        kw = dict(slots=SLOTS, page_size=PAGE, max_context=MAX_CONTEXT,
                  device=dev, kv_dtype="fp8_e4m3")
        with DecodeEngine(model32, prm, session_capacity=4, **kw) as e:
            run_jobs(e, [(p, 1, f"u{i}") for i, (p, _) in
                         enumerate(jobs32)], sequential=True)
            pages[dev] = sorted(e.pool._refs)
            snap[dev] = {n: (t.view(torch.uint8) if t.dtype ==
                             torch.float8_e4m3fn else t)[:, pages[dev]]
                         .cpu().numpy() for n, t in e.pool.tree().items()}
        check(e.pool.allocated == 0, f"f32 fp8 pool on {dev} did not drain")
        with DecodeEngine(model32, prm, **kw) as e:
            toks[dev], _, _ = run_jobs(e, jobs32)
    check(pages[DEVICE] == pages["cpu"] and len(pages["cpu"]) > 0,
          f"pinned pages differ: {pages[DEVICE]} / {pages['cpu']}")
    card, cpu = snap[DEVICE], snap["cpu"]
    for n in ("k", "v"):
        dist = fp8_code_distance(card[n], cpu[n])
        frac = float((dist > 0).mean())
        rel = float(np.abs(card[n + "_scale"] / cpu[n + "_scale"] - 1).max())
        say("fp8", f"f32 {n} pages after prefill, card vs CPU: "
                   f"{int((dist > 0).sum())} of {dist.size} bytes differ "
                   f"({frac:.2e}), at most {int(dist.max())} e4m3 step(s); "
                   f"scales max relative diff {rel:.2e}")
        check(dist.max() <= 1 and frac <= 1e-3,
              f"fp8 {n} bytes: card and CPU differ beyond one e4m3 step "
              f"at a rounding boundary")
        check(rel <= 1e-5, f"fp8 {n} scales differ by {rel:.2e}")
    check_same("f32 fp8 card vs CPU", toks[DEVICE], toks["cpu"])
    say("fp8", f"f32 fp8 card tokens == CPU twin for {len(jobs32)} requests "
               f"({sum(n for _, n in jobs32)} tokens)")


def shared_prefix_requests(vocab: int, n_users: int, system_len: int,
                           user_len: int, seed: int = 0):
    """bench_gpt_decode.py's prefix_ab traffic: one shared system
    prompt, distinct user suffixes."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, (system_len,)).astype(np.int32)
    return [np.concatenate(
        [sys_p, rng.integers(0, vocab, (user_len,)).astype(np.int32)])
        for _ in range(n_users)]


def prefix_turns(eng, prompts, new: int, new2: int, added: int):
    """Each user's first turn, submitted one after another, then one
    second turn per user that adds ``added`` tokens to the whole first
    turn (a sticky-session resume when the engine has sessions). Returns
    (turn-1 tokens, turn-1 requests, turn-2 prompts, turn-2 tokens,
    turn-2 requests)."""
    rng = np.random.default_rng(5)
    outs1, reqs1, _ = run_jobs(eng, [(p, new, f"user{i}")
                                     for i, p in enumerate(prompts)],
                               sequential=True)
    second = [np.concatenate([p, o, rng.integers(
        0, eng.model.cfg.vocab_size, (added,)).astype(np.int32)])
        for p, o in zip(prompts, outs1)]
    outs2, reqs2, _ = run_jobs(eng, [(p, new2, f"user{i}")
                                     for i, p in enumerate(second)],
                               sequential=True)
    return outs1, reqs1, second, outs2, reqs2


def phase_prefix(ctx: dict, rows: dict) -> None:
    """prefix_ab's traffic (16 users, a 192-token system prompt, 32-token
    suffixes, 64 new tokens, one after another) cold and then warm at
    bf16, plus a second turn per user that adds 80 tokens: a session
    resume whose suffix bucket is 128, Q > 32 through the kernel. At f32
    warm and resumed tokens must equal cold ones."""
    from deeplearning4j_tpu_torch.models.gpt import CausalLM
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg, params = ctx["cfg"], ctx["params"]
    users, system, user, new, added, new2 = 16, 192, 32, 64, 80, 32
    prompts = shared_prefix_requests(cfg.vocab_size, users, system, user)
    kw = dict(slots=SLOTS, page_size=PAGE, max_context=MAX_CONTEXT,
              device=DEVICE)
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    # request 0 fills the cache and pays each engine's first calls: the
    # turn-1 TTFT medians leave it out on both sides, as prefix_ab does
    with DecodeEngine(model, params, **kw) as cold:
        c1, creqs1, second, c2, creqs2 = prefix_turns(cold, prompts, new,
                                                      new2, added)
    warm = DecodeEngine(model, params, prefix_cache=True,
                        session_capacity=users, **kw)
    with warm:
        steps0, warm0 = warm.n_steps, warm.n_warm_admissions
        since = reset_launches(warm)
        w1, wreqs1, second_w, w2, wreqs2 = prefix_turns(warm, prompts, new,
                                                        new2, added)
        launches, one_row, multi = launch_check("prefix", warm, since)
        n_warm = warm.n_warm_admissions - warm0
        n_steps = warm.n_steps - steps0
        st = warm.prefix_stats()
        more = shared_prefix_requests(cfg.vocab_size, users + 4, system,
                                      user)[users:]
        profile_window(warm, [(p, new) for p in more], "prefix",
                       sequential=True)
    check(warm.pool.allocated == 0, "prefix pool did not drain")
    # a user's second turn extends its own first turn, so at bf16 the
    # cold and warm second prompts differ where the first turns did
    same2 = [i for i in range(users)
             if np.array_equal(second[i], second_w[i])]
    hits1 = [r.cache_hit_tokens for r in wreqs1[1:]]
    hits2 = [r.cache_hit_tokens for r in wreqs2]
    check(min(hits1) >= system and min(hits2) >= system + user + new - 1,
          f"warm hits {hits1} / resumed hits {hits2}")
    rows["paged_attention_prefix"]["launches"] = multi
    say("prefix", f"{users} users, system {system} + user {user} tokens, "
                  f"{new} new, one after another: TTFT p50 cold "
                  f"{np.median([r.ttft_s for r in creqs1[1:]]) * 1e3:.2f} ms, "
                  f"warm {np.median([r.ttft_s for r in wreqs1[1:]]) * 1e3:.2f} "
                  f"ms; mean hit tokens {np.mean(hits1):.1f}")
    say("prefix", f"second turn (+{added} tokens, suffix bucket 128, "
                  f"{new2} new): TTFT p50 cold "
                  f"{np.median([r.ttft_s for r in creqs2]) * 1e3:.2f} ms, "
                  f"resumed {np.median([r.ttft_s for r in wreqs2]) * 1e3:.2f}"
                  f" ms; mean hit tokens {np.mean(hits2):.1f}; "
                  f"{st['sessions']['resumed_total']} resumes")
    say("prefix", f"kernel launches {launches}: {one_row} one-row = "
                  f"{cfg.n_layers} x {n_steps} decode steps, {multi} at "
                  f"N=1 Q = suffix bucket = {cfg.n_layers} x {n_warm} warm "
                  f"admissions; bf16 warm vs cold: {agreement(w1, c1)}; "
                  f"resumed vs cold, over the {len(same2)} users whose "
                  f"second prompts agree: "
                  f"{agreement([w2[i] for i in same2], [c2[i] for i in same2])}")

    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    few = prompts[:4]
    with DecodeEngine(model32, params, **kw) as cold:
        c1, _, _, c2, _ = prefix_turns(cold, few, new, new2, added)
    with DecodeEngine(model32, params, prefix_cache=True,
                      session_capacity=users, **kw) as warm:
        w1, r1, _, w2, r2 = prefix_turns(warm, few, new, new2, added)
    check(all(r.cache_hit_tokens > 0 for r in r1[1:] + r2),
          "f32 warm run reused nothing")
    check_same("f32 warm vs cold", w1, c1)
    check_same("f32 resumed vs cold", w2, c2)
    say("prefix", f"f32: warm == cold and resumed == cold for {len(few)} "
                  f"users ({len(few) * (new + new2)} tokens)")


def phase_spec(ctx: dict, rows: dict) -> None:
    """Speculative decoding on phase 4's mixed traffic, k in {2, 4, 8},
    against plain decoding in the same phase; at f32 the tokens must
    equal plain."""
    from deeplearning4j_tpu_torch.models.gpt import CausalLM
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg, params, jobs = ctx["cfg"], ctx["params"], ctx["jobs"]
    kw = dict(slots=SLOTS, page_size=PAGE, max_context=MAX_CONTEXT,
              device=DEVICE)
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    with DecodeEngine(model, params, **kw) as eng:
        eng.generate(jobs[0][0][:16], 4)
        plain, _, plain_s = run_jobs(eng, jobs)
    tokens = sum(len(o) for o in plain)
    say("spec", f"plain: {tokens / plain_s:.1f} tokens/s")
    total = 0
    for k in (2, 4, 8):
        eng = DecodeEngine(model, params, spec_decode=k, **kw)
        with eng:
            eng.generate(jobs[0][0][:16], 4)
            since = reset_launches(eng)
            outs, _, wall = run_jobs(eng, jobs)
            _, _, multi = launch_check(f"spec k={k}", eng, since)
            sp = eng.stats()["spec"]
            if k == 4:
                profile_window(eng, serving_jobs(cfg.vocab_size, 8, seed=2),
                               "spec")
        total += multi
        check(eng.pool.allocated == 0, f"spec k={k} pool did not drain")
        check(sp["verify_dispatches"] > 0, f"spec k={k} never verified")
        say("spec", f"k={k}: {tokens / wall:.1f} tokens/s "
                    f"({plain_s / wall:.3f}x plain); acceptance "
                    f"{sp['acceptance']:.3f}, {sp['tokens_per_dispatch']:.3f}"
                    f" tokens per verify per lane over "
                    f"{sp['verify_dispatches']} verify passes; bf16 vs "
                    f"plain: {agreement(outs, plain)}")
    rows["paged_attention_verify"]["launches"] = total

    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    jobs32 = [(p, min(n, 32)) for p, n in jobs[:6]]
    with DecodeEngine(model32, params, **kw) as eng:
        plain32, _, _ = run_jobs(eng, jobs32)
    for k in (2, 4, 8):
        with DecodeEngine(model32, params, spec_decode=k, **kw) as eng:
            outs32, _, _ = run_jobs(eng, jobs32)
        check_same(f"f32 spec k={k} vs plain", outs32, plain32)
    say("spec", f"f32: spec k in (2, 4, 8) == plain for {len(jobs32)} "
                f"requests")


def phase_int8(ctx: dict) -> None:
    """int8 decode weights: phase 4's traffic at bf16, then at f32 the
    card's tokens against a CPU twin."""
    from deeplearning4j_tpu_torch.models.gpt import CausalLM
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg, params, jobs = ctx["cfg"], ctx["params"], ctx["jobs"]
    kw = dict(slots=SLOTS, page_size=PAGE, max_context=MAX_CONTEXT,
              quantization="int8")
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    eng = DecodeEngine(model, params, device=DEVICE, **kw)
    with eng:
        eng.generate(jobs[0][0][:16], 4)
        since = reset_launches(eng)
        outs, reqs, wall = run_jobs(eng, jobs)
        launch_check("int8", eng, since)
    check(eng.pool.allocated == 0, "int8 pool did not drain")
    tokens = sum(len(o) for o in outs)
    say("int8", f"{tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} "
                f"tokens/s (float weights {ctx['tokens_per_s']:.1f}); TTFT "
                f"p50 {ttft_ms(reqs, 50):.1f} ms; vs float weights "
                f"(reported): {agreement(outs, ctx['outs'])}")
    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    jobs32 = [(p, 24) for p, _ in jobs[:4]]
    toks = {}
    for dev, prm in ((DEVICE, params), ("cpu", cpu_params(ctx))):
        with DecodeEngine(model32, prm, device=dev, **kw) as e:
            toks[dev], _, _ = run_jobs(e, jobs32)
    check_same("f32 int8 card vs CPU", toks[DEVICE], toks["cpu"])
    say("int8", f"f32 int8 card tokens == CPU twin for {len(jobs32)} "
                f"requests")


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


# ------------------------------------------------- conv / tail kernels (B4, B3)
# (kind, N, H, W, Cin, Cout): every stride-1 conv class of ResNet-50's
# bottleneck stacks at batch 256 (bench_conv_pallas.py:23-37)
CONV_SHAPES = [
    ("1x1", 256, 56, 56, 64, 64),
    ("1x1", 256, 56, 56, 64, 256),
    ("1x1", 256, 56, 56, 256, 64),
    ("1x1", 256, 28, 28, 512, 128),
    ("1x1", 256, 28, 28, 128, 512),
    ("1x1", 256, 14, 14, 1024, 256),
    ("1x1", 256, 14, 14, 256, 1024),
    ("1x1", 256, 7, 7, 2048, 512),
    ("1x1", 256, 7, 7, 512, 2048),
    ("3x3", 256, 56, 56, 64, 64),
    ("3x3", 256, 28, 28, 128, 128),
    ("3x3", 256, 14, 14, 256, 256),
    ("3x3", 256, 7, 7, 512, 512),
]
#: (N, H, W, C): the four residual joins of batch-256 ResNet-50
#: (bench_residual_tail.py:31-36)
TAIL_SHAPES = [(256, 56, 56, 256), (256, 28, 28, 512), (256, 14, 14, 1024),
               (256, 7, 7, 2048)]
#: the shape of each kernel's row in the kernels line
CONV_ROW_SHAPES = {"1x1": ("1x1", 256, 56, 56, 64, 256),
                   "3x3": ("3x3", 256, 56, 56, 64, 64)}
TAIL_ROW_SHAPE = (256, 56, 56, 256)
#: ResNet-50's identity bottleneck stages (zoo/resnet50.py:46-56): (H = W,
#: block width C, bottleneck width)
RESNET_STAGES = [(56, 256, 64), (28, 512, 128), (14, 1024, 256),
                 (7, 2048, 512)]
RESNET_BATCH, RESNET_PARITY_BATCH = 256, 8


def conv_bound(x, w, y, taps: int):
    """(bound_ms, bound_by, bytes, flops) of one conv + BN-stats call: x
    and w read once, y and the two f32 [Cout] vectors written once; 2 flops
    per product of the implicit GEMM, at the tensor-core rate of the
    inputs' type."""
    rows, cin, cout = y.numel() // y.shape[-1], x.shape[-1], y.shape[-1]
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + y.numel() * y.element_size() + 2 * cout * 4)
    flops = 2 * rows * taps * cin * cout
    peak = BF16_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS
    return (*bound(nbytes, flops, peak), nbytes, flops)


def tail_bound(x):
    """(bound_ms, bound_by, bytes, flops) of one residual-tail call: x and
    res read once, out written once, four f32 [C] vectors read once; 6
    f32 operations per element."""
    c = x.shape[-1]
    nbytes = 3 * x.numel() * x.element_size() + 4 * c * 4
    flops = 6 * x.numel()
    return (*bound(nbytes, flops, F32_FLOPS), nbytes, flops)


def conv_errors(y, m, v, ry, rm, rv) -> tuple:
    """(y err / max |y|, mean err / max |y|, var err / max E[y^2]) of a
    kernel result against its plain version at f32."""
    ymax = float(ry.abs().max())
    e2 = float((rv + rm * rm).max())
    return (float((y.float() - ry).abs().max()) / ymax,
            float((m - rm).abs().max()) / ymax,
            float((v - rv).abs().max()) / e2)


#: tolerances of the bf16 conv checks against the plain version's f32
#: product of the same bf16 values: y one bf16 rounding (2^-8 of max |y|);
#: the statistics come from f32 accumulators on both sides and differ only
#: in summation order over up to 802,816 rows
CONV_TOL = (2 ** -8, 1e-5, 1e-4)


def phase_conv_kernels() -> tuple:
    """Rows of B4a, B4b and B3: each shape through ``Nd4j.exec`` at bf16
    against the plain version at f32 on the same bf16 values, then each
    kernel's time beside its plain version's, a library yardstick the port
    never calls, and its bound."""
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    bf = torch.bfloat16
    rows = {}
    errs = {"1x1": 0.0, "3x3": 0.0}
    for shape in CONV_SHAPES:
        kind, n, h, w_, cin, cout = shape
        g = torch.Generator(device=DEVICE).manual_seed(cin * cout + h)
        x = torch.randn(n, h, w_, cin, generator=g, device=DEVICE).relu_() \
            .to(bf)
        taps = 1 if kind == "1x1" else 9
        wshape = (cin, cout) if taps == 1 else (3, 3, cin, cout)
        w = (torch.randn(wshape, generator=g, device=DEVICE)
             * math.sqrt(2.0 / (taps * cin))).to(bf)
        name = "conv1x1_bn_stats" if taps == 1 else "conv3x3_bn_stats"
        ref = (cb.conv1x1_bn_stats_reference if taps == 1
               else cb.conv3x3_bn_stats_reference)
        y, m, v = Nd4j.exec(name, x, w)
        ry, rm, rv = ref(x.float(), w.float())
        torch.cuda.synchronize()
        check(y.dtype == bf and y.shape == ry.shape,
              f"{name} output {y.dtype} {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(v).all()),
              f"{name} output not finite")
        e = conv_errors(y, m, v, ry, rm, rv)
        errs[kind] = max(errs[kind], float((y.float() - ry).abs().max()))
        check(all(a <= t for a, t in zip(e, CONV_TOL)),
              f"{name} at {shape[1:]}: errors {e} above {CONV_TOL}")
        del ry, rm, rv
        iters = 20
        kern1 = cuda_ms(lambda i: Nd4j.exec(name, x, w), iters, 3)
        plain = cuda_ms(lambda i: ref(x, w), 5, 1)
        if taps == 1:
            x2 = x.reshape(-1, cin)

            def library(i):
                out = torch.matmul(x2, w)
                return torch.var_mean(out, dim=0, correction=0)
        else:
            x_nchw = x.permute(0, 3, 1, 2)          # a channels-last view
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def library(i):
                out = F.conv2d(x_nchw, w_oihw, padding=1)
                return torch.var_mean(out, dim=(0, 2, 3), correction=0)
        lib = cuda_ms(library, iters, 3)
        kern2 = cuda_ms(lambda i: Nd4j.exec(name, x, w), iters, 3)
        ms = min(kern1, kern2)
        bound_ms, bound_by, nbytes, flops = conv_bound(x, w, y, taps)
        say("conv", f"{name} {h}x{w_} {cin}->{cout} N={n} bf16: err/max|y| "
                    f"{e[0]:.2e}, mean {e[1]:.2e}, var/max E[y^2] {e[2]:.2e}; "
                    f"kernel {kern1:.4f} / {kern2:.4f} ms, plain {plain:.4f} "
                    f"ms, library {lib:.4f} ms; bound {bound_ms:.4f} ms by "
                    f"{bound_by} ({nbytes} B, {flops} flop); kernel at "
                    f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
                    f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
                    f"{bound_ms / ms:.3f} of its bound")
        if shape == CONV_ROW_SHAPES[kind]:
            rows[name] = {
                "name": name, "route": "cuda",
                "source": "deeplearning4j_tpu_torch/csrc/conv_bn_stats.cu",
                "replaces": "deeplearning4j_tpu/ops/conv_pallas.py:"
                            + ("88" if taps == 1 else "167"),
                "launches": 0, "max_abs_err": 0.0, "ms": ms,
                "plain_ms": plain, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib}
        del x, w, y, m, v
    rows["conv1x1_bn_stats"]["max_abs_err"] = errs["1x1"]
    rows["conv3x3_bn_stats"]["max_abs_err"] = errs["3x3"]
    say("conv", "library yardsticks (never called by the port): torch.matmul "
                "+ torch.var_mean (1x1), F.conv2d on a channels-last view + "
                "torch.var_mean (3x3), all bf16; plain versions at f32")

    tail_err = 0.0
    for shape in TAIL_SHAPES:
        n, h, w_, c = shape
        g = torch.Generator(device=DEVICE).manual_seed(c + h)
        x = torch.randn(n, h, w_, c, generator=g, device=DEVICE).to(bf)
        res = torch.randn(n, h, w_, c, generator=g, device=DEVICE).relu_() \
            .to(bf)
        mean = 0.1 * torch.randn(c, generator=g, device=DEVICE)
        var = torch.rand(c, generator=g, device=DEVICE) + 0.5
        gamma = torch.rand(c, generator=g, device=DEVICE) + 0.5
        beta = 0.1 * torch.randn(c, generator=g, device=DEVICE)
        args = (x, res, mean, var, gamma, beta)
        out = Nd4j.exec("bn_relu_residual", *args)
        want = rt.residual_tail_reference(x.float(), res.float(), mean, var,
                                          gamma, beta)
        torch.cuda.synchronize()
        check(out.dtype == bf and out.shape == x.shape,
              f"bn_relu_residual output {out.dtype} {tuple(out.shape)}")
        err = float((out.float() - want).abs().max())
        scale = float(want.abs().max())
        tail_err = max(tail_err, err)
        # the same f32 value, rounded once to bf16
        check(err <= 2 ** -8 * scale, f"bn_relu_residual at {shape}: "
                                      f"{err:.3e} > 2^-8 x {scale:.3e}")
        del want
        iters = 20
        kern1 = cuda_ms(lambda i: Nd4j.exec("bn_relu_residual", *args), iters,
                        3)
        plain = cuda_ms(lambda i: rt.residual_tail_reference(*args), 5, 1)
        x_nchw, r_nchw = x.permute(0, 3, 1, 2), res.permute(0, 3, 1, 2)
        lib_kind = "F.batch_norm + add + relu"
        try:
            F.batch_norm(x_nchw, mean, var, gamma, beta, False, 0.0, 1e-5)
        except RuntimeError as e:
            say("tail", f"F.batch_norm refused bf16 input with f32 "
                        f"statistics: {e}")
            lib_kind = None
        if lib_kind:
            def library(i):
                return torch.relu(F.batch_norm(x_nchw, mean, var, gamma, beta,
                                               False, 0.0, 1e-5) + r_nchw)
        else:
            lib_kind = "eager composition"

            def library(i):
                return torch.relu((x - mean) * torch.rsqrt(var + 1e-5)
                                  * gamma + beta + res)
        lib = cuda_ms(library, iters, 3)
        kern2 = cuda_ms(lambda i: Nd4j.exec("bn_relu_residual", *args), iters,
                        3)
        ms = min(kern1, kern2)
        bound_ms, bound_by, nbytes, flops = tail_bound(x)
        say("tail", f"bn_relu_residual {h}x{w_}x{c} N={n} bf16: max abs err "
                    f"{err:.3e} (max |out| {scale:.2f}); kernel {kern1:.4f} / "
                    f"{kern2:.4f} ms, plain {plain:.4f} ms, library "
                    f"({lib_kind}) {lib:.4f} ms; bound {bound_ms:.4f} ms by "
                    f"{bound_by} ({nbytes} B); kernel at "
                    f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
                    f"{bound_ms / ms:.3f} of its bound")
        if shape == TAIL_ROW_SHAPE:
            rows["bn_relu_residual"] = {
                "name": "bn_relu_residual", "route": "cuda",
                "source": "deeplearning4j_tpu_torch/csrc/residual_tail.cu",
                "replaces": "deeplearning4j_tpu/ops/residual_tail_pallas.py:63",
                "launches": 0, "max_abs_err": 0.0, "ms": ms,
                "plain_ms": plain, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib}
        del x, res, out, args
    rows["bn_relu_residual"]["max_abs_err"] = tail_err
    return tuple(rows.values())


# ------------------------------------------------------ ResNet-50 blocks by name
def resnet_block_weights(c: int, mid: int, seed: int) -> dict:
    """An identity bottleneck block's parameters from a numpy seed, in the
    JAX layout: He-normal 1x1 [C, mid], 3x3 HWIO [3, 3, mid, mid], 1x1
    [mid, C], f32; batch-norm gamma near 1 and beta near 0 per conv."""
    rng = np.random.default_rng(seed)
    p = {"w2a": rng.standard_normal((c, mid)) * math.sqrt(2.0 / c),
         "w2b": rng.standard_normal((3, 3, mid, mid))
         * math.sqrt(2.0 / (9 * mid)),
         "w2c": rng.standard_normal((mid, c)) * math.sqrt(2.0 / mid)}
    for tag, width in (("2a", mid), ("2b", mid), ("2c", c)):
        p[f"g{tag}"] = 1.0 + 0.1 * rng.standard_normal(width)
        p[f"b{tag}"] = 0.1 * rng.standard_normal(width)
    return {k: v.astype(np.float32) for k, v in p.items()}


def resnet_block(weights: dict, c: int, dtype: str, device):
    """A SameDiff graph of ResNet-50's identity bottleneck block: conv1x1
    + stats -> batch_norm -> relu -> cast, conv3x3 + stats -> batch_norm
    -> relu -> cast, conv1x1 + stats -> bn_relu_residual with the block
    input as the residual. Convolution weights in ``dtype``, batch-norm
    parameters f32 (bf16 y with f32 statistics promotes to f32; each cast
    brings the next conv's input back to ``dtype``)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    sd = SameDiff.create(device=device)
    x = sd.placeholder("x", shape=(None, None, None, c), dtype=dtype)
    v = {}
    for k, a in weights.items():
        t = torch.from_numpy(a)
        v[k] = sd.var(k, t.to(getattr(torch, dtype)) if k[0] == "w" else t)
    h = x
    for tag, op in (("2a", "conv1x1_bn_stats"), ("2b", "conv3x3_bn_stats")):
        y, m, var = sd.invoke_op(op, [h, v[f"w{tag}"]], n_out=3,
                                 name=f"conv{tag}")
        a = sd.nn.batch_norm(y, v[f"g{tag}"], v[f"b{tag}"], m, var,
                             name=f"bn{tag}")
        h = sd.math.cast(sd.nn.relu(a, name=f"relu{tag}"), dtype=dtype,
                         name=f"cast{tag}")
    y, m, var = sd.invoke_op("conv1x1_bn_stats", [h, v["w2c"]], n_out=3,
                             name="conv2c")
    out = sd.nn.bn_relu_residual(y, x, m, var, v["g2c"], v["b2c"], name="out")
    sd.setLossVariables(out)
    return sd


def conv_counts() -> tuple:
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    return cb.launches_1x1, cb.launches_3x3, rt.launches


def reset_conv_counts() -> None:
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    cb.launches_1x1 = cb.launches_3x3 = rt.launches = 0


def phase_resnet_blocks(rows: dict) -> None:
    """The four identity bottleneck blocks of ResNet-50 as SameDiff graphs
    at batch 256 in bf16, run by name; launches, a gradient through B3, a
    refused gradient through B4, and a save / load round trip."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    graphs, inputs = [], []
    for i, (hw, c, mid) in enumerate(RESNET_STAGES):
        graphs.append(resnet_block(resnet_block_weights(c, mid, seed=i), c,
                                   "bfloat16", DEVICE))
        g = torch.Generator(device=DEVICE).manual_seed(100 + i)
        inputs.append(torch.randn(RESNET_BATCH, hw, hw, c, generator=g,
                                  device=DEVICE).relu_().to(torch.bfloat16))
    for sd, x in zip(graphs, inputs):       # warm-up, untimed
        sd.output({"x": x}, ["out"])
    torch.cuda.synchronize()
    reset_conv_counts()
    outs = [sd.output({"x": x}, ["out"])["out"] for sd, x in
            zip(graphs, inputs)]
    torch.cuda.synchronize()
    counts = conv_counts()
    check(counts == (8, 4, 4), f"launches per output of the four block graphs "
                               f"(B4a, B4b, B3): {counts}, not (8, 4, 4)")
    rows["conv1x1_bn_stats"]["launches"] = counts[0]
    rows["conv3x3_bn_stats"]["launches"] = counts[1]
    rows["bn_relu_residual"]["launches"] = counts[2]
    for (hw, c, mid), x, out in zip(RESNET_STAGES, inputs, outs):
        check(out.dtype == torch.bfloat16 and out.shape == x.shape,
              f"block output {out.dtype} {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()) and float(out.min()) >= 0.0,
              f"block {hw}x{hw}x{c} output not finite or negative")
    say("resnet", f"one output of each block graph launched B4a, B4b, B3 "
                  f"{counts} times (2, 1, 1 per block)")
    for (hw, c, mid), sd, x in zip(RESNET_STAGES, graphs, inputs):
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            sd.output({"x": x}, ["out"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        say("resnet", f"block {hw}x{hw} {c}->{mid}->{c} N={RESNET_BATCH} "
                      f"bf16: {ms:.3f} ms per output ({reps} timed, host "
                      f"clock, synchronised)")
    device_profile("resnet", "one output of each of the four blocks",
                   lambda: [sd.output({"x": x}, ["out"])
                            for sd, x in zip(graphs, inputs)],
                   ("conv_bn_stats", "reduce_stats", "residual_tail"))

    # a gradient through B3: the first stage's 2c gamma and beta, against
    # autograd of the plain formula at f32 on the same tail inputs
    sd, x = graphs[0], inputs[0]
    grads = sd.calculateGradients({"x": x}, wrt=["g2c", "b2c"])
    tail_in = sd.output({"x": x}, [f"conv2c:{j}" for j in range(3)])
    y, m, var = (tail_in[f"conv2c:{j}"] for j in range(3))
    leaves = [sd.getVariable(n).getArr().detach().clone().requires_grad_(True)
              for n in ("g2c", "b2c")]
    with torch.enable_grad():
        plain = rt.residual_tail_reference(y.float(), x.float(), m, var,
                                           *leaves)
        want = torch.autograd.grad(plain.sum(), leaves)
    for n, w in zip(("g2c", "b2c"), want):
        got = grads[n]
        err = float((got.float() - w).abs().max())
        scale = float(w.abs().max())
        check(got.shape == w.shape and err <= 1e-4 * scale,
              f"d{n} through B3: {err:.3e} > 1e-4 x {scale:.3e}")
        say("resnet", f"calculateGradients d{n} ({RESNET_STAGES[0][0]}x"
                      f"{RESNET_STAGES[0][0]} block, through B3's "
                      f"autograd Function): max abs err {err:.3e} against the "
                      f"plain formula's f32 autograd (max |grad| {scale:.3e})")
    try:
        graphs[-1].calculateGradients({"x": inputs[-1]}, wrt=["w2a"])
    except RuntimeError as e:
        check("forward-only" in str(e), f"unexpected error: {e}")
        say("resnet", f"a gradient through B4 raises: {e}")
    else:
        raise RuntimeError("calculateGradients through conv1x1_bn_stats "
                           "returned instead of raising")

    # save and load the 7x7 block's graph (bf16 weights), same output; the
    # zip goes to the git-ignored build directory inside the checkout
    tmp = tempfile.mkdtemp(dir=os.path.join(PKG, "_build"))
    try:
        path = os.path.join(tmp, "block.zip")
        graphs[-1].save(path)
        loaded = SameDiff.load(path, device=DEVICE)
        again = loaded.output({"x": inputs[-1]}, ["out"])["out"]
        check(torch.equal(again, outs[-1]), "the loaded graph's output differs")
        say("resnet", f"save / load of the 7x7 block ({os.path.getsize(path)} "
                      f"B zip, bf16 weights): the same output, bit for bit")
    finally:
        shutil.rmtree(tmp)


#: card (kernels) vs CPU (plain versions), f32 blocks at batch 8: each
#: block's output after three convolutions and batch norms with batch
#: statistics, where the f32 sums differ in order between the two devices
BLOCK_PARITY_TOL = 1e-4


def phase_resnet_parity() -> None:
    """The four blocks at f32, batch 8, full width: the card's graphs (the
    kernels) against the same graphs on the CPU (the plain versions)."""
    for i, (hw, c, mid) in enumerate(RESNET_STAGES):
        weights = resnet_block_weights(c, mid, seed=i)
        rng = np.random.default_rng(200 + i)
        x = np.maximum(rng.standard_normal(
            (RESNET_PARITY_BATCH, hw, hw, c)), 0).astype(np.float32)
        outs = []
        for dev in (DEVICE, "cpu"):
            reset_conv_counts()
            sd = resnet_block(weights, c, "float32", dev)
            outs.append(sd.output({"x": x}, ["out"])["out"].cpu())
            check(conv_counts() == ((2, 1, 1) if dev == DEVICE
                                    else (0, 0, 0)),
                  f"{dev}: launches {conv_counts()}")
        err = float((outs[0] - outs[1]).abs().max())
        scale = float(outs[1].abs().max())
        check(err <= BLOCK_PARITY_TOL * max(1.0, scale),
              f"block {hw}x{hw}x{c} card vs CPU: {err:.3e} > "
              f"{BLOCK_PARITY_TOL:g} x max(1, {scale:.3e})")
        say("resnet-parity", f"block {hw}x{hw} {c}->{mid}->{c} N="
                             f"{RESNET_PARITY_BATCH} f32: card vs CPU max abs "
                             f"err {err:.3e} (max |out| {scale:.3f}, "
                             f"tolerance {BLOCK_PARITY_TOL:g} x max(1, max "
                             f"|out|))")


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
    rows = phase_kernel()
    ctx = phase_serve(rows)
    phase_fp8(ctx, rows)
    phase_prefix(ctx, rows)
    phase_spec(ctx, rows)
    phase_int8(ctx)
    del ctx
    rows.update((r["name"], r) for r in (*phase_flash(), phase_adam()))
    phase_train(rows)
    phase_parity()
    rows.update((r["name"], r) for r in phase_lstm_kernels())
    phase_lstm_train(rows)
    phase_lstm_parity()
    rows.update((r["name"], r) for r in phase_conv_kernels())
    phase_resnet_blocks(rows)
    phase_resnet_parity()
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
