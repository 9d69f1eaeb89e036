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
   started together; ``ptxas`` registers and spills of the kernels the
   slices run (and any ptxas note that it serialized wgmma), and
   ``cuobjdump -sass``: each head-dim instance of the three bf16 flash
   kernels (forward, dk/dv, dq) must hold tensor-core instructions
   (``HMMA``/``HGMMA``), each of the four (taps, BN) instances of the
   bf16 tensor-core conv route ``conv_bn_stats_tc_kernel`` must hold
   ``HGMMA``, each of the six (H, rows) instances of the LSTM
   cluster routes ``lstm_fwd_cluster_kernel`` and
   ``lstm_bwd_cluster_kernel`` and each of the
   eight bf16-query 8-row-tile instances of ``paged_attention_kernel``
   (bf16 or fp8 pools, head_dim 32-128) must hold ``HMMA``;
3. kernel: the paged-attention kernel against its plain PyTorch version
   at every shape the serving paths give it (H=12, hd=64, ps=16, P=32):
   the decode step (N=8, Q=1; float pools and fp8 pools with f32 scale
   planes), the speculative verify (N=8, Q in {3, 5, 9}) and the prefix
   prefill (N=1, Q in {32, 64, 128, 512}, qbase page-aligned and
   mid-page), under f32 and bf16 queries; f32 queries within 1e-5, bf16
   within 2e-2 of the reference run at f32 on the same (dequantized)
   values, the largest error by kind on single rows and 8-row tiles, and
   every warp count per block (1-8) at a mixed decode and a verify case
   in every pool kind; then at the decode (float and fp8), verify (Q=5)
   and prefix (N=1, Q=128) shapes: two calls bit-equal, the kernel's time
   beside the plain version's, a page gather (+ dequantization) +
   ``scaled_dot_product_attention`` yardstick and the bound from the
   bytes it must move, the profiler's device time per call and the
   host's cost per call of the wrapper and of the C entry alone
   (``tools/attention_probe.py``), and those at the f32 engine's decode
   shape;
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
   1e-6, atol 1e-7); the bf16 (tensor-core) flash kernels at hd 32, 64,
   96 and 128, T in {1, 16, 77, 128, 200} and Tq != Tk, no mask or a
   fully masked row, causal off and on (forward within 2e-2, backward
   within 2e-2 of max |grad| with a 1e-5 floor where the gradient is 0
   in exact arithmetic); f16 and head dims 16, 48 and 160 (C9, C10:
   zero-padded or widened copies; f16 within 2e-3), forward and backward;
   then, at the training shape (N=96, bf16), the
   forward and backward kernels against the f32 plain version again
   (within 2e-2, of max |grad| for the backward), two backward calls
   bit-equal, each kernel's time at the training shapes beside its plain
   version's, its bound and a library yardstick the port never calls,
   and each call's device time from the profiler (the backward's split
   between its three kernels);
6. train: BERT-base (``bert_base()``, 108.9 M parameters, random weights
   from a numpy seed in the JAX tree layout) with ``attn_impl="flash"``,
   bf16 compute and f32 masters in one flat buffer, MLM on a fixed batch
   of 96 x 128 tokens with 19 masked positions per row,
   ``masked_capacity=20``, dropout 0.1 from a seeded generator, Adam at
   lr 1e-4: 2 warm-up and 10 timed steps, every layer through the flash
   kernels and every step through one fused Adam launch; the loss must
   start near ln(vocab) and fall. Then a profiled window of 3 steps:
   device busy per step and the flash kernels' share of it;
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
   kernel's own stored ys and cs); both directions at wide shapes (C10:
   N=512 at H=1024 and at H=256, and H=2048) at f32 and bf16, and f16
   calls (C9) against the plain versions; at every one of those shapes the bf16 forward on its
   cluster route (``fwd_route``) and on the first (grid) design, both
   against the plain version and each other within 2e-2, two cluster
   calls bit-equal; the three mixes of f32 and bf16 among x_proj, w_hh
   and the state (C6: the grid route over widened inputs), forward and
   backward against the plain versions on the same mixed inputs (dtypes
   equal, values within 1e-5 (2e-3 under a bf16 w_hh, where the
   recurrence rounds h) or one bf16 step, gradients within 1e-4 of max
   |grad| or one bf16 step); then at the char-LSTM training shape
   (N=256, T=200, H=256, bf16): both directions on their cluster routes
   (``fwd_route``, ``bwd_route``), two calls bit-equal, the first (grid)
   designs against the plain version too, each kernel's time (each
   direction's two designs in turns with cuDNN in the same call) beside
   its plain version's, its bound and a ``torch.nn.LSTM`` (cuDNN)
   yardstick the port never calls, with the port's projection matmul
   plus the kernel beside it (like with like), and the profiler's device
   time per call of each cluster route and the forward's grid design;
9. char-LSTM training: ``TextGenerationLSTM(vocab_size=77, hidden=256)``
   (887,117 parameters, random weights from a numpy seed in the JAX
   layout) through ``MultiLayerNetwork.fit`` at ``bench_common.
   build_char_lstm``'s shape (batch 256 x 200 one-hot characters, labels
   the next character, bf16, standard BPTT, Adam 1e-3): 2 warm-up and 10
   timed steps, exactly 2 forward and 2 backward kernel launches per
   step, the per-character loss starting within 0.5 of ln 77 and falling;
   a profiled window of 3 steps; then the zoo's own tBPTT 50 at f32 on the
   same batch: one ``fit`` is 4 segments, 8 + 8 launches, 4 iterations;
   every bf16 launch on the cluster routes (``fwd_cluster_launches``,
   ``bwd_cluster_launches``); then the JAX bench's wide model (hidden
   1024, C10) on the same batch: a few steps on the grid route, ms/step,
   and B5 at T=200, N=256, H=1024 against its plain version;
10. LSTM parity: the zoo model (hidden 256, tBPTT 50, f32), 3 minibatches
   of 8 x 100 on the card (the kernels) and on the CPU (the plain
   versions) from the same numpy weights (loss 1e-5 relative, parameters
   2e-5 absolute, some parameter moved by at least lr/2); then, on the
   card, ``rnnTimeStep`` fed 64 characters one at a time (batch 4) equals
   ``output()`` over the sequence, and both equal the same network's
   ``output()`` on the CPU (the plain versions), within 1e-5; a changed
   batch size with stored state raises; then the same sampling at bf16,
   every launch on the forward's cluster route, within 2e-2 of bf16
   ``output()``, its ms per character beside f32's;
11. conv / tail kernels: through ``Nd4j.exec`` by name, at batch 256 in
   bf16, the conv + BN-stats kernel (``csrc/conv_bn_stats.cu``) at the 9
   1x1 and 4 3x3 stride-1 shapes of ResNet-50's bottleneck stacks
   (bench_conv_pallas.py:23-37) and the residual-tail kernel
   (``csrc/residual_tail.cu``) at its 4 residual joins
   (bench_residual_tail.py:31-36), each conv against its plain version at
   f32 on the same bf16 values (y within one bf16 rounding, 2^-8 of the
   largest value; means within 1e-5 of max |y|, variances within 1e-4 of
   max E[y^2]: f32 sums in another order), every conv shape on the
   tensor-core route, then each one's time beside the first bf16
   design's (the route odd shapes still take), its plain version's, a
   library yardstick the port never calls (``torch.matmul`` or
   ``F.conv2d`` + ``torch.var_mean``) and its bound; at each conv row
   shape two calls bit-equal and the profiler's device time per call of
   the conv and reduction kernels; the tail in f32, bf16 and both mixes
   of x and res (C5) against its plain version at f32 on the same values
   (f32 within 1e-5, a bf16 output within one bf16 rounding, 2^-8 of the
   largest value), two
   calls bit-equal, each one's time beside its plain version's, the
   library's (``F.batch_norm`` + add + ``relu``) and its byte bound, with
   its share of that bound; f16 by name (C9) for both ops;
11b. batch-norm kernels (``csrc/batch_norm.cu``): the statistics, the
   apply (with and without the ReLU) and the backward at the 9 distinct
   batch-norm shapes of ResNet-50 at batch 256 in bf16 against their
   plain versions (the statistics within 1e-4, the apply bit for bit on
   the same statistics, dx within one bf16 rounding), two calls
   bit-equal, each kernel's time beside its plain version's, the
   library's (``torch.var_mean``, ``F.batch_norm`` forward in inference
   mode, the backward of ``F.batch_norm`` in training mode) and its byte
   bound; the statistics' and the backward's times in turns with their
   two-launch design (``tools/bn_two_launch.cu``, built beside the
   sources) and their launch plans; at 56x56x256 a profiled call of each
   must run one device kernel; the f16 instances at one shape;
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
   max |out|);
14. LeNet: ``zoo.LeNet`` through ``MultiLayerNetwork`` (Nesterovs 0.01,
   0.9) from one numpy tree on the card (cuDNN at f32, TF32 off)
   and on the CPU, three ``fit`` steps at batch 64 on 28x28x1 data:
   losses within 1e-5 relative, parameters within 2e-5, the inference
   output within 2e-5 of max(1, max |out|);
15. ResNet-50 training at full width: ``zoo.ResNet50(num_classes=1000)``
   (25.6 M parameters) through ``ComputationGraph.fit`` at bench.py's
   cell (batch 256, 224x224x3, bf16, ``Nesterovs(0.1, 0.9)``,
   ``RandomState(0)`` images and one-hot labels), ``cudnn.benchmark`` on
   for this phase only: 2 warm-up and 10 timed steps, a finite loss at
   every step; run twice, with ``FUSED_BN_RELU_BWD`` off (the
   reference's default) and on (``batch_norm_relu_train``); each run:
   the batch-norm kernels launched once per BN layer per step (53), ms
   per step, images/s, peak memory, the FLOPs per step counted from the
   graph's conv and dense shapes (2 x MACs, x3 for the backward) over the
   step time and the bf16 peak, each beside the card's ``nvidia-smi``
   line; a profiled step: device busy and idle share, device time by
   group (conv, batch norm, ReLU/add, updater, other), the ten largest
   device operations (no batch-norm work among them outside the kernels)
   and cuDNN's layout transposes; then 5 steps with ``F.batch_norm`` in
   place of the batch norm, a yardstick the port never calls;
16. graph parity: the cut ResNet (``zoo.resnet50.cut_resnet_conf``: the
   stem, a projection block, an identity block, 32x32x3, 4 classes) at
   f32, three ``Nesterovs`` steps on the card and on the CPU from one
   numpy tree (losses 1e-5 relative, parameters 2e-5, BN running state
   2e-5 of max(1, |value|)), then one inference ``output`` alike; with
   ``FUSED_BN_RELU_BWD`` off and on.

Prints progress lines, then a JSON line with every kernel's numbers, the
card's ``nvidia-smi`` line, and last the JSON result line.

``python3 chip_smoke.py tail-times TAG``, run from the root of any tree of
the port (this file given by its path), prints only the residual-tail
kernel's times at the four joins in bf16 and f32 (tagged TAG), for the
port found from the current directory: an earlier design can be timed in
the same chip call as this one. ``python3 chip_smoke.py resnet50-step
TAG`` runs phase 15 alone the same way.
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
                  "lstm_recurrence", "conv_bn_stats", "residual_tail",
                  "batch_norm")

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

    global BN_YARDSTICK
    from concurrent.futures import ThreadPoolExecutor

    from deeplearning4j_tpu_torch.tools import bn_probe

    t0 = time.perf_counter()
    # the batch norm's two-launch design, timed in turns in phase 11b: its
    # nvcc runs beside the sources' (the thread only waits on it)
    pool = ThreadPoolExecutor(1)
    BN_YARDSTICK = pool.submit(
        bn_probe.build, {"two launches": bn_probe.read(bn_probe.TWO_LAUNCH)})
    pool.shutdown(wait=False)
    paths = native.build(KERNEL_SOURCES)
    say("build", f"{len(paths)} sources in {time.perf_counter() - t0:.2f} s")
    # ptxas -v for the instantiations the slices run: head_dim 64 is the
    # template argument 2 (vectors of 32) of paged attention and 64 of
    # flash attention (and 128, where the bf16 dk/dv accumulators are the
    # spill risk); the Adam kernels have no template; the LSTM kernels at
    # one row per thread (the char-LSTM shape's plan) and the backward's
    # cluster route at H=256 (both row tiles)
    marks = {"paged_attention": ("Li2E",),
             "flash_attention": ("Li64E", "Li128E", "deep_kernel"),
             "fused_update": ("",),
             "lstm_recurrence": ("Li1E", "cluster_kernelILi4E",
                                 "wide_kernel"),
             "conv_bn_stats": ("nv_bfloat16",),
             "residual_tail": ("residual_tail_kernelI",),
             "batch_norm": ("nv_bfloat16Li8E",)}
    for name in KERNEL_SOURCES:
        log = native.build_logs.get(name, {})
        say("build", f"{os.path.relpath(paths[name], HERE)}: "
                     f"{log.get('seconds', 0.0):.2f} s")
        lines = str(log.get("output", "")).splitlines()
        for i, ln in enumerate(lines):
            mark = next((m for m in marks[name] if m in ln), None)
            if "Compiling entry function" in ln and mark is not None:
                found = re.search(r"(paged_attention_kernel"
                                  r"|flash_(?:fwd|bwd_[a-z]+)(?:_tc|_deep)?"
                                  r"_kernel"
                                  r"|fused_adam_(?:vec4|scalar)"
                                  r"|lstm_(?:fwd|bwd)(?:_cluster|_wide)?"
                                  r"_kernel"
                                  r"|conv_bn_stats(?:_tc)?_kernel"
                                  r"|residual_tail_kernel"
                                  r"|bn_(?:reduce|apply)_kernel)", ln)
                tc_conv = re.search(
                    r"conv_bn_stats_tc_kernelILi(\d+)ELi(\d+)E", ln)
                cl = re.search(r"cluster_kernelILi(\d)ELi(\d)E", ln)
                wide = "wide_kernel" in ln
                kind = ("bf16" if "nv_bfloat16" in ln or "_tc_" in ln or cl
                        or wide else "f32") \
                    + (" queries, fp8 pools" if "Fp8E4M3" in ln else "") \
                    + (", tensor cores" if any(k in ln for k in
                                               FLASH_TC_KERNELS) else "") \
                    + (f", wgmma, taps {tc_conv.group(1)}, BN "
                       f"{tc_conv.group(2)}" if tc_conv else "") \
                    + (", hd 128" if mark == "Li128E" else "") \
                    + (f", mma.sync, H {64 * int(cl.group(1))}, "
                       f"{16 * int(cl.group(2))} rows per cluster"
                       if cl else "") \
                    + (", mma.sync, wide route" if wide else "") \
                    + (f", template <{tail.group(1)}>" if (tail := re.search(
                        r"residual_tail_kernelI(\w+?)EEv", ln)) else "")
                info = [x.split(":", 1)[-1].strip()
                        for x in lines[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                say("build", f"  ptxas {found.group(1) if found else ln} "
                             f"({kind}): {'; '.join(info)}")
            if "wgmma" in ln and "serialized" in ln:
                say("build", f"  ptxas warning: {ln.strip()}")
    check_tensor_core_sass(paths["flash_attention"], FLASH_TC_KERNELS,
                           r"\bH(?:G)?MMA\b", "head-dim", 4)
    check_tensor_core_sass(paths["conv_bn_stats"], CONV_TC_KERNELS,
                           r"\bHGMMA\b", "(taps, BN)", 4)
    check_tensor_core_sass(paths["lstm_recurrence"], LSTM_TC_KERNELS,
                           r"\bHMMA\b", "(H, rows)", 6)
    check_tensor_core_sass(paths["lstm_recurrence"], LSTM_WIDE_KERNELS,
                           r"\bHMMA\b", "route", 1)
    # paged attention's 8-row tiles under bf16 queries (pools bf16 or fp8,
    # head_dim 32, 64, 96, 128: template arguments 1-4 and rows 8)
    check_tensor_core_sass(paths["paged_attention"], PAGED_TC_KERNELS,
                           r"\bHMMA\b", "(pool, head_dim)", 8,
                           select=r"kernelI13__nv_bfloat16.*?Li[1234]ELi8EE")


#: the bf16 flash-attention kernels, which must run on the tensor cores
FLASH_TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
                    "flash_bwd_dq_tc_kernel")
#: the bf16 conv + BN-stats route that must issue wgmma (HGMMA in SASS)
CONV_TC_KERNELS = ("conv_bn_stats_tc_kernel",)
#: the LSTM cluster routes, whose gate (forward) and dh and gate
#: (backward) products must run on the tensor cores (HMMA in SASS)
LSTM_TC_KERNELS = ("lstm_fwd_cluster_kernel", "lstm_bwd_cluster_kernel")
#: the LSTM wide route (bf16, H past 256): its gate and dh products must
#: run on the tensor cores too
LSTM_WIDE_KERNELS = ("lstm_fwd_wide_kernel", "lstm_bwd_wide_kernel")
#: the paged-attention kernel, whose multi-row bf16 tiles must run on the
#: tensor cores
PAGED_TC_KERNELS = ("paged_attention_kernel",)


def check_tensor_core_sass(lib_path: str, kernels, pattern: str, per: str,
                           instances: int, select: str = "") -> None:
    """``cuobjdump -sass`` of a built library: each of the ``instances``
    instantiations of every kernel in ``kernels`` (those whose mangled name
    matches ``select``, where given) must hold tensor-core instructions
    matching ``pattern`` (``HMMA``/``HGMMA`` for flash attention, ``HGMMA``
    for the conv route, ``HMMA`` for the LSTM and paged-attention routes),
    or the run fails."""
    from deeplearning4j_tpu_torch.ops import native

    tool = os.path.join(os.path.dirname(native.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        kernel = next((k for k in kernels if k in name), None)
        if kernel is not None and re.search(select, name):
            counts.setdefault(kernel, []).append(
                len(re.findall(pattern, fn)))
    for kernel in kernels:
        found = counts.get(kernel, [])
        check(len(found) == instances and min(found) > 0,
              f"{kernel}: {pattern} per {per} instance {found} (cuobjdump "
              f"-sass); need {instances} instances, each > 0")
        say("build", f"  SASS {kernel}: {pattern} per {per} instance "
                     f"{found}")


# ---------------------------------------------------------------- kernel
#: tolerance against the plain version run at f32 on the same (dequantized)
#: values, by the kinds of ``tools/attention_probe.py`` (pool kind and
#: query dtype): f32 queries 1e-5, bf16 queries 2e-2 (the bf16 output
#: rounding)
KIND_TOL = {"f32": 1e-5, "bf16": 2e-2, "fp8-f32": 1e-5, "fp8-bf16": 2e-2}


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
    pages from HBM as the serving path does. Two calls must be bit-equal.
    Then the profiler's device time per call and the host's cost per call
    (``tools/attention_probe.py``)."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.tools import attention_probe as ap

    a = pa.paged_attention_kernel(q, kv, 0, tables, qbase)
    b = pa.paged_attention_kernel(q, kv, 0, tables, qbase)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{label}: two kernel calls differ")
    plan = ap.plan_of(q, kv, tables)
    lib = library_attention(q, kv, 0, tables, qbase)
    ref = pa.paged_attention_reference(q.float(), f32_tree(kv), 0, tables,
                                       qbase)
    lib_err = float((lib.float() - ref).abs().max())
    iters = 240

    def kernel(i):
        pa.paged_attention_kernel(q, kv, i % LAYERS, tables, qbase)

    kern_ms = cuda_ms(kernel, iters)
    plain_ms = cuda_ms(lambda i: pa.paged_attention_reference(
        q, kv, i % LAYERS, tables, qbase), iters)
    lib_ms = cuda_ms(lambda i: library_attention(
        q, kv, i % LAYERS, tables, qbase), iters)
    kern_ms2 = cuda_ms(kernel, iters)
    bound_ms, bound_by, nbytes, flops = attention_bound(q, kv, tables, qbase)
    say("kernel", f"{label}: kernel {kern_ms:.4f} / {kern_ms2:.4f} ms "
                  f"({plan}), plain {plain_ms:.4f} ms, library (yardstick "
                  f"the port never calls; max abs err {lib_err:.3e} vs the "
                  f"reference) {lib_ms:.4f} ms")
    peak = "989 TFLOP/s bf16" if q.dtype == torch.bfloat16 \
        else "67 TFLOP/s f32"
    say("kernel", f"  bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B at "
                  f"3.35 TB/s, {flops} flop at {peak}); kernel at "
                  f"{nbytes / (min(kern_ms, kern_ms2) * 1e-3) / 1e9:.1f} GB/s")
    say_times(q, kv, tables, qbase)
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
            "replaces": "deeplearning4j_tpu/ops/paged_attention_pallas.py:203",
            "launches": 0, "max_abs_err": max_err,
            "ms": min(kern_ms, kern_ms2), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def say_times(q, kv, tables, qbase) -> None:
    """The profiler's device time, the event time and the host's cost per
    call at one shape (``tools/attention_probe.py``'s ``shape_times``)."""
    from deeplearning4j_tpu_torch.tools import attention_probe as ap

    r = ap.shape_times(q, kv, tables, qbase)
    say("kernel", f"  event {r['event_ms'] * 1e3:.1f} us per call, device "
                  f"{r['device_us']:.1f} us per call (profiler, "
                  f"{r['traced']} of 48 launches traced), host "
                  f"{r['host_us']:.1f} us per wrapper call, the C entry "
                  f"alone {r['c_entry_us']:.1f} us")


def check_warp_counts() -> dict:
    """The kernel at every warp count a block takes (1-8 where their rings
    fit one block's shared memory, so warps that get no chunk, and warps
    whose chunks a tile's early rows cannot see),
    at a mixed decode case (shared pages, null-page tails, qbase 0 and
    full context) and a two-tile verify case, in every pool kind, against
    the plain version at f32; at the planned count it must equal the
    wrapper's output bit for bit. Returns the largest error by pool kind
    ("float", "fp8")."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.tools import attention_probe as ap

    worst = {"float": 0.0, "fp8": 0.0}
    for Q in (1, 9):
        for kind in ap.KINDS:
            q, kv, tables, qbase = ap.kernel_case(Q, kind, seed=30 + Q)
            layer = LAYERS // 2
            want = pa.paged_attention_reference(q.float(), f32_tree(kv),
                                                layer, tables, qbase)
            plan = ap.plan_of(q, kv, tables)
            wrapped = pa.paged_attention_kernel(q, kv, layer, tables, qbase)
            rows = 1 if Q == 1 else 8
            for warps in (w for w in range(1, 9) if pa.block_smem(
                    rows, HEAD_DIM, kv["k"].element_size(), tables.shape[1],
                    w) <= pa.SMEM_PER_SM - 1024):
                ints = pa.pack_ints(q, kv["k"], tables,
                                    plan._replace(warps=warps), 0,
                                    "k_scale" in kv)
                got = pa.launch(q, kv, layer, tables, qbase, 0, ints)
                err = float((got.float() - want).abs().max())
                check(err <= KIND_TOL[kind],
                      f"Q={Q} {kind} at {warps} warps: {err:.3e} > "
                      f"{KIND_TOL[kind]:g}")
                check(warps != plan.warps or torch.equal(got, wrapped),
                      f"Q={Q} {kind}: the wrapper's call differs from a "
                      f"launch at its planned {warps} warps")
                pool = "fp8" if kind.startswith("fp8") else "float"
                worst[pool] = max(worst[pool], err)
    torch.cuda.synchronize()
    say("kernel", f"1-8 warps per block where they fit (Q 1 and 9; f32, "
                  f"bf16, fp8 under "
                  f"bf16 and f32 queries): max abs err {worst['float']:.3e} "
                  f"(float pools), {worst['fp8']:.3e} (fp8 pools)")
    return worst


def phase_kernel() -> dict:
    """Every shape the serving paths give the kernel, then its times at
    the decode (float and fp8 pools), verify and prefix shapes. Returns
    the kernel rows by name."""
    from deeplearning4j_tpu_torch.tools import attention_probe as ap

    errs = {"float": 0.0, "fp8": 0.0, "verify": 0.0, "prefix": 0.0}
    # the largest error by kind on single rows (the CUDA cores) and 8-row
    # tiles (under bf16 queries up to head_dim 128, the tensor cores, with
    # the probabilities and fp8's dequantized K and V rounded to bf16)
    by_path = {}

    def note(kind, Q, err):
        key = (kind, "1-row" if Q == 1 else "8-row")
        by_path[key] = max(by_path.get(key, 0.0), err)

    # decode: N=8, Q=1 (and the old Q=4 case), float and fp8 pools
    for kind in ap.KINDS:
        for Q in ((1, 4) if kind in ("f32", "bf16") else (1,)):
            for full in (False, True):
                args = ap.kernel_case(Q, kind, seed=Q, full=full)
                err = check_kernel(f"decode N={SLOTS} Q={Q} "
                                   f"{'full' if full else 'mixed'}", kind,
                                   *args)
                key = "fp8" if kind.startswith("fp8") else "float"
                errs[key] = max(errs[key], err)
                note(kind, Q, err)
    # verify: N=8, Q = k + 1 for k in {2, 4, 8}
    for Q in (3, 5, 9):
        for kind in ap.KINDS:
            err = check_kernel(f"verify N={SLOTS} Q={Q}", kind,
                               *ap.kernel_case(Q, kind, seed=10 + Q))
            errs["verify"] = max(errs["verify"], err)
            note(kind, Q, err)
    # prefix prefill: N=1, Q = the suffix bucket, page-aligned and mid-page
    for Q, bases in PREFIX_QBASE.items():
        for qb in bases:
            for kind in ap.KINDS:
                err = check_kernel(f"prefix N=1 Q={Q} qbase={qb}", kind,
                                   *ap.kernel_case(Q, kind, seed=20 + Q, N=1,
                                                   qbase=qb))
                errs["prefix"] = max(errs["prefix"], err)
                note(kind, Q, err)
    say("kernel", "max abs err by kind and tile: " + ", ".join(
        f"{kind} {rows} {err:.3e} (of {KIND_TOL[kind]:g})"
        for (kind, rows), err in sorted(by_path.items())))
    for pool, err in check_warp_counts().items():
        errs[pool] = max(errs[pool], err)
    rows = {}
    rows["paged_attention"] = time_row(
        "paged_attention", f"decode N={SLOTS} H={HEADS} Q=1 hd={HEAD_DIM} "
        f"ps={PAGE} P={PAGES_PER_SLOT} bf16, full context",
        *ap.kernel_case(1, "bf16", seed=7, full=True), errs["float"])
    rows["paged_attention_fp8"] = time_row(
        "paged_attention_fp8", f"decode N={SLOTS} Q=1 fp8 pools, bf16 "
        f"queries, full context", *ap.kernel_case(1, "fp8-bf16", seed=8,
                                                  full=True), errs["fp8"])
    rows["paged_attention_verify"] = time_row(
        "paged_attention_verify", f"verify N={SLOTS} Q=5 bf16, full context",
        *ap.kernel_case(5, "bf16", seed=9, full=True), errs["verify"])
    rows["paged_attention_prefix"] = time_row(
        "paged_attention_prefix", "prefix N=1 Q=128 qbase=287 bf16 (a "
        "resumed second turn)", *ap.kernel_case(128, "bf16", seed=11, N=1,
                                                qbase=287), errs["prefix"])
    say("kernel", f"decode N={SLOTS} Q=1 f32 pools (the f32 engine's "
                  f"shape), full context:")
    say_times(*ap.kernel_case(1, "f32", seed=12, full=True))
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


def device_profile(phase: str, what: str, run, focus,
                   expect: dict = None, group=None, top: int = 8,
                   out: dict = None) -> float:
    """Device busy share over ``run()`` from a torch.profiler trace: the
    kernels' device times summed over the window's wall time (one
    stream, so kernels do not overlap), the share of the kernels whose
    names hold each string of ``focus`` with the launches the trace holds
    of them (against ``expect[key]`` launches where given: a long process
    can lose records, and then the sums undercount), and the ``top``
    largest kernels by device time. With ``group`` (a function from the
    names of the CPU op that launched a kernel and of its parents,
    innermost first, to a group's name), also the device time by group,
    and each of the largest kernels' group. Record ranges
    (``dl4j::...``) show on the device's timeline too and are not
    kernels. ``out``, where given, receives the ``top`` largest kernels as
    (name, us, group or None). Returns the busy milliseconds (0 when the
    profiler saw no device time)."""
    from collections import Counter, defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    by_name, launches = Counter(), Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith(
                "dl4j::"):
            by_name[e.name] += e.time_range.elapsed_us()
            launches[e.name] += 1
    busy_us = sum(by_name.values())
    if busy_us == 0:
        say(phase, "torch.profiler saw no device time: device idle share "
                   "not measured")
        return 0.0
    say(phase, f"{what} in {wall_us / 1e3:.1f} ms: device busy "
               f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of the "
               f"window, idle {1 - busy_us / wall_us:.3f}), "
               f"{sum(launches.values())} kernels")
    for key in focus:
        t = sum(v for n, v in by_name.items() if key in n)
        k = sum(v for n, v in launches.items() if key in n)
        want = (expect or {}).get(key)
        lost = (f" of {want} launched: the trace is incomplete, so is this "
                f"sum" if want is not None and k != want else "")
        say(phase, f"  {key}*: {t / 1e3:.2f} ms ({t / busy_us:.3f} of "
                   f"device time, {k} launches traced{lost})")
    of_name = defaultdict(Counter)
    if group is not None:
        groups = Counter()
        for e in events:
            if e.device_type != DeviceType.CPU or not e.kernels:
                continue
            chain, q = [], e
            while q is not None:
                chain.append(q.name)
                q = q.cpu_parent
            g = group(chain)
            for k in e.kernels:
                groups[g] += k.duration
                of_name[k.name][g] += k.duration
        groups["not traced to an op"] = max(busy_us - sum(groups.values()),
                                            0)
        say(phase, "device time by group: " + ", ".join(
            f"{g} {t / 1e3:.2f} ms ({t / busy_us:.3f})"
            for g, t in groups.most_common()))
    largest = []
    for name, t in by_name.most_common(top):
        grp = of_name[name].most_common(1)[0][0] if of_name[name] else None
        g = f" [{grp}]" if grp else ""
        say(phase, f"  {t / 1e3:9.2f} ms {t / busy_us:.3f} "
                   f"x{launches[name]:<5d}{g} {name[:90]}")
        largest.append((name, t, grp))
    if out is not None:
        out["largest"] = largest
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


def flash_case(N: int, T: int, dtype, mask_kind: str, seed: int,
               hd: int = HEAD_DIM):
    """q, k, v [N, 12, T, hd] and a key mask: none, padded (row n keeps
    its first T - 7n keys), or padded with the last row fully masked."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (torch.randn(N, HEADS, T, hd, generator=g,
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


def flash_bf16_case(label: str, q, k, v, m, causal) -> tuple:
    """The bf16 kernels on one case against the f32 plain version: the
    forward within 2e-2, each gradient within 2e-2 of its max |grad|.
    Returns (forward err, backward err / max |grad|)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    lq, lk, lv = (x.to(torch.bfloat16) for x in (q, k, v))
    out, _ = fa.flash_attention_fwd(lq, lk, lv, m, causal)
    err = float((out.float() - flash_plain(lq, lk, lv, m, causal))
                .abs().max())
    check(bool(torch.isfinite(out).all()) and err <= 2e-2,
          f"flash forward bf16 {label}: {err:.3e} > 0.02")
    dout = torch.randn_like(q)
    got = flash_grads(q, k, v, m, causal, dout, torch.bfloat16, True)
    want = flash_grads(q, k, v, m, causal, dout, torch.bfloat16, False)
    worst = 0.0
    for name, a, b in zip("qkv", got, want):
        e = float((a.float() - b).abs().max())
        scale = float(b.abs().max())
        # where the gradient is 0 in exact arithmetic (one key, no mask)
        # both sides hold f32 round-off only: an absolute floor of 1e-5
        check(a.dtype == torch.bfloat16 and e <= max(2e-2 * scale, 1e-5),
              f"flash backward d{name} bf16 {label}: {e:.3e} > 0.02 x max "
              f"|grad| {scale:.3e} (floor 1e-5)")
        if scale > 5e-4:
            worst = max(worst, e / scale)
    return err, worst


def flash_bf16_shapes() -> tuple:
    """The bf16 (tensor-core) kernels at every head dim, at lengths that
    fit one tile (1, 16), end in a ragged tile (77, 200) or fill two
    (128), with no mask or a fully masked row, causal off and on, and Tq
    != Tk both ways. Returns the largest forward error and backward
    error / max |grad|."""
    fwd = bwd = 0.0
    n_cases = 0
    for hd in (32, 64, 96, 128):
        for T in (1, 16, 77, 128, 200):
            if hd == HEAD_DIM and T in (77, 128):
                continue  # the T x mask x causal grid above
            for mask_kind in ("none", "full_row"):
                for causal in (False, True):
                    q, k, v, m = flash_case(2, T, torch.float32, mask_kind,
                                            seed=hd + T, hd=hd)
                    e = flash_bf16_case(f"hd={hd} T={T} {mask_kind} "
                                        f"causal={causal}", q, k, v, m,
                                        causal)
                    fwd, bwd = max(fwd, e[0]), max(bwd, e[1])
                    n_cases += 1
        for tq, tk in ((50, 77), (200, 64)):
            q, k, v, m = flash_case(2, tk, torch.float32, "full_row",
                                    seed=hd + tq, hd=hd)
            q = torch.randn(2, HEADS, tq, hd, device=DEVICE)
            for causal in (False, True):
                e = flash_bf16_case(f"hd={hd} Tq={tq} Tk={tk} full_row "
                                    f"causal={causal}", q, k, v, m, causal)
                fwd, bwd = max(fwd, e[0]), max(bwd, e[1])
                n_cases += 1
    torch.cuda.synchronize()
    say("flash", f"bf16 (tensor cores) at hd 32, 64, 96, 128, T 1, 16, 77, "
                 f"128, 200 and Tq != Tk, {n_cases} cases: forward max abs "
                 f"err {fwd:.3e} (tolerance 0.02), backward err / max |grad| "
                 f"{bwd:.3e} (tolerance 0.02)")
    return fwd, bwd


def device_split(what: str, run, calls: int = 20,
                 pattern: str = r"flash_\w+?_kernel",
                 phase: str = "flash", shape: str = "the training shape"
                 ):
    """Device time per call of each kernel matching ``pattern`` that
    ``run`` launches, from a torch.profiler trace of ``calls`` calls:
    each kernel's mean over the launch records the trace holds, and how
    many it holds (a long process can lose records; a sum over lost ones
    divided by ``calls`` would read low). Beside the CUDA-event time per
    call, which also holds the gaps between launches when the host
    enqueues more slowly than the card runs. Returns the sum of the
    means in us (None where the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(pattern, e.name)
            if m:
                t, n = split.get(m.group(0), (0.0, 0))
                split[m.group(0)] = (t + e.time_range.elapsed_us(), n + 1)
    if not split:
        say(phase, f"torch.profiler saw no device time: {what} split not "
                   f"measured")
        return None
    total = sum(t / n for t, n in split.values())
    say(phase, f"{what} device time per call at {shape} (profiler): "
               f"{total:.1f} us = "
               + " + ".join(f"{k} {t / n:.1f} us ({n} of {calls} launches "
                            f"traced)" for k, (t, n) in sorted(split.items())))
    return total


#: (dtype, head dim) the kernels are not built for, run on zero-padded or
#: widened copies (C9: f16; C10: head dims 16, 48, 160 of 32, 64, 96, 128,
#: 256 tiles), with their tolerances against the f32 plain version on the
#: same rounded inputs: (forward, backward of max |grad|)
FLASH_WIDE = ((torch.float16, 64, (2e-3, 2e-3)), (torch.float32, 16,
                                                   (2e-5, 1e-4)),
              (torch.bfloat16, 16, (2e-2, 2e-2)),
              (torch.float32, 48, (2e-5, 1e-4)),
              (torch.float16, 160, (2e-3, 2e-3)),
              (torch.bfloat16, 160, (2e-2, 2e-2)),
              (torch.float32, 320, (2e-5, 1e-4)),
              (torch.bfloat16, 320, (2e-2, 2e-2)),
              (torch.float32, 512, (2e-5, 1e-4)),
              (torch.bfloat16, 512, (2e-2, 2e-2)))


def check_flash_wide(fa) -> None:
    """C9 and C10 on the card: f16, and head dims outside 32/64/96/128,
    through ``fa.attention`` forward and backward (N=4, H=12, Tq=77, Tk=128,
    padded keys, causal off and on) against autograd through the plain
    version at f32 on the same rounded inputs."""
    g = torch.Generator(device=DEVICE).manual_seed(77)
    for dtype, hd, tol in FLASH_WIDE:
        q = torch.randn(4, HEADS, 77, hd, generator=g, device=DEVICE)
        k, v = (torch.randn(4, HEADS, 128, hd, generator=g, device=DEVICE)
                for _ in range(2))
        m = torch.ones(4, 128, device=DEVICE)
        m[0, 90:] = 0.0
        dout = torch.randn(q.shape, generator=g, device=DEVICE).to(dtype)
        errs = []
        for causal in (False, True):
            a = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
            before = (fa.fwd_launches, fa.bwd_launches)
            out = fa.attention(*a, m, causal)
            got = torch.autograd.grad(out, a, dout)
            b = [t.to(dtype).float().requires_grad_(True) for t in (q, k, v)]
            ref = flash_plain(*b, m, causal)
            want = torch.autograd.grad(ref, b, dout.float())
            torch.cuda.synchronize()
            check((fa.fwd_launches - before[0], fa.bwd_launches - before[1])
                  == (1, 1), f"flash {dtype} hd={hd}: not one launch each")
            check(out.dtype == dtype and out.shape == q.shape,
                  f"flash {dtype} hd={hd}: output {out.dtype} "
                  f"{tuple(out.shape)}")
            err = float((out.detach().float() - ref.detach()).abs().max())
            check(err <= tol[0], f"flash forward {dtype} hd={hd} causal="
                                 f"{causal}: {err:.3e} > {tol[0]:g}")
            errs.append(err)
            for name, x, y in zip("qkv", got, want):
                e = float((x.float() - y).abs().max()) / float(
                    y.abs().max())
                check(x.dtype == dtype and e <= tol[1],
                      f"flash backward d{name} {dtype} hd={hd} causal="
                      f"{causal}: {e:.3e} > {tol[1]:g} of max |grad|")
                errs.append(e)
        tile = fa.kernel_layout(dtype, hd)
        say("flash", f"{str(dtype)[6:]} hd={hd} (kernel tile {tile[0]} at "
                     f"{str(tile[1])[6:]}): forward max abs err "
                     f"{max(errs[0], errs[4]):.2e}, backward err / max "
                     f"|grad| {max(errs[1:4] + errs[5:]):.2e}")
    # C11's head dims past 256 walk 64-column slices: their time at this
    # check's shape, f32, beside the 256 tile's
    for hd in (256, 512):
        q, k, v = (torch.randn(4, HEADS, 128, hd, generator=g, device=DEVICE)
                   for _ in range(3))
        out, stats = fa.flash_attention_fwd(q, k, v, None, False)
        fwd = cuda_ms(lambda i: fa.flash_attention_fwd(q, k, v, None, False),
                      10, 2)
        bwd = cuda_ms(lambda i: fa.flash_attention_bwd(q, k, v, out, out,
                                                       stats), 10, 2)
        say("flash", f"f32 hd={hd} at N=4 H={HEADS} T=128 (kernel tile "
                     f"{fa.kernel_layout(torch.float32, hd)[0]}): forward "
                     f"{fwd:.4f} ms, backward {bwd:.4f} ms a call (CUDA "
                     f"events)")


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

    more = flash_bf16_shapes()
    fwd_err = max(fwd_err, more[0])
    check_flash_wide(fa)

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
    first = fa.flash_attention_bwd(q, k, v, out, dout, stats)
    again = fa.flash_attention_bwd(q, k, v, out, dout, stats)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "two backward calls on the same inputs differ")
    del first, again
    say("flash", "two backward calls at the training shape: dq, dk, dv "
                 "bit-equal")
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
    device_split("forward", lambda: fa.flash_attention_fwd(q, k, v))
    device_split("backward", lambda: fa.flash_attention_bwd(
        q, k, v, out, dout, stats))
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
                             ("flash_", "flash_fwd", "flash_bwd",
                              "fused_adam"))
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
            # bf16 takes the cluster route, held against the plain version
            # and against the first (grid) design on the same inputs
            routes = ("cluster", "grid") if dtype == torch.bfloat16 \
                else ("grid",)
            check(lr.fwd_route(*ins) == routes[0],
                  f"LSTM forward {dtype} T={T} N={N} takes the "
                  f"{lr.fwd_route(*ins)} route, not {routes[0]}")
            outs = {}
            for route in routes:
                for cells in (False, True):
                    got = lr.lstm_recurrence_fwd(*ins, collect_cell=cells,
                                                 route=route)
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        check(a.dtype == dtype and a.shape == b.shape,
                              f"LSTM forward output {a.dtype} "
                              f"{tuple(a.shape)}")
                        check(bool(torch.isfinite(a).all()),
                              "LSTM forward output not finite")
                        err = float((a.float() - b).abs().max())
                        if route == routes[0]:
                            fwd_err = max(fwd_err, err)
                        check(err <= tol, f"LSTM forward {dtype} {route} "
                                          f"T={T} N={N} cells={cells}: "
                                          f"{err:.3e} > {tol:g}")
                    outs[route] = got
                line.append(f"fwd {str(dtype)[6:]} {route} {err:.2e}")
            if dtype == torch.bfloat16:
                again = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in
                          zip(again, outs["cluster"])),
                      f"LSTM forward T={T} N={N}: two cluster-route calls "
                      f"differ")
                gap = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(outs["cluster"], outs["grid"]))
                check(gap <= tol, f"LSTM forward T={T} N={N}: cluster and "
                                  f"grid routes {gap:.3e} apart > {tol:g}")
                line.append(f"cluster vs grid {gap:.2e} (bit-equal twice)")
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
    check_lstm_wide(lr)
    check_lstm_f16(lr, H)
    check_lstm_mixed(lr, H)
    wide_rows = lstm_wide_kernels(lr)

    # the training shape: bf16, T=200, N=256, H=256
    T, N = LSTM_SEQ, LSTM_BATCH
    x_proj, w_hh, h0, c0 = (t.to(torch.bfloat16) for t in
                            lstm_case(T, N, H, seed=11))
    g = torch.Generator(device=DEVICE).manual_seed(12)
    dys = torch.randn(T, N, H, generator=g, device=DEVICE).to(torch.bfloat16)
    check(lr.fwd_route(x_proj, w_hh, h0, c0) == "cluster",
          "the training shape must take the forward's cluster route")
    ys, hT, cT, cs = lr.lstm_recurrence_fwd(x_proj, w_hh, h0, c0,
                                            collect_cell=True)
    fwd_plan = lr.last_plan
    lr.lstm_recurrence_fwd(x_proj, w_hh, h0, c0, collect_cell=True,
                           route="grid")
    fwd_grid_plan = lr.last_plan
    check(lr.bwd_route(x_proj, w_hh, h0, ys) == "cluster",
          "the training shape must take the backward's cluster route")
    got = lr.lstm_recurrence_bwd(x_proj, w_hh, h0, c0, ys, cs, dys)
    bwd_plan = lr.last_plan
    again = lr.lstm_recurrence_bwd(x_proj, w_hh, h0, c0, ys, cs, dys)
    first = lr.lstm_recurrence_bwd(x_proj, w_hh, h0, c0, ys, cs, dys,
                                   route="grid")
    grid_plan = lr.last_plan
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "two cluster-route backward calls differ")
    ref = lr.lstm_recurrence_backward_reference(
        *(t.float() for t in (x_proj, w_hh, h0, c0, ys, cs, dys)))
    line = []
    for name, a, b, c in zip(("dx_proj", "dw_hh", "dh0", "dc0"), got, first,
                             ref):
        scale = float(c.abs().max())
        e_cl = float((a.float() - c).abs().max()) / scale
        e_gr = float((b.float() - c).abs().max()) / scale
        check(e_cl <= 2e-2 and e_gr <= 2e-2,
              f"LSTM backward {name} at the training shape: cluster "
              f"{e_cl:.3e}, grid {e_gr:.3e} of max |grad| > 0.02")
        line.append(f"{name} {e_cl:.2e} / {e_gr:.2e}")
    say("lstm", f"backward at T={T} N={N} H={H} bf16, err / max |grad|, "
                f"cluster route / first (grid) design: {', '.join(line)}; "
                f"two cluster-route calls bit-equal")
    iters = 20

    def kernels():
        return (cuda_ms(lambda i: lr.lstm_recurrence_fwd(
                    x_proj, w_hh, h0, c0, collect_cell=True), iters, 3),
                cuda_ms(lambda i: lr.lstm_recurrence_bwd(
                    x_proj, w_hh, h0, c0, ys, cs, dys), iters, 3),
                cuda_ms(lambda i: lr.lstm_recurrence_bwd(
                    x_proj, w_hh, h0, c0, ys, cs, dys, route="grid"),
                    iters, 3),
                cuda_ms(lambda i: lr.lstm_recurrence_fwd(
                    x_proj, w_hh, h0, c0, collect_cell=True, route="grid"),
                    iters, 3))

    kern1 = kernels()
    plain = (cuda_ms(lambda i: lr.lstm_recurrence_reference(
                 x_proj, w_hh, h0, c0, collect_cell=True), 3, 1),
             cuda_ms(lambda i: lr.lstm_recurrence_backward_reference(
                 x_proj, w_hh, h0, c0, ys, cs, dys), 3, 1))
    lib, port_layer = lstm_yardstick(x_proj.shape, iters)
    kern2 = kernels()
    say("lstm", f"B5 bwd, first (grid) design at T={T} N={N} H={H} bf16 "
                f"(plan {grid_plan}), in turns with the cluster route: "
                f"{kern1[2]:.4f} / {kern2[2]:.4f} ms")
    say("lstm", f"B5 fwd, first (grid) design at T={T} N={N} H={H} bf16 "
                f"(plan {fwd_grid_plan}), in turns with the cluster route "
                f"and cuDNN: {kern1[3]:.4f} / {kern2[3]:.4f} ms "
                f"({min(kern1[3], kern2[3]) / T * 1e3:.2f} us per step)")
    # the sampling shape (rnnTimeStep: T=1, N=4) at bf16, each route in
    # turns: a call there is the launch and the prologue
    one = [t.to(torch.bfloat16) for t in lstm_case(1, 4, H, seed=41)]
    samp = [cuda_ms(lambda i: lr.lstm_recurrence_fwd(*one, route=r), 200)
            for r in ("cluster", "grid", "cluster", "grid")]
    say("lstm", f"B5 fwd at the sampling shape T=1 N=4 H={H} bf16, in turns: "
                f"cluster route {samp[0] * 1e3:.1f} / {samp[2] * 1e3:.1f} us, "
                f"grid route {samp[1] * 1e3:.1f} / {samp[3] * 1e3:.1f} us per "
                f"call (CUDA events)")
    for what, run in (
            ("B5 fwd, cluster route", lambda: lr.lstm_recurrence_fwd(
                x_proj, w_hh, h0, c0, collect_cell=True)),
            ("B5 fwd, grid route", lambda: lr.lstm_recurrence_fwd(
                x_proj, w_hh, h0, c0, collect_cell=True, route="grid")),
            ("B5 bwd, cluster route", lambda: lr.lstm_recurrence_bwd(
                x_proj, w_hh, h0, c0, ys, cs, dys))):
        device_split(what, run, calls=10, pattern=r"lstm_\w+?_kernel",
                     phase="lstm", shape=f"T={T} N={N} H={H} bf16")
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
    return tuple(rows) + wide_rows


#: the wide route's widths timed in phase 8 at the training batch: the JAX
#: bench's wide char-LSTM (its row) and H=512 beside it (printed)
LSTM_WIDE_ROWS = (1024, 512)


def lstm_wide_kernels(lr) -> tuple:
    """Rows of the wide route, B5 and B5 bwd at T=200, N=256, H=1024 bf16
    (H=512 printed beside them): each direction against its plain version
    (forward within 2e-2, backward within 2e-2 of max |grad|) and two calls
    bit-equal; then CUDA-event times of the kernel calls (the backward's
    with its f32 dw matmul, also timed alone), the kernels' device time
    (profiler), the plain versions', cuDNN's (``torch.nn.LSTM``, never
    called by the port) and the bounds."""
    T, N = LSTM_SEQ, LSTM_BATCH
    rows = []
    for H in LSTM_WIDE_ROWS:
        ins = [t.to(torch.bfloat16) for t in lstm_case(T, N, H, seed=H)]
        g = torch.Generator(device=DEVICE).manual_seed(H + 1)
        up = [torch.randn(shape, generator=g, device=DEVICE)
              .to(torch.bfloat16) for shape in ((T, N, H), (N, H), (N, H))]
        check(lr.fwd_route(*ins) == "wide", f"B5 at H={H} bf16 takes the "
                                            f"{lr.fwd_route(*ins)} route")
        f32 = [t.float() for t in ins]
        want = lr.lstm_recurrence_reference(*f32, collect_cell=True)
        got = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
        fplan = lr.last_plan
        again = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"B5 wide H={H}: two forward calls differ")
        ferr = max(float((a.float() - b).abs().max())
                   for a, b in zip(got, want))
        check(ferr <= 2e-2, f"B5 wide H={H}: forward {ferr:.3e} > 2e-2")
        ys, cs = got[0], got[3]
        check(lr.bwd_route(ins[0], ins[1], ins[2], ys) == "wide",
              f"B5 bwd at H={H} bf16 not on the wide route")
        grads = lr.lstm_recurrence_bwd(*ins, ys, cs, *up)
        bplan = lr.last_plan
        twice = lr.lstm_recurrence_bwd(*ins, ys, cs, *up)
        ref = lr.lstm_recurrence_backward_reference(
            *f32, ys.float(), cs.float(), *(t.float() for t in up))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(grads, twice)),
              f"B5 wide H={H}: two backward calls differ")
        babs = max(float((a.float() - b).abs().max())
                   for a, b in zip(grads, ref))
        brel = max(float((a.float() - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(grads, ref))
        check(brel <= 2e-2, f"B5 bwd wide H={H}: {brel:.3e} of max |grad| "
                            f"> 2e-2")

        def fwd(i):
            return lr.lstm_recurrence_fwd(*ins, collect_cell=True)

        def bwd(i):
            return lr.lstm_recurrence_bwd(*ins, ys, cs, *up)

        kern = (cuda_ms(fwd, 10, 2), cuda_ms(bwd, 10, 2))
        h_prev = torch.cat([ins[2][None], ys[:-1]]).float() \
            .reshape(T * N, H)
        da = torch.randn(T * N, 4 * H, generator=g, device=DEVICE)
        dw_ms = cuda_ms(lambda i: torch.matmul(h_prev.T, da), 10, 2)
        plain = (cuda_ms(lambda i: lr.lstm_recurrence_reference(
                     *ins, collect_cell=True), 2, 1),
                 cuda_ms(lambda i: lr.lstm_recurrence_backward_reference(
                     *ins, ys, cs, *up), 2, 1))
        lib, port_layer = lstm_yardstick((T, N, 4 * H), 10)
        shape = f"T={T} N={N} H={H} bf16"
        split = [device_split(what, lambda: run(0), calls=5,
                              pattern=r"lstm_\w+?_kernel", phase="lstm",
                              shape=shape)
                 for what, run in (("B5 fwd, wide route", fwd),
                                   ("B5 bwd, wide route", bwd))]
        for j, (name, err, plan) in enumerate((("B5 wide", ferr, fplan),
                                               ("B5 bwd wide", babs,
                                                bplan))):
            bound_ms, bound_by, nbytes, flops = lstm_bound(T, N, H, 2, j == 1)
            dev = split[j]
            say("lstm", f"{name} at {shape} (plan {plan}): kernel call "
                        f"{kern[j]:.4f} ms ({kern[j] / T * 1e3:.2f} us per "
                        f"step; kernel device time "
                        + (f"{dev / 1e3:.4f} ms" if dev else "not measured")
                        + (f", f32 dw matmul alone {dw_ms:.4f} ms" if j
                           else "")
                        + f"), plain {plain[j]:.4f} ms, library (torch.nn."
                          f"LSTM on cuDNN, projection included) {lib[j]:.4f} "
                          f"ms against the port's projection + kernel "
                          f"{port_layer[j]:.4f} ms; bound {bound_ms:.4f} ms "
                          f"by {bound_by} ({nbytes} B, {flops} flop at 989 "
                          f"TFLOP/s bf16); errors: forward max abs "
                          f"{ferr:.2e}, backward max abs {babs:.2e} "
                          f"({brel:.2e} of max |grad|); two calls bit-equal")
            if H == LSTM_WIDE_ROWS[0]:
                rows.append({"name": name, "route": "cuda",
                             "source": "deeplearning4j_tpu_torch/csrc/"
                                       "lstm_recurrence.cu",
                             "replaces":
                                 "deeplearning4j_tpu/ops/lstm_pallas.py:123",
                             "launches": 0, "max_abs_err": err,
                             "ms": kern[j], "plain_ms": plain[j],
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": lib[j]})
    return tuple(rows)


#: wide (T, N, H) (C10): N=512 at the JAX bench's width (f32 on the grid
#: route: a forward block walks 4 batch tiles with w_hh in shared memory,
#: the backward reads w_hh from L2; bf16 on the wide route), a width whose
#: w_hh no block can keep (both directions read it from L2), and N=512 at
#: the training width (bf16 there takes the cluster routes, two waves of
#: clusters)
LSTM_WIDE = ((5, 512, 1024), (3, 8, 2048), (5, 512, 256))


def lstm_pair(lr, ins, up, dtype):
    """Forward (with the cell stream) and backward kernels on ``ins`` and
    the upstream ``up``, against the plain versions at f32 on the same
    rounded values: (forward max abs err, backward max err / max |grad|,
    the forward's plan, the backward's plan)."""
    f32 = [t.float() for t in ins]
    want = lr.lstm_recurrence_reference(*f32, collect_cell=True)
    got = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
    fplan = lr.last_plan
    torch.cuda.synchronize()
    ferr = max(float((a.float() - b).abs().max()) for a, b in zip(got, want))
    grads = lr.lstm_recurrence_bwd(*ins, got[0], got[3], *up)
    bplan = lr.last_plan
    ref = lr.lstm_recurrence_backward_reference(
        *f32, got[0].float(), got[3].float(), *(t.float() for t in up))
    torch.cuda.synchronize()
    for a, t in zip((*got, *grads), (*ins[:1],) * 4 + tuple(ins)):
        check(a.dtype == t.dtype, f"LSTM {dtype} output {a.dtype}")
    berr = max(float((a.float() - b).abs().max()) / float(b.abs().max())
               for a, b in zip(grads, ref))
    return ferr, berr, fplan, bplan


def check_lstm_wide(lr) -> None:
    """C10: wide shapes, both directions at f32 and bf16 on the routes
    they take, against the plain versions (f32 within
    1e-5 and 1e-4 of max |grad|; bf16 within 2e-2 of the f32 plain
    version on the bf16-rounded inputs)."""
    for T, N, H in LSTM_WIDE:
        g = torch.Generator(device=DEVICE).manual_seed(N + H)
        base = lstm_case(T, N, H, seed=N + H)
        up = [torch.randn(shape, generator=g, device=DEVICE)
              for shape in ((T, N, H), (N, H), (N, H))]
        for dtype, tol, gtol in ((torch.float32, 1e-5, 1e-4),
                                 (torch.bfloat16, 2e-2, 2e-2)):
            ins = [t.to(dtype) for t in base]
            route = lr.fwd_route(*ins)
            ferr, berr, fplan, bplan = lstm_pair(
                lr, ins, [t.to(dtype) for t in up], dtype)
            check(ferr <= tol and berr <= gtol,
                  f"LSTM {dtype} T={T} N={N} H={H}: forward {ferr:.3e} > "
                  f"{tol:g} or backward {berr:.3e} > {gtol:g}")
            say("lstm", f"wide shape, {str(dtype)[6:]} T={T} "
                        f"N={N} H={H}, {route} route: forward max abs err "
                        f"{ferr:.2e} (plan "
                        f"{fplan}), backward err / max |grad| {berr:.2e} "
                        f"(plan {bplan}); grid plan: blocks, rows per "
                        f"thread, chunk, shared bytes, blocks per SM, tiles "
                        f"per block, w_hh in shared memory")


def check_lstm_f16(lr, H: int) -> None:
    """C9: f16 x_proj and state with an f16 or a bf16 w_hh, the grid route
    at f32 over widened inputs, outputs and gradients in the primal
    dtypes, against the plain versions on the same values: values within
    2e-3, gradients within 2e-3 of max |grad| (the f16 ones) or one bf16
    step (a bf16 w_hh's)."""
    T, N = 50, 64
    base = lstm_case(T, N, H, seed=51)
    g = torch.Generator(device=DEVICE).manual_seed(52)
    f16 = torch.float16
    for w_dtype in (f16, torch.bfloat16):
        ins = [base[0].to(f16), base[1].to(w_dtype), base[2].to(f16),
               base[3].to(f16)]
        check(lr.fwd_route(*ins) == "grid", "f16 LSTM not on the grid route")
        want = lr.lstm_recurrence_reference(*ins, collect_cell=True)
        got = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
        up = [torch.randn(shape, generator=g, device=DEVICE).to(f16)
              for shape in ((T, N, H), (N, H), (N, H))]
        ref = lr.lstm_recurrence_backward_reference(*ins, want[0], want[3],
                                                    *up)
        grads = lr.lstm_recurrence_bwd(*ins, want[0], want[3], *up)
        torch.cuda.synchronize()
        worst = []
        for name, a, b, grad in (
                *((n, a, b, False) for n, a, b in
                  zip(("ys", "hT", "cT", "cs"), got, want)),
                *((n, a, b, True) for n, a, b in
                  zip(("dx_proj", "dw_hh", "dh0", "dc0"), grads, ref))):
            check(a.dtype == b.dtype, f"f16 LSTM {name}: {a.dtype} against "
                                      f"{b.dtype}")
            err = float((a.float() - b.float()).abs().max())
            scale = float(b.float().abs().max()) if grad else 1.0
            tol = (2e-3 if a.dtype == f16 else 2 ** -7) * scale
            check(err <= tol, f"f16 LSTM (w_hh {w_dtype}) {name}: {err:.3e}"
                              f" > {tol:.3e}")
            worst.append(f"{name} {err / scale:.2e}")
        say("lstm", f"f16 x_proj and state, w_hh {str(w_dtype)[6:]}, T={T} "
                    f"N={N} H={H}, grid route over widened inputs, against "
                    f"the plain versions (values abs, gradients / max "
                    f"|grad|): {', '.join(worst)}")


#: (x_proj, w_hh, h0 and c0) dtypes of the mixed LSTM calls (C6)
LSTM_MIXES = ((torch.float32, torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.bfloat16, torch.float32))


#: f32 forward outputs of a mixed call with a bf16 w_hh: the recurrence
#: rounds h to bf16 before every product, so a 1-ulp change in f32 can flip
#: a rounding and moves the outputs by up to 6.6e-4 at T=200, N=256 in the
#: plain version itself (x_proj scaled by 1 + 2^-23)
MIXED_ROUNDED_TOL = 2e-3


def mixed_tol(t, scale: float, f32_tol: float) -> float:
    """f32 results within ``f32_tol`` (of ``scale`` for gradients); bf16
    ones within one bf16 step of the largest value."""
    return f32_tol * scale if t.dtype == torch.float32 else 2 ** -7 * scale


def check_lstm_mixed(lr, H: int) -> None:
    """C6: the three mixes, forward and backward on the card (the grid
    route at f32 over widened inputs) against the plain versions on the
    same mixed inputs: output and gradient dtypes equal, values within
    1e-5 (f32) or one bf16 step, gradients within 1e-4 of max |grad|
    (f32) or one bf16 step."""
    T, N = 50, 64
    x_proj, w_hh, h0, c0 = lstm_case(T, N, H, seed=31)
    g = torch.Generator(device=DEVICE).manual_seed(32)
    for mix in LSTM_MIXES:
        ins = [t.to(d) for t, d in zip((x_proj, w_hh, h0, c0),
                                       (mix[0], mix[1], mix[2], mix[2]))]
        check(lr.fwd_route(*ins) == "grid", f"mixed {mix} not on the grid "
                                            f"route")
        want = lr.lstm_recurrence_reference(*ins, collect_cell=True)
        got = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
        ys, cs = want[0], want[3]
        dys, dhT, dcT = (torch.randn(shape, generator=g, device=DEVICE)
                         .to(mix[0]) for shape in ((T, N, H), (N, H), (N, H)))
        ref = lr.lstm_recurrence_backward_reference(*ins, ys, cs, dys, dhT,
                                                    dcT)
        grads = lr.lstm_recurrence_bwd(*ins, ys, cs, dys, dhT, dcT)
        torch.cuda.synchronize()
        worst = []
        for name, a, b, absolute in (
                *((n, a, b, True) for n, a, b in
                  zip(("ys", "hT", "cT", "cs"), got, want)),
                *((n, a, b, False) for n, a, b in
                  zip(("dx_proj", "dw_hh", "dh0", "dc0"), grads, ref))):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"mixed {mix} {name}: {a.dtype} {tuple(a.shape)} against "
                  f"{b.dtype} {tuple(b.shape)}")
            err = float((a.float() - b.float()).abs().max())
            scale = float(b.float().abs().max())
            f32_tol = ((MIXED_ROUNDED_TOL if mix[1] == torch.bfloat16
                        else 1e-5) if absolute else 1e-4)
            tol = mixed_tol(a, max(1.0, scale) if absolute else scale,
                            f32_tol)
            check(err <= tol, f"mixed {mix} {name}: {err:.3e} > {tol:.3e}")
            worst.append(f"{name} {str(a.dtype)[6:]} {err:.2e}")
        say("lstm", f"mixed (x_proj, w_hh, state) "
                    f"{tuple(str(d)[6:] for d in mix)} at T={T} N={N} H={H}, "
                    f"grid route over widened inputs, max abs err against "
                    f"the plain versions: {', '.join(worst)}")


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


def textgen_net(dtype: str, tbptt: int, device, seed: int = 0,
                hidden: int = LSTM_HIDDEN):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    conf = TextGenerationLSTM(vocab_size=LSTM_VOCAB, hidden=hidden,
                              tbptt_length=tbptt).conf()
    conf.dtype = dtype
    net = MultiLayerNetwork(conf, device=device).init()
    net.params_list = mln_params_from_numpy(
        textgen_params_numpy(LSTM_VOCAB, hidden, seed), device=device,
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


def lstm_cluster_counts() -> tuple:
    """The launches of :func:`lstm_counts` that took the cluster route."""
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    return lr.fwd_cluster_launches, lr.bwd_cluster_launches


def lstm_wide_counts() -> tuple:
    """The launches of :func:`lstm_counts` that took the wide route."""
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    return lr.fwd_wide_launches, lr.bwd_wide_launches


def reset_lstm_counts() -> None:
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    lr.fwd_launches = lr.bwd_launches = 0
    lr.fwd_cluster_launches = lr.bwd_cluster_launches = 0
    lr.fwd_wide_launches = lr.bwd_wide_launches = 0


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
    cluster = lstm_cluster_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + TIMED_STEPS
    per_char = [float(l) / LSTM_SEQ for l in losses]
    check((fwd, bwd) == (2 * steps, 2 * steps) == cluster,
          f"LSTM launches fwd {fwd}, bwd {bwd} (cluster route {cluster}) "
          f"over {steps} steps of 2 layers")
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
                      f"steps: fwd {fwd}, bwd {bwd}, all on the cluster "
                      f"routes")
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
    del net
    lstm_wide_train(x, y, rows)


#: the JAX bench's wide char-LSTM (bench.py:654, lstm1024_tokens_per_sec_chip;
#: bench_common.py:279): hidden 1024 at batch 256 x 200, bf16
LSTM_WIDE_HIDDEN, LSTM_WIDE_STEPS = 1024, 3


def lstm_wide_train(x, y, rows: dict) -> None:
    """The wide route on the training path: TextGenerationLSTM at hidden
    1024 through ``MultiLayerNetwork.fit`` at phase 9's batch (bf16,
    standard BPTT): one warm-up and a few timed steps, two wide-route
    launches per direction per step (the rows' launches), finite losses;
    then B5 at that width (T=200, N=256, H=1024, bf16) against its plain
    version (forward within 2e-2, backward within 2e-2 of max |grad|)."""
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    H = LSTM_WIDE_HIDDEN
    net = textgen_net("bfloat16", 0, DEVICE, hidden=H)
    reset_lstm_counts()
    net.fit(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(LSTM_WIDE_STEPS):
        net.fit(x, y)
        losses.append(float(net._score) / LSTM_SEQ)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LSTM_WIDE_STEPS
    steps = 1 + LSTM_WIDE_STEPS
    counts, wide = lstm_counts(), lstm_wide_counts()
    check(counts == (2 * steps, 2 * steps) == wide,
          f"hidden {H}: launches {counts} (wide route {wide}) over {steps} "
          f"steps of 2 layers, all on the wide route")
    rows["B5 wide"]["launches"] = counts[0]
    rows["B5 bwd wide"]["launches"] = counts[1]
    check(all(math.isfinite(v) for v in losses), f"hidden {H}: losses "
                                                 f"{losses}")
    say("lstm-train", f"TextGenerationLSTM(hidden={H}) ({net.numParams()} "
                      f"parameters), bf16, batch {LSTM_BATCH} x {LSTM_SEQ}: "
                      f"{LSTM_WIDE_STEPS} timed steps {step_s * 1e3:.2f} "
                      f"ms/step, {LSTM_BATCH * LSTM_SEQ / step_s:.1f} "
                      f"tokens/s; launches {counts} on the wide route; loss "
                      f"per character " + " ".join(f"{v:.4f}"
                                                   for v in losses))
    say("lstm-train", f"yardstick at hidden {H} (phase 8, never called by "
                      f"the port): cuDNN's torch.nn.LSTM forward "
                      f"{rows['B5 wide']['library_ms']:.4f} ms and backward "
                      f"{rows['B5 bwd wide']['library_ms']:.4f} ms per layer "
                      f"against the wide route's kernel calls "
                      f"{rows['B5 wide']['ms']:.4f} and "
                      f"{rows['B5 bwd wide']['ms']:.4f} ms")
    busy_ms = device_profile("lstm-train", f"one more step at hidden {H}",
                             lambda: net.fit(x, y), ("lstm_fwd", "lstm_bwd"),
                             expect={"lstm_fwd": 2, "lstm_bwd": 2})
    if busy_ms:
        say("lstm-train", f"hidden {H}: device busy {busy_ms:.2f} ms against "
                          f"{step_s * 1e3:.2f} ms per timed step "
                          f"(unprofiled): idle about "
                          f"{1 - busy_ms / (step_s * 1e3):.3f} of a step")
    del net
    T, N = LSTM_SEQ, LSTM_BATCH
    ins = [t.to(torch.bfloat16) for t in lstm_case(T, N, H, seed=61)]
    g = torch.Generator(device=DEVICE).manual_seed(62)
    up = [torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
          for shape in ((T, N, H), (N, H), (N, H))]
    ferr, berr, fplan, bplan = lstm_pair(lr, ins, up, torch.bfloat16)
    check(ferr <= 2e-2 and berr <= 2e-2,
          f"B5 at T={T} N={N} H={H} bf16: forward {ferr:.3e}, backward "
          f"{berr:.3e} of max |grad| > 0.02")
    say("lstm-train", f"B5 at T={T} N={N} H={H} bf16 (wide route): forward "
                      f"max abs err {ferr:.2e} against the plain version "
                      f"(plan {fplan}); backward err / max |grad| "
                      f"{berr:.2e} (plan {bplan}); times in phase 8")


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

    # sampling at bf16, the training dtype: every rnnTimeStep on the
    # forward's cluster route (T=1, N=4); the state goes back to the
    # network in bf16 between characters, so output() over the sequence
    # (h and c carried in f32 inside one launch) differs by the roundings
    net = textgen_net("bfloat16", 50, DEVICE, seed=6)
    xb = x.to(torch.bfloat16)
    full = net.output(xb)
    net.rnnTimeStep(xb[:, 0])                 # warm-up, then a fresh state
    net.rnnClearPreviousState()
    reset_lstm_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = torch.stack([net.rnnTimeStep(xb[:, t]) for t in range(64)], 1)
    torch.cuda.synchronize()
    per_char_bf16 = (time.perf_counter() - t0) / 64 * 1e3
    counts, cluster = lstm_counts(), lstm_cluster_counts()
    err = float((steps.float() - full.float()).abs().max())
    say("lstm-parity", f"bf16 rnnTimeStep x 64 (batch 4): {per_char_bf16:.3f} "
                       f"ms per character (host clock, 2 layers + head; f32 "
                       f"above: {per_char:.3f}); launches {counts}, on the "
                       f"cluster route {cluster}; max abs diff from bf16 "
                       f"output() {err:.3e} (tolerance 2e-2)")
    check(counts == cluster == (2 * 64, 0),
          f"bf16 sampling launched {counts}, cluster route {cluster}, not "
          f"2 layers x 64 calls on the cluster route")
    check(err <= 2e-2, f"bf16 rnnTimeStep differs from output() by "
                       f"{err:.3e}")


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


def tail_bound(x, res):
    """(bound_ms, bound_by, bytes, flops) of one residual-tail call: x and
    res read once, out (x's dtype) written once, four f32 [C] vectors read
    once; 6 f32 operations per element."""
    c = x.shape[-1]
    nbytes = (2 * x.numel() * x.element_size()
              + res.numel() * res.element_size() + 4 * c * 4)
    flops = 6 * x.numel()
    return (*bound(nbytes, flops, F32_FLOPS), nbytes, flops)


#: (x, res) dtypes of the tail checks: f32, bf16 and both mixes (C5)
TAIL_DTYPES = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.float32, torch.bfloat16))


def tail_case(shape, mix):
    """(x, res, mean, var, gamma, beta) of one residual join: x and res
    in the dtypes of ``mix`` from the same seeded values whatever the
    dtypes, f32 statistics and parameters."""
    n, h, w_, c = shape
    g = torch.Generator(device=DEVICE).manual_seed(c + h)
    x = torch.randn(n, h, w_, c, generator=g, device=DEVICE).to(mix[0])
    res = torch.randn(n, h, w_, c, generator=g, device=DEVICE).relu_() \
        .to(mix[1])
    mean = 0.1 * torch.randn(c, generator=g, device=DEVICE)
    var = torch.rand(c, generator=g, device=DEVICE) + 0.5
    gamma = torch.rand(c, generator=g, device=DEVICE) + 0.5
    beta = 0.1 * torch.randn(c, generator=g, device=DEVICE)
    return x, res, mean, var, gamma, beta


def tail_times(args, iters: int = 20) -> dict:
    """The residual-tail kernel's time through ``Nd4j.exec`` (two runs,
    in turns with the library yardstick), the plain version's, the
    library's (``F.batch_norm`` + add + ``relu`` on channels-last views,
    never called by the port; an eager composition where ``F.batch_norm``
    refuses the dtypes) and the bound. Needs only the op by name and its
    plain version, so it also times an earlier tree's kernel."""
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    x, res, mean, var, gamma, beta = args
    kern1 = cuda_ms(lambda i: Nd4j.exec("bn_relu_residual", *args), iters, 3)
    plain = cuda_ms(lambda i: rt.residual_tail_reference(*args), 5, 1)
    x_nchw, r_nchw = x.permute(0, 3, 1, 2), res.permute(0, 3, 1, 2)
    kind = "F.batch_norm + add + relu"
    try:
        F.batch_norm(x_nchw, mean, var, gamma, beta, False, 0.0, 1e-5)

        def library(i):
            return torch.relu(F.batch_norm(x_nchw, mean, var, gamma, beta,
                                           False, 0.0, 1e-5) + r_nchw)
    except RuntimeError:
        kind = "eager composition"

        def library(i):
            return torch.relu((x - mean) * torch.rsqrt(var + 1e-5) * gamma
                              + beta + res)
    lib = cuda_ms(library, iters, 3)
    kern2 = cuda_ms(lambda i: Nd4j.exec("bn_relu_residual", *args), iters, 3)
    ms = min(kern1, kern2)
    bound_ms, bound_by, nbytes, _ = tail_bound(x, res)
    kinds = "/".join(str(t.dtype)[6:] for t in (x, res))
    device = device_split(
        "bn_relu_residual", lambda: Nd4j.exec("bn_relu_residual", *args),
        pattern=r"residual_tail\w*?_kernel", phase="tail",
        shape=f"{'x'.join(map(str, x.shape[1:]))} N={x.shape[0]} {kinds}")
    return {"kernel": (kern1, kern2), "plain": plain, "library": lib,
            "library_kind": kind, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "gbs": nbytes / (ms * 1e-3) / 1e9,
            "share": bound_ms / ms,
            "device_share": (bound_ms * 1e3 / device) if device else None}


def fmt_share(share) -> str:
    return "not measured" if share is None else f"{share:.3f}"


def say_tail_times(tag: str) -> None:
    """The residual tail's times (:func:`tail_times`) at the four joins in
    bf16 and f32, one line each: run from the root of an earlier tree of
    the port, with this file's functions loaded, it times that tree's
    kernel, so two designs can be compared in one chip call."""
    for shape in TAIL_SHAPES:
        for mix in TAIL_DTYPES[:2]:
            t = tail_times(tail_case(shape, mix))
            say("tail-times", f"{tag} {'x'.join(map(str, shape[1:]))} "
                              f"N={shape[0]} {str(mix[0])[6:]}: kernel "
                              f"{t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} "
                              f"ms, library {t['library']:.4f} ms, bound "
                              f"{t['bound_ms']:.4f} ms, {t['share']:.3f} of "
                              f"the bound ({fmt_share(t['device_share'])} "
                              f"by device time)")


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
        route = cb.kernel_route(x, w, taps)
        check(route == "tc", f"{name} at {shape[1:]} takes the {route!r} "
                             f"route, not the tensor-core route")
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
        # the first bf16 design, still the route of odd shapes
        first = cuda_ms(lambda i: cb.conv_bn_stats_kernel(x, w, taps,
                                                          route="wmma"),
                        iters, 3)
        kern2 = cuda_ms(lambda i: Nd4j.exec(name, x, w), iters, 3)
        ms = min(kern1, kern2)
        bound_ms, bound_by, nbytes, flops = conv_bound(x, w, y, taps)
        say("conv", f"{name} {h}x{w_} {cin}->{cout} N={n} bf16: err/max|y| "
                    f"{e[0]:.2e}, mean {e[1]:.2e}, var/max E[y^2] {e[2]:.2e}; "
                    f"kernel {kern1:.4f} / {kern2:.4f} ms, first bf16 design "
                    f"{first:.4f} ms, plain {plain:.4f} ms, library "
                    f"{lib:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
                    f"({nbytes} B, {flops} flop); kernel at "
                    f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
                    f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
                    f"{bound_ms / ms:.3f} of its bound")
        if shape == CONV_ROW_SHAPES[kind]:
            again = Nd4j.exec(name, x, w)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(again, (y, m, v))),
                  f"{name} at {shape[1:]}: two calls differ")
            say("conv", f"{name} at {shape[1:]}: two calls give the same y, "
                        f"mean and var, bit for bit")
            device_split(f"{name} {h}x{w_} {cin}->{cout}",
                         lambda: Nd4j.exec(name, x, w),
                         pattern=r"conv_bn_stats(?:_tc)?_kernel"
                                 r"|reduce_stats_kernel",
                         phase="conv", shape=f"N={n}")
            del again
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
        for mix in TAIL_DTYPES:
            args = tail_case(shape, mix)
            x = args[0]
            out = Nd4j.exec("bn_relu_residual", *args)
            # the plain version at f32 on the same values
            want = rt.residual_tail_reference(x.float(), args[1].float(),
                                              *args[2:])
            torch.cuda.synchronize()
            check(out.dtype == mix[0] and out.shape == x.shape,
                  f"bn_relu_residual output {out.dtype} {tuple(out.shape)}")
            again = Nd4j.exec("bn_relu_residual", *args)
            torch.cuda.synchronize()
            check(torch.equal(again, out), f"bn_relu_residual at {shape} "
                                           f"{mix}: two calls differ")
            err = float((out.float() - want).abs().max())
            scale = float(want.abs().max())
            # f32: the same operations in the same order (rsqrt rounded
            # apart); a bf16 output: the same f32 value rounded once
            tol = 1e-5 if mix[0] == torch.float32 else 2 ** -8 * scale
            check(err <= tol, f"bn_relu_residual at {shape} {mix}: "
                              f"{err:.3e} > {tol:.3e}")
            if mix == (bf, bf):
                tail_err = max(tail_err, err)
            del out, want, again
            t = tail_times(args)
            kinds = "/".join(str(d)[6:] for d in mix)
            say("tail", f"bn_relu_residual {h}x{w_}x{c} N={n} x/res {kinds}: "
                        f"max abs err {err:.3e} (max |out| {scale:.2f}, "
                        f"tolerance {tol:.2e}); two calls bit-equal; kernel "
                        f"{t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} ms, "
                        f"plain {t['plain']:.4f} ms, library "
                        f"({t['library_kind']}) {t['library']:.4f} ms; bound "
                        f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
                        f"({t['bytes']} B); kernel at {t['gbs']:.1f} GB/s, "
                        f"{t['share']:.3f} of its bound ("
                        f"{fmt_share(t['device_share'])} by device time)")
            if shape == TAIL_ROW_SHAPE and mix == (bf, bf):
                rows["bn_relu_residual"] = {
                    "name": "bn_relu_residual", "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/csrc/residual_tail.cu",
                    "replaces": "deeplearning4j_tpu/ops/residual_tail_pallas.py"
                                ":63",
                    "launches": 0, "max_abs_err": 0.0, "ms": min(t["kernel"]),
                    "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": t["library"]}
            del args, x
    rows["bn_relu_residual"]["max_abs_err"] = tail_err
    check_conv_tail_f16(cb, rt)
    return tuple(rows.values())


def check_conv_tail_f16(cb, rt) -> None:
    """C9: f16 by name on the card, at ResNet-50's first stage (batch 8):
    the conv ops (f16 x with an f16 or an f32 w) on the f32 route over
    widened copies, y in x's dtype within one f16 rounding (2^-10 of max
    |y|) of the plain version at f32 on the same values and the
    statistics as at f32 (``CONV_TOL``); the tail with an f16 x or res
    within one rounding of x's dtype (2^-10 of max |out| at f16, 1e-5 at
    f32)."""
    from deeplearning4j_tpu_torch.ndarray import Nd4j

    f16 = torch.float16
    g = torch.Generator(device=DEVICE).manual_seed(16)
    x = torch.randn(8, 56, 56, 64, generator=g, device=DEVICE).relu_()
    for taps, cout in ((1, 256), (9, 64)):
        wshape = (64, cout) if taps == 1 else (3, 3, 64, cout)
        w = torch.randn(wshape, generator=g, device=DEVICE) * math.sqrt(
            2.0 / (taps * 64))
        name = "conv1x1_bn_stats" if taps == 1 else "conv3x3_bn_stats"
        ref = (cb.conv1x1_bn_stats_reference if taps == 1
               else cb.conv3x3_bn_stats_reference)
        for w_dtype in (f16, torch.float32):
            xh, wh = x.to(f16), w.to(w_dtype)
            check(cb.kernel_route(xh, wh, taps) == "f32",
                  f"{name} f16 not on the f32 route")
            y, m, v = Nd4j.exec(name, xh, wh)
            ry, rm, rv = ref(xh.float(), wh.float())
            torch.cuda.synchronize()
            check(y.dtype == f16, f"{name} f16 output {y.dtype}")
            e = conv_errors(y, m, v, ry, rm, rv)
            tol = (2 ** -10,) + CONV_TOL[1:]
            check(all(a <= t for a, t in zip(e, tol)),
                  f"{name} f16 x, {w_dtype} w: errors {e} above {tol}")
            say("conv", f"{name} 56x56 64->{cout} N=8, x f16, w "
                        f"{str(w_dtype)[6:]} (f32 route over widened "
                        f"copies): err/max|y| {e[0]:.2e}, mean {e[1]:.2e}, "
                        f"var/max E[y^2] {e[2]:.2e}")
    for mix in ((f16, f16), (f16, torch.float32), (torch.float32, f16)):
        args = tail_case((8, 56, 56, 256), mix)
        out = Nd4j.exec("bn_relu_residual", *args)
        want = rt.residual_tail_reference(args[0].float(), args[1].float(),
                                          *args[2:])
        torch.cuda.synchronize()
        err = float((out.float() - want).abs().max())
        tol = 1e-5 if mix[0] == torch.float32 else \
            2 ** -10 * float(want.abs().max())
        check(out.dtype == mix[0] and err <= tol,
              f"bn_relu_residual x/res {mix}: {out.dtype}, {err:.3e} > "
              f"{tol:.3e}")
        say("tail", f"bn_relu_residual 56x56x256 N=8 x/res "
                    f"{'/'.join(str(d)[6:] for d in mix)} (the f32 kernel "
                    f"over widened copies): max abs err {err:.2e} "
                    f"(tolerance {tol:.2e})")


# ------------------------------------------------------- batch-norm kernels
#: the distinct batch-norm shapes of ResNet-50 (H = W, C) at batch 256
BN_SHAPES = [(112, 64), (56, 64), (56, 256), (28, 128), (28, 512),
             (14, 256), (14, 1024), (7, 512), (7, 2048)]
BN_BATCH = 256
#: the shape of the three batch-norm rows in the kernels line
BN_ROW_SHAPE = (56, 256)
#: the kernels line's batch-norm rows: name, the reference formula each
#: replaces (no Pallas kernel stands behind them), f32 operations per
#: element
BN_ROWS = (("bn_stats_kernel", "deeplearning4j_tpu/ops/nn.py:390", 3),
           ("bn_apply_kernel", "deeplearning4j_tpu/ops/nn.py:426", 2),
           ("bn_backward_kernel", "deeplearning4j_tpu/ops/nn.py:460", 14))
#: tolerances against the plain versions on the card: the statistics
#: (f32 sums of up to 3.2 M terms in another order) of max(1, |value|);
#: dx one bf16 rounding of max |dx|; dgamma, dbeta of the largest sum of
#: |terms| they add
BN_STATS_TOL, BN_DX_TOL, BN_SUM_TOL = 1e-4, 2 ** -8, 1e-5
#: the future of the two-launch design's build (``tools/bn_two_launch.cu``),
#: started by phase_build
BN_YARDSTICK = None


def bn_bounds(x) -> tuple:
    """(bound_ms, bound_by, bytes) of each kernel on ``x`` [rows, C]: (a)
    reads x and writes the f32 mean and var; (b) reads x and the four f32
    vectors and writes y; (c) reads x, g and the four vectors and writes
    dx, dgamma and dbeta; their f32 operations per element (BN_ROWS) at
    67 TFLOP/s."""
    n, c = x.numel() * x.element_size(), x.shape[1] * 4
    out = []
    for nbytes, (_, _, ops) in zip((n + 2 * c, 2 * n + 4 * c,
                                    3 * n + 6 * c), BN_ROWS):
        out.append((*bound(nbytes, ops * x.numel(), F32_FLOPS), nbytes))
    return tuple(out)


def phase_bn_kernels() -> tuple:
    """Phase 11b: the batch-norm kernels (``csrc/batch_norm.cu``) at every
    distinct ResNet-50 shape at batch 256 in bf16, against their plain
    versions on the card: (a) within ``BN_STATS_TOL``, (b) bit for bit on
    the same statistics, with and without the ReLU, (c) within
    ``BN_DX_TOL`` / ``BN_SUM_TOL`` with and without the ReLU; two calls
    bit-equal; each kernel's time (CUDA events, in turns) beside its plain
    version's, the library's (never called by the port: ``torch.var_mean``
    for (a), ``F.batch_norm`` in inference mode for (b), the backward of
    ``F.batch_norm`` in training mode for (c), cuDNN's NHWC kernels on a
    channels-last view) and its byte bound; (a) and (c) also in turns
    with their two-launch design (``tools/bn_two_launch.cu``, never
    called by the port) and, at ``BN_ROW_SHAPE``, a profiled call of each
    (one device kernel); then the f16 kernels (C9) at one shape. Returns
    the three rows of the kernels line at ``BN_ROW_SHAPE``."""
    from deeplearning4j_tpu_torch.ops import batch_norm as bn
    from deeplearning4j_tpu_torch.tools import bn_probe

    bf = torch.bfloat16
    errs = [0.0, 0.0, 0.0]
    rows = {}
    old_stats, old_bwd = bn_probe.legacy_calls(
        BN_YARDSTICK.result()["two launches"])
    for hw, c in BN_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(hw * c)
        x4 = (torch.randn(BN_BATCH, hw, hw, c, generator=g, device=DEVICE)
              * 2 + 0.5).to(bf)
        x = x4.reshape(-1, c)
        dy = torch.randn(x.shape, generator=g, device=DEVICE).to(bf)
        gamma = torch.rand(c, generator=g, device=DEVICE) + 0.5
        beta = torch.randn(c, generator=g, device=DEVICE)
        m, v = bn.bn_stats_kernel(x)
        rm, rv = bn.bn_stats_reference(x, (0,))
        e_stats = max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in ((m, rm), (v, rv)))
        check(e_stats <= BN_STATS_TOL, f"bn statistics {hw}x{hw}x{c}: "
                                       f"{e_stats:.3e} > {BN_STATS_TOL:g}")
        errs[0] = max(errs[0], max(float((m - rm).abs().max()),
                                   float((v - rv).abs().max())))
        del rm, rv
        line = [f"stats {e_stats:.2e}"]
        for relu in (False, True):
            y = bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, relu)
            check(torch.equal(y, bn.bn_apply_reference(
                x, m, v, gamma, beta, 1e-5, relu)),
                f"bn apply {hw}x{hw}x{c} relu={relu}: not bit-equal to the "
                f"plain version")
            dx, dg, db = bn.bn_backward_kernel(x, dy, m, v, gamma, beta,
                                               1e-5, relu)
            wx, wg, wb = bn.bn_backward_reference(x, dy, gamma, beta, m, v,
                                                  1e-5, relu, (0,))
            torch.cuda.synchronize()
            e_dx = float((dx.float() - wx.float()).abs().max()) / float(
                wx.float().abs().max())
            gsum = float(dy.float().abs().sum(0).max())
            e_db = float((db - wb).abs().max()) / gsum
            e_dg = float((dg - wg).abs().max()) / gsum / float(
                ((x.float() - m).abs().amax(0) * torch.rsqrt(v + 1e-5)).max())
            check(e_dx <= BN_DX_TOL and max(e_db, e_dg) <= BN_SUM_TOL,
                  f"bn backward {hw}x{hw}x{c} relu={relu}: dx {e_dx:.3e}, "
                  f"dbeta {e_db:.3e}, dgamma {e_dg:.3e}")
            errs[2] = max(errs[2], float((dx.float() - wx.float()).abs()
                                         .max()))
            line.append(f"relu={relu}: apply bit-equal, dx {e_dx:.2e}, "
                        f"dgamma {e_dg:.2e}, dbeta {e_db:.2e}")
            del y, dx, wx
        first = (*bn.bn_stats_kernel(x),
                 bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, True),
                 *bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, True))
        again = (*bn.bn_stats_kernel(x),
                 bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, True),
                 *bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, True))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"bn kernels at {hw}x{hw}x{c}: two calls differ")
        del first, again
        kernels = (lambda i: bn.bn_stats_kernel(x),
                   lambda i: bn.bn_apply_kernel(x, m, v, gamma, beta),
                   lambda i: bn.bn_backward_kernel(x, dy, m, v, gamma, beta))
        plains = (lambda i: bn.bn_stats_reference(x, (0,)),
                  lambda i: bn.bn_apply_reference(x, m, v, gamma, beta),
                  lambda i: bn.bn_backward_reference(x, dy, gamma, beta, m,
                                                     v))
        x_nchw = x4.permute(0, 3, 1, 2)        # a channels-last view
        lib_in = x_nchw.detach().clone(
            memory_format=torch.channels_last).requires_grad_(True)
        lib_g = gamma.clone().requires_grad_(True)
        lib_b = beta.clone().requires_grad_(True)
        lib_out = F.batch_norm(lib_in, None, None, lib_g, lib_b, True, 0.0,
                               1e-5)
        lib_dy = dy.reshape(x4.shape).permute(0, 3, 1, 2)
        libs = (lambda i: torch.var_mean(x, dim=0, correction=0),
                lambda i: F.batch_norm(x_nchw, m, v, gamma, beta, False,
                                       0.0, 1e-5),
                lambda i: torch.autograd.grad(lib_out, (lib_in, lib_g, lib_b),
                                              lib_dy, retain_graph=True))
        olds = (lambda i: old_stats(x),
                lambda i: old_bwd(x, dy, m, v, gamma, beta))
        kern1 = [cuda_ms(f, 10, 2) for f in kernels]
        old1 = [cuda_ms(f, 10, 2) for f in olds]
        plain = [cuda_ms(f, 3, 1) for f in plains]
        lib = [cuda_ms(f, 10, 2) for f in libs]
        old2 = [cuda_ms(f, 10, 2) for f in olds]
        kern2 = [cuda_ms(f, 10, 2) for f in kernels]
        del lib_in, lib_out
        bn.bn_stats_kernel(x)
        stats_plan = bn.last_launch()
        bn.bn_backward_kernel(x, dy, m, v, gamma, beta)
        bwd_plan = bn.last_launch()
        if (hw, c) == BN_ROW_SHAPE:
            check_bn_one_kernel(bn, x, dy, m, v, gamma, beta)
        bounds = bn_bounds(x)
        times = []
        for j, (name, replaces, _) in enumerate(BN_ROWS):
            ms = min(kern1[j], kern2[j])
            bound_ms, bound_by, nbytes = bounds[j]
            times.append(f"{name} {kern1[j]:.4f} / {kern2[j]:.4f} ms "
                         f"({bound_ms / ms:.3f} of its bound {bound_ms:.4f} "
                         f"ms by {bound_by}, {nbytes} B), plain "
                         f"{plain[j]:.4f}, library {lib[j]:.4f}")
            if (hw, c) == BN_ROW_SHAPE:
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/csrc/batch_norm.cu",
                    "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
                    "ms": ms, "plain_ms": plain[j], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib[j]}
        say("bn", f"{hw}x{hw}x{c} N={BN_BATCH} bf16 ({x.shape[0]} rows): "
                  f"{'; '.join(line)}; two calls bit-equal")
        say("bn", f"  {'; '.join(times)}")
        say("bn", "  in turns with the two-launch design "
                  "(tools/bn_two_launch.cu): " + "; ".join(
                      f"{name} one launch {kern1[j]:.4f} / {kern2[j]:.4f} ms, "
                      f"two launches {old1[i]:.4f} / {old2[i]:.4f} ms"
                      for i, (j, name) in enumerate(
                          ((0, "statistics"), (2, "backward"))))
                  + f"; plan (grid, ring stages, shared bytes, blocks per "
                    f"SM): statistics {stats_plan}, backward {bwd_plan}")
        del x4, x, dy, m, v
    for name, err in zip((r[0] for r in BN_ROWS), errs):
        rows[name]["max_abs_err"] = err
    say("bn", "library yardsticks (never called by the port): "
              "torch.var_mean (a), F.batch_norm in inference mode (b), the "
              "backward of F.batch_norm in training mode (c), on cuDNN's "
              "NHWC kernels; plain versions: the reference's formulas in "
              "eager PyTorch at f32")
    check_bn_f16(bn)
    return tuple(rows.values())


def check_bn_one_kernel(bn, x, dy, m, v, gamma, beta) -> None:
    """A profiled call of the statistics and of the backward each runs
    exactly one device kernel (memsets aside)."""
    from deeplearning4j_tpu_torch.tools import bn_probe

    for what, fn in (("statistics", lambda: bn.bn_stats_kernel(x)),
                     ("backward", lambda: bn.bn_backward_kernel(
                         x, dy, m, v, gamma, beta))):
        names = bn_probe.device_kernels(fn)
        if not names:
            say("bn", f"profiled {what} call: torch.profiler saw no device "
                      f"time (kernel count not measured)")
            continue
        check(len(names) == 1 and "bn_reduce_kernel" in names[0],
              f"a profiled {what} call ran {names}")
        say("bn", f"profiled {what} call: one device kernel, "
                  f"{names[0][:70]}")


def check_bn_f16(bn) -> None:
    """The f16 instances of the batch-norm kernels at 56x56x64, batch 8:
    (a) within ``BN_STATS_TOL``, (b) bit for bit, (c) dx within one f16
    rounding (2^-10) of max |dx|."""
    g = torch.Generator(device=DEVICE).manual_seed(16)
    x = (torch.randn(8 * 56 * 56, 64, generator=g, device=DEVICE) + 1).half()
    dy = torch.randn(x.shape, generator=g, device=DEVICE).half()
    gamma = torch.rand(64, generator=g, device=DEVICE) + 0.5
    beta = torch.randn(64, generator=g, device=DEVICE)
    m, v = bn.bn_stats_kernel(x)
    rm, rv = bn.bn_stats_reference(x, (0,))
    e = max(float((a - b).abs().max()) for a, b in ((m, rm), (v, rv)))
    check(e <= BN_STATS_TOL * max(1.0, float(rv.max()), float(rm.abs().max())),
          f"f16 bn statistics: {e:.3e}")
    for relu in (False, True):
        check(torch.equal(bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, relu),
                          bn.bn_apply_reference(x, m, v, gamma, beta, 1e-5,
                                                relu)),
              f"f16 bn apply relu={relu}: not bit-equal")
        dx = bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, relu)[0]
        wx = bn.bn_backward_reference(x, dy, gamma, beta, m, v, 1e-5,
                                      relu, (0,))[0]
        torch.cuda.synchronize()
        e_dx = float((dx.float() - wx.float()).abs().max()) / float(
            wx.float().abs().max())
        check(dx.dtype == torch.float16 and e_dx <= 2 ** -10,
              f"f16 bn backward relu={relu}: {e_dx:.3e}")
    say("bn", f"f16 at 56x56x64 N=8: statistics {e:.2e}, apply bit-equal, "
              f"dx within {e_dx:.2e} of max |dx| (relu on)")


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
                   ("conv_bn_stats", "reduce_stats", "residual_tail"),
                   {"conv_bn_stats": 12, "reduce_stats": 12,
                    "residual_tail": 4})

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


# ------------------------------------------------------- image models
LENET_BATCH, LENET_CLASSES = 64, 10
RESNET50_BATCH, RESNET50_HW, RESNET50_CLASSES = 256, 224, 1000
GRAPH_PARITY_BATCH = 8
PARITY_STEPS = 3
#: card (cuDNN, TF32 off) vs CPU at f32 after three steps: losses 1e-5
#: relative, BN running state and outputs 2e-5 of max(1, max |value|)
#: (conv sums in another order); parameters PARITY_PARAM_ATOL absolute
IMAGE_LOSS_RTOL, IMAGE_STATE_TOL = 1e-5, 2e-5


def numpy_tree(named_params, seed: int, scheme: str = "relu") -> dict:
    """Normal weights ``W`` from a numpy seed (``scheme`` "relu": He,
    sqrt(2 / fan_in); "xavier": sqrt(2 / (fan_in + fan_out)); fan_in the
    product of all but the last axis of HWIO or [in, out], fan_out the
    product of all but the next to last), ``gamma`` ones and every other
    leaf zero, at the shapes of ``named_params`` ((key, {name: tensor})
    pairs)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, p in named_params:
        out[key] = {}
        for k in sorted(p):
            shape = tuple(p[k].shape)
            if k == "W":
                fan_in = int(np.prod(shape[:-1]))
                fan_out = int(np.prod(shape[:-2])) * shape[-1]
                a = rng.standard_normal(shape) * math.sqrt(2.0 / (
                    fan_in if scheme == "relu" else fan_in + fan_out))
            else:
                a = np.full(shape, 1.0 if k == "gamma" else 0.0)
            out[key][k] = a.astype(np.float32)
    return out


def image_batch(n: int, hw: int, c: int, classes: int, seed: int):
    """bench.py's synthetic data: ``RandomState(seed)`` normal images
    [n, hw, hw, c] and one-hot labels."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, hw, hw, c)).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.randint(0, classes, n)]


def close_card_cpu(what: str, card, cpu, tol: float) -> float:
    """Max abs difference of two tensors, held to ``tol`` of max(1, max
    |cpu|)."""
    card, cpu = card.detach().float().cpu(), cpu.detach().float().cpu()
    check(card.shape == cpu.shape, f"{what}: {tuple(card.shape)} vs "
                                   f"{tuple(cpu.shape)}")
    err = float((card - cpu).abs().max()) if cpu.numel() else 0.0
    scale = max(1.0, float(cpu.abs().max())) if cpu.numel() else 1.0
    check(err <= tol * scale, f"{what}: card vs CPU {err:.3e} > {tol:g} x "
                              f"{scale:.3e}")
    return err


def check_losses(phase: str, card, cpu) -> None:
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    check(all(math.isfinite(v) for v in card + cpu),
          f"{phase}: losses {card} {cpu}")
    check(rel <= IMAGE_LOSS_RTOL, f"{phase}: card and CPU losses differ by "
                                  f"{rel:.3e} relative")
    say(phase, f"losses card {' '.join(f'{v:.7f}' for v in card)}, CPU "
               f"{' '.join(f'{v:.7f}' for v in cpu)} (max relative diff "
               f"{rel:.2e}, tolerance {IMAGE_LOSS_RTOL:g})")


def phase_lenet() -> None:
    """LeNet through MultiLayerNetwork, three Nesterovs steps on the card
    (cuDNN at f32, TF32 off) and on the CPU from one numpy tree. Nesterovs
    moves a parameter by lr times its gradient, so the gradients' rounding
    differences reach the parameters unamplified (Adam divides each
    gradient by its own size: where one cancels to near its epsilon, a
    rounding difference moves the update by up to lr)."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.zoo import LeNet

    t0 = time.perf_counter()
    lr = 1e-2
    zoo = LeNet(num_classes=LENET_CLASSES, updater=Nesterovs(lr, 0.9))
    x, y = image_batch(LENET_BATCH, 28, 1, LENET_CLASSES, seed=0)
    tree, runs = None, []
    for dev in (DEVICE, "cpu"):
        net = zoo.init(device=dev)
        if tree is None:
            tree = numpy_tree(enumerate(net.params_list), seed=13,
                              scheme="xavier")
        net.params_list = mln_params_from_numpy(
            [tree[i] for i in range(len(tree))], device=dev)
        start = net.params().cpu()
        losses = []
        for _ in range(PARITY_STEPS):
            net.fit(x, y)
            losses.append(net.score())
        runs.append((losses, net, float((net.params().cpu() - start)
                                        .abs().max())))
    (lc, card, moved), (lh, cpu, _) = runs
    check_losses("lenet", lc, lh)
    err, where = max((float((p[k].cpu() - q[k]).abs().max()), f"{i}/{k}")
                     for i, (p, q) in enumerate(zip(card.params_list,
                                                    cpu.params_list))
                     for k in q)
    check(err <= PARITY_PARAM_ATOL,
          f"lenet: parameters differ by {err:.3e} (layer {where})")
    check(moved >= 100 * PARITY_PARAM_ATOL,
          f"lenet: the card's updates moved no parameter by 100 x the "
          f"tolerance ({moved:.3e})")
    out = close_card_cpu("lenet output", card.output(x), cpu.output(x),
                         IMAGE_STATE_TOL)
    say("lenet", f"LeNet ({card.numParams()} parameters, conv 5x5 x20, pool, "
                 f"conv 5x5 x50, pool, dense 500, softmax {LENET_CLASSES}) at "
                 f"batch {LENET_BATCH} x 28x28x1, f32, Nesterovs({lr:g}, "
                 f"0.9): {PARITY_STEPS} steps, parameters max abs diff "
                 f"{err:.2e} at layer {where} (tolerance "
                 f"{PARITY_PARAM_ATOL:g}; the card moved one by up to "
                 f"{moved:.3e}), inference output {out:.2e}; "
                 f"{time.perf_counter() - t0:.1f} s")


def graph_macs(conf) -> int:
    """Multiply-adds per example of a graph's convolutions and dense
    layers, from the shapes its configuration gives them."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                         DenseLayer)

    types = dict(zip(conf.network_inputs, conf.input_types))
    macs = 0
    for node in conf.nodes:
        out = node.vertex.output_type([types[s] for s in node.inputs])
        layer = getattr(node.vertex, "layer", None)
        if isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernel_size
            macs += out.height * out.width * out.channels * kh * kw \
                * layer.n_in
        elif isinstance(layer, DenseLayer):
            macs += layer.n_in * layer.n_out
        types[node.name] = out
    return macs


def kernel_group(chain) -> str:
    """The group of a kernel (conv, batch norm, ReLU/add, updater or
    other) from the names of the CPU op that launched it and of its
    parents, innermost first: in the forward and the update, the record
    range that ``ComputationGraph`` puts around each vertex
    (``dl4j::<layer or vertex class>``) and around the update
    (``dl4j::updater``); in the backward, the autograd function (the
    batch-norm kernels' ``BatchNormKernelsBackward``)."""
    text = " | ".join(chain)
    if "BatchNormKernels" in text:
        return BN_GROUP
    if any(k in text for k in ("relu", "clamp_min", "threshold_backward",
                               "ReluBackward", "dl4j::ActivationLayer",
                               "dl4j::ElementWiseVertex")):
        return "ReLU/add"
    if "dl4j::updater" in text:
        return "updater"
    if "dl4j::ConvolutionLayer" in text or "onvolution" in text \
            or "aten::mm" in text or "aten::addmm" in text \
            or "MmBackward" in text:
        return "conv"
    # the batch norm's own forward, and in the backward its kernels'
    # function or the functions of an eager formula (the l2 term's and the
    # global pool's share them, small)
    if "dl4j::BatchNormalization" in text or any(k in text for k in (
            "MulBackward", "SubBackward", "MeanBackward", "ToCopyBackward",
            "MaximumBackward", "RsqrtBackward", "AddBackward",
            "SelectBackward")):
        return BN_GROUP
    return "other"


#: the batch norm's group in the device profile
BN_GROUP = "batch norm"


def library_batch_norm_train(x, gamma, beta, eps=1e-5, axes=None):
    """``F.batch_norm`` in training mode on an NHWC ``x`` (cuDNN's fused
    kernels, two-pass statistics and an unbiased running variance: not
    the reference's formula). A yardstick the port never calls."""
    c = x.shape[-1]
    mean = torch.zeros(c, device=x.device)
    var = torch.ones(c, device=x.device)
    y = F.batch_norm(x.permute(0, 3, 1, 2), mean, var, gamma.float(),
                     beta.float(), True, 1.0, eps)
    return y.permute(0, 2, 3, 1), mean.to(x.dtype), var.to(x.dtype)


def library_bn_step(phase: str, net, x, y, step_ms: float, smi: str,
                    steps: int = 5) -> None:
    """The same training step with every batch norm through
    :func:`library_batch_norm_train`, timed after one warm-up step: how
    much of the step the eager batch-norm formula costs."""
    from deeplearning4j_tpu_torch.ops import nn as nnops

    plain = nnops.batch_norm_train
    nnops.batch_norm_train = library_batch_norm_train
    try:
        net.fit(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            net.fit(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
    finally:
        nnops.batch_norm_train = plain
    check(math.isfinite(net.score()), "the yardstick's loss is not finite")
    say(phase, f"yardstick: the step with F.batch_norm (cuDNN) in place of "
               f"the reference's batch-norm formula, {steps} timed: "
               f"{ms:.2f} ms/step ({ms / step_ms:.3f} of the port's "
               f"{step_ms:.2f}); {smi}")


def bn_counts() -> tuple:
    from deeplearning4j_tpu_torch.ops import batch_norm as bn

    return bn.stats_launches, bn.apply_launches, bn.bwd_launches


def reset_bn_counts() -> None:
    from deeplearning4j_tpu_torch.ops import batch_norm as bn

    bn.stats_launches = bn.apply_launches = bn.bwd_launches = 0


def set_fused(on: bool) -> None:
    from deeplearning4j_tpu_torch.ops import nn as nnops

    nnops.FUSED_BN_RELU_BWD = on


def phase_resnet50_train(smi: str, rows: dict) -> None:
    """ResNet-50 through ComputationGraph at full width: bench.py's cell
    (batch 256, 224x224x3, bf16, Nesterovs(0.1, 0.9), RandomState(0)
    data), twice: with ``FUSED_BN_RELU_BWD`` off (the reference's
    default: batch norm, then the ReLU) and on (``batch_norm_relu_train``
    in every BN layer with a ReLU); cuDNN autotuning
    (``cudnn.benchmark``) on for this phase only."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50

    t_phase = time.perf_counter()
    B, HW = RESNET50_BATCH, RESNET50_HW
    conf = ResNet50(num_classes=RESNET50_CLASSES, in_shape=(HW, HW, 3),
                    updater=Nesterovs(learning_rate=1e-1,
                                      momentum=0.9)).conf()
    conf.dtype = "bfloat16"
    net = ComputationGraph(conf, device=DEVICE).init()
    n_params = net.numParams()
    n_bn = sum(isinstance(getattr(n.vertex, "layer", None),
                          BatchNormalization) for n in conf.nodes)
    if (HW, RESNET50_CLASSES) == (224, 1000):
        check(25_000_000 < n_params < 26_500_000,
              f"ResNet-50 has {n_params} parameters")
        check(n_bn == 53, f"ResNet-50 has {n_bn} batch-norm layers")
    x, y = image_batch(B, HW, 3, RESNET50_CLASSES, seed=0)
    x = torch.from_numpy(x).to(DEVICE, torch.bfloat16)
    y = torch.from_numpy(y).to(DEVICE)
    macs = graph_macs(conf)
    flops = 6 * macs * B        # 2 x MACs, x3 for the backward
    say("resnet50", f"ResNet50(num_classes={RESNET50_CLASSES}): {n_params} "
                    f"parameters, {len(conf.nodes)} nodes ({n_bn} batch "
                    f"norms), bf16, Nesterovs(0.1, 0.9), batch {B} x "
                    f"{HW}x{HW}x3; {macs / 1e9:.3f} GMAC per image forward, "
                    f"{flops / 1e12:.3f} TFLOP per training step")
    torch.backends.cudnn.benchmark = True
    try:
        step_ms = {}
        for fused in (False, True):
            set_fused(fused)
            step_ms[fused], launches = resnet50_run(net, x, y, fused, flops,
                                                    n_bn, smi)
            if not fused:
                for name, k in zip((r[0] for r in BN_ROWS), launches):
                    rows[name]["launches"] = k
        set_fused(False)
        say("resnet50", f"step with the fused ReLU {step_ms[True]:.2f} ms "
                        f"against {step_ms[False]:.2f} ms without "
                        f"({step_ms[True] / step_ms[False]:.3f}); {smi}")
        library_bn_step("resnet50", net, x, y, step_ms[False], smi)
    finally:
        set_fused(False)
        torch.backends.cudnn.benchmark = False
    del net, x, y
    torch.cuda.empty_cache()
    say("resnet50", f"phase {time.perf_counter() - t_phase:.1f} s")


def resnet50_run(net, x, y, fused: bool, flops: int, n_bn: int,
                 smi: str) -> tuple:
    """Warm-up and timed steps of phase 15 with the toggle as set: a
    finite loss at every step, one launch of each batch-norm kernel per
    BN layer per step, ms per step, images/s, peak memory, FLOP share,
    then one profiled step whose largest batch-norm operations must be the
    kernels (the eager formula gone). Returns (ms per step, the kernels'
    launches over the warm-up and timed steps)."""
    tag = ("fused ReLU on" if fused
           else "fused ReLU off, the reference's default")
    B = x.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_bn_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = bn_counts()
    steps = WARMUP_STEPS + TIMED_STEPS
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"losses {vals}")
    check({t.dtype for p in net.params_map.values()
           for t in p.values()} == {torch.bfloat16}, "a parameter left bf16")
    check(launches == (n_bn * steps,) * 3,
          f"batch-norm kernel launches {launches} over {steps} steps, not "
          f"one of each per BN layer per step ({n_bn * steps})")
    step_s = wall / TIMED_STEPS
    say("resnet50", f"[{tag}] {WARMUP_STEPS} warm-up steps in {warm_s:.2f} "
                    f"s (cuDNN autotuning included); losses "
                    + " ".join(f"{v:.4f}" for v in vals))
    say("resnet50", f"[{tag}] {TIMED_STEPS} timed steps: "
                    f"{step_s * 1e3:.2f} ms/step, {B / step_s:.1f} images/s; "
                    f"{smi}")
    say("resnet50", f"[{tag}] batch-norm kernel launches over {steps} steps "
                    f"(statistics, apply, backward): {launches}, "
                    f"{n_bn} BN layers x {steps}")
    say("resnet50", f"[{tag}] peak memory {peak} B ({peak / 2 ** 30:.2f} "
                    f"GiB, torch.cuda.max_memory_allocated); {smi}")
    say("resnet50", f"[{tag}] {flops / step_s / 1e12:.1f} TFLOP/s counted, "
                    f"{flops / step_s / BF16_FLOPS:.4f} of the bf16 "
                    f"tensor-core peak {BF16_FLOPS / 1e12:.0f} TFLOP/s; {smi}")

    def one_step():
        net.fit(x, y)

    out = {}
    # the layout transposes cuDNN would add around an NCHW kernel
    device_profile("resnet50", f"[{tag}] one profiled training step "
                               f"(unprofiled {step_s * 1e3:.2f} ms; {smi})",
                   one_step, ("nchwToNhwc", "nhwcToNchw", "bn_",
                              "bn_reduce_kernel", "bn_apply_kernel"),
                   group=kernel_group, top=10, out=out)
    eager = [n for n, _, g in out.get("largest", ())
             if g == BN_GROUP and "bn_" not in n]
    check(not eager, f"[{tag}] batch-norm work outside the kernels among "
                     f"the largest device operations: {eager}")
    return step_s * 1e3, launches


def phase_graph_parity() -> None:
    """The cut ResNet (``zoo.resnet50.cut_resnet_conf``) at f32: three
    Nesterovs steps on the card (cuDNN, TF32 off; the batch-norm kernels)
    and on the CPU from one numpy tree, then one ``output`` in inference
    mode; with ``FUSED_BN_RELU_BWD`` off and on."""
    try:
        for fused in (False, True):
            set_fused(fused)
            graph_parity(fused)
    finally:
        set_fused(False)


def graph_parity(fused: bool) -> None:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.params import cg_params_from_numpy
    from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

    t0 = time.perf_counter()
    conf = cut_resnet_conf()
    tree = numpy_tree(ComputationGraph(conf, device="cpu").init()
                      .params_map.items(), seed=21)
    x, y = image_batch(GRAPH_PARITY_BATCH, 32, 3, 4, seed=1)
    runs = []
    for dev in (DEVICE, "cpu"):
        g = ComputationGraph(conf, device=dev).init()
        g.params_map = cg_params_from_numpy(conf.nodes, tree, device=dev)
        start = g.params().cpu()
        losses = []
        reset_bn_counts()
        for _ in range(PARITY_STEPS):
            g.fit(x, y)
            losses.append(g.score())
        launched = bn_counts()
        runs.append((losses, g, float((g.params().cpu() - start)
                                      .abs().max()), launched))
    (lc, card, moved, launched), (lh, cpu, _, none) = runs
    check(min(launched) > 0 and none == (0, 0, 0),
          f"graph-parity: batch-norm kernel launches card {launched}, CPU "
          f"{none}")
    tag = "fused ReLU " + ("on" if fused else "off")
    check_losses(f"graph-parity [{tag}]", lc, lh)
    err = float((card.params().cpu() - cpu.params()).abs().max())
    check(err <= PARITY_PARAM_ATOL,
          f"graph-parity [{tag}]: parameters differ by {err:.3e}")
    check(moved >= 100 * PARITY_PARAM_ATOL,
          f"graph-parity [{tag}]: the card's updates moved no parameter by "
          f"100 x the tolerance ({moved:.3e})")
    state = max(close_card_cpu(f"BN state {n}/{k}", card.states_map[n][k],
                               cpu.states_map[n][k], IMAGE_STATE_TOL)
                for n in cpu.states_map for k in cpu.states_map[n])
    out = close_card_cpu("inference output", card.outputSingle(x),
                         cpu.outputSingle(x), IMAGE_STATE_TOL)
    say("graph-parity", f"[{tag}] cut ResNet ({cpu.numParams()} parameters; "
                        f"stem, a projection and an identity block, 32x32x3, "
                        f"4 classes) at batch {GRAPH_PARITY_BATCH}, f32, "
                        f"Nesterovs(0.05, 0.9), l2 1e-4: parameters max abs "
                        f"diff {err:.2e} (tolerance {PARITY_PARAM_ATOL:g}; the "
                        f"card moved one by up to {moved:.3e}), BN running "
                        f"state {state:.2e} and inference output {out:.2e} "
                        f"(tolerance {IMAGE_STATE_TOL:g} of max(1, |value|)); "
                        f"batch-norm kernel launches {launched}; "
                        f"{time.perf_counter() - t0:.1f} s")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["tail-times"]:
        # the residual tail's times alone, of the port found from the
        # current directory (an earlier tree, to compare designs)
        sys.path.insert(0, os.getcwd())
        phase_device()
        say_tail_times(argv[1] if len(argv) > 1 else os.getcwd())
        return 0
    if argv[:1] == ["resnet50-step"]:
        # phase 15 alone, of the port found from the current directory
        sys.path.insert(0, os.getcwd())
        smi = phase_device()
        import deeplearning4j_tpu_torch
        say("resnet50", f"[{argv[1] if len(argv) > 1 else os.getcwd()}] "
                        f"the port of {deeplearning4j_tpu_torch.__file__}")
        phase_resnet50_train(smi, {r[0]: {} for r in BN_ROWS})
        return 0
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
    rows.update((r["name"], r) for r in phase_bn_kernels())
    phase_resnet_blocks(rows)
    phase_resnet_parity()
    phase_lenet()
    phase_resnet50_train(smi, rows)
    phase_graph_parity()
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
