"""Where a paged-attention call's time goes on the card: device time and
host cost per call of ``ops/paged_attention.py``'s kernel at the shapes
the serving slice gives it, and a block's cycles by phase.

Run from the repository root on a machine with one CUDA card::

    python -m deeplearning4j_tpu_torch.tools.attention_probe [times] [cycles]

- times (the default): per shape the CUDA-event time per call (launches
  back to back over the 12 layers), the profiler's device time per call
  of the kernel, and the host's time per call of the wrapper and, where
  the package has the packed C entry, of that entry alone (enqueue
  only). It needs only the wrapper's signature ``paged_attention_kernel(
  q, kv, layer, tables, qbase)``, so the same file measures an earlier
  tree of the port when copied into it;
- cycles: from a copy of the source with ``clock64`` counters on thread 0
  of every block, a block's mean cycles in its prologue (qbase, the page
  table row, the query rows), waiting for its chunks' copies, computing,
  at the barrier before the warps' merge and in that merge, at the
  planned warp count and at the count half an SM's shared memory gives.
  The copy is built under the git-ignored ``_build/probe/``; every edit
  must find its anchor once.

``chip_smoke.py`` phase 3 builds its cases with :func:`kernel_case` and
reads :func:`shape_times`.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.ops import paged_attention as pa

#: the serving slice's attention shape: 8 slots, pages of 16 positions,
#: GPT-2 small's 12 heads of 64 and 12 layers, a 512-position context
SLOTS, PAGE, HEADS, HEAD_DIM, LAYERS, MAX_CONTEXT = 8, 16, 12, 64, 12, 512
PAGES_PER_SLOT = MAX_CONTEXT // PAGE
#: (pool kind, query dtype) of the cases: float pools in the query's
#: dtype, or fp8 pools with f32 scale planes under f32 or bf16 queries
KINDS = {"f32": ("float", torch.float32), "bf16": ("float", torch.bfloat16),
         "fp8-f32": ("fp8", torch.float32),
         "fp8-bf16": ("fp8", torch.bfloat16)}
#: (row name, description, kernel_case args and kwargs) of the timed
#: shapes: chip_smoke.py's four kernel rows, then the f32 engine's decode
SHAPES = [
    ("paged_attention", "decode N=8 Q=1 bf16", (1, "bf16"),
     dict(seed=7, full=True)),
    ("paged_attention_fp8", "decode N=8 Q=1 fp8 pools, bf16 queries",
     (1, "fp8-bf16"), dict(seed=8, full=True)),
    ("paged_attention_verify", "verify N=8 Q=5 bf16", (5, "bf16"),
     dict(seed=9, full=True)),
    ("paged_attention_prefix", "prefix N=1 Q=128 qbase=287 bf16",
     (128, "bf16"), dict(seed=11, N=1, qbase=287)),
    ("paged_attention_f32", "decode N=8 Q=1 f32", (1, "f32"),
     dict(seed=12, full=True)),
]


def kernel_case(Q: int, kind: str, seed: int, full: bool = False,
                N: int = SLOTS, qbase=None, device: str = "cuda"):
    """Pools [L, n_pages, H, ps, hd] (fp8 kinds: quantized per page and
    head with the port's helpers, plus the scale planes), queries and
    page tables at the serving slice's shapes. With ``qbase`` given, N
    rows of 32 distinct pages each query from that position (the
    prefix-prefill shape at N=1). Mixed case: rows 0-1 share their first
    four pages (a shared prompt prefix), rows 2-3 end in null-page tails,
    row 0 attends at full context and row 1 at position 0. Full case:
    every row owns 32 distinct pages and attends at full context (the
    steady state of the timing)."""
    from deeplearning4j_tpu_torch.nn.precision import fp8_scale, quantize_fp8

    pool, qdtype = KINDS[kind]
    dev = torch.device(device)
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


def event_ms(fn, iters: int, warmup: int = 10) -> float:
    """CUDA-event milliseconds per call of ``fn(i)``, back to back."""
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


def host_us(fn, calls: int = 400) -> float:
    """Host microseconds per call of ``fn(i)``: the card is synchronized
    before and after, never inside, so this is what the host spends to
    enqueue a call (the card runs behind it)."""
    for i in range(20):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def device_us(fn, calls: int = 48,
              pattern: str = r"paged_attention\w*kernel"):
    """(device microseconds per traced launch of the kernels matching
    ``pattern``, launches traced) from a torch.profiler trace of ``calls``
    calls; (0, 0) when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and re.search(pattern, e.name):
            total += e.time_range.elapsed_us()
            n += 1
    return (total / n if n else 0.0), n


def plan_of(q, kv, tables, smem_per_sm: int = 0):
    """The wrapper's launch plan for this call (at ``smem_per_sm`` bytes
    of shared memory per SM where given, else the card's)."""
    N, H, Q, hd = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pa.launch_plan(N, H, Q, tables.shape[1], kv["k"].shape[3], hd,
                          kv["k"].element_size(), sms,
                          smem_per_sm or pa.SMEM_PER_SM)


def entry_call(lib, q, kv, tables, qbase, plan):
    """``fn(i)`` calling the packed C entry of ``lib`` alone at layer
    ``i % 12``, with the arguments and the output made once (the host cost
    under the wrapper's checks and allocations)."""
    k, v = kv["k"], kv["v"]
    ksc, vsc = kv.get("k_scale"), kv.get("v_scale")
    fp8 = ksc is not None
    out = torch.empty_like(q)
    ints = pa.pack_ints(q, k, tables, plan, 0, fp8)
    ptrs = (ctypes.c_void_p * 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ksc.data_ptr() if fp8 else 0, vsc.data_ptr() if fp8 else 0,
        tables.data_ptr(), qbase.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(0).cuda_stream)
    fn = lib.dl4j_paged_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_float]
    fn.restype = ctypes.c_int
    scale = 1.0 / math.sqrt(q.shape[-1])

    def run(i):
        err = fn(ptrs, ints, i % LAYERS, scale)
        if err:
            raise RuntimeError(f"C entry: cudaError {err}")
    run.out = out
    return run


def shape_times(q, kv, tables, qbase) -> dict:
    """Event, device and host times per call at one shape, through the
    wrapper (and the C entry alone where the package has it)."""
    def call(i):
        pa.paged_attention_kernel(q, kv, i % LAYERS, tables, qbase)

    res = {"event_ms": event_ms(call, 240)}
    res["device_us"], res["traced"] = device_us(call)
    res["host_us"] = host_us(call)
    if hasattr(pa, "pack_ints"):
        res["c_entry_us"] = host_us(entry_call(
            native.load("paged_attention"), q, kv, tables, qbase,
            plan_of(q, kv, tables)))
    return res


_T0 = ("  const long long t_start = clock64();\n"
       "  long long t_wait = 0;\n")
#: edits of ``csrc/paged_attention.cu`` for the cycles mode's counters:
#: prologue, chunk waits, compute, the barrier before the warps' merge,
#: the merge; then blocks and total cycles
CYCLES = [
    ("namespace {\n\nconstexpr int kWarp = 32;\n",
     "namespace {\n__device__ unsigned long long g_prof[7];\n\n"
     "constexpr int kWarp = 32;\n"),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n",
     "  extern __shared__ __align__(16) unsigned char smem[];\n" + _T0),
    ("  const int n_chunks = (ke + kChunk - 1) / kChunk;\n"
     "  __syncthreads();\n",
     "  const int n_chunks = (ke + kChunk - 1) / kChunk;\n"
     "  __syncthreads();\n  const long long t_pro = clock64();\n"),
    ("    cp_wait_one();  // this lane's copies of chunk i have landed\n"
     "    __syncwarp();   // and every lane's\n",
     "    const long long tw = clock64();\n    cp_wait_one();\n"
     "    __syncwarp();\n    t_wait += clock64() - tw;\n"),
    ("  // the block's merge of its warps, in warp order, through the spent "
     "rings\n  __syncthreads();\n",
     "  const long long t_loop = clock64();\n  __syncthreads();\n"
     "  const long long t_loopb = clock64();\n"),
    ("    out[(prow + r) * hd + d] = from_f32<T>(L > 0.f ? A / L : 0.f);\n"
     "  }\n",
     "    out[(prow + r) * hd + d] = from_f32<T>(L > 0.f ? A / L : 0.f);\n"
     "  }\n  if (threadIdx.x == 0) {\n"
     "    const long long t_end = clock64();\n"
     "    const long long v[7] = {t_pro - t_start, t_wait, "
     "t_loop - t_pro - t_wait,\n"
     "                            t_loopb - t_loop, t_end - t_loopb, 1, "
     "t_end - t_start};\n"
     "    for (int i = 0; i < 7; ++i) atomicAdd(&g_prof[i], "
     "(unsigned long long)v[i]);\n  }\n"),
    ('extern "C" {\n',
     'extern "C" {\nvoid dl4j_probe_read(unsigned long long* out) {\n'
     '  cudaDeviceSynchronize();\n'
     '  cudaMemcpyFromSymbol(out, g_prof, 7 * sizeof(long long));\n'
     '  const unsigned long long z[7] = {};\n'
     '  cudaMemcpyToSymbol(g_prof, z, sizeof z);\n}\n'),
]
PHASES = ("prologue", "chunk waits", "compute", "barrier", "warps' merge")


def build_cycles():
    """The source with :data:`CYCLES`' counters, built and loaded."""
    text = open(native._source("paged_attention")).read()
    for old, new in CYCLES:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once: {old!r}")
        text = text.replace(old, new)
    out = os.path.join(native.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "attention_cycles.cu")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-o",
                           cu[:-3] + ".so", cu], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(cu[:-3] + ".so")
    lib.dl4j_probe_read.argtypes = [ctypes.c_void_p]
    return lib


def run_cycles() -> None:
    lib = build_cycles()
    out = (ctypes.c_ulonglong * 7)()
    for name, label, args, kw in SHAPES:
        q, kv, tables, qbase = kernel_case(*args, **kw)
        want = pa.paged_attention_kernel(q, kv, 0, tables, qbase)
        for budget in (pa.SMEM_PER_SM, pa.SMEM_PER_SM // 2):
            plan = plan_of(q, kv, tables, budget)
            call = entry_call(lib, q, kv, tables, qbase, plan)
            call(0)
            lib.dl4j_probe_read(ctypes.addressof(out))
            us = event_ms(call, 48) * 1e3
            call(0)
            torch.cuda.synchronize()
            if plan.warps == plan_of(q, kv, tables).warps and \
                    not torch.equal(call.out, want):
                raise RuntimeError(f"{label}: the counted copy's output "
                                   f"differs from the package's")
            call(1)
            lib.dl4j_probe_read(ctypes.addressof(out))
            blocks = max(int(out[5]), 1)
            per = [out[i] / blocks for i in range(5)]
            print(f"[cycles] {label}, {plan.warps} warps: event {us:.1f} us "
                  f"per call (counted copy); a block's cycles "
                  f"{out[6] / blocks:.0f} = "
                  + ", ".join(f"{n} {p:.0f}" for n, p in zip(PHASES, per))
                  + f" ({blocks} blocks)", flush=True)


def run_times() -> None:
    for name, label, args, kw in SHAPES:
        r = shape_times(*kernel_case(*args, **kw))
        extra = (f", C entry {r['c_entry_us']:.1f} us"
                 if "c_entry_us" in r else "")
        print(f"[times] {label}: event {r['event_ms'] * 1e3:.1f} us per "
              f"call, device {r['device_us']:.1f} us ({r['traced']} of 48 "
              f"launches traced), wrapper host {r['host_us']:.1f} us{extra}",
              flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device")
        return 1
    print(f"{torch.cuda.get_device_name(0)}")
    for mode in argv or ["times"]:
        {"times": run_times, "cycles": run_cycles}[mode]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
