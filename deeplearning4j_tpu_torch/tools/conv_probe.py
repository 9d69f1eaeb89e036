"""Measurements of the conv + BN-stats kernel (``csrc/conv_bn_stats.cu``)
on the card, beyond the times ``chip_smoke.py`` takes.

Run from the repository root on a machine with one CUDA card::

    python -m deeplearning4j_tpu_torch.tools.conv_probe [split] [variants]
        [spacing] [host]

With no argument it runs all four:

- split: a copy of the kernel source with ``clock64`` counters on thread
  0 of every tensor-core block; per ResNet-50 conv shape, a block's mean
  cycles waiting for its stage and the barrier, issuing the next stage's
  cp.async copies, issuing and waiting for its wgmma group, and in the
  epilogue;
- variants: copies with another ring depth, blocks per SM, wgmma groups
  in flight or cache hint, timed beside the source as it is (CUDA
  events), each holding y bit-equal to it;
- spacing: one kernel's profiler time beside its event time, launched
  back to back and with host gaps, beside the SM clock nvidia-smi reads;
- host: the host's time per call at a tiny shape, layer by layer.

Every copy is the source with text substitutions, each of which must find
its anchor or the run fails, built under the git-ignored ``_build/probe/``.
Nothing here changes what the port computes.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import subprocess
import sys
import time

import torch

from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
from deeplearning4j_tpu_torch.ops import native

#: (kind, N, H, W, Cin, Cout): ResNet-50's stride-1 conv classes at batch
#: 256, as chip_smoke.py's phase 11 runs them
SHAPES = [("1x1", 256, 56, 56, 64, 64), ("1x1", 256, 56, 56, 64, 256),
          ("1x1", 256, 56, 56, 256, 64), ("1x1", 256, 28, 28, 512, 128),
          ("1x1", 256, 28, 28, 128, 512), ("1x1", 256, 14, 14, 1024, 256),
          ("1x1", 256, 14, 14, 256, 1024), ("1x1", 256, 7, 7, 2048, 512),
          ("1x1", 256, 7, 7, 512, 2048), ("3x3", 256, 56, 56, 64, 64),
          ("3x3", 256, 28, 28, 128, 128), ("3x3", 256, 14, 14, 256, 256),
          ("3x3", 256, 7, 7, 512, 512)]

# clock64 counters: wait (cp.async wait + barrier), copy (issuing the next
# stage), mma (issuing and waiting for the wgmma group), epilogue
SPLIT = [
    ("namespace tc {\n",
     "namespace tc {\n__device__ unsigned long long g_prof[8];\n"),
    ("  int c_step = 0;\n",
     "  int c_step = 0;\n  long long pw = 0, pa = 0, pm = 0, pe = 0;\n"
     "  const long long tstart = clock64();\n"),
    ("      cp_wait<T::kStages - 3>();",
     "      const long long t0 = clock64();\n"
     "      cp_wait<T::kStages - 3>();"),
    ("      __syncthreads();  // everyone's copies landed",
     "      __syncthreads();\n      const long long t1 = clock64();  //"),
    ("      advance();        // refills the buffer of step - 2\n",
     "      advance();\n      const long long t2 = clock64();\n"),
    ("      wgmma_wait<1>();\n    }\n",
     "      wgmma_wait<1>();\n      pm += clock64() - t2; pa += t2 - t1;"
     " pw += t1 - t0;\n    }\n    const long long te = clock64();\n"),
    ("col0 + c * 8) = v;\n    }\n",
     "col0 + c * 8) = v;\n    }\n    pe += clock64() - te;\n"),
    ("      partial[(static_cast<long long>(which) * G + g) * s.cout + col0 "
     "+ c] = a;\n  }\n}\n",
     "      partial[(static_cast<long long>(which) * G + g) * s.cout + col0 "
     "+ c] = a;\n  }\n  if (tid == 0) {\n"
     "    const long long v[6] = {pw, pa, pm, pe, clock64() - tstart, 1};\n"
     "    for (int i = 0; i < 6; ++i) atomicAdd(&g_prof[i], "
     "(unsigned long long)v[i]);\n  }\n}\n"),
    ('extern "C" {\n',
     'extern "C" {\nvoid dl4j_probe_read(unsigned long long* out) {\n'
     '  cudaDeviceSynchronize();\n'
     '  cudaMemcpyFromSymbol(out, tc::g_prof, 8 * sizeof(long long));\n'
     '  const unsigned long long z[8] = {};\n'
     '  cudaMemcpyToSymbol(tc::g_prof, z, sizeof z);\n}\n'),
]
STAGES = "static constexpr int kStages = BN == 128 ? 5 : 4;"
BLOCKS = "static constexpr int kMinBlocks = BN == 128 ? 1 : 2;"
VARIANTS = {
    "wgmma groups 2 in flight, ring 6": [
        ("for (int i = 0; i < T::kStages - 2; ++i) advance();",
         "for (int i = 0; i < T::kStages - 3; ++i) advance();"),
        ("cp_wait<T::kStages - 3>();", "cp_wait<T::kStages - 4>();"),
        ("      wgmma_wait<1>();\n", "      wgmma_wait<2>();\n"),
        (STAGES, "static constexpr int kStages = 6;"),
        (BLOCKS, "static constexpr int kMinBlocks = 1;")],
    "BN 64 at 1 block per SM, ring 8": [
        (STAGES, "static constexpr int kStages = BN == 128 ? 5 : 8;"),
        (BLOCKS, "static constexpr int kMinBlocks = 1;")],
    "BN 128 ring 4": [(STAGES, "static constexpr int kStages = 4;")],
    "cp.async.ca (through L1)": [
        ("cp.async.cg.shared.global", "cp.async.ca.shared.global")],
}


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def build(copies: dict) -> dict:
    """Build each edited copy of the source (one nvcc each, all at once);
    returns name -> loaded library."""
    src = open(native._source("conv_bn_stats")).read()
    out = os.path.join(native.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(copies.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: anchor not found: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [native.nvcc(), *native.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            cu[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


@contextlib.contextmanager
def using(lib):
    """Route the wrapper's launches through ``lib`` (an edited copy)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_conv_bn_stats.argtypes = [vp, vp, vp, vp, vp, vp,
                                       ctypes.c_longlong] + [i] * 6 + [vp]
    lib.dl4j_conv_bn_stats.restype = ctypes.c_int
    lib.dl4j_conv_bn_stats_scratch.argtypes = [ctypes.c_longlong] + [i] * 6
    lib.dl4j_conv_bn_stats_scratch.restype = ctypes.c_longlong
    lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    saved = cb._lib
    cb._lib = lambda: lib
    try:
        yield
    finally:
        cb._lib = saved


def cuda_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def inputs(shape, seed: int = 1):
    kind, n, h, w_, cin, cout = shape
    taps = 1 if kind == "1x1" else 9
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, h, w_, cin, generator=g, device="cuda").relu_()
    ws = (cin, cout) if taps == 1 else (3, 3, cin, cout)
    w = torch.randn(ws, generator=g, device="cuda") \
        * math.sqrt(2.0 / (taps * cin))
    return x.to(torch.bfloat16), w.to(torch.bfloat16), taps


def label(shape) -> str:
    kind, n, h, w_, cin, cout = shape
    return f"{kind} {h}x{w_} {cin}->{cout} N={n}"


def run_split() -> None:
    lib = build({"split": SPLIT})["split"]
    lib.dl4j_probe_read.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * 8)()
    with using(lib):
        for shape in SHAPES:
            x, w, taps = inputs(shape)
            cb.conv_bn_stats_kernel(x, w, taps, route="tc")
            lib.dl4j_probe_read(ctypes.addressof(out))
            cb.conv_bn_stats_kernel(x, w, taps, route="tc")
            lib.dl4j_probe_read(ctypes.addressof(out))
            blocks = max(int(out[5]), 1)
            total = out[4] / blocks
            parts = [out[i] / blocks for i in range(4)]
            names = ("wait + barrier", "copy issue", "wgmma issue + wait",
                     "epilogue")
            print(f"[split] {label(shape)}: {total:.0f} cycles per block ("
                  f"{blocks} blocks) = " + ", ".join(
                      f"{n} {p:.0f} ({p / total:.2f})"
                      for n, p in zip(names, parts)), flush=True)
            del x, w


def run_variants() -> None:
    libs = {"source as it is": native.load("conv_bn_stats")}
    libs.update(build(VARIANTS))
    totals = dict.fromkeys(libs, 0.0)
    for shape in SHAPES:
        x, w, taps = inputs(shape)
        times = {k: [] for k in libs}
        ref = None
        for _ in range(2):              # turns: every copy, twice
            for name, lib in libs.items():
                with using(lib):
                    y = cb.conv_bn_stats_kernel(x, w, taps, route="tc")[0]
                    if ref is None:
                        ref = y
                    elif not torch.equal(y, ref):
                        raise RuntimeError(f"{name}: y differs at "
                                           f"{label(shape)}")
                    times[name].append(cuda_ms(
                        lambda: cb.conv_bn_stats_kernel(x, w, taps,
                                                        route="tc")))
        for k, v in times.items():
            totals[k] += min(v)
        print(f"[variants] {label(shape)}: " + "; ".join(
            f"{k} {min(v):.4f} ms" for k, v in times.items()), flush=True)
        del x, w, ref
    print("[variants] sum over the 13 shapes: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in totals.items()))


def run_spacing() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for shape in (SHAPES[1], SHAPES[9]):
        x, w, taps = inputs(shape)

        def fn():
            return cb.conv_bn_stats_kernel(x, w, taps)

        for _ in range(5):
            fn()
        for gap_us in (0, 300, 2000):
            evs = [(torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True)) for _ in range(30)]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for a, b in evs:
                    a.record()
                    fn()
                    b.record()
                    if gap_us:
                        torch.cuda.synchronize()
                        time.sleep(gap_us * 1e-6)
                torch.cuda.synchronize()
            ev = sorted(a.elapsed_time(b) for a, b in evs)
            kern = sorted(e.time_range.elapsed_us() for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and "conv_bn_stats" in e.name)
            print(f"[spacing] {label(shape)}, host gap {gap_us} us: events "
                  f"per call median {ev[15]:.4f} ms; profiler kernel median "
                  f"{kern[len(kern) // 2] / 1e3:.4f} ms ({len(kern)} of 30 "
                  f"launches traced); SM clock, power: "
                  f"{smi('clocks.sm,power.draw')}", flush=True)
        print(f"[spacing] {label(shape)}: 30 calls back to back, no "
              f"profiler: {cuda_ms(fn):.4f} ms per call")
        del x, w


def run_host() -> None:
    from deeplearning4j_tpu_torch.ndarray import Nd4j

    def per_call(fn, n: int = 2000) -> float:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    lib = cb._lib()
    for route, dt in (("tc", torch.bfloat16), ("wmma", torch.bfloat16),
                      ("f32", torch.float32)):
        x = torch.randn(128, 64, device="cuda").to(dt)
        w = torch.randn(64, 64, device="cuda").to(dt)
        y = torch.empty(128, 64, device="cuda", dtype=dt)
        part = torch.empty(cb.scratch_floats(128, 1, 1, 64, 64, 1, route),
                           device="cuda")
        mv = torch.empty(2, 64, device="cuda")
        args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
                mv[0].data_ptr(), mv[1].data_ptr(), 128, 1, 1, 64, 64, 1,
                cb.ROUTES[route], torch.cuda.current_stream().cuda_stream)
        calls = {
            "C entry (conv + reduction launches)":
                lambda: lib.dl4j_conv_bn_stats(*args),
            "conv_bn_stats_kernel":
                lambda: cb.conv_bn_stats_kernel(x, w, 1, route=route)}
        if route != "f32":
            calls["Nd4j.exec"] = lambda: Nd4j.exec("conv1x1_bn_stats", x, w)
        print(f"[host] {route} route, 128 x 64 -> 64: us per call: "
              + ", ".join(f"{k} {per_call(f):.1f}" for k, f in calls.items()),
              flush=True)
    x = torch.randn(128, 64, device="cuda").to(torch.bfloat16)
    w = torch.randn(64, 64, device="cuda").to(torch.bfloat16)
    lib_us = per_call(lambda: torch.var_mean(torch.matmul(x, w), dim=0,
                                             correction=0))
    print(f"[host] torch.matmul + torch.var_mean, the same shape: "
          f"{lib_us:.1f} us per call")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("conv_probe: no CUDA device", file=sys.stderr)
        return 1
    modes = {"split": run_split, "variants": run_variants,
             "spacing": run_spacing, "host": run_host}
    chosen = argv or list(modes)
    bad = [m for m in chosen if m not in modes]
    if bad:
        print(f"conv_probe: unknown mode {bad}; modes: {list(modes)}",
              file=sys.stderr)
        return 2
    print(f"[probe] {smi('name,power.limit')}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    for m in chosen:
        modes[m]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
