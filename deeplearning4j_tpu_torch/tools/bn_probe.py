"""Measurements of the batch-norm statistics and backward kernels
(``csrc/batch_norm.cu``, ``bn_reduce_kernel``) on the card, beyond the
times ``chip_smoke.py`` takes.

Run from the repository root on a machine with one CUDA card::

    python -m deeplearning4j_tpu_torch.tools.bn_probe [times] [split] [host] [variants] [compare=PATH,...]

With no argument it runs times, split and host, at the nine distinct
batch-norm shapes of ResNet-50 at batch 256 in bf16 (``[rows, C]``), the
backward without the ReLU and without the statistics' gradients, as the
ResNet-50 step calls it:

- times: each shape's statistics and backward, in turns (two rounds,
  CUDA events) with the two-launch design they replaced
  (``tools/bn_two_launch.cu``), beside their bounds and the library's
  calls (``torch.var_mean``; the backward of ``F.batch_norm`` in training
  mode on a channels-last view); then a profiled call of each, which must
  show one device kernel;
- compare=PATH[,PATH...]: other copies of ``batch_norm.cu``, timed alike
  in turns with the source; a copy whose text has no ``bn_reduce_kernel``
  is called as the two-launch design is (its C entries take the grid of
  ``launch_plan``);
- split: a copy of the source with ``clock64`` counters on thread 0 of
  every block: a block's mean cycles in each phase (the ring waits and
  the sums of pass A, the fold, the first grid barrier, the sum of the
  partials, the second grid barrier, the ring waits and the dx of pass
  B), and the plan (grid, ring stages, shared bytes);
- host: the host's microseconds per call of the two wrappers at [4096,
  64] bf16 (the card synchronized before and after only), and of the
  statistics' C entry alone. It needs only the wrappers' signatures, so
  the same file measures an earlier tree of the port when copied into it;
- variants: copies of the source with one change (``VARIANTS``), timed
  in turns with it at the nine shapes, and their host cost.

Every copy is built under the git-ignored ``_build/probe/``, named by a
hash of its text; the split's edits must each find their anchor.
``chip_smoke.py`` (phase 11b) times the two-launch design through
:func:`build` and :func:`legacy_calls`. Nothing here changes what the
port computes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import batch_norm as bn
from deeplearning4j_tpu_torch.ops import native

#: the distinct batch-norm shapes of ResNet-50 (H = W, C) at batch 256
SHAPES = [(112, 64), (56, 64), (56, 256), (28, 128), (28, 512), (14, 256),
          (14, 1024), (7, 512), (7, 2048)]
BATCH = 256
#: the two-launch design, kept as the yardstick
TWO_LAUNCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "bn_two_launch.cu")
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
#: tensor cores
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12

PHASES = ("ring waits A", "sums A", "fold", "grid barrier 1",
          "partials summed", "grid barrier 2", "ring waits B", "dx B")


def read(path: str) -> str:
    with open(path) as f:
        return f.read()


def build(copies: dict) -> dict:
    """Build each copy of the source (name -> its text; one nvcc each, all
    at once); returns name -> loaded library."""
    out = os.path.join(native.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, text in copies.items():
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        cu = os.path.join(out, f"bn-{digest}.cu")
        so = cu[:-3] + ".so"
        if os.path.exists(so):
            procs[name] = (None, so)
            continue
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [native.nvcc(), *native.NVCC_FLAGS, "-o", so + ".tmp", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: nvcc failed:\n{log}")
            os.replace(so + ".tmp", so)
        libs[name] = ctypes.CDLL(so)
    return libs


def current_calls(lib):
    """``(stats(x), backward(x, dy, m, v, gamma, beta))`` through the
    wrappers with their launches routed to ``lib``, a copy of the source
    with the current C entries."""
    ref = bn._lib()
    for fn in ("dl4j_bn_stats", "dl4j_bn_backward", "dl4j_cuda_error_string"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype

    def routed(fn):
        def call(*args):
            saved = bn._lib
            bn._lib = lambda: lib
            try:
                return fn(*args)
            finally:
                bn._lib = saved
        return call

    return (routed(bn.bn_stats_kernel),
            routed(lambda x, dy, m, v, g, b: bn.bn_backward_kernel(
                x, dy, m, v, g, b)))


def legacy_calls(lib):
    """``(stats(x), backward(x, dy, m, v, gamma, beta))`` of the two-launch
    design's C entries in ``lib``: the grid of ``launch_plan``, f32
    partials of ``2 * chunks * C`` floats, the backward without the ReLU
    and without the statistics' gradients."""
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.dl4j_bn_stats.argtypes = [i, vp, ll, i, i, i, i, ll, vp, vp, vp, vp]
    lib.dl4j_bn_backward.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, f, i,
                                     ll, i, i, i, i, ll, vp, vp, vp, vp, vp]
    lib.dl4j_bn_stats.restype = lib.dl4j_bn_backward.restype = ctypes.c_int

    def plan(*ts):
        rows, c = ts[0].shape
        aligned = all(t.data_ptr() % 16 == 0 for t in ts)
        return (rows, c) + bn.launch_plan(rows, c, ts[0].element_size(),
                                          aligned)

    def stats(x):
        rows, c, vec, tg, chunks, rpc = plan(x)
        part = torch.empty(2 * chunks * c, device=x.device)
        out = torch.empty(2, c, device=x.device)
        err = lib.dl4j_bn_stats(bn.DTYPES[x.dtype], x.data_ptr(), rows, c,
                                vec, tg, chunks, rpc, part.data_ptr(),
                                out.data_ptr(), out.data_ptr() + 4 * c,
                                bn._stream(x.get_device()))
        if err:
            raise RuntimeError(f"two-launch statistics: cudaError {err}")
        return out[0], out[1]

    def backward(x, dy, m, v, gamma, beta):
        dx = torch.empty_like(x)
        rows, c, vec, tg, chunks, rpc = plan(x, dy, dx)
        part = torch.empty(2 * chunks * c, device=x.device)
        out = torch.empty(2, c, device=x.device)
        err = lib.dl4j_bn_backward(
            bn.DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(), m.data_ptr(),
            v.data_ptr(), gamma.data_ptr(), beta.data_ptr(), None, None,
            1e-5, 0, rows, c, vec, tg, chunks, rpc, part.data_ptr(),
            out.data_ptr() + 4 * c, out.data_ptr(), dx.data_ptr(),
            bn._stream(x.get_device()))
        if err:
            raise RuntimeError(f"two-launch backward: cudaError {err}")
        return dx, out[1], out[0]

    return stats, backward


def calls_of(text: str, lib):
    """The (stats, backward) pair of a copy, by its C entries."""
    return current_calls(lib) if "bn_reduce_kernel" in text \
        else legacy_calls(lib)


def case(hw: int, c: int, dtype=torch.bfloat16, seed: int = 0):
    """``(x4, x, dy, gamma, beta)`` at batch 256, x NHWC and as ``[rows,
    C]``, from a seed (x ~ 2 N(0, 1) + 0.5, as phase 11b)."""
    g = torch.Generator(device="cuda").manual_seed(seed + hw * c)
    x4 = (torch.randn(BATCH, hw, hw, c, generator=g, device="cuda") * 2
          + 0.5).to(dtype)
    x = x4.reshape(-1, c)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
    gamma = torch.rand(c, generator=g, device="cuda") + 0.5
    beta = torch.randn(c, generator=g, device="cuda")
    return x4, x, dy, gamma, beta


def bounds(x) -> tuple:
    """(statistics, backward) bound ms: every input read and output written
    once (x and f32 mean, var; x, g, four f32 vectors, dx, dgamma, dbeta),
    or their f32 operations (3 and 14 an element) at 67 TFLOP/s, the
    larger."""
    n, c = x.numel() * x.element_size(), x.shape[1] * 4
    return tuple(max(nbytes / HBM_BYTES_PER_S, ops * x.numel() / F32_FLOPS)
                 * 1e3 for nbytes, ops in ((n + 2 * c, 3), (3 * n + 6 * c, 14)))


def event_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_calls(x4, x, dy, gamma, beta):
    """``(torch.var_mean, the backward of F.batch_norm)`` on the same
    values, the latter on cuDNN's NHWC kernels through a channels-last
    view; never called by the port."""
    lib_in = x4.permute(0, 3, 1, 2).detach().clone(
        memory_format=torch.channels_last).requires_grad_(True)
    lib_g = gamma.clone().requires_grad_(True)
    lib_b = beta.clone().requires_grad_(True)
    out = F.batch_norm(lib_in, None, None, lib_g, lib_b, True, 0.0, 1e-5)
    lib_dy = dy.reshape(x4.shape).permute(0, 3, 1, 2)
    return (lambda: torch.var_mean(x, dim=0, correction=0),
            lambda: torch.autograd.grad(out, (lib_in, lib_g, lib_b), lib_dy,
                                        retain_graph=True))


def time_in_turns(designs: dict, shapes=SHAPES, rounds: int = 2,
                  tag: str = "times") -> dict:
    """Each design's (stats, backward) at each shape, in turns: CUDA-event
    ms per call back to back (two rounds) and the profiler's device ms per
    call (every kernel a call runs); returns {(hw, c): {name: ([stats ms],
    [backward ms])}} and prints a line per shape and kernel with the
    bounds and the library's times."""
    out = {}
    for hw, c in shapes:
        x4, x, dy, gamma, beta = case(hw, c)
        m, v = bn.bn_stats_reference(x, (0,))
        times = {name: ([], []) for name in designs}
        dev = {name: [] for name in designs}
        for _ in range(rounds):
            for name, (stats, bwd) in designs.items():
                times[name][0].append(event_ms(lambda: stats(x)))
                times[name][1].append(event_ms(
                    lambda: bwd(x, dy, m, v, gamma, beta)))
        for name, (stats, bwd) in designs.items():
            dev[name] = [device_ms(lambda: stats(x)),
                         device_ms(lambda: bwd(x, dy, m, v, gamma, beta))]
        lib = [event_ms(f) for f in library_calls(x4, x, dy, gamma, beta)]
        b = bounds(x)
        for j, what in enumerate(("statistics", "backward")):
            print(f"[{tag}] {hw}x{hw}x{c} N={BATCH} bf16 {what}: " + "; ".join(
                f"{name} {' / '.join(f'{t:.4f}' for t in ts[j])} ms "
                f"({b[j] / min(ts[j]):.3f} of bound), device "
                f"{dev[name][j]:.4f}"
                for name, ts in times.items())
                + f"; bound {b[j]:.4f} ms; library {lib[j]:.4f} ms",
                flush=True)
        out[(hw, c)] = times
        del x4, x, dy
    return out


def device_ms(fn, calls: int = 10) -> float:
    """The profiler's device milliseconds per call of ``fn()``, every
    kernel of the call summed (memsets aside); 0 where it sees none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Memset")) / calls / 1e3


def device_kernels(fn) -> list:
    """The device kernels one call of ``fn`` runs (torch.profiler), by
    name; empty where the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith("Memset")]


def run_times() -> None:
    designs = {"one launch": (bn.bn_stats_kernel,
                              lambda *a: bn.bn_backward_kernel(*a)),
               "two launches": legacy_calls(build(
                   {"two launches": read(TWO_LAUNCH)})["two launches"])}
    time_in_turns(designs)
    _, x, dy, gamma, beta = case(56, 256)
    m, v = bn.bn_stats_kernel(x)
    for what, fn in (("statistics", lambda: bn.bn_stats_kernel(x)),
                     ("backward", lambda: bn.bn_backward_kernel(
                         x, dy, m, v, gamma, beta))):
        names = device_kernels(fn)
        print(f"[times] profiled {what} call at 56x56x256: {len(names)} "
              f"device kernel(s) {sorted(set(n[:60] for n in names))}; "
              f"plan (grid, stages, shared bytes, blocks per SM) "
              f"{bn.last_launch()}", flush=True)


def run_compare(paths: str) -> None:
    """This source against other copies of it (paths joined by commas),
    built alike and timed in turns."""
    texts = {p: read(p) for p in paths.split(",")}
    libs = build(texts)
    designs = {"source as it is": (bn.bn_stats_kernel,
                                   lambda *a: bn.bn_backward_kernel(*a))}
    designs.update((p, calls_of(texts[p], libs[p])) for p in texts)
    time_in_turns(designs)


def _prof(i: int, indent: str) -> str:
    return (f"{indent}if (threadIdx.x == 0) {{ const long long now = "
            f"clock64(); prof[{i}] += now - last; last = now; }}\n")


_FLUSH = ("{ind}if (threadIdx.x == 0) {{\n"
          "{ind}  for (int p = 0; p < 8; ++p) atomicAdd(&g_prof[BWD][p], "
          "(unsigned long long)prof[p]);\n"
          "{ind}  atomicAdd(&g_prof[BWD][8], 1ull);\n{ind}}}\n")

#: the split's edits of the source: (anchor, replacement), each anchor
#: found once
SPLIT = [
    ("namespace {\n\nconstexpr int kThreads",
     "namespace {\n__device__ unsigned long long g_prof[2][10];\n\n"
     "constexpr int kThreads"),
    ("  unsigned phase = 0;  // one parity bit a stage",
     "  long long prof[8] = {}, last = clock64();\n"
     "  unsigned phase = 0;  // one parity bit a stage"),
    ("          mbar_wait(bars + 8 * s, (phase >> s) & 1u);\n"
     "          phase ^= 1u << s;\n          xs =",
     _prof(1, "          ")
     + "          mbar_wait(bars + 8 * s, (phase >> s) & 1u);\n"
     + _prof(0, "          ") + "          phase ^= 1u << s;\n          xs ="),
    ("      fold<V>(a, red, ct, rq, gi, l, act, s1, s2);\n",
     _prof(1, "      ") + "      fold<V>(a, red, ct, rq, gi, l, act, s1, s2);\n"
     + _prof(2, "      ")),
    ("  grid_barrier(a.bar);\n  {\n",
     "  grid_barrier(a.bar);\n" + _prof(3, "  ") + "  {\n"),
    ("  if constexpr (!BWD) return;\n",
     _prof(4, "  ") + "  if constexpr (!BWD) {\n"
     + _FLUSH.format(ind="    ") + "    return;\n  }\n"),
    ("  // ---- pass B (c): dx, the tiles in the reverse order of pass A\n"
     "  grid_barrier(a.bar);\n",
     "  grid_barrier(a.bar);\n" + _prof(5, "  ")),
    ("          mbar_wait(bars + 8 * s, (phase >> s) & 1u);\n"
     "          phase ^= 1u << s;\n        }\n        xs =",
     _prof(7, "          ")
     + "          mbar_wait(bars + 8 * s, (phase >> s) & 1u);\n"
     + _prof(6, "          ") + "          phase ^= 1u << s;\n        }\n"
     "        xs ="),
    ("  // every tile of pass B written\n",
     _prof(7, "  ") + _FLUSH.format(ind="  ")),
    ('extern "C" {\n',
     'extern "C" {\nvoid dl4j_probe_read(unsigned long long* out, int bwd) {\n'
     "  cudaDeviceSynchronize();\n"
     "  unsigned long long all[2][10];\n"
     "  cudaMemcpyFromSymbol(all, g_prof, sizeof all);\n"
     "  for (int i = 0; i < 10; ++i) out[i] = all[bwd][i];\n"
     "  const unsigned long long z[2][10] = {};\n"
     "  cudaMemcpyToSymbol(g_prof, z, sizeof z);\n}\n"),
]


def edited(subs) -> str:
    """The source with the substitutions ``subs``, each of which must find
    its anchor exactly once."""
    text = read(native._source("batch_norm"))
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor found {text.count(old)} times: "
                               f"{old!r}")
        text = text.replace(old, new)
    return text


def run_split() -> None:
    lib = build({"split": edited(SPLIT)})["split"]
    lib.dl4j_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    stats, bwd = current_calls(lib)
    out = (ctypes.c_ulonglong * 10)()
    for hw, c in SHAPES:
        _, x, dy, gamma, beta = case(hw, c)
        m, v = bn.bn_stats_kernel(x)
        for what, n, fn in (("statistics", 5, lambda: stats(x)),
                            ("backward", 8, lambda: bwd(x, dy, m, v, gamma,
                                                        beta))):
            fn()                               # warm-up; counts discarded
            lib.dl4j_probe_read(ctypes.addressof(out), int(n == 8))
            fn()
            lib.dl4j_probe_read(ctypes.addressof(out), int(n == 8))
            blocks = max(int(out[8]), 1)
            per = [out[i] / blocks for i in range(n)]
            total = sum(per)
            print(f"[split] {hw}x{hw}x{c} {what} (plan {bn.last_launch()}): "
                  f"{total:.0f} cycles a block ({blocks} blocks) = "
                  + ", ".join(f"{p_} {p:.0f} ({p / total:.2f})"
                              for p_, p in zip(PHASES, per)), flush=True)
        del x, dy


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn()``: the card synchronized before
    and after, never inside (what the host spends to enqueue a call)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def run_host() -> None:
    """The wrappers' host cost per call at [4096, 64] bf16 (a few us of
    device time, so the card never holds the host back), three rounds;
    where the source has the one-launch entries, also the C entries alone
    (arguments prepared once)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(4096, 64, generator=g, device="cuda").bfloat16()
    dy = torch.randn(4096, 64, generator=g, device="cuda").bfloat16()
    gamma, beta = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    m, v = bn.bn_stats_kernel(x)
    entry = getattr(bn, "_reduce_args", None)
    for r in range(3):
        s = host_us(lambda: bn.bn_stats_kernel(x))
        b = host_us(lambda: bn.bn_backward_kernel(x, dy, m, v, gamma, beta))
        line = (f"[host] round {r}: bn_stats_kernel {s:.2f} us a call, "
                f"bn_backward_kernel {b:.2f} us a call")
        if entry is not None:
            lib = bn._lib()
            rows, c = x.shape
            dev = x.get_device()
            plan, ints, bar, part, stream = entry(x, x.data_ptr(), dev)
            out = torch.empty(2, c, device="cuda")
            args = (bn.DTYPES[x.dtype], x.data_ptr(), rows, c, plan.vec,
                    ints, part, bar, out.data_ptr(), out.data_ptr() + 4 * c,
                    None, dev, stream)
            e = host_us(lambda: lib.dl4j_bn_stats(*args))
            line += f"; the statistics' C entry alone {e:.2f} us a call"
        print(line, flush=True)


#: copies of the source with one change, timed in turns with it (mode
#: variants): (anchor, replacement) edits, each anchor found once
VARIANTS = {
    "regular launch": [
        ("  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kBlock), "
         "args, smem, st);\n",
         "  err = cudaLaunchKernel(fn, dim3(grid), dim3(kBlock), args, smem, "
         "st);\n")],
    # dx (and the apply's y) stored with the evict-first hint
    "streaming stores": [
        ("    *reinterpret_cast<uint4*>(p) = u;\n",
         "    __stcs(reinterpret_cast<uint4*>(p), u);\n")],
    # what pass B's division costs (wrong dx; timing only)
    "no division in dx": [
        ("__fdiv_rn(__fadd_rn(w.s1[e], __fmul_rn(xhat, w.s2[e])), count)",
         "__fmul_rn(__fadd_rn(w.s1[e], __fmul_rn(xhat, w.s2[e])), count)")],
}


def run_variants() -> None:
    libs = build({name: edited(subs) for name, subs in VARIANTS.items()})
    designs = {"source as it is": (bn.bn_stats_kernel,
                                   lambda *a: bn.bn_backward_kernel(*a))}
    designs.update((name, current_calls(lib)) for name, lib in libs.items())
    time_in_turns(designs, tag="variants")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(4096, 64, generator=g, device="cuda").bfloat16()
    for name, (stats, _) in designs.items():
        print(f"[variants] host {name}: bn_stats_kernel "
              f"{host_us(lambda: stats(x)):.2f} us a call at [4096, 64]",
              flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bn_probe: no CUDA device")
        return 1
    modes = argv or ["times", "split", "host"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    native.build(["batch_norm"])
    lines = str(native.build_logs.get("batch_norm", {}).get("output", "")) \
        .splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "reduce_kernel" in ln:
            info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            name = re.sub(r"^.*?'(_Z\w+)'.*$", r"\1", ln)
            print(f"ptxas {name[:90]}: {'; '.join(info)}", flush=True)
    for mode in modes:
        if mode.startswith("compare="):
            run_compare(mode.split("=", 1)[1])
        else:
            {"times": run_times, "split": run_split, "host": run_host,
             "variants": run_variants}[mode]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
