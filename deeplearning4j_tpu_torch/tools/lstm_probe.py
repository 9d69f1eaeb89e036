"""Measurements of the LSTM cluster routes, forward and backward
(``csrc/lstm_recurrence.cu``, namespace ``cl``) on the card, beyond the
times ``chip_smoke.py`` takes.

Run from the repository root on a machine with one CUDA card::

    python -m deeplearning4j_tpu_torch.tools.lstm_probe [split] [variants] [wide] [compare=PATH,...]

With no argument it runs split and variants, at the char-LSTM training
shape (T=200, H=256, bf16) with N=256 (32-row clusters) and N=240 (16-row
clusters):

- split: a copy of the source with ``clock64`` counters on thread 0 of
  every block of both cluster kernels; a step's mean cycles in each phase
  of the loop. Forward: the gate product, the cell update, the block
  barrier before the copies, the work before the wait (issuing the copies
  of h_t to the cluster, the ys and cs stores and the x_proj copy two
  steps ahead), the wait for the peers' h, the closing wait for x_proj and
  block barrier. Backward:
  the cell update, the wait for the h tile and the block barrier, the
  partial dh product, the arrive, the work between the arrive and the wait
  (da's stores, the next gates and loads), the cluster wait, the DSMEM
  reads, the closing block barrier;
- variants: copies with one cost taken away (which makes them wrong),
  timed beside the source in turns (CUDA events), forward and backward,
  to see what the step waits for;
- compare=PATH[,PATH...]: other copies of ``lstm_recurrence.cu`` with the
  same C entries (earlier designs of the same tree), timed in turns with
  the source, forward and backward;
- wide: the wide route (namespace ``wd``) at T=200, N=256, H=1024 and 512,
  bf16: a step's mean cycles by phase on thread 0 of every block (the
  copies due and the chunk wait, the gate product, the block barrier, the
  slot's release and the copies issued ahead, the cell update and block
  barrier, the grid barrier(s), and in the backward the dh pieces), then
  copies with one
  cost taken away, timed in turns with the source.

Every copy but compare's is the source with text substitutions, each of
which must find its anchor or the run fails; all are built under the
git-ignored ``_build/probe/``.
Nothing here changes what the port computes.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import sys

import torch

from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr
from deeplearning4j_tpu_torch.ops import native

PHASES = ("cell update", "h tile + block barrier", "partial product",
          "arrive", "da stores + next gates + loads", "cluster wait",
          "DSMEM reads", "block barrier")
FWD_PHASES = ("gate product", "cell update", "block barrier",
              "copies issued + ys/cs stores + x_proj copy",
              "wait for the peers' h", "x_proj wait + block barrier")


def _prof(i: int, indent: str = "    ") -> str:
    return (f"{indent}if (threadIdx.x == 0) {{ const long long now = "
            f"clock64(); prof[{i}] += now - last; last = now; }}\n")


def _flush(symbol: str, n: int) -> str:
    return ("  if (threadIdx.x == 0) {\n"
            f"    for (int i = 0; i < {n}; ++i) atomicAdd(&{symbol}[i], "
            "(unsigned long long)prof[i]);\n"
            f"    atomicAdd(&{symbol}[8], 1ull);\n"
            f"    atomicAdd(&{symbol}[9], (unsigned long long)steps);\n  }}\n")


SPLIT = [
    ("namespace cl {\n",
     "namespace cl {\n__device__ unsigned long long g_prof[10];\n"
     "__device__ unsigned long long g_fprof[10];\n"),
    ("  const unsigned part_u32 = smem_u32(part);\n",
     "  const unsigned part_u32 = smem_u32(part);\n"
     "  long long prof[8] = {}, last = clock64();\n"),
    ("    cp_wait_all();  // the h tile of the next gate product\n"
     "    __syncthreads();\n",
     _prof(0) + "    cp_wait_all();\n    __syncthreads();\n" + _prof(1)),
    ("    cluster_arrive();\n\n    // 3. off the chain",
     _prof(2) + "    cluster_arrive();\n" + _prof(3) + "\n    // 3."),
    ("    cluster_wait();\n\n    // 4. dh_{t-1}",
     _prof(4) + "    cluster_wait();\n" + _prof(5) + "\n    // 4."),
    ("    __syncthreads();  // the gates of step t-1 before its cell update\n",
     _prof(6) + "    __syncthreads();\n" + _prof(7)),
    ("  // no block leaves while a peer may still read its partials\n",
     _flush("g_prof", 8)
     + "  // no block leaves while a peer may still read its partials\n"),
    # the forward
    ("  const int sr = sq / 4, sk = 8 * (sq % 4);\n",
     "  const int sr = sq / 4, sk = 8 * (sq % 4);\n"
     "  long long prof[8] = {}, last = clock64();\n"),
    ("    // 2. the cell update in f32 registers; h_t (bf16) into slot t & 1, "
     "c_t\n",
     _prof(0) + "    // 2. the cell update in f32 registers; h_t (bf16) into "
                "slot t & 1, c_t\n"),
    ("    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
     "    __syncthreads();\n",
     _prof(1) + "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
                "\"memory\");\n    __syncthreads();\n" + _prof(2)),
    ("    // 4. the next A tile: every block's copy landed\n",
     _prof(3) + "    // 4. the next A tile: every block's copy landed\n"),
    ("      mbar_wait(mbar_u32 + 8 * (buf ^ 1), (unsigned)(t >> 1) & 1u);\n",
     "      mbar_wait(mbar_u32 + 8 * (buf ^ 1), (unsigned)(t >> 1) & 1u);\n"
     + _prof(4, "      ")),
    ("      cp_wait<1>();  // x_proj[t+1]\n      __syncthreads();\n",
     "      cp_wait<1>();\n      __syncthreads();\n" + _prof(5, "      ")),
    ("  // no block leaves while a peer's copy from it may still be in "
     "flight\n",
     _flush("g_fprof", 6)
     + "  // no block leaves while a peer's copy from it may still be in "
       "flight\n"),
    ('extern "C" {\n',
     'extern "C" {\nvoid dl4j_probe_read(unsigned long long* out, int fwd) {\n'
     '  cudaDeviceSynchronize();\n'
     '  if (fwd) cudaMemcpyFromSymbol(out, cl::g_fprof, 10 * sizeof(long long));\n'
     '  else cudaMemcpyFromSymbol(out, cl::g_prof, 10 * sizeof(long long));\n'
     '  const unsigned long long z[10] = {};\n'
     '  cudaMemcpyToSymbol(cl::g_prof, z, sizeof z);\n'
     '  cudaMemcpyToSymbol(cl::g_fprof, z, sizeof z);\n}\n'),
]

VARIANTS = {
    "no da stores": [
        ("        a.da[ox + q * H] = da[p][q];\n"
         "        dxp[ox + q * H] = __float2bfloat16_rn(da[p][q]);\n", "")],
    "no next-step loads": [
        ("      load_inputs(t - 1);\n", "")],
    "cluster of 16 rows at N=256 (two waves)": [
        ("  if (one >= 1 && (tiles <= one || two < 1))",
         "  if (one >= 1)")],
    "no gate product": [
        ("      gate_product(t - 1);\n", "")],
    "no DSMEM reads": [
        ("          v[q][p] = ld_cluster(map_rank(slot + (unsigned)((r0 + 8 * p)"
         " * PP + unit) * 4u, q));\n",
         "          v[q][p] = part[(t & 1) * R * PP + (r0 + 8 * p) * PP + unit];\n")],
    "no partial product": [
        ("              mma(acc[kk % KS][m][j], af[s], wb[j][kk][0], "
         "wb[j][kk][1]);\n", "              ;\n")],
    "no ys/cs stores (forward)": [
        ("    if (stores) {\n", "    if (false) {\n")],
    "fast exp/tanh": [
        ("__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / "
         "(1.0f + expf(-x)); }",
         "__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / "
         "(1.0f + __expf(-x)); }")],
}


def read(path: str) -> str:
    with open(path) as f:
        return f.read()


def edited(subs) -> str:
    """The source with the substitutions ``subs``, each of which must find
    its anchor."""
    text = read(native._source("lstm_recurrence"))
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"anchor not found: {old!r}")
        text = text.replace(old, new)
    return text


def build(copies: dict) -> dict:
    """Build each copy of the source (name -> its text; one nvcc each, all
    at once); returns name -> loaded library."""
    out = os.path.join(native.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, text in copies.items():
        # named by content: a process loads each path once (dlopen)
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        cu = os.path.join(out, f"lstm-{digest}.cu")
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
    ref = lr._lib()
    for fn in ("dl4j_lstm_fwd", "dl4j_lstm_bwd", "dl4j_cuda_error_string"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    saved = lr._lib
    lr._lib = lambda: lib
    try:
        yield
    finally:
        lr._lib = saved


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def inputs(n: int, t: int = 200, h: int = 256, seed: int = 1):
    """A bf16 backward call's arguments at (T, N, H), through the forward
    kernel for ys and cs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = (0.5 * torch.randn(t, n, 4 * h, generator=g, device="cuda")).to(bf)
    w = (torch.randn(h, 4 * h, generator=g, device="cuda") / h ** 0.5).to(bf)
    h0, c0 = ((0.5 * torch.randn(n, h, generator=g, device="cuda")).to(bf)
              for _ in range(2))
    dys = torch.randn(t, n, h, generator=g, device="cuda").to(bf)
    ys, _, _, cs = lr.lstm_recurrence_fwd(x, w, h0, c0, collect_cell=True)
    return x, w, h0, c0, ys, cs, dys


def run_split() -> None:
    lib = build({"split": edited(SPLIT)})["split"]
    lib.dl4j_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_ulonglong * 10)()
    for n in (256, 240):
        args = inputs(n)
        for what, phases, call in (
                ("forward", FWD_PHASES, lambda: lr.lstm_recurrence_fwd(
                    *args[:4], collect_cell=True, route="cluster")),
                ("backward", PHASES, lambda: lr.lstm_recurrence_bwd(
                    *args, route="cluster"))):
            fwd = int(what == "forward")
            with using(lib):
                call()                       # warm-up; counts discarded
                lib.dl4j_probe_read(ctypes.addressof(out), fwd)
                call()
                lib.dl4j_probe_read(ctypes.addressof(out), fwd)
            steps = max(int(out[9]), 1)
            per = [out[i] / steps for i in range(len(phases))]
            total = sum(per)
            print(f"[split] {what} N={n} (plan {lr.last_plan}): {total:.0f} "
                  f"cycles per step ({int(out[8])} blocks) = " + ", ".join(
                      f"{name} {p:.0f} ({p / total:.2f})"
                      for name, p in zip(phases, per)), flush=True)


def time_in_turns(tag: str, libs: dict) -> None:
    """Each library's forward and backward on the cluster routes at N=256
    and 240, in turns (two rounds), CUDA events."""
    for n in (256, 240):
        args = inputs(n)
        for what, call in (
                ("forward", lambda: lr.lstm_recurrence_fwd(
                    *args[:4], collect_cell=True, route="cluster")),
                ("backward", lambda: lr.lstm_recurrence_bwd(
                    *args, route="cluster"))):
            times = {name: [] for name in libs}
            for _ in range(2):
                for name, lib in libs.items():
                    with using(lib):
                        times[name].append(cuda_ms(call))
            for name, ts in times.items():
                print(f"[{tag}] {what} N={n} {name}: "
                      f"{' / '.join(f'{t:.4f}' for t in ts)} ms per call",
                      flush=True)


def run_variants() -> None:
    libs = {"source as it is": native.load("lstm_recurrence")}
    libs.update(build({name: edited(subs)
                       for name, subs in VARIANTS.items()}))
    time_in_turns("variants", libs)


def run_compare(paths: str) -> None:
    """This source against other copies of it with the same C entries
    (earlier designs; paths joined by commas), built alike and timed in
    turns."""
    libs = {"source as it is": native.load("lstm_recurrence")}
    libs.update(build({p: read(p) for p in paths.split(",")}))
    time_in_turns("compare", libs)


WIDE_FWD_PHASES = ("copies due + chunk wait", "gate product", "block barrier",
                   "release + copies ahead", "cell update + block barrier",
                   "grid barrier + first copies")
WIDE_BWD_PHASES = ("copies due + chunk wait", "gate product", "block barrier",
                   "release + copies ahead", "cell update + block barrier",
                   "grid barrier (da)", "dh pieces",
                   "grid barrier (dh)")

# the same anchors in both wide kernels (each substitution edits both)
WIDE_SPLIT = [
    ("namespace wd {\n",
     "namespace wd {\n__device__ unsigned long long g_wprof[10];\n"),
    ("  if (warp == 0) pump(r, issued, 0, ",
     "  long long prof[8] = {}, last = clock64();\n"
     "  if (warp == 0) pump(r, issued, 0, "),
    ("      mbar_wait(r.full + 8u * s, (unsigned)(i / r.S) & 1u);\n",
     "      mbar_wait(r.full + 8u * s, (unsigned)(i / r.S) & 1u);\n"
     + _prof(0, "      ")),
    ("                    lane);\n      __syncthreads();\n",
     "                    lane);\n" + _prof(1, "      ")
     + "      __syncthreads();\n" + _prof(2, "      ")),
    ("        pump(r, issued, i + 1, ready, -1, chunk);\n      }\n",
     "        pump(r, issued, i + 1, ready, -1, chunk);\n      }\n"
     + _prof(3, "      ")),
    ("        pump(r, issued, i + 1, total, -1, chunk);\n      }\n",
     "        pump(r, issued, i + 1, total, -1, chunk);\n      }\n"
     + _prof(3, "      ")),
    ("      __syncthreads();  // the partials are rewritten by the next "
     "chunk\n",
     "      __syncthreads();\n" + _prof(4, "      ")),
    ("        ready = (t + 2) * nrt;\n        pump(r, issued, i, ready, "
     "-1, chunk);\n      }\n",
     "        ready = (t + 2) * nrt;\n        pump(r, issued, i, ready, "
     "-1, chunk);\n      }\n" + _prof(5, "      ")),
    ("    grid_barrier(a.bar);  // da_t complete\n",
     "    grid_barrier(a.bar);\n" + _prof(5)),
    ("    grid_barrier(a.bar);  // the partials of dh_{t-1} complete\n",
     _prof(6) + "    grid_barrier(a.bar);\n" + _prof(7)),
    ("  // no block leaves while a peer may still arrive on its barriers\n",
     _flush("g_wprof", 6)
     + "  // no block leaves while a peer may still arrive on its barriers\n"),
    ("    static_cast<bf16*>(a.dc0)[o] = __float2bfloat16_rn(st_dc[o]);\n"
     "  }\n",
     "    static_cast<bf16*>(a.dc0)[o] = __float2bfloat16_rn(st_dc[o]);\n"
     "  }\n" + _flush("g_wprof", 8)),
    ('extern "C" {\n',
     'extern "C" {\nvoid dl4j_probe_wide_read(unsigned long long* out) {\n'
     '  cudaDeviceSynchronize();\n'
     '  cudaMemcpyFromSymbol(out, wd::g_wprof, 10 * sizeof(long long));\n'
     '  const unsigned long long z[10] = {};\n'
     '  cudaMemcpyToSymbol(wd::g_wprof, z, sizeof z);\n}\n'),
]

WIDE_VARIANTS = {
    "no grid barrier": [("grid_barrier(a.bar);", ";")],
    "clusters of 1 (no multicast)": [("  for (int C : {4, 2, 1}) {\n",
                                      "  for (int C : {1}) {\n")],
    "one bulk copy per chunk": [
        ("  const unsigned bytes = 2u * r.H, pitch = 2u * (r.H + 8);\n",
         "  const unsigned bytes = 2u * r.H * rows, pitch = 0u;\n"),
        ("  for (int i = threadIdx.x & 31; i < rows; i += 32) {\n",
         "  for (int i = threadIdx.x & 31; i < 1; i += 32) {\n")],
    "no cell update": [("      if (cell && row < N) {\n",
                        "      if (false) {\n"),
                       ("      if (mine) {\n", "      if (false) {\n")],
    "no wait for the slot's release": [
        ("      if (issued > must && !__shfl_sync(0xffffffffu, mbar_done(bar, "
         "parity), 0)) break;\n      mbar_wait(bar, parity);\n", "")],
    "no dh pieces (backward)": [("    if (dblock) {\n",
                                 "    if (false) {\n")],
}


def run_wide() -> None:
    """The wide route's split and variants at H=1024 and 512."""
    split = build({"split": edited(WIDE_SPLIT)})["split"]
    split.dl4j_probe_wide_read.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * 10)()
    cases = {h: inputs(256, h=h) for h in (1024, 512)}
    for h, args in cases.items():
        for what, phases, call in (
                ("forward", WIDE_FWD_PHASES, lambda: lr.lstm_recurrence_fwd(
                    *args[:4], collect_cell=True, route="wide")),
                ("backward", WIDE_BWD_PHASES, lambda: lr.lstm_recurrence_bwd(
                    *args, route="wide"))):
            with using(split):
                call()                       # warm-up; counts discarded
                split.dl4j_probe_wide_read(ctypes.addressof(out))
                call()
                split.dl4j_probe_wide_read(ctypes.addressof(out))
            steps = max(int(out[9]), 1)
            per = [out[i] / steps for i in range(len(phases))]
            total = sum(per)
            print(f"[wide split] {what} H={h} (plan {lr.last_plan}): "
                  f"{total:.0f} cycles per step ({int(out[8])} blocks) = "
                  + ", ".join(f"{name} {p:.0f} ({p / total:.2f})"
                              for name, p in zip(phases, per)), flush=True)
    libs = {"source as it is": native.load("lstm_recurrence")}
    libs.update(build({name: edited(subs)
                       for name, subs in WIDE_VARIANTS.items()}))
    for h, args in cases.items():
        for what, call in (
                ("forward", lambda: lr.lstm_recurrence_fwd(
                    *args[:4], collect_cell=True, route="wide")),
                ("backward", lambda: lr.lstm_recurrence_bwd(
                    *args, route="wide"))):
            times = {name: [] for name in libs}
            for _ in range(2):
                for name, lib in libs.items():
                    with using(lib):
                        try:
                            times[name].append(f"{cuda_ms(call, 3, 1):.4f}")
                        except RuntimeError as e:   # a copy the launch refuses
                            times[name].append(f"refused ({e})")
            for name, ts in times.items():
                print(f"[wide variants] {what} H={h} {name}: "
                      f"{' / '.join(ts)} ms per call", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("lstm_probe: no CUDA device")
        return 1
    modes = argv or ["split", "variants"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    native.build(["lstm_recurrence"])
    lines = str(native.build_logs.get("lstm_recurrence", {})
                .get("output", "")).splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "cluster_kernel" in ln:
            info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            print(f"ptxas {ln.split()[-1][:60]}: {'; '.join(info)}")
    for mode in modes:
        if mode.startswith("compare="):
            run_compare(mode.split("=", 1)[1])
        else:
            {"split": run_split, "variants": run_variants,
             "wide": run_wide}[mode]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
