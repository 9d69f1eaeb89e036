// Training-mode batch norm (statistics, scale-shift with an optional ReLU, and
// the two-pass backward), written by hand for Hopper (sm_90a) and bound to
// PyTorch through a plain C interface (ctypes).
//
// No Pallas kernel stands behind these: the reference leaves the batch norm to
// XLA, which fuses it. They port the JAX package's formulas in
// deeplearning4j_tpu/ops/nn.py: the shifted one-pass statistics _bn_stats
// (:390-409), the scale-shift of batch_norm_train (:412-428) and of the fused
// _bn_relu_fwd (:449-457), and the two-pass backward _bn_relu_bwd (:460-499),
// which recomputes the ReLU mask from x instead of storing the masked gradient.
// Without them the port's eager formula took 0.79-0.81 of the ResNet-50 step's
// device time on the H100.
//
// What it computes, for x [rows, C] (channels last: every axis but the kept ones
// flattened into rows), f32, bf16 or f16, and f32 per-channel vectors:
// (a) statistics: shift = x[0] (per channel), d = x - shift,
//     mean = shift + sum(d) / rows, var = max(sum(d^2) / rows - (sum(d) / rows)^2, 0);
// (b) apply: scale = rsqrt(var + eps) * gamma, shift = beta - mean * scale (f32),
//     both rounded to x's type; y = x * scale + shift in x's type (the product
//     rounded to x's type before the add, as the plain version's two tensor ops
//     round), then max(y, 0) where relu;
// (c) backward, for the upstream g [rows, C]: xhat = (x - mean) * inv,
//     inv = rsqrt(var + eps), sc = gamma * inv, g' = g where x * sc + sh > 0
//     (sh = beta - mean * gamma * inv; relu only) else 0, or g itself;
//     pass A: s1 = sum(g'), s2 = sum(g' * xhat) per channel (= dbeta, dgamma);
//     pass B: dx = sc * (g' - (s1 + xhat * s2) / rows), plus, for
//     batch_norm_train's returned mean and variance, gm / rows +
//     gv * 2 (x - mean) / rows. g' is never written to memory.
// Every multiply, add and divide outside the sums is an explicitly rounded
// intrinsic (no FMA contraction), in the plain version's order, so (b) equals
// the plain PyTorch version bit for bit and (a), (c) differ from it only by the
// order of their sums.
//
// What bounds it on the H100: bytes. (a) reads x once, (b) reads x and writes y,
// (c) reads x and g twice and writes dx: 2, 4 and 10 bytes per bf16 element; at
// ResNet-50's 2.71 G batch-norm elements a step (batch 256) some 43 GB, 13 ms at
// 3.35 TB/s. The design, simple first:
// - A thread owns one group of V channels (16 bytes: 4 f32 or 8 bf16/f16; V = 1
//   where C or a pointer does not allow 16-byte pieces) and walks rows. A warp
//   spans up to 32 groups of a row (or several rows of a narrow C), so loads are
//   16 bytes a thread on neighbouring addresses. A block of 256 threads holds
//   tg groups x 256 / tg row lanes; the grid is (channel tiles, row chunks),
//   some 512 blocks, from the shape alone (ops/batch_norm.py launch_plan).
// - The sums of (a) and (c) go from registers to one f32 partial per block and
//   channel, summed over the block's lanes in a fixed order; a second small
//   launch sums the partials of each channel with one warp in a fixed order
//   (lane-strided, then a shuffle tree), as the B4 epilogue does
//   (conv_bn_stats.cu). No atomics: two calls are bit-equal, on any card.
// - (b) and pass B are streaming passes over the same grid; their per-channel
//   constants are computed once per thread and held in registers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTg = 32;        // channel groups per block row (one warp wide)
constexpr int kMaxV = 8;          // channels per group (16 bytes of bf16 / f16)
constexpr int kFinalWarps = 8;    // channels per finalize block (a warp each)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T and back (the identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// V elements of T at p (16 bytes where V > 1, one element otherwise) as f32
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "a group is 16 bytes");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(f[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// The launch geometry every kernel of one call shares.
struct Geo {
  long long rows;
  int C;
  int tg;          // channel groups per block row
  long long rpc;   // rows per chunk (blockIdx.y)
};

// This thread's channel group (c0, or -1 past C) and row lane, and its chunk.
struct Slot {
  int c0, lane, lanes;
  long long r0, r1;
};

template <int V>
__device__ __forceinline__ Slot slot(const Geo& g) {
  Slot s;
  s.lanes = kThreads / g.tg;
  const int gi = threadIdx.x % g.tg;
  s.lane = threadIdx.x / g.tg;
  s.c0 = (blockIdx.x * g.tg + gi) * V;
  if (s.lane >= s.lanes || s.c0 >= g.C) s.c0 = -1;
  s.r0 = (long long)blockIdx.y * g.rpc + s.lane;
  s.r1 = min(g.rows, (long long)(blockIdx.y + 1) * g.rpc);
  return s;
}

// The block's per-lane sums a[V], b[V] summed over its lanes in lane order,
// written as this chunk's partials part[0][chunk][c] and part[1][chunk][c].
template <int V>
__device__ __forceinline__ void block_partials(const Geo& g, const Slot& s, const float (&a)[V],
                                               const float (&b)[V], float* __restrict__ part) {
  __shared__ float red[2][kThreads * kMaxV];
  const int gi = threadIdx.x % g.tg;
  if (s.lane < s.lanes) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[0][threadIdx.x * V + i] = a[i];
      red[1][threadIdx.x * V + i] = b[i];
    }
  }
  __syncthreads();
  if (s.lane == 0 && s.c0 >= 0) {
    const size_t plane = (size_t)gridDim.y * g.C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float x = 0.f, y = 0.f;
      for (int l = 0; l < s.lanes; ++l) {
        x += red[0][(l * g.tg + gi) * V + i];
        y += red[1][(l * g.tg + gi) * V + i];
      }
      part[(size_t)blockIdx.y * g.C + s.c0 + i] = x;
      part[plane + (size_t)blockIdx.y * g.C + s.c0 + i] = y;
    }
  }
}

// --------------------------------------------------------------- (a) statistics
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_partial_kernel(const T* __restrict__ x, Geo g, float* __restrict__ part) {
  const Slot s = slot<V>(g);
  float s1[V] = {}, s2[V] = {};
  if (s.c0 >= 0) {
    float sh[V];
    load_v<T, V>(x + s.c0, sh);
#pragma unroll 4
    for (long long r = s.r0; r < s.r1; r += s.lanes) {
      float f[V];
      load_v<T, V>(x + r * g.C + s.c0, f);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = f[i] - sh[i];
        s1[i] += d;
        s2[i] = fmaf(d, d, s2[i]);
      }
    }
  }
  block_partials<V>(g, s, s1, s2, part);
}

// One warp per channel sums its `chunks` partials of both planes in a fixed
// order. STATS: out0 = mean, out1 = var from the sums of d and d^2 and the
// shift x[0, c]; else out0 = s1 (dbeta), out1 = s2 (dgamma).
template <typename T, bool STATS>
__global__ void __launch_bounds__(kFinalWarps * 32)
    bn_finalize_kernel(const float* __restrict__ part, int chunks, int C, float count,
                       const T* __restrict__ x, float* __restrict__ out0,
                       float* __restrict__ out1) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kFinalWarps + (threadIdx.x >> 5);
  if (c >= C) return;
  const size_t plane = (size_t)chunks * C;
  float a = 0.f, b = 0.f;
  for (int k = lane; k < chunks; k += 32) {
    a += part[(size_t)k * C + c];
    b += part[plane + (size_t)k * C + c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (lane != 0) return;
  if constexpr (STATS) {
    const float md = __fdiv_rn(a, count);
    const float v = __fsub_rn(__fdiv_rn(b, count), __fmul_rn(md, md));
    out0[c] = __fadd_rn(to_f(x[c]), md);
    out1[c] = v > 0.f ? v : 0.f;
  } else {
    out0[c] = a;
    out1[c] = b;
  }
}

// ---------------------------------------------------------------- (b) apply
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ var, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float eps, Geo g, T* __restrict__ y) {
  const Slot s = slot<V>(g);
  if (s.c0 < 0) return;
  float sc[V], sh[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = s.c0 + i;
    const float scale = __fmul_rn(rsqrtf(__fadd_rn(var[c], eps)), gamma[c]);
    sh[i] = round_to<T>(__fsub_rn(beta[c], __fmul_rn(mean[c], scale)));
    sc[i] = round_to<T>(scale);
  }
#pragma unroll 4
  for (long long r = s.r0; r < s.r1; r += s.lanes) {
    float f[V];
    load_v<T, V>(x + r * g.C + s.c0, f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(f[i], sc[i])), sh[i]));
      f[i] = (RELU && v < 0.f) ? 0.f : v;
    }
    store_v<T, V>(y + r * g.C + s.c0, f);
  }
}

// ------------------------------------------------------------- (c) backward
// Per-channel constants of the backward, in _bn_relu_bwd's order.
struct BwdConst {
  float m, inv, sc, sh;
};

__device__ __forceinline__ BwdConst bwd_const(const float* __restrict__ mean,
                                              const float* __restrict__ var,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, float eps, int c) {
  BwdConst k;
  k.m = mean[c];
  k.inv = rsqrtf(__fadd_rn(var[c], eps));
  k.sc = __fmul_rn(gamma[c], k.inv);
  k.sh = __fsub_rn(beta[c], __fmul_rn(__fmul_rn(k.m, gamma[c]), k.inv));
  return k;
}

// g, or 0 where the recomputed ReLU is off (relu only)
template <bool RELU>
__device__ __forceinline__ float masked(float xf, float gf, const BwdConst& k) {
  if constexpr (RELU) return __fadd_rn(__fmul_rn(xf, k.sc), k.sh) > 0.f ? gf : 0.f;
  return gf;
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          const float* __restrict__ mean, const float* __restrict__ var,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          float eps, Geo g, float* __restrict__ part) {
  const Slot s = slot<V>(g);
  float s1[V] = {}, s2[V] = {};
  if (s.c0 >= 0) {
    BwdConst k[V];
#pragma unroll
    for (int i = 0; i < V; ++i) k[i] = bwd_const(mean, var, gamma, beta, eps, s.c0 + i);
#pragma unroll 4
    for (long long r = s.r0; r < s.r1; r += s.lanes) {
      float f[V], d[V];
      load_v<T, V>(x + r * g.C + s.c0, f);
      load_v<T, V>(gy + r * g.C + s.c0, d);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float gp = masked<RELU>(f[i], d[i], k[i]);
        const float xhat = __fmul_rn(__fsub_rn(f[i], k[i].m), k[i].inv);
        s1[i] += gp;
        s2[i] = fmaf(gp, xhat, s2[i]);
      }
    }
  }
  block_partials<V>(g, s, s1, s2, part);
}

template <typename T, int V, bool RELU, bool EXTRA>
__global__ void __launch_bounds__(kThreads)
    bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                 const float* __restrict__ mean, const float* __restrict__ var,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const float* __restrict__ s1, const float* __restrict__ s2,
                 const float* __restrict__ gm, const float* __restrict__ gv, float eps,
                 float count, Geo g, T* __restrict__ dx) {
  const Slot s = slot<V>(g);
  if (s.c0 < 0) return;
  BwdConst k[V];
  float a[V], b[V], em[V], ev[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = s.c0 + i;
    k[i] = bwd_const(mean, var, gamma, beta, eps, c);
    a[i] = s1[c];
    b[i] = s2[c];
    em[i] = EXTRA ? __fdiv_rn(gm[c], count) : 0.f;
    ev[i] = EXTRA ? __fdiv_rn(__fmul_rn(gv[c], 2.f), count) : 0.f;
  }
#pragma unroll 4
  for (long long r = s.r0; r < s.r1; r += s.lanes) {
    float f[V], d[V];
    load_v<T, V>(x + r * g.C + s.c0, f);
    load_v<T, V>(gy + r * g.C + s.c0, d);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gp = masked<RELU>(f[i], d[i], k[i]);
      const float xhat = __fmul_rn(__fsub_rn(f[i], k[i].m), k[i].inv);
      float v = __fmul_rn(k[i].sc,
                          __fsub_rn(gp, __fdiv_rn(__fadd_rn(a[i], __fmul_rn(xhat, b[i])), count)));
      if (EXTRA) v = __fadd_rn(v, __fadd_rn(em[i], __fmul_rn(ev[i], __fsub_rn(f[i], k[i].m))));
      d[i] = v;
    }
    store_v<T, V>(dx + r * g.C + s.c0, d);
  }
}

// ------------------------------------------------------------------- launch
// dtype: 0 f32, 1 bf16, 2 f16
template <template <typename> class Fn, typename... A>
int by_dtype(int dtype, A... args) {
  switch (dtype) {
    case 0: return Fn<float>::run(args...);
    case 1: return Fn<__nv_bfloat16>::run(args...);
    case 2: return Fn<__half>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(std::initializer_list<const void*> ps) {
  uintptr_t bits = 0;
  for (const void* p : ps) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15) == 0;
}

// The grid and the checks every entry shares: vec asks for 16-byte groups
// (C a multiple of V and every tensor pointer 16-byte aligned), tg groups per
// block row, `chunks` row chunks of rpc rows covering all rows.
template <typename T>
bool bad_geo(const Geo& g, int vec, int chunks, std::initializer_list<const void*> ps) {
  constexpr int V = 16 / sizeof(T);
  if (g.rows < 1 || g.C < 1 || g.tg < 1 || g.tg > kMaxTg || chunks < 1 || chunks > 65535 ||
      g.rpc < 1 || (long long)chunks * g.rpc < g.rows || (long long)(chunks - 1) * g.rpc >= g.rows)
    return true;
  return vec && (g.C % V != 0 || !aligned16(ps));
}

template <typename T>
dim3 grid_of(const Geo& g, int vec, int chunks) {
  const int v = vec ? 16 / (int)sizeof(T) : 1;
  const int groups = (g.C + v - 1) / v;
  return dim3((groups + g.tg - 1) / g.tg, chunks);
}

template <typename T>
int finalize_stats(const float* part, int chunks, const Geo& g, const T* x, float* m, float* v,
                   cudaStream_t st) {
  bn_finalize_kernel<T, true><<<(g.C + kFinalWarps - 1) / kFinalWarps, kFinalWarps * 32, 0, st>>>(
      part, chunks, g.C, (float)g.rows, x, m, v);
  return (int)cudaGetLastError();
}

template <typename T>
struct Stats {
  static int run(const void* x, Geo g, int vec, int chunks, float* part, float* mean, float* var,
                 cudaStream_t st) {
    if (bad_geo<T>(g, vec, chunks, {x})) return (int)cudaErrorInvalidValue;
    const T* px = static_cast<const T*>(x);
    const dim3 grid = grid_of<T>(g, vec, chunks);
    if (vec)
      bn_stats_partial_kernel<T, 16 / sizeof(T)><<<grid, kThreads, 0, st>>>(px, g, part);
    else
      bn_stats_partial_kernel<T, 1><<<grid, kThreads, 0, st>>>(px, g, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return finalize_stats<T>(part, chunks, g, px, mean, var, st);
  }
};

template <typename T>
struct Apply {
  template <int V>
  static void go(dim3 grid, int relu, const T* x, const float* m, const float* v, const float* ga,
                 const float* be, float eps, Geo g, T* y, cudaStream_t st) {
    if (relu)
      bn_apply_kernel<T, V, true><<<grid, kThreads, 0, st>>>(x, m, v, ga, be, eps, g, y);
    else
      bn_apply_kernel<T, V, false><<<grid, kThreads, 0, st>>>(x, m, v, ga, be, eps, g, y);
  }
  static int run(const void* x, const float* m, const float* v, const float* ga, const float* be,
                 float eps, int relu, Geo g, int vec, int chunks, void* y, cudaStream_t st) {
    if (bad_geo<T>(g, vec, chunks, {x, y})) return (int)cudaErrorInvalidValue;
    const dim3 grid = grid_of<T>(g, vec, chunks);
    const T* px = static_cast<const T*>(x);
    T* py = static_cast<T*>(y);
    if (vec)
      go<16 / sizeof(T)>(grid, relu, px, m, v, ga, be, eps, g, py, st);
    else
      go<1>(grid, relu, px, m, v, ga, be, eps, g, py, st);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct Backward {
  template <int V, bool RELU>
  static int go(dim3 grid, int chunks, const T* x, const T* gy, const float* m, const float* v,
                const float* ga, const float* be, const float* gm, const float* gv, float eps,
                Geo g, float* part, float* dgamma, float* dbeta, T* dx, cudaStream_t st) {
    bn_bwd_partial_kernel<T, V, RELU><<<grid, kThreads, 0, st>>>(x, gy, m, v, ga, be, eps, g,
                                                                 part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bn_finalize_kernel<T, false><<<(g.C + kFinalWarps - 1) / kFinalWarps, kFinalWarps * 32, 0,
                                   st>>>(part, chunks, g.C, (float)g.rows, x, dbeta, dgamma);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const float count = (float)g.rows;
    if (gm != nullptr)
      bn_dx_kernel<T, V, RELU, true><<<grid, kThreads, 0, st>>>(x, gy, m, v, ga, be, dbeta, dgamma,
                                                                gm, gv, eps, count, g, dx);
    else
      bn_dx_kernel<T, V, RELU, false><<<grid, kThreads, 0, st>>>(x, gy, m, v, ga, be, dbeta,
                                                                 dgamma, gm, gv, eps, count, g, dx);
    return (int)cudaGetLastError();
  }
  static int run(const void* x, const void* gy, const float* m, const float* v, const float* ga,
                 const float* be, const float* gm, const float* gv, float eps, int relu, Geo g,
                 int vec, int chunks, float* part, float* dgamma, float* dbeta, void* dx,
                 cudaStream_t st) {
    if (bad_geo<T>(g, vec, chunks, {x, gy, dx}) || (gm == nullptr) != (gv == nullptr))
      return (int)cudaErrorInvalidValue;
    const dim3 grid = grid_of<T>(g, vec, chunks);
    const T* px = static_cast<const T*>(x);
    const T* pg = static_cast<const T*>(gy);
    T* pd = static_cast<T*>(dx);
    constexpr int V = 16 / sizeof(T);
    if (vec)
      return relu ? go<V, true>(grid, chunks, px, pg, m, v, ga, be, gm, gv, eps, g, part, dgamma,
                                dbeta, pd, st)
                  : go<V, false>(grid, chunks, px, pg, m, v, ga, be, gm, gv, eps, g, part, dgamma,
                                 dbeta, pd, st);
    return relu ? go<1, true>(grid, chunks, px, pg, m, v, ga, be, gm, gv, eps, g, part, dgamma,
                              dbeta, pd, st)
                : go<1, false>(grid, chunks, px, pg, m, v, ga, be, gm, gv, eps, g, part, dgamma,
                               dbeta, pd, st);
  }
};

Geo geo(long long rows, int C, int tg, long long rpc) { return Geo{rows, C, tg, rpc}; }

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns the CUDA error (0 on success).
// x (and g, y, dx) are contiguous [rows, C] of one type (dtype 0 f32, 1 bf16,
// 2 f16); the per-channel vectors are contiguous f32 [C]. The geometry comes
// from the caller (ops/batch_norm.py launch_plan): vec 1 for 16-byte channel
// groups, tg groups per block row (1-32), `chunks` row chunks of rpc rows;
// part is f32 scratch of 2 * chunks * C floats.

// (a) mean and var [C] of x.
int dl4j_bn_stats(int dtype, const void* x, long long rows, int C, int vec, int tg, int chunks,
                  long long rpc, float* part, float* mean, float* var, void* stream) {
  return by_dtype<Stats>(dtype, x, geo(rows, C, tg, rpc), vec, chunks, part, mean, var,
                         static_cast<cudaStream_t>(stream));
}

// (b) y = x * scale + shift in x's type, then max(y, 0) where relu.
int dl4j_bn_apply(int dtype, const void* x, const float* mean, const float* var,
                  const float* gamma, const float* beta, float eps, int relu, long long rows,
                  int C, int vec, int tg, int chunks, long long rpc, void* y, void* stream) {
  return by_dtype<Apply>(dtype, x, mean, var, gamma, beta, eps, relu, geo(rows, C, tg, rpc), vec,
                         chunks, y, static_cast<cudaStream_t>(stream));
}

// (c) dx [rows, C] in x's type and dgamma, dbeta [C] f32 from the upstream gy;
// gm and gv (f32 [C], both or neither) are the gradients of the returned mean
// and variance.
int dl4j_bn_backward(int dtype, const void* x, const void* gy, const float* mean,
                     const float* var, const float* gamma, const float* beta, const float* gm,
                     const float* gv, float eps, int relu, long long rows, int C, int vec, int tg,
                     int chunks, long long rpc, float* part, float* dgamma, float* dbeta,
                     void* dx, void* stream) {
  return by_dtype<Backward>(dtype, x, gy, mean, var, gamma, beta, gm, gv, eps, relu,
                            geo(rows, C, tg, rpc), vec, chunks, part, dgamma, dbeta, dx,
                            static_cast<cudaStream_t>(stream));
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
