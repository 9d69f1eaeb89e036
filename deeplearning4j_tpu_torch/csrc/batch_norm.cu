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
// (c) reads x and g and writes dx: 2, 4 and 6 bytes per bf16 element at the
// bound; (c) reads x and g twice wherever they do not stay on chip between its
// passes (10 bytes). ResNet-50 holds 2.71 G batch-norm elements a step at batch
// 256.
//
// (b) is a plain stream: a thread owns one group of V channels (16 bytes: 4 f32
// or 8 bf16/f16; V = 1 where C or a pointer does not allow 16-byte pieces) and
// walks rows; a block of 256 threads holds tg groups x 256 / tg row lanes; the
// grid is (channel tiles, row chunks), some 512 blocks (ops/batch_norm.py
// launch_plan). Its per-channel constants sit in registers.
//
// (a) and (c) are one launch each (bn_reduce_kernel):
// - A persistent grid of co-resident blocks (one per SM at the ring's size),
//   launched cooperatively; a plan the card cannot hold all at once is refused.
//   The work is cut from the shape alone (ops/batch_norm.py reduce_plan): tiles
//   of R = 4 x lanes rows by tg channel groups, chunks of tpc consecutive tiles,
//   about 132 chunks; block b takes chunks b, b + grid, ...
// - A copy warp fills a ring of S stages in shared memory with the bulk-copy
//   engine (cp.async.bulk, completing on the stage's full mbarrier; one copy a
//   tensor where a tile spans all channels, a copy a row otherwise); eight
//   consumer warps read the stages and release them on their empty mbarriers.
//   The ring takes most of the SM's shared memory, so some 190 KB are in flight.
// - Each thread sums its rows of a chunk in row order; at the chunk's end the
//   lanes of a channel are folded by warp shuffles (where a warp holds several
//   row lanes) and then in lane order through shared memory, and the chunk's
//   partial goes to f32 scratch [2][chunks][C]. After a grid barrier a block
//   takes 32 channels at a time: each consumer warp sums one eighth of the
//   chunks in chunk order (lanes over channels, the loads coalesced), and the
//   eight sums are added in order. No atomics take part in any sum, and the
//   grouping of every sum comes from the shape: two calls are bit-equal, on any
//   card.
// - (c) then passes a second grid barrier and walks its tiles in the reverse
//   order: the last S tiles of pass A are still in the ring (where a block's
//   share fits, pass B reads nothing from device memory), and the ones before
//   them were the last to pass through L2.
// - Where C or a pointer does not allow 16-byte pieces, the same kernel reads x
//   and g one element a thread straight from device memory (no ring).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTg = 32;        // channel groups per block row of (b) (one warp wide)
constexpr int kWarps = kThreads / 32;   // consumer warps of (a) and (c)
constexpr int kBlock = kThreads + 32;   // and their copy warp
constexpr int kRowsPerLane = 4;         // rows of a tile per row lane
constexpr int kMaxStages = 32;          // ring stages (one parity bit each)
constexpr int kBarBytes = 16 * kMaxStages;  // full and empty mbarriers
constexpr long long kWaitTimeoutNs = 10LL * 1000 * 1000 * 1000;

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

// V elements of T (16 bytes where V > 1, one element otherwise) as loaded
template <typename T, int V>
struct Raw {
  uint4 u;
};
template <typename T>
struct Raw<T, 1> {
  T u;
};

// SMEM: p lies in this block's shared memory (the ring), else in device memory
template <typename T, int V, bool SMEM = false>
__device__ __forceinline__ Raw<T, V> load_raw(const T* __restrict__ p) {
  Raw<T, V> r;
  if constexpr (V == 1) {
    r.u = p[0];
  } else {
    static_assert(V * sizeof(T) == 16, "a group is 16 bytes");
    if constexpr (SMEM)
      r.u = *reinterpret_cast<const uint4*>(p);
    else
      r.u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(r.u);
  } else {
    const T* e = reinterpret_cast<const T*>(&r.u);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* __restrict__ p, float (&f)[V]) {
  unpack<T, V>(load_raw<T, V>(p), f);
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

// The launch geometry of (b).
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

// ------------------------------------------------ (a), (c): the reduce kernel
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

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned addr, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned addr, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(addr), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned addr) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(addr) : "memory");
}
__device__ __forceinline__ bool mbar_done(unsigned addr, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of parity `parity` of an mbarrier to complete; trap after
// the timeout rather than hang (the clock read only once a wait is long).
__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  if (mbar_done(addr, parity)) return;
  const long long t0 = global_ns();
  while (!mbar_done(addr, parity))
    if (global_ns() - t0 > kWaitTimeoutNs) __trap();
}
// `bytes` (a multiple of 16) at src in device memory into dst in this block's
// shared memory, completing on the mbarrier at mbar
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// Grid-wide barrier over all co-resident blocks, on one word (the scheme of
// cooperative groups' grid sync): every block adds 1 but block 0, which adds
// 2^31 - (blocks - 1), so the last arrival flips the top bit and leaves the
// low bits as they were. A block waits until the top bit differs from the one
// it saw when it arrived. The word's low bits stay 0 between barriers, so it
// serves the next launch as it is.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(bar, add);
    volatile unsigned int* word = bar;
    if ((*word ^ old) < 0x80000000u) {
      const long long t0 = global_ns();
      while ((*word ^ old) < 0x80000000u)
        if (global_ns() - t0 > kWaitTimeoutNs) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The reduce kernels' arguments. The work: ctiles channel tiles of tg groups
// of V channels, by `chunks` row chunks of rpc = tpc * R rows, item q = (ct =
// q / chunks, rq = q % chunks); a tile is R rows of a chunk (fewer at the end).
struct Red {
  const void* x;
  const void* g;  // the upstream gradient (c), or null (a)
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  const float* gm;  // (c) with the statistics' gradients, else null
  const float* gv;
  float eps, count;
  long long rows;
  long long rpc;
  int C, tg, lanes, R, tpc, chunks, ctiles;
  int S;                 // ring stages (0 without the ring)
  int rows_red;          // rows of the fold's shared scratch
  unsigned ring_off;     // byte offset of the ring in shared memory
  unsigned stage_bytes;  // one stage: the x tile, then the g tile (c)
  unsigned tile_bytes;   // one tensor's full tile, R * tg * 16
  float* part;           // [2][chunks][C] f32 scratch
  unsigned* bar;         // the grid-barrier word, zero before the first launch
  float* out0;           // (a) mean, (c) dbeta = s1
  float* out1;           // (a) var, (c) dgamma = s2
  void* dx;              // (c)
};

// tiles of item q
__device__ __forceinline__ int tiles_of(const Red& a, int q) {
  const long long r0 = (long long)(q % a.chunks) * a.rpc;
  return (int)((min(a.rpc, a.rows - r0) + a.R - 1) / a.R);
}

// The copy warp: the tile of rows [r0, r0 + nr), channels [c0, c0 + cw) of
// both tensors into the stage at `stage`, completing on `full`.
template <typename T, int NT>
__device__ __forceinline__ void issue(const Red& a, long long r0, int nr, int c0, int cw,
                                      unsigned stage, unsigned full) {
  const int lane = threadIdx.x & 31;
  const unsigned row = (unsigned)(cw * sizeof(T));
  if (lane == 0) mbar_expect_tx(full, row * nr * NT);
  __syncwarp();
  const T* src[2] = {static_cast<const T*>(a.x), static_cast<const T*>(a.g)};
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const unsigned dst = stage + k * a.tile_bytes;
    const T* p = src[k] + r0 * a.C + c0;
    if (cw == a.C) {  // rows contiguous: one copy
      if (lane == 0) bulk_load(dst, p, row * nr, full);
    } else {
      const unsigned pitch = (unsigned)(a.tg * 16);
      for (int r = lane; r < nr; r += 32)
        bulk_load(dst + r * pitch, p + (long long)r * a.C, row, full);
    }
  }
}

// The consumers' fold at the end of an item: s1, s2 of every lane summed per
// channel in a fixed order, written as the item's partials part[plane][rq][c].
// Where a channel has one row lane (tg = 256) a thread writes its own sums.
template <int V>
__device__ __forceinline__ void fold(const Red& a, float* red, int ct, int rq, int gi, int l,
                                     bool act, float (&s1)[V], float (&s2)[V]) {
  const int tgV = a.tg * V;
  float* part = a.part + (size_t)rq * a.C + ct * tgV;
  const size_t plane = (size_t)a.chunks * a.C;
  if (a.lanes == 1) {
    if (act) {
      if constexpr (V % 4 == 0) {  // 16-byte stores (C a multiple of V)
#pragma unroll
        for (int i = 0; i < V; i += 4) {
          *reinterpret_cast<float4*>(part + gi * V + i) =
              make_float4(s1[i], s1[i + 1], s1[i + 2], s1[i + 3]);
          *reinterpret_cast<float4*>(part + plane + gi * V + i) =
              make_float4(s2[i], s2[i + 1], s2[i + 2], s2[i + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          part[gi * V + i] = s1[i];
          part[plane + gi * V + i] = s2[i];
        }
      }
    }
  } else {
    const bool shfl = a.tg < 32 && 32 % a.tg == 0;  // a warp holds 32 / tg row lanes
    if (shfl) {
      for (int off = a.tg; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
          s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
        }
      }
    }
    const int rr = shfl ? (int)(threadIdx.x >> 5) : l;
    if (act && (!shfl || (threadIdx.x & 31) < a.tg)) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[rr * tgV + gi * V + i] = s1[i];
        red[(a.rows_red + rr) * tgV + gi * V + i] = s2[i];
      }
    }
    consumers_sync();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      for (int k = threadIdx.x; k < tgV && ct * tgV + k < a.C; k += kThreads) {
        const float* col = red + p * a.rows_red * tgV + k;
        float v = 0.f;
        for (int r = 0; r < a.rows_red; ++r) v += col[r * tgV];
        part[p * plane + k] = v;
      }
    }
    consumers_sync();  // the scratch is rewritten by the next item
  }
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
}

// One row of pass A: its terms added to this thread's s1, s2.
template <typename T, int V, bool BWD, bool RELU>
__device__ __forceinline__ void add_row(const Raw<T, V>& rx, const Raw<T, V>& rg,
                                        const BwdConst (&k)[V], const float (&sh)[V],
                                        float (&s1)[V], float (&s2)[V]) {
  float f[V];
  unpack<T, V>(rx, f);
  if constexpr (BWD) {
    float d[V];
    unpack<T, V>(rg, d);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float gp = masked<RELU>(f[e], d[e], k[e]);
      const float xhat = __fmul_rn(__fsub_rn(f[e], k[e].m), k[e].inv);
      s1[e] += gp;
      s2[e] = fmaf(gp, xhat, s2[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = f[e] - sh[e];
      s1[e] += d;
      s2[e] = fmaf(d, d, s2[e]);
    }
  }
}

// The per-channel terms of dx beside the constants: s1, s2 and, with the
// statistics' gradients, gm / count and 2 gv / count.
template <int V>
struct DxConst {
  float s1[V], s2[V], em[V], ev[V];
};

// One row of pass B: dx, written to out.
template <typename T, int V, bool RELU, bool EXTRA>
__device__ __forceinline__ void dx_row(const Raw<T, V>& rx, const Raw<T, V>& rg,
                                       const BwdConst (&k)[V], const DxConst<V>& w, float count,
                                       T* __restrict__ out) {
  float f[V], d[V];
  unpack<T, V>(rx, f);
  unpack<T, V>(rg, d);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float gp = masked<RELU>(f[e], d[e], k[e]);
    const float xhat = __fmul_rn(__fsub_rn(f[e], k[e].m), k[e].inv);
    float v = __fmul_rn(
        k[e].sc, __fsub_rn(gp, __fdiv_rn(__fadd_rn(w.s1[e], __fmul_rn(xhat, w.s2[e])), count)));
    if (EXTRA) v = __fadd_rn(v, __fadd_rn(w.em[e], __fmul_rn(w.ev[e], __fsub_rn(f[e], k[e].m))));
    d[e] = v;
  }
  store_v<T, V>(out, d);
}

// (a) BWD false: mean and var. (c) BWD true: dbeta, dgamma and dx.
// A thread's rows of a tile are l + j * lanes (j < kRowsPerLane), taken in
// that order; all of a tile's loads are issued before its arithmetic.
template <typename T, int V, bool BULK, bool BWD, bool RELU, bool EXTRA>
__global__ void __launch_bounds__(kBlock, 1) bn_reduce_kernel(const Red a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NT = BWD ? 2 : 1;
  constexpr int K = kRowsPerLane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool copier = warp == kWarps;
  const int gi = threadIdx.x % a.tg, l = threadIdx.x / a.tg;
  const bool lane_ok = !copier && l < a.lanes;
  const int items = a.ctiles * a.chunks;
  const int S = a.S, tgV = a.tg * V;
  const unsigned bars = smem_u32(smem);  // full[s] at 8 s, empty[s] at 8 (kMaxStages + s)
  float* red = reinterpret_cast<float*>(smem + kBarBytes);
  const unsigned ring = smem_u32(smem + a.ring_off);
  const T* xg = static_cast<const T*>(a.x);
  const T* gg = static_cast<const T*>(a.g);

  int n = 0;  // this block's tiles
  for (int q = blockIdx.x; q < items; q += gridDim.x) n += tiles_of(a, q);

  if (BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(bars + 8 * s, 1);
        mbar_init(bars + 8 * (kMaxStages + s), kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  unsigned phase = 0;  // one parity bit a stage: full (consumers), empty (copy warp)

  // ---- pass A: the sums of each item into its partials
  if (copier) {
    if (BULK) {
      int i = 0, s = 0;
      for (int q = blockIdx.x; q < items; q += gridDim.x) {
        const int ct = q / a.chunks, rq = q % a.chunks, nt = tiles_of(a, q);
        const int c0 = ct * tgV, cw = min(tgV, a.C - c0);
        for (int t = 0; t < nt; ++t, ++i) {
          if (i >= S) {
            mbar_wait(bars + 8 * (kMaxStages + s), (phase >> s) & 1u);
            phase ^= 1u << s;
          }
          const long long r0 = (long long)rq * a.rpc + (long long)t * a.R;
          issue<T, NT>(a, r0, (int)min((long long)a.R, a.rows - r0), c0, cw,
                       ring + s * a.stage_bytes, bars + 8 * s);
          s = s + 1 == S ? 0 : s + 1;
        }
      }
    }
  } else {
    float s1[V] = {}, s2[V] = {};
    int i = 0, s = 0;
    for (int q = blockIdx.x; q < items; q += gridDim.x) {
      const int ct = q / a.chunks, rq = q % a.chunks, nt = tiles_of(a, q);
      const int c0 = ct * tgV + gi * V;
      const bool act = lane_ok && c0 < a.C;
      float sh[V];  // (a): the shift; (c): the constants below
      BwdConst k[V];
      if (act) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (BWD)
            k[j] = bwd_const(a.mean, a.var, a.gamma, a.beta, a.eps, c0 + j);
          else
            sh[j] = to_f(xg[c0 + j]);
        }
      }
      for (int t = 0; t < nt; ++t, ++i) {
        const long long r0 = (long long)rq * a.rpc + (long long)t * a.R;
        const int nr = (int)min((long long)a.R, a.rows - r0);
        const T *xs, *gs;
        long long pitch;
        if (BULK) {
          mbar_wait(bars + 8 * s, (phase >> s) & 1u);
          phase ^= 1u << s;
          xs = reinterpret_cast<const T*>(smem + a.ring_off + s * a.stage_bytes);
          gs = reinterpret_cast<const T*>(smem + a.ring_off + s * a.stage_bytes + a.tile_bytes);
          pitch = tgV;
        } else {
          xs = xg + r0 * a.C + ct * tgV;
          gs = BWD ? gg + r0 * a.C + ct * tgV : nullptr;
          pitch = a.C;
        }
        if (act) {
          Raw<T, V> rx[K], rg[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int r = l + j * a.lanes;
            if (r < nr) {
              rx[j] = load_raw<T, V, BULK>(xs + r * pitch + gi * V);
              if (BWD) rg[j] = load_raw<T, V, BULK>(gs + r * pitch + gi * V);
            }
          }
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (l + j * a.lanes < nr) add_row<T, V, BWD, RELU>(rx[j], rg[j], k, sh, s1, s2);
        }
        if (BULK) {
          __syncwarp();
          if (i + S < n && lane == 0) mbar_arrive(bars + 8 * (kMaxStages + s));
          s = s + 1 == S ? 0 : s + 1;
        }
      }
      fold<V>(a, red, ct, rq, gi, l, act, s1, s2);
    }
  }

  // ---- every channel's partials summed: 32 channels a block at a time, lanes
  // over channels; consumer warp w sums the chunks of range w in chunk order,
  // and the ranges' sums are added in range order
  grid_barrier(a.bar);
  {
    constexpr int B = 8;  // partials a lane loads before it adds them
    const int span = (a.chunks + kWarps - 1) / kWarps;
    const size_t plane = (size_t)a.chunks * a.C;
    float* sums = red;    // [2][kWarps][32]
    for (int c0 = blockIdx.x * 32; c0 < a.C; c0 += gridDim.x * 32) {
      const int c = c0 + lane;
      if (!copier) {
        float p = 0.f, r = 0.f;
        const int k1 = min(a.chunks, (warp + 1) * span);
        for (int k0 = warp * span; k0 < k1; k0 += B) {
          float pv[B], rv[B];
#pragma unroll
          for (int u = 0; u < B; ++u) {
            const bool in = c < a.C && k0 + u < k1;
            pv[u] = in ? __ldcg(a.part + (size_t)(k0 + u) * a.C + c) : 0.f;
            rv[u] = in ? __ldcg(a.part + plane + (size_t)(k0 + u) * a.C + c) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < B; ++u) {
            if (k0 + u < k1) {
              p += pv[u];
              r += rv[u];
            }
          }
        }
        sums[warp * 32 + lane] = p;
        sums[(kWarps + warp) * 32 + lane] = r;
      }
      __syncthreads();
      if (warp == 0 && c < a.C) {
        float p = 0.f, r = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          p += sums[w * 32 + lane];
          r += sums[(kWarps + w) * 32 + lane];
        }
        if constexpr (BWD) {
          a.out0[c] = p;
          a.out1[c] = r;
        } else {
          const float md = __fdiv_rn(p, a.count);
          const float v = __fsub_rn(__fdiv_rn(r, a.count), __fmul_rn(md, md));
          a.out0[c] = __fadd_rn(to_f(xg[c]), md);
          a.out1[c] = v > 0.f ? v : 0.f;
        }
      }
      __syncthreads();  // the sums are rewritten by the next 32 channels
    }
  }
  if constexpr (!BWD) return;

  // ---- pass B (c): dx, the tiles in the reverse order of pass A
  grid_barrier(a.bar);
  const int kq_end = (items - 1 - (int)blockIdx.x) / (int)gridDim.x;
  if (copier) {
    if (BULK) {
      int i = n - 1, s = S > 0 ? (n - 1) % S : 0;
      for (int kq = kq_end; kq >= 0; --kq) {
        const int q = blockIdx.x + kq * gridDim.x;
        const int ct = q / a.chunks, rq = q % a.chunks;
        const int c0 = ct * tgV, cw = min(tgV, a.C - c0);
        for (int t = tiles_of(a, q) - 1; t >= 0; --t, --i) {
          if (i < n - S) {  // tile i + S released it in pass B
            mbar_wait(bars + 8 * (kMaxStages + s), (phase >> s) & 1u);
            phase ^= 1u << s;
            const long long r0 = (long long)rq * a.rpc + (long long)t * a.R;
            issue<T, NT>(a, r0, (int)min((long long)a.R, a.rows - r0), c0, cw,
                         ring + s * a.stage_bytes, bars + 8 * s);
          }
          s = s == 0 ? S - 1 : s - 1;
        }
      }
    }
    return;
  }
  int i = n - 1, s = S > 0 ? (n - 1) % S : 0;
  for (int kq = kq_end; kq >= 0; --kq) {
    const int q = blockIdx.x + kq * gridDim.x;
    const int ct = q / a.chunks, rq = q % a.chunks;
    const int c0 = ct * tgV + gi * V;
    const bool act = lane_ok && c0 < a.C;
    BwdConst k[V];
    DxConst<V> w;
    if (act) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = c0 + j;
        k[j] = bwd_const(a.mean, a.var, a.gamma, a.beta, a.eps, c);
        w.s1[j] = __ldcg(a.out0 + c);
        w.s2[j] = __ldcg(a.out1 + c);
        w.em[j] = EXTRA ? __fdiv_rn(a.gm[c], a.count) : 0.f;
        w.ev[j] = EXTRA ? __fdiv_rn(__fmul_rn(a.gv[c], 2.f), a.count) : 0.f;
      }
    }
    for (int t = tiles_of(a, q) - 1; t >= 0; --t, --i) {
      const long long r0 = (long long)rq * a.rpc + (long long)t * a.R;
      const int nr = (int)min((long long)a.R, a.rows - r0);
      const T *xs, *gs;
      long long pitch;
      if (BULK) {
        if (i < n - S) {  // not held in the ring since pass A
          mbar_wait(bars + 8 * s, (phase >> s) & 1u);
          phase ^= 1u << s;
        }
        xs = reinterpret_cast<const T*>(smem + a.ring_off + s * a.stage_bytes);
        gs = reinterpret_cast<const T*>(smem + a.ring_off + s * a.stage_bytes + a.tile_bytes);
        pitch = tgV;
      } else {
        xs = xg + r0 * a.C + ct * tgV;
        gs = gg + r0 * a.C + ct * tgV;
        pitch = a.C;
      }
      if (act) {
        T* out = static_cast<T*>(a.dx) + r0 * a.C + c0;
        Raw<T, V> rx[K], rg[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int r = l + j * a.lanes;
          if (r < nr) {
            rx[j] = load_raw<T, V, BULK>(xs + r * pitch + gi * V);
            rg[j] = load_raw<T, V, BULK>(gs + r * pitch + gi * V);
          }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int r = l + j * a.lanes;
          if (r < nr)
            dx_row<T, V, RELU, EXTRA>(rx[j], rg[j], k, w, a.count, out + (long long)r * a.C);
        }
      }
      if (BULK) {
        __syncwarp();
        if (i >= S && lane == 0) mbar_arrive(bars + 8 * (kMaxStages + s));
        s = s == 0 ? S - 1 : s - 1;
      }
    }
  }
  // every tile of pass B written
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

// (b)'s grid and checks: vec asks for 16-byte groups (C a multiple of V and
// every tensor pointer 16-byte aligned), tg groups per block row, `chunks` row
// chunks of rpc rows covering all rows.
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

// The card's numbers a reduce launch needs, and the blocks per SM of each
// kernel instance at each shared-memory size, found once.
std::mutex g_mu;
std::map<int, std::pair<int, int>> g_dev;                     // SMs, shared-memory opt-in
std::map<std::tuple<const void*, int, unsigned>, int> g_occ;  // blocks per SM

cudaError_t card(int* dev, int* sms, int* optin) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_dev.find(*dev);
  if (it == g_dev.end()) {
    int n = 0, o = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, *dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    it = g_dev.emplace(*dev, std::make_pair(n, o)).first;
  }
  *sms = it->second.first;
  *optin = it->second.second;
  return cudaSuccess;
}

// blocks of fn per SM at `smem` bytes (the opt-in set to the card's whole first)
cudaError_t blocks_per_sm(const void* fn, int dev, int optin, unsigned smem, int* out) {
  std::lock_guard<std::mutex> lock(g_mu);
  const auto key = std::make_tuple(fn, dev, smem);
  auto it = g_occ.find(key);
  if (it == g_occ.end()) {
    const auto once = std::make_tuple(fn, dev, 0u);
    if (g_occ.find(once) == g_occ.end()) {
      const cudaError_t err =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err != cudaSuccess) return err;
      g_occ.emplace(once, 0);
    }
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kBlock, smem);
    if (err != cudaSuccess) return err;
    it = g_occ.emplace(key, n).first;
  }
  *out = it->second;
  return cudaSuccess;
}

// The plan of one reduce launch: ring stages, shared memory and grid. The ring
// takes what the opt-in leaves after the barriers and the fold's scratch, but
// no more stages than a block has tiles; the grid is every block the card
// holds at once, at most one an item. Writes (grid, S, smem, blocks per SM) to
// info where given.
template <typename T, int V, bool BULK, bool BWD, bool RELU, bool EXTRA>
int launch_reduce(Red a, cudaStream_t st, int* info) {
  const void* fn = reinterpret_cast<const void*>(&bn_reduce_kernel<T, V, BULK, BWD, RELU, EXTRA>);
  int dev = 0, sms = 0, optin = 0, per = 0;
  cudaError_t err = card(&dev, &sms, &optin);
  if (err != cudaSuccess) return (int)err;
  const int items = a.ctiles * a.chunks;
  const int tgV = a.tg * V;
  a.rows_red = (a.tg < 32 && 32 % a.tg == 0) ? kWarps : a.lanes;
  // the fold's scratch, which the sum of the partials reuses ([2][kWarps][32])
  a.ring_off = kBarBytes + ((std::max(2u * a.rows_red * tgV, 2u * kWarps * 32u) * 4u + 127u) &
                            ~127u);
  a.tile_bytes = (unsigned)(a.R * tgV * sizeof(T));
  a.stage_bytes = ((BWD ? 2u : 1u) * a.tile_bytes + 127u) & ~127u;
  a.S = 0;
  unsigned smem = a.ring_off;
  if (BULK) {
    if ((long long)optin < (long long)a.ring_off + a.stage_bytes) return (int)cudaErrorInvalidValue;
    a.S = std::min(kMaxStages, (int)((optin - a.ring_off) / a.stage_bytes));
    err = blocks_per_sm(fn, dev, optin, a.ring_off + a.S * a.stage_bytes, &per);
    if (err != cudaSuccess) return (int)err;
    if (per > 0) {  // no more stages than a block's tiles
      const int grid = std::min(items, per * sms);
      a.S = std::min(a.S, ((items + grid - 1) / grid) * a.tpc);
    }
    smem = a.ring_off + a.S * a.stage_bytes;
  }
  err = blocks_per_sm(fn, dev, optin, smem, &per);
  if (err != cudaSuccess) return (int)err;
  if (per < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = std::min(items, per * sms);
  if (info != nullptr) {
    info[0] = grid;
    info[1] = a.S;
    info[2] = (int)smem;
    info[3] = per;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kBlock), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The reduce plan's checks: every row and channel in exactly one tile of one
// item (ops/batch_norm.py reduce_plan), vec as for (b).
template <typename T>
bool bad_red(const Red& a, int vec, std::initializer_list<const void*> ps) {
  constexpr int V = 16 / sizeof(T);
  const int v = vec ? V : 1;
  const long long groups = (a.C + v - 1) / v;
  if (a.rows < 1 || a.C < 1 || a.tg < 1 || a.tg > kThreads || a.lanes != kThreads / a.tg ||
      a.R != kRowsPerLane * a.lanes || a.tpc < 1 || a.chunks < 1 || a.ctiles < 1 ||
      a.rpc != (long long)a.tpc * a.R || (long long)a.chunks * a.rpc < a.rows ||
      (long long)(a.chunks - 1) * a.rpc >= a.rows || (long long)a.ctiles * a.tg < groups ||
      (long long)(a.ctiles - 1) * a.tg >= groups || (long long)a.ctiles * a.chunks > (1 << 30))
    return true;
  return vec && (a.C % V != 0 || !aligned16(ps));
}

template <typename T>
struct Stats {
  static int run(Red a, int vec, cudaStream_t st, int* info) {
    if (bad_red<T>(a, vec, {a.x})) return (int)cudaErrorInvalidValue;
    a.count = (float)a.rows;
    if (vec) return launch_reduce<T, 16 / sizeof(T), true, false, false, false>(a, st, info);
    return launch_reduce<T, 1, false, false, false, false>(a, st, info);
  }
};

template <typename T>
struct Backward {
  template <int V, bool BULK>
  static int go(const Red& a, int relu, cudaStream_t st, int* info) {
    if (a.gm != nullptr)
      return relu ? launch_reduce<T, V, BULK, true, true, true>(a, st, info)
                  : launch_reduce<T, V, BULK, true, false, true>(a, st, info);
    return relu ? launch_reduce<T, V, BULK, true, true, false>(a, st, info)
                : launch_reduce<T, V, BULK, true, false, false>(a, st, info);
  }
  static int run(Red a, int vec, int relu, cudaStream_t st, int* info) {
    if (bad_red<T>(a, vec, {a.x, a.g, a.dx}) || (a.gm == nullptr) != (a.gv == nullptr))
      return (int)cudaErrorInvalidValue;
    a.count = (float)a.rows;
    if (vec) return go<16 / sizeof(T), true>(a, relu, st, info);
    return go<1, false>(a, relu, st, info);
  }
};

Geo geo(long long rows, int C, int tg, long long rpc) { return Geo{rows, C, tg, rpc}; }

// Makes device `dev` current for a launch, and the caller's again after.
class DeviceGuard {
 public:
  explicit DeviceGuard(int dev) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != dev) {
      err_ = cudaSetDevice(dev);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

Red red_args(long long rows, int C, const int* plan) {
  Red a{};
  a.rows = rows;
  a.C = C;
  a.tg = plan[0];
  a.lanes = plan[1];
  a.R = plan[2];
  a.tpc = plan[3];
  a.chunks = plan[4];
  a.ctiles = plan[5];
  a.rpc = (long long)a.tpc * a.R;
  return a;
}

}  // namespace

extern "C" {

// Every entry launches on `stream` of CUDA device `device` (made current for
// the call) and returns the CUDA error (0 on success).
// x (and g, y, dx) are contiguous [rows, C] of one type (dtype 0 f32, 1 bf16,
// 2 f16); the per-channel vectors are contiguous f32 [C]. The geometry comes
// from the caller (ops/batch_norm.py): vec 1 for 16-byte channel groups.

// (a) mean and var [C] of x, one cooperative launch. plan = reduce_plan's
// (tg, lanes, R, tpc, chunks, ctiles); part is f32 scratch of 2 * chunks * C
// floats, bar one zeroed word (its low bits left zero); info, where not null, receives
// (grid, ring stages, shared bytes, blocks per SM).
int dl4j_bn_stats(int dtype, const void* x, long long rows, int C, int vec, const int* plan,
                  float* part, unsigned* bar, float* mean, float* var, int* info, int device,
                  void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  Red a = red_args(rows, C, plan);
  a.x = x;
  a.part = part;
  a.bar = bar;
  a.out0 = mean;
  a.out1 = var;
  return by_dtype<Stats>(dtype, a, vec, static_cast<cudaStream_t>(stream), info);
}

// (b) y = x * scale + shift in x's type, then max(y, 0) where relu; tg groups
// per block row (1-32), `chunks` row chunks of rpc rows (launch_plan).
int dl4j_bn_apply(int dtype, const void* x, const float* mean, const float* var,
                  const float* gamma, const float* beta, float eps, int relu, long long rows,
                  int C, int vec, int tg, int chunks, long long rpc, void* y, int device,
                  void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return by_dtype<Apply>(dtype, x, mean, var, gamma, beta, eps, relu, geo(rows, C, tg, rpc), vec,
                         chunks, y, static_cast<cudaStream_t>(stream));
}

// (c) dx [rows, C] in x's type and dgamma, dbeta [C] f32 from the upstream gy,
// one cooperative launch; gm and gv (f32 [C], both or neither) are the
// gradients of the returned mean and variance. plan, part, bar, info as (a).
int dl4j_bn_backward(int dtype, const void* x, const void* gy, const float* mean,
                     const float* var, const float* gamma, const float* beta, const float* gm,
                     const float* gv, float eps, int relu, long long rows, int C, int vec,
                     const int* plan, float* part, unsigned* bar, float* dgamma, float* dbeta,
                     void* dx, int* info, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  Red a = red_args(rows, C, plan);
  a.x = x;
  a.g = gy;
  a.mean = mean;
  a.var = var;
  a.gamma = gamma;
  a.beta = beta;
  a.gm = gm;
  a.gv = gv;
  a.eps = eps;
  a.part = part;
  a.bar = bar;
  a.out0 = dbeta;
  a.out1 = dgamma;
  a.dx = dx;
  return by_dtype<Backward>(dtype, a, vec, relu, static_cast<cudaStream_t>(stream), info);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
