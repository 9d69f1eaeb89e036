// Flash attention, forward and backward, written by hand for Hopper (sm_90a)
// and bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel in deeplearning4j_tpu/ops/flash_attention.py
// (pallas_flash_forward / _flash_fwd_kernel, pl.pallas_call at :181). That
// kernel has no backward of its own: its custom_vjp recomputes through the plain
// blockwise_attention (:197-217). Here the backward is a kernel too and computes
// the same exact attention gradient.
//
// What it computes, for q [N, H, Tq, hd], k and v [N, H, Tk, hd], an optional
// key-padding mask [N, Tk] (key j of sequence n is attended iff mask > 0) and an
// optional causal mask (query i attends key j iff i >= j):
//   s_ij = (f32(q_i) * scale) . f32(k_j), masked scores set to -1e30 (not -inf)
//   out_i = sum_j exp(s_ij - m_i) v_j / l_i, m_i = max(-1e30, max_j s_ij),
//   l_i = sum_j exp(s_ij - m_i)
// with the online softmax over key tiles in f32, as _flash_fwd_kernel does. A
// row whose every key is masked therefore weighs all Tk keys equally and returns
// the mean of v. Keys past Tk (the ragged last tile) take no part at all.
//
// Backward (FlashAttention-2): with P_ij = exp(s_ij - m_i) / l_i from the
// forward's row statistics,
//   D_i = dout_i . out_i,  dv_j = sum_i P_ij dout_i,  dP_ij = dout_i . v_j,
//   dS_ij = P_ij (dP_ij - D_i) (0 where masked: the mask blocks the gradient),
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i.
// The forward stores m and l apart rather than one log-sum-exp: for a fully
// masked row m = -1e30 and m + log(l) rounds back to -1e30 in f32, which would
// lose l.
//
// Design (simple and correct first; no tensor cores, no TMA):
// - Forward: one block per (n*h, tile of 64 query rows), one thread per query
//   row. K and V stream through shared memory in tiles of 32 keys, widened to
//   f32; each thread loads 16 bytes at a time and issues a batch of loads
//   before it stores any, so a tile pays the memory latency about once. A
//   thread keeps its 32 scores and its output row in registers and reads K and
//   V rows as broadcasts (float4), its own scaled query row from a padded
//   shared tile.
// - Backward, three kernels: D (one warp per row); dk/dv, one block per
//   (n*h, tile of 64 keys), one thread per key with its dk and dv rows in
//   registers, looping over the query tiles; dq, one block per (n*h, tile of 64
//   query rows), one thread per query row, looping over the key tiles (the
//   second pass over the query tiles that avoids atomics). Both take the other
//   side's rows kGroup at a time, so one read of the thread's own rows from
//   shared memory serves kGroup of them: shared-memory bandwidth, not the
//   FMAs, is what these loops run out of.
// - Every tile is bounds-checked, so any Tq and Tk work. hd is a multiple of 32
//   up to 128 (at 128 the dk/dv accumulators exceed the register file and
//   spill).
//
// What bounds it on the H100 at the BERT-base training shape (N=96, H=12,
// T=128, hd=64, bf16): bytes. The forward must read q, k, v and write out,
// 75.5 MB, 22.5 us at 3.35 TB/s; its 4.83 GFLOP would take 4.9 us at the bf16
// dense tensor-core peak. The backward reads q, k, v, out, dout and the row
// statistics and writes dq, dk, dv: 151.6 MB, 45 us. These kernels do their
// arithmetic on the CUDA cores in f32 (67 TFLOP/s), so they are bound by that
// rate and by shared-memory bandwidth, well above the byte bound; mma/wgmma
// tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the JAX module
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kRows = 64;      // query rows (forward, dq) or keys (dk/dv) per block = threads
constexpr int kTile = 32;      // keys (forward, dq) or query rows (dk/dv) per staged tile
constexpr int kPad = 4;        // row padding of thread-owned shared rows (float4 reads)
constexpr int kGroup = 4;      // tile rows a backward thread takes per pass over its own rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A thread's load of its own shared row, kept inside the loop: left to
// itself the compiler hoists a whole loop-invariant row into registers, and
// beside the row's gradient accumulators that spills.
__device__ __forceinline__ float4 ld4_own(const float* p) {
  float4 r;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"(a)
               : "memory");
  return r;
}

// Stage rows [r0, r0 + ROWS) of NS slabs [total, HD] (src[s], 16-byte
// aligned) into shared memory as f32 times mul[s] (dst[s], row stride
// `stride`); rows past `total` are zero. The kRows threads move 16-byte chunks
// and issue a batch of loads for every slab before they store any, so a
// tile pays the loads' latency once per batch, not once per element.
template <typename T, int HD, int ROWS, int NS>
__device__ __forceinline__ void stage_rows(float* const (&dst)[NS], int stride,
                                           const T* const (&src)[NS], const float (&mul)[NS],
                                           int r0, int total) {
  constexpr int kVec = 16 / (int)sizeof(T);   // elements per chunk
  constexpr int kCpr = HD / kVec;             // chunks per row
  static_assert(ROWS * kCpr % kRows == 0, "a tile is a whole number of chunks per thread");
  constexpr int kIters = ROWS * kCpr / kRows;
  constexpr int kBatch = kIters % 4 == 0 ? 4 : (kIters % 2 == 0 ? 2 : 1);
  for (int b0 = 0; b0 < kIters; b0 += kBatch) {
    uint4 buf[NS][kBatch];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = (b0 + i) * kRows + (int)threadIdx.x;
        const int g = r0 + c / kCpr;
        buf[s][i] = g < total
                        ? __ldg(reinterpret_cast<const uint4*>(src[s] + (size_t)g * HD) + c % kCpr)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = (b0 + i) * kRows + (int)threadIdx.x;
        float* d = dst[s] + (c / kCpr) * stride + (c % kCpr) * kVec;
        const float m = mul[s];
        if constexpr (std::is_same<T, float>::value) {
          const uint4 u = buf[s][i];
          *reinterpret_cast<float4*>(d) =
              make_float4(__uint_as_float(u.x) * m, __uint_as_float(u.y) * m,
                          __uint_as_float(u.z) * m, __uint_as_float(u.w) * m);
        } else {
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&buf[s][i]);
          const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
          const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
          *reinterpret_cast<float4*>(d) = make_float4(a.x * m, a.y * m, b.x * m, b.y * m);
          *reinterpret_cast<float4*>(d + 4) = make_float4(e.x * m, e.y * m, f.x * m, f.y * m);
        }
      }
    }
  }
}

// Write a thread's f32 row times `mul` to its 16-byte aligned row of T, 16
// bytes per store.
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* dst, const float* row, float mul) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(dst + d) =
          make_float4(row[d] * mul, row[d + 1] * mul, row[d + 2] * mul, row[d + 3] * mul);
  } else {
#pragma unroll
    for (int d = 0; d < HD; d += 8) {
      __align__(16) __nv_bfloat162 h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(row[d + 2 * e] * mul, row[d + 2 * e + 1] * mul);
      *reinterpret_cast<uint4*>(dst + d) = *reinterpret_cast<const uint4*>(h);
    }
  }
}

// ------------------------------------------------------------------ forward
// Grid (N*H, ceil(Tq / kRows)); block kRows threads.
template <typename T, int HD>
__global__ void __launch_bounds__(kRows)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, T* __restrict__ out,
                     float* __restrict__ stats, int H, int Tq, int Tk, float scale, int causal) {
  constexpr int QS = HD + kPad;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kRows][QS]  scaled query rows
  float* ks = qs + kRows * QS;       // [kTile][HD]
  float* vs = ks + kTile * HD;       // [kTile][HD]
  float* kok = vs + kTile * HD;      // [kTile]      key-mask flags

  const int nh = blockIdx.x;
  const int n = nh / H;
  const int q0 = blockIdx.y * kRows;
  const int row = q0 + threadIdx.x;
  const bool has_row = row < Tq;
  const T* qh = q + (size_t)nh * Tq * HD;
  const T* kh = k + (size_t)nh * Tk * HD;
  const T* vh = v + (size_t)nh * Tk * HD;

  {
    float* const dst[1] = {qs};
    const T* const src[1] = {qh};
    const float mul[1] = {scale};
    stage_rows<T, HD, kRows>(dst, QS, src, mul, q0, Tq);
  }
  const float* qrow = qs + threadIdx.x * QS;
  float* const kv_dst[2] = {ks, vs};
  const T* const kv_src[2] = {kh, vh};
  const float kv_mul[2] = {1.f, 1.f};

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  for (int j0 = 0; j0 < Tk; j0 += kTile) {
    const int jn = min(kTile, Tk - j0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<T, HD, kTile>(kv_dst, HD, kv_src, kv_mul, j0, Tk);
    if (threadIdx.x < kTile) {
      const int j = j0 + threadIdx.x;
      kok[threadIdx.x] = j < Tk && (mask == nullptr || mask[(size_t)n * Tk + j] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
    if (!has_row) continue;

    float s[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = ld4(qrow + d);
#pragma unroll
      for (int j = 0; j < kTile; ++j) s[j] += dot4(qv, ld4(ks + j * HD + d));
    }
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const bool ok = kok[j] > 0.f && (!causal || row >= j0 + j);
      s[j] = ok ? s[j] : kNegInf;
      if (j < jn) tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      // masked keys in range keep exp(-1e30 - m_new) (1 while the row has
      // seen only masked keys); keys past Tk take no part
      s[j] = j < jn ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = s[j];
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 vv = ld4(vs + j * HD + d);
        acc[d] += p * vv.x;
        acc[d + 1] += p * vv.y;
        acc[d + 2] += p * vv.z;
        acc[d + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (has_row) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = acc[d] / den;
    store_row<T, HD>(out + ((size_t)nh * Tq + row) * HD, acc, 1.f);
    const size_t at = (size_t)nh * Tq + row;
    stats[at] = m;
    stats[(size_t)gridDim.x * Tq + at] = l;
  }
}

// ------------------------------------------------------- backward: D = dO.O
// One warp per (n*h, query row); rows = N*H*Tq.
template <typename T, int HD>
__global__ void flash_bwd_rowdot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                        float* __restrict__ drow, long long rows) {
  const long long r = (long long)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= rows) return;
  float part = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += kWarp)
    part += to_f32(out[r * HD + d]) * to_f32(dout[r * HD + d]);
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
  if (lane == 0) drow[r] = part;
}

// ------------------------------------------------------ backward: dk and dv
// Grid (N*H, ceil(Tk / kRows)); block kRows threads, thread t owns key j0 + t.
template <typename T, int HD>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ mask,
                          const T* __restrict__ dout, const float* __restrict__ stats,
                          const float* __restrict__ drow, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int Tq, int Tk, float scale, int causal) {
  constexpr int KS = HD + kPad;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [kRows][KS]  this block's keys
  float* vs = ks + kRows * KS;       // [kRows][KS]
  float* qs = vs + kRows * KS;       // [kTile][HD]  scaled query rows
  float* dos = qs + kTile * HD;      // [kTile][HD]
  float* ms = dos + kTile * HD;      // [kTile] row max
  float* ls = ms + kTile;            // [kTile] row sum
  float* ds_ = ls + kTile;           // [kTile] D

  const int nh = blockIdx.x;
  const int n = nh / H;
  const int NH = gridDim.x;
  const int j0 = blockIdx.y * kRows;
  const int j = j0 + threadIdx.x;
  const bool has_key = j < Tk;
  const bool key_ok = has_key && (mask == nullptr || mask[(size_t)n * Tk + j] > 0.f);
  const T* qh = q + (size_t)nh * Tq * HD;
  const T* doh = dout + (size_t)nh * Tq * HD;

  {
    float* const dst[2] = {ks, vs};
    const T* const src[2] = {k + (size_t)nh * Tk * HD, v + (size_t)nh * Tk * HD};
    const float mul[2] = {1.f, 1.f};
    stage_rows<T, HD, kRows>(dst, KS, src, mul, j0, Tk);
  }
  const float* krow = ks + threadIdx.x * KS;
  const float* vrow = vs + threadIdx.x * KS;
  float* const qd_dst[2] = {qs, dos};
  const T* const qd_src[2] = {qh, doh};
  const float qd_mul[2] = {scale, 1.f};

  float dka[HD], dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dka[d] = dva[d] = 0.f;

  for (int i0 = 0; i0 < Tq; i0 += kTile) {
    const int in = min(kTile, Tq - i0);
    __syncthreads();
    stage_rows<T, HD, kTile>(qd_dst, HD, qd_src, qd_mul, i0, Tq);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      const size_t at = (size_t)nh * Tq + i;
      ms[threadIdx.x] = i < Tq ? stats[at] : 0.f;
      ls[threadIdx.x] = i < Tq ? fmaxf(stats[(size_t)NH * Tq + at], 1e-30f) : 1.f;
      ds_[threadIdx.x] = i < Tq ? drow[at] : 0.f;
    }
    __syncthreads();
    if (!has_key) continue;
    // kGroup query rows per pass, so each read of the thread's own k and v
    // rows serves kGroup rows; rows past the tile's end take no part
    for (int r0 = 0; r0 < in; r0 += kGroup) {
      float s[kGroup], dp[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) s[g] = dp[g] = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = ld4_own(krow + d);
        const float4 vv = ld4_own(vrow + d);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          s[g] += dot4(ld4(qs + (r0 + g) * HD + d), kk);
          dp[g] += dot4(ld4(dos + (r0 + g) * HD + d), vv);
        }
      }
      float p[kGroup], dsv[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int r = r0 + g;
        const bool ok = key_ok && (!causal || i0 + r >= j);
        p[g] = r < in ? expf((ok ? s[g] : kNegInf) - ms[r]) / ls[r] : 0.f;
        dsv[g] = ok ? p[g] * (dp[g] - ds_[r]) : 0.f;
      }
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float4 gg = ld4(dos + (r0 + g) * HD + d);
          dva[d] += p[g] * gg.x;
          dva[d + 1] += p[g] * gg.y;
          dva[d + 2] += p[g] * gg.z;
          dva[d + 3] += p[g] * gg.w;
          const float4 qq = ld4(qs + (r0 + g) * HD + d);  // already times scale
          dka[d] += dsv[g] * qq.x;
          dka[d + 1] += dsv[g] * qq.y;
          dka[d + 2] += dsv[g] * qq.z;
          dka[d + 3] += dsv[g] * qq.w;
        }
      }
    }
  }

  if (has_key) {
    const size_t at = ((size_t)nh * Tk + j) * HD;
    store_row<T, HD>(dk + at, dka, 1.f);
    store_row<T, HD>(dv + at, dva, 1.f);
  }
}

// ------------------------------------------------------------ backward: dq
// Grid (N*H, ceil(Tq / kRows)); block kRows threads, thread t owns query row i0 + t.
template <typename T, int HD>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ mask,
                        const T* __restrict__ dout, const float* __restrict__ stats,
                        const float* __restrict__ drow, T* __restrict__ dq, int H, int Tq,
                        int Tk, float scale, int causal) {
  constexpr int QS = HD + kPad;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kRows][QS]  scaled query rows
  float* dos = qs + kRows * QS;      // [kRows][QS]
  float* ks = dos + kRows * QS;      // [kTile][HD]
  float* vs = ks + kTile * HD;       // [kTile][HD]
  float* kok = vs + kTile * HD;      // [kTile]

  const int nh = blockIdx.x;
  const int n = nh / H;
  const int NH = gridDim.x;
  const int i0 = blockIdx.y * kRows;
  const int i = i0 + threadIdx.x;
  const bool has_row = i < Tq;
  const T* kh = k + (size_t)nh * Tk * HD;
  const T* vh = v + (size_t)nh * Tk * HD;

  {
    float* const dst[2] = {qs, dos};
    const T* const src[2] = {q + (size_t)nh * Tq * HD, dout + (size_t)nh * Tq * HD};
    const float mul[2] = {scale, 1.f};
    stage_rows<T, HD, kRows>(dst, QS, src, mul, i0, Tq);
  }
  float* const kv_dst[2] = {ks, vs};
  const T* const kv_src[2] = {kh, vh};
  const float kv_mul[2] = {1.f, 1.f};
  const float* qrow = qs + threadIdx.x * QS;
  const float* drow_s = dos + threadIdx.x * QS;
  const size_t at = (size_t)nh * Tq + i;
  const float mi = has_row ? stats[at] : 0.f;
  const float li = has_row ? fmaxf(stats[(size_t)NH * Tq + at], 1e-30f) : 1.f;
  const float Di = has_row ? drow[at] : 0.f;

  float dqa[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dqa[d] = 0.f;

  for (int j0 = 0; j0 < Tk; j0 += kTile) {
    const int jn = min(kTile, Tk - j0);
    __syncthreads();
    stage_rows<T, HD, kTile>(kv_dst, HD, kv_src, kv_mul, j0, Tk);
    if (threadIdx.x < kTile) {
      const int j = j0 + threadIdx.x;
      kok[threadIdx.x] = j < Tk && (mask == nullptr || mask[(size_t)n * Tk + j] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
    if (!has_row) continue;
    // kGroup keys per pass, so each read of the thread's own q and dout rows
    // serves kGroup keys; keys past Tk take no part
    for (int c0 = 0; c0 < jn; c0 += kGroup) {
      float s[kGroup], dp[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) s[g] = dp[g] = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 qq = ld4_own(qrow + d);
        const float4 gg = ld4_own(drow_s + d);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          s[g] += dot4(qq, ld4(ks + (c0 + g) * HD + d));
          dp[g] += dot4(gg, ld4(vs + (c0 + g) * HD + d));
        }
      }
      float dsv[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int c = c0 + g;
        const bool ok = c < jn && kok[c] > 0.f && (!causal || i >= j0 + c);
        const float p = expf((ok ? s[g] : kNegInf) - mi) / li;
        dsv[g] = ok ? p * (dp[g] - Di) : 0.f;
      }
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float4 kk = ld4(ks + (c0 + g) * HD + d);
          dqa[d] += dsv[g] * kk.x;
          dqa[d + 1] += dsv[g] * kk.y;
          dqa[d + 2] += dsv[g] * kk.z;
          dqa[d + 3] += dsv[g] * kk.w;
        }
      }
    }
  }

  if (has_row) store_row<T, HD>(dq + at * HD, dqa, scale);
}

// ------------------------------------------------------------------ launch
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* mask;
  float* stats;
  float* drow;
  void *o, *dq, *dk, *dv;
  int N, H, Tq, Tk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t forward(const Args& a) {
  const size_t smem = sizeof(float) * ((size_t)kRows * (HD + kPad) + 2 * kTile * HD + kTile);
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.N * a.H, (a.Tq + kRows - 1) / kRows);
  kernel<<<grid, kRows, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.mask,
      static_cast<T*>(a.o), a.stats, a.H, a.Tq, a.Tk, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t backward(const Args& a) {
  const long long rows = (long long)a.N * a.H * a.Tq;
  constexpr int kRowdotWarps = 8;
  flash_bwd_rowdot_kernel<T, HD>
      <<<(unsigned)((rows + kRowdotWarps - 1) / kRowdotWarps), kRowdotWarps * kWarp, 0,
         a.stream>>>(static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.drow, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = sizeof(float) * (2 * (size_t)kRows * (HD + kPad) + 2 * kTile * HD +
                                          3 * kTile);
  auto kv = flash_bwd_dkdv_kernel<T, HD>;
  err = allow_smem(kv, smem_kv);
  if (err != cudaSuccess) return err;
  kv<<<dim3(a.N * a.H, (a.Tk + kRows - 1) / kRows), kRows, smem_kv, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.mask,
      static_cast<const T*>(a.dout), a.stats, a.drow, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.Tq, a.Tk, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = sizeof(float) * (2 * (size_t)kRows * (HD + kPad) + 2 * kTile * HD + kTile);
  auto qk = flash_bwd_dq_kernel<T, HD>;
  err = allow_smem(qk, smem_q);
  if (err != cudaSuccess) return err;
  qk<<<dim3(a.N * a.H, (a.Tq + kRows - 1) / kRows), kRows, smem_q, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.mask,
      static_cast<const T*>(a.dout), a.stats, a.drow, static_cast<T*>(a.dq), a.H, a.Tq, a.Tk,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, bool kBackward>
cudaError_t dispatch(int hd, const Args& a) {
  switch (hd) {
#define DL4J_FA_CASE(D) \
  case D:               \
    return kBackward ? backward<T, D>(a) : forward<T, D>(a);
    DL4J_FA_CASE(32)
    DL4J_FA_CASE(64)
    DL4J_FA_CASE(96)
    DL4J_FA_CASE(128)
#undef DL4J_FA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(int N, int H, int Tq, int Tk) {
  return N < 1 || H < 1 || Tq < 1 || Tk < 1 || (long long)N * H > 0x7fffffffLL ||
         (Tq + kRows - 1) / kRows > 65535 || (Tk + kRows - 1) / kRows > 65535;
}

}  // namespace

extern "C" {

// Forward. Launches on `stream` and returns cudaGetLastError() (0 on success).
// Device pointers to contiguous tensors: q and out [N, H, Tq, hd], k and v
// [N, H, Tk, hd], all of one element type (bf16 if is_bf16, else f32); mask
// [N, Tk] f32 or null (no key mask); stats [2, N*H, Tq] f32 receives the row
// max (plane 0) and the row sum (plane 1) for the backward.
int dl4j_flash_attention_fwd(int is_bf16, const void* q, const void* k, const void* v,
                             const void* mask, void* out, void* stats, int N, int H, int Tq,
                             int Tk, int hd, float scale, int causal, void* stream) {
  if (bad_shape(N, H, Tq, Tk)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.o = out;
  a.stats = static_cast<float*>(stats);
  a.N = N;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16, false>(hd, a) : dispatch<float, false>(hd, a));
}

// Backward. Same layouts; out, dout and stats from the forward; drow is f32
// scratch [N*H, Tq]; dq [N, H, Tq, hd] and dk, dv [N, H, Tk, hd] are written.
int dl4j_flash_attention_bwd(int is_bf16, const void* q, const void* k, const void* v,
                             const void* mask, const void* out, const void* dout,
                             const void* stats, void* drow, void* dq, void* dk, void* dv, int N,
                             int H, int Tq, int Tk, int hd, float scale, int causal,
                             void* stream) {
  if (bad_shape(N, H, Tq, Tk)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  a.dout = dout;
  a.stats = const_cast<float*>(static_cast<const float*>(stats));
  a.drow = static_cast<float*>(drow);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.N = N;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16, true>(hd, a) : dispatch<float, true>(hd, a));
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
