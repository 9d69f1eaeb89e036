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
//   s_ij = scale * (q_i . k_j) in f32 (the f32 route scales q_i first), masked
//   scores set to -1e30 (not -inf)
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
// Two routes, chosen by the element type alone in `dispatch` (no switch, no
// environment variable, no fallback; a refused launch returns its error):
//
// bf16, on the tensor cores (namespace tc). This is the training path.
// - mma.sync.m16n8k16 (bf16 in, f32 accumulators) through inline PTX, fed by
//   ldmatrix (.trans for the operand whose reduction runs down its rows: V in
//   P.V, dO and Q in the backward's P^T.dO and dS^T.Q, K in dS.K). A C
//   fragment of m16n8 is the A fragment of m16n8k16, so P and dS go from
//   their f32 accumulators to bf16 operands in registers, never through
//   shared memory. Every accumulator, the scale, the masks and the softmax
//   stay in f32; P and dS are rounded to bf16 only as mma operands.
// - Tiles stay bf16 in shared memory, rows padded by 16 bytes so that
//   ldmatrix is free of bank conflicts, filled by cp.async 16 bytes a thread
//   and double-buffered (commit_group / wait_group): the next tile loads
//   while this one computes. Rows past the end are zero-filled, never read.
// - Forward: blocks of 4 warps, a warp owns 16 query rows of the block's 64;
//   grid (N*H, ceil(Tq/64)). Per 64-key tile: S = Q K^T, then the scale and
//   the masks in f32, the online softmax over the C fragments (quad
//   shuffles), O += P V. Epilogue out = O / max(l, 1e-30) staged through
//   shared memory for 16-byte stores; m and l go to stats as above.
// - Backward (FlashAttention-2, no atomics, so two calls are bit-equal): D =
//   rowsum(dO * O), 4 lanes a row and 16-byte loads; dk/dv, a block per
//   (n*h, 64 keys), walking the query tiles with Q, dO and the rows' m, 1/l
//   and D double-buffered; dq, a block per (n*h, 64 query rows), walking the
//   key tiles. Both recompute S and P from the stats, 32 streamed rows per
//   product. The dk/dv and dq kernels replace the custom_vjp's recompute
//   through blockwise_attention; D feeds both.
// - Causal: tiles wholly above the diagonal are skipped where that changes
//   nothing, i.e. once every row concerned has an attended key (a row with
//   none weighs every key, masked or not). dq skips them always: dS = 0
//   there.
// f32, on the CUDA cores (the kernels above the tc namespace). The f32
// contracts (forward within 2e-5, backward within 1e-4 of max |grad|, card
// vs CPU training parity at 1e-4) cannot be met through TF32, so f32 keeps
// its own kernels:
// - Forward: one block per (n*h, tile of 64 query rows), one thread per query
//   row. K and V stream through shared memory in tiles of 32 keys, widened to
//   f32; each thread loads 16 bytes at a time and starts a batch of loads
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
// Every tile is bounds-checked, so any Tq and Tk >= 1 work; hd is 32, 64, 96
// or 128 on both routes, or 256 on the f32 one (there each thread's rows live
// mostly in local memory: right, and slow), or on the f32 one any multiple of
// 64 past 256 (namespace dp: a thread keeps a 64-column slice of its row, the
// grid's third dimension walks the slices, and every slice's block recomputes
// the scores over the whole head dim: right, and slow). The wrapper
// (ops/flash_attention.py) zero-pads any head dim to the next of these, with
// the softmax scale of the real one: the padded columns add nothing to q.k and
// give zero output and gradient columns, which it slices off.
//
// What bounds it on the H100 at the BERT-base training shape (N=96, H=12,
// T=128, hd=64, bf16): bytes. The forward must read q, k, v and write out,
// 75.5 MB, 22.9 us at 3.35 TB/s; its 4.83 GFLOP would take 4.9 us at the bf16
// dense tensor-core peak. The backward reads q, k, v, out, dout and the row
// statistics and writes dq, dk, dv: 151.6 MB, 45.4 us, against 12.1 GFLOP of
// the five products (16.9 GFLOP with the recomputed S and dP of the dq pass).
// The CUDA-core design of the first port ran all of it in f32 FMAs (67
// TFLOP/s peak, 72 and 180 us at best) out of f32 shared memory, at 0.29 and
// 0.98 ms; the tensor-core route above removes both limits, leaving the
// cp.async pipeline and the mma.sync instruction rate between it and the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the JAX module
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kRows = 64;      // query rows (forward, dq) or keys (dk/dv) per block = threads
constexpr int kTile = 32;      // keys (forward, dq) or query rows (dk/dv) per staged tile
constexpr int kPad = 4;        // row padding of thread-owned shared rows (float4 reads)
constexpr int kGroup = 4;      // tile rows a backward thread takes per pass over its own rows

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
template <int HD, int ROWS, int NS>
__device__ __forceinline__ void stage_rows(float* const (&dst)[NS], int stride,
                                           const float* const (&src)[NS], const float (&mul)[NS],
                                           int r0, int total) {
  constexpr int kVec = 4;                     // elements per chunk
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
        const uint4 u = buf[s][i];
        *reinterpret_cast<float4*>(d) =
            make_float4(__uint_as_float(u.x) * m, __uint_as_float(u.y) * m,
                        __uint_as_float(u.z) * m, __uint_as_float(u.w) * m);
      }
    }
  }
}

// Write a thread's f32 row times `mul` to its 16-byte aligned row, 16 bytes
// per store.
template <int HD>
__device__ __forceinline__ void store_row(float* dst, const float* row, float mul) {
#pragma unroll
  for (int d = 0; d < HD; d += 4)
    *reinterpret_cast<float4*>(dst + d) =
        make_float4(row[d] * mul, row[d + 1] * mul, row[d + 2] * mul, row[d + 3] * mul);
}

// ------------------------------------------------------------------ forward
// Grid (N*H, ceil(Tq / kRows)); block kRows threads.
template <int HD>
__global__ void __launch_bounds__(kRows)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ mask,
                     float* __restrict__ out,
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
  const float* qh = q + (size_t)nh * Tq * HD;
  const float* kh = k + (size_t)nh * Tk * HD;
  const float* vh = v + (size_t)nh * Tk * HD;

  {
    float* const dst[1] = {qs};
    const float* const src[1] = {qh};
    const float mul[1] = {scale};
    stage_rows<HD, kRows>(dst, QS, src, mul, q0, Tq);
  }
  const float* qrow = qs + threadIdx.x * QS;
  float* const kv_dst[2] = {ks, vs};
  const float* const kv_src[2] = {kh, vh};
  const float kv_mul[2] = {1.f, 1.f};

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  for (int j0 = 0; j0 < Tk; j0 += kTile) {
    const int jn = min(kTile, Tk - j0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<HD, kTile>(kv_dst, HD, kv_src, kv_mul, j0, Tk);
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
    store_row<HD>(out + ((size_t)nh * Tq + row) * HD, acc, 1.f);
    const size_t at = (size_t)nh * Tq + row;
    stats[at] = m;
    stats[(size_t)gridDim.x * Tq + at] = l;
  }
}

// ------------------------------------------------------- backward: D = dO.O
// One warp per (n*h, query row); rows = N*H*Tq.
template <int HD>
__global__ void flash_bwd_rowdot_kernel(const float* __restrict__ out,
                                        const float* __restrict__ dout,
                                        float* __restrict__ drow, long long rows) {
  const long long r = (long long)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= rows) return;
  float part = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += kWarp)
    part += out[r * HD + d] * dout[r * HD + d];
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
  if (lane == 0) drow[r] = part;
}

// ------------------------------------------------------ backward: dk and dv
// Grid (N*H, ceil(Tk / kRows)); block kRows threads, thread t owns key j0 + t.
template <int HD>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ mask,
                          const float* __restrict__ dout, const float* __restrict__ stats,
                          const float* __restrict__ drow, float* __restrict__ dk,
                          float* __restrict__ dv, int H, int Tq, int Tk, float scale, int causal) {
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
  const float* qh = q + (size_t)nh * Tq * HD;
  const float* doh = dout + (size_t)nh * Tq * HD;

  {
    float* const dst[2] = {ks, vs};
    const float* const src[2] = {k + (size_t)nh * Tk * HD, v + (size_t)nh * Tk * HD};
    const float mul[2] = {1.f, 1.f};
    stage_rows<HD, kRows>(dst, KS, src, mul, j0, Tk);
  }
  const float* krow = ks + threadIdx.x * KS;
  const float* vrow = vs + threadIdx.x * KS;
  float* const qd_dst[2] = {qs, dos};
  const float* const qd_src[2] = {qh, doh};
  const float qd_mul[2] = {scale, 1.f};

  float dka[HD], dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dka[d] = dva[d] = 0.f;

  for (int i0 = 0; i0 < Tq; i0 += kTile) {
    const int in = min(kTile, Tq - i0);
    __syncthreads();
    stage_rows<HD, kTile>(qd_dst, HD, qd_src, qd_mul, i0, Tq);
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
    store_row<HD>(dk + at, dka, 1.f);
    store_row<HD>(dv + at, dva, 1.f);
  }
}

// ------------------------------------------------------------ backward: dq
// Grid (N*H, ceil(Tq / kRows)); block kRows threads, thread t owns query row i0 + t.
template <int HD>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ mask,
                        const float* __restrict__ dout, const float* __restrict__ stats,
                        const float* __restrict__ drow, float* __restrict__ dq, int H, int Tq,
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
  const float* kh = k + (size_t)nh * Tk * HD;
  const float* vh = v + (size_t)nh * Tk * HD;

  {
    float* const dst[2] = {qs, dos};
    const float* const src[2] = {q + (size_t)nh * Tq * HD, dout + (size_t)nh * Tq * HD};
    const float mul[2] = {scale, 1.f};
    stage_rows<HD, kRows>(dst, QS, src, mul, i0, Tq);
  }
  float* const kv_dst[2] = {ks, vs};
  const float* const kv_src[2] = {kh, vh};
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
    stage_rows<HD, kTile>(kv_dst, HD, kv_src, kv_mul, j0, Tk);
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

  if (has_row) store_row<HD>(dq + at * HD, dqa, scale);
}

// ------------------------------------------- bf16: tensor-core kernels (tc)
// Every bf16 call runs these; f32 calls run the kernels above. Blocks of 4
// warps; warp w owns 16 rows (query rows, or keys in dk/dv) of the block's
// 64. Tiles live in shared memory in bf16 with rows padded by 8 elements (16
// bytes), so the 8 row addresses of an ldmatrix fall in 8 distinct groups of
// 4 banks. The other side's tiles stream through a double buffer filled by
// cp.async (16 bytes a thread, rows past the end zero-filled, never read):
// tile i+1 loads while tile i computes.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows a block owns = rows of a streamed tile
constexpr int kPadH = 8;       // row padding in elements
constexpr int kChunk = 32;     // streamed rows per backward product

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Fragment layout of m16n8 (lane = 4 g + t): c[0], c[1] are row g, columns
// 2t and 2t+1; c[2], c[3] row g+8, the same columns.

// c[16 x 8 NB] += a[16 x HD] . b[8 NB x HD]^T, a and b row-major in shared
// memory with row pitch `pitch` (a: the warp's 16 rows; b: non-transposed
// ldmatrix, two n8 blocks per x4).
template <int NB, int HD>
__device__ __forceinline__ void mma_abt(float (&c)[NB][4], const bf16* a, const bf16* b,
                                        int pitch) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = a + (lane & 15) * pitch + (lane >> 4) * 8;
  const bf16* pb = b + ((lane & 7) + (lane >> 4) * 8) * pitch + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    unsigned af[4];
    ldsm4(af, pa + ks * 16);
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      unsigned r[4];
      ldsm4(r, pb + nb * 8 * pitch + ks * 16);
      mma(c[nb], af, r[0], r[1]);
      mma(c[nb + 1], af, r[2], r[3]);
    }
  }
}

// c[16 x 8 ND] += p[16 x 16 KK] . b[16 KK x 8 ND]: p as A fragments in
// registers, b row-major in shared memory (transposed ldmatrix).
template <int ND, int KK>
__device__ __forceinline__ void mma_ab(float (&c)[ND][4], const unsigned (&p)[KK][4],
                                       const bf16* b, int pitch) {
  const int lane = threadIdx.x & 31;
  const bf16* pb = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      unsigned r[4];
      ldsm4t(r, pb + kk * 16 * pitch + nd * 8);
      mma(c[nd], p[kk], r[0], r[1]);
      mma(c[nd + 1], p[kk], r[2], r[3]);
    }
  }
}

// The m16n8 accumulator layout is the m16n8k16 A layout: C fragments of a
// 16 x 16 KK product, rounded to bf16, are the A fragments of the next one.
template <int KK>
__device__ __forceinline__ void c_to_a(unsigned (&a)[KK][4], const float (&c)[2 * KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Rows [r0, r0 + kRows) of a [total, HD] slab into shared memory (pitch
// HD + kPadH) by cp.async; rows past `total` are zero-filled, not read.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int total) {
  constexpr int kCpr = HD / 8;  // 16-byte chunks per row
  static_assert(kRows * kCpr % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kRows * kCpr / kThreads; ++i) {
    const int c = i * kThreads + (int)threadIdx.x;
    const int r = c / kCpr, col = (c % kCpr) * 8;
    const bool ok = r0 + r < total;
    cp16(dst + r * (HD + kPadH) + col, src + (size_t)(ok ? r0 + r : 0) * HD + col, ok);
  }
}

// The warp's 16 x 8 ND accumulators times mul0 (row g) / mul1 (row g+8) as
// bf16 into its 16 shared rows at `dst`, then 16 bytes a lane to global
// rows [r0, r0 + 16) of `out` below `total`.
template <int HD>
__device__ __forceinline__ void store_warp_rows(bf16* dst, const float (&c)[HD / 8][4], float mul0,
                                                float mul1, bf16* out, int r0, int total) {
  constexpr int P = HD + kPadH;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    *reinterpret_cast<unsigned*>(dst + g * P + nd * 8 + 2 * t) =
        pack(c[nd][0] * mul0, c[nd][1] * mul0);
    *reinterpret_cast<unsigned*>(dst + (g + 8) * P + nd * 8 + 2 * t) =
        pack(c[nd][2] * mul1, c[nd][3] * mul1);
  }
  __syncwarp();
  constexpr int kCpr = HD / 8;
#pragma unroll
  for (int i = 0; i < 16 * kCpr / 32; ++i) {
    const int ch = i * 32 + lane;
    const int r = ch / kCpr, col = (ch % kCpr) * 8;
    if (r0 + r < total)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * HD + col) =
          *reinterpret_cast<const uint4*>(dst + r * P + col);
  }
}

// The first key of sequence n that the key mask attends (0 without a mask,
// INT_MAX if none). Under the causal mask every query row i >= f then has
// an attended key, so its masked keys weigh exactly 0 and a tile of keys all
// above the diagonal can be skipped; a row with none (f > i) weighs every
// key, masked or not, and keeps them all.
__device__ int first_attended(const float* mask, int n, int Tk) {
  if (mask == nullptr) return 0;
  __shared__ int wmin[kThreads / kWarp];
  int f = 0x7fffffff;
  for (int j = threadIdx.x; j < Tk; j += kThreads)
    if (mask[(size_t)n * Tk + j] > 0.f) {
      f = j;
      break;
    }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) f = min(f, __shfl_xor_sync(kFull, f, o));
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = f;
  __syncthreads();
  f = wmin[0];
#pragma unroll
  for (int w = 1; w < kThreads / kWarp; ++w) f = min(f, wmin[w]);
  return f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// key flag of key j: 1 attended, 0 masked (scores -1e30, takes part), -1 past
// Tk (takes no part)
__device__ __forceinline__ float key_flag(const float* mask, int n, int j, int Tk) {
  return j >= Tk ? -1.f : (mask == nullptr || mask[(size_t)n * Tk + j] > 0.f ? 1.f : 0.f);
}

// ------------------------------------------------------------------ forward
// Grid (N*H, ceil(Tq / 64)); 128 threads. Per 64-key tile each warp forms
// S = Q K^T for its 16 rows (16 x 64, f32), scales and masks it in f32,
// runs the online softmax on the C fragments (a row's 4 lanes meet by quad
// shuffles), rounds P to bf16 in registers and accumulates O += P V in f32.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ mask,
                        bf16* __restrict__ out, float* __restrict__ stats, int H, int Tq, int Tk,
                        float scale, int causal) {
  constexpr int P = HD + kPadH, NB = kRows / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);               // [64][P]
  bf16* kvs = qs + kRows * P;                                 // [2][K, V][64][P]
  float* kfs = reinterpret_cast<float*>(kvs + 4 * kRows * P);  // [2][64] key flags

  const int nh = blockIdx.x, n = nh / H, q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;  // the warp's first row
  const int row0 = wrow + g, row1 = row0 + 8;
  const bf16* kh = k + (size_t)nh * Tk * HD;
  const bf16* vh = v + (size_t)nh * Tk * HD;

  int ntiles = (Tk + kRows - 1) / kRows;
  // causal: key tiles wholly above the block's rows weigh 0 once every row
  // has an attended key
  const bool trim = causal && first_attended(mask, n, Tk) <= q0;
  if (trim) ntiles = min(ntiles, (q0 + kRows - 1) / kRows + 1);

  auto prefetch = [&](int tile, int st) {
    load_tile<HD>(kvs + (2 * st) * kRows * P, kh, tile * kRows, Tk);
    load_tile<HD>(kvs + (2 * st + 1) * kRows * P, vh, tile * kRows, Tk);
    if (threadIdx.x < kRows)
      kfs[st * kRows + threadIdx.x] = key_flag(mask, n, tile * kRows + threadIdx.x, Tk);
  };
  load_tile<HD>(qs, q + (size_t)nh * Tq * HD, q0, Tq);
  prefetch(0, 0);
  cp_commit();

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's part

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      prefetch(it + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int j0 = it * kRows;
    if (!(trim && j0 > wrow + 15)) {
      const bf16* ks = kvs + (2 * st) * kRows * P;
      const float* kf = kfs + st * kRows;
      float s[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b) s[b][0] = s[b][1] = s[b][2] = s[b][3] = 0.f;
      mma_abt<NB, HD>(s, qs + warp * 16 * P, ks, P);
      float tmax0 = kNegInf, tmax1 = kNegInf;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = b * 8 + 2 * t + e;
          const float f = kf[col];
          const int key = j0 + col;
          const bool ok0 = f > 0.f && (!causal || row0 >= key);
          const bool ok1 = f > 0.f && (!causal || row1 >= key);
          s[b][e] = ok0 ? s[b][e] * scale : kNegInf;
          s[b][2 + e] = ok1 ? s[b][2 + e] * scale : kNegInf;
          if (f >= 0.f) {
            tmax0 = fmaxf(tmax0, s[b][e]);
            tmax1 = fmaxf(tmax1, s[b][2 + e]);
          }
        }
      }
      const float mn0 = fmaxf(m0, quad_max(tmax0)), mn1 = fmaxf(m1, quad_max(tmax1));
      const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // masked keys in range keep exp(-1e30 - m) (1 while the row has
          // seen only masked keys); keys past Tk take no part
          const bool in = kf[b * 8 + 2 * t + e] >= 0.f;
          s[b][e] = in ? __expf(s[b][e] - mn0) : 0.f;
          s[b][2 + e] = in ? __expf(s[b][2 + e] - mn1) : 0.f;
          ps0 += s[b][e];
          ps1 += s[b][2 + e];
        }
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][0] *= al0;
        o[d][1] *= al0;
        o[d][2] *= al1;
        o[d][3] *= al1;
      }
      unsigned pa[NB / 2][4];
      c_to_a<NB / 2>(pa, s);
      mma_ab<ND, NB / 2>(o, pa, kvs + (2 * st + 1) * kRows * P, P);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // the warp's own Q rows (read only by it) stage its output
  store_warp_rows<HD>(qs + warp * 16 * P, o, 1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f),
                      out + (size_t)nh * Tq * HD, wrow, Tq);
  if (t == 0) {
    const size_t plane = (size_t)gridDim.x * Tq;
    if (row0 < Tq) {
      stats[(size_t)nh * Tq + row0] = m0;
      stats[plane + (size_t)nh * Tq + row0] = l0;
    }
    if (row1 < Tq) {
      stats[(size_t)nh * Tq + row1] = m1;
      stats[plane + (size_t)nh * Tq + row1] = l1;
    }
  }
}

// ------------------------------------------------------- backward: D = dO.O
// 4 lanes per row, 16 bytes a load (flash_bwd_rowdot_kernel, the f32
// route's, loads 2 bytes a lane); rows = N*H*Tq.
template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_rowdot_tc_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                               float* __restrict__ drow, long long rows) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int part = threadIdx.x & 3;
  float acc = 0.f;
  if (r < rows) {
    const uint4* o = reinterpret_cast<const uint4*>(out + r * HD);
    const uint4* d = reinterpret_cast<const uint4*>(dout + r * HD);
#pragma unroll
    for (int c = part; c < HD / 8; c += 4) {
      const uint4 a = __ldg(o + c), b = __ldg(d + c);
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(ha[e]), y = __bfloat1622float2(hb[e]);
        acc += x.x * y.x + x.y * y.y;
      }
    }
  }
  acc = quad_sum(acc);  // every lane takes part, rows past the end with 0
  if (part == 0 && r < rows) drow[r] = acc;
}

// ------------------------------------------------------ backward: dk and dv
// Grid (N*H, ceil(Tk / 64)); 128 threads, warp w owns keys j0 + 16w ..
// j0 + 16w + 15. Walks the query tiles (Q, dO and the rows' m, 1/l and D
// double-buffered), 32 query rows per product:
//   S^T = K Q^T, P^T = exp(scale S^T - m) / l, dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T (dP^T - D) (0 where masked), dK += dS^T Q.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ mask,
                             const bf16* __restrict__ dout, const float* __restrict__ stats,
                             const float* __restrict__ drow, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int H, int Tq, int Tk, float scale,
                             int causal) {
  constexpr int P = HD + kPadH, NC = kChunk / 8, KC = kChunk / 16, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);                // [64][P]
  bf16* vs = ks + kRows * P;                                   // [64][P]
  bf16* qds = vs + kRows * P;                                  // [2][Q, dO][64][P]
  float* rows = reinterpret_cast<float*>(qds + 4 * kRows * P);  // [2][m, 1/l, D][64]

  const int nh = blockIdx.x, n = nh / H, NH = gridDim.x, j0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wkey = j0 + warp * 16;
  const int key0 = wkey + g, key1 = key0 + 8;
  const bool kok0 = key_flag(mask, n, key0, Tk) > 0.f;
  const bool kok1 = key_flag(mask, n, key1, Tk) > 0.f;
  const bf16* qh = q + (size_t)nh * Tq * HD;
  const bf16* doh = dout + (size_t)nh * Tq * HD;

  const int ntiles = (Tq + kRows - 1) / kRows;
  // causal: a query tile wholly below the block's keys (i < j0 for all its
  // rows) gives P = 0 and dS = 0 once its rows have an attended key
  const int f = causal ? first_attended(mask, n, Tk) : 0;
  auto needed = [&](int tile) {
    const int i0 = tile * kRows;
    return !(causal && i0 + kRows - 1 < j0 && i0 >= f);
  };
  auto next = [&](int tile) {
    while (tile < ntiles && !needed(tile)) ++tile;
    return tile;
  };
  auto prefetch = [&](int tile, int st) {
    const int i0 = tile * kRows;
    load_tile<HD>(qds + (2 * st) * kRows * P, qh, i0, Tq);
    load_tile<HD>(qds + (2 * st + 1) * kRows * P, doh, i0, Tq);
    if (threadIdx.x < kRows) {
      const int i = i0 + threadIdx.x;
      const size_t at = (size_t)nh * Tq + i;
      float* r = rows + st * 3 * kRows + threadIdx.x;
      r[0] = i < Tq ? stats[at] : 0.f;
      r[kRows] = i < Tq ? 1.f / fmaxf(stats[(size_t)NH * Tq + at], 1e-30f) : 0.f;
      r[2 * kRows] = i < Tq ? drow[at] : 0.f;
    }
  };
  load_tile<HD>(ks, k + (size_t)nh * Tk * HD, j0, Tk);
  load_tile<HD>(vs, v + (size_t)nh * Tk * HD, j0, Tk);
  int cur = next(0), st = 0;
  if (cur < ntiles) prefetch(cur, 0);
  cp_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  while (cur < ntiles) {
    const int nxt = next(cur + 1);
    if (nxt < ntiles) {
      prefetch(nxt, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int i0 = cur * kRows;
    const bf16* qs = qds + (2 * st) * kRows * P;
    const bf16* dos = qds + (2 * st + 1) * kRows * P;
    const float* r = rows + st * 3 * kRows;
#pragma unroll 1
    for (int c0 = 0; c0 < kRows; c0 += kChunk) {
      if (causal && i0 + c0 + kChunk - 1 < wkey && i0 + c0 >= f) continue;
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int b = 0; b < NC; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[b][e] = dp[b][e] = 0.f;
      mma_abt<NC, HD>(s, ks + warp * 16 * P, qs + c0 * P, P);
      mma_abt<NC, HD>(dp, vs + warp * 16 * P, dos + c0 * P, P);
#pragma unroll
      for (int b = 0; b < NC; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + b * 8 + 2 * t + (e & 1);
          const int i = i0 + col;
          const bool ok = (e < 2 ? kok0 : kok1) && (!causal || i >= (e < 2 ? key0 : key1));
          // rows past Tq have 1/l = 0, so P = 0 and dS = 0
          const float p = __expf((ok ? s[b][e] * scale : kNegInf) - r[col]) * r[kRows + col];
          s[b][e] = p;
          dp[b][e] = ok ? p * (dp[b][e] - r[2 * kRows + col]) : 0.f;
        }
      }
      unsigned pa[KC][4];
      c_to_a<KC>(pa, s);
      mma_ab<ND, KC>(dva, pa, dos + c0 * P, P);
      c_to_a<KC>(pa, dp);
      mma_ab<ND, KC>(dka, pa, qs + c0 * P, P);
    }
    __syncthreads();  // the stage is consumed before it is refilled
    cur = nxt;
    st ^= 1;
  }
  cp_wait<0>();  // nothing in flight when no tile was needed
  __syncthreads();

  // the warp's own K and V rows (read only by it) stage dk and dv
  store_warp_rows<HD>(ks + warp * 16 * P, dka, scale, scale, dk + (size_t)nh * Tk * HD, wkey, Tk);
  store_warp_rows<HD>(vs + warp * 16 * P, dva, 1.f, 1.f, dv + (size_t)nh * Tk * HD, wkey, Tk);
}

// ------------------------------------------------------------ backward: dq
// Grid (N*H, ceil(Tq / 64)); 128 threads, warp w owns query rows q0 + 16w ..
// q0 + 16w + 15. Walks the key tiles (K, V and the key flags double-
// buffered), 32 keys per product: S = Q K^T, dP = dO V^T,
// dS = P (dP - D) (0 where masked or past Tk), dQ += dS K.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           const bf16* __restrict__ dout, const float* __restrict__ stats,
                           const float* __restrict__ drow, bf16* __restrict__ dq, int H, int Tq,
                           int Tk, float scale, int causal) {
  constexpr int P = HD + kPadH, NC = kChunk / 8, KC = kChunk / 16, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);               // [64][P]
  bf16* dos = qs + kRows * P;                                 // [64][P]
  bf16* kvs = dos + kRows * P;                                // [2][K, V][64][P]
  float* kfs = reinterpret_cast<float*>(kvs + 4 * kRows * P);  // [2][64]

  const int nh = blockIdx.x, n = nh / H, NH = gridDim.x, q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;
  const int row0 = wrow + g, row1 = row0 + 8;
  const bf16* kh = k + (size_t)nh * Tk * HD;
  const bf16* vh = v + (size_t)nh * Tk * HD;
  float mr[2], rl[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h ? row1 : row0;
    const size_t at = (size_t)nh * Tq + i;
    mr[h] = i < Tq ? stats[at] : 0.f;
    rl[h] = i < Tq ? 1.f / fmaxf(stats[(size_t)NH * Tq + at], 1e-30f) : 0.f;
    dr[h] = i < Tq ? drow[at] : 0.f;
  }

  int ntiles = (Tk + kRows - 1) / kRows;
  // causal: keys above the block's rows are masked for all of them, so dS = 0
  if (causal) ntiles = min(ntiles, (q0 + kRows - 1) / kRows + 1);

  auto prefetch = [&](int tile, int st) {
    load_tile<HD>(kvs + (2 * st) * kRows * P, kh, tile * kRows, Tk);
    load_tile<HD>(kvs + (2 * st + 1) * kRows * P, vh, tile * kRows, Tk);
    if (threadIdx.x < kRows)
      kfs[st * kRows + threadIdx.x] = key_flag(mask, n, tile * kRows + threadIdx.x, Tk);
  };
  load_tile<HD>(qs, q + (size_t)nh * Tq * HD, q0, Tq);
  load_tile<HD>(dos, dout + (size_t)nh * Tq * HD, q0, Tq);
  prefetch(0, 0);
  cp_commit();

  float dqa[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      prefetch(it + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int j0 = it * kRows;
    const bf16* ks = kvs + (2 * st) * kRows * P;
    const bf16* vs = kvs + (2 * st + 1) * kRows * P;
    const float* kf = kfs + st * kRows;
#pragma unroll 1
    for (int c0 = 0; c0 < kRows; c0 += kChunk) {
      if (causal && j0 + c0 > wrow + 15) continue;
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int b = 0; b < NC; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[b][e] = dp[b][e] = 0.f;
      mma_abt<NC, HD>(s, qs + warp * 16 * P, ks + c0 * P, P);
      mma_abt<NC, HD>(dp, dos + warp * 16 * P, vs + c0 * P, P);
#pragma unroll
      for (int b = 0; b < NC; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + b * 8 + 2 * t + (e & 1);
          const int h = e >> 1;
          const bool ok = kf[col] > 0.f && (!causal || (h ? row1 : row0) >= j0 + col);
          const float p = __expf(s[b][e] * scale - mr[h]) * rl[h];
          dp[b][e] = ok ? p * (dp[b][e] - dr[h]) : 0.f;
        }
      }
      unsigned da[KC][4];
      c_to_a<KC>(da, dp);
      mma_ab<ND, KC>(dqa, da, ks + c0 * P, P);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  store_warp_rows<HD>(qs + warp * 16 * P, dqa, scale, scale, dq + (size_t)nh * Tq * HD, wrow, Tq);
}

}  // namespace tc

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

namespace tc {

template <int HD>
constexpr size_t smem_bytes(int tiles, int floats) {
  return (size_t)tiles * kRows * (HD + kPadH) * sizeof(bf16) + (size_t)floats * sizeof(float);
}

template <int HD>
cudaError_t forward(const Args& a) {
  const size_t smem = smem_bytes<HD>(5, 2 * kRows);  // Q, 2 x (K, V), 2 x key flags
  auto kernel = flash_fwd_tc_kernel<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.N * a.H, (a.Tq + kRows - 1) / kRows), kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.mask, static_cast<bf16*>(a.o), a.stats, a.H, a.Tq, a.Tk,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t backward(const Args& a) {
  const long long rows = (long long)a.N * a.H * a.Tq;
  constexpr int kRowdotRows = 64;  // rows per 256-thread block
  flash_bwd_rowdot_tc_kernel<HD>
      <<<(unsigned)((rows + kRowdotRows - 1) / kRowdotRows), 4 * kRowdotRows, 0, a.stream>>>(
          static_cast<const bf16*>(a.out), static_cast<const bf16*>(a.dout), a.drow, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = smem_bytes<HD>(6, 6 * kRows);  // K, V, 2 x (Q, dO), 2 x (m, 1/l, D)
  auto kv = flash_bwd_dkdv_tc_kernel<HD>;
  err = allow_smem(kv, smem_kv);
  if (err != cudaSuccess) return err;
  kv<<<dim3(a.N * a.H, (a.Tk + kRows - 1) / kRows), kThreads, smem_kv, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.mask, static_cast<const bf16*>(a.dout), a.stats, a.drow,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.Tq, a.Tk, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = smem_bytes<HD>(6, 2 * kRows);  // Q, dO, 2 x (K, V), 2 x key flags
  auto qk = flash_bwd_dq_tc_kernel<HD>;
  err = allow_smem(qk, smem_q);
  if (err != cudaSuccess) return err;
  qk<<<dim3(a.N * a.H, (a.Tq + kRows - 1) / kRows), kThreads, smem_q, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.mask, static_cast<const bf16*>(a.dout), a.stats, a.drow,
      static_cast<bf16*>(a.dq), a.H, a.Tq, a.Tk, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace tc

// f32: the CUDA-core kernels
template <int HD>
cudaError_t forward(const Args& a) {
  const size_t smem = sizeof(float) * ((size_t)kRows * (HD + kPad) + 2 * kTile * HD + kTile);
  auto kernel = flash_fwd_kernel<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.N * a.H, (a.Tq + kRows - 1) / kRows);
  kernel<<<grid, kRows, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.o), a.stats, a.H, a.Tq, a.Tk,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t backward(const Args& a) {
  const long long rows = (long long)a.N * a.H * a.Tq;
  constexpr int kRowdotWarps = 8;
  flash_bwd_rowdot_kernel<HD>
      <<<(unsigned)((rows + kRowdotWarps - 1) / kRowdotWarps), kRowdotWarps * kWarp, 0,
         a.stream>>>(static_cast<const float*>(a.out), static_cast<const float*>(a.dout), a.drow,
                     rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = sizeof(float) * (2 * (size_t)kRows * (HD + kPad) + 2 * kTile * HD +
                                          3 * kTile);
  auto kv = flash_bwd_dkdv_kernel<HD>;
  err = allow_smem(kv, smem_kv);
  if (err != cudaSuccess) return err;
  kv<<<dim3(a.N * a.H, (a.Tk + kRows - 1) / kRows), kRows, smem_kv, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<const float*>(a.dout), a.stats, a.drow,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.Tq, a.Tk, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = sizeof(float) * (2 * (size_t)kRows * (HD + kPad) + 2 * kTile * HD + kTile);
  auto qk = flash_bwd_dq_kernel<HD>;
  err = allow_smem(qk, smem_q);
  if (err != cudaSuccess) return err;
  qk<<<dim3(a.N * a.H, (a.Tq + kRows - 1) / kRows), kRows, smem_q, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<const float*>(a.dout), a.stats, a.drow,
      static_cast<float*>(a.dq), a.H, a.Tq, a.Tk, a.scale, a.causal);
  return cudaGetLastError();
}

// f32 past the wide tile (namespace dp, "deep"): any head dim that is a
// multiple of kDc. A thread keeps kDc columns of its output row (out, dk and
// dv, or dq) in registers, and the grid's third dimension walks the head dim's
// kDc-column slices; the scores q.k and dO.v go over the whole head dim, kDc
// columns at a time staged through shared memory, and are recomputed by every
// slice's block. Right and simple; each slice repeats the score work.
namespace dp {

constexpr int kDc = 64;    // head-dim columns per slice and per staged chunk
constexpr int kT = 16;     // keys (forward, dq) or query rows (dk/dv) per tile
constexpr int kQs = kDc + kPad;

// rows [r0, r0 + ROWS) of src [total, hd], columns [c0, c0 + kDc), times
// mul, into dst (row pitch `pitch`); rows past `total` are zero
template <int ROWS>
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src, int hd, int c0,
                                      int r0, int total, float mul) {
  constexpr int kCpr = kDc / 4;
  for (int c = threadIdx.x; c < ROWS * kCpr; c += kRows) {
    const int rr = c / kCpr, cc = (c % kCpr) * 4, g = r0 + rr;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < total) v = __ldg(reinterpret_cast<const float4*>(src + (size_t)g * hd + c0 + cc));
    *reinterpret_cast<float4*>(dst + rr * pitch + cc) =
        make_float4(v.x * mul, v.y * mul, v.z * mul, v.w * mul);
  }
}

// Forward: grid (N*H, ceil(Tq / kRows), hd / kDc); block kRows threads, one
// per query row; block z writes output columns [z kDc, z kDc + kDc), and z = 0
// the row statistics.
__global__ void __launch_bounds__(kRows)
    flash_fwd_deep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ mask,
                          float* __restrict__ out, float* __restrict__ stats, int H, int Tq, int Tk,
                          int hd, float scale, int causal) {
  __shared__ __align__(16) float qs[kRows * kQs];
  __shared__ __align__(16) float ks[kT * kDc];
  __shared__ __align__(16) float vs[kT * kDc];
  __shared__ float kok[kT];
  const int nh = blockIdx.x, n = nh / H, q0 = blockIdx.y * kRows, z = blockIdx.z;
  const int row = q0 + threadIdx.x;
  const bool has_row = row < Tq;
  const float* qh = q + (size_t)nh * Tq * hd;
  const float* kh = k + (size_t)nh * Tk * hd;
  const float* vh = v + (size_t)nh * Tk * hd;
  const float* qrow = qs + threadIdx.x * kQs;
  float acc[kDc];
#pragma unroll
  for (int d = 0; d < kDc; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += kT) {
    const int jn = min(kT, Tk - j0);
    float s[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kDc) {
      __syncthreads();
      stage<kRows>(qs, kQs, qh, hd, c0, q0, Tq, scale);
      stage<kT>(ks, kDc, kh, hd, c0, j0, Tk, 1.f);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kDc; d += 4) {
        const float4 qv = ld4(qrow + d);
#pragma unroll
        for (int j = 0; j < kT; ++j) s[j] += dot4(qv, ld4(ks + j * kDc + d));
      }
    }
    __syncthreads();
    stage<kT>(vs, kDc, vh, hd, z * kDc, j0, Tk, 1.f);
    if (threadIdx.x < kT) {
      const int j = j0 + threadIdx.x;
      kok[threadIdx.x] = j < Tk && (mask == nullptr || mask[(size_t)n * Tk + j] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
    if (!has_row) continue;
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const bool ok = kok[j] > 0.f && (!causal || row >= j0 + j);
      s[j] = ok ? s[j] : kNegInf;
      if (j < jn) tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      s[j] = j < jn ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < kDc; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const float p = s[j];
#pragma unroll
      for (int d = 0; d < kDc; d += 4) {
        const float4 vv = ld4(vs + j * kDc + d);
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
    for (int d = 0; d < kDc; ++d) acc[d] = acc[d] / den;
    store_row<kDc>(out + ((size_t)nh * Tq + row) * hd + z * kDc, acc, 1.f);
    if (z == 0) {
      const size_t at = (size_t)nh * Tq + row;
      stats[at] = m;
      stats[(size_t)gridDim.x * Tq + at] = l;
    }
  }
}

// D = rowsum(dO * O): one warp per (n*h, query row)
__global__ void flash_bwd_rowdot_deep_kernel(const float* __restrict__ out,
                                             const float* __restrict__ dout,
                                             float* __restrict__ drow, long long rows, int hd) {
  const long long r = (long long)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= rows) return;
  float part = 0.f;
  for (int d = lane; d < hd; d += kWarp) part += out[r * hd + d] * dout[r * hd + d];
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
  if (lane == 0) drow[r] = part;
}

// dk and dv: grid (N*H, ceil(Tk / kRows), hd / kDc); thread t owns key
// j0 + t and columns [z kDc, z kDc + kDc) of its dk and dv rows.
__global__ void __launch_bounds__(kRows)
    flash_bwd_dkdv_deep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ mask,
                               const float* __restrict__ dout, const float* __restrict__ stats,
                               const float* __restrict__ drow, float* __restrict__ dk,
                               float* __restrict__ dv, int H, int Tq, int Tk, int hd, float scale,
                               int causal) {
  __shared__ __align__(16) float ks[kRows * kQs];
  __shared__ __align__(16) float vs[kRows * kQs];
  __shared__ __align__(16) float qs[kT * kDc];   // scaled query rows
  __shared__ __align__(16) float dos[kT * kDc];
  __shared__ float ms[kT], ls[kT], ds_[kT];
  const int nh = blockIdx.x, n = nh / H, NH = gridDim.x, j0 = blockIdx.y * kRows, z = blockIdx.z;
  const int j = j0 + threadIdx.x;
  const bool has_key = j < Tk;
  const bool key_ok = has_key && (mask == nullptr || mask[(size_t)n * Tk + j] > 0.f);
  const float* qh = q + (size_t)nh * Tq * hd;
  const float* doh = dout + (size_t)nh * Tq * hd;
  const float* kh = k + (size_t)nh * Tk * hd;
  const float* vh = v + (size_t)nh * Tk * hd;
  const float* krow = ks + threadIdx.x * kQs;
  const float* vrow = vs + threadIdx.x * kQs;
  float dka[kDc], dva[kDc];
#pragma unroll
  for (int d = 0; d < kDc; ++d) dka[d] = dva[d] = 0.f;
  for (int i0 = 0; i0 < Tq; i0 += kT) {
    const int in = min(kT, Tq - i0);
    float s[kT], dp[kT];
#pragma unroll
    for (int r = 0; r < kT; ++r) s[r] = dp[r] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kDc) {
      __syncthreads();
      stage<kRows>(ks, kQs, kh, hd, c0, j0, Tk, 1.f);
      stage<kRows>(vs, kQs, vh, hd, c0, j0, Tk, 1.f);
      stage<kT>(qs, kDc, qh, hd, c0, i0, Tq, scale);
      stage<kT>(dos, kDc, doh, hd, c0, i0, Tq, 1.f);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kDc; d += 4) {
        const float4 kk = ld4_own(krow + d);
        const float4 vv = ld4_own(vrow + d);
#pragma unroll
        for (int r = 0; r < kT; ++r) {
          s[r] += dot4(ld4(qs + r * kDc + d), kk);
          dp[r] += dot4(ld4(dos + r * kDc + d), vv);
        }
      }
    }
    __syncthreads();
    stage<kT>(qs, kDc, qh, hd, z * kDc, i0, Tq, scale);
    stage<kT>(dos, kDc, doh, hd, z * kDc, i0, Tq, 1.f);
    if (threadIdx.x < kT) {
      const int i = i0 + threadIdx.x;
      const size_t at = (size_t)nh * Tq + i;
      ms[threadIdx.x] = i < Tq ? stats[at] : 0.f;
      ls[threadIdx.x] = i < Tq ? fmaxf(stats[(size_t)NH * Tq + at], 1e-30f) : 1.f;
      ds_[threadIdx.x] = i < Tq ? drow[at] : 0.f;
    }
    __syncthreads();
    if (!has_key) continue;
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      const bool ok = key_ok && (!causal || i0 + r >= j);
      const float p = r < in ? expf((ok ? s[r] : kNegInf) - ms[r]) / ls[r] : 0.f;
      const float dsv = ok ? p * (dp[r] - ds_[r]) : 0.f;
#pragma unroll
      for (int d = 0; d < kDc; d += 4) {
        const float4 gg = ld4(dos + r * kDc + d);
        dva[d] += p * gg.x;
        dva[d + 1] += p * gg.y;
        dva[d + 2] += p * gg.z;
        dva[d + 3] += p * gg.w;
        const float4 qq = ld4(qs + r * kDc + d);  // already times scale
        dka[d] += dsv * qq.x;
        dka[d + 1] += dsv * qq.y;
        dka[d + 2] += dsv * qq.z;
        dka[d + 3] += dsv * qq.w;
      }
    }
  }
  if (has_key) {
    const size_t at = ((size_t)nh * Tk + j) * hd + z * kDc;
    store_row<kDc>(dk + at, dka, 1.f);
    store_row<kDc>(dv + at, dva, 1.f);
  }
}

// dq: grid (N*H, ceil(Tq / kRows), hd / kDc); thread t owns query row
// i0 + t and columns [z kDc, z kDc + kDc) of its dq row.
__global__ void __launch_bounds__(kRows)
    flash_bwd_dq_deep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ mask,
                             const float* __restrict__ dout, const float* __restrict__ stats,
                             const float* __restrict__ drow, float* __restrict__ dq, int H, int Tq,
                             int Tk, int hd, float scale, int causal) {
  __shared__ __align__(16) float qs[kRows * kQs];   // scaled query rows
  __shared__ __align__(16) float dos[kRows * kQs];
  __shared__ __align__(16) float ks[kT * kDc];
  __shared__ __align__(16) float vs[kT * kDc];
  __shared__ float kok[kT];
  const int nh = blockIdx.x, n = nh / H, NH = gridDim.x, i0 = blockIdx.y * kRows, z = blockIdx.z;
  const int i = i0 + threadIdx.x;
  const bool has_row = i < Tq;
  const float* qh = q + (size_t)nh * Tq * hd;
  const float* doh = dout + (size_t)nh * Tq * hd;
  const float* kh = k + (size_t)nh * Tk * hd;
  const float* vh = v + (size_t)nh * Tk * hd;
  const float* qrow = qs + threadIdx.x * kQs;
  const float* drow_s = dos + threadIdx.x * kQs;
  const size_t at = (size_t)nh * Tq + i;
  const float mi = has_row ? stats[at] : 0.f;
  const float li = has_row ? fmaxf(stats[(size_t)NH * Tq + at], 1e-30f) : 1.f;
  const float Di = has_row ? drow[at] : 0.f;
  float dqa[kDc];
#pragma unroll
  for (int d = 0; d < kDc; ++d) dqa[d] = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += kT) {
    const int jn = min(kT, Tk - j0);
    float s[kT], dp[kT];
#pragma unroll
    for (int c = 0; c < kT; ++c) s[c] = dp[c] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kDc) {
      __syncthreads();
      stage<kRows>(qs, kQs, qh, hd, c0, i0, Tq, scale);
      stage<kRows>(dos, kQs, doh, hd, c0, i0, Tq, 1.f);
      stage<kT>(ks, kDc, kh, hd, c0, j0, Tk, 1.f);
      stage<kT>(vs, kDc, vh, hd, c0, j0, Tk, 1.f);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kDc; d += 4) {
        const float4 qq = ld4_own(qrow + d);
        const float4 gg = ld4_own(drow_s + d);
#pragma unroll
        for (int c = 0; c < kT; ++c) {
          s[c] += dot4(qq, ld4(ks + c * kDc + d));
          dp[c] += dot4(gg, ld4(vs + c * kDc + d));
        }
      }
    }
    __syncthreads();
    stage<kT>(ks, kDc, kh, hd, z * kDc, j0, Tk, 1.f);
    if (threadIdx.x < kT) {
      const int j = j0 + threadIdx.x;
      kok[threadIdx.x] = j < Tk && (mask == nullptr || mask[(size_t)n * Tk + j] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
    if (!has_row) continue;
#pragma unroll
    for (int c = 0; c < kT; ++c) {
      const bool ok = c < jn && kok[c] > 0.f && (!causal || i >= j0 + c);
      const float p = expf((ok ? s[c] : kNegInf) - mi) / li;
      const float dsv = ok ? p * (dp[c] - Di) : 0.f;
#pragma unroll
      for (int d = 0; d < kDc; d += 4) {
        const float4 kk = ld4(ks + c * kDc + d);
        dqa[d] += dsv * kk.x;
        dqa[d + 1] += dsv * kk.y;
        dqa[d + 2] += dsv * kk.z;
        dqa[d + 3] += dsv * kk.w;
      }
    }
  }
  if (has_row) store_row<kDc>(dq + at * hd + z * kDc, dqa, scale);
}

cudaError_t forward(const Args& a, int hd) {
  const dim3 grid(a.N * a.H, (a.Tq + kRows - 1) / kRows, hd / kDc);
  flash_fwd_deep_kernel<<<grid, kRows, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.o), a.stats, a.H, a.Tq, a.Tk,
      hd, a.scale, a.causal);
  return cudaGetLastError();
}

cudaError_t backward(const Args& a, int hd) {
  const long long rows = (long long)a.N * a.H * a.Tq;
  constexpr int kRowdotWarps = 8;
  flash_bwd_rowdot_deep_kernel<<<(unsigned)((rows + kRowdotWarps - 1) / kRowdotWarps),
                                 kRowdotWarps * kWarp, 0, a.stream>>>(
      static_cast<const float*>(a.out), static_cast<const float*>(a.dout), a.drow, rows, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_deep_kernel<<<dim3(a.N * a.H, (a.Tk + kRows - 1) / kRows, hd / kDc), kRows, 0,
                               a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<const float*>(a.dout), a.stats, a.drow,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.Tq, a.Tk, hd, a.scale,
      a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_deep_kernel<<<dim3(a.N * a.H, (a.Tq + kRows - 1) / kRows, hd / kDc), kRows, 0,
                             a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<const float*>(a.dout), a.stats, a.drow,
      static_cast<float*>(a.dq), a.H, a.Tq, a.Tk, hd, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace dp

// The element type alone picks the route: bf16 the tensor-core kernels, f32
// the CUDA-core ones. Both are kernels; neither stands in for the other.
template <bool kBackward>
cudaError_t dispatch(int is_bf16, int hd, const Args& a) {
  switch (hd) {
#define DL4J_FA_CASE(D)                                                       \
  case D:                                                                     \
    if (is_bf16) return kBackward ? tc::backward<D>(a) : tc::forward<D>(a); \
    return kBackward ? backward<D>(a) : forward<D>(a);
    DL4J_FA_CASE(32)
    DL4J_FA_CASE(64)
    DL4J_FA_CASE(96)
    DL4J_FA_CASE(128)
#undef DL4J_FA_CASE
    case 256:  // the wide tile, f32 only: the wrapper widens bf16 and f16
      if (is_bf16) return cudaErrorInvalidValue;
      return kBackward ? backward<256>(a) : forward<256>(a);
    default:  // past the wide tile: f32, a multiple of dp::kDc
      if (is_bf16 || hd < 256 || hd % dp::kDc != 0 || hd / dp::kDc > 65535)
        return cudaErrorInvalidValue;
      return kBackward ? dp::backward(a, hd) : dp::forward(a, hd);
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
  return (int)dispatch<false>(is_bf16, hd, a);
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
  return (int)dispatch<true>(is_bf16, hd, a);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
