// LSTM recurrence, forward and backward, written by hand for Hopper (sm_90a)
// and bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel in deeplearning4j_tpu/ops/lstm_pallas.py
// (_run / _kernel, pl.pallas_call at :123). That kernel has no backward of its
// own: its custom_vjp runs a reverse-time lax.scan that recomputes the gates
// (_recurrence_bwd, :167-217). Here the backward is a kernel too.
//
// What it computes, for x_proj [T, N, 4H] (the input projection plus bias, gate
// order i, f, g, o), w_hh [H, 4H] and h0, c0 [N, H], all of one element type
// (f32 or bf16), with h and c carried in f32:
//   a_t = f32(h_{t-1}) @ w_hh + x_proj[t]      (h rounded to the storage type
//   i, f, o = sigmoid(a_i, a_f, a_o)            first, as the Pallas kernel
//   g = tanh(a_g)                               casts h to w_hh's dtype)
//   c_t = f * c_{t-1} + i * g,  h_t = o * tanh(c_t)
//   ys[t] = h_t, cs[t] = c_t (optional, the cell stream for the backward),
//   hT = h_{T-1}, cT = c_{T-1}, all stored in the storage type.
// Backward, for the upstream dys [T, N, H], dhT and dcT, in f32 throughout:
//   dh += dys[t]; gates recomputed from h_{t-1} and x_proj[t];
//   do = dh tanh(c_t); dc += dh o (1 - tanh^2 c_t);
//   da_t = [dc g i(1-i), dc c_{t-1} f(1-f), dc i (1-g^2), do o(1-o)]
//   dh_{t-1} = da_t @ w_hh^T,  dc_{t-1} = dc f,
// writing da_t in f32 (and d x_proj[t] = da_t in the storage type, when that is
// bf16) and, after the last step, dh0 and dc0. The weight gradient
// sum_t f32(h_{t-1})^T da_t is one f32 matrix product over all T*N rows of the
// f32 da, taken by the caller after the kernel, as _recurrence_bwd sums it in
// f32 and casts only at the end.
//
// Design (simple and correct first; no tensor cores, no TMA, no clusters):
// - One persistent launch per call. The TPU grid's sequential T axis becomes a
//   loop inside every block, and the steps are separated by a grid-wide
//   barrier. The launch is cooperative (cudaLaunchCooperativeKernel), so the
//   runtime refuses a grid whose blocks cannot all be resident at once instead
//   of letting the barrier wait forever; the grid is sized from the occupancy
//   calculator. The barrier is a counter and a generation word in global
//   memory, with the fences of cooperative groups' grid sync, and it traps
//   (the launch fails) if a wait lasts ten seconds.
// - A block owns 8 hidden units (all four gate columns of each) and a tile of
//   32 * RB batch rows; a thread owns one unit of RB rows and keeps their c (and
//   in the backward dh and dc) in registers for all T, so the cell update never
//   leaves the thread. The block's columns of w_hh ([H, 32], widened to f32)
//   stay in shared memory for all T; the backward also keeps the block's rows
//   of w_hh ([8, 4H]) for dh = da @ w_hh^T.
// - Each step reads h_{t-1} for the block's rows from global memory (ys[t-1],
//   in L2) in chunks through shared memory. ys itself is the exchange buffer:
//   step t writes ys[t] and reads ys[t-1], which no later step overwrites, so
//   no block can clobber what a slower one still reads. The backward exchanges
//   da the same way, through an f32 buffer [T, N, 4H] with one plane per step,
//   which is also the f32 da the caller takes the weight gradient from.
// - Every tile is bounds-checked: any T >= 1, any N (envelope 1-256), any
//   H (envelope 1-512; the wrapper raises outside it).
//
// What bounds it on the H100 at the char-LSTM training shape (T=200, N=256,
// H=256, bf16): bytes, then the recurrence's latency. The forward must read
// x_proj (104.9 MB) and write ys and cs (26.2 MB each): ~158 MB, 47 us at
// 3.35 TB/s; its 26.8 GFLOP would take 27 us at the bf16 tensor-core peak. The
// backward reads x_proj, ys, cs and dys and writes d x_proj: ~288 MB, 86 us,
// against 53.7 GFLOP (54 us). These kernels do their arithmetic on the CUDA
// cores in f32 (67 TFLOP/s) and pay one grid barrier (a few us) per step, so
// both sit far above those bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 256;
constexpr int kU = 8;                 // hidden units per block
constexpr int kRG = kThreads / kU;    // row groups: threads per unit
constexpr int kChunkMin = 32;         // smallest k chunk staged per pass
constexpr long long kBarrierTimeoutNs = 10LL * 1000 * 1000 * 1000;

// ---------------------------------------------------------------- loads/stores
// Coherent loads (cache-global, past L1): ys and the da planes are written by
// other blocks of the same launch.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  const unsigned short b = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(b) << 16);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Grid-wide barrier over all co-resident blocks: bar[0] counts arrivals,
// bar[1] is the generation. The last block to arrive resets the count and
// bumps the generation; the others wait for the bump. The count is back at 0
// after every barrier.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    const unsigned int arrived = atomicAdd(bar, 1u);
    if (arrived == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long t0 = global_ns();
      while (*gen == g) {
        __nanosleep(32);
        if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

struct Args {
  const void* xp;    // [T, N, 4H]
  const void* whh;   // [H, 4H]
  const void* h0;    // [N, H]
  const void* c0;    // [N, H]
  void* ys;          // [T, N, H]
  void* cs;          // [T, N, H], or null (forward without the cell stream)
  void* hT;          // [N, H] (forward)
  void* cT;          // [N, H] (forward)
  const void* dys;   // [T, N, H] (backward)
  const void* dhT;   // [N, H] or null (backward)
  const void* dcT;   // [N, H] or null (backward)
  void* dxp;         // [T, N, 4H] in the storage type, or null (backward, f32)
  float* da;         // [T, N, 4H] f32 da, one exchange plane per step (backward)
  void* dh0;         // [N, H] (backward)
  void* dc0;         // [N, H] (backward)
  unsigned int* bar; // [2] zeroed barrier words
  int steps, N, H;
  int hpad;          // H rounded up to the chunk
  int kc;            // chunk length (a multiple of 32 that divides hpad)
  int unit_tiles;    // ceil(H / kU)
};

// Shared memory: w columns [hpad][kU] float4 (gates i, f, g, o of one unit in
// one float4), then (backward) w rows [4 * hpad / 4][kU] float4 (four
// consecutive columns j of one unit's row), then the chunk [32 * RB][kc + 4].
__host__ __device__ __forceinline__ int chunk_stride(int kc) { return kc + 4; }

template <typename T>
__device__ void load_w_cols(float* w_s, const Args& a, int ut) {
  const T* whh = static_cast<const T*>(a.whh);
  const int H = a.H, n = a.hpad * kU * 4;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int g = e & 3, u = (e >> 2) % kU, k = e / (4 * kU);
    const int col = ut * kU + u;
    w_s[e] = (col < H && k < H) ? ld(whh + (size_t)k * 4 * H + g * H + col) : 0.0f;
  }
}

template <typename T>
__device__ void load_w_rows(float* w_s, const Args& a, int ut) {
  const T* whh = static_cast<const T*>(a.whh);
  const int H = a.H, n = a.hpad * 4 * kU;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int jj = e & 3, u = (e >> 2) % kU, jq = e / (4 * kU);
    const int col = ut * kU + u, j = jq * 4 + jj;
    w_s[e] = (col < H && j < 4 * H) ? ld(whh + (size_t)col * 4 * H + j) : 0.0f;
  }
}

// 16 bytes of the storage type widened to f32 into dst (16-byte aligned).
__device__ __forceinline__ void widen_store(float* dst, uint4 v, const float*) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                  __uint_as_float(v.w));
}
__device__ __forceinline__ void widen_store(float* dst, uint4 v, const __nv_bfloat16*) {
  // little-endian: the low half of each word is the first element
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                  __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
                  __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
}

// Stage src[row, c0 + c) for the block's rows and c < kc into the chunk,
// zero past n_rows or past `width` columns. Where every row starts on a
// 16-byte boundary (width a multiple of 16 bytes' elements, src aligned), a
// warp reads whole 16-byte pieces of one row and each thread issues kBatch
// loads before it stores any, so a chunk pays the memory latency a few times
// rather than once per element; otherwise one element at a time.
constexpr int kBatch = 8;

template <typename T, int RB>
__device__ __forceinline__ void stage(float* ch_s, const T* src, int row0, int n_rows, int width,
                                      int c0, int kc) {
  constexpr int NB = kRG * RB;
  constexpr int V = 16 / sizeof(T);       // elements per 16-byte piece
  constexpr int kWarps = kThreads / 32;
  const int hs = chunk_stride(kc);
  if (width % V == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int pieces = kc / V;                    // per row (kc is a multiple of 32)
    const int per_row = (pieces + 31) / 32;       // piece slots per lane and row
    const int items = (NB / kWarps) * per_row;
    for (int i0 = 0; i0 < items; i0 += kBatch) {
      uint4 v[kBatch];
      int dst[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k;
        const int r = warp + kWarps * (i / per_row), c = lane + 32 * (i % per_row);
        const int row = row0 + r, col = c0 + c * V;
        dst[k] = (i < items && c < pieces) ? r * hs + c * V : -1;
        v[k] = (dst[k] >= 0 && row < n_rows && col < width)
                   ? __ldcg(reinterpret_cast<const uint4*>(src + (size_t)row * width + col))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (dst[k] >= 0) widen_store(ch_s + dst[k], v[k], src);
    }
    return;
  }
  const int n = NB * kc;
#pragma unroll 8
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / kc, c = e - r * kc;
    const int row = row0 + r, col = c0 + c;
    ch_s[r * hs + c] = (row < n_rows && col < width) ? ld(src + (size_t)row * width + col) : 0.0f;
  }
}

__device__ __forceinline__ void fma4(float (&c)[4], float h, float4 w) {
  c[0] = fmaf(h, w.x, c[0]);
  c[1] = fmaf(h, w.y, c[1]);
  c[2] = fmaf(h, w.z, c[2]);
  c[3] = fmaf(h, w.w, c[3]);
}

// acc[j][g] += sum_k h[row_j, k] w[k, g*H + unit] over the whole hidden width,
// h streaming through the chunk.
template <typename T, int RB>
__device__ __forceinline__ void gates_matmul(float (&acc)[RB][4], const float* w_s, float* ch_s,
                                             const T* hp, const Args& a, int row0, int rg, int u) {
  const int kc = a.kc, hs = chunk_stride(kc);
#pragma unroll
  for (int j = 0; j < RB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int k0 = 0; k0 < a.hpad; k0 += kc) {
    stage<T, RB>(ch_s, hp, row0, a.N, a.H, k0, kc);
    __syncthreads();
    const float4* wp = reinterpret_cast<const float4*>(w_s) + (size_t)k0 * kU + u;
    for (int k = 0; k < kc; k += 4, wp += 4 * kU) {
      float4 hv[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j)
        hv[j] = *reinterpret_cast<const float4*>(ch_s + (rg + j * kRG) * hs + k);
      const float4 w0 = wp[0], w1 = wp[kU], w2 = wp[2 * kU], w3 = wp[3 * kU];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        fma4(acc[j], hv[j].x, w0);
        fma4(acc[j], hv[j].y, w1);
        fma4(acc[j], hv[j].z, w2);
        fma4(acc[j], hv[j].w, w3);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- forward
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* ch_s = w_s + (size_t)a.hpad * kU * 4;
  constexpr int NB = kRG * RB;
  const int u = threadIdx.x % kU, rg = threadIdx.x / kU;
  const int ut = blockIdx.x % a.unit_tiles, bt = blockIdx.x / a.unit_tiles;
  const int H = a.H, N = a.N, unit = ut * kU + u, row0 = bt * NB;
  const T* xp = static_cast<const T*>(a.xp);
  T* ys = static_cast<T*>(a.ys);
  T* cs = static_cast<T*>(a.cs);

  load_w_cols<T>(w_s, a, ut);
  float c[RB];
  bool ok[RB];
  int row[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    row[j] = row0 + rg + j * kRG;
    ok[j] = unit < H && row[j] < N;
    c[j] = ok[j] ? ld(static_cast<const T*>(a.c0) + (size_t)row[j] * H + unit) : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < a.steps; ++t) {
    const T* hp = t == 0 ? static_cast<const T*>(a.h0) : ys + (size_t)(t - 1) * N * H;
    // this step's inputs that no other block writes, loaded before the
    // matmul so their latency hides behind it
    float x[RB][4];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const T* xr = xp + ((size_t)t * N + row[j]) * 4 * H + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[j][g] = ok[j] ? ld(xr + g * H) : 0.0f;
    }
    float acc[RB][4];
    gates_matmul<T, RB>(acc, w_s, ch_s, hp, a, row0, rg, u);
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      if (!ok[j]) continue;
      const float gi = sigmoidf(acc[j][0] + x[j][0]);
      const float gf = sigmoidf(acc[j][1] + x[j][1]);
      const float gg = tanhf(acc[j][2] + x[j][2]);
      const float go = sigmoidf(acc[j][3] + x[j][3]);
      c[j] = __fadd_rn(__fmul_rn(gf, c[j]), __fmul_rn(gi, gg));
      const float h = __fmul_rn(go, tanhf(c[j]));
      const size_t o = ((size_t)t * N + row[j]) * H + unit;
      st(ys + o, h);
      if (cs != nullptr) st(cs + o, c[j]);
      if (t == a.steps - 1) {
        st(static_cast<T*>(a.hT) + (size_t)row[j] * H + unit, h);
        st(static_cast<T*>(a.cT) + (size_t)row[j] * H + unit, c[j]);
      }
    }
    if (t + 1 < a.steps) grid_barrier(a.bar);
  }
}

// ---------------------------------------------------------------- backward
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* wc_s = reinterpret_cast<float*>(smem4);
  float* wr_s = wc_s + (size_t)a.hpad * kU * 4;
  float* ch_s = wr_s + (size_t)a.hpad * kU * 4;
  constexpr int NB = kRG * RB;
  const int u = threadIdx.x % kU, rg = threadIdx.x / kU;
  const int ut = blockIdx.x % a.unit_tiles, bt = blockIdx.x / a.unit_tiles;
  const int H = a.H, N = a.N, H4 = 4 * H, unit = ut * kU + u, row0 = bt * NB;
  const int kc = a.kc, hs = chunk_stride(kc);
  const T* xp = static_cast<const T*>(a.xp);
  const T* ys = static_cast<const T*>(a.ys);
  const T* cs = static_cast<const T*>(a.cs);
  const T* dys = static_cast<const T*>(a.dys);
  T* dxp = static_cast<T*>(a.dxp);

  load_w_cols<T>(wc_s, a, ut);
  load_w_rows<T>(wr_s, a, ut);
  float dh[RB], dc[RB];
  bool ok[RB];
  int row[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    row[j] = row0 + rg + j * kRG;
    ok[j] = unit < H && row[j] < N;
    const size_t o = (size_t)row[j] * H + unit;
    dh[j] = (ok[j] && a.dhT != nullptr) ? ld(static_cast<const T*>(a.dhT) + o) : 0.0f;
    dc[j] = (ok[j] && a.dcT != nullptr) ? ld(static_cast<const T*>(a.dcT) + o) : 0.0f;
  }
  __syncthreads();

  for (int t = a.steps - 1; t >= 0; --t) {
    const T* hp = t == 0 ? static_cast<const T*>(a.h0) : ys + (size_t)(t - 1) * N * H;
    const T* cp = t == 0 ? static_cast<const T*>(a.c0) : cs + (size_t)(t - 1) * N * H;
    float* da = a.da + (size_t)t * N * H4;
    // this step's inputs that no other block writes, loaded before the
    // matmul so their latency hides behind it
    float x[RB][4], dy[RB], ct[RB], cprev[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const size_t o = ((size_t)t * N + row[j]) * H + unit;
      const T* xr = xp + ((size_t)t * N + row[j]) * H4 + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[j][g] = ok[j] ? ld(xr + g * H) : 0.0f;
      dy[j] = ok[j] ? ld(dys + o) : 0.0f;
      ct[j] = ok[j] ? ld(cs + o) : 0.0f;
      cprev[j] = ok[j] ? ld(cp + (size_t)row[j] * H + unit) : 0.0f;
    }
    float acc[RB][4];
    gates_matmul<T, RB>(acc, wc_s, ch_s, hp, a, row0, rg, u);
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      if (!ok[j]) continue;
      const size_t ox = ((size_t)t * N + row[j]) * H4 + unit;
      const float gi = sigmoidf(acc[j][0] + x[j][0]);
      const float gf = sigmoidf(acc[j][1] + x[j][1]);
      const float gg = tanhf(acc[j][2] + x[j][2]);
      const float go = sigmoidf(acc[j][3] + x[j][3]);
      dh[j] = __fadd_rn(dh[j], dy[j]);
      const float tc = tanhf(ct[j]);
      const float d_o = __fmul_rn(dh[j], tc);
      dc[j] = __fadd_rn(dc[j], __fmul_rn(__fmul_rn(dh[j], go), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      const float d_i = __fmul_rn(dc[j], gg), d_f = __fmul_rn(dc[j], cprev[j]);
      const float d_g = __fmul_rn(dc[j], gi);
      const float a_i = __fmul_rn(__fmul_rn(d_i, gi), __fsub_rn(1.0f, gi));
      const float a_f = __fmul_rn(__fmul_rn(d_f, gf), __fsub_rn(1.0f, gf));
      const float a_g = __fmul_rn(d_g, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      const float a_o = __fmul_rn(__fmul_rn(d_o, go), __fsub_rn(1.0f, go));
      if (dxp != nullptr) {
        st(dxp + ox, a_i);
        st(dxp + ox + H, a_f);
        st(dxp + ox + 2 * H, a_g);
        st(dxp + ox + 3 * H, a_o);
      }
      float* dr = da + (size_t)row[j] * H4 + unit;
      dr[0] = a_i;
      dr[H] = a_f;
      dr[2 * H] = a_g;
      dr[3 * H] = a_o;
      dc[j] = __fmul_rn(dc[j], gf);
    }
    grid_barrier(a.bar);

    // dh_{t-1}[row, unit] = sum_j da_t[row, j] w_hh[unit, j], da streaming
    // through the chunk
    float acc_h[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) acc_h[j] = 0.0f;
    for (int j0 = 0; j0 < H4; j0 += kc) {
      stage<float, RB>(ch_s, da, row0, N, H4, j0, kc);
      __syncthreads();
      const float4* wp = reinterpret_cast<const float4*>(wr_s) + (size_t)(j0 / 4) * kU + u;
      for (int k = 0; k < kc; k += 4, wp += kU) {
        const float4 w = *wp;
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const float4 d = *reinterpret_cast<const float4*>(ch_s + (rg + j * kRG) * hs + k);
          acc_h[j] = fmaf(d.x, w.x, acc_h[j]);
          acc_h[j] = fmaf(d.y, w.y, acc_h[j]);
          acc_h[j] = fmaf(d.z, w.z, acc_h[j]);
          acc_h[j] = fmaf(d.w, w.w, acc_h[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) dh[j] = acc_h[j];
  }
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    if (!ok[j]) continue;
    const size_t o = (size_t)row[j] * H + unit;
    st(static_cast<T*>(a.dh0) + o, dh[j]);
    st(static_cast<T*>(a.dc0) + o, dc[j]);
  }
}

// ---------------------------------------------------------------- launch plan
template <typename T, int RB, bool BWD>
const void* kernel_ptr() {
  return BWD ? reinterpret_cast<const void*>(&lstm_bwd_kernel<T, RB>)
             : reinterpret_cast<const void*>(&lstm_fwd_kernel<T, RB>);
}

size_t smem_bytes(bool bwd, int hpad, int rb, int kc) {
  const size_t w = (size_t)hpad * kU * 4 * sizeof(float);
  return (bwd ? 2 * w : w) + (size_t)kRG * rb * chunk_stride(kc) * sizeof(float);
}

struct Plan {
  const void* fn;
  int rb, kc, hpad, blocks, per_sm;
  size_t smem;
};

// The first plan, by rows per thread (1, 2, 4) and then by chunk (the whole
// padded width, else 32), whose grid is co-resident on this card. On the H100
// (132 SMs) the envelope's largest grid, the backward at N=256 and H=512, fits
// at 4 rows per thread (128 blocks, one per SM). Each kernel may use the
// card's whole opt-in shared memory, so a plan stays launchable whatever plan
// was made after it.
template <typename T, bool BWD>
cudaError_t make_plan(int dev, int N, int H, Plan* p) {
  int sms = 0, max_smem = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const void* fns[3] = {kernel_ptr<T, 1, BWD>(), kernel_ptr<T, 2, BWD>(),
                        kernel_ptr<T, 4, BWD>()};
  const int unit_tiles = (H + kU - 1) / kU;
  const int hpad_full = (H + kChunkMin - 1) / kChunkMin * kChunkMin;
  for (int i = 0; i < 3; ++i) {
    const int rb = 1 << i, nb = kRG * rb;
    const int blocks = unit_tiles * ((N + nb - 1) / nb);
    err = cudaFuncSetAttribute(fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return err;
    for (int kc : {hpad_full, kChunkMin}) {
      const size_t smem = smem_bytes(BWD, hpad_full, rb, kc);
      if (smem > (size_t)max_smem) continue;
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[i], kThreads, smem);
      if (err != cudaSuccess) return err;
      if (blocks <= per_sm * sms) {
        *p = Plan{fns[i], rb, kc, hpad_full, blocks, per_sm, smem};
        return cudaSuccess;
      }
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

// make_plan's answer for this device and shape, made once: every later call
// of the shape (one per sampled character at T=1) skips the occupancy queries.
template <typename T, bool BWD>
cudaError_t cached_plan(int N, int H, Plan* p) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, Plan> plans;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, N, H);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    *p = it->second;
    return cudaSuccess;
  }
  err = make_plan<T, BWD>(dev, N, H, p);
  if (err == cudaSuccess) plans.emplace(key, *p);
  return err;
}

template <typename T, bool BWD>
cudaError_t launch(Args a, cudaStream_t stream, int* plan_out) {
  Plan p{};
  cudaError_t err = cached_plan<T, BWD>(a.N, a.H, &p);
  if (err != cudaSuccess) return err;
  a.hpad = p.hpad;
  a.kc = p.kc;
  a.unit_tiles = (a.H + kU - 1) / kU;
  if (plan_out != nullptr) {
    plan_out[0] = p.blocks;
    plan_out[1] = p.rb;
    plan_out[2] = p.kc;
    plan_out[3] = (int)p.smem;
    plan_out[4] = p.per_sm;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(p.fn, dim3(p.blocks), dim3(kThreads), args, p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int steps, int N, int H) {
  return steps < 1 || N < 1 || N > 256 || H < 1 || H > 512;
}

}  // namespace

extern "C" {

// Forward. Launches on `stream` and returns the CUDA error (0 on success).
// Device pointers to contiguous tensors of one element type (bf16 if is_bf16,
// else f32): xp [T, N, 4H], whh [H, 4H], h0 and c0 [N, H]; ys [T, N, H], cs
// [T, N, H] or null, hT and cT [N, H] are written. bar is two zeroed uint32.
// plan_out, if not null, receives {blocks, rows per thread, chunk, shared
// bytes, blocks per SM}.
int dl4j_lstm_fwd(int is_bf16, const void* xp, const void* whh, const void* h0, const void* c0,
                  void* ys, void* cs, void* hT, void* cT, void* bar, int steps, int N, int H,
                  int* plan_out, void* stream) {
  if (bad_shape(steps, N, H)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.xp = xp;
  a.whh = whh;
  a.h0 = h0;
  a.c0 = c0;
  a.ys = ys;
  a.cs = cs;
  a.hT = hT;
  a.cT = cT;
  a.bar = static_cast<unsigned int*>(bar);
  a.steps = steps;
  a.N = N;
  a.H = H;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16, false>(a, s, plan_out)
                       : launch<float, false>(a, s, plan_out));
}

// Backward. xp, whh, h0, c0 as in the forward; ys and cs [T, N, H] from the
// forward (with the cell stream); dys [T, N, H]; dhT and dcT [N, H] or null
// (zero). da [T, N, 4H] f32 (d x_proj in f32), dh0 and dc0 [N, H] are written,
// and dxp [T, N, 4H] in the storage type unless it is null (f32, where da is
// d x_proj itself).
int dl4j_lstm_bwd(int is_bf16, const void* xp, const void* whh, const void* h0, const void* c0,
                  const void* ys, const void* cs, const void* dys, const void* dhT,
                  const void* dcT, void* dxp, void* da, void* dh0, void* dc0, void* bar,
                  int steps, int N, int H, int* plan_out, void* stream) {
  if (bad_shape(steps, N, H) || cs == nullptr) return (int)cudaErrorInvalidValue;
  Args a{};
  a.xp = xp;
  a.whh = whh;
  a.h0 = h0;
  a.c0 = c0;
  a.ys = const_cast<void*>(ys);
  a.cs = const_cast<void*>(cs);
  a.dys = dys;
  a.dhT = dhT;
  a.dcT = dcT;
  a.dxp = dxp;
  a.da = static_cast<float*>(da);
  a.dh0 = dh0;
  a.dc0 = dc0;
  a.bar = static_cast<unsigned int*>(bar);
  a.steps = steps;
  a.N = N;
  a.H = H;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16, true>(a, s, plan_out)
                       : launch<float, true>(a, s, plan_out));
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
