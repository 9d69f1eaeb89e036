// Convolution + batch-norm statistics, written by hand for Hopper (sm_90a) and
// bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels in deeplearning4j_tpu/ops/conv_pallas.py:
//   conv1x1_bn_stats / _k_conv1x1 (pl.pallas_call at :88), and
//   conv3x3_bn_stats / _k_conv3x3 (pl.pallas_call at :167).
//
// What it computes (NHWC activations, HWIO weights, f32 or bf16):
//   1x1: y[r, o] = sum_i x[r, i] w[i, o] over rows r of [rows, Cin];
//   3x3: stride-1 SAME conv, an implicit GEMM over K = 9 taps x Cin: the A
//        element (r, tap, i) is x[n, h + dy - 1, w + dx - 1, i], read with
//        bounds checks (zero outside the image), so no padded copy of x is
//        made (the Pallas wrapper pads with jnp.pad first);
//   plus, from the f32 accumulator before the cast to y's type, the
//   per-channel mean and the single-pass biased variance
//   max(E[acc^2] - E[acc]^2, 0), as conv_pallas.py:107-112 computes them.
//
// Design. One block of 128 threads per 64 x 64 output tile, in a K loop of 32:
// the A and B tiles are staged in shared memory (16-byte loads where Cin, Cout
// and the pointers allow, masked element loads elsewhere), then multiplied:
// bf16 on the tensor cores (WMMA 16x16x16 fragments, f32 accumulators, 2x2 per
// warp), f32 on the CUDA cores (a 4 x 8 register tile per thread, fmaf). The
// f32 tile goes through shared memory to the epilogue, which writes y in its
// type and each column's sum and sum of squares over the tile's real rows into
// a [2, row tiles, Cout] f32 partial buffer. A second small kernel reduces the
// partials over row tiles in a fixed order (no atomics: the result does not
// change from run to run) and writes mean and var. On the TPU one grid ran in
// order and revisited one stats block; here blocks run in parallel, so the
// stats cross blocks through the partials. Ragged edge tiles are masked: rows
// past the end are zero in A and contribute nothing to the stats.
//
// What bounds it on the H100: at ResNet-50's bottleneck widths and batch 256,
// bytes for most 1x1 shapes (reading x once and writing y once: 514 MB, 153 us
// at 56x56 64->256) and operations for the deep ones (7x7 2048->512: 26.3
// GFLOP, 26.6 us at 989 TFLOP/s bf16); the 3x3 shapes sit near the line
// (56x56x64: 61 us by bytes, the others ~60 us by operations). This first
// kernel has no cp.async pipeline, wgmma or TMA: those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int C_LD = BN + 4;

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int A_LD = BK + 1;  // odd stride: row reads hit distinct banks
  static constexpr int B_LD = BN;
  static constexpr int VEC = 4;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int A_LD = BK + 8;  // WMMA wants a multiple of 8 elements
  static constexpr int B_LD = BN + 8;
  static constexpr int VEC = 8;
};

struct Shape {
  long long rows;
  int h, w, cin, cout;
};

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

// Offset into x of the A element (row r, k) and whether it lies inside the
// image; K = Cin (1x1) or 9 Cin (3x3, k = tap * Cin + i, tap = dy * 3 + dx).
template <int TAPS>
__device__ __forceinline__ long long a_offset(const Shape& s, long long r, int k, bool& ok) {
  if (TAPS == 1) {
    ok = r < s.rows && k < s.cin;
    return r * s.cin + k;
  }
  ok = false;
  if (r >= s.rows || k >= 9 * s.cin) return 0;
  const int tap = k / s.cin, ci = k - tap * s.cin;
  const int dy = tap / 3, dx = tap - dy * 3;
  const long long hw = (long long)s.h * s.w;
  const long long n = r / hw;
  const int rem = (int)(r - n * hw);
  const int oh = rem / s.w, ow = rem - oh * s.w;
  const int ih = oh + dy - 1, iw = ow + dx - 1;
  ok = ih >= 0 && ih < s.h && iw >= 0 && iw < s.w;
  return ((n * s.h + ih) * s.w + iw) * (long long)s.cin + ci;
}

template <typename T, int TAPS, bool VEC>
__device__ __forceinline__ void load_tiles(const T* __restrict__ x, const T* __restrict__ w,
                                           const Shape& s, long long row0, int col0, int k0,
                                           T (*As)[Cfg<T>::A_LD], T (*Bs)[Cfg<T>::B_LD]) {
  const int K = TAPS * s.cin;
  if constexpr (VEC) {
    // 16 bytes (V elements) per load; a vector never straddles a tap or
    // the end of a row because Cin and Cout are multiples of V
    constexpr int V = Cfg<T>::VEC;
    const uint4 none = make_uint4(0u, 0u, 0u, 0u);  // all-zero bits: 0.0 in both types
    for (int e = threadIdx.x; e < BM * BK / V; e += THREADS) {
      const int i = e / (BK / V), kk = (e % (BK / V)) * V;
      bool ok;
      const long long off = a_offset<TAPS>(s, row0 + i, k0 + kk, ok);
      const uint4 u = ok ? *reinterpret_cast<const uint4*>(x + off) : none;
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) As[i][kk + j] = v[j];
    }
    for (int e = threadIdx.x; e < BK * BN / V; e += THREADS) {
      const int kk = e / (BN / V), c = (e % (BN / V)) * V;
      const int k = k0 + kk, col = col0 + c;
      const uint4 u = (k < K && col < s.cout)
                          ? *reinterpret_cast<const uint4*>(w + (long long)k * s.cout + col)
                          : none;
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) Bs[kk][c + j] = v[j];
    }
  } else {
    const T zero = from_f<T>(0.f);
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int i = e / BK, kk = e % BK;
      bool ok;
      const long long off = a_offset<TAPS>(s, row0 + i, k0 + kk, ok);
      As[i][kk] = ok ? x[off] : zero;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int kk = e / BN, c = e % BN;
      const int k = k0 + kk, col = col0 + c;
      Bs[kk][c] = (k < K && col < s.cout) ? w[(long long)k * s.cout + col] : zero;
    }
  }
}

// f32: each thread's 4 x 8 share of the 64 x 64 tile (rows ty + 16 i, columns
// tx + 8 j), accumulated over one K step of the staged tiles.
struct F32Acc {
  float v[4][8];
};

__device__ __forceinline__ void mma_tile(const float (*As)[Cfg<float>::A_LD],
                                         const float (*Bs)[Cfg<float>::B_LD], F32Acc& acc) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 8 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.v[i][j] = fmaf(a[i], b[j], acc.v[i][j]);
  }
}

template <typename T, int TAPS, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv_bn_stats_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                         float* __restrict__ partial, Shape s, int row_tiles, int col_tiles) {
  __shared__ __align__(32) T As[BM][Cfg<T>::A_LD];
  __shared__ __align__(32) T Bs[BK][Cfg<T>::B_LD];
  __shared__ __align__(32) float Cs[BM][C_LD];

  const int col_tile = blockIdx.x % col_tiles;
  const long long row_tile = blockIdx.x / col_tiles;
  const long long row0 = row_tile * BM;
  const int col0 = col_tile * BN;
  const int K = TAPS * s.cin;

  if constexpr (sizeof(T) == 2) {
    const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tiles<T, TAPS, VEC>(x, w, s, row0, col0, k0, As, Bs);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[wr * 32 + i * 16][kk], Cfg<T>::A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], &Bs[kk][wc * 32 + j * 16], Cfg<T>::B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&Cs[wr * 32 + i * 16][wc * 32 + j * 16], acc[i][j], C_LD,
                                wmma::mem_row_major);
  } else {
    F32Acc acc;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.v[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tiles<T, TAPS, VEC>(x, w, s, row0, col0, k0, As, Bs);
      __syncthreads();
      mma_tile(As, Bs, acc);
      __syncthreads();
    }
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[ty + 16 * i][tx + 8 * j] = acc.v[i][j];
  }
  __syncthreads();

  // epilogue: y in its type, then the tile's column sums of acc and acc^2
  const long long left = s.rows - row0;
  const int valid = left < BM ? (int)left : BM;
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int i = e / BN, c = e % BN;
    if (i < valid && col0 + c < s.cout)
      y[(row0 + i) * s.cout + col0 + c] = from_f<T>(Cs[i][c]);
  }
  const int c = threadIdx.x % BN;
  const bool squares = threadIdx.x >= BN;
  if (col0 + c < s.cout) {
    float acc = 0.f;
    for (int i = 0; i < valid; ++i) {
      const float v = Cs[i][c];
      acc = squares ? __fadd_rn(acc, __fmul_rn(v, v)) : __fadd_rn(acc, v);
    }
    partial[((squares ? row_tiles : 0) + row_tile) * s.cout + col0 + c] = acc;
  }
}

// mean and var per channel from the partials, summed over row tiles in a
// fixed order: 8 strided lanes per channel, then the 8 in order.
__global__ void reduce_stats_kernel(const float* __restrict__ partial, float* __restrict__ mean,
                                    float* __restrict__ var, int row_tiles, int cout,
                                    float rows) {
  __shared__ float ss[8][33], qq[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  float s = 0.f, q = 0.f;
  if (col < cout) {
    for (int t = ty; t < row_tiles; t += 8) {
      s = __fadd_rn(s, partial[(long long)t * cout + col]);
      q = __fadd_rn(q, partial[(long long)(row_tiles + t) * cout + col]);
    }
  }
  ss[ty][tx] = s;
  qq[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && col < cout) {
    for (int j = 1; j < 8; ++j) {
      s = __fadd_rn(s, ss[j][tx]);
      q = __fadd_rn(q, qq[j][tx]);
    }
    const float m = __fdiv_rn(s, rows);
    const float v = __fsub_rn(__fdiv_rn(q, rows), __fmul_rn(m, m));
    mean[col] = m;
    var[col] = v > 0.f ? v : 0.f;
  }
}

template <typename T, int TAPS>
int launch(const void* x, const void* w, void* y, void* partial, void* mean, void* var,
           const Shape& s, bool vec, cudaStream_t st) {
  const long long row_tiles = (s.rows + BM - 1) / BM;
  const int col_tiles = (s.cout + BN - 1) / BN;
  const long long blocks = row_tiles * col_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  auto* yt = static_cast<T*>(y);
  auto* pt = static_cast<float*>(partial);
  if (vec)
    conv_bn_stats_kernel<T, TAPS, true>
        <<<(unsigned)blocks, THREADS, 0, st>>>(xt, wt, yt, pt, s, (int)row_tiles, col_tiles);
  else
    conv_bn_stats_kernel<T, TAPS, false>
        <<<(unsigned)blocks, THREADS, 0, st>>>(xt, wt, yt, pt, s, (int)row_tiles, col_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_stats_kernel<<<(s.cout + 31) / 32, dim3(32, 8), 0, st>>>(
      pt, static_cast<float*>(mean), static_cast<float*>(var), (int)row_tiles, s.cout,
      (float)s.rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: [rows, Cin] (taps 1) or [N, H, W, Cin] with rows = N H W (taps 9);
// w: [taps * Cin, Cout]; y: [rows, Cout] in x's type; partial: f32 scratch of
// 2 * ceil(rows / 64) * Cout; mean, var: f32 [Cout]. bf16 != 0 means x, w
// and y are bfloat16, else float32. All contiguous device memory.
int dl4j_conv_bn_stats(const void* x, const void* w, void* y, void* partial, void* mean,
                       void* var, long long rows, int h, int wd, int cin, int cout, int taps,
                       int bf16, void* stream) {
  if (rows <= 0 || cin <= 0 || cout <= 0 || (taps != 1 && taps != 9))
    return (int)cudaErrorInvalidValue;
  if (taps == 9 && (h <= 0 || wd <= 0 || rows % ((long long)h * wd) != 0))
    return (int)cudaErrorInvalidValue;
  const Shape s{rows, h, wd, cin, cout};
  const int v = bf16 ? 8 : 4;
  const bool vec = cin % v == 0 && cout % v == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15u) == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return taps == 1 ? launch<__nv_bfloat16, 1>(x, w, y, partial, mean, var, s, vec, st)
                     : launch<__nv_bfloat16, 9>(x, w, y, partial, mean, var, s, vec, st);
  return taps == 1 ? launch<float, 1>(x, w, y, partial, mean, var, s, vec, st)
                   : launch<float, 9>(x, w, y, partial, mean, var, s, vec, st);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
