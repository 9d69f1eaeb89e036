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
//        element (r, tap, i) is x[n, h + dy - 1, w + dx - 1, i], zero outside
//        the image, so no padded copy of x is made (the Pallas wrapper pads
//        with jnp.pad first);
//   plus, from the f32 accumulator before the cast to y's type, the
//   per-channel mean and the single-pass biased variance
//   max(E[acc^2] - E[acc]^2, 0), as conv_pallas.py:107-112 computes them.
//
// What bounds it on the H100: at ResNet-50's bottleneck widths and batch 256,
// bytes for most 1x1 shapes (reading x once and writing y once: 514 MB, 153 us
// at 56x56 64->256) and operations for the deep ones (7x7 2048->512: 26.3
// GFLOP, 26.6 us at 989 TFLOP/s bf16); the 3x3 shapes sit near the line
// (56x56x64: 61 us by bytes, the others ~60 us by operations).
//
// Measured (chip_smoke.py phase 11, NVIDIA H100 80GB HBM3, 700.00 W): the tc
// route takes 0.209 ms at 56x56 64->256 (0.73 of its byte bound; the wmma
// design 0.84 ms) and 0.251 ms at 3x3 56x56x64 (0.24; wmma 0.92 ms), 231-421
// TFLOP/s at the operation-heavy shapes. tools/conv_probe.py's cycle split
// says what holds it: where K is deep, issuing the cp.async copies takes
// 0.45-0.65 of a block's cycles (the copies wait on the L2); where Cout is
// wide, the epilogue's y stores take 0.45-0.68 (HBM writes). TMA loads
// (with multicast across a cluster), a halo tile that the nine taps share,
// and larger tiles are the next steps.
//
// Three routes, chosen by the caller (ops/conv_bn_stats.py kernel_route, by
// dtype, shape and alignment; the entry point refuses a route the shape does
// not fit, and never retries another):
//
// tc, every bf16 call whose Cin and Cout are multiples of 8 (Cin of 64 for the
//   3x3) on 16-byte aligned tensors: a persistent implicit GEMM on the tensor
//   cores. A block is two warpgroups; a tile is 128 output rows x BN columns
//   (BN 128, or 64 where Cout <= 64), each warpgroup issuing wgmma m64nBNk16
//   with f32 accumulators in registers, both operands read from shared memory
//   through 128-byte-swizzle descriptors: A (x's rows) K-major, B (w, [K, Cout]
//   with Cout contiguous) MN-major through the descriptor's transpose bit, so w
//   is never copied. K goes in stages of 64 (one 128-byte swizzle row) through
//   a ring of 4-5 stages that cp.async 16-byte copies fill with zero fill (rows
//   past the end, the 3x3 halo, K past Cin), S-2 stages ahead of the wgmma,
//   which keeps one group in flight. The 3x3 gather does no division in the K
//   loop: each thread works out once per tile the pixel offset and the 9-bit
//   in-image tap mask of its four A rows, and K is tap-major (k = tap Cin + i),
//   so a stage never crosses a tap. Blocks are persistent: block (c, g) of
//   col_tiles x G (G from the SM count and the blocks that fit on an SM) walks
//   row tiles g, g + G, ... of column tile c in one pipeline that runs across
//   tile boundaries, so the next tile's loads fly during this tile's epilogue.
//   The epilogue stages y in bf16 in the spent ring stage (swizzled against
//   bank conflicts) and writes it with 16-byte coalesced stores; each thread
//   adds its rows of acc and acc^2 (ragged rows masked) into per-column
//   registers across all its tiles; at the end a fixed-order __shfl_xor over
//   the lanes that share a column and a fixed-order sum over the 8 warps
//   write one partial per column: [2, G, Cout].
// wmma (the first bf16 design), the other bf16 calls: one block of 128
//   threads per 64 x 64 tile, K in steps of 32 staged synchronously in shared
//   memory, WMMA 16x16x16 fragments; partials [2, ceil(rows / 64), Cout].
// f32, every float32 call: the same tiles on the CUDA cores (a 4 x 8 register
//   tile per thread, fmaf).
// A second small kernel sums the partials of each column in a fixed order and
// writes mean and var. No atomics anywhere: two calls give the same bits.
// dl4j_conv_bn_stats_scratch gives the partial buffer's size for a route, the
// one source of that size.

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

// ------------------------------------------- bf16: tensor-core route (tc)
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;           // two warpgroups
constexpr int kBM = 128;                // output rows per tile: 64 per warpgroup
constexpr int kBK = 64;                 // K per stage: one 128-byte swizzle row of bf16
constexpr int kABytes = kBM * kBK * 2;  // A stage: 128 rows x 128 bytes
constexpr int kAtom = kBK * 128;        // B stage atom: 64 K rows x 64 columns (128 bytes)

// BN 128 or 64 output columns per tile
template <int BN>
struct Tile {
  static constexpr int kStages = BN == 128 ? 5 : 4;
  static constexpr int kStageBytes = kABytes + kBK * BN * 2;
  static constexpr int kRedBytes = 8 * 2 * BN * 4;  // per-warp column sums at the end
  static constexpr int kSmem = kStages * kStageBytes + kRedBytes + 1024;  // + ring alignment
  static constexpr int kMinBlocks = BN == 128 ? 1 : 2;
  static constexpr int kAcc = BN / 2;  // f32 accumulators per thread
  static constexpr int kChunks = BN / 8;  // 16-byte chunks per B row and per y row
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory through L2; src-size 0 writes zeros
// and reads nothing
__device__ __forceinline__ void cp16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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
// this thread's cp.async writes, made visible to the wgmma (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across the asynchronous MMA
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d[64 x N] (+)= A[64 x 16] . B[16 x N]: A K-major (transpose 0), B MN-major
// (transpose 1); acc == 0 overwrites d. Fragment of d (lane = 4 q + t, warp v
// of the warpgroup): d[4j], d[4j+1] at row 16 v + q, columns 8j + 2t, 8j + 2t + 1;
// d[4j+2], d[4j+3] at row 16 v + q + 8, the same columns.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 64)
    wgmma_n64(d, da, db, acc);
  else
    wgmma_n128(d, da, db, acc);
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Shared memory of one ring stage (1024-byte aligned):
//   A [128 rows][64 k]: row r at r * 128 bytes, its 16-byte chunk c (k 8c..8c+7)
//     at chunk c ^ (r % 8): the K-major 128-byte swizzle; the descriptor's
//     stride byte offset is 1024 (8 rows), and a k16 step adds 32 bytes;
//   B [64 k][BN cols]: atom a (columns 64a..64a+63) at kABytes + a * kAtom, row k
//     at k * 128 bytes, chunk c (columns 8c..8c+7 of the atom) at c ^ (k % 8): the
//     MN-major 128-byte swizzle; leading byte offset kAtom (the next 64
//     columns), stride byte offset 1024 (the next 8 k), a k16 step adds 2048.
template <int TAPS, int BN>
__global__ void __launch_bounds__(kThreads, Tile<BN>::kMinBlocks)
    conv_bn_stats_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                            bf16* __restrict__ y, float* __restrict__ partial, Shape s,
                            int row_tiles, int col_tiles, int G) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const unsigned sbase = smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + T::kStages * T::kStageBytes);

  const int tid = threadIdx.x;
  const int g = blockIdx.x / col_tiles;
  const int col0 = (blockIdx.x - g * col_tiles) * BN;
  const int rows = static_cast<int>(s.rows);  // the route takes rows <= INT_MAX
  const int K = TAPS * s.cin;
  const int KT = (K + kBK - 1) / kBK;
  const int n_tiles = (row_tiles - g + G - 1) / G;
  const int total = n_tiles * KT;

  // loader roles: A rows a_row + 32 i (i < 4), chunk a_chunk; B rows b_row +
  // kBPass i, chunk b_chunk
  const int a_chunk = tid & 7, a_row = tid >> 3;
  constexpr int kBPass = kThreads / T::kChunks;
  const int b_chunk = tid % T::kChunks, b_row = tid / T::kChunks;
  const bool b_col_ok = col0 + b_chunk * 8 < s.cout;
  const unsigned a_dst = a_row * 128 + ((a_chunk ^ (a_row & 7)) << 4);
  const unsigned b_dst =
      (b_chunk >> 3) * kAtom + b_row * 128 + (((b_chunk & 7) ^ (b_row & 7)) << 4);

  // the tile being loaded: each A row's offset into x (row r is pixel r) and
  // its in-image taps (1x1: bit 0 = the row exists)
  long long a_base[4];
  unsigned a_mask[4];
  auto setup = [&](int tile) {
    const int hw = s.h * s.w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tile * kBM + a_row + 32 * i;
      a_base[i] = static_cast<long long>(r) * s.cin;
      unsigned m = 0;
      if (r < rows) {
        if constexpr (TAPS == 1) {
          m = 1;
        } else {
          const int n = r / hw, rem = r - n * hw;
          const int oh = rem / s.w, ow = rem - oh * s.w;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int ih = oh + dy - 1, iw = ow + dx - 1;
              if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w) m |= 1u << (dy * 3 + dx);
            }
        }
      }
      a_mask[i] = m;
    }
  };

  // w rows kt * 64 .. + 63 of this column tile into the B slot at `dst`
  auto load_b = [&](unsigned dst, int kt) {
#pragma unroll
    for (int i = 0; i < kBK / kBPass; ++i) {
      const int k = kt * kBK + b_row + kBPass * i;
      const bool ok = b_col_ok && k < K;
      const bf16* src = ok ? w + static_cast<long long>(k) * s.cout + col0 + b_chunk * 8 : w;
      cp16(dst + b_dst + i * kBPass * 128, src, ok);
    }
  };

  auto load = [&](int buf, int kt) {
    const unsigned st = sbase + buf * T::kStageBytes;
    int tap = 0, ci0 = kt * kBK;
    long long toff = 0;
    if constexpr (TAPS == 9) {
      const int cpt = s.cin / kBK;  // stages per tap
      tap = kt / cpt;
      ci0 = (kt - tap * cpt) * kBK;
      const int dy = tap / 3, dx = tap - dy * 3;
      toff = static_cast<long long>((dy - 1) * s.w + (dx - 1)) * s.cin;
    }
    const int k_off = ci0 + a_chunk * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = ((a_mask[i] >> tap) & 1u) && k_off < s.cin;
      const bf16* src = ok ? x + a_base[i] + toff + k_off : x;
      cp16(st + a_dst + i * 32 * 128, src, ok);
    }
    load_b(st + kABytes, kt);
  };

  // the load cursor runs kStages - 2 stages ahead of the MMA, across tiles
  int l_step = 0, l_kt = 0, l_tile = 0;
  auto advance = [&]() {
    if (l_step < total) load(l_step % T::kStages, l_kt);
    cp_commit();  // an empty group past the end keeps the group count
    ++l_step;
    if (++l_kt == KT) {
      l_kt = 0;
      if (++l_tile < n_tiles) setup(g + l_tile * G);
    }
  };

  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int qr = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's rows qr, qr + 8
  const int qc = 2 * (lane & 3);                           // and columns 8j + qc, + 1
  float acc[T::kAcc];
  float csum[T::kAcc / 2], csq[T::kAcc / 2];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::kAcc / 2; ++i) csum[i] = csq[i] = 0.f;

  setup(g);
#pragma unroll
  for (int i = 0; i < T::kStages - 2; ++i) advance();

  int c_step = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int row0 = (g + it * G) * kBM;
    for (int kt = 0; kt < KT; ++kt, ++c_step) {
      cp_wait<T::kStages - 3>();  // this thread's copies of stage c_step landed
      fence_proxy_async();
      __syncthreads();  // everyone's copies landed; every wgmma of step - 2 is done
      advance();        // refills the buffer of step - 2
      const unsigned st = sbase + (c_step % T::kStages) * T::kStageBytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma<BN>(acc, desc(st + wg * 64 * 128 + kk * 32, 16, 1024),
                  desc(st + kABytes + kk * 16 * 128, kAtom, 1024), (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // statistics of the real rows, from the f32 accumulators
    const bool ok0 = row0 + qr < rows, ok1 = row0 + qr + 8 < rows;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v0 = ok0 ? acc[4 * j + e] : 0.f, v1 = ok1 ? acc[4 * j + 2 + e] : 0.f;
        csum[2 * j + e] = __fadd_rn(__fadd_rn(csum[2 * j + e], v0), v1);
        csq[2 * j + e] = __fadd_rn(__fadd_rn(csq[2 * j + e], __fmul_rn(v0, v0)), __fmul_rn(v1, v1));
      }

    // y in bf16 through the spent stage, then 16-byte coalesced stores
    __syncthreads();  // both warpgroups are done reading the stage
    unsigned char* stg = smem + ((c_step - 1) % T::kStages) * T::kStageBytes;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int sw = (j ^ (qr & 7)) << 4;
      *reinterpret_cast<unsigned*>(stg + qr * (BN * 2) + sw + qc * 2) =
          pack(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<unsigned*>(stg + (qr + 8) * (BN * 2) + sw + qc * 2) =
          pack(acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kBM * T::kChunks / kThreads; ++p) {
      const int e = tid + p * kThreads;
      const int r = e / T::kChunks, c = e - r * T::kChunks;
      const uint4 v = *reinterpret_cast<const uint4*>(stg + r * (BN * 2) + ((c ^ (r & 7)) << 4));
      if (row0 + r < rows && col0 + c * 8 < s.cout)
        *reinterpret_cast<uint4*>(y + static_cast<long long>(row0 + r) * s.cout + col0 + c * 8) = v;
    }
  }
  cp_wait<0>();

  // one partial per column: lanes that share a column, then the 8 warps, in
  // a fixed order
#pragma unroll
  for (int i = 0; i < T::kAcc / 2; ++i) {
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      csum[i] = __fadd_rn(csum[i], __shfl_xor_sync(0xffffffffu, csum[i], m));
      csq[i] = __fadd_rn(csq[i], __shfl_xor_sync(0xffffffffu, csq[i], m));
    }
  }
  if ((lane >> 2) == 0) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(warp * 2) * BN + 8 * j + qc + e] = csum[2 * j + e];
        red[(warp * 2 + 1) * BN + 8 * j + qc + e] = csq[2 * j + e];
      }
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int which = tid / BN, c = tid - which * BN;  // 0: sums, 1: squares
    float a = 0.f;
#pragma unroll
    for (int v = 0; v < 8; ++v) a = __fadd_rn(a, red[(v * 2 + which) * BN + c]);
    if (col0 + c < s.cout)
      partial[(static_cast<long long>(which) * G + g) * s.cout + col0 + c] = a;
  }
}

// Blocks of one instantiation that fit on an SM of device `dev`, after
// raising its dynamic shared-memory limit once per device; < 0: -cudaError.
template <int TAPS, int BN>
int blocks_per_sm(int dev) {
  static int known[64] = {};
  if (dev < 0 || dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (known[dev] == 0) {
    auto* fn = conv_bn_stats_tc_kernel<TAPS, BN>;
    cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
    if (e != cudaSuccess) return -static_cast<int>(e);
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, Tile<BN>::kSmem);
    if (e != cudaSuccess) return -static_cast<int>(e);
    if (n < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
    known[dev] = n;
  }
  return known[dev];
}

struct Plan {
  int bn, row_tiles, col_tiles, G;
};

// The persistent grid for this shape on the current device: G row walkers
// per column tile, as many blocks in all as fit on the card at once.
int plan(const Shape& s, int taps, Plan& p) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.bn = s.cout <= 64 ? 64 : 128;
  const int occ = taps == 1 ? (p.bn == 64 ? blocks_per_sm<1, 64>(dev) : blocks_per_sm<1, 128>(dev))
                            : (p.bn == 64 ? blocks_per_sm<9, 64>(dev) : blocks_per_sm<9, 128>(dev));
  if (occ < 0) return -occ;
  p.row_tiles = static_cast<int>((s.rows + kBM - 1) / kBM);
  p.col_tiles = (s.cout + p.bn - 1) / p.bn;
  const int walkers = sms * occ / p.col_tiles;
  p.G = walkers < 1 ? 1 : (walkers < p.row_tiles ? walkers : p.row_tiles);
  return 0;
}

// Whether the route takes this call: Cin and Cout multiples of 8 (Cin a
// multiple of 64 for the 3x3, so that a stage never crosses a tap), 16-byte
// aligned x, w and y, rows that fit an int.
bool takes(const void* x, const void* w, const void* y, const Shape& s, int taps) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y);
  return s.cin % 8 == 0 && s.cout % 8 == 0 && (taps == 1 || s.cin % kBK == 0) &&
         (bits & 15u) == 0 && s.rows <= 0x7fffffffLL;
}

template <int TAPS, int BN>
int launch(const void* x, const void* w, void* y, float* partial, const Plan& p, const Shape& s,
           cudaStream_t st) {
  conv_bn_stats_tc_kernel<TAPS, BN><<<p.col_tiles * p.G, kThreads, Tile<BN>::kSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), partial,
      s, p.row_tiles, p.col_tiles, p.G);
  return static_cast<int>(cudaGetLastError());
}

template <int TAPS>
int launch(const void* x, const void* w, void* y, float* partial, const Plan& p, const Shape& s,
           cudaStream_t st) {
  return p.bn == 128 ? launch<TAPS, 128>(x, w, y, partial, p, s, st)
                     : launch<TAPS, 64>(x, w, y, partial, p, s, st);
}

}  // namespace tc

enum Route { kF32 = 0, kWmma = 1, kTc = 2 };

int reduce(const float* partial, void* mean, void* var, int parts, const Shape& s,
           cudaStream_t st) {
  reduce_stats_kernel<<<(s.cout + 31) / 32, dim3(32, 8), 0, st>>>(
      partial, static_cast<float*>(mean), static_cast<float*>(var), parts, s.cout,
      static_cast<float>(s.rows));
  return static_cast<int>(cudaGetLastError());
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
  return reduce(pt, mean, var, (int)row_tiles, s, st);
}

bool valid_shape(long long rows, int h, int wd, int cin, int cout, int taps) {
  if (rows <= 0 || cin <= 0 || cout <= 0 || (taps != 1 && taps != 9)) return false;
  return taps == 1 || (h > 0 && wd > 0 && rows % ((long long)h * wd) == 0);
}

}  // namespace

extern "C" {

// Floats of the partial-statistics scratch that dl4j_conv_bn_stats needs for
// this shape and route on the current device (route 0 f32, 1 wmma, 2 tc);
// < 0: -cudaError. The caller allocates exactly this.
long long dl4j_conv_bn_stats_scratch(long long rows, int h, int wd, int cin, int cout, int taps,
                                     int route) {
  if (!valid_shape(rows, h, wd, cin, cout, taps) || route < kF32 || route > kTc)
    return -static_cast<long long>(cudaErrorInvalidValue);
  const Shape s{rows, h, wd, cin, cout};
  if (route == kTc) {
    tc::Plan p;
    const int err = tc::plan(s, taps, p);
    if (err != 0) return -static_cast<long long>(err);
    return 2LL * p.G * cout;
  }
  return 2LL * ((rows + BM - 1) / BM) * cout;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: [rows, Cin] (taps 1) or [N, H, W, Cin] with rows = N H W (taps 9);
// w: [taps * Cin, Cout]; y: [rows, Cout] in x's type; partial: f32 scratch of
// dl4j_conv_bn_stats_scratch floats; mean, var: f32 [Cout]. route 0: x, w
// and y float32 (CUDA cores); 1: bfloat16, the WMMA tiles; 2: bfloat16, the
// tensor-core implicit GEMM, which refuses shapes it does not take
// (cudaErrorInvalidValue). All contiguous device memory.
int dl4j_conv_bn_stats(const void* x, const void* w, void* y, void* partial, void* mean,
                       void* var, long long rows, int h, int wd, int cin, int cout, int taps,
                       int route, void* stream) {
  if (!valid_shape(rows, h, wd, cin, cout, taps)) return (int)cudaErrorInvalidValue;
  const Shape s{rows, h, wd, cin, cout};
  const auto st = static_cast<cudaStream_t>(stream);
  if (route == kTc) {
    if (!tc::takes(x, w, y, s, taps)) return (int)cudaErrorInvalidValue;
    tc::Plan p;
    int err = tc::plan(s, taps, p);
    if (err != 0) return err;
    auto* pt = static_cast<float*>(partial);
    err = taps == 1 ? tc::launch<1>(x, w, y, pt, p, s, st) : tc::launch<9>(x, w, y, pt, p, s, st);
    if (err != 0) return err;
    return reduce(pt, mean, var, p.G, s, st);
  }
  if (route != kF32 && route != kWmma) return (int)cudaErrorInvalidValue;
  const int v = route == kWmma ? 8 : 4;
  const bool vec = cin % v == 0 && cout % v == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15u) == 0;
  if (route == kWmma)
    return taps == 1 ? launch<__nv_bfloat16, 1>(x, w, y, partial, mean, var, s, vec, st)
                     : launch<__nv_bfloat16, 9>(x, w, y, partial, mean, var, s, vec, st);
  return taps == 1 ? launch<float, 1>(x, w, y, partial, mean, var, s, vec, st)
                   : launch<float, 9>(x, w, y, partial, mean, var, s, vec, st);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
