// Residual-block tail (batch-norm apply + residual add + ReLU), written by hand
// for Hopper (sm_90a) and bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel in deeplearning4j_tpu/ops/residual_tail_pallas.py
// (_tail_kernel / _k_tail, pl.pallas_call at :63), behind bn_relu_residual.
//
// What it computes, over x and res of [rows, C] (each f32 or bf16, in any mix)
// with f32 per-channel mean, var, gamma, beta:
//   out = relu((x - mean) * rsqrt(var + eps) * gamma + beta + res)
// in f32, in _k_tail's order of operations, then cast to x's type (each operand
// is widened to f32 first, as _k_tail and _ref_formula cast them, so an f32 res
// is added unrounded to a bf16 x). Every multiply and add is an explicitly
// rounded intrinsic (no FMA contraction), and rsqrt is 1 / sqrt correctly
// rounded, so f32 results match the plain version (ops/residual_tail.py) to
// rounding.
//
// What bounds it on the H100: bytes. It reads x and res once and writes out
// once: at ResNet-50's 56x56x256 join at batch 256 in bf16, 1.23 GB, 368 us at
// 3.35 TB/s; there are 6 flops per element. The design streams:
// - Each thread owns one fixed group of G channels (G = 8 where either operand
//   is bf16, else 4: 16 or 32 bytes of each operand) for its whole walk and
//   strides over rows, never over channels. The grid holds a whole number of
//   row lanes (C / G threads each), so a thread's channels never change: its
//   mean, 1 / sqrt(var + eps), gamma and beta are loaded once and held in
//   registers. No shared memory, no modulo in the loop.
// - Each thread keeps the loads of kUnroll rows in flight (16-byte loads with
//   the streaming hint: nothing is read twice) before it computes and stores
//   any of them, also with the streaming hint.
// - The grid is sized from the blocks the card holds at once (occupancy
//   calculator, once per device and instantiation), capped by the rows.
// Where C is not a multiple of G or a pointer is not 16-byte aligned, every
// element takes the scalar kernel: a thread owns one channel and strides over
// rows alike.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // rows in flight per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
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

__device__ __forceinline__ float inv_std(float var, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// _k_tail's order: ((((x - mean) * inv) * gamma) + beta) + res, then ReLU
__device__ __forceinline__ float tail_one(float x, float r, float m, float inv, float g,
                                          float b) {
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), inv), g), b), r);
  return z > 0.f ? z : 0.f;
}

// G elements of type T in 32-bit words (G * sizeof(T) bytes, whole 16-byte
// pieces); element j of a bf16 piece is the low (even j) or high half of word
// j / 2 (little-endian)
template <typename T, int G>
struct Piece {
  static constexpr int kPieces = G * (int)sizeof(T) / 16;
  unsigned w[4 * kPieces] = {};
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < kPieces; ++i)
      __stcs(reinterpret_cast<uint4*>(p) + i,
             make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]));
  }
  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[j]);
    return __uint_as_float((j & 1) ? (w[j / 2] & 0xffff0000u) : (w[j / 2] << 16));
  }
  __device__ __forceinline__ void set(int j, float v) {
    if constexpr (sizeof(T) == 4) {
      w[j] = __float_as_uint(v);
    } else {
      const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      w[j / 2] = (j & 1) ? (w[j / 2] & 0xffffu) | (b << 16) : (w[j / 2] & 0xffff0000u) | b;
    }
  }
};

// Thread gid < lanes * cg owns channels [G (gid % cg), + G) of rows gid / cg,
// + lanes, + 2 lanes, ... (cg = C / G).
template <typename TX, typename TR, int G>
__global__ void __launch_bounds__(kThreads)
    residual_tail_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
                         const float* __restrict__ mean, const float* __restrict__ var,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         TX* __restrict__ out, long long rows, int C, int lanes, float eps) {
  const int cg = C / G;
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (long long)lanes * cg) return;
  const int c0 = (int)(gid % cg) * G;
  float m[G], inv[G], g[G], b[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = __ldg(mean + c0 + j);
    inv[j] = inv_std(__ldg(var + c0 + j), eps);
    g[j] = __ldg(gamma + c0 + j);
    b[j] = __ldg(beta + c0 + j);
  }
  const long long step = (long long)lanes * C;   // elements between a thread's rows
  long long r = gid / cg;
  for (; r < rows; r += (long long)kUnroll * lanes) {
    Piece<TX, G> px[kUnroll];
    Piece<TR, G> pr[kUnroll];
    const long long o = r * C + c0;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (r + (long long)k * lanes < rows) {
        px[k].load(x + o + k * step);
        pr[k].load(res + o + k * step);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (r + (long long)k * lanes < rows) {
        Piece<TX, G> po;
#pragma unroll
        for (int j = 0; j < G; ++j)
          po.set(j, tail_one(px[k].get(j), pr[k].get(j), m[j], inv[j], g[j], b[j]));
        po.store(out + o + k * step);
      }
    }
  }
}

// One channel per thread: gid < lanes * C owns channel gid % C of rows gid / C,
// + lanes, ...
template <typename TX, typename TR>
__global__ void __launch_bounds__(kThreads)
    residual_tail_scalar_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
                                const float* __restrict__ mean, const float* __restrict__ var,
                                const float* __restrict__ gamma, const float* __restrict__ beta,
                                TX* __restrict__ out, long long rows, int C, int lanes,
                                float eps) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (long long)lanes * C) return;
  const int c = (int)(gid % C);
  const float m = __ldg(mean + c), inv = inv_std(__ldg(var + c), eps);
  const float g = __ldg(gamma + c), b = __ldg(beta + c);
  for (long long r = gid / C; r < rows; r += lanes) {
    const long long o = r * C + c;
    out[o] = from_f<TX>(tail_one(to_f(x[o]), to_f(res[o]), m, inv, g, b));
  }
}

// Blocks of `fn` the card holds at once, once per device and kernel.
template <typename F>
cudaError_t resident_blocks(F fn, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, reinterpret_cast<const void*>(fn));
  auto it = cache.find(key);
  if (it == cache.end()) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
    if (err != cudaSuccess) return err;
    it = cache.emplace(key, sms * (per_sm < 1 ? 1 : per_sm)).first;
  }
  *blocks = it->second;
  return cudaSuccess;
}

// Row lanes: as many as the resident threads hold (at least one, at most the
// rows), each lane `width` threads wide.
long long row_lanes(int resident, int width, long long rows) {
  long long lanes = (long long)resident * kThreads / width;
  if (lanes < 1) lanes = 1;
  return lanes < rows ? lanes : rows;
}

template <typename TX, typename TR>
int launch(const void* x, const void* res, const void* mean, const void* var, const void* gamma,
           const void* beta, void* out, long long n, int C, float eps, cudaStream_t st) {
  constexpr int G = (sizeof(TX) == 2 || sizeof(TR) == 2) ? 8 : 4;
  const long long rows = n / C;
  const bool vec = C % G == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const auto* px = static_cast<const TX*>(x);
  const auto* pr = static_cast<const TR*>(res);
  const auto* pm = static_cast<const float*>(mean);
  const auto* pv = static_cast<const float*>(var);
  const auto* pg = static_cast<const float*>(gamma);
  const auto* pb = static_cast<const float*>(beta);
  auto* po = static_cast<TX*>(out);
  int resident = 0;
  if (vec) {
    auto fn = residual_tail_kernel<TX, TR, G>;
    const cudaError_t err = resident_blocks(fn, &resident);
    if (err != cudaSuccess) return (int)err;
    const long long lanes = row_lanes(resident, C / G, rows);
    const long long blocks = (lanes * (C / G) + kThreads - 1) / kThreads;
    fn<<<(unsigned)blocks, kThreads, 0, st>>>(px, pr, pm, pv, pg, pb, po, rows, C, (int)lanes,
                                              eps);
  } else {
    auto fn = residual_tail_scalar_kernel<TX, TR>;
    const cudaError_t err = resident_blocks(fn, &resident);
    if (err != cudaSuccess) return (int)err;
    const long long lanes = row_lanes(resident, C, rows);
    const long long blocks = (lanes * C + kThreads - 1) / kThreads;
    fn<<<(unsigned)blocks, kThreads, 0, st>>>(px, pr, pm, pv, pg, pb, po, rows, C, (int)lanes,
                                              eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error (0 on success). x, res and
// out: n = rows * C contiguous elements; x and out bfloat16 when x_bf16 != 0,
// else float32; res bfloat16 when res_bf16 != 0, else float32; mean, var,
// gamma, beta: contiguous f32 [C].
int dl4j_residual_tail(const void* x, const void* res, const void* mean, const void* var,
                       const void* gamma, const void* beta, void* out, long long n, int C,
                       float eps, int x_bf16, int res_bf16, void* stream) {
  if (n < 0 || C <= 0 || n % C != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16 && res_bf16) return launch<bf16, bf16>(x, res, mean, var, gamma, beta, out, n, C, eps, st);
  if (x_bf16) return launch<bf16, float>(x, res, mean, var, gamma, beta, out, n, C, eps, st);
  if (res_bf16) return launch<float, bf16>(x, res, mean, var, gamma, beta, out, n, C, eps, st);
  return launch<float, float>(x, res, mean, var, gamma, beta, out, n, C, eps, st);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
