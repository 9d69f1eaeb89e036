// Residual-block tail (batch-norm apply + residual add + ReLU), written by hand
// for Hopper (sm_90a) and bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel in deeplearning4j_tpu/ops/residual_tail_pallas.py
// (_tail_kernel / _k_tail, pl.pallas_call at :63), behind bn_relu_residual.
//
// What it computes, over x and res of [rows, C] (f32 or bf16) with f32
// per-channel mean, var, gamma, beta:
//   out = relu((x - mean) * rsqrt(var + eps) * gamma + beta + res)
// in f32, in _k_tail's order of operations, then cast to x's type. Every
// multiply and add is an explicitly rounded intrinsic (no FMA contraction), and
// rsqrt is 1 / sqrt correctly rounded, so f32 results match the plain version
// (ops/residual_tail.py) to rounding.
//
// What bounds it on the H100: bytes. It reads x and res once and writes out
// once: at ResNet-50's 56x56x256 join at batch 256 in bf16, 1.23 GB, 368 us at
// 3.35 TB/s; there are 6 flops per element. Design: each block first stages
// the per-channel mean, 1/sqrt(var + eps), gamma and beta in shared memory (16
// bytes per channel, read once per block), then walks the elements in a
// grid-stride loop, 16 bytes of x and of res per thread per step where C and
// the pointers allow, one element at a time elsewhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

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

// p: mean | inv | gamma | beta, C each
__device__ __forceinline__ float tail_one(float x, float r, const float* p, int c, int C) {
  const float z = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, p[c]), p[C + c]), p[2 * C + c]), p[3 * C + c]),
      r);
  return z > 0.f ? z : 0.f;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    residual_tail_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         const float* __restrict__ mean, const float* __restrict__ var,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         T* __restrict__ out, long long n, int C, float eps) {
  extern __shared__ float p[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    p[c] = mean[c];
    p[C + c] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var[c], eps)));
    p[2 * C + c] = gamma[c];
    p[3 * C + c] = beta[c];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const long long nv = n / V;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nv; i += stride) {
      const uint4 ux = reinterpret_cast<const uint4*>(x)[i];
      const uint4 ur = reinterpret_cast<const uint4*>(res)[i];
      const T* vx = reinterpret_cast<const T*>(&ux);
      const T* vr = reinterpret_cast<const T*>(&ur);
      const int c0 = (int)((i * V) % C);
      uint4 uo;
      T* vo = reinterpret_cast<T*>(&uo);
#pragma unroll
      for (int j = 0; j < V; ++j) vo[j] = from_f<T>(tail_one(to_f(vx[j]), to_f(vr[j]), p, c0 + j, C));
      reinterpret_cast<uint4*>(out)[i] = uo;
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
      out[i] = from_f<T>(tail_one(to_f(x[i]), to_f(res[i]), p, (int)(i % C), C));
    }
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* mean, const void* var, const void* gamma,
           const void* beta, void* out, long long n, int C, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const long long work = vec ? n / V : n;
  const long long cap = 132LL * 8;
  long long blocks = (work + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
  const size_t smem = (size_t)16 * C;
  auto kernel = vec ? residual_tail_kernel<T, true> : residual_tail_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), n, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). x, res
// and out: n = rows * C contiguous elements, bfloat16 when bf16 != 0, else
// float32; mean, var, gamma, beta: contiguous f32 [C].
int dl4j_residual_tail(const void* x, const void* res, const void* mean, const void* var,
                       const void* gamma, const void* beta, void* out, long long n, int C,
                       float eps, int bf16, void* stream) {
  if (n < 0 || C <= 0 || n % C != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, res, mean, var, gamma, beta, out, n, C, eps, st);
  return launch<float>(x, res, mean, var, gamma, beta, out, n, C, eps, st);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
