// Fused Adam master update, written by hand for Hopper (sm_90a) and bound to
// PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel in deeplearning4j_tpu/ops/fused_update_pallas.py
// (_pallas_update / _k_fused, pl.pallas_call at :147).
//
// What it computes, elementwise over flat f32 vectors of any length n:
//   g       = grad * gscale                  (loss-scale unscale and clip, folded)
//   m'      = beta1 * m + (1 - beta1) * g
//   v'      = beta2 * v + (1 - beta2) * g * g
//   master' = master - alpha * m' / (sqrt(v') + eps)
// with alpha the bias-corrected step size. Same formula, in the same order of
// operations, as adam_update_reference() in ops/fused_update.py (_formula,
// fused_update_pallas.py:101-107). Every multiply and add is an explicitly
// rounded intrinsic, so the compiler fuses none of them into an FMA and the
// kernel rounds where the plain version rounds.
//
// master, m and v are updated in place: the JAX step donates these buffers
// (transformer.py:372) and writes the new values into them.
//
// What bounds it on the H100: bytes. Each element reads grad, m, v, master
// (16 B) and writes m, v, master (12 B): 28 B per parameter. At BERT-base's
// 108,922,170 parameters that is 3.05 GB, 0.91 ms at 3.35 TB/s; the 9 flops per
// element are far below any compute limit. Design: a grid-stride loop of 16-byte
// (float4) loads and stores when all four buffers are 16-byte aligned, a scalar
// loop for the tail and for unaligned buffers. The TPU kernel's 128-lane row
// padding is not needed here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Coef {
  float gscale, alpha, b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ void adam_one(float& p, float& m, float& v, float grad,
                                         const Coef& k) {
  const float g = __fmul_rn(grad, k.gscale);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.c2, g), g));
  const float upd = __fdiv_rn(__fmul_rn(k.alpha, m), __fadd_rn(__fsqrt_rn(v), k.eps));
  p = __fsub_rn(p, upd);
}

__global__ void fused_adam_vec4(float4* __restrict__ master, float4* __restrict__ m,
                                float4* __restrict__ v, const float4* __restrict__ grad,
                                long long n4, Coef k) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 p = master[i], mm = m[i], vv = v[i];
    const float4 g = grad[i];
    adam_one(p.x, mm.x, vv.x, g.x, k);
    adam_one(p.y, mm.y, vv.y, g.y, k);
    adam_one(p.z, mm.z, vv.z, g.z, k);
    adam_one(p.w, mm.w, vv.w, g.w, k);
    master[i] = p;
    m[i] = mm;
    v[i] = vv;
  }
}

__global__ void fused_adam_scalar(float* __restrict__ master, float* __restrict__ m,
                                  float* __restrict__ v, const float* __restrict__ grad,
                                  long long begin, long long n, Coef k) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float p = master[i], mm = m[i], vv = v[i];
    adam_one(p, mm, vv, grad[i], k);
    master[i] = p;
    m[i] = mm;
    v[i] = vv;
  }
}

constexpr int kThreads = 256;

int grid_for(long long work) {
  // enough blocks to keep every SM's memory pipe busy; the loop strides past
  const long long cap = 132LL * 16;
  const long long need = (work + kThreads - 1) / kThreads;
  return (int)(need < 1 ? 1 : (need < cap ? need : cap));
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). All four
// pointers are device pointers to contiguous f32 vectors of n elements;
// master, m and v are overwritten with the updated values. The betas come in
// double, as the Python floats they are.
int dl4j_fused_adam_update(void* master, void* m, void* v, const void* grad, long long n,
                           float gscale, float alpha, double beta1, double beta2, float eps,
                           void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  // 1 - beta is taken in double and rounded once, as Python does before the
  // f32 multiply in the plain version. Rounding beta first would not do:
  // 1 - (float)0.999 is 1.3e-5 away from (float)(1 - 0.999), which moves v'
  // wherever (1 - beta2) g^2 outweighs beta2 v (the first step, for one).
  const Coef k{gscale, alpha, (float)beta1, (float)(1.0 - beta1), (float)beta2,
               (float)(1.0 - beta2), eps};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(master);
  auto* mm = static_cast<float*>(m);
  auto* vv = static_cast<float*>(v);
  const auto* g = static_cast<const float*>(grad);
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(mm) |
                         reinterpret_cast<uintptr_t>(vv) | reinterpret_cast<uintptr_t>(g)) &
                        15u) == 0;
  long long done = 0;
  if (aligned && n >= 4) {
    const long long n4 = n / 4;
    fused_adam_vec4<<<grid_for(n4), kThreads, 0, s>>>(
        reinterpret_cast<float4*>(p), reinterpret_cast<float4*>(mm),
        reinterpret_cast<float4*>(vv), reinterpret_cast<const float4*>(g), n4, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    done = n4 * 4;
  }
  if (done < n) {
    fused_adam_scalar<<<grid_for(n - done), kThreads, 0, s>>>(p, mm, vv, g, done, n, k);
  }
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
