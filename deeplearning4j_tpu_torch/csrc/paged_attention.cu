// Paged attention for the serving decode step, written by hand for Hopper
// (sm_90a) and bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel in deeplearning4j_tpu/ops/paged_attention_pallas.py
// (_pallas_paged_attention / _kernel, pl.pallas_call at :203), float pools only.
// The fp8 branch of that kernel (per-page, per-head scale planes) is not ported;
// the Python wrapper raises NotImplementedError on an fp8 tree.
//
// What it computes, per layer: for query i of sequence n at absolute position
// qbase[n] + i, softmax attention over the keys at flat positions
// p * page_size + o <= qbase[n] + i, where flat position p * page_size + o of
// sequence n lives at pool[layer, tables[n, p], h, o]. Same formula as the plain
// version paged_attention_reference() in ops/paged_attention.py.
//
// Design (simple and correct first):
// - One block per (n, h). The TPU kernel's sequential page grid dimension is a
//   loop inside the block; the block reads tables[n, p] itself.
// - A tile of whole K/V pages [tile_pages * page_size, head_dim] is staged in
//   shared memory, widened to f32 (16-byte vector loads from the pool).
// - One warp per query row; lanes split head_dim (lane owns d = lane + 32 * c),
//   scores are reduced with warp shuffles. Online-softmax m, l and the context
//   accumulator stay in registers in f32; the output is acc / l cast to the
//   pool's type.
// - Pages whose first flat position is past qbase[n] + Q - 1 are fully masked
//   for every row and are skipped, which is exact.
// - Masked lanes contribute an explicit zero (paged_attention_pallas.py:154-157):
//   without it an all-masked chunk would add exp(0) = 1 per lane.
//
// What bounds it on the H100: the K/V bytes. At slots=8, 12 heads, head_dim 64,
// page_size 16 and 512 positions of context in bf16, one layer call must read
// 8 * 32 * 12 * 16 * 64 * 2 B * 2 = 12.6 MB, about 3.8 us at 3.35 TB/s; the
// arithmetic (4 flops per key and head element) is far below the tensor-core
// or even the f32 rate. N * H = 96 blocks do not fill the card's 132 SMs, and
// the page loads are not overlapped with compute. Splitting a sequence's pages
// over several blocks (flash-decoding) and TMA loads into a ring of shared-memory
// stages are the next steps; they are not done here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Grid: N * H blocks. Block: 32 * n_warps threads, n_warps >= Q.
// DPL = head_dim / 32 elements of a row per lane.
template <typename T, int DPL>
__global__ void paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                                       const T* __restrict__ vpool,
                                       const int* __restrict__ tables,
                                       const int* __restrict__ qbase, T* __restrict__ out,
                                       int H, int Q, int ps, int P, int n_pages, int layer,
                                       int tile_pages, float scale) {
  constexpr int hd = DPL * kWarp;
  constexpr int kVec = 16 / sizeof(T);  // pool elements per 16-byte load
  extern __shared__ __align__(16) float smem[];
  const int page_elems = ps * hd;
  float* ks = smem;                                   // [tile_pages * ps, hd]
  float* vs = smem + (size_t)tile_pages * page_elems;  // [tile_pages * ps, hd]

  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const int lane = threadIdx.x % kWarp;
  const int row = threadIdx.x / kWarp;  // the query row this warp owns
  const bool has_row = row < Q;
  const int base = qbase[n];
  const int qpos = base + row;
  // pages past the last row's position are masked for every row
  const int last_pos = base + Q - 1;
  const int n_live = last_pos < 0 ? 0 : min(P, last_pos / ps + 1);

  float qv[DPL];
  float acc[DPL];
  float m = -FLT_MAX;
  float l = 0.f;
  if (has_row) {
    const T* qrow = q + (((size_t)n * H + h) * Q + row) * hd;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      qv[c] = to_f32(qrow[lane + kWarp * c]);
      acc[c] = 0.f;
    }
  }

  const size_t page_stride = (size_t)H * page_elems;  // one page, all heads
  const size_t layer_off = (size_t)layer * n_pages * page_stride;
  const size_t head_off = (size_t)h * page_elems;

  for (int p0 = 0; p0 < n_live; p0 += tile_pages) {
    const int tp = min(tile_pages, n_live - p0);
    __syncthreads();  // every warp is done with the previous tile
    const int tile_elems = tp * page_elems;
    for (int e = threadIdx.x * kVec; e < tile_elems; e += blockDim.x * kVec) {
      const int t = e / page_elems;
      const int r = e - t * page_elems;
      int page = tables[(size_t)n * P + p0 + t];
      page = min(max(page, 0), n_pages - 1);  // clamp like the XLA gather
      const size_t src = layer_off + (size_t)page * page_stride + head_off + r;
      const uint4 kraw = *reinterpret_cast<const uint4*>(kpool + src);
      const uint4 vraw = *reinterpret_cast<const uint4*>(vpool + src);
      const T* kk = reinterpret_cast<const T*>(&kraw);
      const T* vv = reinterpret_cast<const T*>(&vraw);
#pragma unroll
      for (int u = 0; u < kVec; u += 4) {
        *reinterpret_cast<float4*>(ks + e + u) =
            make_float4(to_f32(kk[u]), to_f32(kk[u + 1]), to_f32(kk[u + 2]), to_f32(kk[u + 3]));
        *reinterpret_cast<float4*>(vs + e + u) =
            make_float4(to_f32(vv[u]), to_f32(vv[u + 1]), to_f32(vv[u + 2]), to_f32(vv[u + 3]));
      }
    }
    __syncthreads();
    if (!has_row) continue;
    const int keys = tp * ps;
    const int flat0 = p0 * ps;
    for (int j0 = 0; j0 < keys; j0 += kWarp) {
      const int jn = min(kWarp, keys - j0);
      // scores of keys j0 .. j0 + jn - 1; lane jj keeps key j0 + jj's score
      float s_mine = -FLT_MAX;
      for (int jj = 0; jj < jn; ++jj) {
        const float* krow = ks + (size_t)(j0 + jj) * hd;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) part += qv[c] * krow[lane + kWarp * c];
        const float s = warp_sum(part) * scale;
        if (lane == jj) s_mine = s;
      }
      const bool valid = lane < jn && flat0 + j0 + lane <= qpos;
      if (!valid) s_mine = -FLT_MAX;
      const float m_new = fmaxf(m, warp_max(s_mine));
      const float alpha = expf(m - m_new);
      const float pexp = valid ? expf(s_mine - m_new) : 0.f;
      l = l * alpha + warp_sum(pexp);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[c] *= alpha;
      for (int jj = 0; jj < jn; ++jj) {
        const float pj = __shfl_sync(kFull, pexp, jj);
        const float* vrow = vs + (size_t)(j0 + jj) * hd;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[c] += pj * vrow[lane + kWarp * c];
      }
      m = m_new;
    }
  }

  if (has_row) {
    // every row admits flat position 0 (qbase >= 0), so l >= 1 here
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + (((size_t)n * H + h) * Q + row) * hd;
#pragma unroll
    for (int c = 0; c < DPL; ++c) orow[lane + kWarp * c] = from_f32<T>(acc[c] * inv);
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* qbase, void* out, int N, int H, int Q, int ps, int P,
                   int n_pages, int layer, int tile_pages, float scale, cudaStream_t stream) {
  const int n_warps = Q < 4 ? 4 : Q;
  const size_t smem = 2 * (size_t)tile_pages * ps * DPL * kWarp * sizeof(float);
  auto kernel = paged_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<N * H, n_warps * kWarp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      qbase, static_cast<T*>(out), H, Q, ps, P, n_pages, layer, tile_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, const int* tables,
                     const int* qbase, void* out, int N, int H, int Q, int ps, int P,
                     int n_pages, int layer, int tile_pages, float scale, cudaStream_t stream) {
  switch (hd) {
#define DL4J_PA_CASE(D)                                                                 \
  case D * kWarp:                                                                       \
    return launch<T, D>(q, k, v, tables, qbase, out, N, H, Q, ps, P, n_pages, layer,    \
                        tile_pages, scale, stream);
    DL4J_PA_CASE(1)
    DL4J_PA_CASE(2)
    DL4J_PA_CASE(3)
    DL4J_PA_CASE(4)
    DL4J_PA_CASE(5)
    DL4J_PA_CASE(6)
    DL4J_PA_CASE(7)
    DL4J_PA_CASE(8)
#undef DL4J_PA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). Pointers
// are device pointers to contiguous tensors: q and out [N, H, Q, hd]; k and v
// pools [L, n_pages, H, ps, hd]; tables [N, P] int32; qbase [N] int32.
// is_bf16 selects the element type of q, the pools and out (else float32).
int dl4j_paged_attention(int is_bf16, const void* q, const void* k, const void* v,
                         const void* tables, const void* qbase, void* out, int N, int H, int Q,
                         int hd, int ps, int P, int n_pages, int layer, int tile_pages,
                         float scale, void* stream) {
  if (N < 1 || H < 1 || Q < 1 || Q > kWarp || ps < 1 || P < 1 || tile_pages < 1 ||
      layer < 0 || n_pages < 1)
    return (int)cudaErrorInvalidValue;
  const auto* t = static_cast<const int*>(tables);
  const auto* b = static_cast<const int*>(qbase);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, t, b, out, N, H, Q, ps, P, n_pages, layer,
                                        tile_pages, scale, s)
              : dispatch<float>(hd, q, k, v, t, b, out, N, H, Q, ps, P, n_pages, layer,
                                tile_pages, scale, s);
  return (int)err;
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
