// Paged attention for the serving engine, written by hand for Hopper (sm_90a)
// and bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel in deeplearning4j_tpu/ops/paged_attention_pallas.py
// (_pallas_paged_attention / _kernel, pl.pallas_call at :203), both branches: float
// pools (f32 or bf16, the query's type) and fp8 pools (float8_e4m3fn with f32
// per-page-per-head scale planes, the kernel's `fp8` path at :140-142).
//
// What it computes, per layer: for query i of sequence n at absolute position
// qbase[n] + i, softmax attention over the keys at flat positions
// p * page_size + o <= qbase[n] + i, where flat position p * page_size + o of
// sequence n lives at pool[layer, tables[n, p], h, o] (times scale[layer,
// tables[n, p], h] for fp8 pools). Same formula as the plain version
// paged_attention_reference() in ops/paged_attention.py.
//
// Design (simple and correct first):
// - Grid (N * H, query tiles). A tile holds up to 32 query rows, so any Q runs:
//   the decode step (Q = 1), the speculative verify (Q = k + 1) and the
//   prefix-prefill suffix (Q = the suffix bucket, up to max_context) alike. The
//   TPU kernel's sequential page grid dimension is a loop inside the block; the
//   block reads tables[n, p] itself and walks only the pages its last row can
//   see, (qbase + last row) / page_size + 1, which is exact: later pages are
//   masked for every row of the tile.
// - A tile of whole K/V pages [tile_pages * page_size, head_dim] is staged in
//   shared memory, widened to f32, with 16-byte vector loads from the pool: four
//   f32, eight bf16 or sixteen fp8 elements per load. fp8 pages are dequantised
//   as they are staged, each element times its page-and-head scale in f32 (the
//   Pallas kernel's k_ref.astype(f32) * ks), so HBM traffic stays fp8.
// - One warp per query row; lanes split head_dim (lane owns d = lane + 32 * c),
//   scores are reduced with warp shuffles. Online-softmax m, l and the context
//   accumulator stay in registers in f32; the output is acc / l cast to the
//   query's type.
// - Masked lanes contribute an explicit zero (paged_attention_pallas.py:154-157):
//   without it an all-masked chunk would add exp(0) = 1 per lane.
//
// What bounds it on the H100: the K/V bytes. At slots=8, 12 heads, head_dim 64,
// page_size 16 and 512 positions of context in bf16, one layer call must read
// 8 * 32 * 12 * 16 * 64 * 2 B * 2 = 12.6 MB, about 3.8 us at 3.35 TB/s (half of
// that for fp8 pools); the arithmetic (4 flops per key and head element) is far
// below the f32 rate. N * H = 96 blocks do not fill the card's 132 SMs, and the
// page loads are not overlapped with compute, so the decode call is set by
// latency, not bytes. Splitting a sequence's pages over several blocks
// (flash-decoding), TMA loads into a ring of shared-memory stages and wgmma for
// the wide prefix tiles are the next steps; they are not done here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kTileRows = 32;  // query rows per block: one warp each
constexpr unsigned kFull = 0xffffffffu;

// Storage tag of an fp8 e4m3 pool element (one byte).
struct Fp8E4M3 {
  uint8_t bits;
};

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

// Widen one 16-byte load of pool elements to f32 (times `scale` for fp8).
template <typename KV>
struct Widen;

template <>
struct Widen<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void run(const uint4& raw, float, float* out) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) out[u] = f[u];
  }
};

template <>
struct Widen<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void run(const uint4& raw, float, float* out) {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) out[u] = __bfloat162float(b[u]);
  }
};

template <>
struct Widen<Fp8E4M3> {
  static constexpr int kVec = 16;
  __device__ __forceinline__ static void run(const uint4& raw, float scale, float* out) {
    const __nv_fp8x2_storage_t* pairs = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec / 2; ++u) {
      // e4m3 -> f16 is exact, and so is f16 -> f32
      const __half2 h(__nv_cvt_fp8x2_to_halfraw2(pairs[u], __NV_E4M3));
      const float2 f = __half22float2(h);
      out[2 * u] = f.x * scale;
      out[2 * u + 1] = f.y * scale;
    }
  }
};

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

// Grid: (N * H, ceil(Q / tile_rows)). Block: 32 * n_warps threads,
// n_warps >= tile_rows. T is the query/output type, KV the pool element type.
// DPL = head_dim / 32 elements of a row per lane. kscale/vscale are the fp8
// scale planes [L, n_pages, H] (unused for float pools).
template <typename T, typename KV, int DPL>
__global__ void paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kpool,
                                       const KV* __restrict__ vpool,
                                       const float* __restrict__ kscale,
                                       const float* __restrict__ vscale,
                                       const int* __restrict__ tables,
                                       const int* __restrict__ qbase, T* __restrict__ out,
                                       int H, int Q, int tile_rows, int ps, int P, int n_pages,
                                       int layer, int tile_pages, float scale) {
  constexpr int hd = DPL * kWarp;
  constexpr bool kFp8 = sizeof(KV) == 1;
  constexpr int kVec = Widen<KV>::kVec;  // pool elements per 16-byte load
  extern __shared__ __align__(16) float smem[];
  const int page_elems = ps * hd;
  float* ks = smem;                                   // [tile_pages * ps, hd]
  float* vs = smem + (size_t)tile_pages * page_elems;  // [tile_pages * ps, hd]

  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int row0 = blockIdx.y * tile_rows;
  const int row = row0 + warp;  // the query row this warp owns
  const bool has_row = warp < tile_rows && row < Q;
  const int base = qbase[n];
  const int qpos = base + row;
  // pages past the tile's last row's position are masked for every row
  const int last_pos = base + min(Q, row0 + tile_rows) - 1;
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
  const size_t scale_off = (size_t)layer * n_pages * H + h;

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
      float ksc = 1.f, vsc = 1.f;
      if constexpr (kFp8) {
        ksc = kscale[scale_off + (size_t)page * H];
        vsc = vscale[scale_off + (size_t)page * H];
      }
      float kf[kVec], vf[kVec];
      Widen<KV>::run(kraw, ksc, kf);
      Widen<KV>::run(vraw, vsc, vf);
#pragma unroll
      for (int u = 0; u < kVec; u += 4) {
        *reinterpret_cast<float4*>(ks + e + u) = make_float4(kf[u], kf[u + 1], kf[u + 2], kf[u + 3]);
        *reinterpret_cast<float4*>(vs + e + u) = make_float4(vf[u], vf[u + 1], vf[u + 2], vf[u + 3]);
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kscale;
  const float* vscale;
  const int* tables;
  const int* qbase;
  void* out;
  int N, H, Q, ps, P, n_pages, layer, tile_pages;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int DPL>
cudaError_t launch(const Args& a) {
  const int tile_rows = a.Q < kTileRows ? a.Q : kTileRows;
  const int n_tiles = (a.Q + tile_rows - 1) / tile_rows;
  const int n_warps = tile_rows < 4 ? 4 : tile_rows;
  const size_t smem = 2 * (size_t)a.tile_pages * a.ps * DPL * kWarp * sizeof(float);
  auto kernel = paged_attention_kernel<T, KV, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.N * a.H, n_tiles);
  kernel<<<grid, n_warps * kWarp, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      a.kscale, a.vscale, a.tables, a.qbase, static_cast<T*>(a.out), a.H, a.Q, tile_rows, a.ps,
      a.P, a.n_pages, a.layer, a.tile_pages, a.scale);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch(int hd, const Args& a) {
  switch (hd) {
#define DL4J_PA_CASE(D) \
  case D * kWarp:       \
    return launch<T, KV, D>(a);
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
// is_bf16 selects the element type of q and out (else float32). is_fp8 says the
// pools hold float8_e4m3fn with f32 scale planes k_scale and v_scale
// [L, n_pages, H]; otherwise the pools have q's type and the planes are unused.
int dl4j_paged_attention(int is_bf16, int is_fp8, const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale, const void* tables,
                         const void* qbase, void* out, int N, int H, int Q, int hd, int ps, int P,
                         int n_pages, int layer, int tile_pages, float scale, void* stream) {
  if (N < 1 || H < 1 || Q < 1 || (Q + kTileRows - 1) / kTileRows > 65535 || ps < 1 || P < 1 ||
      tile_pages < 1 || layer < 0 || n_pages < 1 || (is_fp8 && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  const Args a{q,
               k,
               v,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tables),
               static_cast<const int*>(qbase),
               out,
               N,
               H,
               Q,
               ps,
               P,
               n_pages,
               layer,
               tile_pages,
               scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (is_bf16)
    err = is_fp8 ? dispatch<__nv_bfloat16, Fp8E4M3>(hd, a) : dispatch<__nv_bfloat16, __nv_bfloat16>(hd, a);
  else
    err = is_fp8 ? dispatch<float, Fp8E4M3>(hd, a) : dispatch<float, float>(hd, a);
  return (int)err;
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
