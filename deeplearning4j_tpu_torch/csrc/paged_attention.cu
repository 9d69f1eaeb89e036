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
// Design:
// - One block per (sequence, head, query tile of 1 row at Q = 1, else 8), so any
//   Q runs: the decode step (Q = 1), the speculative verify (Q = k + 1) and the
//   prefix-prefill suffix (Q = the suffix bucket, up to max_context) alike. The
//   TPU kernel's sequential page grid dimension is a loop inside the block; the
//   block reads its sequence's page-table row into shared memory and walks only
//   the keys its last row can see, which is exact: later keys are masked for
//   every row of the tile.
// - Every warp shares the block's keys, even at Q = 1: the warps take the
//   visible keys' 32-key chunks in turn, each through its own two-stage
//   cp.async ring of whole key rows in the pool's storage type (16 bytes a copy,
//   the K and V scales of fp8 pages by 4-byte copies), so loads overlap the math.
//   Rows are widened in registers (fp8 times its scale) as they are read.
// - A single row (decode), f32 queries and head widths past 128 run on the CUDA
//   cores: lane j scores key j against every row of the tile, so a score needs
//   no shuffles, and the probabilities go through shared memory to the context
//   product, where lane j owns dims j + 32 c. Tiles of 8 rows under bf16 queries
//   (verify, prefix) at head widths up to 128 run both products on the tensor
//   cores (mma.sync m16n8k16 through ldmatrix, rows 8-15 of the m16 tile zero,
//   the online softmax on the C fragments); fp8 chunks are dequantized to bf16
//   in shared memory first. That path rounds the probabilities, and fp8 pools'
//   dequantized K and V, to bf16 before the products, where the Pallas kernel
//   keeps f32: within the bf16 output's 2e-2 contract, not exact.
// - Online-softmax m, l and the context accumulator stay in f32. The warps'
//   states merge in shared memory in warp order, so two calls are bit-equal. A
//   warp that saw no key of a row (l = 0) weighs exactly 0 there, without an exp
//   of a -FLT_MAX difference.
// - Masked lanes contribute an explicit zero (paged_attention_pallas.py:154-157):
//   without it an all-masked chunk would add exp(0) = 1 per lane.
//
// What bounds it on the H100: the K/V bytes. At slots=8, 12 heads, head_dim 64,
// page_size 16 and 512 positions of context in bf16, one layer call must read
// 8 * 32 * 12 * 16 * 64 * 2 B * 2 = 12.6 MB, about 3.8 us at 3.35 TB/s (half of
// that for fp8 pools); the arithmetic (4 flops per key and head element) is far
// below the f32 rate.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;     // keys per warp chunk: lane j scores key j
constexpr int kStages = 2;     // cp.async ring depth per warp
constexpr int kMaxWarps = 8;

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

// one pool element (storage type) widened to f32
__device__ __forceinline__ float elem(const float* p) { return *p; }
__device__ __forceinline__ float elem(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float elem(const Fp8E4M3* p) {
  const __half h(__nv_cvt_fp8_to_halfraw(p->bits, __NV_E4M3));
  return __half2float(h);
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// c += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators. Fragment
// layout (lane = 4 g + t): c[0], c[1] row g, columns 2t and 2t+1; c[2], c[3]
// row g + 8; a[0] row g, k 2t..2t+1; a[1] row g + 8; a[2], a[3] k + 8.
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
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Shared memory of a block (the host sizes it with the same functions, and
// ops/paged_attention.py's launch_plan() mirrors them): the tile's query rows
// in f32 [rows][hd] and the sequence's page ids [P]; then per warp a ring of
// kStages chunks (K and V [32][hd + 16 bytes] in the storage type, rows padded
// so that lanes and ldmatrix read them without bank conflicts, and for fp8 the
// 32 keys' K and V scales), the chunk's probabilities [32][rows], and for fp8
// pools under 8-row tiles the chunk's K and V dequantized to bf16 [32][hd + 8]
// for the tensor cores. After the walk the rings hold the warps' states.
__host__ __device__ constexpr size_t stage_bytes(int hd, int kvb) {
  return 2 * (size_t)kChunk * (hd * kvb + 16) + 2 * kChunk * 4;
}
__host__ __device__ constexpr size_t conv_bytes(int hd, int kvb, int rows) {
  return kvb == 1 && rows == 8 ? 2 * (size_t)kChunk * (hd + 8) * 2 : 0;
}
__host__ __device__ constexpr size_t warp_bytes(int hd, int kvb, int rows) {
  return kStages * stage_bytes(hd, kvb) + (size_t)kChunk * rows * 4 + conv_bytes(hd, kvb, rows);
}
__host__ __device__ constexpr size_t head_bytes(int hd, int rows, int P) {
  return align16((size_t)rows * hd * 4 + (size_t)P * 4);
}
__host__ __device__ constexpr size_t smem_bytes(int hd, int kvb, int rows, int warps, int P) {
  return head_bytes(hd, rows, P) + (size_t)warps * warp_bytes(hd, kvb, rows);
}

// Grid (N * H * tiles): one block per (sequence n, head h, query tile); 32 *
// warps threads. The block takes the query rows [tile * RM, tile * RM + rows)
// and the keys those rows can see. Its warps take the keys' 32-key chunks in
// turn, each through its own cp.async ring; the warps' (m, l, acc) merge in
// shared memory in warp order and the block writes the tile's output. T is
// the query/output type, KV the pool element type, DPL = head_dim / 32
// elements of a row per lane, RM the rows of a tile (1 or 8). kscale/vscale are
// the fp8 scale planes [L, n_pages, H] (unused for float pools).
template <typename T, typename KV, int DPL, int RM>
__global__ void __launch_bounds__(kMaxWarps* kWarp)
    paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kpool,
                           const KV* __restrict__ vpool, const float* __restrict__ kscale,
                           const float* __restrict__ vscale, const int* __restrict__ tables,
                           const int* __restrict__ qbase, T* __restrict__ out, int H, int Q,
                           int ps, int P, int n_pages, int layer, int tiles, float scale) {
  constexpr int hd = DPL * kWarp;
  constexpr int kvb = sizeof(KV);
  constexpr int kVec = Widen<KV>::kVec;   // elements per 16 bytes
  constexpr int RB = hd * kvb;            // bytes of one key row
  constexpr int KP = RB + 16;             // padded K and V row pitch in bytes
  constexpr int kPieces = RB / 16;
  constexpr bool kFp8 = kvb == 1;
  constexpr size_t kStage = stage_bytes(hd, kvb);
  // 8-row tiles under bf16 queries take the tensor cores (mma.sync m16n8k16,
  // rows 8-15 of the m16 tile zero) up to head_dim 128, where the context
  // accumulators still fit the registers; f32 queries, whose 1e-5 contract
  // bf16 operands cannot keep, single rows and wider heads take the CUDA cores
  constexpr bool kMma = RM == 8 && sizeof(T) == 2 && DPL <= 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x / kWarp, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int tile = blockIdx.x % tiles, nh = blockIdx.x / tiles;
  const int n = nh / H, h = nh - n * H;
  const int row0 = tile * RM, R = min(RM, Q - row0);

  float* qs = reinterpret_cast<float*>(smem);  // [RM][hd]
  int* pg = reinterpret_cast<int*>(qs + RM * hd);
  unsigned char* ring = smem + head_bytes(hd, RM, P);
  unsigned char* mine = ring + (size_t)warp * warp_bytes(hd, kvb, RM);
  float* pbuf = reinterpret_cast<float*>(mine + kStages * kStage);

  // the page table row, the query rows and qbase, loaded side by side
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    pg[i] = min(max(tables[(size_t)n * P + i], 0), n_pages - 1);  // clamp like the XLA gather
  // rows past the tile's R are zero: the chunk loops run all RM rows
  // without branches, those rows masked
  for (int e = threadIdx.x; e < RM * hd; e += blockDim.x)
    qs[e] = e < R * hd ? to_f32(q[((size_t)nh * Q + row0) * hd + e]) : 0.f;
  const int base = qbase[n];
  const int last_pos = base + row0 + R - 1;
  // keys [0, ke): those the tile's last row can see, within the table
  const int ke = last_pos < 0 ? 0 : min(P * ps, last_pos + 1);
  const int n_chunks = (ke + kChunk - 1) / kChunk;
  __syncthreads();

  const size_t page_stride = (size_t)H * ps * hd;  // one page, all heads, in elements
  const size_t layer_off = (size_t)layer * n_pages * page_stride;
  const size_t head_off = (size_t)h * ps * hd;
  const size_t scale_off = (size_t)layer * n_pages * H + h;
  // chunk c into stage st: 16-byte copies of whole key rows, rows past ke
  // zero-filled. Lane j finds key j's row (one page lookup and one division
  // per lane), and the warp copies the rows piece by piece with the row
  // offsets shuffled across, so that neighbouring lanes copy neighbouring 16
  // bytes
  auto prefetch = [&](int c, int st) {
    unsigned char* ks = mine + st * kStage;
    unsigned char* vs = ks + kChunk * KP;
    const int f0 = c * kChunk, fl = f0 + lane;
    const int fp = fl < ke ? fl : 0;
    const int page = pg[fp / ps];
    const long long row =
        (long long)(layer_off + (size_t)page * page_stride + head_off + (size_t)(fp % ps) * hd);
#pragma unroll
    for (int i0 = 0; i0 < kChunk * kPieces; i0 += kWarp) {
      const int i = i0 + lane, j = i / kPieces, pc = i - j * kPieces;
      const long long src = __shfl_sync(kFull, row, j);
      const bool ok = f0 + j < ke;
      cp16(ks + j * KP + pc * 16, reinterpret_cast<const unsigned char*>(kpool + src) + pc * 16, ok);
      cp16(vs + j * KP + pc * 16, reinterpret_cast<const unsigned char*>(vpool + src) + pc * 16, ok);
    }
    if constexpr (kFp8) {
      float* sc = reinterpret_cast<float*>(vs + kChunk * KP);
      const bool ok = fl < ke;
      const size_t so = scale_off + (size_t)page * H;
      cp4(sc + lane, kscale + so, ok);
      cp4(sc + kChunk + lane, vscale + so, ok);
    }
  };

  float m[RM], l[RM], acc[RM][DPL];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = -FLT_MAX;
    l[r] = 0.f;  // this lane's part of the row sum
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  // the tensor-core path's state: the query rows as A fragments (row g =
  // lane / 4, k 2t..2t+1 and 2t+8..2t+9; rows 8-15 zero), the context
  // accumulators in the C layout, and row g's m and (this lane's part of) l
  const int g = lane >> 2, t4 = lane & 3;
  constexpr int KQ = kMma ? hd / 16 : 1, ND = kMma ? hd / 8 : 1;
  unsigned qa[KQ][2];
  float o[ND][4];
  float mg = -FLT_MAX, lg = 0.f;
  if constexpr (kMma) {
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
      const float* qr = qs + g * hd + 16 * k + 2 * t4;
      qa[k][0] = pack(qr[0], qr[1]);
      qa[k][1] = pack(qr[8], qr[9]);
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  }
  const int mine_n = n_chunks > warp ? (n_chunks - warp + W - 1) / W : 0;
  if (mine_n > 0) prefetch(warp, 0);
  cp_commit();
  for (int i = 0; i < mine_n; ++i) {
    const int c = warp + i * W, st = i & 1;
    if (i + 1 < mine_n) prefetch(c + W, st ^ 1);
    cp_commit();
    cp_wait_one();  // this lane's copies of chunk i have landed
    __syncwarp();   // and every lane's
    const unsigned char* ks = mine + st * kStage;
    const unsigned char* vs = ks + kChunk * KP;
    const float* sc = reinterpret_cast<const float*>(vs + kChunk * KP);
    const int f0 = c * kChunk, f = f0 + lane;
    if constexpr (kMma) {
      // bf16 rows for ldmatrix: the pool's own (bf16 pools), or lane j's
      // key j dequantized (fp8 pools: times its page's K or V scale, in f32,
      // then rounded to bf16)
      const __nv_bfloat16* kr = reinterpret_cast<const __nv_bfloat16*>(ks);
      const __nv_bfloat16* vr = reinterpret_cast<const __nv_bfloat16*>(vs);
      constexpr int RP = hd + 8;  // bf16 row pitch (KP / 2 for bf16 pools)
      if constexpr (kFp8) {
        __nv_bfloat16* kc =
            reinterpret_cast<__nv_bfloat16*>(mine + kStages * kStage + kChunk * RM * 4);
        __nv_bfloat16* vc = kc + kChunk * RP;
#pragma unroll
        for (int pc = 0; pc < kPieces; ++pc) {
          float kf[kVec], vf[kVec];
          Widen<KV>::run(*reinterpret_cast<const uint4*>(ks + lane * KP + pc * 16), sc[lane], kf);
          Widen<KV>::run(*reinterpret_cast<const uint4*>(vs + lane * KP + pc * 16),
                         sc[kChunk + lane], vf);
#pragma unroll
          for (int h8 = 0; h8 < kVec; h8 += 8) {
            uint4 kw, vw;
            kw.x = pack(kf[h8], kf[h8 + 1]);
            kw.y = pack(kf[h8 + 2], kf[h8 + 3]);
            kw.z = pack(kf[h8 + 4], kf[h8 + 5]);
            kw.w = pack(kf[h8 + 6], kf[h8 + 7]);
            vw.x = pack(vf[h8], vf[h8 + 1]);
            vw.y = pack(vf[h8 + 2], vf[h8 + 3]);
            vw.z = pack(vf[h8 + 4], vf[h8 + 5]);
            vw.w = pack(vf[h8 + 6], vf[h8 + 7]);
            *reinterpret_cast<uint4*>(kc + lane * RP + pc * kVec + h8) = kw;
            *reinterpret_cast<uint4*>(vc + lane * RP + pc * kVec + h8) = vw;
          }
        }
        __syncwarp();
        kr = kc;
        vr = vc;
      }
      // scores S = Q K^T for the chunk's 32 keys (4 n8 tiles)
      float sc4[4][4] = {};
      const __nv_bfloat16* pk = kr + ((lane & 7) + (lane >> 4) * 8) * RP + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int k = 0; k < KQ; ++k) {
        const unsigned a[4] = {qa[k][0], 0u, qa[k][1], 0u};
#pragma unroll
        for (int nb = 0; nb < 4; nb += 2) {
          unsigned r[4];
          ldsm4(r, pk + nb * 8 * RP + k * 16);
          mma(sc4[nb], a, r[0], r[1]);
          mma(sc4[nb + 1], a, r[2], r[3]);
        }
      }
      // row g's online softmax over its 8 scores here and its quad's; masked
      // keys (and rows past R) contribute an explicit zero
      const int qpos = base + row0 + g;
      float mx = -FLT_MAX;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int fk = f0 + 8 * nb + 2 * t4 + e;
          const bool valid = g < R && fk < ke && fk <= qpos;
          sc4[nb][e] = valid ? sc4[nb][e] * scale : -FLT_MAX;
          mx = fmaxf(mx, sc4[nb][e]);
        }
      const float m_new = fmaxf(mg, quad_max(mx));
      const float alpha = expf(mg - m_new);
      float ls = 0.f;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int fk = f0 + 8 * nb + 2 * t4 + e;
          const bool valid = g < R && fk < ke && fk <= qpos;
          sc4[nb][e] = valid ? expf(sc4[nb][e] - m_new) : 0.f;
          ls += sc4[nb][e];
        }
      lg = lg * alpha + ls;
      mg = m_new;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][0] *= alpha;
        o[d][1] *= alpha;
      }
      // context O += P V: P from the C fragments (rows 8-15 zero), V through
      // transposed ldmatrix
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const unsigned a[4] = {pack(sc4[2 * kk][0], sc4[2 * kk][1]), 0u,
                               pack(sc4[2 * kk + 1][0], sc4[2 * kk + 1][1]), 0u};
        const __nv_bfloat16* pv =
            vr + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RP + (lane >> 4) * 8;
#pragma unroll
        for (int d = 0; d < ND; d += 2) {
          unsigned r[4];
          ldsm4t(r, pv + d * 8);
          mma(o[d], a, r[0], r[1]);
          mma(o[d + 1], a, r[2], r[3]);
        }
      }
    } else {
      // scores of key f against the tile's rows (fp8: times its page's K scale)
      float sco[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) sco[r] = 0.f;
      const float ksc = kFp8 ? sc[lane] : 1.f;
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc) {
        float kf[kVec];
        Widen<KV>::run(*reinterpret_cast<const uint4*>(ks + lane * KP + pc * 16), ksc, kf);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float4* qr = reinterpret_cast<const float4*>(qs + r * hd + pc * kVec);
#pragma unroll
          for (int e4 = 0; e4 < kVec / 4; ++e4) {
            const float4 qv = qr[e4];
            sco[r] += qv.x * kf[4 * e4] + qv.y * kf[4 * e4 + 1] + qv.z * kf[4 * e4 + 2] +
                      qv.w * kf[4 * e4 + 3];
          }
        }
      }
      // online softmax per row; masked lanes contribute an explicit zero
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const bool valid = r < R && f < ke && f <= base + row0 + r;
        const float sv = valid ? sco[r] * scale : -FLT_MAX;
        const float m_new = fmaxf(m[r], warp_max(sv));
        const float alpha = expf(m[r] - m_new);
        const float p = valid ? expf(sv - m_new) : 0.f;
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int c2 = 0; c2 < DPL; ++c2) acc[r][c2] *= alpha;
        m[r] = m_new;
        pbuf[lane * RM + r] = p;
      }
      __syncwarp();
      // context: lane owns dims lane + 32 c. Keys past ke have p = 0 and
      // zero-filled rows (scale 0 for fp8), so the loop runs over the whole
      // chunk, unrolled, with the probabilities read 4 rows at a time
#pragma unroll 8
      for (int j = 0; j < kChunk; ++j) {
        const KV* vrow = reinterpret_cast<const KV*>(vs + j * KP);
        const float vsc = kFp8 ? sc[kChunk + j] : 1.f;
        float v[DPL];
#pragma unroll
        for (int c2 = 0; c2 < DPL; ++c2) v[c2] = elem(vrow + lane + kWarp * c2) * vsc;
        float pj[RM];
        if constexpr (RM % 4 == 0) {
#pragma unroll
          for (int r4 = 0; r4 < RM; r4 += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pbuf + j * RM + r4);
            pj[r4] = p4.x;
            pj[r4 + 1] = p4.y;
            pj[r4 + 2] = p4.z;
            pj[r4 + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < RM; ++r) pj[r] = pbuf[j * RM + r];
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c2 = 0; c2 < DPL; ++c2) acc[r][c2] += pj[r] * v[c2];
      }
    }
    __syncwarp();  // every lane is done with stage st before it is refilled
  }

  // the block's merge of its warps, in warp order, through the spent rings
  __syncthreads();
  float* racc = reinterpret_cast<float*>(ring);  // [W][RM][hd]
  float* rml = racc + (size_t)W * RM * hd;       // [W][RM][2]
  if constexpr (kMma) {
    lg = quad_sum(lg);
    if (g < R) {
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<float2*>(racc + (warp * RM + g) * hd + 8 * d + 2 * t4) =
            make_float2(o[d][0], o[d][1]);
      if (t4 == 0) {
        rml[(warp * RM + g) * 2] = mg;
        rml[(warp * RM + g) * 2 + 1] = lg;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      const float lr = warp_sum(l[r]);
#pragma unroll
      for (int c2 = 0; c2 < DPL; ++c2) racc[(warp * RM + r) * hd + lane + kWarp * c2] = acc[r][c2];
      if (lane == 0) {
        rml[(warp * RM + r) * 2] = m[r];
        rml[(warp * RM + r) * 2 + 1] = lr;
      }
    }
  }
  __syncthreads();
  const size_t prow = (size_t)nh * Q + row0;  // the tile's first (n, h, row)
  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    float M = -FLT_MAX;
    for (int w = 0; w < W; ++w)
      if (rml[(w * RM + r) * 2 + 1] > 0.f) M = fmaxf(M, rml[(w * RM + r) * 2]);
    float A = 0.f, L = 0.f;
    for (int w = 0; w < W; ++w) {
      const float lw = rml[(w * RM + r) * 2 + 1];
      if (lw > 0.f) {
        const float wt = expf(rml[(w * RM + r) * 2] - M);
        A += wt * racc[(w * RM + r) * hd + d];
        L += wt * lw;
      }
    }
    // every row admits flat position 0 (qbase >= 0), so L >= 1 here
    out[(prow + r) * hd + d] = from_f32<T>(L > 0.f ? A / L : 0.f);
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
  int N, H, Q, ps, P, n_pages, layer, rows, warps;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int DPL, int RM>
cudaError_t launch(const Args& a) {
  constexpr int hd = DPL * kWarp;
  const int tiles = (a.Q + RM - 1) / RM;
  const size_t smem = smem_bytes(hd, sizeof(KV), RM, a.warps, a.P);
  auto kernel = paged_attention_kernel<T, KV, DPL, RM>;
  // the shared-memory opt-in, per device, once: all the card lets a block
  // take beside the kernel's static shared memory, so every plan of this
  // instance launches
  static std::mutex mu;
  static std::map<int, int> opt_in;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    const std::lock_guard<std::mutex> lock(mu);
    auto it = opt_in.find(dev);
    if (it == opt_in.end()) {
      int max_smem = 0;
      cudaFuncAttributes fa{};
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
      const int dyn = max_smem - (int)fa.sharedSizeBytes;
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
      if (err != cudaSuccess) {
        cudaGetLastError();  // leave no stale error for a later launch's check
        return err;
      }
      it = opt_in.emplace(dev, dyn).first;
    }
    if (smem > (size_t)it->second) return cudaErrorInvalidValue;
  }
  kernel<<<a.N * a.H * tiles, a.warps * kWarp, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      a.kscale, a.vscale, a.tables, a.qbase, static_cast<T*>(a.out), a.H, a.Q, a.ps, a.P,
      a.n_pages, a.layer, tiles, a.scale);
  return cudaGetLastError();
}

template <typename T, typename KV, int RM>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
#define DL4J_PA_CASE(D) \
  case D * kWarp:       \
    return launch<T, KV, D, RM>(a);
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

template <typename T, typename KV>
cudaError_t dispatch(int hd, const Args& a) {
  return a.rows == 1 ? dispatch_hd<T, KV, 1>(hd, a) : dispatch_hd<T, KV, 8>(hd, a);
}

}  // namespace

extern "C" {

// Launches on the given stream and returns cudaGetLastError() (0 on success).
// The arguments come packed, so that the wrapper's call converts four values
// instead of twenty-odd. ptrs holds device pointers to contiguous tensors and
// the stream: q, k, v, k_scale, v_scale, tables, qbase, out, stream, where q
// and out are [N, H, Q, hd], the k and v pools [L, n_pages, H, ps, hd], tables
// [N, P] int32 and qbase [N] int32. ints holds is_bf16 (the element type of q
// and out, else float32), is_fp8 (the pools hold float8_e4m3fn with f32 scale
// planes k_scale and v_scale [L, n_pages, H]; otherwise the pools have q's
// type and the planes are unused), N, H, Q, hd, ps, P, n_pages, rows per tile
// (1 or 8), warps (1-8) and the device to launch on.
int dl4j_paged_attention(void* const* ptrs, const int* ints, int layer, float scale) {
  const int is_bf16 = ints[0], is_fp8 = ints[1], N = ints[2], H = ints[3], Q = ints[4],
            hd = ints[5], ps = ints[6], P = ints[7], n_pages = ints[8], rows = ints[9],
            warps = ints[10], device = ints[11];
  void* const k_scale = ptrs[3];
  void* const v_scale = ptrs[4];
  if (N < 1 || H < 1 || Q < 1 || ps < 1 || P < 1 || layer < 0 || n_pages < 1 ||
      (rows != 1 && rows != 8) || warps < 1 || warps > kMaxWarps ||
      (is_fp8 && (!k_scale || !v_scale)) ||
      (long long)N * H * ((Q + rows - 1) / rows) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{ptrs[0],
               ptrs[1],
               ptrs[2],
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(ptrs[5]),
               static_cast<const int*>(ptrs[6]),
               ptrs[7],
               N,
               H,
               Q,
               ps,
               P,
               n_pages,
               layer,
               rows,
               warps,
               scale,
               static_cast<cudaStream_t>(ptrs[8])};
  if (is_fp8)
    err = is_bf16 ? dispatch<__nv_bfloat16, Fp8E4M3>(hd, a) : dispatch<float, Fp8E4M3>(hd, a);
  else
    err = is_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(hd, a) : dispatch<float, float>(hd, a);
  if (cur != device) cudaSetDevice(cur);
  return (int)err;
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
