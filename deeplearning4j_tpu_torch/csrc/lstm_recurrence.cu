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
// (f32 or bf16; the wrapper runs a call that mixes the two, or holds any f16,
// on the f32 grid design over widened inputs, with h rounded to w_hh's type
// before the product where w_hh is bf16 or f16: Args::round_h), with h and c
// carried in f32:
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
// - Every tile is bounds-checked: any T, N and H >= 1 (N * 4H below 2^31).
//   Where the tiles outnumber the blocks the card holds at once (N past 256,
//   or H past 512), a block walks several tiles a step and each tile's c (dh
//   and dc) waits in an f32 scratch between steps; where a block's columns
//   (and rows) of w_hh do not fit its shared memory (the backward past
//   H=832), or one block per unit tile does not fit the card (H past 1056 on
//   the H100), blocks read w_hh from L2 each step (make_plan's three passes).
//
// What bounds it on the H100 at the char-LSTM training shape (T=200, N=256,
// H=256, bf16): bytes, then the recurrence's latency. The forward must read
// x_proj (104.9 MB) and write ys and cs (26.2 MB each): ~158 MB, 47 us at
// 3.35 TB/s; its 26.8 GFLOP would take 27 us at the bf16 tensor-core peak. The
// backward reads x_proj, ys, cs and dys and writes d x_proj: ~288 MB, 86 us,
// against 53.7 GFLOP (54 us). These kernels do their arithmetic on the CUDA
// cores in f32 (67 TFLOP/s) and pay one grid barrier (a few us) per step, so
// both sit far above those bounds.
//
// The backward's cluster route (namespace cl; bf16, H in {64, 128, 256}, the
// training path). The design above spends ~34 us a step at the training
// shape: it recomputes the gates on the chain, waits at a grid-wide barrier,
// and streams every da row through shared memory for 8 units. But the batch
// rows of an LSTM never exchange anything, so:
// - A cluster of H / 32 blocks owns 16 batch rows and all H units; a block
//   owns 32 units (128 gate columns). Clusters never wait on each other, so
//   the launch (cudaLaunchKernelEx with a cluster dimension) needs no
//   co-residency and there is no grid barrier. Where the card cannot hold all
//   the 16-row clusters at once (cudaOccupancyMaxActiveClusters: 15 clusters
//   of 8 on the H100, against 16 at N = 256), a cluster owns 32 rows instead,
//   two m16 tiles: one wave of 8 clusters rather than two waves of 16.
// - dh_{t-1} = da_t w_hh^T is split by columns: each block forms the partial
//   product of its 128 da columns with all H rows of w_hh ([16, H], f32) on
//   the tensor cores (mma.sync m16n8k16), puts it in its own shared memory,
//   arrives at barrier.cluster (release), and after the wait (acquire) sums
//   the H / 32 partials of its own 32 units over DSMEM (mapa +
//   ld.shared::cluster) in rank order, so two calls are bit-equal. Partials
//   alternate between two slots: a peer may still read step t's slot while
//   this block writes step t-1's. (Storing each share into its owner's
//   shared memory instead was measured slower: the arrive's release then
//   waits for the remote stores.) w_hh is exact in bf16; the f32 da is split
//   into three bf16 terms (hi + mid + lo, 24 bits), whose three products are
//   accumulated in f32: the reference's f32 da @ w_hh^T to about f32 rounding.
//   The block's B fragments of w_hh live in registers for all T.
// - The gate recompute h_{t-2} w_hh for step t-1 depends only on forward
//   outputs, so it runs between the arrive and the wait, on the tensor cores,
//   from the block's columns of w_hh resident in shared memory and an h tile
//   prefetched one step ahead by cp.async; the cell-update inputs of step t-1
//   (x_proj, dys, cs) are loaded into registers there too.
// - The cell update stays in f32 registers, in the __fmul_rn / __fadd_rn
//   order of the kernel above, one thread per (2 or 4 rows, unit). da goes to
//   global memory once per step in f32 (the caller's weight gradient) and in
//   bf16 (d x_proj), after the arrive, so that the barrier's release does not
//   wait for those stores. Rows past N are zero and never stored.
// What is left on its chain per step: the cell update, one __syncthreads, the
// partial product (96 mma per warp and m16 tile at H = 256), the cluster
// barrier and 2 x H / 32 DSMEM loads per thread and m16 tile.
//
// The forward's cluster route (lstm_fwd_cluster_kernel; bf16, H in {64, 128,
// 256}: the training and sampling paths). The grid design spends ~14 us a
// step on the H100 at the training shape on its grid barrier and on f32
// FMAs over h staged through shared memory. Here, as in the backward:
// - A cluster of H / 32 blocks owns a tile of 16 (or 32) batch rows and all H
//   units, a block 32 units (128 gate columns) with 8 warps per m16 tile of
//   rows (256 or 512 threads); the tile size follows the backward's choice
//   from cudaOccupancyMaxActiveClusters.
// - The gates h_{t-1} w_hh of the block's columns are one tensor-core product
//   per step (mma.sync m16n8k16 through ldmatrix, f32 accumulators): h is
//   exact in bf16 (the reference rounds h to w_hh's type before the dot), so
//   one term suffices, a third of the backward's split product. The block's
//   B fragments of w_hh stay in registers for all T. The columns are ordered
//   so that each thread's accumulators hold all four gates of its (row, unit)
//   pairs, and the cell update (f32 registers, the grid design's order of
//   operations) follows without a shuffle.
// - h_t (bf16) goes into the block's own shared-memory slot (two,
//   alternating); after a block barrier one thread copies the slot with the
//   bulk-copy engine (cp.async.bulk, shared::cta to shared::cluster) into
//   chunk `rank` of every block's next A tile, each copy completing on the
//   receiver's mbarrier, which waits for all H / 32 slices. There is no
//   cluster barrier per step. (Pulling the peers' slices over DSMEM after a
//   barrier.cluster arrive and wait was the first design: on an H100 80GB
//   HBM3 at 700 W, 0.75 ms per call at the training shape against 0.53,
//   the exchange 0.34 of its step; tools/lstm_probe.py split and compare.)
// - Off the chain, while the copies fly: ys and cs in 16-byte stores from
//   the slot and a c tile, hT and cT, and x_proj two steps ahead copied by
//   cp.async into a ring of three shared-memory tiles.
// Rows past N are zero and never stored. What is left on its chain per step:
// the product (2 H / 16 mma per warp and m16 tile), the cell update, a block
// barrier, the copies' flight and the mbarrier wait, and one __syncthreads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
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
  float* st;         // [2, N, H] f32: a tile's c (forward) or dh, dc (backward)
                     // between steps, where a block walks several tiles
  int steps, N, H;
  int hpad;          // H rounded up to the chunk
  int kc;            // chunk length (a multiple of 32 that divides hpad)
  int unit_tiles;    // ceil(H / kU)
  int btiles;        // ceil(N / rows per block tile)
  int round_h;       // f32 storage under a bf16 (kRoundBf16) or f16 (kRoundF16) w_hh: h
                     // rounded to that type before the product, else 0
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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x rounded to w_hh's type under f32 storage: kRoundBf16 or kRoundF16 (round_h)
constexpr int kRoundBf16 = 1, kRoundF16 = 2;
__device__ __forceinline__ float round_w(float x, int mode) {
  if (mode == kRoundBf16) return round_bf16(x);
  if (mode == kRoundF16) return __half2float(__float2half_rn(x));
  return x;
}

// w_hh read from L2 where no plan keeps it in shared memory (read-only path:
// no block writes it)
__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(b) << 16);
}

// Gates i, f, g, o of unit `col` at row k of w_hh (zero past H): one float4
// of the shared column layout.
template <typename T>
__device__ __forceinline__ float4 w_col4(const Args& a, int k, int col) {
  if (col >= a.H || k >= a.H) return make_float4(0.f, 0.f, 0.f, 0.f);
  const T* p = static_cast<const T*>(a.whh) + (size_t)k * 4 * a.H + col;
  return make_float4(ldw(p), ldw(p + a.H), ldw(p + 2 * a.H), ldw(p + 3 * a.H));
}

// Columns j .. j + 3 of row `col` of w_hh (zero past the matrix): one float4
// of the shared row layout.
template <typename T>
__device__ __forceinline__ float4 w_row4(const Args& a, int col, int j) {
  if (col >= a.H || j >= 4 * a.H) return make_float4(0.f, 0.f, 0.f, 0.f);
  const T* p = static_cast<const T*>(a.whh) + (size_t)col * 4 * a.H + j;
  return make_float4(ldw(p), ldw(p + 1), ldw(p + 2), ldw(p + 3));
}

// 16 bytes of the storage type widened to f32 into dst (16-byte aligned); f32
// values rounded to w_hh's type first where `round` says (round_w).
__device__ __forceinline__ void widen_store(float* dst, uint4 v, const float*, int round) {
  float4 f = make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                         __uint_as_float(v.w));
  if (round)
    f = make_float4(round_w(f.x, round), round_w(f.y, round), round_w(f.z, round),
                    round_w(f.w, round));
  *reinterpret_cast<float4*>(dst) = f;
}
__device__ __forceinline__ void widen_store(float* dst, uint4 v, const __nv_bfloat16*, int) {
  // little-endian: the low half of each word is the first element
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                  __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
                  __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
}

// Stage src[row, c0 + c) for the block's rows and c < kc into the chunk,
// zero past n_rows or past `width` columns, f32 values rounded to w_hh's type
// where `round` says (h under a bf16 or f16 w_hh, as the Pallas kernel casts h
// to w_hh's type before the dot). Where every row starts on a
// 16-byte boundary (width a multiple of 16 bytes' elements, src aligned), a
// warp reads whole 16-byte pieces of one row and each thread issues kBatch
// loads before it stores any, so a chunk pays the memory latency a few times
// rather than once per element; otherwise one element at a time.
constexpr int kBatch = 8;

template <typename T, int RB>
__device__ __forceinline__ void stage(float* ch_s, const T* src, int row0, int n_rows, int width,
                                      int c0, int kc, int round) {
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
        if (dst[k] >= 0) widen_store(ch_s + dst[k], v[k], src, round);
    }
    return;
  }
  const int n = NB * kc;
#pragma unroll 8
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / kc, c = e - r * kc;
    const int row = row0 + r, col = c0 + c;
    const float v = (row < n_rows && col < width) ? ld(src + (size_t)row * width + col) : 0.0f;
    ch_s[r * hs + c] = round_w(v, round);
  }
}

__device__ __forceinline__ void fma4(float (&c)[4], float h, float4 w) {
  c[0] = fmaf(h, w.x, c[0]);
  c[1] = fmaf(h, w.y, c[1]);
  c[2] = fmaf(h, w.z, c[2]);
  c[3] = fmaf(h, w.w, c[3]);
}

// acc[j][g] += sum_k h[row_j, k] w[k, g*H + unit] over the whole hidden width,
// h streaming through the chunk; w from shared memory (WS) or from L2.
template <typename T, int RB, bool WS>
__device__ __forceinline__ void gates_matmul(float (&acc)[RB][4], const float* w_s, float* ch_s,
                                             const T* hp, const Args& a, int row0, int rg, int u,
                                             int unit) {
  const int kc = a.kc, hs = chunk_stride(kc);
#pragma unroll
  for (int j = 0; j < RB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int k0 = 0; k0 < a.hpad; k0 += kc) {
    stage<T, RB>(ch_s, hp, row0, a.N, a.H, k0, kc, a.round_h);
    __syncthreads();
    const float4* wp = reinterpret_cast<const float4*>(w_s) + (size_t)k0 * kU + u;
    for (int k = 0; k < kc; k += 4, wp += 4 * kU) {
      float4 hv[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j)
        hv[j] = *reinterpret_cast<const float4*>(ch_s + (rg + j * kRG) * hs + k);
      float4 w0, w1, w2, w3;
      if constexpr (WS) {
        w0 = wp[0];
        w1 = wp[kU];
        w2 = wp[2 * kU];
        w3 = wp[3 * kU];
      } else {
        w0 = w_col4<T>(a, k0 + k, unit);
        w1 = w_col4<T>(a, k0 + k + 1, unit);
        w2 = w_col4<T>(a, k0 + k + 2, unit);
        w3 = w_col4<T>(a, k0 + k + 3, unit);
      }
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

// A block's tiles: blockIdx.x, + gridDim.x, ... of unit_tiles x btiles, unit
// tile fastest. Where there are no more tiles than blocks, a thread keeps its
// state (c; dh and dc) in registers for all T; otherwise each tile's state
// waits in a.st between steps.
struct Tile {
  int unit, row0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int tile, int nb) {
  return Tile{(tile % a.unit_tiles) * kU + (int)(threadIdx.x % kU), (tile / a.unit_tiles) * nb};
}

// ---------------------------------------------------------------- forward
template <typename T, int RB, bool WS>
__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* ch_s = WS ? w_s + (size_t)a.hpad * kU * 4 : w_s;
  constexpr int NB = kRG * RB;
  const int u = threadIdx.x % kU, rg = threadIdx.x / kU;
  const int H = a.H, N = a.N, tiles = a.unit_tiles * a.btiles;
  const bool walk = tiles > (int)gridDim.x;
  const T* xp = static_cast<const T*>(a.xp);
  T* ys = static_cast<T*>(a.ys);
  T* cs = static_cast<T*>(a.cs);

  // with w in shared memory the grid is a multiple of unit_tiles, so a
  // block's unit tile is the same in every tile it walks
  if (WS) load_w_cols<T>(w_s, a, blockIdx.x % a.unit_tiles);
  float c[RB];
  __syncthreads();

  for (int t = 0; t < a.steps; ++t) {
    const T* hp = t == 0 ? static_cast<const T*>(a.h0) : ys + (size_t)(t - 1) * N * H;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile tl = tile_of(a, tile, NB);
      const int unit = tl.unit;
      bool ok[RB];
      int row[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        row[j] = tl.row0 + rg + j * kRG;
        ok[j] = unit < H && row[j] < N;
        const size_t o = (size_t)row[j] * H + unit;
        if (t == 0)
          c[j] = ok[j] ? ld(static_cast<const T*>(a.c0) + o) : 0.0f;
        else if (walk)
          c[j] = ok[j] ? a.st[o] : 0.0f;
      }
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
      gates_matmul<T, RB, WS>(acc, w_s, ch_s, hp, a, tl.row0, rg, u, unit);
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
        if (walk) a.st[(size_t)row[j] * H + unit] = c[j];
        if (t == a.steps - 1) {
          st(static_cast<T*>(a.hT) + (size_t)row[j] * H + unit, h);
          st(static_cast<T*>(a.cT) + (size_t)row[j] * H + unit, c[j]);
        }
      }
    }
    if (t + 1 < a.steps) grid_barrier(a.bar);
  }
}

// ---------------------------------------------------------------- backward
template <typename T, int RB, bool WS>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* wc_s = reinterpret_cast<float*>(smem4);
  float* wr_s = WS ? wc_s + (size_t)a.hpad * kU * 4 : wc_s;
  float* ch_s = WS ? wr_s + (size_t)a.hpad * kU * 4 : wc_s;
  constexpr int NB = kRG * RB;
  const int u = threadIdx.x % kU, rg = threadIdx.x / kU;
  const int H = a.H, N = a.N, H4 = 4 * H, tiles = a.unit_tiles * a.btiles;
  const int kc = a.kc, hs = chunk_stride(kc);
  const bool walk = tiles > (int)gridDim.x;
  const T* xp = static_cast<const T*>(a.xp);
  const T* ys = static_cast<const T*>(a.ys);
  const T* cs = static_cast<const T*>(a.cs);
  const T* dys = static_cast<const T*>(a.dys);
  T* dxp = static_cast<T*>(a.dxp);
  float* st_dh = a.st;
  float* st_dc = a.st + (size_t)N * H;

  if (WS) {
    load_w_cols<T>(wc_s, a, blockIdx.x % a.unit_tiles);
    load_w_rows<T>(wr_s, a, blockIdx.x % a.unit_tiles);
  }
  float dh[RB], dc[RB];
  __syncthreads();

  for (int t = a.steps - 1; t >= 0; --t) {
    const T* hp = t == 0 ? static_cast<const T*>(a.h0) : ys + (size_t)(t - 1) * N * H;
    const T* cp = t == 0 ? static_cast<const T*>(a.c0) : cs + (size_t)(t - 1) * N * H;
    float* da = a.da + (size_t)t * N * H4;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile tl = tile_of(a, tile, NB);
      const int unit = tl.unit;
      bool ok[RB];
      int row[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        row[j] = tl.row0 + rg + j * kRG;
        ok[j] = unit < H && row[j] < N;
        const size_t o = (size_t)row[j] * H + unit;
        if (t == a.steps - 1) {
          dh[j] = (ok[j] && a.dhT != nullptr) ? ld(static_cast<const T*>(a.dhT) + o) : 0.0f;
          dc[j] = (ok[j] && a.dcT != nullptr) ? ld(static_cast<const T*>(a.dcT) + o) : 0.0f;
        } else if (walk) {
          dh[j] = ok[j] ? st_dh[o] : 0.0f;
          dc[j] = ok[j] ? st_dc[o] : 0.0f;
        }
      }
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
      gates_matmul<T, RB, WS>(acc, wc_s, ch_s, hp, a, tl.row0, rg, u, unit);
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
        if (walk) st_dc[(size_t)row[j] * H + unit] = dc[j];
      }
    }
    grid_barrier(a.bar);

    // dh_{t-1}[row, unit] = sum_j da_t[row, j] w_hh[unit, j], da streaming
    // through the chunk
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile tl = tile_of(a, tile, NB);
      const int unit = tl.unit;
      float acc_h[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) acc_h[j] = 0.0f;
      for (int j0 = 0; j0 < H4; j0 += kc) {
        stage<float, RB>(ch_s, da, tl.row0, N, H4, j0, kc, 0);
        __syncthreads();
        const float4* wp = reinterpret_cast<const float4*>(wr_s) + (size_t)(j0 / 4) * kU + u;
        for (int k = 0; k < kc; k += 4, wp += kU) {
          const float4 w = WS ? *wp : w_row4<T>(a, unit, j0 + k);
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
      for (int j = 0; j < RB; ++j) {
        const int row = tl.row0 + rg + j * kRG;
        if (walk) {
          if (unit < H && row < N) st_dh[(size_t)row * H + unit] = acc_h[j];
        } else {
          dh[j] = acc_h[j];
        }
      }
    }
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(a, tile, NB);
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int row = tl.row0 + rg + j * kRG;
      if (tl.unit >= H || row >= N) continue;
      const size_t o = (size_t)row * H + tl.unit;
      st(static_cast<T*>(a.dh0) + o, walk ? st_dh[o] : dh[j]);
      st(static_cast<T*>(a.dc0) + o, walk ? st_dc[o] : dc[j]);
    }
  }
}

// ------------------------------------------------- backward, cluster route
namespace cl {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;     // 8 warps
constexpr int kRows = 16;         // batch rows per cluster: one m16 tile
constexpr int kUnits = 32;        // hidden units per block
constexpr int kCols = 4 * kUnits; // the block's gate columns
constexpr int kPadH = 8;          // bf16 row padding (16 bytes: ldmatrix without bank conflicts)
constexpr int kPadF = 4;          // f32 row padding

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

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
// c += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators. Fragment
// layout (lane = 4 g + t): c[0], c[1] row g, columns 2t, 2t+1; c[2], c[3] row
// g + 8; b0 holds k = 2t, 2t+1 of column g, b1 k = 2t+8, 2t+9.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of `addr` (this block's shared memory) in block `rank`
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float bf(const bf16* p) {
  const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(b) << 16);
}
// the raw bits of a bf16 element, and those bits widened to f32 (0 where
// the row is masked): a load into raw bits is not waited for until the
// bits are widened, a step later
__device__ __forceinline__ unsigned short raw(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float widen(unsigned short b, bool ok) {
  return ok ? __uint_as_float(static_cast<unsigned int>(b) << 16) : 0.0f;
}

// x = hi + mid + lo in bf16, to within 2^-24 of |x| (each difference is exact)
__device__ __forceinline__ void split3(float x, bf16* hi, bf16* mid, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(h));
  const bf16 m = __float2bfloat16_rn(r1);
  const float r2 = __fsub_rn(r1, __bfloat162float(m));
  *hi = h;
  *mid = m;
  *lo = __float2bfloat16_rn(r2);
}

// Shared memory, with H = 64 NT, CS = H / 32 blocks per cluster and R = 16
// MT batch rows per cluster:
//   wc   [H][kCols + kPadH] bf16   the block's columns of w_hh (gate product B)
//   hb   [2][R][H + kPadH] bf16    h_{s-1} tiles of the gate product (A)
//   dsp  [3][R][kCols + kPadH]     da_t split in three bf16 terms (partial product A)
//   gts  [R][kCols + kPadF] f32    h_{s-1} w_hh for the block's columns
//   part [2][R][H + kPadF] f32     partial dh over the block's columns, read by the cluster
__host__ __device__ constexpr size_t smem_bytes(int H, int MT) {
  return 2 * ((size_t)H * (kCols + kPadH) +
              (size_t)MT * kRows * (2 * (H + kPadH) + 3 * (kCols + kPadH))) +
         4 * (size_t)MT * kRows * ((kCols + kPadF) + 2 * (H + kPadF));
}

// Grid: H / 32 blocks per cluster, one cluster per 16 MT batch rows; 256
// threads. Warp w forms gate columns [16 w, 16 w + 16) of the gate product and
// output units [8 NT w, 8 NT (w + 1)) of the partial product, for each of the
// MT m16 tiles; thread (warp r0, lane u) owns unit u of the block for rows
// r0 + 8 p, p < 2 MT, in the cell update.
template <int NT, int MT>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_cluster_kernel(Args a) {
  constexpr int H = 64 * NT, H4 = 4 * H, CS = H / kUnits, R = kRows * MT, NP = 2 * MT;
  constexpr int WP = kCols + kPadH, HP = H + kPadH, GP = kCols + kPadF, PP = H + kPadF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wc = reinterpret_cast<bf16*>(smem_raw);
  bf16* hb = wc + H * WP;
  bf16* dsp = hb + 2 * R * HP;
  float* gts = reinterpret_cast<float*>(dsp + 3 * R * WP);
  float* part = gts + R * GP;

  const int N = a.N, steps = a.steps;
  const int rank = (int)cluster_rank(), row_base = (int)cluster_id() * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int u = lane, r0 = warp, unit = rank * kUnits + u;
  const bf16* whh = static_cast<const bf16*>(a.whh);
  const bf16* xp = static_cast<const bf16*>(a.xp);
  const bf16* ys = static_cast<const bf16*>(a.ys);
  const bf16* cs = static_cast<const bf16*>(a.cs);
  const bf16* dys = static_cast<const bf16*>(a.dys);
  bf16* dxp = static_cast<bf16*>(a.dxp);
  // column of w_hh behind local gate column lc (gate lc / 32, unit lc % 32)
  auto col = [&](int lc) { return (lc / kUnits) * H + rank * kUnits + lc % kUnits; };

  // h_{s-1} for the gate product of step s (h0 at s = 0), 16 bytes a copy
  auto load_h = [&](int s) {
    const bf16* src = s == 0 ? static_cast<const bf16*>(a.h0) : ys + (size_t)(s - 1) * N * H;
    bf16* dst = hb + (s & 1) * R * HP;
    for (int c = threadIdx.x; c < R * H / 8; c += kThreads) {
      const int r = c / (H / 8), k = (c % (H / 8)) * 8;
      const bool ok = row_base + r < N;
      cp16(dst + r * HP + k, src + (size_t)(ok ? row_base + r : 0) * H + k, ok);
    }
  };
  // gts = h_{s-1} w_hh[:, block columns]; warp w forms columns [16 w, 16 w + 16)
  auto gate_product = [&](int s) {
    const bf16* pa = hb + (s & 1) * R * HP + (lane & 15) * HP + (lane >> 4) * 8;
    const bf16* pb = wc + ((lane & 7) + ((lane >> 3) & 1) * 8) * WP + (lane >> 4) * 8 + 16 * warp;
    float c[MT][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      unsigned r[4];
      ldsm4t(r, pb + kk * 16 * WP);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        unsigned af[4];
        ldsm4(af, pa + m * kRows * HP + kk * 16);
        mma(c[m][0], af, r[0], r[1]);
        mma(c[m][1], af, r[2], r[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        float* d = gts + (m * kRows) * GP + 16 * warp + 8 * nb + 2 * t4;
        *reinterpret_cast<float2*>(d + g * GP) = make_float2(c[m][nb][0], c[m][nb][1]);
        *reinterpret_cast<float2*>(d + (g + 8) * GP) = make_float2(c[m][nb][2], c[m][nb][3]);
      }
  };

  // the cell-update inputs of step s for the thread's rows
  bool ok[NP];
  size_t rowo[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int row = row_base + r0 + 8 * p;
    ok[p] = row < N;
    rowo[p] = ok[p] ? (size_t)row : 0;
  }
  // raw bf16 bits, loaded a step ahead (masked rows read row 0 and are
  // zeroed when widened)
  unsigned short x[NP][4], dy[NP], ct[NP], cp[NP];
  auto load_inputs = [&](int s) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const size_t o = ((size_t)s * N + rowo[p]) * H + unit;
      const size_t ox = ((size_t)s * N + rowo[p]) * H4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[p][q] = raw(xp + ox + q * H);
      dy[p] = raw(dys + o);
      ct[p] = raw(cs + o);
      cp[p] = s == 0 ? raw(static_cast<const bf16*>(a.c0) + rowo[p] * H + unit)
                     : raw(cs + o - (size_t)N * H);
    }
  };

  // prologue: w_hh's block columns (shared) and its B fragments of the
  // partial product (registers), the first h tiles, the first gates
  for (int c = threadIdx.x; c < H * kCols / 8; c += kThreads) {
    const int k = c / (kCols / 8), lc = (c % (kCols / 8)) * 8;
    cp16(wc + k * WP + lc, whh + (size_t)k * H4 + col(lc), true);
  }
  load_h(steps - 1);
  if (steps >= 2) load_h(steps - 2);
  cp_commit();
  // B of the partial product: k = local column, n = unit; b0 = w_hh[n, col(k)],
  // w_hh[n, col(k + 1)] for k = 16 kk + 2 t (b1: k + 8), one 32-bit load each
  unsigned wb[NT][8][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const unsigned* base =
        reinterpret_cast<const unsigned*>(whh + (size_t)(8 * (NT * warp + j) + g) * H4);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wb[j][kk][0] = __ldg(base + col(16 * kk + 2 * t4) / 2);
      wb[j][kk][1] = __ldg(base + col(16 * kk + 2 * t4 + 8) / 2);
    }
  }
  float dh[NP], dc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const size_t o = rowo[p] * H + unit;
    dh[p] = (ok[p] && a.dhT != nullptr) ? bf(static_cast<const bf16*>(a.dhT) + o) : 0.0f;
    dc[p] = (ok[p] && a.dcT != nullptr) ? bf(static_cast<const bf16*>(a.dcT) + o) : 0.0f;
  }
  load_inputs(steps - 1);
  cp_wait_all();
  __syncthreads();
  gate_product(steps - 1);
  __syncthreads();

  const unsigned part_u32 = smem_u32(part);
  for (int t = steps - 1; t >= 0; --t) {
    // 1. the cell update of step t, in f32 registers; da into the split tiles
    float da[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int r = r0 + 8 * p;
      const float* gr = gts + r * GP + u;
      const float gi = sigmoidf(gr[0] + widen(x[p][0], ok[p]));
      const float gf = sigmoidf(gr[kUnits] + widen(x[p][1], ok[p]));
      const float gg = tanhf(gr[2 * kUnits] + widen(x[p][2], ok[p]));
      const float go = sigmoidf(gr[3 * kUnits] + widen(x[p][3], ok[p]));
      dh[p] = __fadd_rn(dh[p], widen(dy[p], ok[p]));
      const float tc = tanhf(widen(ct[p], ok[p]));
      const float d_o = __fmul_rn(dh[p], tc);
      dc[p] = __fadd_rn(dc[p], __fmul_rn(__fmul_rn(dh[p], go), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      const float d_i = __fmul_rn(dc[p], gg), d_f = __fmul_rn(dc[p], widen(cp[p], ok[p]));
      const float d_g = __fmul_rn(dc[p], gi);
      da[p][0] = __fmul_rn(__fmul_rn(d_i, gi), __fsub_rn(1.0f, gi));
      da[p][1] = __fmul_rn(__fmul_rn(d_f, gf), __fsub_rn(1.0f, gf));
      da[p][2] = __fmul_rn(d_g, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      da[p][3] = __fmul_rn(__fmul_rn(d_o, go), __fsub_rn(1.0f, go));
      dc[p] = __fmul_rn(dc[p], gf);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!ok[p]) da[p][q] = 0.0f;
        bf16* d = dsp + r * WP + q * kUnits + u;
        split3(da[p][q], d, d + R * WP, d + 2 * R * WP);
      }
    }
    cp_wait_all();  // the h tile of the next gate product
    __syncthreads();

    // 2. this block's partial of dh_{t-1} = da_t w_hh^T, into slot t & 1
    {
      // with one m16 tile, even and odd k steps in two accumulators (more
      // mma chains in flight), summed at the end
      constexpr int KS = MT == 1 ? 2 : 1;
      float acc[KS][MT][NT][4] = {};
      const bf16* pa = dsp + (lane & 15) * WP + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned af[3][4];
#pragma unroll
          for (int s = 0; s < 3; ++s) ldsm4(af[s], pa + (s * R + m * kRows) * WP + kk * 16);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int s = 2; s >= 0; --s)
              mma(acc[kk % KS][m][j], af[s], wb[j][kk][0], wb[j][kk][1]);
        }
      float* slot = part + (t & 1) * R * PP;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = KS == 2 ? acc[0][m][j][i] + acc[KS - 1][m][j][i]
                                                     : acc[0][m][j][i];
          float* d = slot + (m * kRows) * PP + 8 * (NT * warp + j) + 2 * t4;
          *reinterpret_cast<float2*>(d + g * PP) = make_float2(c[0], c[1]);
          *reinterpret_cast<float2*>(d + (g + 8) * PP) = make_float2(c[2], c[3]);
        }
    }
    cluster_arrive();

    // 3. off the chain: da to global memory (after the arrive, so that its
    // release need not wait for these stores), step t-1's gates and inputs,
    // step t-2's h tile
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (!ok[p]) continue;
      const size_t ox = ((size_t)t * N + rowo[p]) * H4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a.da[ox + q * H] = da[p][q];
        dxp[ox + q * H] = __float2bfloat16_rn(da[p][q]);
      }
    }
    if (t > 0) {
      load_inputs(t - 1);
      gate_product(t - 1);
      if (t >= 2) {
        load_h(t - 2);
        cp_commit();
      }
    }
    cluster_wait();

    // 4. dh_{t-1} for the thread's unit: the cluster's partials in rank order
    {
      const unsigned slot = part_u32 + (unsigned)((t & 1) * R * PP) * 4u;
      float v[CS][NP];
#pragma unroll
      for (int q = 0; q < CS; ++q)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          v[q][p] = ld_cluster(map_rank(slot + (unsigned)((r0 + 8 * p) * PP + unit) * 4u, q));
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float s = v[0][p];
#pragma unroll
        for (int q = 1; q < CS; ++q) s = __fadd_rn(s, v[q][p]);
        dh[p] = s;
      }
    }
    __syncthreads();  // the gates of step t-1 before its cell update
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (!ok[p]) continue;
    const size_t o = rowo[p] * H + unit;
    static_cast<bf16*>(a.dh0)[o] = __float2bfloat16_rn(dh[p]);
    static_cast<bf16*>(a.dc0)[o] = __float2bfloat16_rn(dc[p]);
  }
  // no block leaves while a peer may still read its partials
  cluster_arrive();
  cluster_wait();
}


// ------------------------------------------------- forward, cluster route
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ unsigned pack2(unsigned short lo, unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}
__device__ __forceinline__ void mbar_init(unsigned addr, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned addr, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(addr), "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` of this block's mbarrier to complete
// (the bytes of every peer's copy landed); trap after the barrier timeout.
__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  const long long t0 = global_ns();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
  }
}
// `bytes` of this block's shared memory at src into dst of a peer (a
// shared::cluster address), completing on that peer's mbarrier
__device__ __forceinline__ void copy_to_peer(unsigned dst, unsigned src, unsigned bytes,
                                             unsigned mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// Shared memory of the forward, with H = 64 NT, CS = H / 32 blocks per
// cluster and R = 16 MT batch rows per cluster (rows of SP = 40 bf16, 80
// bytes: ldmatrix without bank conflicts):
//   ha  [2][CS][R][SP] bf16  h_{t-1} for all H units, the A tile of the gate
//                            product: chunk q holds units [32 q, 32 q + 32),
//                            written by block q's copy (double-buffered)
//   hs  [2][R][SP] bf16      h_t of the block's 32 units: the copies' source
//   cst [R][SP] bf16         c_t of the block's 32 units, for 16-byte stores
//   xs  [3][R][kCols + kPadH] bf16  x_proj[t] for the block's 128 columns,
//                            copied two steps ahead
//   mbar[2]                  one mbarrier per A buffer
__host__ __device__ constexpr size_t fwd_smem_bytes(int H, int MT) {
  return 2 * (size_t)MT * kRows *
             (2 * (H / kUnits) * (kUnits + kPadH) + 3 * (kUnits + kPadH) + 3 * (kCols + kPadH)) +
         16;
}

// Grid: H / 32 blocks per cluster, one cluster per R = 16 MT batch rows; 256
// threads per m16 tile (8 warps each). Block `rank` owns units [32 rank,
// 32 rank + 32). Warp w of the warps of tile m forms 16 gate columns of the
// tile's rows, ordered so that lane (g, t4) of the m16n8 accumulators ends up
// holding all four gates of unit u = 4 (w % 8) + t4: n-tile j, column n is
// gate 2 j + (n & 1) of unit 4 (w % 8) + (n >> 1), so c[0], c[1] of tile 0
// are i and f, of tile 1 g and o, for row g (c[2], c[3]: row g + 8). The
// thread then runs the cell update of unit u for its 2 rows, no shuffle
// needed. (With both tiles in one set of 8 warps, a thread's cell update
// has 4 rows and takes 0.37 of a step at N = 256 on an H100:
// tools/lstm_probe.py split.)
//
// The exchange: after the cell update every block copies its [R][32] slice
// of h_t with the bulk-copy engine into chunk `rank` of each peer's next A
// buffer (its own included), each copy completing on the receiver's
// mbarrier, which waits for the bytes of all CS copies. No cluster barrier
// per step. Buffer reuse needs no more than the data: a peer writes step
// t+1's slice into this block's buffer t & 1 only after it has this block's
// h_t, which this block copies only after its product of step t has read
// that buffer; and this block's source slot of step t is rewritten at step
// t+2 only after the wait for step t+2's A tile, which needs every peer's
// h_{t+1}, which needs this block's copies of h_t to have landed.
template <int NT, int MT>
__global__ void __launch_bounds__(kThreads * MT, 1) lstm_fwd_cluster_kernel(Args a) {
  constexpr int H = 64 * NT, H4 = 4 * H, CS = H / kUnits, R = kRows * MT, KK = H / 16;
  constexpr int SP = kUnits + kPadH, XP = kCols + kPadH;
  constexpr int THREADS = kThreads * MT;
  constexpr int XPIECES = R * (kCols / 8);              // 16-byte pieces of one x tile
  constexpr unsigned kSlice = R * SP * 2;               // bytes of one block's h slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ha = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = ha + 2 * CS * R * SP;
  bf16* cst = hs + 2 * R * SP;
  bf16* xs = cst + R * SP;
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(xs + 3 * R * XP);

  const int N = a.N, steps = a.steps;
  const int rank = (int)cluster_rank(), row_base = (int)cluster_id() * R;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int mt = threadIdx.x / kThreads, warp = (threadIdx.x % kThreads) >> 5;
  const int u = 4 * warp + t4, unit = rank * kUnits + u;
  const bf16* whh = static_cast<const bf16*>(a.whh);
  const bf16* xp = static_cast<const bf16*>(a.xp);
  bf16* ys = static_cast<bf16*>(a.ys);
  bf16* cs = static_cast<bf16*>(a.cs);
  const unsigned ha_u32 = smem_u32(ha), hs_u32 = smem_u32(hs), mbar_u32 = smem_u32(mbar);

  // x_proj[s] for the block's columns into buffer s % 3, 16 bytes a copy:
  // local column 32 q + v is gate q of unit v
  auto load_x = [&](int s) {
    bf16* dst = xs + (s % 3) * R * XP;
    for (int c = threadIdx.x; c < XPIECES; c += THREADS) {
      const int r = c / (kCols / 8), lc = (c % (kCols / 8)) * 8;
      const bool ok = row_base + r < N;
      const size_t row = ok ? (size_t)row_base + r : 0;
      cp16(dst + r * XP + lc,
           xp + ((size_t)s * N + row) * H4 + (lc / kUnits) * H + rank * kUnits + lc % kUnits, ok);
    }
  };

  // prologue: the mbarriers (one arrival each: this block's expect_tx), seen
  // by the whole cluster before any copy; h0 into A buffer 0 and x_proj[0]
  // (one group), x_proj[1] (the next); the B fragments of w_hh in registers;
  // c0
  if (threadIdx.x == 0) {
    mbar_init(mbar_u32, 1);
    mbar_init(mbar_u32 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < R * H / 8; c += THREADS) {
    const int r = c / (H / 8), k = (c % (H / 8)) * 8;
    const bool ok = row_base + r < N;
    cp16(ha + ((k / kUnits) * R + r) * SP + k % kUnits,
         static_cast<const bf16*>(a.h0) + (size_t)(ok ? row_base + r : 0) * H + k, ok);
  }
  load_x(0);
  cp_commit();
  if (steps > 1) load_x(1);
  cp_commit();
  // B (k = hidden input, n = gate column): b0 holds k = 16 kk + 2 t4, + 1 of
  // column n = g, b1 k + 8, + 9; column g of n-tile j is w_hh's column
  // (2 j + (g & 1)) H + 32 rank + 4 warp + (g >> 1)
  unsigned wb[2][KK][2];
  {
    const unsigned short* w = reinterpret_cast<const unsigned short*>(whh);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = (2 * j + (g & 1)) * H + rank * kUnits + 4 * warp + (g >> 1);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int k = 16 * kk + 2 * t4;
        wb[j][kk][0] = pack2(__ldg(w + (size_t)k * H4 + col), __ldg(w + (size_t)(k + 1) * H4 + col));
        wb[j][kk][1] =
            pack2(__ldg(w + (size_t)(k + 8) * H4 + col), __ldg(w + (size_t)(k + 9) * H4 + col));
      }
    }
  }
  // the thread's rows: p is row 16 mt + 8 p + g of the cluster's tile
  bool ok[2];
  size_t rowo[2];
  float c[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int row = row_base + 16 * mt + 8 * p + g;
    ok[p] = row < N;
    rowo[p] = ok[p] ? (size_t)row : 0;
    c[p] = ok[p] ? bf(static_cast<const bf16*>(a.c0) + rowo[p] * H + unit) : 0.0f;
  }
  cp_wait<1>();
  cluster_arrive();   // the mbarriers initialised, and the block's A buffer 0
  cluster_wait();

  // the thread's 16-byte store of ys or cs per step: piece q < 4 R is row
  // q / 4, units 8 (q % 4) + [0, 8) of the block's slice
  const int sq = threadIdx.x % (4 * R);
  const bool store_cs = threadIdx.x >= 4 * R;
  const bool stores = threadIdx.x < 8 * R && (!store_cs || cs != nullptr) &&
                      row_base + sq / 4 < N;
  const int sr = sq / 4, sk = 8 * (sq % 4);
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    // 1. the gates h_{t-1} w_hh of the block's columns for the warp's m16
    // tile on the tensor cores, even and odd k steps in two accumulators
    // (more mma chains in flight); k step kk reads chunk kk / 2 of the A tile
    float acc[2][2][4] = {};
    {
      const bf16* pa = ha + (size_t)buf * CS * R * SP + (16 * mt + (lane & 15)) * SP +
                       (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        unsigned af[4];
        ldsm4(af, pa + (kk >> 1) * R * SP + (kk & 1) * 16);
        mma(acc[kk & 1][0], af, wb[0][kk][0], wb[0][kk][1]);
        mma(acc[kk & 1][1], af, wb[1][kk][0], wb[1][kk][1]);
      }
    }

    // 2. the cell update in f32 registers; h_t (bf16) into slot t & 1, c_t
    // into the store tile
    const bf16* xt = xs + (t % 3) * R * XP + u;
    bf16* slot = hs + buf * R * SP + u;
    float h[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int e = 2 * p, r = 16 * mt + 8 * p + g;
      const bf16* xr = xt + r * XP;
      const float gi = sigmoidf(acc[0][0][e] + acc[1][0][e] + __bfloat162float(xr[0]));
      const float gf = sigmoidf(acc[0][0][e + 1] + acc[1][0][e + 1] + __bfloat162float(xr[kUnits]));
      const float gg = tanhf(acc[0][1][e] + acc[1][1][e] + __bfloat162float(xr[2 * kUnits]));
      const float go =
          sigmoidf(acc[0][1][e + 1] + acc[1][1][e + 1] + __bfloat162float(xr[3 * kUnits]));
      c[p] = ok[p] ? __fadd_rn(__fmul_rn(gf, c[p]), __fmul_rn(gi, gg)) : 0.0f;
      h[p] = ok[p] ? __fmul_rn(go, tanhf(c[p])) : 0.0f;
      slot[r * SP] = __float2bfloat16_rn(h[p]);
      cst[r * SP + u] = __float2bfloat16_rn(c[p]);
    }
    // the slot is read by the bulk-copy engine (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // 3. h_t to every block of the cluster (one thread issues the copies),
    // then, off the chain, ys and cs from the tiles (16 bytes a store),
    // hT and cT, x_proj[t+2]
    if (t + 1 < steps && threadIdx.x == 0) {
      const unsigned nb = (unsigned)(buf ^ 1);
      mbar_expect_tx(mbar_u32 + 8 * nb, CS * kSlice);
      const unsigned src = hs_u32 + (unsigned)buf * kSlice;
      const unsigned dst = ha_u32 + (nb * CS + (unsigned)rank) * kSlice;
#pragma unroll
      for (int q = 0; q < CS; ++q)
        copy_to_peer(map_rank(dst, q), src, kSlice, map_rank(mbar_u32 + 8 * nb, q));
    }
    if (stores) {
      const bf16* tile = store_cs ? cst : hs + buf * R * SP;
      bf16* out = store_cs ? cs : ys;
      *reinterpret_cast<uint4*>(out + ((size_t)t * N + row_base + sr) * H + rank * kUnits + sk) =
          *reinterpret_cast<const uint4*>(tile + sr * SP + sk);
    }
    if (t == steps - 1) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (!ok[p]) continue;
        static_cast<bf16*>(a.hT)[rowo[p] * H + unit] = __float2bfloat16_rn(h[p]);
        static_cast<bf16*>(a.cT)[rowo[p] * H + unit] = __float2bfloat16_rn(c[p]);
      }
    }
    if (t + 2 < steps) load_x(t + 2);
    cp_commit();

    // 4. the next A tile: every block's copy landed
    if (t + 1 < steps) {
      mbar_wait(mbar_u32 + 8 * (buf ^ 1), (unsigned)(t >> 1) & 1u);
      cp_wait<1>();  // x_proj[t+1]
      __syncthreads();
    }
  }
  // no block leaves while a peer's copy from it may still be in flight
  cluster_arrive();
  cluster_wait();
}

// The cluster kernel of the forward (FWD) or the backward at (NT, MT), and
// its shared memory.
using ClusterKernel = void (*)(Args);
template <int NT, int MT, bool FWD>
ClusterKernel cluster_kernel() {
  return FWD ? lstm_fwd_cluster_kernel<NT, MT> : lstm_bwd_cluster_kernel<NT, MT>;
}
template <int NT, int MT, bool FWD>
size_t cluster_smem() {
  return FWD ? fwd_smem_bytes(64 * NT, MT) : smem_bytes(64 * NT, MT);
}
// threads per block: the forward runs 8 warps per m16 tile
template <int MT, bool FWD>
constexpr int cluster_threads() {
  return FWD ? kThreads * MT : kThreads;
}

// The clusters of cluster route instance (NT, MT, FWD) that the card holds at
// once, with its shared-memory opt-in set first; per device, once.
template <int NT, int MT, bool FWD>
cudaError_t active_clusters(int dev, int* clusters) {
  constexpr int CS = 64 * NT / kUnits;
  static std::mutex mu;
  static std::map<int, int> active;
  const std::lock_guard<std::mutex> lock(mu);
  auto it = active.find(dev);
  if (it == active.end()) {
    const ClusterKernel fn = cluster_kernel<NT, MT, FWD>();
    const size_t smem = cluster_smem<NT, MT, FWD>();
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CS);
    cfg.blockDim = dim3(cluster_threads<MT, FWD>());
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();  // leave no stale error for a later launch's check
      return err;
    }
    it = active.emplace(dev, n).first;
  }
  *clusters = it->second;
  return cudaSuccess;
}

template <int NT, int MT, bool FWD>
cudaError_t launch_mt(const Args& a, cudaStream_t stream, int clusters, int* plan_out) {
  constexpr int CS = 64 * NT / kUnits;
  const size_t smem = cluster_smem<NT, MT, FWD>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS * ((a.N + kRows * MT - 1) / (kRows * MT)));
  cfg.blockDim = dim3(cluster_threads<MT, FWD>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (plan_out != nullptr) {
    plan_out[0] = (int)cfg.gridDim.x;
    plan_out[1] = CS;
    plan_out[2] = kRows * MT;
    plan_out[3] = (int)smem;
    plan_out[4] = clusters;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_kernel<NT, MT, FWD>(), a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// 16 batch rows per cluster while the card holds all the clusters at once,
// else 32 (one wave of half as many clusters rather than two)
template <int NT, bool FWD>
cudaError_t launch(const Args& a, cudaStream_t stream, int* plan_out) {
  int dev = 0, one = 0, two = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = active_clusters<NT, 1, FWD>(dev, &one);
  if (err == cudaSuccess) err = active_clusters<NT, 2, FWD>(dev, &two);
  if (err != cudaSuccess) return err;
  if (one < 1 && two < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (a.N + kRows - 1) / kRows;
  if (one >= 1 && (tiles <= one || two < 1))
    return launch_mt<NT, 1, FWD>(a, stream, one, plan_out);
  return launch_mt<NT, 2, FWD>(a, stream, two, plan_out);
}

template <bool FWD>
cudaError_t launch_h(const Args& a, cudaStream_t stream, int* plan_out) {
  switch (a.H) {
    case 64: return launch<1, FWD>(a, stream, plan_out);
    case 128: return launch<2, FWD>(a, stream, plan_out);
    default: return launch<4, FWD>(a, stream, plan_out);
  }
}

}  // namespace cl

// ---------------------------------------------------------------- launch plan
template <typename T, int RB, bool BWD, bool WS>
const void* kernel_ptr() {
  return BWD ? reinterpret_cast<const void*>(&lstm_bwd_kernel<T, RB, WS>)
             : reinterpret_cast<const void*>(&lstm_fwd_kernel<T, RB, WS>);
}

size_t smem_bytes(bool bwd, bool ws, int hpad, int rb, int kc) {
  const size_t w = ws ? (size_t)hpad * kU * 4 * sizeof(float) : 0;
  return (bwd ? 2 * w : w) + (size_t)kRG * rb * chunk_stride(kc) * sizeof(float);
}

struct Plan {
  const void* fn;
  int rb, kc, hpad, blocks, per_sm;
  size_t smem;
  int btiles, ws;
};

// The first plan whose grid is co-resident on this card, in three passes:
// 1. w_hh in shared memory and one tile per block, by rows per thread (1, 2,
//    4) and then by chunk (the whole padded width, else 32). On the H100 (132
//    SMs) every shape up to N=256, H=512 fits here.
// 2. w_hh in shared memory, a block per unit tile and as many per batch as
//    the card holds, each walking its batch tiles (4 rows per thread), the
//    state waiting in global memory between steps (N past 256: the char-LSTM
//    at H=1024 keeps its 128 KiB of widened forward columns).
// 3. w_hh read from L2 every step, as many blocks as the card holds walking
//    every tile (the backward at H=1024, whose columns and rows would take 256
//    KiB; any H).
// Each kernel may use the card's whole opt-in shared memory, so a plan stays
// launchable whatever plan was made after it.
template <typename T, bool BWD>
cudaError_t make_plan(int dev, int N, int H, Plan* p) {
  int sms = 0, max_smem = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const void* fns[2][3] = {
      {kernel_ptr<T, 1, BWD, false>(), kernel_ptr<T, 2, BWD, false>(),
       kernel_ptr<T, 4, BWD, false>()},
      {kernel_ptr<T, 1, BWD, true>(), kernel_ptr<T, 2, BWD, true>(),
       kernel_ptr<T, 4, BWD, true>()}};
  const long long unit_tiles = (H + kU - 1) / kU;
  const int hpad_full = (H + kChunkMin - 1) / kChunkMin * kChunkMin;
  for (int pass = 0; pass < 3; ++pass) {
    const bool ws = pass < 2;
    for (int i = pass == 0 ? 0 : 2; i < 3; ++i) {
      const int rb = 1 << i, nb = kRG * rb;
      const long long btiles = (N + nb - 1) / nb;
      const void* fn = fns[ws][i];
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
      if (err != cudaSuccess) return err;
      for (int kc : {hpad_full, kChunkMin}) {
        const size_t smem = smem_bytes(BWD, ws, hpad_full, rb, kc);
        if (smem > (size_t)max_smem) continue;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
        if (err != cudaSuccess) return err;
        const long long cap = (long long)per_sm * sms;
        long long blocks;
        if (pass == 0)
          blocks = unit_tiles * btiles <= cap ? unit_tiles * btiles : 0;
        else if (pass == 1)
          blocks = unit_tiles <= cap ? unit_tiles * std::min(btiles, cap / unit_tiles) : 0;
        else
          blocks = std::min(unit_tiles * btiles, cap);
        if (blocks < 1) continue;
        *p = Plan{fn, rb, kc, hpad_full, (int)blocks, per_sm, smem, (int)btiles, (int)ws};
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
  a.btiles = p.btiles;
  if (plan_out != nullptr) {
    const long long tiles = (long long)a.unit_tiles * a.btiles;
    plan_out[0] = p.blocks;
    plan_out[1] = p.rb;
    plan_out[2] = p.kc;
    plan_out[3] = (int)p.smem;
    plan_out[4] = p.per_sm;
    plan_out[5] = (int)((tiles + p.blocks - 1) / p.blocks);
    plan_out[6] = p.ws;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(p.fn, dim3(p.blocks), dim3(kThreads), args, p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int steps, int N, int H) {
  return steps < 1 || N < 1 || H < 1 || (long long)N * 4 * H > 0x7fffffffLL;
}

bool aligned16(std::initializer_list<const void*> ps) {
  uintptr_t bits = 0;
  for (const void* p : ps) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15) == 0;
}

// What the routes take: round_h (0-2) only with f32 storage (0, the first grid
// design); route 1 (clusters) bf16 with H in {64, 128, 256}.
bool bad_route(int is_bf16, int route, int round_h, int H) {
  if (route < 0 || route > 1 || round_h < 0 || round_h > 2 || (round_h && (is_bf16 || route == 1)))
    return true;
  return route == 1 && (!is_bf16 || (H != 64 && H != 128 && H != 256));
}

}  // namespace

extern "C" {

// Forward. Launches on `stream` and returns the CUDA error (0 on success).
// Device pointers to contiguous tensors of one element type (bf16 if is_bf16,
// else f32): xp [T, N, 4H], whh [H, 4H], h0 and c0 [N, H]; ys [T, N, H], cs
// [T, N, H] or null, hT and cT [N, H] are written. route 0 is the cooperative
// grid design (bar: two zeroed uint32; st: f32 scratch [2, N, H]; round_h 1
// or 2 rounds h to bf16 or f16 before the product, for f32 storage of a bf16
// or f16 w_hh), route
// 1 the cluster route, which takes bf16 with H in {64, 128, 256} and 16-byte
// aligned xp, whh and h0, and refuses anything else. plan_out, if not null,
// receives {blocks, rows per thread, chunk, shared bytes, blocks per SM, tiles
// per block, w_hh in shared memory (1) or read from L2 (0)} (route 0) or
// {blocks, cluster size, rows per cluster, shared bytes, clusters the card
// holds at once} (route 1).
int dl4j_lstm_fwd(int is_bf16, int route, int round_h, const void* xp, const void* whh,
                  const void* h0, const void* c0, void* ys, void* cs, void* hT, void* cT,
                  void* bar, void* st, int steps, int N, int H, int* plan_out, void* stream) {
  if (bad_shape(steps, N, H) || bad_route(is_bf16, route, round_h, H))
    return (int)cudaErrorInvalidValue;
  if (route == 1 && !aligned16({xp, whh, h0})) return (int)cudaErrorInvalidValue;
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
  a.st = static_cast<float*>(st);
  a.steps = steps;
  a.N = N;
  a.H = H;
  a.round_h = round_h;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == 1) return (int)cl::launch_h<true>(a, s, plan_out);
  return (int)(is_bf16 ? launch<__nv_bfloat16, false>(a, s, plan_out)
                       : launch<float, false>(a, s, plan_out));
}

// Backward. xp, whh, h0, c0 as in the forward; ys and cs [T, N, H] from the
// forward (with the cell stream); dys [T, N, H]; dhT and dcT [N, H] or null
// (zero). da [T, N, 4H] f32 (d x_proj in f32), dh0 and dc0 [N, H] are written,
// and dxp [T, N, 4H] in the storage type unless it is null (f32, where da is
// d x_proj itself). route 0 is the cooperative grid design (bar, st and
// round_h as in the forward), route 1 the cluster route, which takes bf16
// with H in {64, 128, 256} and 16-byte aligned whh, ys and h0, and refuses
// anything else. plan_out as in the forward.
int dl4j_lstm_bwd(int is_bf16, int route, int round_h, const void* xp, const void* whh,
                  const void* h0, const void* c0, const void* ys, const void* cs,
                  const void* dys, const void* dhT, const void* dcT, void* dxp, void* da,
                  void* dh0, void* dc0, void* bar, void* st, int steps, int N, int H,
                  int* plan_out, void* stream) {
  if (bad_shape(steps, N, H) || cs == nullptr || bad_route(is_bf16, route, round_h, H))
    return (int)cudaErrorInvalidValue;
  if (route == 1 && (!aligned16({whh, ys, h0}) || dxp == nullptr))
    return (int)cudaErrorInvalidValue;
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
  a.st = static_cast<float*>(st);
  a.steps = steps;
  a.N = N;
  a.H = H;
  a.round_h = round_h;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == 1) return (int)cl::launch_h<false>(a, s, plan_out);
  return (int)(is_bf16 ? launch<__nv_bfloat16, true>(a, s, plan_out)
                       : launch<float, true>(a, s, plan_out));
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
