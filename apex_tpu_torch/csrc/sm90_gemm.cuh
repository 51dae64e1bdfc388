// The Hopper GEMM shared by kernel rows 9 (csrc/grouped_matmul.cu: its
// 16-bit, transposed and int8-slab branches) and 10 (csrc/dense_int8.cu:
// its tensor-core route above 64 rows), built from sm90_tile.cuh.
//
//   y[r] = x[r] @ B(g)  for the rows r of segment g,
//
// x [N, K] and y [N, P] in one 16-bit type, B(g) read through a 3-D tensor
// map of the slab, so that a box never crosses a group:
//   kFwd   w [G, K, P] 16-bit, an MN-major B;
//   kTrans w [G, P, K] 16-bit, each group's weight transposed in place, a
//          K-major B (the backward's dx = g @ w[g]^T without a copy);
//   kInt8  wire [G, K, P] int8 with scale [G, K / kb, P] fp32: the product
//          of each kb block is an fp32 partial of the 16-bit values,
//          multiplied by its scale row in registers before it joins the
//          accumulator, as the TPU kernel's dot(x, q) * s.
// Rows split into G + 2 segments: the rows before offsets[0], the G groups'
// spans and the rows from offsets[G] on (no offsets: one group of all N
// rows, row 10).  Every CTA reads the offsets on the device and builds the
// segments' tile table in shared memory (a warp scan): no metadata pass,
// no host read, so a launch can sit in a CUDA graph.
//
// Persistent CTAs of 384 threads, one per SM, walk work items (a tile of
// up to 128 rows of one segment x 64, 128 or 256 columns), the two outer
// segments' tiles last; those store zeros without loading, so every
// element of y is written exactly once.  Warp 8, the producer, keeps a
// ring of TMA loads in flight over all items of the CTA: x's 128 rows
// (K-major, swizzled) and the weight tile.  Warpgroups 0 and 1 own rows
// 0-63 and 64-127 of the tile and issue wgmma m64nNk16 (N the tile's
// columns) from shared memory into fp32 registers;
// a tile's rows that fall outside its segment are real rows of a
// neighbouring group, computed and dropped at the store, and rows past N
// and k past K read as TMA's zeros.  The int8 tile lands as TMA brings it
// (64 k rows of 128 bytes, or 32 when kb is not a multiple of 64, so that
// every scale block ends with a stage); the 256 consumer threads widen it
// to the 16-bit type (exact for |q| <= 127), 16 bytes at a time, into a
// ring of three swizzled MN-major buffers, one stage ahead while the
// current stage's products run, and fence it for the async proxy; a named
// barrier of the two warpgroups precedes the wgmma that read it.  Each
// scale block ends with wgmma.wait 0 and the scale-add of its partial:
// that drain, more than the widening, sets the int8 branch's pace.  Two
// partials taking turns, with the running sums in shared memory, would
// hide it, but ptxas then serializes the wgmma (C7514: it cannot tell
// which partial a retired group wrote), which is slower still.  The
// scale is never folded into the widened weight: q * s rounded to 16
// bits is not the TPU kernel's function.  One writer per output element,
// no atomics: the result does not depend on scheduling.
#pragma once

#include <string.h>

#include "sm90_tile.cuh"

namespace gemm {

// kInt8 takes k stages of 64 rows (kb % 64 == 0), kInt8K32 of 32 (any
// kb % 32 == 0): every scale block ends with a stage; kInt8N64 is kInt8
// at 64 columns, for calls whose 128-column tiles would leave SMs idle.
// The 16-bit slabs
// take tiles of 128 columns, or of 256 (kFwdWide, kTransWide: each
// warpgroup m64n256, which halves the re-reads of x, worth it when the
// tiles fit in one wave of CTAs and so lose nothing to its tail).
enum Mode : int {
  kFwd = 0, kTrans = 1, kInt8 = 2, kInt8K32 = 3, kFwdWide = 4, kTransWide = 5,
  kInt8N64 = 6
};
template <int MODE>
constexpr bool kIsInt8 =
    MODE == kInt8 || MODE == kInt8K32 || MODE == kInt8N64;
template <int MODE>
constexpr bool kIsTrans = MODE == kTrans || MODE == kTransWide;

constexpr int kBM = 128;  // tile rows: two consumer warpgroups of 64
// the segment table lives in shared memory beside the ring
constexpr int kMaxGroups = 2048;

template <int MODE>
struct Cfg {
  // tile columns (the int8 slab's partial and accumulator take 128
  // registers at n = 128)
  static constexpr int BN = MODE == kFwdWide || MODE == kTransWide ? 256
                            : MODE == kInt8N64                    ? 64
                                                                  : 128;
  // k rows per stage: four k16 products, or two (kInt8K32)
  static constexpr int BK = MODE == kInt8K32 ? 32 : 64;
  static constexpr int STAGES =
      MODE == kInt8K32 || MODE == kInt8N64 ? 8 : MODE == kInt8 ? 6 : 4;
  using AT = sm90::Tile<BK, kBM>;  // x rows, K-major A
  using BT = typename std::conditional<kIsTrans<MODE>,
                                       sm90::Tile<BK, BN>,   // K-major B
                                       sm90::Tile<BN, BK>>::type;  // MN-major
  static constexpr int RAW = kIsInt8<MODE> ? BK * BN : 0;  // int8 as landed
  // B: a 16-bit slab's tile in every stage, or three widened int8 tiles
  static constexpr int B_SLOTS = kIsInt8<MODE> ? 3 : STAGES;
  // 16-byte int8 pieces each consumer thread widens per stage
  static constexpr int PIECES = RAW / 16 / 256;
  static constexpr int a_off = 0;
  static constexpr int b_off = a_off + STAGES * AT::BYTES;
  static constexpr int raw_off = b_off + B_SLOTS * BT::BYTES;
  static constexpr int bar_off = raw_off + STAGES * RAW;
  // full[S], empty[S], then the segment table
  static constexpr int table_off = bar_off + 2 * STAGES * 8;
  static constexpr int bytes(int G) { return table_off + 8 * (G + 3) + 1024; }
};

// Segment bound i of 0..G+2 before the running max: 0, offsets[0..G]
// clamped into [0, N], N.  No offsets: 0, 0, N (one group of every row).
__device__ __forceinline__ int raw_bound(const int* __restrict__ off, int G,
                                         int N, int i) {
  if (i <= 0) return 0;
  if (i > G + 1) return N;
  if (off == nullptr) return i == 1 ? 0 : N;
  return min(max(off[i - 1], 0), N);
}

// Warp 0: seg_lo[s] (s = 0..G+2, the last N) is segment s's first row and
// tile_pre[s] the tiles of the segments before it (tile_pre[G + 2], all
// tiles).  Bounds are the running max of the clamped offsets, so the
// segments tile [0, N) whatever the offsets hold.
__device__ void build_table(const int* __restrict__ off, int G, int N,
                            int* seg_lo, int* tile_pre) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int nseg = G + 2;
  int tiles_before = 0, bound_before = 0;
  for (int base = 0; base < nseg; base += 32) {
    const int s = base + lane;
    int lo = s < nseg ? raw_bound(off, G, N, s) : N;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(full, lo, o);
      if (lane >= o) lo = max(lo, v);
    }
    lo = max(lo, bound_before);
    const int hi = s < nseg ? max(lo, raw_bound(off, G, N, s + 1)) : N;
    const int nt = s < nseg ? (hi - lo + kBM - 1) / kBM : 0;
    int incl = nt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(full, incl, o);
      if (lane >= o) incl += v;
    }
    incl += tiles_before;
    if (s < nseg) {
      seg_lo[s] = lo;
      tile_pre[s] = incl - nt;
    }
    tiles_before = __shfl_sync(full, incl, 31);
    bound_before = __shfl_sync(full, hi, 31);
  }
  if (lane == 0) {
    seg_lo[nseg] = N;
    tile_pre[nseg] = tiles_before;
  }
}

// Work item i: column tile i % ncols (of bn columns) of row tile i /
// ncols, the row tiles counted from segment 1 on, so the outer segments'
// zero tiles come last.
struct Item {
  int seg, row0, rows, n0;
  __device__ Item(int i, int ncols, int bn, const int* seg_lo,
                  const int* tile_pre, int G) {
    const int total = tile_pre[G + 2];
    int t = i / ncols;
    n0 = (i - t * ncols) * bn;
    t += tile_pre[1];
    if (t >= total) t -= total;
    int lo = 0, hi = G + 1;  // the last segment whose first tile is <= t
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tile_pre[mid] <= t)
        lo = mid;
      else
        hi = mid - 1;
    }
    seg = lo;
    row0 = seg_lo[seg] + (t - tile_pre[seg]) * kBM;
    rows = min(kBM, seg_lo[seg + 1] - row0);
  }
  __device__ bool inner(int G) const { return seg >= 1 && seg <= G; }
};

// The scale row's values at this thread's accumulator columns (srow
// points at column 0 of the row; columns past P take 0), then acc +=
// part x them.
template <int BN>
__device__ __forceinline__ void load_scales(float2 (&sv)[BN / 8],
                                            const float* __restrict__ srow,
                                            int n0, int P, int lane) {
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * (lane & 3);
    sv[c] = col < P ? __ldg(reinterpret_cast<const float2*>(srow + col))
                    : make_float2(0.0f, 0.0f);
  }
}
template <int BN>
__device__ __forceinline__ void scale_add(float (&acc)[BN / 2],
                                          const float (&part)[BN / 2],
                                          const float2 (&sv)[BN / 8]) {
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    acc[4 * c] += part[4 * c] * sv[c].x;
    acc[4 * c + 1] += part[4 * c + 1] * sv[c].y;
    acc[4 * c + 2] += part[4 * c + 2] * sv[c].x;
    acc[4 * c + 3] += part[4 * c + 3] * sv[c].y;
  }
}

// Consumers: named barrier 1 over the two warpgroups.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// This thread's rows of the warpgroup's m64nBN accumulator (zeros when
// !live), rounded once to T; rows past `rows` and columns past P dropped.
template <typename T, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           bool live, T* __restrict__ y,
                                           int P, int row0, int rows, int n0,
                                           int r0, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
    T* dst = y + (size_t)(row0 + r) * P;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int col = n0 + 8 * c + 2 * (lane & 3);
      if (col < P)
        *reinterpret_cast<uint32_t*>(dst + col) =
            live ? sm90::pack2<T>(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1])
                 : 0u;
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    gmm_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const float* __restrict__ scale,
                    const int* __restrict__ off, T* __restrict__ y, int N,
                    int K, int P, int G, int kb) {
  using C = Cfg<MODE>;
  constexpr int BN = C::BN, BK = C::BK, S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* empty = full + S;
  int* seg_lo = reinterpret_cast<int*>(smem + C::table_off);
  int* tile_pre = seg_lo + G + 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], sm90::kConsumerWarps);
    }
    sm90::bar_init_fence();
  }
  if (threadIdx.x < 32) build_table(off, G, N, seg_lo, tile_pre);
  __syncthreads();
  const int ncols = (P + BN - 1) / BN;
  const int items = tile_pre[G + 2] * ncols;
  const int nk = (K + BK - 1) / BK;  // k stages of a tile
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= 256) {
    // producer warpgroup: its first warp loads, the other three leave
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (threadIdx.x < 288) {
      // x's rows and the weight tile of every k stage of every item
      int stage = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Item it(i, ncols, BN, seg_lo, tile_pre, G);
        if (!it.inner(G)) continue;
        const int g = it.seg - 1;
        for (int j = 0; j < nk; ++j, ++stage) {
          const int s = stage % S;
          sm90::bar_wait(&empty[s], ((stage / S) & 1) ^ 1);
          if (lane != 0) continue;
          unsigned char* a = smem + C::a_off + s * C::AT::BYTES;
          if constexpr (kIsInt8<MODE>) {
            sm90::bar_arrive_tx(&full[s], C::AT::BYTES + C::RAW);
            sm90::tma_load_2d(a, &tx, &full[s], j * BK, it.row0);
            sm90::tma_load_3d(smem + C::raw_off + s * C::RAW, &tw, &full[s],
                              it.n0, j * BK, g);
          } else {
            unsigned char* b = smem + C::b_off + s * C::BT::BYTES;
            sm90::bar_arrive_tx(&full[s], C::AT::BYTES + C::BT::BYTES);
            sm90::tma_load_2d(a, &tx, &full[s], j * BK, it.row0);
            if constexpr (!kIsTrans<MODE>) {
#pragma unroll
              for (int p = 0; p < C::BT::PANELS; ++p)
                sm90::tma_load_3d(b + p * C::BT::PANEL_BYTES, &tw, &full[s],
                                  it.n0 + p * C::BT::W, j * BK, g);
            } else {
              sm90::tma_load_3d(b, &tw, &full[s], j * BK, it.n0, g);
            }
          }
        }
      }
    }
  } else {
    sm90::reg_alloc<sm90::kConsumerRegs>();
    const int wg = threadIdx.x >> 7;
    const int r0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    int stage = 0;
    float acc[BN / 2];
    float part[kIsInt8<MODE> ? BN / 2 : 1];
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) sm90::bar_arrive(&empty[s]);
    };
    // int8: stage t's tile widened into wide[t % 3], this thread's
    // 16-byte pieces, fenced for the wgmma that read it
    auto widen = [&](int t) {
      sm90::bar_wait(&full[t % S], (t / S) & 1);
      const uint32_t b =
          sm90::smem_addr(smem + C::b_off + (t % 3) * C::BT::BYTES);
      const unsigned char* raw = smem + C::raw_off + (t % S) * C::RAW;
#pragma unroll
      for (int q = 0; q < C::PIECES; ++q) {
        const int i = threadIdx.x + 256 * q;
        const int k = i / (BN / 16), n = i % (BN / 16) * 16;
        uint4 lo, hi;
        sm90::widen16<T>(*reinterpret_cast<const uint4*>(raw + k * BN + n),
                         lo, hi);
        sm90::st_shared16(sm90::swz_addr<BN, BK>(b, k, n), lo);
        sm90::st_shared16(sm90::swz_addr<BN, BK>(b, k, n + 8), hi);
      }
      sm90::fence_proxy_async();
    };
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it(i, ncols, BN, seg_lo, tile_pre, G);
      const bool live = it.inner(G) && nk > 0;
      if (live) {
        if constexpr (!kIsInt8<MODE>) {
          int pending = -1;  // a stage whose products may still be running
          for (int j = 0; j < nk; ++j, ++stage) {
            const int s = stage % S;
            sm90::bar_wait(&full[s], (stage / S) & 1);
            const uint32_t a =
                sm90::smem_addr(smem + C::a_off + s * C::AT::BYTES);
            const uint32_t b =
                sm90::smem_addr(smem + C::b_off + s * C::BT::BYTES);
            sm90::mma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
              const uint64_t da = sm90::desc_k<BK, kBM>(a, wg * 64, kk);
              if constexpr (kIsTrans<MODE>)
                sm90::mma_ss<T, BN, 0>(acc, da, sm90::desc_k<BK, BN>(b, 0, kk),
                                       j > 0 || kk > 0);
              else
                sm90::mma_ss<T, BN, 1>(acc, da, sm90::desc_mn<BN, BK>(b, kk),
                                       j > 0 || kk > 0);
            }
            sm90::mma_commit();
            sm90::mma_wait<1>();
            if (pending >= 0) release(pending);
            pending = s;
          }
          sm90::mma_wait<0>();
          release(pending);
          sm90::fence_regs(acc);
        } else {
          const int g = it.seg - 1;
#pragma unroll
          for (int r = 0; r < BN / 2; ++r) acc[r] = 0.0f;
          widen(stage);
          consumers_sync();
          int pending = -1;  // a stage whose products may still be running
          for (int j = 0; j < nk; ++j, ++stage) {
            const int s = stage % S;
            // A landed with the int8 tile this stage's widening waited for
            const uint32_t a =
                sm90::smem_addr(smem + C::a_off + s * C::AT::BYTES);
            const uint32_t b =
                sm90::smem_addr(smem + C::b_off + (stage % 3) * C::BT::BYTES);
            const bool block_end = (j + 1) * BK % kb == 0;
            float2 sv[BN / 8];
            if (block_end)  // its scale row, loaded before the products
              load_scales<BN>(sv,
                          scale + ((size_t)g * (K / kb) + (j + 1) * BK / kb - 1)
                                      * P,
                          it.n0, P, lane);
            sm90::mma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)  // a fresh partial per block
              sm90::mma_ss<T, BN, 1>(part,
                                      sm90::desc_k<BK, kBM>(a, wg * 64, kk),
                                      sm90::desc_mn<BN, BK>(b, kk),
                                      (j * BK + kk * 16) % kb != 0);
            sm90::mma_commit();
            // the next stage widens while these products run, into the
            // buffer stage - 2's products read; every thread of both
            // warpgroups waited for those before the last named barrier
            if (j + 1 < nk) widen(stage + 1);
            if (block_end) {
              // the block's products, then its partial scaled into acc
              sm90::mma_wait<0>();
              sm90::fence_regs(part);
              if (pending >= 0) release(pending);
              release(s);
              pending = -1;
              scale_add<BN>(acc, part, sv);
            } else {
              sm90::mma_wait<1>();
              if (pending >= 0) release(pending);
              pending = s;
            }
            consumers_sync();
          }
        }
      }
      store_tile<T, BN>(acc, live, y, P, it.row0, it.rows, it.n0, r0, lane);
    }
  }
}

// Launch one call: x [N, K], the slab (w, or wire + scale for kInt8),
// offsets [G + 1] int32 on the device (nullptr: one group of all rows,
// G = 1), y [N, P].  K, P (and, for kInt8, kb) as the callers check:
// 16-byte row strides (K % 8, P % 8; int8 P % 16), K % kb, kb % 32.
template <typename T, int MODE>
int launch(const void* x, const void* w, const void* scale, const void* off,
           void* y, int N, int K, int P, int G, int kb, cudaStream_t stream) {
  using C = Cfg<MODE>;
  if (N <= 0 || K < 0 || P <= 0 || G < 0 || G > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  memset(&tx, 0, sizeof(tx));
  memset(&tw, 0, sizeof(tw));
  int err = 0;
  if (K > 0 && G > 0) {  // otherwise nothing is loaded: every tile stores 0
    const uint64_t xd[2] = {(uint64_t)K, (uint64_t)N};
    const uint32_t xb[2] = {(uint32_t)C::BK, (uint32_t)kBM};
    err = sm90::encode_map<T>(&tx, x, 2, xd, xb);
    if (err == 0) {
      if constexpr (kIsTrans<MODE>) {
        const uint64_t wd[3] = {(uint64_t)K, (uint64_t)P, (uint64_t)G};
        const uint32_t wb[3] = {(uint32_t)C::BK, (uint32_t)C::BN, 1};
        err = sm90::encode_map<T>(&tw, w, 3, wd, wb);
      } else if constexpr (!kIsInt8<MODE>) {
        const uint64_t wd[3] = {(uint64_t)P, (uint64_t)K, (uint64_t)G};
        const uint32_t wb[3] = {(uint32_t)C::BT::W, (uint32_t)C::BK, 1};
        err = sm90::encode_map<T>(&tw, w, 3, wd, wb);
      } else {
        static_assert(kIsInt8<MODE>, "an int8 slab");
        const uint64_t wd[3] = {(uint64_t)P, (uint64_t)K, (uint64_t)G};
        const uint32_t wb[3] = {(uint32_t)C::BN, (uint32_t)C::BK, 1};
        err = sm90::encode_map<int8_t>(&tw, w, 3, wd, wb);
      }
    }
  }
  const int bytes = C::bytes(G);
  if (err == 0) err = sm90::set_smem(gmm_sm90_kernel<T, MODE>, bytes);
  // at most one partial tile per segment beyond ceil(N / 128)
  const long long bound = ((long long)(N + kBM - 1) / kBM + G + 2) *
                          ((P + C::BN - 1) / C::BN);
  int grid = 0;
  if (err == 0)
    err = sm90::persistent_grid(bound < (1 << 30) ? (int)bound : (1 << 30),
                                &grid);
  if (err != 0) return err;
  gmm_sm90_kernel<T, MODE><<<grid, sm90::kThreads, bytes, stream>>>(
      tx, tw, (const float*)scale, (const int*)off, (T*)y, N, K, P, G, kb);
  return (int)cudaGetLastError();
}

// The int8 slab's GEMM, with 64-row stages where the scale block allows,
// at 64 columns when the caller asks (narrow) and the stages are 64 rows.
template <typename T>
int launch_int8(const void* x, const void* wire, const void* scale,
                const void* off, void* y, int N, int K, int P, int G, int kb,
                int narrow, cudaStream_t stream) {
  if (kb % 64 != 0)
    return launch<T, kInt8K32>(x, wire, scale, off, y, N, K, P, G, kb,
                               stream);
  return narrow ? launch<T, kInt8N64>(x, wire, scale, off, y, N, K, P, G, kb,
                                      stream)
                : launch<T, kInt8>(x, wire, scale, off, y, N, K, P, G, kb,
                                   stream);
}

// {registers, shared memory per CTA, CTAs per SM, spill bytes} of one
// instantiation (sm90::kernel_attrs), its table sized for 8 groups.
template <typename T, int MODE>
int attrs(int* out) {
  return sm90::kernel_attrs(gmm_sm90_kernel<T, MODE>, Cfg<MODE>::bytes(8),
                            sm90::kThreads, out);
}

}  // namespace gemm
