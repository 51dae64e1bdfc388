// Split-key paged decode attention, shared by kernel row 6
// (paged_attention.cu) and K3 (decode_step.cu): one query token per
// sequence attends over the sequence's blocks of a paged K/V pool
// [nb, bs, g, dh] through its block table.
//
// Bound on the H100: bytes (each live K/V row, and an int8 pool's
// scales, read once; ~4 flops per element at rep query heads a group).
// What the design does about it:
//
// * Keys split across CTAs (flash-decoding).  The host knows each
//   sequence's reach, max_blocks * block_size; the wrapper's planner
//   (ops/paged_attention.paged_plan) cuts it into `splits` chunks of
//   `chunk` tokens, and the grid is (splits, g * head_chunks *
//   dim_chunks, b) whatever the device-side lengths: no host sync, and a
//   launch captured in a CUDA graph replays for any lengths.  A chunk
//   that starts at or past the length exits at once (chunk 0 of an empty
//   lane writes its exact zeros first); a lane whose length fits one
//   chunk is finished by that chunk.  Otherwise each live chunk writes
//   its (max, sum, acc) partial to a per-call fp32 scratch and a second
//   launch (paged_combine_kernel, or K3's projection) adds a lane's
//   partials in chunk order: deterministic, bitwise repeatable, no
//   atomics.  That launch is the split kernel's programmatic dependent:
//   it is scheduled while the split kernel runs and waits for its
//   results (griddepcontrol), so its launch latency is hidden.  Why not a
//   thread-block cluster combining through distributed shared memory:
//   the cluster is sized by the reach, most of a ragged batch's chunks
//   are past their lane's length, and an exited CTA's slot stays taken
//   until its cluster ends, so a batch of short lanes ran several times
//   slower as clusters than as plain CTAs (PERF.md, Findings).
// * Tiles stay in the pool's dtype.  Each of the CTA's four warps
//   streams its own warp tiles of `tile` tokens (the chunk's warp tiles
//   dealt round robin) through a ring of `stages` buffers filled by
//   16-byte cp.async copies (zero-filled past the length, so a position
//   at or past the length is never read), and waits for them with
//   cp.async.wait_group and a warp barrier: no CTA barrier inside the
//   loop, and the next tiles' loads are in flight while the current one
//   is scored.  The warp reads its block-table entries itself, a tile
//   ahead of their use (one lane a token, shared by shuffles); entries
//   are clamped into the pool before any address is formed.
// * Dot products are lane-parallel: 32 / tile lanes a token, each with a
//   share of the row's 16-byte vectors widened in registers (int8 times
//   the token's fp32 scale, one rounding, as the plain version's
//   dequantize), reduced by shuffles; every query head of the CTA reuses
//   the loaded row.  The online softmax runs in base 2 with the scale
//   folded in; head r's running max and sum live in lane r.  In P V each
//   lane owns `EPL` consecutive dims of every head and walks the tile's
//   tokens; with one head a CTA (MHA) the query share stays in registers
//   and P V is token-parallel instead: each lane adds its own token's p
//   times its share of that token's V row, and the warp's lanes are
//   summed once, after the loop.
// * Any rep = nh / g and any dh that is a multiple of 16 bytes of pool
//   elements: a CTA takes up to H query heads (head_chunks CTAs share a
//   larger group, each reading the group's K/V) and up to 32 * EPL dims
//   of P V (dim_chunks CTAs share a wider head).  The register arrays are
//   sized by H and EPL, the template's two parameters.
// * At the chunk's end the warps' partials combine in warp order in
//   shared memory, then (second launch) the chunks' in chunk order.
//
// Scores, sums and accumulators are fp32; the context is written in the
// compute dtype T.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace apex_paged {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 32;       // key chunks of one sequence
constexpr int kSmemMax = 232448;     // dynamic shared memory a CTA may use
// CTAs an SM the register budget is set for (at most 170 registers a
// thread); naming it keeps ptxas from spilling to reach another CTA.  (A
// budget of 5, 102 registers, made the one-head kernel spill.)
constexpr int kMinCtas = 3;

// Shapes and plan of one launch (passed by value).
struct Args {
  const void* q;                 // [b, nh, dh] T
  const void* k_pool;            // [nb, bs, g, dh] P
  const void* v_pool;
  const float* k_scale;          // [nb, bs, g] (int8 pools)
  const float* v_scale;
  const int* tables;             // [b, mb]
  const int* lengths;            // [b]
  const float* rope_cos;         // [b, d2] (d2 = 0: none)
  const float* rope_sin;
  void* out;                     // [b, nh, dh] T
  float* part;                   // per-call scratch: the chunks' partials
  int nh, dh, nb, bs, g, mb, d2;
  float scale_log2;              // softmax scale * log2(e)
  // the plan (ops/paged_attention.paged_plan)
  int chunk, rc, head_chunks, dim_chunks, dn_max, tile, stages;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Byte offsets of the shared-memory regions (the planner computes the same
// total, ops/paged_attention.paged_smem).  The query stays; the rings, an
// int8 pool's scales and the probabilities serve the loop, and the warps'
// partials reuse their bytes after it.
struct Layout {
  int k_row, v_row;  // bytes between K and V rows (padded: lanes that read
                     // one vector of 8 rows hit 8 different bank groups)
  int off_q, off_k, off_v, off_ks, off_vs, off_p, off_wpart, total;
};

__host__ __device__ inline Layout layout(int dh, int isz, bool quant, int rc,
                                         int dn_max, int tile, int stages) {
  Layout L;
  L.k_row = dh * isz + 16;
  L.v_row = dn_max * isz + 16;
  const int slots = kWarps * stages * tile;  // token rows of all rings
  L.off_q = 0;
  const int base = align16(rc * dh * 4);
  int off = base;
  L.off_k = off;
  off += align16(slots * L.k_row);
  L.off_v = off;
  off += align16(slots * L.v_row);
  L.off_ks = off;
  off += quant ? align16(slots * 4) : 0;
  L.off_vs = off;
  off += quant ? align16(slots * 4) : 0;
  L.off_p = off;
  off += align16(kWarps * rc * tile * 4);
  const int loop_end = off;
  off = base;
  L.off_wpart = off;
  off += align16(kWarps * rc * (dn_max + 2) * 4);
  L.total = off > loop_end ? off : loop_end;
  return L;
}

// ------------------------------------------------------------ device --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !valid (src
// is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n (1..3) of this thread's newest groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// Programmatic dependent launch: a kernel lets the next one on its stream
// (launched with cudaLaunchAttributeProgrammaticStreamSerialization) start
// early, and that kernel waits for this one's completion and memory
// before it reads what this one wrote.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Element j of type P packed in a 32-bit word, widened by bit operations
// (no local array whose address is taken: that would live in local memory).
template <typename P>
__device__ __forceinline__ float widen(uint32_t w, int j);
template <>
__device__ __forceinline__ float widen<float>(uint32_t w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(uint32_t w, int j) {
  return __uint_as_float(j ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float widen<__half>(uint32_t w, int j) {
  return __half2float(__ushort_as_half((unsigned short)(w >> (16 * j))));
}
template <>
__device__ __forceinline__ float widen<int8_t>(uint32_t w, int j) {
  return (float)((int)(w << (24 - 8 * j)) >> 24);
}

// N consecutive elements of type P from shared memory at p (N * sizeof(P)
// bytes, aligned to that size: 2, 4, 8 or 16) widened to floats.
template <typename P, int N>
__device__ __forceinline__ void load_small(const unsigned char* p,
                                           float* dst) {
  constexpr int kBytes = N * (int)sizeof(P);
  constexpr int kPer = 4 / (int)sizeof(P) > 0 ? 4 / (int)sizeof(P) : 1;
  static_assert(kBytes == 2 || kBytes == 4 || kBytes == 8 || kBytes == 16,
                "one 2-, 4-, 8- or 16-byte load");
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (kBytes == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else if constexpr (kBytes == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = widen<P>(w[j / kPer], j % kPer);
}

// The EPL dims [d, d + EPL) of a V row of dn elements (zeros past dn;
// dn is a multiple of 16 bytes of elements, so a 16-byte piece lies wholly
// inside or outside).
template <typename P, int EPL>
__device__ __forceinline__ void load_lane(const unsigned char* row, int d,
                                          int dn, float* dst) {
  constexpr int kBytes = EPL * (int)sizeof(P);
  constexpr int kPiece = kBytes < 16 ? EPL : 16 / (int)sizeof(P);
#pragma unroll
  for (int j0 = 0; j0 < EPL; j0 += kPiece) {
    if (d + j0 < dn) {
      load_small<P, kPiece>(row + (size_t)(d + j0) * sizeof(P), dst + j0);
    } else {
#pragma unroll
      for (int j = 0; j < kPiece; ++j) dst[j0 + j] = 0.0f;
    }
  }
}

// The 16-byte vectors of a K row (its query share, its P V sums) one lane
// holds in the one-head variant: EPL * sizeof(P), at most 8.  With two
// lanes a token that covers dh up to 32 * EPL for 16-bit and int8 pools
// and up to 64 for fp32; the planner takes the variant only where the
// row fits (plan_ok checks it).
template <typename P, int EPL>
__host__ __device__ constexpr int slots_of() {
  return EPL * (int)sizeof(P) < 8 ? EPL * (int)sizeof(P) : 8;
}

__device__ __forceinline__ int clamp_block(int blk, int nb) {
  return blk < 0 ? 0 : (blk >= nb ? nb - 1 : blk);
}

// One CTA: chunk blockIdx.x of sequence blockIdx.z, for the kv group,
// head chunk and dim chunk packed in blockIdx.y.
template <typename T, typename P, int H, int EPL>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    paged_split_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kCV = 16 / (int)sizeof(P);  // elements of a 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  griddep_launch_dependents();  // the combine (or projection) may launch
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const int i = blockIdx.z;
  int y = blockIdx.y;
  const int dci = y % a.dim_chunks;
  y /= a.dim_chunks;
  const int hci = y % a.head_chunks;
  const int grp = y / a.head_chunks;
  const int rep = a.nh / a.g;
  const int r0 = hci * a.rc;
  const int rcc = min(a.rc, rep - r0);  // query heads of this CTA
  const int d0 = dci * a.dn_max;
  const int dn = min(a.dn_max, a.dh - d0);  // P V dims of this CTA
  // the block-table entry of token t_lo + (j * kWarps + warp) * wt + lane,
  // warp tile j's (one lane a token; 0 past the chunk or the table)
  const int t_lo = c * a.chunk;
  const int wt = a.tile;
  const int reach = min(a.mb * a.bs, t_lo + a.chunk);
  auto entry_of = [&](int j) {
    const int tok = t_lo + (j * kWarps + warp) * wt + lane;
    return lane < wt && tok < reach ? a.tables[(size_t)i * a.mb + tok / a.bs]
                                    : 0;
  };
  // the first tiles' entries load beside the length: they do not depend
  // on it
  int first_entry[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) first_entry[j] = j < a.stages ? entry_of(j) : 0;
  const int len = max(0, min(a.lengths[i], a.mb * a.bs));  // table reach
  const int n_live = (len + a.chunk - 1) / a.chunk;
  T* out = reinterpret_cast<T*>(a.out) +
           ((size_t)i * a.nh + (size_t)grp * rep + r0) * a.dh + d0;

  if (c >= n_live) {
    if (c == 0) {  // an empty lane: exact zeros
      for (int e = threadIdx.x; e < rcc * dn; e += kThreads)
        out[(size_t)(e / dn) * a.dh + e % dn] = apex_from_float<T>(0.0f);
    }
    return;  // nobody reads this CTA's shared memory
  }

  const Layout L = layout(a.dh, (int)sizeof(P), kQuant, a.rc, a.dn_max,
                          a.tile, a.stages);
  float* q_s = reinterpret_cast<float*>(smem + L.off_q);

  // ---- this warp's stream of warp tiles -------------------------------
  const int parts = 32 / wt;  // lanes a token in Q K
  const int t_hi = min(len, t_lo + a.chunk);
  const int span = t_hi - t_lo - warp * wt;
  const int n_wt = span > 0 ? (span + kWarps * wt - 1) / (kWarps * wt) : 0;
  const int nvk = a.dh * (int)sizeof(P) / 16;  // 16-byte vectors of a K row
  const int nvv = dn * (int)sizeof(P) / 16;    // ... of this CTA's V dims
  const unsigned char* kpool = reinterpret_cast<const unsigned char*>(a.k_pool);
  const unsigned char* vpool = reinterpret_cast<const unsigned char*>(a.v_pool);
  const size_t row_bytes = (size_t)a.dh * sizeof(P);
  const int ring0 = warp * a.stages * wt;  // this warp's first ring row
  float* p_s = reinterpret_cast<float*>(smem + L.off_p) + warp * a.rc * wt;
  const float* ks_s = reinterpret_cast<const float*>(smem + L.off_ks);
  const float* vs_s = reinterpret_cast<const float*>(smem + L.off_vs);

  // lane -> (token, vector) of a copy step: no division in the loop when
  // a row's vectors divide the warp (the usual rows of 64 to 512 bytes)
  const bool k_even = 32 % nvk == 0, v_even = 32 % nvv == 0;
  const int k_step = k_even ? 32 / nvk : 0, k_t0 = lane / nvk;
  const int v_step = v_even ? 32 / nvv : 0, v_t0 = lane / nvv;

  // warp tile j into its ring slot; `entry` is entry_of(j)
  auto load_tile = [&](int j, int entry) {
    const int row0 = ring0 + (j % a.stages) * wt;
    const int tok0 = t_lo + (j * kWarps + warp) * wt;
    int slot = -1;  // pool row (block * bs + offset) of token tok0 + lane
    if (lane < wt && tok0 + lane < t_hi) {
      const int tok = tok0 + lane;
      const int blk = clamp_block(entry, a.nb);
      slot = blk * a.bs + tok % a.bs;
    }
    for (int it = 0; it * 32 < wt * nvk; ++it) {
      const int idx = it * 32 + lane;
      const int t = min(k_even ? it * k_step + k_t0 : idx / nvk, wt - 1);
      const int s = __shfl_sync(0xffffffffu, slot, t);
      if (idx < wt * nvk) {
        const int v = idx - t * nvk;
        const bool ok = s >= 0;
        const unsigned char* src =
            ok ? kpool + ((size_t)s * a.g + grp) * row_bytes + v * 16 : kpool;
        cp_async16(smem + L.off_k + (size_t)(row0 + t) * L.k_row + v * 16,
                   src, ok);
      }
    }
    for (int it = 0; it * 32 < wt * nvv; ++it) {
      const int idx = it * 32 + lane;
      const int t = min(v_even ? it * v_step + v_t0 : idx / nvv, wt - 1);
      const int s = __shfl_sync(0xffffffffu, slot, t);
      if (idx < wt * nvv) {
        const int v = idx - t * nvv;
        const bool ok = s >= 0;
        const unsigned char* src =
            ok ? vpool + ((size_t)s * a.g + grp) * row_bytes +
                     (size_t)d0 * sizeof(P) + v * 16
               : vpool;
        cp_async16(smem + L.off_v + (size_t)(row0 + t) * L.v_row + v * 16,
                   src, ok);
      }
    }
    if (kQuant && lane < wt) {
      const bool ok = slot >= 0;
      const size_t si = ok ? (size_t)slot * a.g + grp : 0;
      cp_async4(smem + L.off_ks + (size_t)(row0 + lane) * 4, a.k_scale + si,
                ok);
      cp_async4(smem + L.off_vs + (size_t)(row0 + lane) * 4, a.v_scale + si,
                ok);
    }
  };

  // head r's running max and sum (base 2) and last rescale, in lane r
  float m_l = APEX_NEG_INF, l_l = 0.0f, a_l = 0.0f;
  // P V accumulators: H > 1, EPL dims a lane of every head; H == 1, the
  // lane's own token's share (the vectors v = part, part + parts, ...),
  // summed over the warp's tokens after the loop
  constexpr int kSlots = slots_of<P, EPL>();  // a lane's vectors, H == 1
  float acc[H][EPL];
  float acc1[H == 1 ? kSlots : 1][kCV];
  float qreg[H == 1 ? kSlots : 1][kCV];  // H == 1: the lane's query share
#pragma unroll
  for (int r = 0; r < H; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.0f;
#pragma unroll
  for (int u = 0; u < (H == 1 ? kSlots : 1); ++u)
#pragma unroll
    for (int e = 0; e < kCV; ++e) acc1[u][e] = 0.0f;

  const int t = lane & (wt - 1);  // Q K: this lane's token, and part
  const int part = lane / wt;
  const int dl = lane * EPL;      // P V: this lane's first dim
  int next_entry = 0;  // warp tile j + stages - 1's, loaded a step early
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < a.stages - 1) {
      if (j < n_wt) load_tile(j, first_entry[j]);
      cp_async_commit();
    } else if (j == a.stages - 1) {
      next_entry = first_entry[j];
    }
  }
  // the query heads load while the first tiles are in flight
  // (roped and rounded like the unfused path for K3)
  {
    const T* qg = reinterpret_cast<const T*>(a.q) +
                  ((size_t)i * a.nh + (size_t)grp * rep + r0) * a.dh;
    for (int e = threadIdx.x; e < rcc * a.dh; e += kThreads) {
      const int r = e / a.dh, d = e - r * a.dh;
      const T* qh = qg + (size_t)r * a.dh;
      float qv = apex_to_float(qh[d]);
      if (d < a.d2) {
        const int half = a.d2 / 2;
        const float rot = d < half ? -apex_to_float(qh[d + half])
                                   : apex_to_float(qh[d - half]);
        const float cs = a.rope_cos[(size_t)i * a.d2 + d];
        const float sn = a.rope_sin[(size_t)i * a.d2 + d];
        qv = apex_round<T>(__fadd_rn(__fmul_rn(qv, cs), __fmul_rn(rot, sn)));
      }
      q_s[e] = qv;
    }
  }
  __syncthreads();
  if constexpr (H == 1) {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int v = part + u * parts;
#pragma unroll
      for (int e = 0; e < kCV; ++e)
        qreg[u][e] = v < nvk ? q_s[v * kCV + e] : 0.0f;
    }
  }

  for (int j = 0; j < n_wt; ++j) {
    if (j + a.stages - 1 < n_wt) {
      load_tile(j + a.stages - 1, next_entry);
      next_entry = entry_of(j + a.stages);  // used next step: no stall now
    }
    cp_async_commit();
    cp_async_wait(a.stages - 1);
    __syncwarp();

    const int row0 = ring0 + (j % a.stages) * wt;
    const int tok0 = t_lo + (j * kWarps + warp) * wt;
    const int ntok = min(wt, t_hi - tok0);

    // scores of the CTA's heads for token t: this lane's vectors, then the
    // token's lanes summed by shuffles
    float dot[H];
#pragma unroll
    for (int r = 0; r < H; ++r) dot[r] = 0.0f;
    const unsigned char* krow = smem + L.off_k + (size_t)(row0 + t) * L.k_row;
    const float sk = kQuant ? ks_s[row0 + t] : 1.0f;
    if constexpr (H == 1) {
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int v = part + u * parts;
        if (v < nvk) {
          float kv[kCV];
          load_small<P, kCV>(krow + v * 16, kv);
#pragma unroll
          for (int e = 0; e < kCV; ++e)
            dot[0] = fmaf(qreg[u][e], kQuant ? kv[e] * sk : kv[e], dot[0]);
        }
      }
    } else {
      for (int v = part; v < nvk; v += parts) {
        float kv[kCV];
        load_small<P, kCV>(krow + v * 16, kv);
        if (kQuant) {
#pragma unroll
          for (int e = 0; e < kCV; ++e) kv[e] *= sk;
        }
        const float* qv = q_s + v * kCV;
#pragma unroll
        for (int r = 0; r < H; ++r) {
          if (r < rcc) {
#pragma unroll
            for (int e4 = 0; e4 < kCV; e4 += 4) {
              const float4 qq =
                  *reinterpret_cast<const float4*>(qv + r * a.dh + e4);
              dot[r] = fmaf(qq.x, kv[e4], dot[r]);
              dot[r] = fmaf(qq.y, kv[e4 + 1], dot[r]);
              dot[r] = fmaf(qq.z, kv[e4 + 2], dot[r]);
              dot[r] = fmaf(qq.w, kv[e4 + 3], dot[r]);
            }
          }
        }
      }
    }
    // online softmax per head over the warp tile's tokens, every head's
    // shuffle chain advanced one step at a time (their latencies overlap)
    const bool live = t < ntok;
    for (int o = wt; o < 32; o <<= 1) {
#pragma unroll
      for (int r = 0; r < H; ++r)
        if (r < rcc) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
    }
    float mt[H];
#pragma unroll
    for (int r = 0; r < H; ++r) {
      dot[r] = live ? dot[r] * a.scale_log2 : APEX_NEG_INF;
      mt[r] = dot[r];
    }
    for (int o = 1; o < wt; o <<= 1) {
#pragma unroll
      for (int r = 0; r < H; ++r)
        if (r < rcc)
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], o));
    }
    float p_own = 0.0f;  // H == 1: this lane's token's p, for P V
#pragma unroll
    for (int r = 0; r < H; ++r) {
      if (r < rcc) {
        const float m_new = fmaxf(__shfl_sync(0xffffffffu, m_l, r), mt[r]);
        mt[r] = m_new;
        dot[r] = live ? apex_exp2(dot[r] - m_new) : 0.0f;  // p
        if (H == 1) p_own = dot[r];
        else if (part == 0) p_s[r * wt + t] = dot[r];
      }
    }
    for (int o = 1; o < wt; o <<= 1) {
#pragma unroll
      for (int r = 0; r < H; ++r)
        if (r < rcc) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
    }
#pragma unroll
    for (int r = 0; r < H; ++r) {
      if (r < rcc && lane == r) {  // head r's state lives in lane r
        const float alpha = apex_exp2(m_l - mt[r]);
        l_l = l_l * alpha + dot[r];
        m_l = mt[r];
        a_l = alpha;
      }
    }
    __syncwarp();
    if constexpr (H == 1) {
      // P V, token-parallel: this lane's token's p times its share of the
      // token's V row
      const float al = __shfl_sync(0xffffffffu, a_l, 0);
      const unsigned char* vrow = smem + L.off_v + (size_t)(row0 + t) * L.v_row;
      const float sv = kQuant ? vs_s[row0 + t] : 1.0f;
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int v = part + u * parts;
        if (v < nvv) {
          float vv[kCV];
          load_small<P, kCV>(vrow + v * 16, vv);
#pragma unroll
          for (int e = 0; e < kCV; ++e)
            acc1[u][e] = fmaf(p_own, kQuant ? vv[e] * sv : vv[e],
                              acc1[u][e] * al);
        }
      }
      __syncwarp();
      continue;
    }
    // P V: this lane's dims of every head over the tile's tokens
#pragma unroll
    for (int r = 0; r < H; ++r) {
      if (r < rcc) {
        const float al = __shfl_sync(0xffffffffu, a_l, r);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] *= al;
      }
    }
#pragma unroll 4
    for (int tt = 0; tt < ntok; ++tt) {
      float vv[EPL];
      load_lane<P, EPL>(smem + L.off_v + (size_t)(row0 + tt) * L.v_row, dl,
                        dn, vv);
      if (kQuant) {
        const float sv = vs_s[row0 + tt];
#pragma unroll
        for (int e = 0; e < EPL; ++e) vv[e] *= sv;
      }
#pragma unroll
      for (int r = 0; r < H; ++r) {
        if (r < rcc) {
          const float p = p_s[r * wt + tt];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
        }
      }
    }
    __syncwarp();  // the ring slot and p_s are rewritten next
  }

  // ---- the warps' partials, combined in warp order --------------------
  __syncthreads();  // every warp is out of the loop: its bytes are free
  float* wm = reinterpret_cast<float*>(smem + L.off_wpart);  // [kWarps][rc]
  float* wl = wm + kWarps * a.rc;
  float* wacc = wl + kWarps * a.rc;  // [kWarps][rc][dn_max]
  if (lane < rcc) {
    wm[warp * a.rc + lane] = m_l;
    wl[warp * a.rc + lane] = l_l;
  }
  if constexpr (H == 1) {
    // the warp's tokens' shares summed (lanes of one part), lane t = 0 of
    // each part stores its vectors
    for (int o = 1; o < wt; o <<= 1) {
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
#pragma unroll
        for (int e = 0; e < kCV; ++e)
          acc1[u][e] += __shfl_xor_sync(0xffffffffu, acc1[u][e], o);
    }
    if (t == 0) {
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int v = part + u * parts;
        if (v < nvv) {
#pragma unroll
          for (int e = 0; e < kCV; ++e)
            wacc[(size_t)warp * a.rc * a.dn_max + v * kCV + e] = acc1[u][e];
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < H; ++r) {
      if (r < rcc) {
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          if (dl + e < dn)
            wacc[(size_t)(warp * a.rc + r) * a.dn_max + dl + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  // one live chunk: the context is final; else the chunk's partial, for
  // paged_combine_kernel: [m (rc), l (rc), acc (rc x dn_max)]
  const bool single = n_live == 1;
  float* dst = a.part + (((size_t)i * gridDim.y + blockIdx.y) * gridDim.x + c) *
                            ((size_t)a.rc * (a.dn_max + 2));
  for (int e = threadIdx.x; e < rcc * dn; e += kThreads) {
    const int r = e / dn, d = e - r * dn;
    float mx = APEX_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * a.rc + r]);
    float sa = 0.0f, sl = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = apex_exp2(wm[w * a.rc + r] - mx);
      sa = fmaf(wacc[(size_t)(w * a.rc + r) * a.dn_max + d], f, sa);
      sl = fmaf(wl[w * a.rc + r], f, sl);
    }
    if (single) {
      out[(size_t)r * a.dh + d] = apex_from_float<T>(sa / sl);
    } else {
      dst[2 * a.rc + r * a.dn_max + d] = sa;
      if (d == 0) {
        dst[r] = mx;
        dst[a.rc + r] = sl;
      }
    }
  }
}

// The number of chunks holding lane i's keys.
__device__ __forceinline__ int live_chunks(const Args& a, int i) {
  const int len = max(0, min(a.lengths[i], a.mb * a.bs));
  return (len + a.chunk - 1) / a.chunk;
}

// Element (head r of the block, dim d of the block) of lane i's context
// from the n_live > 1 partials at `part` (splits of them, chunk order).
__device__ __forceinline__ float combine_partials(const Args& a,
                                                  const float* part,
                                                  int n_live, int r, int d) {
  const size_t stride = (size_t)a.rc * (a.dn_max + 2);
  float mx = APEX_NEG_INF;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, part[s * stride + r]);
  float sa = 0.0f, sl = 0.0f;
  for (int s = 0; s < n_live; ++s) {
    const float* ps = part + s * stride;
    const float f = apex_exp2(ps[r] - mx);
    sa = fmaf(ps[2 * a.rc + r * a.dn_max + d], f, sa);
    sl = fmaf(ps[a.rc + r], f, sl);
  }
  return sa / sl;
}

// The second pass: for each (sequence, group block) of more than one live
// chunk, the chunks' partials added in chunk order (chunks past the length
// wrote none and are not read), the context written in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const Args a, int splits) {
  const int i = blockIdx.y;
  const int n_live = live_chunks(a, i);
  if (n_live <= 1) return;  // finished by the split kernel
  int y = blockIdx.x;
  const int dci = y % a.dim_chunks;
  y /= a.dim_chunks;
  const int hci = y % a.head_chunks;
  const int grp = y / a.head_chunks;
  const int rep = a.nh / a.g;
  const int r0 = hci * a.rc;
  const int rcc = min(a.rc, rep - r0);
  const int d0 = dci * a.dn_max;
  const int dn = min(a.dn_max, a.dh - d0);
  const size_t stride = (size_t)a.rc * (a.dn_max + 2);
  const float* part =
      a.part + ((size_t)i * gridDim.x + blockIdx.x) * splits * stride;
  T* out = reinterpret_cast<T*>(a.out) +
           ((size_t)i * a.nh + (size_t)grp * rep + r0) * a.dh + d0;
  griddep_wait();  // the split kernel's partials are complete
  for (int e = threadIdx.x; e < rcc * dn; e += kThreads) {
    const int r = e / dn, d = e - r * dn;
    out[(size_t)r * a.dh + d] =
        apex_from_float<T>(combine_partials(a, part, n_live, r, d));
  }
}

// Launch `kern` on `grid` x `threads` with dynamic shared memory `smem`,
// as a programmatic dependent of the kernel before it on the stream, and
// as clusters of `cluster_y` CTAs along y when that is above 1.
template <typename... Params, typename... Args2>
int launch_dependent(void (*kern)(Params...), dim3 grid, int threads,
                     int smem, int cluster_y, cudaStream_t stream,
                     Args2... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = cluster_y;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_y > 1 ? 2 : 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- host --

inline void set_plan(Args& a, int chunk, int rc, int head_chunks, int epl,
                     int dim_chunks, int tile, int stages) {
  a.chunk = chunk;
  a.rc = rc;
  a.head_chunks = head_chunks;
  a.dim_chunks = dim_chunks;
  a.dn_max = a.dh < 32 * epl ? a.dh : 32 * epl;
  a.tile = tile;
  a.stages = stages;
}

// What the plan asks of the launch, checked: the C entries take the plan
// as arguments and refuse one that does not fit the shapes.
inline bool plan_ok(int b, int nh, int dh, int g, int elem_bytes, int mb,
                    int bs, int splits, const Args& a, int heads, int epl,
                    int smem) {
  if (b <= 0 || g <= 0 || nh <= 0 || nh % g || dh <= 0 ||
      (dh * elem_bytes) % 16 || mb <= 0 || bs <= 0 || b > 65535)
    return false;
  const int rep = nh / g;
  if (splits < 1 || splits > kMaxSplits || a.chunk <= 0 ||
      a.chunk % (kWarps * a.tile) || (long long)splits * a.chunk <
      (long long)mb * bs || (long long)(splits - 1) * a.chunk >=
      (long long)mb * bs)
    return false;
  if (a.tile < 1 || a.tile > 32 || (a.tile & (a.tile - 1)) || a.stages < 2 ||
      a.stages > 4)
    return false;
  if (a.rc < 1 || a.rc > heads || a.head_chunks < 1 ||
      (long long)a.rc * a.head_chunks < rep ||
      (long long)a.rc * (a.head_chunks - 1) >= rep)
    return false;
  if (a.dn_max != (dh < 32 * epl ? dh : 32 * epl) || a.dim_chunks < 1 ||
      (long long)a.dn_max * a.dim_chunks < dh ||
      (long long)a.dn_max * (a.dim_chunks - 1) >= dh)
    return false;
  if ((long long)g * a.head_chunks * a.dim_chunks > 65535) return false;
  if (heads == 1) {  // the one-head variant holds a lane's share of a row
    const int parts = 32 / a.tile;
    const int slots = epl * elem_bytes < 8 ? epl * elem_bytes : 8;
    if (a.dim_chunks != 1 || (dh * elem_bytes / 16 + parts - 1) / parts > slots)
      return false;
  }
  const Layout L = layout(dh, elem_bytes, elem_bytes == 1, a.rc, a.dn_max,
                          a.tile, a.stages);
  return smem == L.total && smem <= kSmemMax;
}

// The split kernel, then (keys in more than one chunk, and `combine`) the
// combine as its programmatic dependent; `part` holds splits partials of
// rc x (dn_max + 2) floats for each (sequence, group block).
template <typename T, typename P, int H, int EPL>
int launch_split(const Args& a, int b, int splits, int smem, bool combine,
                 cudaStream_t stream) {
  auto kern = paged_split_kernel<T, P, H, EPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = a.g * a.head_chunks * a.dim_chunks;
  kern<<<dim3(splits, blocks, b), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1 || !combine) return (int)err;
  return launch_dependent(paged_combine_kernel<T>, dim3(blocks, b), kThreads,
                          0, 1, stream, a, splits);
}

// What the runtime reports of one instantiation at `smem` bytes of dynamic
// shared memory: out = {registers per thread, shared memory per CTA,
// resident CTAs per SM, local (spill) bytes per thread}.
template <typename Kern>
int kernel_attrs(Kern kern, int smem, int threads, int* out) {
  cudaFuncAttributes fa;
  int ctas = 0;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == 0) err = (int)cudaFuncGetAttributes(&fa, kern);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern,
                                                             threads, smem);
  if (err != 0) return err;
  out[0] = fa.numRegs;
  out[1] = smem + (int)fa.sharedSizeBytes;
  out[2] = ctas;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

// The pool's element type behind an integer code: the float codes of
// common.cuh (the pool in any float dtype, whatever the compute dtype T),
// or kPoolInt8 for the block-scaled int8 pool.
constexpr int kPoolInt8 = 3;

// Runs the statements with P bound to the pool element type named by
// code; returns cudaErrorInvalidValue for an unknown code.
#define APEX_PAGED_POOL(code, P, ...)               \
  switch (code) {                                   \
    case APEX_F32: {                                \
      using P = float;                              \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case APEX_BF16: {                               \
      using P = __nv_bfloat16;                      \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case APEX_F16: {                                \
      using P = __half;                             \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case kPoolInt8: {                               \
      using P = int8_t;                             \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    default:                                        \
      return (int)cudaErrorInvalidValue;            \
  }

// Runs the statements with H and EPL bound to the plan's kernel variant:
// heads 1, 4 or 16, P V elements a lane 2 or 4.
#define APEX_PAGED_VARIANT(heads, epl, ...)            \
  do {                                                 \
    if ((heads) == 1 && (epl) == 2) {                  \
      constexpr int H = 1, EPL = 2;                    \
      __VA_ARGS__;                                     \
    } else if ((heads) == 1 && (epl) == 4) {           \
      constexpr int H = 1, EPL = 4;                    \
      __VA_ARGS__;                                     \
    } else if ((heads) == 4 && (epl) == 2) {           \
      constexpr int H = 4, EPL = 2;                    \
      __VA_ARGS__;                                     \
    } else if ((heads) == 4 && (epl) == 4) {           \
      constexpr int H = 4, EPL = 4;                    \
      __VA_ARGS__;                                     \
    } else if ((heads) == 16 && (epl) == 2) {          \
      constexpr int H = 16, EPL = 2;                   \
      __VA_ARGS__;                                     \
    } else if ((heads) == 16 && (epl) == 4) {          \
      constexpr int H = 16, EPL = 4;                   \
      __VA_ARGS__;                                     \
    }                                                  \
  } while (0)

}  // namespace apex_paged
