// The tensor-core tile shared by kernel rows 9 (csrc/grouped_matmul.cu,
// its 16-bit and int8 branches) and 10 (csrc/dense_int8.cu).
//
// A CTA of four warps computes a 64 x 64 fp32 tile of A [rows, K] x
// B [K, cols] with mma.sync m16n8k16: bf16 or fp16 operands, fp32
// accumulation, so the products are exact in fp32 and the result is an
// fp32 matmul of the 16-bit values up to summation order.  K advances in
// steps of 32 staged in shared memory: A row-major (k contiguous), B as
// below; the fragments take the layouts of mma.sync's "row.col"
// operands.  Each warp holds a 32 x 32
// quarter as 2 x 4 fragments of 16 x 8.  The accumulator layout of
// mma.sync is fixed (rows groupID and groupID + 8, columns
// 2 * (lane % 4) + {0, 1}), so each thread knows the output elements it
// holds: a per-column scale applies in registers (the int8 slabs) and
// the store masks rows and columns element by element.
//
// B stages in shared memory in the layout its source has, so every
// thread stores whole 16-byte chunks: a row-major [K, N] slab (the
// forward's weights, an int8 slab widened on the way) lands k-major in
// MmaSmemKN and its fragments load with ldmatrix.trans; a slab stored
// transposed, [N, K] (the backward's dx reads w[g]^T in place), lands
// n-major in MmaSmemNK and its fragments load as they are.  The loaders
// zero-fill what lies outside the operands: rows past the tile's row
// count, k past K, columns past N.  They need 16-byte-aligned bases and
// row strides, so a 16-bit operand's contiguous axis must be a multiple
// of 8 and an int8 slab's row a multiple of 16.  Loads are synchronous
// (no cp.async or TMA pipeline yet).
#pragma once

#include "common.cuh"

namespace {

constexpr int kTileM = 64, kTileN = 64, kTileK = 32, kTilePad = 8;
constexpr int kTileThreads = 128;

// A k-contiguous; B n-major (k contiguous), fragments read as they are
template <typename T>
struct MmaSmemNK {
  T a[kTileM][kTileK + kTilePad];
  T b[kTileN][kTileK + kTilePad];
};

// A k-contiguous; B k-major (n contiguous), fragments by ldmatrix.trans.
// Rows of 144 bytes: the 8 row addresses of one ldmatrix matrix fall on
// distinct banks.
template <typename T>
struct MmaSmemKN {
  T a[kTileM][kTileK + kTilePad];
  T b[kTileK][kTileN + kTilePad];
};

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// |q| <= 127 is exact in bf16 and fp16
template <typename T>
__device__ __forceinline__ T from_int8(int8_t v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_int8<__nv_bfloat16>(int8_t v) {
  return __float2bfloat16_rn((float)v);
}
template <>
__device__ __forceinline__ __half from_int8<__half>(int8_t v) {
  return __float2half_rn((float)v);
}

// A warp's 32 x 32 quarter of the tile: [m fragment][n fragment][4]
using MmaFrag = float[2][4][4];

__device__ __forceinline__ void mma_zero(MmaFrag& d) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) d[a][b][c] = 0.0f;
}

// Tile row and column of fragment element (mt, nt, c) of this thread.
__device__ __forceinline__ int mma_row(int mt, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 1) * 32 + mt * 16 + (lane >> 2) + (c >= 2 ? 8 : 0);
}
__device__ __forceinline__ int mma_col(int nt, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp & 1) * 32 + nt * 8 + (lane & 3) * 2 + (c & 1);
}

// This warp's A fragments of k step kk (16 wide) of the staged tile.
template <typename S>
__device__ __forceinline__ void mma_load_a(const S& s, int kk,
                                           uint32_t (&af)[2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = (warp >> 1) * 32 + mt * 16 + grp;
    af[mt][0] = *reinterpret_cast<const uint32_t*>(&s.a[r][kk + tig * 2]);
    af[mt][1] = *reinterpret_cast<const uint32_t*>(&s.a[r + 8][kk + tig * 2]);
    af[mt][2] = *reinterpret_cast<const uint32_t*>(&s.a[r][kk + tig * 2 + 8]);
    af[mt][3] =
        *reinterpret_cast<const uint32_t*>(&s.a[r + 8][kk + tig * 2 + 8]);
  }
}

// This warp's B fragments of k step kk, B n-major: b[nt] holds
// B[k = kk + 2 * tig + {0, 1} (+ 8)][n = nt * 8 + groupID].
template <typename T>
__device__ __forceinline__ void mma_load_b(const MmaSmemNK<T>& s, int kk,
                                           uint32_t (&bf)[4][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = (warp & 1) * 32 + nt * 8 + grp;
    bf[nt][0] = *reinterpret_cast<const uint32_t*>(&s.b[n][kk + tig * 2]);
    bf[nt][1] = *reinterpret_cast<const uint32_t*>(&s.b[n][kk + tig * 2 + 8]);
  }
}

// The same fragments from B k-major: one ldmatrix.x4.trans per pair of
// n fragments.  Lane l addresses row l % 8 of matrix l / 8: matrices 0
// and 1 are k rows 0-7 and 8-15 of fragment nt, 2 and 3 those of nt + 1;
// the transposed load hands each thread the (k, k + 1) pair of its
// column, the layout of mma.sync's col-major B.
template <typename T>
__device__ __forceinline__ void mma_load_b(const MmaSmemKN<T>& s, int kk,
                                           uint32_t (&bf)[4][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = lane >> 3;
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    const int n = (warp & 1) * 32 + np * 16 + (m >> 1) * 8;
    const T* p = &s.b[kk + (m & 1) * 8 + (lane & 7)][n];
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(bf[2 * np][0]), "=r"(bf[2 * np][1]), "=r"(bf[2 * np + 1][0]),
          "=r"(bf[2 * np + 1][1])
        : "r"(addr));
  }
}

// d += the staged A tile x B tile (one k step of kTileK), this warp's
// quarter.
template <typename T, template <typename> class S>
__device__ __forceinline__ void mma_tile_step(const S<T>& s, MmaFrag& d) {
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 16) {
    uint32_t af[2][4], bf[4][2];
    mma_load_a(s, kk, af);
    mma_load_b(s, kk, bf);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma16816<T>(d[mt][nt], af[mt], bf[nt]);
  }
}

// acc += part x (the scale row's value at each column), then part = 0:
// one k block of an int8 slab ends.  srow points at the scale row's
// column 0; columns n0 + tile column past N take scale 0.
__device__ __forceinline__ void mma_scale_add(MmaFrag& acc, MmaFrag& part,
                                              const float* __restrict__ srow,
                                              int n0, int N) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + mma_col(nt, 0);
    const float s0 = n < N ? srow[n] : 0.0f;
    const float s1 = n + 1 < N ? srow[n + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      acc[mt][nt][0] += part[mt][nt][0] * s0;
      acc[mt][nt][1] += part[mt][nt][1] * s1;
      acc[mt][nt][2] += part[mt][nt][2] * s0;
      acc[mt][nt][3] += part[mt][nt][3] * s1;
#pragma unroll
      for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.0f;
    }
  }
}

// Stage rows row0 .. row0 + R - 1 (R <= 64; the rest zero) and k0 ..
// k0 + 31 of a row-major [*, K] 16-bit operand into s.a.  K % 8 == 0.
template <typename T, template <typename> class S>
__device__ __forceinline__ void mma_stage_a(S<T>& s, const T* __restrict__ x,
                                            int K, int row0, int R, int k0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = threadIdx.x + j * kTileThreads;   // 256 chunks of 8
    const int r = c >> 2, col = (c & 3) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < R && k0 + col < K)
      v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * K + k0 +
                                          col);
    *reinterpret_cast<uint4*>(&s.a[r][col]) = v;
  }
}

// Stage B = a row-major [K, N] 16-bit slab, rows k0 .. k0 + 31 and
// columns n0 .. n0 + 63, k-major into s.b.  N % 8 == 0.
template <typename T>
__device__ __forceinline__ void mma_stage_b(MmaSmemKN<T>& s,
                                            const T* __restrict__ w, int K,
                                            int N, int k0, int n0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = threadIdx.x + j * kTileThreads;   // 256 chunks of 8
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k0 + r < K && n0 + col < N)
      v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 +
                                          col);
    *reinterpret_cast<uint4*>(&s.b[r][col]) = v;
  }
}

// Stage B from its transpose in memory: a row-major [N, K] 16-bit slab
// (row n holds column n of B), n-major into s.b as it is.  K % 8 == 0.
template <typename T>
__device__ __forceinline__ void mma_stage_bt(MmaSmemNK<T>& s,
                                             const T* __restrict__ wt, int K,
                                             int N, int k0, int n0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = threadIdx.x + j * kTileThreads;   // 256 chunks of 8
    const int n = c >> 2, kc = (c & 3) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n0 + n < N && k0 + kc < K)
      v = *reinterpret_cast<const uint4*>(wt + (size_t)(n0 + n) * K + k0 +
                                          kc);
    *reinterpret_cast<uint4*>(&s.b[n][kc]) = v;
  }
}

// Stage B = a row-major [K, N] int8 slab, widened to T, k-major into
// s.b: each thread's 16 int8 become two 16-byte stores.  N % 16 == 0.
template <typename T>
__device__ __forceinline__ void mma_stage_b_int8(MmaSmemKN<T>& s,
                                                 const int8_t* __restrict__ w,
                                                 int K, int N, int k0,
                                                 int n0) {
  const int r = threadIdx.x >> 2, col = (threadIdx.x & 3) * 16;  // 128 chunks
  alignas(16) int8_t v[16];
  alignas(16) T h[16];
  uint4 raw = make_uint4(0, 0, 0, 0);
  if (k0 + r < K && n0 + col < N)
    raw = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + col);
  *reinterpret_cast<uint4*>(v) = raw;
#pragma unroll
  for (int u = 0; u < 16; ++u) h[u] = from_int8<T>(v[u]);
  *reinterpret_cast<uint4*>(&s.b[r][col]) = *reinterpret_cast<uint4*>(h);
  *reinterpret_cast<uint4*>(&s.b[r][col + 8]) =
      *reinterpret_cast<uint4*>(h + 8);
}

// Write tile rows < R and columns n0 + c < N of the fragments to the
// row-major y (leading dimension ldy) at row row0, rounded once to O.
template <typename O>
__device__ __forceinline__ void mma_store(const MmaFrag& d, O* __restrict__ y,
                                          int ldy, int row0, int R, int n0,
                                          int N) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = mma_row(mt, c), n = n0 + mma_col(nt, c);
        if (r < R && n < N)
          y[(size_t)(row0 + r) * ldy + n] = apex_from_float<O>(d[mt][nt][c]);
      }
}

}  // namespace
