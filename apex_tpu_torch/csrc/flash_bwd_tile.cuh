// Shared tiles of the flash-attention backward kernels: K6 and K7
// (flash_attention_bwd.cu) and row 5 (flash_attention_bwd_short.cu).
//
// Four warps per CTA, each owning 16 rows of a 64-row tile.  Input tiles
// sit in shared memory in their own type; scores and dp in fp32 shared
// memory; p and ds are rounded to the input type for the tensor-core
// products (WMMA 16x16x16, fp32 accumulators) and fp32 inputs take a
// CUDA-core 16x16x16 product that rounds nothing.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "keep_mask.cuh"
#include "sm90_tile.cuh"

namespace {

constexpr int kB = 64;  // query and key tile rows
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// A 16x16 fp32 accumulator owned by one warp: a WMMA fragment for 16-bit
// inputs; for fp32 inputs lane l holds row l/2, columns (l%2)*8 .. +7.
template <typename T>
struct Acc {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f;
  __device__ __forceinline__ void zero() { nvcuda::wmma::fill_fragment(f, 0.0f); }
  __device__ __forceinline__ void store(float* c, int ldc) {
    nvcuda::wmma::store_matrix_sync(c, f, ldc, nvcuda::wmma::mem_row_major);
  }
};

template <>
struct Acc<float> {
  float v[8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.0f;
  }
  __device__ __forceinline__ void store(float* c, int ldc) {
    const int lane = threadIdx.x & 31;
    float* p = c + (lane >> 1) * ldc + (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = v[j];
  }
};

// acc += A[16 x 16] B[16 x 16] over shared-memory operands.  A's element
// (m, k) is a[m * lda + k] when A_ROW, else a[k * lda + m]; B's (k, n) is
// b[k * ldb + n] when B_ROW, else b[n * ldb + k].
template <bool A_ROW, bool B_ROW, typename T>
__device__ __forceinline__ void mma16(Acc<T>& acc, const T* a, int lda,
                                      const T* b, int ldb) {
  if constexpr (std::is_same<T, float>::value) {
    const int lane = threadIdx.x & 31;
    const int m = lane >> 1, n0 = (lane & 1) * 8;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float av = A_ROW ? a[m * lda + k] : a[k * lda + m];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc.v[j] += av * (B_ROW ? b[k * ldb + n0 + j] : b[(n0 + j) * ldb + k]);
    }
  } else {
    using namespace nvcuda;
    using LA = typename std::conditional<A_ROW, wmma::row_major,
                                         wmma::col_major>::type;
    using LB = typename std::conditional<B_ROW, wmma::row_major,
                                         wmma::col_major>::type;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> fb;
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, b, ldb);
    wmma::mma_sync(acc.f, fa, fb, acc.f);
  }
}

// Shared-memory layout (every offset a multiple of 32 bytes, as WMMA
// loads and stores need).
template <typename T, int D>
struct Smem {
  static constexpr int LDT = D + 8;    // T tiles: q, do, k, v
  static constexpr int LDS = kB + 4;   // fp32 scores and dp
  static constexpr int LDP = kB + 8;   // T probabilities and ds
  static constexpr int tile = kB * LDT * (int)sizeof(T);
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + tile;
  static constexpr int k_off = do_off + tile;
  static constexpr int v_off = k_off + tile;
  static constexpr int s_off = v_off + tile;
  static constexpr int dp_off = s_off + kB * LDS * 4;
  static constexpr int p_off = dp_off + kB * LDS * 4;
  static constexpr int ds_off = p_off + kB * LDP * (int)sizeof(T);
  static constexpr int l_off = ds_off + kB * LDP * (int)sizeof(T);
  static constexpr int dl_off = l_off + kB * 4;
  static constexpr int bytes = dl_off + kB * 4;
};

// kB rows x D of T from src (row r at src + r * stride) into dst with
// leading dimension D + 8, 16 bytes per access; rows at or past nrows and
// columns at or past dr (a multiple of 8) are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int nrows, int stride, int dr) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int LDT = D + 8;
  for (int i = threadIdx.x; i < kB * (D / kVec); i += kThreads) {
    const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows && c < dr)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
  }
}

// lse and delta of query rows q0 .. q0+kB-1 of flat head bh; rows at or
// past sq get the -1e30 sentinel (their p is then 0).
__device__ __forceinline__ void load_row_stats(float* sL, float* sDl,
                                               const float* lse,
                                               const float* delta, int bh,
                                               int q0, int sq) {
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const int row = q0 + i;
    const bool in = row < sq;
    sL[i] = in ? lse[(size_t)bh * sq + row] : APEX_NEG_INF;
    sDl[i] = in ? delta[(size_t)bh * sq + row] : 0.0f;
  }
}

// This warp's 16 query rows: S = Q K^T and dP = dO V^T into fp32 shared
// memory, then p and ds (rounded to T) by two lanes per row.  Segment ids
// mask keys of other segments; under dropout sP holds the dropped p (dv's
// operand) and ds takes the dropped dp (flash_attention.py:424-427,
// :511-527), the hash keyed by flat head bh.
template <typename T, int D>
__device__ __forceinline__ void probs_and_ds(
    unsigned char* smem, const float* __restrict__ kpm, int b, int sk,
    int q0, int k0, float scale, int causal, const FlashExtras& ex,
    const Dropout& drop, int bh) {
  using L = Smem<T, D>;
  const T* sQ = reinterpret_cast<const T*>(smem + L::q_off);
  const T* sdO = reinterpret_cast<const T*>(smem + L::do_off);
  const T* sK = reinterpret_cast<const T*>(smem + L::k_off);
  const T* sV = reinterpret_cast<const T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sdP = reinterpret_cast<float*>(smem + L::dp_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  T* sdS = reinterpret_cast<T*>(smem + L::ds_off);
  const float* sL = reinterpret_cast<const float*>(smem + L::l_off);
  const float* sDl = reinterpret_cast<const float*>(smem + L::dl_off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;

#pragma unroll
  for (int nb = 0; nb < kB / 16; ++nb) {
    Acc<T> s, dp;
    s.zero();
    dp.zero();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma16<true, false>(s, sQ + r0 * L::LDT + kk * 16, L::LDT,
                         sK + nb * 16 * L::LDT + kk * 16, L::LDT);
      mma16<true, false>(dp, sdO + r0 * L::LDT + kk * 16, L::LDT,
                         sV + nb * 16 * L::LDT + kk * 16, L::LDT);
    }
    s.store(sS + r0 * L::LDS + nb * 16, L::LDS);
    dp.store(sdP + r0 * L::LDS + nb * 16, L::LDS);
  }
  __syncwarp();

  const int lrow = r0 + (lane >> 1);
  const int half = lane & 1;
  const int row = q0 + lrow;
  const float lse = sL[lrow];
  const float dl = sDl[lrow];
  const bool live = lse > APEX_NEG_INF / 2;
  const int qs = ex.seg != nullptr ? seg_at(ex, b, sk, row) : 0;
  for (int c = 0; c < kB / 2; ++c) {
    const int cc = half * (kB / 2) + c;
    const int col = k0 + cc;
    float sv = sS[lrow * L::LDS + cc] * scale;
    if (kpm != nullptr && col < sk) sv += kpm[(size_t)b * sk + col];
    const bool pred =
        live && col < sk && (!causal || col <= row) &&
        (ex.seg == nullptr || seg_open(qs, seg_at(ex, b, sk, col)));
    const float p = pred ? expf(sv - lse) : 0.0f;
    float dpv = sdP[lrow * L::LDS + cc], pa = p;
    if (drop.on) {
      const bool kept = drop.keep(bh, row, col);
      dpv = kept ? dpv * drop.inv : 0.0f;
      pa = kept ? p * drop.inv : 0.0f;
    }
    const float ds = p * (dpv - dl) * scale;
    sP[lrow * L::LDP + cc] = apex_from_float<T>(pa);
    sdS[lrow * L::LDP + cc] = apex_from_float<T>(ds);
  }
  __syncwarp();
}

// Writes one 16x16 fp32 accumulator of this warp to rows row0.. of out
// (row r at out + r * stride, columns col0..col0+15), staged through the
// warp's 16 x LDS slice of stage; rows at or past nrows and columns at or
// past ncols are skipped.
template <typename T>
__device__ __forceinline__ void store_acc(Acc<T>& acc, float* stage, int lds,
                                          T* out, int row0, int nrows,
                                          size_t stride, int col0,
                                          int ncols) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  acc.store(stage, lds);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int r = e >> 4, c = e & 15;
    if (row0 + r < nrows && col0 + c < ncols)
      out[(size_t)(row0 + r) * stride + col0 + c] =
          apex_from_float<T>(stage[r * lds + c]);
  }
}

template <typename Kern>
int prepare(Kern kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Runs the statements with D bound to the tile width of head size d
// (sm90::head_panel: 32, 64 or 128 for a multiple of 8 up to 128).
#define APEX_DISPATCH_HEAD_DIM(d, D, ...)  \
  switch (sm90::head_panel(d)) {           \
    case 32: {                             \
      constexpr int D = 32;                \
      return __VA_ARGS__;                  \
    }                                      \
    case 64: {                             \
      constexpr int D = 64;                \
      return __VA_ARGS__;                  \
    }                                      \
    case 128: {                            \
      constexpr int D = 128;               \
      return __VA_ARGS__;                  \
    }                                      \
    default:                               \
      return (int)cudaErrorInvalidValue;   \
  }

}  // namespace
