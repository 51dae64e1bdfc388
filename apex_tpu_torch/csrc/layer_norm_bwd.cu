// K5: LayerNorm / RMSNorm backward.
//
// Replaces apex_tpu/ops/layer_norm.py:_ln_bwd_kernel (launched by
// _ln_bwd_pallas): from the forward's fp32 statistics (mu, rstd), per row
//   xhat = (x - mu) * rstd,  g = dy * gamma,
//   c1 = mean(g),  c2 = mean(g * xhat),
//   dx = (g - c1 - xhat * c2) * rstd        (RMSNorm: no c1),
// plus dgamma = sum_rows(dy * xhat) and dbeta = sum_rows(dy) in fp32.
//
// The TPU kernel accumulates dgamma/dbeta into one (1, hidden) output
// tile that every grid step revisits in order.  Hopper blocks run in no
// order, so here each CTA writes the fp32 column sums of its own rows as
// one partial row, and a second small kernel adds the partial rows in a
// fixed order (no atomics: the sums are deterministic run to run).
//
// Bound on the H100: bytes.  dy and x are read and dx written once
// (~10 flops per element, far below the ~295 flop/byte ridge); the
// partial rows add 2 x (rows / kRows) x hidden fp32 values, 1/32 of x at
// bf16 for 64-row CTAs.
// Design: 256 threads = 8 warps per CTA over a run of rows_per_block
// rows, one warp per row.  Rows that are a whole number of 16-byte
// vectors and at most 32 values per lane (hidden <= 1024) take the
// register path: dy and x are read once with 16-byte loads and held for
// the two row sums (warp shuffles) and dx, and each lane keeps the fp32
// dgamma/dbeta sums of its own columns across the warp's rows; the CTA
// then adds its 8 warps' sums in warp order through shared memory.  Any
// other width takes a lane-strided scalar path: phase 1 as above with
// the second read of the row from L1, phase 2 one thread per column
// summing the CTA's rows in row order (from L2).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ w, const float* __restrict__ mu,
                  const float* __restrict__ rs, T* __restrict__ dx,
                  float* __restrict__ dw_part, float* __restrict__ db_part,
                  int rows, int hidden, int rows_per_block, int rms) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const float inv_h = 1.0f / (float)hidden;

  for (int row = r0 + warp; row < r1; row += kWarps) {
    const T* dyr = dy + (size_t)row * hidden;
    const T* xr = x + (size_t)row * hidden;
    const float m = mu[row];
    const float s = rs[row];
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < hidden; c += 32) {
      float g = apex_to_float(dyr[c]);
      if (w != nullptr) g *= w[c];
      const float xh = (apex_to_float(xr[c]) - m) * s;
      s1 += g;
      s2 += g * xh;
    }
    s1 = apex_warp_sum(s1);
    s2 = apex_warp_sum(s2);
    const float c1 = rms ? 0.0f : s1 * inv_h;
    const float c2 = s2 * inv_h;
    T* dxr = dx + (size_t)row * hidden;
    for (int c = lane; c < hidden; c += 32) {
      float g = apex_to_float(dyr[c]);
      if (w != nullptr) g *= w[c];
      const float xh = (apex_to_float(xr[c]) - m) * s;
      dxr[c] = apex_from_float<T>((g - c1 - xh * c2) * s);
    }
  }

  if (dw_part == nullptr) return;  // no affine parameters
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    float aw = 0.0f, ab = 0.0f;
#pragma unroll 8
    for (int row = r0; row < r1; ++row) {
      const size_t off = (size_t)row * hidden + c;
      const float g = apex_to_float(dy[off]);
      aw += g * ((apex_to_float(x[off]) - mu[row]) * rs[row]);
      ab += g;
    }
    dw_part[(size_t)blockIdx.x * hidden + c] = aw;
    if (db_part != nullptr) db_part[(size_t)blockIdx.x * hidden + c] = ab;
  }
}


// Register path: see the header.  NV 16-byte vectors per lane per row.
constexpr int kMaxVals = 32;  // values a lane holds per row

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_vec_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ mu,
                      const float* __restrict__ rs, T* __restrict__ dx,
                      float* __restrict__ dw_part,
                      float* __restrict__ db_part, int rows, int hidden,
                      int rows_per_block, int rms) {
  constexpr int kVec = 16 / (int)sizeof(T);
  __shared__ float red[kWarps][kMaxVals * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = hidden / kVec;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const float inv_h = 1.0f / (float)hidden;

  float aw[NV][kVec], ab[NV][kVec];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j) aw[i][j] = ab[i][j] = 0.0f;

  for (int row = r0 + warp; row < r1; row += kWarps) {
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + (size_t)row * hidden);
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * hidden);
    const float m = mu[row];
    const float s = rs[row];
    float g[NV][kVec], xh[NV][kVec];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        const uint4 rd = dyr[vi];
        const uint4 rx = xr[vi];
        const T* ed = reinterpret_cast<const T*>(&rd);
        const T* ex = reinterpret_cast<const T*>(&rx);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = apex_to_float(ed[j]);
          const float xv = (apex_to_float(ex[j]) - m) * s;
          aw[i][j] += d * xv;
          ab[i][j] += d;
          const float gv = w != nullptr ? d * w[vi * kVec + j] : d;
          g[i][j] = gv;
          xh[i][j] = xv;
          s1 += gv;
          s2 += gv * xv;
        }
      }
    }
    s1 = apex_warp_sum(s1);
    s2 = apex_warp_sum(s2);
    const float c1 = rms ? 0.0f : s1 * inv_h;
    const float c2 = s2 * inv_h;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * hidden);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        uint4 out;
        T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          eo[j] = apex_from_float<T>((g[i][j] - c1 - xh[i][j] * c2) * s);
        dxr[vi] = out;
      }
    }
  }

  if (dw_part == nullptr) return;  // no affine parameters
  for (int pass = 0; pass < (db_part != nullptr ? 2 : 1); ++pass) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          red[warp][vi * kVec + j] = pass == 0 ? aw[i][j] : ab[i][j];
      }
    }
    __syncthreads();
    float* out = pass == 0 ? dw_part : db_part;
    for (int c = threadIdx.x; c < hidden; c += kThreads) {
      float t = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) t += red[wp][c];
      out[(size_t)blockIdx.x * hidden + c] = t;
    }
    __syncthreads();
  }
}

// out[y][c] = sum over p of part[y][p][c], p in increasing order within
// each of the 8 thread rows, then the 8 row sums in order: a fixed order.
constexpr int kRedCols = 32;
constexpr int kRedRows = 8;

__global__ void __launch_bounds__(kRedCols* kRedRows)
    ln_bwd_reduce_kernel(const float* __restrict__ part,
                         float* __restrict__ out, int nparts, int hidden) {
  __shared__ float acc[kRedRows][kRedCols + 1];
  const int tx = threadIdx.x % kRedCols;
  const int ty = threadIdx.x / kRedCols;
  const int c = blockIdx.x * kRedCols + tx;
  const float* src = part + (size_t)blockIdx.y * nparts * hidden;
  float s = 0.0f;
  if (c < hidden) {
#pragma unroll 4
    for (int p = ty; p < nparts; p += kRedRows) s += src[(size_t)p * hidden + c];
  }
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < hidden) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < kRedRows; ++i) t += acc[i][tx];
    out[(size_t)blockIdx.y * hidden + c] = t;
  }
}

template <typename T, int NV>
void launch_vec(int nblk, cudaStream_t stream, const void* dy, const void* x,
                const void* w, const void* mu, const void* rs, void* dx,
                float* dw_part, float* db_part, int rows, int hidden,
                int rows_per_block, int rms) {
  if constexpr (NV * (16 / (int)sizeof(T)) <= kMaxVals)
    ln_bwd_vec_kernel<T, NV><<<nblk, kThreads, 0, stream>>>(
        (const T*)dy, (const T*)x, (const float*)w, (const float*)mu,
        (const float*)rs, (T*)dx, dw_part, db_part, rows, hidden,
        rows_per_block, rms);
}

// The row pass: the register path when the width allows, else the
// scalar path.
template <typename T>
void launch_rows(int nblk, cudaStream_t stream, const void* dy,
                 const void* x, const void* w, const void* mu,
                 const void* rs, void* dx, float* dw_part, float* db_part,
                 int rows, int hidden, int rows_per_block, int rms) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool aligned =
      (((uintptr_t)dy | (uintptr_t)x | (uintptr_t)dx) % 16) == 0;
  const int nv = (hidden / kVec + 31) / 32;
  if (aligned && hidden % kVec == 0 && nv * kVec <= kMaxVals) {
#define APEX_LN_BWD_VEC(N)                                                \
  case N:                                                                 \
    launch_vec<T, N>(nblk, stream, dy, x, w, mu, rs, dx, dw_part, db_part, \
                     rows, hidden, rows_per_block, rms);                  \
    return;
    switch (nv) {
      APEX_LN_BWD_VEC(1)
      APEX_LN_BWD_VEC(2)
      APEX_LN_BWD_VEC(3)
      APEX_LN_BWD_VEC(4)
      APEX_LN_BWD_VEC(5)
      APEX_LN_BWD_VEC(6)
      APEX_LN_BWD_VEC(7)
      APEX_LN_BWD_VEC(8)
    }
#undef APEX_LN_BWD_VEC
  }
  ln_bwd_kernel<T><<<nblk, kThreads, 0, stream>>>(
      (const T*)dy, (const T*)x, (const float*)w, (const float*)mu,
      (const float*)rs, (T*)dx, dw_part, db_part, rows, hidden,
      rows_per_block, rms);
}

}  // namespace

// dy, x, dx: [rows, hidden] of dtype; w: [hidden] fp32 or NULL; mu, rs:
// [rows] fp32.  With w: part is scratch of [1 + has_bias, nblk, hidden]
// fp32 (nblk = ceil(rows / rows_per_block)) and dwdb receives
// [1 + has_bias, hidden] fp32 (dgamma, then dbeta).  Launches the row pass
// and, with w, the reduction; returns cudaGetLastError().
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* w, const void* mu,
                                   const void* rs, void* dx, void* part,
                                   void* dwdb, int rows, int hidden,
                                   int rows_per_block, int rms, int has_bias,
                                   int dtype, cudaStream_t stream) {
  if (rows <= 0 || hidden <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  if (w != nullptr && (part == nullptr || dwdb == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nblk = (rows + rows_per_block - 1) / rows_per_block;
  float* dw_part = w != nullptr ? (float*)part : nullptr;
  float* db_part =
      (w != nullptr && has_bias) ? (float*)part + (size_t)nblk * hidden
                                 : nullptr;
  APEX_DISPATCH_FLOAT(dtype, T,
                      launch_rows<T>(nblk, stream, dy, x, w, mu, rs, dx,
                                     dw_part, db_part, rows, hidden,
                                     rows_per_block, rms));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || w == nullptr) return (int)err;
  const dim3 grid((hidden + kRedCols - 1) / kRedCols, has_bias ? 2 : 1);
  ln_bwd_reduce_kernel<<<grid, kRedCols * kRedRows, 0, stream>>>(
      (const float*)part, (float*)dwdb, nblk, hidden);
  return (int)cudaGetLastError();
}
