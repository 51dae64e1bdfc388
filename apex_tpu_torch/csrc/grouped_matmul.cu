// Kernel row 9: the ragged grouped matmul
//   y[r] = x[r] @ w[g]  for rows r in [offsets[g], offsets[g + 1]),
// rows outside [offsets[0], offsets[G]) exactly zero.
//
// Replaces apex_tpu/ops/grouped_matmul.py:_gmm_kernel (launched by
// _gmm_pallas, its float branch): x [N, K] sorted by group, w [G, K, P],
// offsets [G + 1] int32 non-decreasing, on the device; y [N, P] in x's
// dtype, accumulated in fp32.  The TPU kernel walks a static list of
// (row block, group) steps prepared by the host-side jnp metadata and
// carries one VMEM accumulator across the steps of a block.  Here the
// rows split into G + 2 segments (the rows before offsets[0], the G
// groups' spans, the rows from offsets[G] on), each segment into tiles of
// at most kBM rows of that segment alone, so no tile mixes two groups and
// the work is N*K*P plus at most one partial tile per segment, never
// G*N*K*P.  Every CTA reads the offsets itself and finds its tile by a
// warp scan over the segments' tile counts: no metadata pass, no host read
// of the offsets, so a caller can capture the launch in a CUDA graph.
// The grid is the static bound ceil(N / kBM) + G + 2 tiles; CTAs past the
// real tile count return at once.  The two outer segments' tiles write
// zeros: every element of y is written exactly once, zeros included.
//
// Bound on the H100: bytes.  The LoRA delta runs at rank r = 8: the A
// side (K = 768 or 3072, P = 8) and the B side (K = 8, P = 768..3072) do
// 2 flops per weight element for each row of its group, and a decode
// batch holds one or two rows per group, so the weights of the live
// groups are the bytes.  Design: fp32 FMA on the CUDA cores (the slabs
// are fp32 and the merged-weights oracle is fp32; TF32 would break it),
// 16-bit operands widened to fp32 on load.  A CTA of 256 threads holds a
// tile of up to kBM rows x bn columns (bn = P rounded up to a power of
// two, at most 256); the 256 / bn thread slices split the contraction
// and a fixed-order sum in shared memory adds them (P = 8 gives 32
// slices).  x's rows stage in shared memory kKC columns at a time, k
// major, so a thread reads four rows with one 16-byte load.  When the
// tiles are few and K is long (the A side at decode), the contraction
// also splits across blockIdx.z in whole kKC chunks: each split writes an
// fp32 partial [N, P] and a second kernel adds the splits in order.  No
// atomics: the result does not depend on scheduling.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 16;         // rows of one tile (one segment's)
constexpr int kKC = 256;        // contraction chunk staged in shared memory
constexpr int kXs = kBM + 4;    // padded k row of the staged chunk

// Segment bound i of 0..G+2 before the running max: 0, offsets[0..G]
// clamped into [0, N], N.
__device__ __forceinline__ int raw_bound(const int* __restrict__ off, int G,
                                         int N, int i) {
  if (i <= 0) return 0;
  if (i > G + 1) return N;
  return min(max(off[i - 1], 0), N);
}

// Warp 0: the tile of index t — (segment, first row, rows); rows = 0 when
// t is past the last tile.  Segment bounds are the running max of the
// clamped offsets, so the segments tile [0, N) whatever the offsets hold.
__device__ void find_tile(const int* __restrict__ off, int G, int N, int t,
                          int* s_tile) {
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
    const int excl = incl - nt;
    const unsigned mine = __ballot_sync(full, t >= excl && t < incl);
    if (mine) {
      if (lane == __ffs(mine) - 1) {
        const int row0 = lo + (t - excl) * kBM;
        s_tile[0] = s;
        s_tile[1] = row0;
        s_tile[2] = min(kBM, hi - row0);
      }
      return;
    }
    tiles_before = __shfl_sync(full, incl, 31);
    bound_before = __shfl_sync(full, hi, 31);
  }
  if (lane == 0) s_tile[2] = 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gmm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int* __restrict__ off, T* __restrict__ y,
    float* __restrict__ partial, int N, int K, int P, int G, int bn,
    int splits) {
  __shared__ __align__(16) float xs[kKC][kXs];
  __shared__ float red[kBM][kThreads];
  __shared__ int s_tile[3];

  if (threadIdx.x < 32) find_tile(off, G, N, blockIdx.x, s_tile);
  __syncthreads();
  const int seg = s_tile[0], row0 = s_tile[1], R = s_tile[2];
  if (R <= 0) return;

  const int tid = threadIdx.x;
  const int c = tid % bn, slice = tid / bn, nsl = kThreads / bn;
  const int col = blockIdx.y * bn + c;
  float acc[kBM];
#pragma unroll
  for (int r = 0; r < kBM; ++r) acc[r] = 0.0f;

  // segments 0 and G + 1 lie outside the window: their tiles write zeros
  if (seg >= 1 && seg <= G) {
    const T* __restrict__ wg = w + (size_t)(seg - 1) * K * P;
    const int nch = (K + kKC - 1) / kKC;
    const int ch_lo = (int)((long long)blockIdx.z * nch / splits);
    const int ch_hi = (int)((long long)(blockIdx.z + 1) * nch / splits);
    for (int ch = ch_lo; ch < ch_hi; ++ch) {
      const int k0 = ch * kKC, kc = min(kKC, K - k0);
      for (int e = tid; e < R * kc; e += kThreads) {
        const int r = e / kc, kk = e - r * kc;
        xs[kk][r] = apex_to_float(x[(size_t)(row0 + r) * K + k0 + kk]);
      }
      __syncthreads();
      if (col < P) {
#pragma unroll 4
        for (int kk = slice; kk < kc; kk += nsl) {
          const float wv = apex_to_float(wg[(size_t)(k0 + kk) * P + col]);
#pragma unroll
          for (int r4 = 0; r4 < kBM; r4 += 4) {
            if (r4 < R) {
              const float4 xv = *reinterpret_cast<const float4*>(&xs[kk][r4]);
              acc[r4] = fmaf(xv.x, wv, acc[r4]);
              acc[r4 + 1] = fmaf(xv.y, wv, acc[r4 + 1]);
              acc[r4 + 2] = fmaf(xv.z, wv, acc[r4 + 2]);
              acc[r4 + 3] = fmaf(xv.w, wv, acc[r4 + 3]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  float* __restrict__ part =
      splits > 1 ? partial + (size_t)blockIdx.z * N * P : nullptr;
  auto store = [&](int r, int cl, float v) {
    const size_t i = (size_t)(row0 + r) * P + cl;
    if (part)
      part[i] = v;
    else
      y[i] = apex_from_float<T>(v);
  };
  if (nsl == 1) {
    if (col < P) {
#pragma unroll
      for (int r = 0; r < kBM; ++r)
        if (r < R) store(r, col, acc[r]);
    }
    return;
  }
  // the contraction slices' sums, added in slice order
#pragma unroll
  for (int r = 0; r < kBM; ++r)
    if (r < R) red[r][tid] = acc[r];
  __syncthreads();
  for (int e = tid; e < R * bn; e += kThreads) {
    const int r = e / bn, cc = e - r * bn;
    const int cl = blockIdx.y * bn + cc;
    if (cl >= P) continue;
    float s = 0.0f;
    for (int z = 0; z < nsl; ++z) s += red[r][z * bn + cc];
    store(r, cl, s);
  }
}

// y = the splits' partials added in split order, rounded once.
template <typename T>
__global__ void gmm_sum_splits_kernel(const float* __restrict__ partial,
                                      T* __restrict__ y, size_t np,
                                      int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= np) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * np + e];
  y[e] = apex_from_float<T>(s);
}

int column_tile(int P) {
  int bn = 1;
  while (bn < P && bn < kThreads) bn <<= 1;
  return bn;
}

template <typename T>
int launch(const void* x, const void* w, const void* off, void* y,
           void* partial, int N, int K, int P, int G, int splits,
           cudaStream_t stream) {
  const int bn = column_tile(P);
  dim3 grid((N + kBM - 1) / kBM + G + 2, (P + bn - 1) / bn, splits);
  gmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (const int*)off, (T*)y, (float*)partial, N, K,
      P, G, bn, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t np = (size_t)N * P;
  gmm_sum_splits_kernel<T><<<(unsigned)((np + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, (T*)y, np, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, K], w [G, K, P] and y [N, P] of one dtype; offsets [G + 1] int32
// on the device; partial [splits, N, P] fp32 scratch (NULL when splits is
// 1).  splits (1 ..= ceil(K / 256), 1 when K is 0) cuts the contraction
// into whole 256-wide chunks across CTAs.
extern "C" int apex_grouped_matmul(const void* x, const void* w,
                                   const void* offsets, void* y,
                                   void* partial, int N, int K, int P, int G,
                                   int splits, int dtype,
                                   cudaStream_t stream) {
  const int nch = (K + kKC - 1) / kKC;
  if (N <= 0 || K < 0 || P <= 0 || G < 0 || splits < 1 ||
      splits > (nch > 1 ? nch : 1) || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    return launch<T>(x, w, offsets, y, partial, N, K, P, G, splits, stream);
  });
  return (int)cudaErrorInvalidValue;
}
