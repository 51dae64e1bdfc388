// Kernel row 9: the ragged grouped matmul
//   y[r] = x[r] @ w[g]  for rows r in [offsets[g], offsets[g + 1]),
// rows outside [offsets[0], offsets[G]) exactly zero.
//
// Replaces apex_tpu/ops/grouped_matmul.py:_gmm_kernel (launched by
// _gmm_pallas): x [N, K] sorted by group, w [G, K, P], offsets [G + 1]
// int32 non-decreasing, on the device; y [N, P], accumulated in fp32.
// The TPU kernel walks a static list of (row block, group) steps
// prepared by the host-side jnp metadata and carries one VMEM
// accumulator across the steps of a block.  Here the rows split into
// G + 2 segments (the rows before offsets[0], the G groups' spans, the
// rows from offsets[G] on), each segment into tiles of rows of that
// segment alone, so no tile mixes two groups and the work is N*K*P plus
// at most one partial tile per segment, never G*N*K*P.  Every CTA reads
// the offsets itself and finds its tile by a warp scan over the
// segments' tile counts: no metadata pass, no host read of the offsets,
// so a caller can capture the launch in a CUDA graph.  The grid is the
// static bound ceil(N / tile rows) + G + 2 tiles; CTAs past the real
// tile count return at once.  The two outer segments' tiles write zeros:
// every element of y is written exactly once, zeros included.
//
// Four branches, one entry point each:
//
// * apex_grouped_matmul, the fp32 branch (LoRA's slabs; also 16-bit
//   operands of shapes the tensor-core tile does not take, and more than
//   2048 groups).  Bound on the H100: bytes.  The LoRA delta runs at rank
//   r = 8: the A side (K = 768 or 3072, P = 8) and the B side (K = 8, P =
//   768..3072) do 2 flops per weight element for each row of its group,
//   and a decode batch holds one or two rows per group, so the weights of
//   the live groups are the bytes; at ~0.35 us of bytes a call the kernel
//   is bound by latency.  Design: fp32 FMA on the CUDA cores (the slabs
//   are fp32 and the merged-weights oracle is fp32; TF32 would break it),
//   16-bit operands widened to fp32 on load.  A CTA of 256 threads holds a
//   tile of up to BM rows (4, a decode batch's one or two rows per group,
//   or 16 for the B side of a prefill) x bn columns (bn = P rounded up to
//   a power of two, at most 256); the 256 / bn thread slices split the
//   contraction; x's rows are staged in shared memory, k major, 1024 or
//   256 k rows at a time, and a thread keeps 8 weight loads in flight.  The slices are added in a
//   fixed order: across the lanes of a warp by shuffles, then across warps
//   in shared memory.  When the tiles are few and K is long (the A side at
//   decode) the contraction also splits across the CTAs of one
//   thread-block cluster (up to 8), whose partials are added in rank order
//   through distributed shared memory: one launch, no partial in device
//   memory, no atomics, so the result does not depend on scheduling.
//
// * apex_grouped_matmul_mma, the 16-bit branch (the MoE experts: bf16 x
//   and w, y in their dtype).  Bound on the H100: at the ragged MoE step
//   (N = 4096, K = 768, P = 3072, G = 8, or the transpose) bytes and
//   operations are within 10% of each other (~0.02 ms a call).  Design:
//   the Hopper GEMM of sm90_gemm.cuh (persistent CTAs, a TMA ring fed by
//   one producer warp, two consumer warpgroups issuing wgmma m64n128k16
//   from shared memory into fp32 registers) over tiles of 128 rows of one
//   segment; the rows of a partial tile outside the segment are computed
//   and dropped at the store.  The TPU kernel widens both operands to
//   fp32 before its dot; a product of two 16-bit floats is exact in fp32,
//   so this is its function up to summation order.  trans = 0 reads w[g]
//   [K, P] as an MN-major B; trans = 1 reads w as [G, P, K] (each group's
//   weight transposed in place, k contiguous), a K-major B: dx = g @
//   w[g]^T of the backward without a transposed copy.  Needs K % 8 == 0,
//   P % 8 == 0 and 16-byte-aligned x and w (TMA's row strides).
//
// * apex_grouped_matmul_int8, the int8-slab branch (quantized MoE
//   experts; _gmm_kernel with quant=True): wire [G, K, P] int8 and scale
//   [G, K / kb, P] fp32, one scale per (kb-row block, column), read
//   through the tile's group as the TPU kernel's BlockSpec reads both
//   through its step's group.  The same GEMM, with each int8 tile widened
//   to x's 16-bit type in shared memory by the producer warpgroup (exact:
//   |q| <= 127) and each k block's fp32 partial multiplied by its scale
//   row in registers before it joins the accumulator, as row 10 does; y in
//   x's dtype.  Needs 16-bit x, K % kb == 0, kb % 32 == 0, P % 16 == 0.
//
// * apex_grouped_matmul_int8_simt, the int8 slab where the GEMM's tile
//   does not take it (fp32 x, a scale block that is not a multiple of 32,
//   P not a multiple of 16, more than 2048 groups): the fp32 branch's
//   kernel reading the int8 wire, each weight widened and multiplied by
//   its (kb-row block, column) scale in registers as it is loaded, which
//   is _dequantize_group's fp32 weight, bit for bit, with no fp32 copy of
//   the slab in device memory; y in x's dtype.  Bound: bytes (the int8
//   weights of the live groups).
#include <cooperative_groups.h>

#include <type_traits>

#include "sm90_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSplits = 8;  // the portable cluster size

// Warp 0: the tile of index t, tiles of at most bm rows — (segment,
// first row, rows); rows = 0 when t is past the last tile.  Segment
// bounds are the running max of the clamped offsets, so the segments
// tile [0, N) whatever the offsets hold.
__device__ void find_tile(const int* __restrict__ off, int G, int N, int t,
                          int bm, int* s_tile) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int nseg = G + 2;
  int tiles_before = 0, bound_before = 0;
  for (int base = 0; base < nseg; base += 32) {
    const int s = base + lane;
    int lo = s < nseg ? gemm::raw_bound(off, G, N, s) : N;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(full, lo, o);
      if (lane >= o) lo = max(lo, v);
    }
    lo = max(lo, bound_before);
    const int hi =
        s < nseg ? max(lo, gemm::raw_bound(off, G, N, s + 1)) : N;
    const int nt = s < nseg ? (hi - lo + bm - 1) / bm : 0;
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
        const int row0 = lo + (t - excl) * bm;
        s_tile[0] = s;
        s_tile[1] = row0;
        s_tile[2] = min(bm, hi - row0);
      }
      return;
    }
    tiles_before = __shfl_sync(full, incl, 31);
    bound_before = __shfl_sync(full, hi, 31);
  }
  if (lane == 0) s_tile[2] = 0;
}

// A weight element as fp32: a float type widened, an int8 as its integer.
template <typename W>
__device__ __forceinline__ float weight_to_float(W v) {
  return apex_to_float(v);
}
template <>
__device__ __forceinline__ float weight_to_float<int8_t>(int8_t v) {
  return (float)v;
}

// W = T: y = x @ w.  W = int8_t: y = x @ (wire * scale), scale [G, K / kb,
// P] fp32 (the int8_simt entry).
template <typename T, typename W, int BM>
__global__ void __launch_bounds__(kThreads) gmm_kernel(
    const T* __restrict__ x, const W* __restrict__ w,
    const float* __restrict__ scale, int kb, const int* __restrict__ off,
    T* __restrict__ y, int N, int K, int P, int G, int bn) {
  constexpr bool kQuant = std::is_same<W, int8_t>::value;
  constexpr int KC = BM == 4 ? 1024 : 256;  // contraction rows staged
  constexpr int XS = BM == 4 ? 4 : BM + 4;   // padded k row of the chunk
  __shared__ __align__(16) float xs[KC][XS];
  __shared__ float red[BM][kThreads];
  __shared__ int s_tile[3];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();

  // every rank of a cluster finds the same tile, so all or none return
  if (threadIdx.x < 32) find_tile(off, G, N, blockIdx.x / splits, BM, s_tile);
  __syncthreads();
  const int seg = s_tile[0], row0 = s_tile[1], R = s_tile[2];
  if (R <= 0) return;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % bn, slice = tid / bn, nsl = kThreads / bn;
  const int col = blockIdx.y * bn + c;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.0f;

  // segments 0 and G + 1 lie outside the window: their tiles write zeros
  if (seg >= 1 && seg <= G) {
    const W* __restrict__ wg = w + (size_t)(seg - 1) * K * P;
    const float* __restrict__ sg =
        kQuant ? scale + (size_t)(seg - 1) * (K / kb) * P : nullptr;
    const int k_lo = (int)((long long)rank * K / splits);
    const int k_hi = (int)((long long)(rank + 1) * K / splits);
    for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
      const int kc = min(KC, k_hi - k0);
#pragma unroll 4
      for (int e = tid; e < R * kc; e += kThreads) {
        const int r = e / kc, kk = e - r * kc;
        xs[kk][r] = apex_to_float(x[(size_t)(row0 + r) * K + k0 + kk]);
      }
      __syncthreads();
      if (col < P) {
        // unrolled so that eight weight loads are in flight at once
#pragma unroll 8
        for (int kk = slice; kk < kc; kk += nsl) {
          float wv = weight_to_float(wg[(size_t)(k0 + kk) * P + col]);
          if constexpr (kQuant) wv *= sg[(size_t)((k0 + kk) / kb) * P + col];
#pragma unroll
          for (int r4 = 0; r4 < BM; r4 += 4) {
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

  if (nsl == 1 && splits == 1) {  // one slice, one CTA: the sums are done
    if (col < P) {
#pragma unroll
      for (int r = 0; r < BM; ++r)
        if (r < R) y[(size_t)(row0 + r) * P + col] = apex_from_float<T>(acc[r]);
    }
    return;
  }
  // the contraction slices, added in a fixed order: a warp's lanes of one
  // column by a shuffle tree (bn < 32), then the warps' or slices' sums
  // in index order; the CTA's partial lands in red[r][column]
  int nes = nsl, es = slice;
  bool writer = true;
  if (bn < 32) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
      for (int o = bn; o < 32; o <<= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    nes = kThreads / 32;
    es = warp;
    writer = lane < bn;
  }
  if (writer) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
      if (r < R) red[r][es * bn + c] = acc[r];
  }
  __syncthreads();
  const int E = R * bn;
  for (int e = tid; e < E; e += kThreads) {
    const int r = e / bn, cc = e - r * bn;
    float s = 0.0f;
    for (int z = 0; z < nes; ++z) s += red[r][z * bn + cc];
    const int cl = blockIdx.y * bn + cc;
    if (splits == 1) {
      if (cl < P) y[(size_t)(row0 + r) * P + cl] = apex_from_float<T>(s);
    } else {
      red[r][cc] = s;  // read before by this thread alone
    }
  }
  if (splits == 1) return;
  // the cluster's partials, added in rank order; each rank stores its
  // share of the tile
  cluster.sync();
  const int e_hi = (rank + 1) * E / splits;
  for (int e = rank * E / splits + tid; e < e_hi; e += kThreads) {
    const int r = e / bn, cc = e - r * bn;
    const int cl = blockIdx.y * bn + cc;
    if (cl >= P) continue;
    float s = 0.0f;
    for (int j = 0; j < splits; ++j)
      s += cluster.map_shared_rank(&red[0][0], j)[r * kThreads + cc];
    y[(size_t)(row0 + r) * P + cl] = apex_from_float<T>(s);
  }
  cluster.sync();  // no CTA leaves while a peer reads its partial
}

int column_tile(int P) {
  int bn = 1;
  while (bn < P && bn < kThreads) bn <<= 1;
  return bn;
}

template <typename T, typename W, int BM>
int launch(const void* x, const void* w, const void* scale, int kb,
           const void* off, void* y, int N, int K, int P, int G, int splits,
           cudaStream_t stream) {
  const int bn = column_tile(P);
  const long long tiles = (N + BM - 1) / BM + (long long)G + 2;
  if (tiles * splits > 0x7fffffffLL || (P + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * splits), (P + bn - 1) / bn, 1);
  if (splits == 1) {  // no cluster to launch: a plain launch starts sooner
    gmm_kernel<T, W, BM><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const W*)w, (const float*)scale, kb, (const int*)off,
        (T*)y, N, K, P, G, bn);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const T* xp = (const T*)x;
  const W* wp = (const W*)w;
  const float* sp = (const float*)scale;
  const int* op = (const int*)off;
  T* yp = (T*)y;
  int bnv = bn;
  void* args[] = {&xp, &wp, &sp, &kb, &op, &yp, &N, &K, &P, &G, &bnv};
  int err = (int)cudaLaunchKernelExC(
      &cfg, (const void*)gmm_kernel<T, W, BM>, args);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, K], w [G, K, P] and y [N, P] of one dtype; offsets [G + 1] int32
// on the device.  rows (4 or 16) is the row tile; splits (1 ..= 8, at
// most max(K, 1)) the CTAs of one cluster that share the contraction.
extern "C" int apex_grouped_matmul(const void* x, const void* w,
                                   const void* offsets, void* y, int N,
                                   int K, int P, int G, int splits, int rows,
                                   int dtype, cudaStream_t stream) {
  if (N <= 0 || K < 0 || P <= 0 || G < 0 || splits < 1 ||
      splits > kMaxSplits || splits > (K > 1 ? K : 1) ||
      (rows != 4 && rows != 16))
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    return rows == 4 ? launch<T, T, 4>(x, w, nullptr, 1, offsets, y, N, K, P,
                                       G, splits, stream)
                     : launch<T, T, 16>(x, w, nullptr, 1, offsets, y, N, K,
                                        P, G, splits, stream);
  });
  return (int)cudaErrorInvalidValue;
}

// x [N, K] and y [N, P] of dtype (fp32, bf16 or fp16); wire [G, K, P]
// int8; scale [G, K / kb, P] fp32; offsets [G + 1] int32 on the device.
// rows and splits as apex_grouped_matmul's; any kb dividing K, any P, any
// G.
extern "C" int apex_grouped_matmul_int8_simt(const void* x, const void* wire,
                                             const void* scale,
                                             const void* offsets, void* y,
                                             int N, int K, int P, int G,
                                             int kb, int splits, int rows,
                                             int dtype, cudaStream_t stream) {
  if (N <= 0 || K < 0 || P <= 0 || G < 0 || kb <= 0 || K % kb != 0 ||
      splits < 1 || splits > kMaxSplits || splits > (K > 1 ? K : 1) ||
      (rows != 4 && rows != 16))
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    return rows == 4 ? launch<T, int8_t, 4>(x, wire, scale, kb, offsets, y, N,
                                            K, P, G, splits, stream)
                     : launch<T, int8_t, 16>(x, wire, scale, kb, offsets, y,
                                             N, K, P, G, splits, stream);
  });
  return (int)cudaErrorInvalidValue;
}

// x [N, K] and y [N, P] bf16 or fp16, w [G, K, P] (trans = 0) or
// [G, P, K] (trans = 1) of the same dtype, offsets [G + 1] int32 on the
// device, G <= 2048; tiles of 128 columns, or 256 with wide = 1.  Needs
// K % 8 == 0, P % 8 == 0 and 16-byte-aligned x and w.
extern "C" int apex_grouped_matmul_mma(const void* x, const void* w,
                                       const void* offsets, void* y, int N,
                                       int K, int P, int G, int trans,
                                       int wide, int dtype,
                                       cudaStream_t stream) {
  if (N <= 0 || K < 0 || P <= 0 || G < 0 || K % 8 != 0 || P % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int mode = wide ? (trans ? gemm::kTransWide : gemm::kFwdWide)
                        : (trans ? gemm::kTrans : gemm::kFwd);
#define APEX_GMM_LAUNCH(T, MODE)                                            \
  case MODE:                                                                \
    return gemm::launch<T, MODE>(x, w, nullptr, offsets, y, N, K, P, G, 0, \
                                 stream);
  if (dtype == APEX_BF16) {
    switch (mode) {
      APEX_GMM_LAUNCH(__nv_bfloat16, gemm::kFwd)
      APEX_GMM_LAUNCH(__nv_bfloat16, gemm::kTrans)
      APEX_GMM_LAUNCH(__nv_bfloat16, gemm::kFwdWide)
      APEX_GMM_LAUNCH(__nv_bfloat16, gemm::kTransWide)
    }
  } else if (dtype == APEX_F16) {
    switch (mode) {
      APEX_GMM_LAUNCH(__half, gemm::kFwd)
      APEX_GMM_LAUNCH(__half, gemm::kTrans)
      APEX_GMM_LAUNCH(__half, gemm::kFwdWide)
      APEX_GMM_LAUNCH(__half, gemm::kTransWide)
    }
  }
#undef APEX_GMM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// x [N, K] and y [N, P] bf16 or fp16; wire [G, K, P] int8; scale
// [G, K / kb, P] fp32; offsets [G + 1] int32 on the device, G <= 2048;
// tiles of 64 columns with narrow = 1 (when kb % 64 == 0), else 128.
// Needs K % kb == 0, kb % 32 == 0, P % 16 == 0 and 16-byte-aligned x and
// wire.
extern "C" int apex_grouped_matmul_int8(const void* x, const void* wire,
                                        const void* scale,
                                        const void* offsets, void* y, int N,
                                        int K, int P, int G, int kb,
                                        int narrow, int dtype,
                                        cudaStream_t stream) {
  if (N <= 0 || K < 0 || P <= 0 || G < 0 || kb <= 0 || kb % 32 != 0 ||
      K % kb != 0 || P % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == APEX_BF16)
    return gemm::launch_int8<__nv_bfloat16>(x, wire, scale, offsets, y, N, K,
                                            P, G, kb, narrow, stream);
  if (dtype == APEX_F16)
    return gemm::launch_int8<__half>(x, wire, scale, offsets, y, N, K, P, G,
                                     kb, narrow, stream);
  return (int)cudaErrorInvalidValue;
}

// {registers, shared memory per CTA, CTAs per SM, spill bytes} of the
// tensor-core branches' kernels (gemm::Mode: 0 forward, 1 transposed
// read, 2 int8 slab in stages of 64 k rows, 3 of 32, 4 and 5 the 16-bit
// ones at 256 columns, 6 the int8 slab at 64 columns).
extern "C" int apex_grouped_matmul_attrs(int mode, int dtype, int* out) {
  const bool bf = dtype == APEX_BF16;
  if (!bf && dtype != APEX_F16) return (int)cudaErrorInvalidValue;
#define APEX_GMM_ATTRS(MODE)                                  \
  case MODE:                                                  \
    return bf ? gemm::attrs<__nv_bfloat16, MODE>(out)         \
              : gemm::attrs<__half, MODE>(out);
  switch (mode) {
    APEX_GMM_ATTRS(gemm::kFwd)
    APEX_GMM_ATTRS(gemm::kTrans)
    APEX_GMM_ATTRS(gemm::kInt8)
    APEX_GMM_ATTRS(gemm::kInt8K32)
    APEX_GMM_ATTRS(gemm::kFwdWide)
    APEX_GMM_ATTRS(gemm::kTransWide)
    APEX_GMM_ATTRS(gemm::kInt8N64)
  }
#undef APEX_GMM_ATTRS
  return (int)cudaErrorInvalidValue;
}

// {registers, shared memory per CTA, CTAs per SM, spill bytes} of the
// fp32 branch's kernel at row tile `rows` (4 or 16) for dtype.
extern "C" int apex_grouped_matmul_fp32_attrs(int rows, int dtype, int* out) {
  if (rows != 4 && rows != 16) return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    return rows == 4
               ? sm90::kernel_attrs(gmm_kernel<T, T, 4>, 0, kThreads, out)
               : sm90::kernel_attrs(gmm_kernel<T, T, 16>, 0, kThreads, out);
  });
  return (int)cudaErrorInvalidValue;
}
