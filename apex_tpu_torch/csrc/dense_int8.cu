// Kernel row 10: the weight-only int8 matmul  y = x @ (wire * scale).
//
// Replaces apex_tpu/ops/dense.py:_dq_kernel (launched by _dq_pallas):
// x [M, K] in the compute dtype, wire [K, N] int8, scale [K/kb, N] fp32
// with one scale per (kb-row block of the contraction axis, column);
// y [M, N] in x's dtype, accumulated in fp32.  The TPU kernel's k grid
// is the quantization blocking: it dots each [kb, N] tile and multiplies
// the partial by the tile's scale row before adding it to the
// accumulator.  This kernel does the same inside one CTA: the partial of
// each k block lives in registers, is scaled per column when the block
// ends, and is added to a second register accumulator.
//
// Bound on the H100: bytes at decode (M = the engine's 32 lanes: the
// whole int8 slab is read for 2*M flops per weight byte), operations at
// prefill (M up to ~1000).  Design, bf16/fp16 activations: |q| <= 127
// is exact in bf16 and fp16, so the int8 tile is widened to the
// activation type in shared memory and multiplied on the tensor cores
// with mma.sync m16n8k16 (fp32 accumulation); products of two 16-bit
// floats are exact in fp32, so this is the TPU kernel's function up to
// summation order.  CTA tile 64 x 64, four warps of 32 x 32, k steps of
// 32.  The accumulator layout of mma.sync is fixed (row groupID and
// groupID + 8, columns 2 * (lane % 4) + {0, 1}), so each thread knows
// the columns it holds and scales them in registers.  Few output tiles
// (decode: M = 32 gives 12-48 tiles for 132 SMs) split the contraction
// axis into whole scale blocks across blockIdx.z; each split writes an
// fp32 partial [M, N] and a second kernel adds the splits in order
// (deterministic, no atomics) and rounds once.  Shapes the tile
// does not take (K or kb not a multiple of 32, N not a multiple of 16)
// and fp32 activations take the CUDA-core path: one CTA per (row,
// 256 columns), the x row staged in shared memory, one column per
// thread, fp32 products summed block by block.
#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32, kPad = 8;
constexpr int kThreads = 128;

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

// 16-bit activations on the tensor cores.  Needs K % kb == 0,
// kb % kBK == 0, N % 16 == 0, x and wire 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wire,
    const float* __restrict__ scale, T* __restrict__ y,
    float* __restrict__ partial, int M, int K, int N, int kb, int splits) {
  __shared__ __align__(16) T sA[kBM][kBK + kPad];   // x tile, k contiguous
  __shared__ __align__(16) T sB[kBN][kBK + kPad];   // weight tile, transposed

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;          // 2 x 2 warps of 32 x 32
  const int grp = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float part[2][4][4], acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[a][b][c] = acc[a][b][c] = 0.0f;

  // this split's whole scale blocks of the contraction axis
  const int nkb = K / kb;
  const int k_lo = (int)((long long)blockIdx.z * nkb / splits) * kb;
  const int k_hi = (int)((long long)(blockIdx.z + 1) * nkb / splits) * kb;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    // x tile: 64 rows x 32 values = 256 16-byte chunks, two per thread
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * kThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + col);
      *reinterpret_cast<uint4*>(&sA[r][col]) = v;
    }
    // weight tile: 32 k rows x 64 columns of int8 = 128 16-byte chunks
    {
      const int r = tid >> 2, col = (tid & 3) * 16;
      alignas(16) int8_t w[16];
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + col < N)
        v = *reinterpret_cast<const uint4*>(wire + (size_t)(k0 + r) * N + n0 + col);
      *reinterpret_cast<uint4*>(w) = v;
#pragma unroll
      for (int u = 0; u < 16; ++u) sB[col + u][r] = from_int8<T>(w[u]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + grp;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&sA[r][kk + tig * 2]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&sA[r + 8][kk + tig * 2]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&sA[r][kk + tig * 2 + 8]);
        af[mt][3] =
            *reinterpret_cast<const uint32_t*>(&sA[r + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + grp;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(&sB[n][kk + tig * 2]);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(&sB[n][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma16816<T>(part[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();

    if ((k0 + kBK) % kb == 0) {   // a scale block ends: scale and add
      const float* srow = scale + (size_t)((k0 + kBK) / kb - 1) * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + tig * 2;
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
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = m0 + wm * 32 + mt * 16 + grp;
      const int n = n0 + wn * 32 + nt * 8 + tig * 2;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = r + (c >= 2 ? 8 : 0), nn = n + (c & 1);
        if (rr < M && nn < N) {
          if (splits == 1)
            y[(size_t)rr * N + nn] = apex_from_float<T>(acc[mt][nt][c]);
          else
            partial[((size_t)blockIdx.z * M + rr) * N + nn] = acc[mt][nt][c];
        }
      }
    }
}

// y = the splits' partials added in split order, rounded once.
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  T* __restrict__ y, size_t mn, int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + e];
  y[e] = apex_from_float<T>(s);
}

// Any dtype and shape on the CUDA cores: CTA (column block, row), the
// x row in shared memory, one output column per thread.
constexpr int kColThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kColThreads) dq_simt_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wire,
    const float* __restrict__ scale, T* __restrict__ y, int M, int K, int N,
    int kb) {
  extern __shared__ float sx[];
  const int row = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += kColThreads)
    sx[k] = apex_to_float(x[(size_t)row * K + k]);
  __syncthreads();
  const int n = blockIdx.x * kColThreads + threadIdx.x;
  if (n >= N) return;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kb) {
    float part = 0.0f;
    for (int k = k0; k < k0 + kb; ++k)
      part += sx[k] * (float)wire[(size_t)k * N + n];
    acc += part * scale[(size_t)(k0 / kb) * N + n];
  }
  y[(size_t)row * N + n] = apex_from_float<T>(acc);
}

template <typename T>
int launch_simt(const void* x, const void* wire, const void* scale, void* y,
                int M, int K, int N, int kb, cudaStream_t stream) {
  const int bytes = K * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((N + kColThreads - 1) / kColThreads, M);
  dq_simt_kernel<T><<<grid, kColThreads, bytes, stream>>>(
      (const T*)x, (const int8_t*)wire, (const float*)scale, (T*)y, M, K, N,
      kb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mma(const void* x, const void* wire, const void* scale, void* y,
               void* partial, int M, int K, int N, int kb, int splits,
               cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  dq_mma_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const int8_t*)wire, (const float*)scale, (T*)y,
      (float*)partial, M, K, N, kb, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  sum_splits_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, (T*)y, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (dtype); wire [K, N] int8; scale [K / kb, N] fp32; y [M, N]
// (dtype); partial [splits, M, N] fp32 scratch (unused, may be NULL, when
// splits == 1).  splits (1 ..= K / kb) applies to the tensor-core path
// (kb % 32 == 0, N % 16 == 0, 16-bit x); the CUDA-core path takes 1.
// Needs K % kb == 0 and K <= 57344 (the x row of the CUDA-core path in
// shared memory).
extern "C" int apex_dense_int8(const void* x, const void* wire,
                               const void* scale, void* y, void* partial,
                               int M, int K, int N, int kb, int splits,
                               int dtype, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || kb <= 0 || K % kb != 0 || K > 57344 ||
      splits < 1 || splits > K / kb || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool tiles = kb % kBK == 0 && N % 16 == 0;
  if (!tiles && splits != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case APEX_BF16:
      return tiles ? launch_mma<__nv_bfloat16>(x, wire, scale, y, partial, M,
                                               K, N, kb, splits, stream)
                   : launch_simt<__nv_bfloat16>(x, wire, scale, y, M, K, N, kb,
                                                stream);
    case APEX_F16:
      return tiles ? launch_mma<__half>(x, wire, scale, y, partial, M, K, N,
                                        kb, splits, stream)
                   : launch_simt<__half>(x, wire, scale, y, M, K, N, kb,
                                         stream);
    case APEX_F32:
      return launch_simt<float>(x, wire, scale, y, M, K, N, kb, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
