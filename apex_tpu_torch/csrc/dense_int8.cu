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
// 32 (the tile of csrc/mma_tile.cuh, shared with row 9).  The accumulator layout of mma.sync is fixed (row groupID and
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
#include "mma_tile.cuh"

namespace {

constexpr int kBM = kTileM, kBN = kTileN, kBK = kTileK;
constexpr int kThreads = kTileThreads;

// 16-bit activations on the tensor cores (the tile of csrc/mma_tile.cuh).
// Needs K % kb == 0, kb % kBK == 0, N % 16 == 0, x and wire 16-byte
// aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wire,
    const float* __restrict__ scale, T* __restrict__ y,
    float* __restrict__ partial, int M, int K, int N, int kb, int splits) {
  __shared__ __align__(16) MmaSmemKN<T> s;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = min(kBM, M - m0);

  MmaFrag part, acc;
  mma_zero(part);
  mma_zero(acc);

  // this split's whole scale blocks of the contraction axis
  const int nkb = K / kb;
  const int k_lo = (int)((long long)blockIdx.z * nkb / splits) * kb;
  const int k_hi = (int)((long long)(blockIdx.z + 1) * nkb / splits) * kb;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    mma_stage_a(s, x, K, m0, rows, k0);
    mma_stage_b_int8(s, wire, K, N, k0, n0);
    __syncthreads();
    mma_tile_step(s, part);
    __syncthreads();
    if ((k0 + kBK) % kb == 0)   // a scale block ends: scale and add
      mma_scale_add(acc, part, scale + (size_t)((k0 + kBK) / kb - 1) * N, n0,
                    N);
  }

  if (splits == 1)
    mma_store(acc, y, N, m0, rows, n0, N);
  else
    mma_store(acc, partial + (size_t)blockIdx.z * M * N, N, m0, rows, n0, N);
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
