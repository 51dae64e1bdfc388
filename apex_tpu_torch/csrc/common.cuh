// Shared helpers of the port's kernels: element types behind an integer
// code (the Python wrappers pass it), float loads/stores, and the
// round-trip through a 16-bit type that replays a framework's cast.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with apex_tpu_torch/ops/_kernel_utils.py DTYPE_CODES
enum ApexDtype : int { APEX_F32 = 0, APEX_BF16 = 1, APEX_F16 = 2 };

__device__ __forceinline__ float apex_to_float(float v) { return v; }
__device__ __forceinline__ float apex_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float apex_to_float(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T apex_from_float(float v);
template <>
__device__ __forceinline__ float apex_from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 apex_from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half apex_from_float<__half>(float v) {
  return __float2half_rn(v);
}

// x rounded to T and widened back: the value a framework sees after
// casting an fp32 intermediate to the compute dtype and back.
template <typename T>
__device__ __forceinline__ float apex_round(float x) {
  return apex_to_float(apex_from_float<T>(x));
}

__device__ __forceinline__ float apex_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float apex_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Runs the statements with T bound to the element type named by code;
// returns cudaErrorInvalidValue for an unknown code.
#define APEX_DISPATCH_FLOAT(code, T, ...)            \
  switch (code) {                                    \
    case APEX_F32: {                                 \
      using T = float;                               \
      __VA_ARGS__;                                   \
      break;                                         \
    }                                                \
    case APEX_BF16: {                                \
      using T = __nv_bfloat16;                       \
      __VA_ARGS__;                                   \
      break;                                         \
    }                                                \
    case APEX_F16: {                                 \
      using T = __half;                              \
      __VA_ARGS__;                                   \
      break;                                         \
    }                                                \
    default:                                         \
      return (int)cudaErrorInvalidValue;             \
  }

#define APEX_NEG_INF (-1e30f)

// What the runtime reports of one kernel launched with `threads` threads
// and no dynamic shared memory: out = {registers per thread, static
// shared memory per CTA, resident CTAs per SM, local (spill) bytes per
// thread}.  Returns a cudaError_t.
template <typename Kern>
inline int apex_kernel_attrs(Kern kern, int threads, int* out) {
  cudaFuncAttributes a;
  int ctas = 0;
  int err = (int)cudaFuncGetAttributes(&a, kern);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern,
                                                             threads, 0);
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = ctas;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

// 2^x on the special-function unit (ex2.approx.ftz: ~2 ulp, subnormal
// results flushed to 0)
__device__ __forceinline__ float apex_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
