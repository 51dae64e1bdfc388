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
