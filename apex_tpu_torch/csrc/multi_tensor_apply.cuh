// The tensor table and chunk walk of the multi-tensor kernels
// (csrc/multi_tensor.cu), after the reference's csrc/multi_tensor_apply.cuh.
//
// The reference packs up to 110 tensor pointers and 320 block-to-chunk
// entries into a kernel parameter of about 4 KB and launches again when
// either fills.  Since CUDA 12.1 a kernel's parameters may take 32,764
// bytes, so here one launch carries kMaxTensors tensors, every chunk of
// them: Table<NL> holds, for each tensor, NL pointers (one per list:
// grads, params, moments, outputs), their element-type codes, the element
// count and the first chunk.  A longer list launches again for each
// further kMaxTensors tensors (the wrapper groups it), so a call is
// ceil(n / kMaxTensors) launches of each kernel; the stacked trees of the
// repo's train steps take one.  The table lives in the kernel's parameter
// space (__grid_constant__), is read there with indexed constant loads,
// and is captured with the launch by a CUDA graph (a device table would
// need a host-to-device copy each call, which a capture refuses).
//
// A CTA takes one chunk of kChunk elements of one tensor: it finds the
// tensor by a binary search over `start`, then its threads walk the chunk
// in 4-element vectors (16 bytes of fp32, 8 of a 16-bit type) when every
// pointer of the tensor is 16-byte aligned, else element by element.  Each
// thread visits its elements in a fixed order and a CTA reduces in a fixed
// order, so a sum over a chunk is the same bits on every run; sums across
// chunks are left to a second, ordered pass (no atomics).
#pragma once

#include "common.cuh"

namespace mt {

constexpr int kChunk = 65536;       // elements a CTA takes (2048 * 32)
constexpr int kThreads = 512;
constexpr int kMaxTensors = 320;    // Table<9> is 30,096 bytes

template <int NL>
struct Table {
  int n;                              // tensors
  int chunks;                         // chunks of all tensors
  int start[kMaxTensors + 1];         // tensor t owns chunks [start[t], start[t+1])
  long long numel[kMaxTensors];
  void* ptr[NL][kMaxTensors];         // NULL: the list has no tensor here
  unsigned char code[NL][kMaxTensors];  // ApexDtype of each pointer
  unsigned char vec[kMaxTensors];     // every pointer of t 16-byte aligned
};

// the tensor that owns `chunk`: the largest t with start[t] <= chunk
// (an empty tensor shares its start with the next one and is skipped)
template <int NL>
__device__ __forceinline__ int find_tensor(const Table<NL>& tab, int chunk) {
  int lo = 0, hi = tab.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.start[mid] <= chunk) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float bits16_to_float(unsigned short h, int code) {
  return code == APEX_BF16 ? __uint_as_float((unsigned)h << 16)
                           : __half2float(__ushort_as_half(h));
}

__device__ __forceinline__ unsigned short float_to_bits16(float x, int code) {
  return code == APEX_BF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(x))
                           : __half_as_ushort(__float2half_rn(x));
}

// W elements of p (element type `code`) from index i, widened to fp32;
// W == 4 is one vector load (i a multiple of 4, p 16-byte aligned)
template <int W>
__device__ __forceinline__ void load(const void* p, int code, long long i,
                                     float* v) {
  if (W == 4) {
    if (code == APEX_F32) {
      const float4 x = *reinterpret_cast<const float4*>(
          static_cast<const float*>(p) + i);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(
          static_cast<const unsigned short*>(p) + i);
      v[0] = bits16_to_float(x.x & 0xffffu, code);
      v[1] = bits16_to_float(x.x >> 16, code);
      v[2] = bits16_to_float(x.y & 0xffffu, code);
      v[3] = bits16_to_float(x.y >> 16, code);
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k)
      v[k] = code == APEX_F32
                 ? static_cast<const float*>(p)[i + k]
                 : bits16_to_float(
                       static_cast<const unsigned short*>(p)[i + k], code);
  }
}

// W fp32 values rounded to `code` and stored at p[i..i+W)
template <int W>
__device__ __forceinline__ void store(void* p, int code, long long i,
                                      const float* v) {
  if (W == 4) {
    if (code == APEX_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 x;
      x.x = float_to_bits16(v[0], code) |
            ((unsigned)float_to_bits16(v[1], code) << 16);
      x.y = float_to_bits16(v[2], code) |
            ((unsigned)float_to_bits16(v[3], code) << 16);
      *reinterpret_cast<uint2*>(static_cast<unsigned short*>(p) + i) = x;
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (code == APEX_F32) static_cast<float*>(p)[i + k] = v[k];
      else static_cast<unsigned short*>(p)[i + k] = float_to_bits16(v[k], code);
    }
  }
}

// x rounded to `code` and widened back (the value a tensor of that type holds)
__device__ __forceinline__ float round_to(float x, int code) {
  return code == APEX_F32 ? x : bits16_to_float(float_to_bits16(x, code), code);
}

__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.402823466e38f;   // false for inf and nan
}

// Walks this CTA's share of elements [c0, c1) of one tensor: op.apply<4>(i)
// on aligned 4-element vectors, op.apply<1>(i) on the rest.  A thread's
// elements come in a fixed order.
template <class Op>
__device__ __forceinline__ void for_chunk(Op& op, long long c0, long long c1,
                                          bool vec) {
  long long v1 = c0;
  if (vec) {
    v1 = c0 + (c1 - c0) / 4 * 4;
    for (long long i = c0 + 4LL * threadIdx.x; i < v1;
         i += 4LL * blockDim.x)
      op.template apply<4>(i);
  }
  for (long long i = v1 + threadIdx.x; i < c1; i += blockDim.x)
    op.template apply<1>(i);
}

// Sum of v over the CTA in a fixed order (butterfly in each warp, then the
// warps in order by thread 0); the result is valid in thread 0.  `red`
// holds 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = apex_warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

}  // namespace mt
