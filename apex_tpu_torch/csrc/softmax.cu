// Row 11: the scaled / masked / causal softmax forward.
//
// Replaces apex_tpu/ops/softmax.py:_softmax_kernel (launched by
// _softmax_fwd_pallas).  x is viewed as rows x sk with rows = d0*d1*sq;
// each row is
//   v_c = x_c * scale, then -10000 where mask[i0, i1, i2, c] or, when
//         causal, where c > i2 (i2 = row % sq, the query position),
//   y_c = exp(v_c - max v) / sum exp(v - max v),
// with fp32 math whatever the element type, and y = 0 on a row whose max
// is <= -10000 when a mask or the causal triangle applies (the
// reference kernels' scale_value = 0 on fully masked rows).  y has x's
// type.
//
// Routing.  The JAX package takes the Pallas kernel only for a mask of
// x's full shape, sk <= 512 and outside differentiation (softmax.py:148-
// 192): those rules were v5e VMEM and XLA-fusion measurements.  Here the
// mask is read through its own strides (a [b,1,1,sk] or [b,1,sq,sk]
// mask broadcast at no cost), a row of any length is handled, and the
// wrapper launches this kernel for every CUDA call of the four softmax
// functions; the backward is a torch composition.  The math is the same
// on every route.
//
// Bound on the H100 at [8,16,512,512] fp32 with a [8,1,1,512] mask:
// bytes (x read once, y written once: 268 MB, ~0.08 ms at 3.35 TB/s;
// ~5 flops per element).  The Pallas kernel holds a block of whole rows
// in VMEM and reads each element once; the Hopper design does the same
// in registers:
// - softmax_row_kernel (rows that fit: sk <= 1024 fp32 or 2048 16-bit,
//   16-byte aligned): a group of LANES lanes (8, 16 or 32) takes a row,
//   each lane NV 16-byte vectors of it.  All of a row's mask and x loads
//   are issued before the first reduction; max and sum are group
//   shuffles; one exp2 per element (log2 e folded into one FFMA), one
//   reciprocal per row, 16-byte stores.  x is read once and y written
//   once.
// - The mask is read in vectors (4 or 8 bytes covering a lane's 4 or 8
//   elements) when its last stride is 1 and the row is aligned;
//   otherwise element by element through its strides.
// - A vector whose elements are all masked or past the diagonal is not
//   read: its value is the fill whatever x holds.  A fully masked row
//   reads no x and writes zeros.
// - softmax_loop_kernel (longer or unaligned rows): one warp per row, an
//   online max and sum over 16-byte vectors where alignment allows (one
//   element at a time otherwise), then a second pass that writes y.
// The wrapper (ops/softmax.py softmax_plan) picks the kernel and its
// LANES x NV from sk, the element size and the alignment; this file
// only checks that the choice fits.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kFill = -10000.0f;
constexpr float kLog2e = 1.4426950408889634f;

// how the mask is read (ops/softmax.py MASK_* codes)
enum MaskMode : int { kNoMask = 0, kMaskVec = 1, kMaskStrided = 2 };

// Bit j set when element c0 + j of the row is masked (mr: the row's mask).
template <int VEC, int MASK>
__device__ __forceinline__ unsigned mask_bits(const unsigned char* mr,
                                              int c0, long long ms3) {
  unsigned bits = 0;
  if constexpr (MASK == kMaskVec && VEC == 1) {
    bits = mr[c0] != 0;
  } else if constexpr (MASK == kMaskVec && VEC == 4) {
    const unsigned w = *reinterpret_cast<const unsigned*>(mr + c0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bits |= ((w >> (8 * j)) & 0xffu) != 0 ? 1u << j : 0u;
  } else if constexpr (MASK == kMaskVec && VEC == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(mr + c0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bits |= ((w.x >> (8 * j)) & 0xffu) != 0 ? 1u << j : 0u;
      bits |= ((w.y >> (8 * j)) & 0xffu) != 0 ? 1u << (j + 4) : 0u;
    }
  } else if constexpr (MASK == kMaskStrided) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      bits |= mr[(long long)(c0 + j) * ms3] != 0 ? 1u << j : 0u;
  }
  return bits;
}

// Bit j set when element c0 + j lies past the diagonal (c > i2).
template <int VEC>
__device__ __forceinline__ unsigned causal_bits(int c0, int i2) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < VEC; ++j) bits |= c0 + j > i2 ? 1u << j : 0u;
  return bits;
}

// VEC elements at p (one 16-byte load when VEC > 1) widened to fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vals(const T* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = apex_to_float(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = apex_to_float(e[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vals(T* p, const float* v) {
  if constexpr (VEC == 1) {
    p[0] = apex_from_float<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = apex_from_float<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The scaled, filled values of elements c0 .. c0 + VEC - 1; x is read
// only when one of them is live.
template <typename T, int VEC, int MASK>
__device__ __forceinline__ void row_vals(const T* xr,
                                         const unsigned char* mr, int c0,
                                         long long ms3, int i2, int causal,
                                         float scale, float* v) {
  constexpr unsigned kAll = (1u << VEC) - 1u;
  unsigned bits = mask_bits<VEC, MASK>(mr, c0, ms3);
  if (causal) bits |= causal_bits<VEC>(c0, i2);
  float raw[VEC];
  if (bits != kAll) {
    load_vals<T, VEC>(xr + c0, raw);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) raw[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    v[j] = (bits >> j) & 1u ? kFill : raw[j] * scale;
}

template <int LANES>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of at most LANES * NV 16-byte vectors, x and y 16-byte aligned.
// Every lane of the CTA reaches the shuffles (no early return): a group
// past the last row computes on a clamped row and stores nothing.
template <typename T, int LANES, int NV, int MASK>
__global__ void __launch_bounds__(kThreads)
    softmax_row_kernel(const T* __restrict__ x,
                       const unsigned char* __restrict__ mask,
                       T* __restrict__ y, long long rows, int sk, int sq,
                       int d1, long long ms0, long long ms1, long long ms2,
                       long long ms3, float scale, int causal) {
  constexpr int VEC = 16 / sizeof(T);
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / LANES;
  const int sub = threadIdx.x & (LANES - 1);
  const bool live = row < rows;
  const long long r = live ? row : rows - 1;
  const int i2 = (int)(r % sq);
  const long long t = r / sq;
  const long long i1 = t % d1, i0 = t / d1;
  const T* xr = x + r * sk;
  T* yr = y + r * sk;
  const unsigned char* mr =
      MASK == kNoMask ? nullptr : mask + i0 * ms0 + i1 * ms1 + i2 * ms2;
  const int nvec = sk / VEC;

  // every load of the row (mask, then x where live) before any reduction
  float v[NV][VEC];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = sub + LANES * i;
    if (live && vi < nvec) {
      row_vals<T, VEC, MASK>(xr, mr, vi * VEC, ms3, i2, causal, scale,
                             v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = -INFINITY;  // not in the row
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) m = fmaxf(m, v[i][j]);
  }
  m = group_max<LANES>(m);
  const bool dead = (MASK != kNoMask || causal) && m <= kFill;
  const float mb = m * kLog2e;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[i][j] = apex_exp2(fmaf(v[i][j], kLog2e, -mb));
      s += v[i][j];
    }
  }
  s = group_sum<LANES>(s);
  const float rinv = dead ? 0.0f : 1.0f / s;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = sub + LANES * i;
    if (live && vi < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] *= rinv;
      store_vals<T, VEC>(yr + vi * VEC, v[i]);
    }
  }
}

// Any row: one warp per row walks it in VEC-element steps (VEC = 1, or a
// 16-byte vector when x and y are aligned and sk is a multiple of it)
// keeping an online max and sum, merged across the warp by shuffles; a
// second pass (the row is still in L1 or L2) writes y.
template <typename T, int VEC, int MASK>
__global__ void __launch_bounds__(kThreads)
    softmax_loop_kernel(const T* __restrict__ x,
                        const unsigned char* __restrict__ mask,
                        T* __restrict__ y, long long rows, int sk, int sq,
                        int d1, long long ms0, long long ms1, long long ms2,
                        long long ms3, float scale, int causal) {
  const long long row =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i2 = (int)(row % sq);
  const long long t = row / sq;
  const long long i1 = t % d1, i0 = t / d1;
  const T* xr = x + row * (long long)sk;
  T* yr = y + row * (long long)sk;
  const unsigned char* mr =
      MASK == kNoMask ? nullptr : mask + i0 * ms0 + i1 * ms1 + i2 * ms2;
  const int nvec = sk / VEC;

  float m = -INFINITY, s = 0.0f;
  for (int vi = lane; vi < nvec; vi += 32) {
    float v[VEC];
    row_vals<T, VEC, MASK>(xr, mr, vi * VEC, ms3, i2, causal, scale, v);
    float vm = v[0];
#pragma unroll
    for (int j = 1; j < VEC; ++j) vm = fmaxf(vm, v[j]);
    if (vm > m) {
      s *= apex_exp2((m - vm) * kLog2e);
      m = vm;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += apex_exp2((v[j] - m) * kLog2e);
  }
  const float row_max = apex_warp_max(m);
  const float row_sum = apex_warp_sum(
      m == -INFINITY ? 0.0f : s * apex_exp2((m - row_max) * kLog2e));
  const bool dead = (MASK != kNoMask || causal) && row_max <= kFill;
  const float rinv = dead ? 0.0f : 1.0f / row_sum;
  const float mb = row_max * kLog2e;
  for (int vi = lane; vi < nvec; vi += 32) {
    float v[VEC];
    row_vals<T, VEC, MASK>(xr, mr, vi * VEC, ms3, i2, causal, scale, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      v[j] = apex_exp2(fmaf(v[j], kLog2e, -mb)) * rinv;
    store_vals<T, VEC>(yr + vi * VEC, v);
  }
}

template <typename T>
using Kern = void (*)(const T*, const unsigned char*, T*, long long, int,
                      int, int, long long, long long, long long, long long,
                      float, int);

// The kernel for one plan: lanes == 0 the loop kernel at vec elements a
// step; else the row kernel with lanes x nv 16-byte vectors.  NULL for a
// combination that is not built.
template <typename T, int MASK>
Kern<T> pick_mask(int lanes, int nv, int vec) {
  constexpr int V = 16 / sizeof(T);
  if (lanes == 0) {
    if (vec == 1) return softmax_loop_kernel<T, 1, MASK>;
    if (vec == V) return softmax_loop_kernel<T, V, MASK>;
    return nullptr;
  }
  if (vec != V) return nullptr;
  switch (lanes * 16 + nv) {
    case 8 * 16 + 1: return softmax_row_kernel<T, 8, 1, MASK>;
    case 16 * 16 + 1: return softmax_row_kernel<T, 16, 1, MASK>;
    case 32 * 16 + 1: return softmax_row_kernel<T, 32, 1, MASK>;
    case 32 * 16 + 2: return softmax_row_kernel<T, 32, 2, MASK>;
    case 32 * 16 + 4: return softmax_row_kernel<T, 32, 4, MASK>;
    case 32 * 16 + 8: return softmax_row_kernel<T, 32, 8, MASK>;
    default: return nullptr;
  }
}

template <typename T>
Kern<T> pick(int mask_mode, int lanes, int nv, int vec) {
  switch (mask_mode) {
    case kNoMask: return pick_mask<T, kNoMask>(lanes, nv, vec);
    case kMaskVec: return pick_mask<T, kMaskVec>(lanes, nv, vec);
    case kMaskStrided: return pick_mask<T, kMaskStrided>(lanes, nv, vec);
    default: return nullptr;
  }
}

template <typename T>
int launch(const void* x, const void* mask, void* y, long long rows, int sk,
           int sq, int d1, long long ms0, long long ms1, long long ms2,
           long long ms3, float scale, int causal, int lanes, int nv,
           int vec, int mask_mode, cudaStream_t stream) {
  const Kern<T> kern = pick<T>(mask_mode, lanes, nv, vec);
  if (kern == nullptr || (mask == nullptr) != (mask_mode == kNoMask))
    return (int)cudaErrorInvalidValue;
  // the plan's conditions, checked again: vector steps divide the row and
  // start aligned; a vector mask has unit last stride and aligned rows
  if (vec > 1 && (sk % vec != 0 || ((uintptr_t)x | (uintptr_t)y) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (mask_mode == kMaskVec &&
      (ms3 != 1 || ((uintptr_t)mask | ms0 | ms1 | ms2) % vec != 0))
    return (int)cudaErrorInvalidValue;
  if (lanes > 0 && sk / vec > lanes * nv) return (int)cudaErrorInvalidValue;
  const long long blocks =
      lanes == 0 ? (rows + kWarps - 1) / kWarps
                 : (rows * lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, (const unsigned char*)mask, (T*)y, rows, sk, sq, d1, ms0,
      ms1, ms2, ms3, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [rows, sk] contiguous of dtype, rows = d0 * d1 * sq; mask NULL or
// bytes (nonzero = masked) at mask[i0*ms0 + i1*ms1 + i2*ms2 + c*ms3].
// lanes, nv, vec, mask_mode: the wrapper's plan (ops/softmax.py
// softmax_plan).
extern "C" int apex_scaled_softmax_fwd(const void* x, const void* mask,
                                       void* y, long long rows, int sk,
                                       int sq, int d1, long long ms0,
                                       long long ms1, long long ms2,
                                       long long ms3, float scale,
                                       int causal, int dtype, int lanes,
                                       int nv, int vec, int mask_mode,
                                       cudaStream_t stream) {
  if (rows <= 0 || sk <= 0 || sq <= 0 || d1 <= 0 || rows % sq != 0)
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T,
                      return launch<T>(x, mask, y, rows, sk, sq, d1, ms0,
                                       ms1, ms2, ms3, scale, causal, lanes,
                                       nv, vec, mask_mode, stream));
  return (int)cudaErrorInvalidValue;
}

// Registers, static shared memory, resident CTAs per SM and spill bytes
// of one planned instantiation (see apex_kernel_attrs).
extern "C" int apex_scaled_softmax_attrs(int dtype, int lanes, int nv,
                                         int vec, int mask_mode, int* out) {
  APEX_DISPATCH_FLOAT(dtype, T, {
    const Kern<T> kern = pick<T>(mask_mode, lanes, nv, vec);
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    return apex_kernel_attrs(kern, kThreads, out);
  });
  return (int)cudaErrorInvalidValue;
}
