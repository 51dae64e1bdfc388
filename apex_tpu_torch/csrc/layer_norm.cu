// K1: LayerNorm / RMSNorm forward.
//
// Replaces apex_tpu/ops/layer_norm.py:_ln_fwd_kernel (launched by
// _ln_fwd_pallas): per row, fp32 mean, then the mean of squared
// deviations (the same two-pass formula, not Welford), rstd =
// rsqrt(var + eps), y = (x - mu) * rstd * gamma (+ beta) written in x's
// dtype, plus mu and rstd in fp32 for a later backward.  RMSNorm drops
// the mean (mu = 0, var = mean(x^2)).
//
// Bound on the H100: bytes.  A row of 768 bf16 values is 1.5 KB and
// takes ~4 flops per element, far under the ~295 flop/byte ridge, so the
// least time is one read of x and one write of y at 3.35 TB/s.  The
// Pallas kernel keeps gamma and beta resident (the same block at every
// grid step) and streams row blocks through VMEM.  The Hopper design:
// - ln_fwd_rows_kernel (rows of at most 8 16-byte vectors a lane, x and
//   y aligned): one warp per row, the row read once into registers with
//   16-byte loads; both statistics passes and the epilogue run on the
//   registers, so device memory sees one read and one write.  The warps
//   are persistent: each walks rows `stride` apart, and the next row's
//   loads are issued before the current row's reductions, a register
//   double buffer that keeps a row's bytes in flight while the warp
//   computes.  gamma and beta are loaded once per warp with 16-byte
//   loads, together with its first row, and stay in registers when a
//   lane's share of them is at most 32 values each (h <= 1024 bf16 or
//   fp32); wider rows re-read them per row in vectors (L1 hits).
// - Many rows: about three 4-warp CTAs per SM (the launch bound holds
//   registers to that).  Few rows (decode's 8-32): one 1-warp CTA per
//   row, so each row has an SM to itself and costs one memory round trip
//   (x, gamma and beta issued together).
// - Other widths (not a multiple of a 16-byte vector, unaligned rows,
//   more than 8 vectors a lane) take ln_fwd_kernel: lane-strided scalar
//   loads whose second and third pass hit L1.
// The wrapper (ops/layer_norm.py ln_plan) picks the kernel, the vectors
// per lane, the warps per CTA and the grid from rows, width, element
// size and alignment; this file only checks that the choice fits.
// Unlike the TPU kernel, which a v5e measurement gated to 16-bit inputs,
// this kernel takes fp32, bf16 and fp16.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;   // scalar kernel: one warp per row
constexpr int kRowWarps = 4;       // vector kernel: most warps per CTA
constexpr int kResident = 32;      // gamma/beta values a lane keeps

// gamma (or beta) for the VEC elements at c, fp32: 16-byte loads.
template <int VEC>
__device__ __forceinline__ void load_param(const float* p, int c,
                                           float dflt, float* out) {
  if (p == nullptr) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = dflt;
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + c + j);
    out[j] = q.x;
    out[j + 1] = q.y;
    out[j + 2] = q.z;
    out[j + 3] = q.w;
  }
}

// A lane's NV 16-byte vectors of row r.
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* x, int r, int hidden,
                                         int nvec, int lane,
                                         uint4 (&raw)[NV]) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * hidden);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec) raw[i] = xr[lane + 32 * i];
}

// Rows of at most NV 16-byte vectors a lane; x, y, gamma, beta 16-byte
// aligned, hidden a multiple of the vector.  gamma = NULL scales by 1,
// beta = NULL adds 0 (both exact).
template <typename T, int NV>
__global__ void __launch_bounds__(32 * kRowWarps, 3)
    ln_fwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ y,
                       float* __restrict__ mu_out,
                       float* __restrict__ rs_out, int rows, int hidden,
                       float eps, int rms) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr bool kKeep = NV * VEC <= kResident;
  constexpr int KV = kKeep ? NV : 1;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  int row = blockIdx.x * warps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = hidden / VEC;
  const float inv_h = 1.0f / (float)hidden;

  uint4 cur[NV], nxt[NV];
  load_row<T, NV>(x, row, hidden, nvec, lane, cur);
  float gw[KV][VEC], gb[KV][VEC];
  if constexpr (kKeep) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        load_param<VEC>(w, vi * VEC, 1.0f, gw[i]);
        load_param<VEC>(b, vi * VEC, 0.0f, gb[i]);
      }
    }
  }

  for (; row < rows; row += stride) {
    const int next = row + stride;
    if (next < rows)   // in flight during this row's reductions
      load_row<T, NV>(x, next, hidden, nvec, lane, nxt);
    float v[NV][VEC];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        const T* e = reinterpret_cast<const T*>(&cur[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          v[i][j] = apex_to_float(e[j]);
          s += v[i][j];
        }
      }
    }
    const float mu = rms ? 0.0f : apex_warp_sum(s) * inv_h;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = v[i][j] - mu;
          ss += d * d;
        }
      }
    }
    const float rs = rsqrtf(apex_warp_sum(ss) * inv_h + eps);
    T* yr = y + (size_t)row * hidden;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        float pw[VEC], pb[VEC];
        if constexpr (kKeep) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            pw[j] = gw[i][j];
            pb[j] = gb[i][j];
          }
        } else {
          load_param<VEC>(w, vi * VEC, 1.0f, pw);
          load_param<VEC>(b, vi * VEC, 0.0f, pb);
        }
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          e[j] = apex_from_float<T>((v[i][j] - mu) * rs * pw[j] + pb[j]);
        reinterpret_cast<uint4*>(yr)[vi] = raw;
      }
    }
    if (lane == 0) {
      mu_out[row] = mu;
      rs_out[row] = rs;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

// Any other width: lane-strided scalar loads; the second and third pass
// over the row hit L1.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mu_out, float* __restrict__ rs_out,
                  int rows, int hidden, float eps, int rms) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * hidden;
  T* yr = y + (size_t)row * hidden;
  const float inv_h = 1.0f / (float)hidden;

  float mu = 0.0f;
  if (!rms) {
    float s = 0.0f;
    for (int c = lane; c < hidden; c += 32) s += apex_to_float(xr[c]);
    mu = apex_warp_sum(s) * inv_h;
  }
  float ss = 0.0f;
  for (int c = lane; c < hidden; c += 32) {
    const float d = apex_to_float(xr[c]) - mu;
    ss += d * d;
  }
  const float var = apex_warp_sum(ss) * inv_h;
  const float rs = rsqrtf(var + eps);
  for (int c = lane; c < hidden; c += 32) {
    float v = (apex_to_float(xr[c]) - mu) * rs;
    if (w != nullptr) v *= w[c];
    if (b != nullptr) v += b[c];
    yr[c] = apex_from_float<T>(v);
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rs_out[row] = rs;
  }
}

template <typename T>
using Kern = void (*)(const T*, const float*, const float*, T*, float*,
                      float*, int, int, float, int);

// nv == 0: the scalar kernel; 1..8: the vector kernel at nv vectors a
// lane.
template <typename T>
Kern<T> pick(int nv) {
  switch (nv) {
    case 0: return ln_fwd_kernel<T>;
    case 1: return ln_fwd_rows_kernel<T, 1>;
    case 2: return ln_fwd_rows_kernel<T, 2>;
    case 3: return ln_fwd_rows_kernel<T, 3>;
    case 4: return ln_fwd_rows_kernel<T, 4>;
    case 5: return ln_fwd_rows_kernel<T, 5>;
    case 6: return ln_fwd_rows_kernel<T, 6>;
    case 7: return ln_fwd_rows_kernel<T, 7>;
    case 8: return ln_fwd_rows_kernel<T, 8>;
    default: return nullptr;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, void* mu,
           void* rs, int rows, int hidden, float eps, int rms, int nv,
           int warps, int grid, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const Kern<T> kern = pick<T>(nv);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  if (nv == 0) {
    const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    kern<<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
        (const T*)x, (const float*)w, (const float*)b, (T*)y, (float*)mu,
        (float*)rs, rows, hidden, eps, rms);
    return (int)cudaGetLastError();
  }
  // the plan's conditions, checked again
  const uintptr_t addr =
      (uintptr_t)x | (uintptr_t)y | (uintptr_t)w | (uintptr_t)b;
  if (addr % 16 != 0 || hidden % kVec != 0 ||
      hidden / kVec > 32 * nv || hidden / kVec <= 32 * (nv - 1) ||
      warps < 1 || warps > kRowWarps || grid < 1)
    return (int)cudaErrorInvalidValue;
  kern<<<grid, 32 * warps, 0, stream>>>(
      (const T*)x, (const float*)w, (const float*)b, (T*)y, (float*)mu,
      (float*)rs, rows, hidden, eps, rms);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [rows, hidden] of dtype; w, b: [hidden] fp32 or NULL;
// mu, rs: [rows] fp32.  nv, warps, grid: the wrapper's plan
// (ops/layer_norm.py ln_plan; nv = 0 is the scalar kernel, which sizes
// its own grid).  Returns cudaGetLastError() after the launch.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* y, void* mu,
                                   void* rs, int rows, int hidden,
                                   float eps, int rms, int dtype, int nv,
                                   int warps, int grid,
                                   cudaStream_t stream) {
  if (rows <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T,
                      return launch<T>(x, w, b, y, mu, rs, rows, hidden, eps,
                                       rms, nv, warps, grid, stream));
  return (int)cudaErrorInvalidValue;
}

// Registers, static shared memory, resident CTAs per SM (at kRowWarps
// warps a CTA; the scalar kernel at its own 8) and spill bytes of the
// kernel for nv vectors a lane (see apex_kernel_attrs).
extern "C" int apex_layer_norm_fwd_attrs(int dtype, int nv, int* out) {
  APEX_DISPATCH_FLOAT(dtype, T, {
    const Kern<T> kern = pick<T>(nv);
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    return apex_kernel_attrs(kern, 32 * (nv == 0 ? kRowsPerBlock : kRowWarps),
                             out);
  });
  return (int)cudaErrorInvalidValue;
}
