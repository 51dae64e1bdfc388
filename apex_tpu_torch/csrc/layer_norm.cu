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
// least time is one read of x and one write of y at 3.35 TB/s.
// Design: one warp per row, 8 rows per 256-thread block.  Rows up to
// 2048 bf16 (1024 fp32) values are read once with 16-byte loads and held
// in registers for both statistics passes and the epilogue, so device
// memory sees one read and one write; other widths take a lane-strided
// scalar path whose second and third pass hit L1.  Warp shuffles do the
// reductions; no shared memory and no atomics.
// Unlike the TPU kernel, which a v5e measurement gated to 16-bit inputs,
// this kernel takes fp32, bf16 and fp16.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kMaxVecs = 8;  // 16-byte vectors a lane may hold

// Rows whose width is a multiple of one 16-byte vector and at most
// 32 lanes x kMaxVecs vectors (2048 bf16 / 1024 fp32 values): the row
// is read once into registers with 16-byte loads and written once.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    ln_fwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mu_out, float* __restrict__ rs_out,
                      int rows, int hidden, float eps, int rms) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = hidden / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * hidden);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * hidden);
  const float inv_h = 1.0f / (float)hidden;

  float v[kMaxVecs][kVec];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) {
      const uint4 raw = xr[vi];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[i][j] = apex_to_float(e[j]);
        s += v[i][j];
      }
    }
  }
  const float mu = rms ? 0.0f : apex_warp_sum(s) * inv_h;
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[i][j] - mu;
        ss += d * d;
      }
    }
  }
  const float rs = rsqrtf(apex_warp_sum(ss) * inv_h + eps);
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = vi * kVec + j;
        float o = (v[i][j] - mu) * rs;
        if (w != nullptr) o *= w[c];
        if (b != nullptr) o += b[c];
        e[j] = apex_from_float<T>(o);
      }
      yr[vi] = raw;
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rs_out[row] = rs;
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
void launch(const void* x, const void* w, const void* b, void* y, void* mu,
            void* rs, int rows, int hidden, float eps, int rms,
            cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (aligned && hidden % kVec == 0 && hidden <= 32 * kMaxVecs * kVec)
    ln_fwd_vec_kernel<T><<<grid, block, 0, stream>>>(
        (const T*)x, (const float*)w, (const float*)b, (T*)y, (float*)mu,
        (float*)rs, rows, hidden, eps, rms);
  else
    ln_fwd_kernel<T><<<grid, block, 0, stream>>>(
        (const T*)x, (const float*)w, (const float*)b, (T*)y, (float*)mu,
        (float*)rs, rows, hidden, eps, rms);
}

}  // namespace

// x, y: [rows, hidden] of dtype; w, b: [hidden] fp32 or NULL;
// mu, rs: [rows] fp32.  Returns cudaGetLastError() after the launch.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* y, void* mu,
                                   void* rs, int rows, int hidden,
                                   float eps, int rms, int dtype,
                                   cudaStream_t stream) {
  if (rows <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T,
                      launch<T>(x, w, b, y, mu, rs, rows, hidden, eps, rms,
                                stream));
  return (int)cudaGetLastError();
}
