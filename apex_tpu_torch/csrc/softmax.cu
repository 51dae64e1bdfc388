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
// mask broadcast at no cost), a row of any length is looped in chunks,
// and the wrapper launches this kernel for every CUDA call of the four
// softmax functions; the backward is a torch composition.  The math is
// the same on every route.
//
// Bound on the H100 at [8,16,512,512] fp32 with a [8,1,1,512] mask:
// bytes (x read once, y written once: 268 MB, ~0.08 ms at 3.35 TB/s;
// ~5 flops per element).  Design: one warp per row, four rows per CTA.
// Pass 1 walks the row in 32-element strides, each lane keeping an
// online max and sum of exponentials, merged across the warp by
// shuffles; pass 2 walks it again (the row is still in L1) and writes y.
// Loads are coalesced scalar loads; vector loads and a register-cached
// row for short rows are the next step.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kFill = -10000.0f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scaled_softmax_kernel(const T* __restrict__ x,
                          const unsigned char* __restrict__ mask,
                          T* __restrict__ y, long long rows, int sk, int sq,
                          int d1, long long ms0, long long ms1,
                          long long ms2, long long ms3, float scale,
                          int causal) {
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
      mask == nullptr ? nullptr : mask + i0 * ms0 + i1 * ms1 + i2 * ms2;
  const bool masks = mask != nullptr || causal;

  auto value = [&](int c) {
    float v = apex_to_float(xr[c]) * scale;
    if (mr != nullptr && mr[c * ms3] != 0) v = kFill;
    if (causal && c > i2) v = kFill;
    return v;
  };

  float m = -INFINITY, s = 0.0f;
  for (int c = lane; c < sk; c += 32) {
    const float v = value(c);
    if (v > m) {
      s = s * expf(m - v) + 1.0f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
  const float row_max = apex_warp_max(m);
  const float row_sum =
      apex_warp_sum(m == -INFINITY ? 0.0f : s * expf(m - row_max));
  const bool dead = masks && row_max <= kFill;
  for (int c = lane; c < sk; c += 32) {
    const float p = dead ? 0.0f : expf(value(c) - row_max) / row_sum;
    yr[c] = apex_from_float<T>(p);
  }
}

}  // namespace

// x, y [rows, sk] contiguous of dtype, rows = d0 * d1 * sq; mask NULL or
// bytes (nonzero = masked) at mask[i0*ms0 + i1*ms1 + i2*ms2 + c*ms3].
extern "C" int apex_scaled_softmax_fwd(const void* x, const void* mask,
                                       void* y, long long rows, int sk,
                                       int sq, int d1, long long ms0,
                                       long long ms1, long long ms2,
                                       long long ms3, float scale,
                                       int causal, int dtype,
                                       cudaStream_t stream) {
  if (rows <= 0 || sk <= 0 || sq <= 0 || d1 <= 0 || rows % sq != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    scaled_softmax_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)x, (const unsigned char*)mask, (T*)y, rows, sk, sq, d1,
        ms0, ms1, ms2, ms3, scale, causal);
  });
  return (int)cudaGetLastError();
}
