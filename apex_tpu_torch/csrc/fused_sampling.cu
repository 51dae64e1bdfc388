// K4: the fused sampler — vocab limit, temperature, top-k, top-p,
// Gumbel-max draw, one int32 token per row.
//
// Replaces apex_tpu/ops/fused_sampling.py:_sampling_kernel (launched by
// _fused_pallas): mask columns >= n_valid; greedy = the lowest index of
// the row max; y = x / max(temp, 1e-6); the top-k cutoff by 64
// bisection steps over the live range (lo from y > -1e30/2); the nucleus
// cutoff by 64 bisection steps on unnormalized mass, always keeping the
// greedy column; the draw by Gumbel-max with the counter hash
// _uniform_bits ported bit for bit as uint32 arithmetic; the output is
// temp > 0 ? sampled : greedy.
//
// Bound on the H100: bytes.  The kernel reads each logit once from
// device memory; the 128 bisection passes run over a copy of the row in
// shared memory (a 50304-wide fp32 row is 201 KB, under the 227 KB a
// block may hold), so they cost shared-memory and ALU time, not HBM.
// Design: one 1024-thread CTA per row; each pass is a strided sweep plus
// a block reduction (warp shuffles, then 32 partials).  Every bisection
// step only raises the lower bound, so elements below it can never count
// again: every 4 steps the kernel tries to copy the elements still above
// it into a candidate list in the rest of shared memory (in a fixed
// order, by a block scan), and once they fit, the remaining steps sweep
// that list instead of the row.  The counts, hence the top-k cutoff, are
// exactly those of a full sweep; the nucleus masses are the same terms
// summed in another order.  Exponentials are recomputed per pass rather
// than stored.  Rows wider than the shared-memory budget are refused.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 64;
constexpr int kCompactEvery = 4;   // bisection steps between compactions

__device__ float block_sum(float v, float* red) {
  v = apex_warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__device__ float block_max(float v, float* red) {
  v = apex_warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ float block_min(float v, float* red) {
  return -block_max(-v, red);
}

__device__ int block_count(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__device__ int block_min_int(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int m = red[0];
  for (int w = 1; w < kWarps; ++w) m = min(m, red[w]);
  return m;
}

// Copies the elements of y[0:V] that satisfy keep into cand, in a fixed
// order (thread-major over the strided sweep, by an exclusive block
// scan), when at most cap of them do.  Returns their number, or -1 (and
// copies nothing) when there are more.  Every thread gets the result.
template <typename Keep>
__device__ int block_compact(const float* y, int V, float* cand, int cap,
                             Keep keep, int* red) {
  int mine = 0;
  for (int c = threadIdx.x; c < V; c += kThreads) mine += keep(y[c]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int total = 0, before = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? red[w] : 0;
    total += red[w];
  }
  if (total > cap) return -1;
  int at = before + incl - mine;
  for (int c = threadIdx.x; c < V; c += kThreads)
    if (keep(y[c])) cand[at++] = y[c];
  __syncthreads();
  return total;
}

// _uniform_bits (fused_sampling.py:165): murmur3-style finalizer over
// (column, row, key words) → a multiple of 2^-24 in [2^-24, 1 - 2^-24].
__device__ __forceinline__ float uniform_bits(uint32_t col, uint32_t row,
                                              uint32_t s0, uint32_t s1) {
  uint32_t x = col ^ (s0 + row * 0x9E3779B9u);
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  x += s1;
  x *= 0x27D4EB2Fu;
  x ^= x >> 15;
  const float u = (float)(x >> 8) * (1.0f / 16777216.0f);
  return fmaxf(u, 1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads)
    sampling_kernel(const float* __restrict__ logits,
                    const float* __restrict__ temps, int* __restrict__ out,
                    int V, int n_valid, int top_k, float top_p, int use_top_p,
                    uint32_t s0, uint32_t s1, int cap) {
  extern __shared__ float y[];          // [V], then cand[cap]
  float* cand = y + V;
  __shared__ float redf[kWarps];
  __shared__ int redi[kWarps];
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const float* x = logits + (size_t)i * V;
  const float temp = temps[i];
  const float div = fmaxf(temp, 1e-6f);

  // greedy argmax over the masked row, lowest index on ties
  float lm = APEX_NEG_INF;
  for (int c = tid; c < V; c += kThreads) {
    const float xv = c < n_valid ? x[c] : APEX_NEG_INF;
    y[c] = c < n_valid ? xv / div : APEX_NEG_INF;
    lm = fmaxf(lm, xv);
  }
  const float m = block_max(lm, redf);
  int li = V;
  for (int c = tid; c < n_valid && c < V; c += kThreads)
    if (x[c] == m) {
      li = c;
      break;
    }
  const int greedy = block_min_int(li, redi);

  if (top_k > 0 && top_k < n_valid) {
    float lhi = APEX_NEG_INF;
    for (int c = tid; c < V; c += kThreads) lhi = fmaxf(lhi, y[c]);
    const float hi0 = block_max(lhi, redf);
    float llo = INFINITY;
    for (int c = tid; c < V; c += kThreads)
      llo = fminf(llo, y[c] > APEX_NEG_INF / 2 ? y[c] : hi0);
    float lo = block_min(llo, redf), hi = hi0;
    const float* src = y;
    int n_src = V;
    for (int it = 0; it < kBisectIters; ++it) {
      if (src == y && it % kCompactEvery == 0 && it > 0) {
        // every later mid is >= lo: elements below lo never count again
        const float l0 = lo;
        const int n = block_compact(
            y, V, cand, cap, [l0](float v) { return v >= l0; }, redi);
        if (n >= 0) {
          src = cand;
          n_src = n;
        }
      }
      const float mid = 0.5f * (lo + hi);
      int cnt = 0;
      for (int c = tid; c < n_src; c += kThreads) cnt += src[c] >= mid;
      const bool ok = block_count(cnt, redi) >= top_k;
      lo = ok ? mid : lo;
      hi = ok ? hi : mid;
    }
    __syncthreads();
    for (int c = tid; c < V; c += kThreads)
      if (y[c] < lo) y[c] = APEX_NEG_INF;
  }

  if (use_top_p) {
    float lmx = APEX_NEG_INF;
    for (int c = tid; c < V; c += kThreads) lmx = fmaxf(lmx, y[c]);
    const float m2 = block_max(lmx, redf);
    float le = 0.0f, llo = INFINITY;
    for (int c = tid; c < V; c += kThreads) {
      const bool live = y[c] > APEX_NEG_INF / 2;
      le += live ? expf(y[c] - m2) : 0.0f;
      llo = fminf(llo, live ? y[c] : m2);
    }
    const float target = top_p * block_sum(le, redf);
    float lo = block_min(llo, redf) - 1.0f, hi = m2;
    const float* src = y;
    int n_src = V;
    for (int it = 0; it < kBisectIters; ++it) {
      if (src == y && it % kCompactEvery == 0) {
        // every later mid is >= lo: only live elements above lo add mass
        const float l0 = lo;
        const int n = block_compact(
            y, V, cand, cap,
            [l0](float v) { return v > l0 && v > APEX_NEG_INF / 2; }, redi);
        if (n >= 0) {
          src = cand;
          n_src = n;
        }
      }
      const float mid = 0.5f * (lo + hi);
      float mass = 0.0f;
      for (int c = tid; c < n_src; c += kThreads)
        if (src[c] > mid && src[c] > APEX_NEG_INF / 2)
          mass += expf(src[c] - m2);
      const bool ok = block_sum(mass, redf) >= target;
      lo = ok ? mid : lo;
      hi = ok ? hi : mid;
    }
    __syncthreads();
    for (int c = tid; c < V; c += kThreads)
      if (!(y[c] > lo || c == greedy)) y[c] = APEX_NEG_INF;
  }
  __syncthreads();

  // Gumbel-max over the filtered row, lowest index on ties
  float lz = -INFINITY;
  for (int c = tid; c < V; c += kThreads) {
    const float u = uniform_bits((uint32_t)c, (uint32_t)i, s0, s1);
    lz = fmaxf(lz, y[c] + (-logf(-logf(u))));
  }
  const float zm = block_max(lz, redf);
  int lzi = V;
  for (int c = tid; c < V; c += kThreads) {
    const float u = uniform_bits((uint32_t)c, (uint32_t)i, s0, s1);
    if (y[c] + (-logf(-logf(u))) == zm) {
      lzi = c;
      break;
    }
  }
  const int sampled = block_min_int(lzi, redi);
  if (tid == 0) out[i] = temp > 0.0f ? sampled : greedy;
}

}  // namespace

// logits [b, V] fp32, temps [b] fp32, out [b] int32.  top_k <= 0 means
// no top-k cutoff; use_top_p = 0 means no nucleus cutoff.
extern "C" int apex_fused_sample(const void* logits, const void* temps,
                                 void* out, int b, int V, int n_valid,
                                 int top_k, float top_p, int use_top_p,
                                 unsigned int s0, unsigned int s1,
                                 cudaStream_t stream) {
  // the row, then as many candidates as the rest of 227 KB holds (1 KB
  // is left to the static reduction scratch)
  const int budget = 227 * 1024 - 1024;
  const int row_bytes = V * (int)sizeof(float);
  if (b <= 0 || V <= 0 || row_bytes > budget)
    return (int)cudaErrorInvalidValue;
  const int cap = min(8192, (budget - row_bytes) / (int)sizeof(float));
  const int bytes = row_bytes + cap * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sampling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  sampling_kernel<<<b, kThreads, bytes, stream>>>(
      (const float*)logits, (const float*)temps, (int*)out, V, n_valid, top_k,
      top_p, use_top_p, s0, s1, cap);
  return (int)cudaGetLastError();
}
