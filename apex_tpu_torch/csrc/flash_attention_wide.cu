// Rows 3, 4a and 4b at head sizes above 128: the wide branches of K2, K6
// and K7 (flash-attention forward, dq and dk/dv; BSND, causal, key
// padding, GQA, dropout and segment ids), for fp32, bf16 and fp16.
//
// Replace apex_tpu/ops/flash_attention.py:_fwd_kernel, _bwd_dq_kernel and
// _bwd_dkv_kernel where the head is wider than the Hopper kernels' tiles
// (flash_attention.cu, flash_attention_bwd.cu: 32, 64 or 128 columns).
// The TPU kernels take any head size, the whole head a block.  Here the
// fp32 accumulators of a 64-row tile at d = 256 (dK and dV: 256 registers
// a thread in K7's design) do not fit, so these kernels loop over the head
// in panels of 64 columns and give each CTA a chunk of at most 256 output
// columns: every CTA of a (tile, head) recomputes the scores over the
// whole head, in the same order, and keeps only its chunk's accumulator
// (32 fp32 registers a thread, 64 for dK and dV).  Any head size runs.
//
// A CTA of 256 threads owns a tile of 32 rows (queries, or keys for
// dK/dV); thread t owns row t / 8 and, of a 32 x 32 score tile, the four
// columns t % 8 + 8 j, and of its output chunk the columns t % 8 + 8 i.
// Panels are staged in shared memory as fp32 (rows padded one word) and
// multiplied on the CUDA cores; the row max and sum of the online softmax
// are reduced over the row's eight threads by shuffles.  As the TPU
// kernels: l sums the un-dropped probabilities, the accumulator takes
// keep ? p / (1 - p) : 0 (rounded to V's type, as the Hopper kernel does);
// dq takes ds = p (dp' - delta) scale with dp' the dropped dp; dv the
// dropped p, dk ds; probabilities and ds stay fp32 in the backward.
// Masks: causal from indices, the additive key-padding row, the key tail,
// segment ids (keep_mask.cuh), the lse > -1e30 / 2 guard; tile pairs
// above the diagonal or of disjoint segment ranges are skipped.  No
// atomics: every output element has one writer.
//
// Bound on the H100 at d = 256: operations (4 d flops per open pair in
// the forward, 10 d in the backward), at the tensor cores' rate; these
// kernels run on the CUDA cores (67 TFLOP/s fp32), a simple design first.
#include "common.cuh"
#include "keep_mask.cuh"

namespace {

constexpr int kWB = 32;          // rows of a tile (queries or keys)
constexpr int kPanel = 64;       // head columns a panel
constexpr int kChunk = 256;      // output columns a CTA
constexpr int kWThreads = 256;
constexpr int kLD = kPanel + 1;  // padded fp32 panel row
constexpr int kLP = kWB + 1;     // padded fp32 score row
constexpr int kAcc = kChunk / 8;  // accumulator columns a thread

// Rows [r0, r0 + 32) x columns [c0, c0 + 64) of a [rows, d] view (row r
// at base + r * stride) into dst as fp32; zeros past nrows and d.
template <typename T>
__device__ __forceinline__ void load_panel(float* dst, const T* base,
                                           size_t stride, int r0, int nrows,
                                           int c0, int d) {
  for (int i = threadIdx.x; i < kWB * kPanel; i += kWThreads) {
    const int r = i / kPanel, c = i % kPanel;
    const int row = r0 + r, col = c0 + c;
    dst[r * kLD + c] = row < nrows && col < d
                           ? apex_to_float(base[(size_t)row * stride + col])
                           : 0.0f;
  }
}

// acc[j] = sum over the head of A[a0 + t / 8] . B[b0 + t % 8 + 8 j]: a
// 32 x 32 tile of row dot products, panel by panel through sA and sB.
// Starts with a barrier (the previous readers of sA and sB are done).
template <typename T>
__device__ __forceinline__ void tile_dots(float (&acc)[4], float* sA,
                                          float* sB, const T* a, size_t as,
                                          int a0, int an, const T* b,
                                          size_t bs, int b0, int bn, int d) {
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.0f;
  for (int c0 = 0; c0 < d; c0 += kPanel) {
    __syncthreads();
    load_panel<T>(sA, a, as, a0, an, c0, d);
    load_panel<T>(sB, b, bs, b0, bn, c0, d);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kPanel; ++c) {
      const float av = sA[r * kLD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += av * sB[(c8 + 8 * j) * kLD + c];
    }
  }
}

// acc[pi * 8 + i] += sum_k P[t / 8][k] * X[x0 + k][col0 + 64 pi + t % 8 +
// 8 i] over the chunk's panels: sP the 32 x 32 weights, X a [rows, d] view.
template <typename T>
__device__ __forceinline__ void chunk_product(float (&acc)[kAcc],
                                              const float* sP, float* sB,
                                              const T* x, size_t xs, int x0,
                                              int xn, int col0, int d) {
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
#pragma unroll
  for (int pi = 0; pi < kChunk / kPanel; ++pi) {
    if (col0 + pi * kPanel >= d) break;
    __syncthreads();  // sP is written, the previous readers of sB are done
    load_panel<T>(sB, x, xs, x0, xn, col0 + pi * kPanel, d);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kWB; ++kk) {
      const float pv = sP[r * kLP + kk];
#pragma unroll
      for (int i = 0; i < kPanel / 8; ++i)
        acc[pi * 8 + i] += pv * sB[kk * kLD + c8 + 8 * i];
    }
  }
}

// Stores row `row` (< nrows) of the chunk, times mul, to out_row.
template <typename T>
__device__ __forceinline__ void store_chunk(const float (&acc)[kAcc],
                                            float mul, T* out_row, int col0,
                                            int d) {
  const int c8 = threadIdx.x & 7;
#pragma unroll
  for (int pi = 0; pi < kChunk / kPanel; ++pi)
#pragma unroll
    for (int i = 0; i < kPanel / 8; ++i) {
      const int col = col0 + pi * kPanel + c8 + 8 * i;
      if (col < d) out_row[col] = apex_from_float<T>(acc[pi * 8 + i] * mul);
    }
}

__device__ __forceinline__ float row8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// K2's wide branch: o and lse of (32-query tile, b*n, output chunk).
template <typename T>
__global__ void __launch_bounds__(kWThreads)
    flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ kpm, T* __restrict__ o,
                          float* __restrict__ lse, int sq, int sk, int n,
                          int g, int d, float scale, int causal,
                          FlashExtras ex) {
  __shared__ float sA[kWB * kLD], sB[kWB * kLD], sP[kWB * kLP];
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
  const int bh = blockIdx.y, b = bh / n, h = bh % n, kvh = h / (n / g);
  const int q0 = blockIdx.x * kWB, row = q0 + r;
  const int col0 = blockIdx.z * kChunk;
  const Dropout drop(ex);
  const int qs = ex.seg != nullptr ? seg_at(ex, b, sq, row) : 0;
  const size_t qstr = (size_t)n * d, kstr = (size_t)g * d;
  const T* qb = q + ((size_t)b * sq * n + h) * d;
  const T* kb = k + ((size_t)b * sk * g + kvh) * d;
  const T* vb = v + ((size_t)b * sk * g + kvh) * d;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  float m = APEX_NEG_INF, l = 0.0f;
  const int kv_end = causal ? min(sk, q0 + kWB) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kWB) {
    if (!seg_tile_live(ex, b, sq, q0, kWB, k0, kWB)) continue;
    float s[4];
    tile_dots<T>(s, sA, sB, qb, qstr, q0, sq, kb, kstr, k0, sk, d);
    float mx = APEX_NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + c8 + 8 * j;
      float sv = s[j] * scale;
      if (kpm != nullptr && col < sk) sv += kpm[(size_t)b * sk + col];
      const bool pred =
          col < sk && (!causal || col <= row) &&
          (ex.seg == nullptr || seg_open(qs, seg_at(ex, b, sk, col)));
      s[j] = pred ? sv : APEX_NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, row8_max(mx));
    const bool live = m_new > APEX_NEG_INF / 2;
    const float alpha = live ? expf(m - m_new) : 0.0f;
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + c8 + 8 * j;
      const float p = live ? expf(s[j] - m_new) : 0.0f;
      ps += p;  // l sums the un-dropped p
      sP[r * kLP + c8 + 8 * j] =
          apex_round<T>(drop.on ? drop.apply(p, bh, row, col) : p);
    }
    l = l * alpha + row8_sum(ps);
    m = m_new;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha;
    chunk_product<T>(acc, sP, sB, vb, kstr, k0, sk, col0, d);
  }

  if (row < sq) {
    const float safe_l = l == 0.0f ? 1.0f : l;
    store_chunk<T>(acc, 1.0f / safe_l,
                   o + (((size_t)b * sq + row) * n + h) * d, col0, d);
    if (blockIdx.z == 0 && c8 == 0)
      lse[(size_t)bh * sq + row] =
          l == 0.0f ? APEX_NEG_INF : m + logf(safe_l);
  }
}

// K6's wide branch: dq of (32-query tile, b*n, output chunk).
template <typename T>
__global__ void __launch_bounds__(kWThreads)
    flash_bwd_dq_wide_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ kpm,
                             T* __restrict__ dq, int sq, int sk, int n, int g,
                             int d, float scale, int causal, FlashExtras ex) {
  __shared__ float sA[kWB * kLD], sB[kWB * kLD], sP[kWB * kLP];
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
  const int bh = blockIdx.y, b = bh / n, h = bh % n, kvh = h / (n / g);
  const int q0 = blockIdx.x * kWB, row = q0 + r;
  const int col0 = blockIdx.z * kChunk;
  const Dropout drop(ex);
  const int qs = ex.seg != nullptr ? seg_at(ex, b, sq, row) : 0;
  const float lr = row < sq ? lse[(size_t)bh * sq + row] : APEX_NEG_INF;
  const float dl = row < sq ? delta[(size_t)bh * sq + row] : 0.0f;
  const bool live = lr > APEX_NEG_INF / 2;
  const size_t qstr = (size_t)n * d, kstr = (size_t)g * d;
  const T* qb = q + ((size_t)b * sq * n + h) * d;
  const T* dob = dout + ((size_t)b * sq * n + h) * d;
  const T* kb = k + ((size_t)b * sk * g + kvh) * d;
  const T* vb = v + ((size_t)b * sk * g + kvh) * d;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int kv_end = causal ? min(sk, q0 + kWB) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kWB) {
    if (!seg_tile_live(ex, b, sq, q0, kWB, k0, kWB)) continue;
    float s[4], dp[4];
    tile_dots<T>(s, sA, sB, qb, qstr, q0, sq, kb, kstr, k0, sk, d);
    tile_dots<T>(dp, sA, sB, dob, qstr, q0, sq, vb, kstr, k0, sk, d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + c8 + 8 * j;
      float sv = s[j] * scale;
      if (kpm != nullptr && col < sk) sv += kpm[(size_t)b * sk + col];
      const bool pred =
          live && col < sk && (!causal || col <= row) &&
          (ex.seg == nullptr || seg_open(qs, seg_at(ex, b, sk, col)));
      const float p = pred ? expf(sv - lr) : 0.0f;
      const float dpv = drop.on ? drop.apply(dp[j], bh, row, col) : dp[j];
      sP[r * kLP + c8 + 8 * j] = p * (dpv - dl) * scale;
    }
    chunk_product<T>(acc, sP, sB, kb, kstr, k0, sk, col0, d);
  }
  if (row < sq)
    store_chunk<T>(acc, 1.0f, dq + (((size_t)b * sq + row) * n + h) * d,
                   col0, d);
}

// K7's wide branch: dk and dv of (32-key tile, b*g, output chunk), summed
// over the group's rep query heads.
template <typename T>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_bwd_dkv_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const float* __restrict__ kpm,
                              T* __restrict__ dk, T* __restrict__ dv, int sq,
                              int sk, int n, int g, int d, float scale,
                              int causal, FlashExtras ex) {
  __shared__ float sA[kWB * kLD], sB[kWB * kLD], sP[kWB * kLP],
      sS[kWB * kLP], sL[kWB], sD[kWB];
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
  const int bg = blockIdx.y, b = bg / g, kvh = bg % g;
  const int rep = n / g;
  const int k0 = blockIdx.x * kWB, key = k0 + r;
  const int col0 = blockIdx.z * kChunk;
  const Dropout drop(ex);
  const int ks = ex.seg != nullptr ? seg_at(ex, b, sk, key) : 0;
  const float kp = kpm != nullptr && key < sk ? kpm[(size_t)b * sk + key]
                                              : 0.0f;
  const size_t qstr = (size_t)n * d, kstr = (size_t)g * d;
  const T* kb = k + ((size_t)b * sk * g + kvh) * d;
  const T* vb = v + ((size_t)b * sk * g + kvh) * d;

  float acc_dk[kAcc], acc_dv[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    acc_dk[i] = 0.0f;
    acc_dv[i] = 0.0f;
  }
  // causal: query tiles wholly above this key tile's first key add 0
  const int q_begin = causal ? k0 : 0;
  for (int hr = 0; hr < rep; ++hr) {
    const int h = kvh * rep + hr;
    const int bh = b * n + h;
    const T* qb = q + ((size_t)b * sq * n + h) * d;
    const T* dob = dout + ((size_t)b * sq * n + h) * d;
    for (int q0 = q_begin; q0 < sq; q0 += kWB) {
      if (!seg_tile_live(ex, b, sq, q0, kWB, k0, kWB)) continue;
      // S^T and dP^T: rows are keys, columns queries
      float st[4], dpt[4];
      tile_dots<T>(st, sA, sB, kb, kstr, k0, sk, qb, qstr, q0, sq, d);
      tile_dots<T>(dpt, sA, sB, vb, kstr, k0, sk, dob, qstr, q0, sq, d);
      if (threadIdx.x < kWB) {
        const int qr = q0 + threadIdx.x;
        sL[threadIdx.x] =
            qr < sq ? lse[(size_t)bh * sq + qr] : APEX_NEG_INF;
        sD[threadIdx.x] = qr < sq ? delta[(size_t)bh * sq + qr] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = c8 + 8 * j, qrow = q0 + qc;
        const float lq = sL[qc];
        const bool pred =
            lq > APEX_NEG_INF / 2 && key < sk && qrow < sq &&
            (!causal || key <= qrow) &&
            (ex.seg == nullptr || seg_open(seg_at(ex, b, sq, qrow), ks));
        const float p = pred ? expf(st[j] * scale + kp - lq) : 0.0f;
        float dpv = dpt[j], pd = p;
        if (drop.on) {
          const bool kept = drop.keep(bh, qrow, key);
          dpv = kept ? dpv * drop.inv : 0.0f;
          pd = kept ? p * drop.inv : 0.0f;
        }
        sP[r * kLP + qc] = pd;
        sS[r * kLP + qc] = p * (dpv - sD[qc]) * scale;
      }
      // dV += P^T dO and dK += dS^T Q over the chunk's panels
      chunk_product<T>(acc_dv, sP, sB, dob, qstr, q0, sq, col0, d);
      chunk_product<T>(acc_dk, sS, sB, qb, qstr, q0, sq, col0, d);
    }
  }
  if (key < sk) {
    const size_t off = (((size_t)b * sk + key) * g + kvh) * d;
    store_chunk<T>(acc_dk, 1.0f, dk + off, col0, d);
    store_chunk<T>(acc_dv, 1.0f, dv + off, col0, d);
  }
}

int wide_grid(int rows, int heads, int d, dim3* grid) {
  if (heads > 65535 || (d + kChunk - 1) / kChunk > 65535)
    return (int)cudaErrorInvalidValue;
  *grid = dim3((rows + kWB - 1) / kWB, heads, (d + kChunk - 1) / kChunk);
  return 0;
}

bool args_ok(int b, int sq, int sk, int n, int g, int d, const void* seg,
             const void* seg_rng) {
  return b > 0 && sq > 0 && sk > 0 && g > 0 && d > 0 && n % g == 0 &&
         (seg == nullptr || (seg_rng != nullptr && sq == sk));
}

}  // namespace

// q [b, sq, n, d], k/v [b, sk, g, d], o like q, kpm [b, sk] fp32 additive
// or NULL, lse [b·n, sq] fp32, any d; dtype fp32, bf16 or fp16.  seed,
// threshold, inv_keep, seg and seg_rng as apex_flash_fwd's.
extern "C" int apex_flash_fwd_wide(const void* q, const void* k,
                                   const void* v, const void* kpm, void* o,
                                   void* lse, int b, int sq, int sk, int n,
                                   int g, int d, float scale, int causal,
                                   int dtype, const void* seed,
                                   unsigned threshold, float inv_keep,
                                   const void* seg, const void* seg_rng,
                                   cudaStream_t stream) {
  if (!args_ok(b, sq, sk, n, g, d, seg, seg_rng))
    return (int)cudaErrorInvalidValue;
  const FlashExtras ex = make_extras(seed, threshold, inv_keep, seg, seg_rng);
  dim3 grid;
  if (int err = wide_grid(sq, b * n, d, &grid)) return err;
  APEX_DISPATCH_FLOAT(dtype, T, {
    flash_fwd_wide_kernel<T><<<grid, kWThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)kpm, (T*)o,
        (float*)lse, sq, sk, n, g, d, scale, causal, ex);
    return (int)cudaGetLastError();
  });
  return (int)cudaErrorInvalidValue;
}

// q, do [b, sq, n, d] and k, v [b, sk, g, d]; lse, delta [b·n, sq] fp32;
// dq like q; any d.
extern "C" int apex_flash_bwd_dq_wide(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* kpm, void* dq, int b,
                                      int sq, int sk, int n, int g, int d,
                                      float scale, int causal, int dtype,
                                      const void* seed, unsigned threshold,
                                      float inv_keep, const void* seg,
                                      const void* seg_rng,
                                      cudaStream_t stream) {
  if (!args_ok(b, sq, sk, n, g, d, seg, seg_rng))
    return (int)cudaErrorInvalidValue;
  const FlashExtras ex = make_extras(seed, threshold, inv_keep, seg, seg_rng);
  dim3 grid;
  if (int err = wide_grid(sq, b * n, d, &grid)) return err;
  APEX_DISPATCH_FLOAT(dtype, T, {
    flash_bwd_dq_wide_kernel<T><<<grid, kWThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (const float*)kpm, (T*)dq,
        sq, sk, n, g, d, scale, causal, ex);
    return (int)cudaGetLastError();
  });
  return (int)cudaErrorInvalidValue;
}

// As apex_flash_bwd_dq_wide; dk, dv like k (summed over each group's
// heads).
extern "C" int apex_flash_bwd_dkv_wide(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* kpm, void* dk, void* dv,
                                       int b, int sq, int sk, int n, int g,
                                       int d, float scale, int causal,
                                       int dtype, const void* seed,
                                       unsigned threshold, float inv_keep,
                                       const void* seg, const void* seg_rng,
                                       cudaStream_t stream) {
  if (!args_ok(b, sq, sk, n, g, d, seg, seg_rng))
    return (int)cudaErrorInvalidValue;
  const FlashExtras ex = make_extras(seed, threshold, inv_keep, seg, seg_rng);
  dim3 grid;
  if (int err = wide_grid(sk, b * g, d, &grid)) return err;
  APEX_DISPATCH_FLOAT(dtype, T, {
    flash_bwd_dkv_wide_kernel<T><<<grid, kWThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (const float*)kpm, (T*)dk,
        (T*)dv, sq, sk, n, g, d, scale, causal, ex);
    return (int)cudaGetLastError();
  });
  return (int)cudaErrorInvalidValue;
}

namespace {

template <typename T>
int wide_attrs(int which, int* out) {
  if (which == 0)
    return apex_kernel_attrs(flash_fwd_wide_kernel<T>, kWThreads, out);
  if (which == 1)
    return apex_kernel_attrs(flash_bwd_dq_wide_kernel<T>, kWThreads, out);
  return apex_kernel_attrs(flash_bwd_dkv_wide_kernel<T>, kWThreads, out);
}

}  // namespace

// {registers, static shared memory per CTA, CTAs per SM, spill bytes} of
// the wide forward (which = 0), dq (1) or dk/dv (2) kernel for dtype.
extern "C" int apex_flash_wide_attrs(int which, int dtype, int* out) {
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, { return wide_attrs<T>(which, out); });
  return (int)cudaErrorInvalidValue;
}
