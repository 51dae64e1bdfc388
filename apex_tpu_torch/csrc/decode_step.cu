// K3: the fused decode layer — rope(q), paged attention, ctx @ W_proj.
//
// Replaces apex_tpu/ops/decode_step.py:_fused_kernel (launched by
// _fused_pallas): one decode token per sequence; the query is roped
// (partial NeoX rotation over the first d2 dims, per-sequence angle
// rows) and rounded to the compute dtype and back, attends over the
// sequence's pool blocks through its block table with an online
// softmax (positions >= length masked, unmapped entries never read
// inside the length), and the context, rounded to the compute dtype,
// is multiplied by W_proj rounded to the compute dtype, summed in fp32.
// Those two round-trips replay the unfused path's dtype edges, so the
// greedy tokens do not drift from it.  The pool is the compute dtype or,
// for cache_wire="int8", int8 with one fp32 scale per (token, kv group),
// multiplied in as each K/V tile is stored to shared memory.
//
// Bound on the H100: bytes.  Per sequence the step reads its live K/V
// (length x g x dh x 2 sides, plus the scales of an int8 pool) once and
// W_proj once for the batch; the flops (~4 per K/V element) are far
// under the ridge.
// Design: the TPU kernel keeps all of W_proj resident in VMEM; 768x768
// does not fit the 227 KB of shared memory, so here W streams through
// L2 in coalesced rows along h_out.  One 128-thread CTA per (sequence,
// kv group) runs the paged loop of paged_tile.cuh; at the end the CTA
// multiplies its rep heads' context by their rep*dh rows of W into an
// fp32 partial [h_out], and a second tiny kernel sums the g partials of
// each sequence in a fixed order (deterministic, no atomics) and writes
// the output in the compute dtype.  The (sequence, group) grid gives
// b*g CTAs (96 at b=8, g=12) instead of b.
#include "paged_tile.cuh"

namespace {

using namespace apex_paged;

template <typename T, typename P>
__global__ void __launch_bounds__(kTT) decode_attn_proj_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, const float* __restrict__ w,
    const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
    float* __restrict__ partial, int nh, int dh, int nb, int bs, int g,
    int mb, int h_out, int d2, float scale) {
  extern __shared__ float smem[];
  const int rep = nh / g;
  const int rd = rep * dh;
  const Smem sm = carve(smem, rep, dh);
  const int tid = threadIdx.x;
  const int i = blockIdx.x;
  const int grp = blockIdx.y;

  // the group's rep query heads, roped and rounded like the unfused path
  for (int e = tid; e < rd; e += kTT) {
    const int d = e % dh;
    const T* qh = q + ((size_t)i * nh + grp * rep + e / dh) * dh;
    float qv = apex_to_float(qh[d]);
    if (d < d2) {
      const int half = d2 / 2;
      const float rot =
          d < half ? -apex_to_float(qh[d + half]) : apex_to_float(qh[d - half]);
      const float c = rope_cos[(size_t)i * d2 + d];
      const float s = rope_sin[(size_t)i * d2 + d];
      qv = apex_round<T>(__fadd_rn(__fmul_rn(qv, c), __fmul_rn(rot, s)));
    }
    sm.q[e] = qv;
  }
  __syncthreads();

  attend<P>(sm, k_pool, v_pool, k_scale, v_scale, tables, i, grp, lengths[i],
            rep, dh, nb, bs, g, mb, scale);
  for (int e = tid; e < rd; e += kTT) sm.ctx[e] = apex_round<T>(sm.ctx[e]);
  __syncthreads();

  // this group's rows of W_proj: [rep*dh, h_out], coalesced along h_out
  // (four columns per thread at once: 16 independent L2 loads in flight)
  const float* wg = w + (size_t)grp * rd * h_out;
  for (int c0 = tid; c0 < h_out; c0 += 4 * kTT) {
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int e = 0; e < rd; ++e) {
      const float cv = sm.ctx[e];
      const float* wr = wg + (size_t)e * h_out;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j * kTT;
        if (c < h_out) sum[j] += cv * apex_round<T>(wr[c]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j * kTT;
      if (c < h_out) partial[((size_t)i * g + grp) * h_out + c] = sum[j];
    }
  }
}

template <typename T>
__global__ void sum_groups_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int g, int h_out) {
  const int i = blockIdx.x;
  for (int c = threadIdx.x; c < h_out; c += blockDim.x) {
    float s = 0.0f;
    for (int grp = 0; grp < g; ++grp)
      s += partial[((size_t)i * g + grp) * h_out + c];
    out[(size_t)i * h_out + c] = apex_from_float<T>(s);
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* lengths, const void* w, const void* rope_cos,
           const void* rope_sin, void* out, void* partial, int b, int nh,
           int dh, int nb, int bs, int g, int mb, int h_out, int d2,
           float scale, cudaStream_t stream) {
  const int bytes = smem_floats(nh / g, dh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_proj_kernel<T, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  decode_attn_proj_kernel<T, P><<<dim3(b, g), kTT, bytes, stream>>>(
      (const T*)q, (const P*)k_pool, (const P*)v_pool, (const float*)k_scale,
      (const float*)v_scale, (const int*)tables, (const int*)lengths,
      (const float*)w, (const float*)rope_cos, (const float*)rope_sin,
      (float*)partial, nh, dh, nb, bs, g, mb, h_out, d2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_groups_kernel<T><<<b, 256, 0, stream>>>((const float*)partial, (T*)out,
                                              g, h_out);
  return (int)cudaGetLastError();
}

}  // namespace

// q [b, nh, dh] (dtype, pre-rope); pools [nb, bs, g, dh] in dtype, or
// int8 (quant = 1) with k_scale/v_scale [nb, bs, g] fp32 (NULL
// otherwise); tables [b, mb] int32; lengths [b] int32; w [nh*dh, h_out]
// fp32; rope_cos/sin [b, d2] fp32 or NULL with d2 = 0; out [b, h_out]
// (dtype); partial [b, g, h_out] fp32 scratch.  Needs dh a multiple of
// 16 bytes' worth of pool elements, nh / g <= 8 and (nh / g) * dh <= 1024.
extern "C" int apex_decode_layer(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* lengths, const void* w,
                                 const void* rope_cos, const void* rope_sin,
                                 void* out, void* partial, int b, int nh,
                                 int dh, int nb, int bs, int g, int mb,
                                 int h_out, int d2, float scale, int dtype,
                                 int quant, cudaStream_t stream) {
  if (d2 > dh || d2 % 2 || (quant && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    if (quant) {
      if (!shapes_ok(b, nh, dh, g, 1)) return (int)cudaErrorInvalidValue;
      return launch<T, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables,
                               lengths, w, rope_cos, rope_sin, out, partial, b,
                               nh, dh, nb, bs, g, mb, h_out, d2, scale, stream);
    }
    if (!shapes_ok(b, nh, dh, g, (int)sizeof(T)))
      return (int)cudaErrorInvalidValue;
    return launch<T, T>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                        w, rope_cos, rope_sin, out, partial, b, nh, dh, nb, bs,
                        g, mb, h_out, d2, scale, stream);
  });
  return (int)cudaErrorInvalidValue;
}
