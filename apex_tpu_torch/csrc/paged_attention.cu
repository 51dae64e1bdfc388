// Kernel row 6: ragged paged decode attention.
//
// Replaces apex_tpu/ops/paged_attention.py:_paged_kernel (launched by
// _paged_pallas): one query token per sequence attends over the
// sequence's blocks of a paged K/V pool [nb, bs, g, dh] through its
// block table, with an online softmax per block, the rep query heads of
// a kv group folded against the group's single K/V (GQA without
// repeat), blocks at or past the length skipped and the tail block
// masked; an int8 pool is dequantized by its per-(token, group) fp32
// scales as it is loaded.  Output [b, nh, dh] in q's dtype; a sequence
// of length 0 gets exact zeros.
//
// Bound on the H100: bytes — each sequence's live K/V (and an int8
// pool's scales) read once, ~4 flops per element.  Design: K3's loop
// without the projection (paged_tile.cuh): one 128-thread CTA per
// (sequence, kv group) walks its own block-table row, clamping sentinel
// entries (>= num_blocks, released or free lanes) into the pool before
// forming an address and never loading a token at or past the length;
// 128-token K/V tiles in shared memory, one thread per token scoring,
// each thread holding rep*dh/128 fp32 accumulators.
#include "paged_tile.cuh"

namespace {

using namespace apex_paged;

template <typename T, typename P>
__global__ void __launch_bounds__(kTT) paged_attention_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int nh, int dh,
    int nb, int bs, int g, int mb, float scale) {
  extern __shared__ float smem[];
  const int rep = nh / g;
  const int rd = rep * dh;
  const Smem sm = carve(smem, rep, dh);
  const int i = blockIdx.x;
  const int grp = blockIdx.y;
  const size_t head0 = (size_t)i * nh + (size_t)grp * rep;
  for (int e = threadIdx.x; e < rd; e += kTT)
    sm.q[e] = apex_to_float(q[head0 * dh + e]);
  __syncthreads();
  attend<P>(sm, k_pool, v_pool, k_scale, v_scale, tables, i, grp, lengths[i],
            rep, dh, nb, bs, g, mb, scale);
  for (int e = threadIdx.x; e < rd; e += kTT)
    out[head0 * dh + e] = apex_from_float<T>(sm.ctx[e]);
}

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* lengths, void* out, int b, int nh, int dh, int nb,
           int bs, int g, int mb, float scale, cudaStream_t stream) {
  const int bytes = smem_floats(nh / g, dh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<T, P><<<dim3(b, g), kTT, bytes, stream>>>(
      (const T*)q, (const P*)k_pool, (const P*)v_pool, (const float*)k_scale,
      (const float*)v_scale, (const int*)tables, (const int*)lengths, (T*)out,
      nh, dh, nb, bs, g, mb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [b, nh, dh] (dtype); pools [nb, bs, g, dh] in dtype, or int8
// (quant = 1) with k_scale/v_scale [nb, bs, g] fp32 (NULL otherwise);
// tables [b, mb] int32; lengths [b] int32; out [b, nh, dh] (dtype).
// Needs dh a multiple of 16 bytes' worth of pool elements, nh / g <= 8
// and (nh / g) * dh <= 1024.
extern "C" int apex_paged_attention(const void* q, const void* k_pool,
                                    const void* v_pool, const void* k_scale,
                                    const void* v_scale, const void* tables,
                                    const void* lengths, void* out, int b,
                                    int nh, int dh, int nb, int bs, int g,
                                    int mb, float scale, int dtype, int quant,
                                    cudaStream_t stream) {
  if (quant && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    if (quant) {
      if (!shapes_ok(b, nh, dh, g, 1)) return (int)cudaErrorInvalidValue;
      return launch<T, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables,
                               lengths, out, b, nh, dh, nb, bs, g, mb, scale,
                               stream);
    }
    if (!shapes_ok(b, nh, dh, g, (int)sizeof(T)))
      return (int)cudaErrorInvalidValue;
    return launch<T, T>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                        out, b, nh, dh, nb, bs, g, mb, scale, stream);
  });
  return (int)cudaErrorInvalidValue;
}
