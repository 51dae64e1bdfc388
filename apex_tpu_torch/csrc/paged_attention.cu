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
// pool's scales) read once, ~4 flops per element.  Design: the
// split-key loop of paged_tile.cuh (one cluster of key chunks per
// sequence and kv group, each chunk's warps streaming pool-dtype tiles
// through a cp.async ring, the chunks' partials combined in rank order
// through distributed shared memory), one launch a call.
#include "paged_tile.cuh"

namespace {

using namespace apex_paged;

template <typename T, typename P>
int launch(const Args& a, int b, int splits, int heads, int epl, int smem,
           cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  APEX_PAGED_VARIANT(heads, epl, {
    err = launch_split<T, P, H, EPL>(a, b, splits, smem, true, stream);
  });
  return err;
}

}  // namespace

// q [b, nh, dh] (dtype); pools [nb, bs, g, dh] with elements of code
// `pool`: any float dtype (fp32, bf16 or fp16, whatever q's), or int8
// (kPoolInt8) with k_scale/v_scale [nb, bs, g] fp32 (NULL otherwise);
// tables [b, mb] int32; lengths [b] int32; out [b, nh, dh] (dtype); part
// fp32 scratch for the chunks' partials (splits x rc x (dn_max + 2) floats
// a sequence and group block; NULL when splits = 1).  The
// plan (ops/paged_attention.paged_plan): splits, chunk, heads (the
// kernel's head capacity, 4 or 16), rc (heads a CTA), head_chunks, epl (P
// V dims a lane, 2 or 4), dim_chunks, tile, stages and the dynamic shared
// memory; the entry only checks that it fits.  Needs dh a multiple of 16
// bytes' worth of pool elements.
extern "C" int apex_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* part, int b, int nh, int dh,
    int nb, int bs, int g, int mb, float scale, int dtype, int pool,
    int splits, int chunk, int heads, int rc, int head_chunks, int epl,
    int dim_chunks, int tile, int stages, int smem, cudaStream_t stream) {
  const bool quant = pool == kPoolInt8;
  if ((quant && (k_scale == nullptr || v_scale == nullptr)) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = (const float*)k_scale;
  a.v_scale = (const float*)v_scale;
  a.tables = (const int*)tables;
  a.lengths = (const int*)lengths;
  a.out = out;
  a.part = (float*)part;
  a.nh = nh;
  a.dh = dh;
  a.nb = nb;
  a.bs = bs;
  a.g = g;
  a.mb = mb;
  a.scale_log2 = scale * 1.4426950408889634f;
  set_plan(a, chunk, rc, head_chunks, epl, dim_chunks, tile, stages);
  APEX_DISPATCH_FLOAT(dtype, T, {
    APEX_PAGED_POOL(pool, P, {
      if (!plan_ok(b, nh, dh, g, (int)sizeof(P), mb, bs, splits, a, heads,
                   epl, smem))
        return (int)cudaErrorInvalidValue;
      return launch<T, P>(a, b, splits, heads, epl, smem, stream);
    });
  });
  return (int)cudaErrorInvalidValue;
}

// Registers, shared memory per CTA, CTAs per SM and spill bytes of one
// variant (compute dtype, pool code as above) at `smem` bytes of dynamic
// shared memory (see kernel_attrs).
extern "C" int apex_paged_attention_attrs(int dtype, int pool, int heads,
                                          int epl, int smem, int* out) {
  int err = (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    APEX_PAGED_POOL(pool, P, {
      APEX_PAGED_VARIANT(heads, epl, {
        err = kernel_attrs(paged_split_kernel<T, P, H, EPL>, smem, kThreads,
                           out);
      });
    });
  });
  return err;
}
