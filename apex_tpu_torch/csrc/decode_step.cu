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
// greedy tokens do not drift from it.  The pool is any float dtype (the
// engine's cache_dtype, whatever the compute dtype) or, for
// cache_wire="int8", int8 with one fp32 scale per (token, kv group).
//
// Bound on the H100: bytes.  Per sequence the step reads its live K/V
// (length x g x dh x 2 sides, plus the scales of an int8 pool) once and
// W_proj once for the batch; the flops (~4 per K/V element, 2 per W
// element and row) are far under the ridge.
// Design: two launches a call.  The first is row 6's split-key kernel of
// paged_tile.cuh with the rope folded into its query load; a lane whose
// keys fit one chunk gets its context, rounded to the compute dtype, in
// a per-call [b, nh*dh] buffer, the others leave their chunks' partials.
// The second projects it, launched as the first one's programmatic
// dependent so that its weight loads are in flight while the attention
// runs: each 256-thread CTA owns 64 columns of W (128- or 256-byte row
// segments) and one of up to 8 slices of the contraction (a thread-block
// cluster of those CTAs), reads W in the dtype the caller passes and
// rounds each element to the compute dtype in registers; it stages the
// context itself, adding a lane's chunk partials in chunk order as row
// 6's combine would (so K3 needs no combine launch), and adds the
// contraction slices in a fixed order (shuffles, the warps in order, the
// cluster's ranks in order through distributed shared memory): W crosses
// device memory once a call, and there is no g-way partial sum.  The TPU
// kernel keeps all of W in VMEM; 768 x 768 does not fit the 227 KB of
// shared memory.
#include "paged_tile.cuh"

namespace {

using namespace apex_paged;

constexpr int kProjThreads = 256;
constexpr int kProjRows = 8;       // rows of ctx a pass
// columns of W a CTA: 64 read in 16-byte vectors (128- or 256-byte row
// segments), 32 one element a thread (a warp's lanes span the tile)
template <int VW>
__host__ __device__ constexpr int proj_cols() {
  return VW == 1 ? 32 : 64;
}
constexpr int kProjKBlock = 2048;  // ctx columns staged in shared memory

// A barrier of every thread of the thread-block cluster (release/acquire).
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
          : "memory");
}

// A float at p's offset in the shared memory of cluster CTA `rank`.  Not
// volatile: read only after a cluster barrier (a memory clobber), so the
// loads of several ranks may be in flight together.
__device__ __forceinline__ float ld_rank(const float* p, int rank) {
  uint32_t remote;
  float v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(remote)
      : "r"(smem_u32(p)), "r"(rank));
  asm("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

// VW elements of W at p as raw bits: a 16-byte vector, or one element.
template <typename W, int VW>
__device__ __forceinline__ uint4 load_w(const W* p) {
  if constexpr (VW * sizeof(W) == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint4 u = make_uint4(0, 0, 0, 0);
    if constexpr (sizeof(W) == 4)
      u.x = __ldg(reinterpret_cast<const unsigned int*>(p));
    else
      u.x = __ldg(reinterpret_cast<const unsigned short*>(p));
    return u;
  }
}

// Context element (lane i, column k of nh*dh) rounded to T, lane i's keys
// in n_live chunks: from ctx when one chunk held them (the attention kernel finished it), else
// its chunks' partials added in chunk order, as paged_combine_kernel
// would write it (the combine folded into the projection's staging).
template <typename T>
__device__ __forceinline__ float context_at(const T* ctx, const Args& a,
                                            int splits, int i, int k,
                                            int n_live) {
  if (n_live <= 1) return apex_to_float(ctx[(size_t)i * a.nh * a.dh + k]);
  const int rep = a.nh / a.g;
  const int h = k / a.dh, d = k - h * a.dh;
  const int grp = h / rep, rr = h - grp * rep;
  const int hci = rr / a.rc, dci = d / a.dn_max;
  const int y = (grp * a.head_chunks + hci) * a.dim_chunks + dci;
  const size_t blocks = (size_t)a.g * a.head_chunks * a.dim_chunks;
  const float* part = a.part + ((size_t)i * blocks + y) * splits *
                                   ((size_t)a.rc * (a.dn_max + 2));
  return apex_round<T>(combine_partials(a, part, n_live, rr - hci * a.rc,
                                        d - dci * a.dn_max));
}

// out[i, c] = sum_k ctx[i, k] * round_T(w[k, c]), fp32 sums.  A CTA takes
// a tile of proj_cols<VW>() columns and its cluster rank's slice of the
// contraction (a cluster of gridDim.y CTAs splits it); its threads are cg
// column groups of VW columns times nks slices of that slice.  Each pass
// of kProjRows rows sums the slices within a warp by shuffles, across the
// warps in order, then the ranks' partials in rank order through
// distributed shared memory.  A thread's first kPrefetch weight vectors of
// each pass are in flight while the pass's context rows are staged in
// shared memory (and, launched as the attention's dependent, while the
// attention runs).
template <typename T, typename W, int VW>
__global__ void __launch_bounds__(kProjThreads, 1)
    proj_kernel(const T* __restrict__ ctx, const W* __restrict__ w,
                T* __restrict__ out, int b, int K, int h_out, const Args a,
                int splits) {
  constexpr int kPrefetch = 8;
  constexpr int kPer = 4 / (int)sizeof(W);  // elements a 32-bit word
  constexpr int nc = proj_cols<VW>();
  constexpr int cg = nc / VW;               // column groups
  constexpr int nks = kProjThreads / cg;    // contraction slices
  constexpr int kWarpSlices = 32 / cg;      // slices within one warp
  extern __shared__ __align__(16) float xs[];  // [kProjRows][kb]
  __shared__ float red[kProjThreads / 32][kProjRows][nc];
  __shared__ float cpart[kProjRows * nc];  // this rank's partial of a pass
  __shared__ int live_s[kProjRows];        // the pass's lanes' live chunks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = tid % cg, ks = tid / cg;
  const int col = blockIdx.x * nc + gi * VW;
  const bool has_col = col < h_out;
  const int ranks = gridDim.y, rank = blockIdx.y;
  const int k_lo = (int)((long long)rank * K / ranks);
  const int k_hi = (int)((long long)(rank + 1) * K / ranks);
  const int kb = min(k_hi - k_lo, kProjKBlock);
  for (int i0 = 0; i0 < b; i0 += kProjRows) {
    const int rows = min(kProjRows, b - i0);
    float acc[kProjRows][VW];
#pragma unroll
    for (int r = 0; r < kProjRows; ++r)
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[r][j] = 0.0f;
    auto consume = [&](const uint4& u, int k) {
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
      float wv[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j)
        wv[j] = apex_round<T>(widen<W>(words[j / kPer], j % kPer));
#pragma unroll
      for (int r = 0; r < kProjRows; ++r) {
        if (r < rows) {
          const float x = xs[r * kb + k];
#pragma unroll
          for (int j = 0; j < VW; ++j) acc[r][j] = fmaf(x, wv[j], acc[r][j]);
        }
      }
    };
    for (int k0 = k_lo; k0 < k_hi; k0 += kb) {
      const int kc = min(kb, k_hi - k0);
      uint4 pre[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int k = ks + u * nks;
        pre[u] = has_col && k < kc
                     ? load_w<W, VW>(w + (size_t)(k0 + k) * h_out + col)
                     : make_uint4(0, 0, 0, 0);
      }
      // the lengths are the attention's input: read before its results
      if (tid < rows) live_s[tid] = live_chunks(a, i0 + tid);
      griddep_wait();   // the attention kernel's context is complete
      __syncthreads();  // the previous block's readers are done
      for (int e = tid; e < rows * kc; e += kProjThreads) {
        const int r = e / kc, k = e - r * kc;
        xs[r * kb + k] = context_at(ctx, a, splits, i0 + r, k0 + k,
                                    live_s[r]);
      }
      __syncthreads();
      if (has_col) {
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          const int k = ks + u * nks;
          if (k < kc) consume(pre[u], k);
        }
#pragma unroll 4
        for (int k = ks + kPrefetch * nks; k < kc; k += nks)
          consume(load_w<W, VW>(w + (size_t)(k0 + k) * h_out + col), k);
      }
    }
    // the warp's slices of one column group (lanes gi, gi + cg, ...),
    // every chain advanced one step at a time so their latencies overlap
#pragma unroll
    for (int o = cg; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < kProjRows; ++r)
#pragma unroll
        for (int j = 0; j < VW; ++j)
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
    static_assert(kWarpSlices >= 1, "a column group within a warp");
    if (lane < cg) {
#pragma unroll
      for (int r = 0; r < kProjRows; ++r)
#pragma unroll
        for (int j = 0; j < VW; ++j) red[warp][r][lane * VW + j] = acc[r][j];
    }
    __syncthreads();
    for (int e = tid; e < rows * nc; e += kProjThreads) {
      const int r = e / nc, cc = e - r * nc;
      float sum = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kProjThreads / 32; ++wi) sum += red[wi][r][cc];
      const int c = blockIdx.x * nc + cc;
      if (ranks == 1) {
        if (c < h_out)
          out[(size_t)(i0 + r) * h_out + c] = apex_from_float<T>(sum);
      } else {
        cpart[e] = sum;
      }
    }
    if (ranks == 1) continue;
    cluster_sync_all();
    const int E = rows * nc;
    for (int e = rank * E / ranks + tid; e < (rank + 1) * E / ranks;
         e += kProjThreads) {
      const int r = e / nc, c = blockIdx.x * nc + e % nc;
      float sum = 0.0f;
      for (int q = 0; q < ranks; ++q) sum += ld_rank(cpart + e, q);
      if (c < h_out)
        out[(size_t)(i0 + r) * h_out + c] = apex_from_float<T>(sum);
    }
    cluster_sync_all();  // cpart is rewritten next pass; peers still read
  }
}

// CTAs of one projection cluster, each a slice of the contraction (up to
// 8, at least 64 rows each), and the dynamic shared memory of one (its
// context rows).
inline int proj_ranks(int K) {
  int r = K / 64;
  return r < 1 ? 1 : (r > 8 ? 8 : r);
}
inline int proj_smem(int K) {
  const int ranks = proj_ranks(K);
  const int k_max = (K + ranks - 1) / ranks;
  return kProjRows * (k_max < kProjKBlock ? k_max : kProjKBlock) * 4;
}

// The projection as the attention kernel's programmatic dependent: its
// weight loads start while the attention runs.
template <typename T, typename W>
int launch_proj(const void* ctx, const void* w, void* out, int b, int K,
                int h_out, int vec, const Args& a, int splits,
                cudaStream_t stream) {
  const int ranks = proj_ranks(K);
  const int smem = proj_smem(K);
  auto kern = vec ? proj_kernel<T, W, 16 / (int)sizeof(W)>
                  : proj_kernel<T, W, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = vec ? proj_cols<16 / (int)sizeof(W)>() : proj_cols<1>();
  return launch_dependent(kern, dim3((h_out + nc - 1) / nc, ranks, 1),
                          kProjThreads, smem, ranks, stream, (const T*)ctx,
                          (const W*)w, (T*)out, b, K, h_out, a, splits);
}

template <typename T, typename P>
int launch(const Args& a, int b, int splits, int heads, int epl, int smem,
           cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  APEX_PAGED_VARIANT(heads, epl, {
    err = launch_split<T, P, H, EPL>(a, b, splits, smem, false, stream);
  });
  return err;
}

}  // namespace

// q [b, nh, dh] (dtype, pre-rope); pools [nb, bs, g, dh] with elements
// of code `pool`: any float dtype (whatever q's), or int8 (kPoolInt8)
// with k_scale/v_scale [nb, bs, g] fp32 (NULL otherwise); tables [b, mb]
// int32; lengths [b] int32; w [nh*dh, h_out] in w_dtype (fp32, bf16 or fp16; vec = 1 when its rows are 16-byte
// aligned and h_out a multiple of 16 bytes of elements); rope_cos/sin
// [b, d2] fp32 or NULL with d2 = 0; out [b, h_out] (dtype); ctx
// [b, nh*dh] (dtype) and part (the attention plan's partials, fp32)
// scratch.  The attention plan as for apex_paged_attention; the entry
// only checks that it fits.  Needs dh a multiple of 16 bytes' worth of
// pool elements.
extern "C" int apex_decode_layer(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, const void* w, const void* rope_cos,
    const void* rope_sin, void* out, void* ctx, void* part, int b, int nh,
    int dh, int nb, int bs, int g, int mb, int h_out, int d2, float scale,
    int dtype, int pool, int w_dtype, int vec, int splits, int chunk,
    int heads, int rc, int head_chunks, int epl, int dim_chunks, int tile,
    int stages, int smem, cudaStream_t stream) {
  const bool quant = pool == kPoolInt8;
  if (d2 > dh || d2 % 2 || d2 < 0 || (d2 > 0 && rope_cos == nullptr) ||
      h_out <= 0 || (quant && (k_scale == nullptr || v_scale == nullptr)) ||
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
  a.rope_cos = (const float*)rope_cos;
  a.rope_sin = (const float*)rope_sin;
  a.out = ctx;
  a.part = (float*)part;
  a.nh = nh;
  a.dh = dh;
  a.nb = nb;
  a.bs = bs;
  a.g = g;
  a.mb = mb;
  a.d2 = d2;
  a.scale_log2 = scale * 1.4426950408889634f;
  set_plan(a, chunk, rc, head_chunks, epl, dim_chunks, tile, stages);
  APEX_DISPATCH_FLOAT(dtype, T, {
    int err = (int)cudaErrorInvalidValue;
    APEX_PAGED_POOL(pool, P, {
      if (!plan_ok(b, nh, dh, g, (int)sizeof(P), mb, bs, splits, a, heads,
                   epl, smem) ||
          (long long)nh * dh > 0x7fffffff / 4)
        return (int)cudaErrorInvalidValue;
      err = launch<T, P>(a, b, splits, heads, epl, smem, stream);
    });
    if (err != 0) return err;
    APEX_DISPATCH_FLOAT(w_dtype, W, {
      return launch_proj<T, W>(ctx, w, out, b, nh * dh, h_out, vec, a,
                               splits, stream);
    });
  });
  return (int)cudaErrorInvalidValue;
}

// Registers, shared memory per CTA, CTAs per SM and spill bytes of the
// attention kernel of one variant at `smem` bytes of dynamic shared memory.
extern "C" int apex_decode_attention_attrs(int dtype, int pool, int heads,
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

// ... and of the projection for W of w_dtype (in vectors when vec) and a
// contraction of k_in.
extern "C" int apex_decode_projection_attrs(int dtype, int w_dtype, int vec,
                                            int k_in, int* out) {
  APEX_DISPATCH_FLOAT(dtype, T, {
    APEX_DISPATCH_FLOAT(w_dtype, W, {
      constexpr int VW = 16 / (int)sizeof(W);
      return vec ? kernel_attrs(proj_kernel<T, W, VW>, proj_smem(k_in),
                                kProjThreads, out)
                 : kernel_attrs(proj_kernel<T, W, 1>, proj_smem(k_in),
                                kProjThreads, out);
    });
  });
  return (int)cudaErrorInvalidValue;
}
