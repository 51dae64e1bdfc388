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
// greedy tokens do not drift from it.
//
// Bound on the H100: bytes.  Per sequence the step reads its live K/V
// (length x g x dh x 2 sides) once and W_proj once for the batch; the
// flops (~4 per K/V element) are far under the ridge.
// Design: the TPU kernel keeps all of W_proj resident in VMEM; 768x768
// does not fit the 227 KB of shared memory, so here W streams through
// L2 in coalesced rows along h_out.  One 128-thread CTA per (sequence,
// kv group): it walks block_tables[i, :] itself (a block loads its own
// indices), stages 128 tokens of its group's K and V in shared memory
// as fp32 (K rows padded one word: conflict-free dots), one thread per
// token scores the group's rep query heads, block reductions give the
// running max and sum, and each thread owns rep*dh/128 accumulator
// elements.  Each thread issues its 8 K and 8 V 16-byte tile loads
// before storing any, so the tile arrives in about one memory latency.
// Tiles past the sequence length are never loaded.  At the end the CTA
// multiplies its rep heads' context by their rep*dh rows of
// W into an fp32 partial [h_out]; a second tiny kernel sums the g
// partials of each sequence in a fixed order (deterministic, no
// atomics) and writes the output in the compute dtype.  The (sequence,
// group) grid gives b*g CTAs (96 at b=8, g=12) instead of b.
#include "common.cuh"

namespace {

constexpr int kTT = 128;       // tokens per tile == threads per CTA
constexpr int kWarps = kTT / 32;
constexpr int kMaxRep = 8;     // query heads per kv group
constexpr int kMaxAcc = 8;     // rep*dh <= kTT*kMaxAcc
constexpr int kLoadGroup = 8;  // 16-byte K (and V) loads a thread issues at once

__host__ __device__ inline int smem_floats(int rep, int dh) {
  return rep * dh              // sQ
         + kTT * (dh + 1)      // sK (padded)
         + kTT * dh            // sV
         + rep * kTT           // sP
         + rep * dh            // sCtx
         + 2 * kWarps * kMaxRep  // block-reduction partials
         + 2 * kMaxRep;        // alpha, final l
}

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* dst) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) dst[j] = apex_to_float(e[j]);
}

template <typename T>
__global__ void __launch_bounds__(kTT) decode_attn_proj_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, const float* __restrict__ w,
    const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
    float* __restrict__ partial, int nh, int dh, int nb, int bs, int g,
    int mb, int h_out, int d2, float scale) {
  extern __shared__ float smem[];
  const int rep = nh / g;
  const int rd = rep * dh;
  float* sQ = smem;
  float* sK = sQ + rd;
  float* sV = sK + kTT * (dh + 1);
  float* sP = sV + kTT * dh;
  float* sCtx = sP + rep * kTT;
  float* sRedMax = sCtx + rd;
  float* sRedSum = sRedMax + kWarps * kMaxRep;
  float* sAlpha = sRedSum + kWarps * kMaxRep;
  float* sL = sAlpha + kMaxRep;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i = blockIdx.x;
  const int grp = blockIdx.y;
  const int length = lengths[i];

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
    sQ[e] = qv;
  }

  float m[kMaxRep], l[kMaxRep], acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = APEX_NEG_INF;
    l[r] = 0.0f;
  }
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.0f;

  constexpr int kVec = 16 / sizeof(T);
  const int chunks = dh / kVec;
  for (int t0 = 0; t0 < length; t0 += kTT) {
    __syncthreads();  // sQ written / previous tile's readers done
    // all of a group's loads are issued before any is stored, so up to
    // 2 x kLoadGroup 16-byte loads per thread are in flight at once
    for (int c0 = 0; c0 < kTT * chunks; c0 += kLoadGroup * kTT) {
      uint4 kr[kLoadGroup], vr[kLoadGroup];
#pragma unroll
      for (int j = 0; j < kLoadGroup; ++j) {
        const int c = c0 + j * kTT + tid;
        const int tok = t0 + c / chunks;
        kr[j] = vr[j] = make_uint4(0, 0, 0, 0);
        if (c < kTT * chunks && tok < length) {
          int blk = tables[(size_t)i * mb + tok / bs];
          blk = blk < 0 ? 0 : (blk >= nb ? nb - 1 : blk);
          const size_t off = (((size_t)blk * bs + tok % bs) * g + grp) * dh +
                             (c % chunks) * kVec;
          kr[j] = *reinterpret_cast<const uint4*>(k_pool + off);
          vr[j] = *reinterpret_cast<const uint4*>(v_pool + off);
        }
      }
#pragma unroll
      for (int j = 0; j < kLoadGroup; ++j) {
        const int c = c0 + j * kTT + tid;
        if (c < kTT * chunks) {
          const int t = c / chunks, col = (c % chunks) * kVec;
          float kv[kVec], vv[kVec];
          unpack16<T>(kr[j], kv);
          unpack16<T>(vr[j], vv);
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            sK[t * (dh + 1) + col + u] = kv[u];
            sV[t * dh + col + u] = vv[u];
          }
        }
      }
    }
    __syncthreads();

    // one thread per token: the group's rep scores
    const bool tok_live = t0 + tid < length;
    float s[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      s[r] = APEX_NEG_INF;
      if (r < rep && tok_live) {
        float dot = 0.0f;
        for (int d = 0; d < dh; ++d)
          dot += sQ[r * dh + d] * sK[tid * (dh + 1) + d];
        s[r] = dot * scale;
      }
      if (r < rep) {
        const float wm = apex_warp_max(s[r]);
        if (lane == 0) sRedMax[warp * kMaxRep + r] = wm;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float mx = sRedMax[r];
        for (int wi = 1; wi < kWarps; ++wi)
          mx = fmaxf(mx, sRedMax[wi * kMaxRep + r]);
        const float m_new = fmaxf(m[r], mx);
        const bool live = m_new > APEX_NEG_INF / 2;
        const float alpha = live ? expf(m[r] - m_new) : 0.0f;
        const float p = live ? expf(s[r] - m_new) : 0.0f;
        sP[r * kTT + tid] = p;
        const float ws = apex_warp_sum(p);
        if (lane == 0) sRedSum[warp * kMaxRep + r] = ws;
        if (tid == 0) sAlpha[r] = alpha;
        m[r] = m_new;
        l[r] *= alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float ps = 0.0f;
        for (int wi = 0; wi < kWarps; ++wi) ps += sRedSum[wi * kMaxRep + r];
        l[r] += ps;
      }
    }
    const int n_tok = min(kTT, length - t0);
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int e = tid + a * kTT;
      if (e < rd) {
        const int r = e / dh, d = e % dh;
        float v = acc[a] * sAlpha[r];
        for (int tt = 0; tt < n_tok; ++tt)
          v += sP[r * kTT + tt] * sV[tt * dh + d];
        acc[a] = v;
      }
    }
  }

  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) sL[r] = l[r] == 0.0f ? 1.0f : l[r];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int e = tid + a * kTT;
    if (e < rd) sCtx[e] = apex_round<T>(acc[a] / sL[e / dh]);
  }
  __syncthreads();

  // this group's rows of W_proj: [rep*dh, h_out], coalesced along h_out
  // (four columns per thread at once: 16 independent L2 loads in flight)
  const float* wg = w + (size_t)grp * rd * h_out;
  for (int c0 = tid; c0 < h_out; c0 += 4 * kTT) {
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int e = 0; e < rd; ++e) {
      const float cv = sCtx[e];
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

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, const void* w,
           const void* rope_cos, const void* rope_sin, void* out,
           void* partial, int b, int nh, int dh, int nb, int bs, int g,
           int mb, int h_out, int d2, float scale, cudaStream_t stream) {
  const int bytes = smem_floats(nh / g, dh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_proj_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  decode_attn_proj_kernel<T><<<dim3(b, g), kTT, bytes, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)tables,
      (const int*)lengths, (const float*)w, (const float*)rope_cos,
      (const float*)rope_sin, (float*)partial, nh, dh, nb, bs, g, mb, h_out,
      d2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_groups_kernel<T><<<b, 256, 0, stream>>>((const float*)partial, (T*)out,
                                              g, h_out);
  return (int)cudaGetLastError();
}

}  // namespace

// q [b, nh, dh] (dtype, pre-rope); pools [nb, bs, g, dh] (dtype);
// tables [b, mb] int32; lengths [b] int32; w [nh*dh, h_out] fp32;
// rope_cos/sin [b, d2] fp32 or NULL with d2 = 0; out [b, h_out] (dtype);
// partial [b, g, h_out] fp32 scratch.  Needs dh % (16 / sizeof(dtype))
// == 0, nh / g <= 8 and (nh / g) * dh <= 1024.
extern "C" int apex_decode_layer(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tables,
                                 const void* lengths, const void* w,
                                 const void* rope_cos, const void* rope_sin,
                                 void* out, void* partial, int b, int nh,
                                 int dh, int nb, int bs, int g, int mb,
                                 int h_out, int d2, float scale, int dtype,
                                 cudaStream_t stream) {
  if (b <= 0 || g <= 0 || nh % g != 0 || nh / g > kMaxRep ||
      (nh / g) * dh > kTT * kMaxAcc || dh % 8 != 0 || d2 > dh || d2 % 2)
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T,
                      return launch<T>(q, k_pool, v_pool, tables, lengths, w,
                                       rope_cos, rope_sin, out, partial, b, nh,
                                       dh, nb, bs, g, mb, h_out, d2, scale,
                                       stream));
  return (int)cudaErrorInvalidValue;
}
