// The paged-attention loop shared by K3 (decode_step.cu) and kernel
// row 6 (paged_attention.cu): one 128-thread CTA attends the rep query
// heads of one kv group of one sequence over the sequence's pool blocks.
//
// The CTA walks block_tables[i, :] itself (a block loads its own
// indices; entries are clamped into the pool before any address is
// formed, and tokens at or past the length are never loaded).  Tiles of
// 128 tokens of the group's K and V are staged in shared memory as fp32
// (K rows padded one word: conflict-free dots); an int8 pool's tile is
// multiplied by its per-(token, group) fp32 scales as it is stored, the
// same single rounding as the plain version's dequantize.  Each thread
// issues its 8 K and 8 V 16-byte loads before storing any, so a tile
// arrives in about one memory latency.  One thread per token scores the
// rep heads, block reductions give the running max and sum (online
// softmax, a fully masked row keeps exact zeros), and each thread owns
// rep*dh/128 accumulator elements.  The context ends in sCtx, fp32.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace apex_paged {

constexpr int kTT = 128;       // tokens per tile == threads per CTA
constexpr int kWarps = kTT / 32;
constexpr int kMaxRep = 8;     // query heads per kv group
constexpr int kMaxAcc = 8;     // rep*dh <= kTT*kMaxAcc
constexpr int kLoadGroup = 8;  // 16-byte K (and V) loads a thread issues at once

__host__ __device__ inline int smem_floats(int rep, int dh) {
  return rep * dh                // q
         + kTT * (dh + 1)        // k (padded)
         + kTT * dh              // v
         + rep * kTT             // p
         + rep * dh              // ctx
         + 2 * kWarps * kMaxRep  // block-reduction partials
         + 2 * kMaxRep           // alpha, final l
         + 2 * kTT;              // the tile's K and V scales (int8 pools)
}

struct Smem {
  float *q, *k, *v, *p, *ctx, *red_max, *red_sum, *alpha, *l, *ks, *vs;
};

__device__ inline Smem carve(float* base, int rep, int dh) {
  Smem s;
  s.q = base;
  s.k = s.q + rep * dh;
  s.v = s.k + kTT * (dh + 1);
  s.p = s.v + kTT * dh;
  s.ctx = s.p + rep * kTT;
  s.red_max = s.ctx + rep * dh;
  s.red_sum = s.red_max + kWarps * kMaxRep;
  s.alpha = s.red_sum + kWarps * kMaxRep;
  s.l = s.alpha + kMaxRep;
  s.ks = s.l + kMaxRep;
  s.vs = s.ks + kTT;
  return s;
}

__device__ __forceinline__ float elem_to_float(int8_t v) { return (float)v; }
template <typename E>
__device__ __forceinline__ float elem_to_float(E v) {
  return apex_to_float(v);
}

template <typename P>
__device__ __forceinline__ void unpack16(const uint4& u, float* dst) {
  const P* e = reinterpret_cast<const P*>(&u);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(P)); ++j) dst[j] = elem_to_float(e[j]);
}

__device__ __forceinline__ int clamp_block(int blk, int nb) {
  return blk < 0 ? 0 : (blk >= nb ? nb - 1 : blk);
}

// Attend sequence i, kv group grp.  sm.q [rep, dh] must hold the (roped)
// query, written before the call; on return sm.ctx [rep, dh] holds the
// fp32 context (acc / l, zeros for an empty sequence) and every thread
// has passed a barrier.  P is the pool's element type: the compute
// dtype, or int8_t with k_scale/v_scale [nb, bs, g] fp32.
template <typename P>
__device__ void attend(const Smem& sm, const P* __restrict__ k_pool,
                       const P* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables, int i, int grp,
                       int length, int rep, int dh, int nb, int bs, int g,
                       int mb, float scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rd = rep * dh;
  length = min(length, mb * bs);   // the table's reach

  float m[kMaxRep], l[kMaxRep], acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = APEX_NEG_INF;
    l[r] = 0.0f;
  }
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.0f;

  constexpr int kVec = 16 / sizeof(P);
  const int chunks = dh / kVec;
  for (int t0 = 0; t0 < length; t0 += kTT) {
    __syncthreads();  // q written / previous tile's readers done
    if (kQuant) {
      const int tok = t0 + tid;
      float sk = 1.0f, sv = 1.0f;
      if (tok < length) {
        const int blk = clamp_block(tables[(size_t)i * mb + tok / bs], nb);
        const size_t si = ((size_t)blk * bs + tok % bs) * g + grp;
        sk = k_scale[si];
        sv = v_scale[si];
      }
      sm.ks[tid] = sk;
      sm.vs[tid] = sv;
      __syncthreads();
    }
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
          const int blk = clamp_block(tables[(size_t)i * mb + tok / bs], nb);
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
          unpack16<P>(kr[j], kv);
          unpack16<P>(vr[j], vv);
          const float sk = kQuant ? sm.ks[t] : 1.0f;
          const float sv = kQuant ? sm.vs[t] : 1.0f;
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            sm.k[t * (dh + 1) + col + u] = kQuant ? kv[u] * sk : kv[u];
            sm.v[t * dh + col + u] = kQuant ? vv[u] * sv : vv[u];
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
          dot += sm.q[r * dh + d] * sm.k[tid * (dh + 1) + d];
        s[r] = dot * scale;
      }
      if (r < rep) {
        const float wm = apex_warp_max(s[r]);
        if (lane == 0) sm.red_max[warp * kMaxRep + r] = wm;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float mx = sm.red_max[r];
        for (int wi = 1; wi < kWarps; ++wi)
          mx = fmaxf(mx, sm.red_max[wi * kMaxRep + r]);
        const float m_new = fmaxf(m[r], mx);
        const bool live = m_new > APEX_NEG_INF / 2;
        const float alpha = live ? expf(m[r] - m_new) : 0.0f;
        const float p = live ? expf(s[r] - m_new) : 0.0f;
        sm.p[r * kTT + tid] = p;
        const float ws = apex_warp_sum(p);
        if (lane == 0) sm.red_sum[warp * kMaxRep + r] = ws;
        if (tid == 0) sm.alpha[r] = alpha;
        m[r] = m_new;
        l[r] *= alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float ps = 0.0f;
        for (int wi = 0; wi < kWarps; ++wi) ps += sm.red_sum[wi * kMaxRep + r];
        l[r] += ps;
      }
    }
    const int n_tok = min(kTT, length - t0);
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int e = tid + a * kTT;
      if (e < rd) {
        const int r = e / dh, d = e % dh;
        float v = acc[a] * sm.alpha[r];
        for (int tt = 0; tt < n_tok; ++tt)
          v += sm.p[r * kTT + tt] * sm.v[tt * dh + d];
        acc[a] = v;
      }
    }
  }

  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) sm.l[r] = l[r] == 0.0f ? 1.0f : l[r];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int e = tid + a * kTT;
    if (e < rd) sm.ctx[e] = acc[a] / sm.l[e / dh];
  }
  __syncthreads();
}

// Shape checks shared by both entry points (the wrapper checks too).
inline bool shapes_ok(int b, int nh, int dh, int g, int elem_bytes) {
  return b > 0 && g > 0 && nh % g == 0 && nh / g <= kMaxRep &&
         (nh / g) * dh <= kTT * kMaxAcc && dh % (16 / elem_bytes) == 0;
}

}  // namespace apex_paged
