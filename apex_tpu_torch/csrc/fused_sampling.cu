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
// Bound on the H100: bytes (each logit read once).  What held the first
// version back was not bytes but a chain of ~130 dependent block-wide
// reductions in one CTA per row, and a row in one SM's shared memory.
//
// Design.  A row is spread over a thread-block cluster of `c` CTAs
// (fused_sampling.sample_plan: up to 8, so that b = 8 rows fill 64 SMs),
// each reading a slice of S logits once, in their own dtype (widened in
// registers, no fp32 copy of the row), and keeping the scaled slice y =
// x / div in shared memory as fp32, so that later passes divide nothing;
// a slice too large for the staging budget is re-read from L2 instead,
// so any vocabulary runs.  The CTAs exchange
// partials through distributed shared memory and add them in rank order.
//   1. One read of the slice: the max with its lowest valid index (the
//      greedy token, no second read), max y and min live y, and for top-k
//      the ceil(k / c)-th largest of the CTA's 16 warp maxima.  Each CTA
//      pushes them into every rank's slots; after one cluster barrier
//      every CTA holds the row's (greedy, hi0, lo0) and the smallest of
//      those warp maxima: c CTAs hold at least k distinct elements at or
//      above it, so it bounds the k-th value from below and nothing under
//      it is a candidate.  Temperature-0 rows are done.
//   2. With no filter: the Gumbel-max draw over the slice, pushed to rank
//      0, which takes the (value, lowest index) max in rank order.
//   3. With a filter: a histogram of the live y over kBins equal buckets
//      of [floor0, hi0] (floor0: lo0, or for top-k that lower bound when
//      higher, so most of a row is never counted; shared-memory integer
//      atomics: exact counts), plus,
//      for top-p alone, each bucket's mass and the slice's mass
//      sum(exp(y - hi0)).  After a cluster barrier every CTA
//      reads all ranks' histograms and picks the same buckets [jc, jhi]:
//        top-k: from the bucket holding the k-th largest value v_k up.
//          The candidates C contain every y >= v_k, and for every mid,
//          count(y >= mid) >= k over the row iff over C (mid <= v_k: both
//          hold the k largest; mid > v_k: fewer than k exceed v_k in
//          either), so the 64 halvings from the row's (lo0, hi0) take the
//          same branches and give the same cutoff, bit for bit.
//        top-p alone: jc the highest bucket whose suffix mass reaches
//          1 + 2^-14 times the target, jhi the lowest above which it stays
//          under 1 - 2^-14 times it; the bucket masses are summed exactly,
//          in fixed point (units of 2^-40), so the choice does not depend
//          on the order of addition, and the margin covers every fp32
//          rounding of the sums compared below.  Elements above jhi are
//          "committed": always kept; each CTA sums their mass and draws
//          their Gumbel-max in the compaction pass.  Every candidate
//          exceeds every element below and is below every committed one,
//          so for mids below C both the row's mass and C's plus the
//          committed reach the target, for mids above C neither does, and
//          in between they are sums of the same terms.
//      The candidates (y, exp(y - hi0), column) are copied in rank and
//      slice order into rank 0's shared memory; a cluster barrier; the
//      other ranks leave.
//   4. Rank 0 finishes over the candidates — one warp, shuffles only, up
//      to kWarpCands of them; all 16 warps above.  Up to kDirectCands it
//      takes each branch from one value: count(y >= mid) >= k iff mid <=
//      v_k, and mass(y > mid) >= target iff mid < the largest kept value
//      whose mass at or above it (committed included) reaches the target;
//      so the 64 + 64 halvings run in registers, as _sampling_plain's do.
//      Past kDirectCands each step sums over the candidates.  The draw
//      runs over the kept candidates and the committed draw: after a
//      filter a dropped column's z = -1e30 + g is -1e30 in fp32 and
//      cannot beat a live kept one, so the hash and the two logs run once
//      per kept element.
//   5. Where the candidates do not fit (ties, or a nucleus boundary wider
//      than `cap`), a cutoff leaves the candidates (64 halvings that did
//      not reach one ulp), or nothing live is kept, rank 0 finishes the
//      remaining steps over the whole row from global memory, block-wide.
// Every sum is taken in a fixed order (thread-strided, a shuffle tree,
// warps and ranks in order), so repeats are bitwise equal.  The key words
// and temperatures are read from device memory, so a captured CUDA graph
// replays new draws from new words written into the same buffer.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2 * kThreads;   // two histogram buckets a thread
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kWarpCands = 64;        // candidates one warp finishes alone
constexpr int kBisectIters = 64;
constexpr float kLive = APEX_NEG_INF / 2;
constexpr unsigned kFull = 0xffffffffu;
// top-p alone: bucket masses in fixed point (exp(y - hi0) <= 1 in units of
// 2^-40; integer sums are exact in any order), and the margin around the
// target within which the candidates' buckets are kept
constexpr float kFix = 1099511627776.0f;  // 2^40
constexpr float kMargin = 1.0f / 16384.0f;

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

__device__ __forceinline__ float gumbel(int col, int row, uint32_t s0,
                                        uint32_t s1) {
  return -logf(-logf(uniform_bits((uint32_t)col, (uint32_t)row, s0, s1)));
}

// The two halves of a cluster barrier: every CTA of the cluster must have
// started before a peer writes into its shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Slice elements a thread loads before it works on any of them, so that
// their latencies overlap.
constexpr int kBatch = 4;

// f(j, y) over this thread's slice elements j = tid, tid + kThreads, ...,
// in that order, each batch's y read before f runs on it.
template <typename Y, typename F>
__device__ __forceinline__ void sweep(int n, Y y_at, F f) {
  for (int j0 = threadIdx.x; j0 < n; j0 += kBatch * kThreads) {
    float y[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      y[u] = j < n ? y_at(j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      if (j < n) f(j, y[u]);
    }
  }
}

// The bucket of a live y among kBins equal ones over [lo0, hi0]
// (sc = kBins / (hi0 - lo0), or 0): non-decreasing in y.
__device__ __forceinline__ int bucket(float y, float lo0, float sc) {
  const float t = (y - lo0) * sc;
  if (!(t > 0.0f)) return 0;
  return t >= (float)(kBins - 1) ? kBins - 1 : (int)t;
}

// (value, column): the larger value wins, the lower column on ties.
struct Best {
  float v;
  int i;
};
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}
__device__ __forceinline__ Best warp_best(Best a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = better(a, Best{__shfl_xor_sync(kFull, a.v, o),
                       __shfl_xor_sync(kFull, a.i, o)});
  return a;
}

// A sum every lane agrees on, bit for bit: a fixed tree into lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}
__device__ __forceinline__ int warp_count(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Shared scratch of the block-wide reductions.
struct Scratch {
  float f[kWarps];
  int i[kWarps];
};

// Reductions over the threads taking part: one warp (WIDE = false,
// shuffles only) or the whole CTA (WIDE, warps added in order).
template <bool WIDE>
__device__ __forceinline__ int red_count(int v, Scratch& s) {
  v = warp_count(v);
  if constexpr (!WIDE) {
    return v;
  } else {
    __syncthreads();
    if ((threadIdx.x & 31) == 0) s.i[threadIdx.x >> 5] = v;
    __syncthreads();
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += s.i[w];
    return t;
  }
}
template <bool WIDE>
__device__ __forceinline__ float red_sum(float v, Scratch& s) {
  v = warp_sum(v);
  if constexpr (!WIDE) {
    return v;
  } else {
    __syncthreads();
    if ((threadIdx.x & 31) == 0) s.f[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += s.f[w];
    return t;
  }
}
template <bool WIDE>
__device__ __forceinline__ float red_min(float v, Scratch& s) {
  v = warp_min(v);
  if constexpr (!WIDE) {
    return v;
  } else {
    __syncthreads();
    if ((threadIdx.x & 31) == 0) s.f[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = s.f[0];
    for (int w = 1; w < kWarps; ++w) t = fminf(t, s.f[w]);
    return t;
  }
}
template <bool WIDE>
__device__ __forceinline__ Best red_best(Best v, Scratch& s) {
  v = warp_best(v);
  if constexpr (!WIDE) {
    return v;
  } else {
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
      s.f[threadIdx.x >> 5] = v.v;
      s.i[threadIdx.x >> 5] = v.i;
    }
    __syncthreads();
    Best t{s.f[0], s.i[0]};
    for (int w = 1; w < kWarps; ++w) t = better(t, Best{s.f[w], s.i[w]});
    return t;
  }
}

// The elements a finishing pass walks: rank 0's candidates, or the whole
// row from global memory.  get() gives y (x / div, or -1e30 past
// n_valid) and the column; ex() exp(y - hi0).
struct CandSrc {
  const float* y;
  const float* e;
  const int* col;
  int n;
  static constexpr bool kRow = false;
  __device__ __forceinline__ int size() const { return n; }
  __device__ __forceinline__ float get(int i, int& c) const {
    c = col[i];
    return y[i];
  }
  __device__ __forceinline__ float ex(int i, float, float) const {
    return e[i];
  }
};

template <typename T>
struct RowSrc {
  const T* x;
  int V, n_valid;
  float div;
  static constexpr bool kRow = true;
  __device__ __forceinline__ int size() const { return V; }
  __device__ __forceinline__ float get(int i, int& c) const {
    c = i;
    return i < n_valid ? apex_to_float(x[i]) / div : APEX_NEG_INF;
  }
  __device__ __forceinline__ float ex(int, float y, float hi0) const {
    return expf(y - hi0);
  }
};

// What rank 0 knows of a row when it finishes it.  For top-p alone the
// elements above the candidates' buckets are "committed": certainly kept,
// their mass summed and their Gumbel-max drawn cluster-wide in pass 3.
struct Row {
  int row, greedy, top_k, use_top_p, jc;
  float hi0, lo0, floor0, sc, top_p;  // floor0, sc: the buckets' floor, scale
  float target;                       // top-p alone, from pass 3
  float committed;                    // their mass (0 when none)
  Best cz;                            // their draw ({-inf, kNone}: none)
  uint32_t s0, s1;
};

// Cutoffs found so far, and the token once drawn (-1: not yet).
struct Cut {
  int have_kth, have_theta, token;
  float kth, theta;
};

constexpr int kNone = 0x7fffffff;
// candidates up to which each one's count and mass above it are summed
// directly (O(n^2 / threads)); more are bisected step by step
constexpr int kDirectCands = 1024;

// 64 halvings of [lo, hi] whose branch at each mid is ok(mid), as
// _sampling_plain takes them.
template <typename Ok>
__device__ __forceinline__ float halve(float lo, float hi, Ok ok) {
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    const bool k = ok(mid);
    lo = k ? mid : lo;
    hi = k ? hi : mid;
  }
  return lo;
}

template <bool WIDE>
__device__ __forceinline__ float red_max(float v, Scratch& s) {
  return -red_min<WIDE>(-v, s);
}

// The remaining steps over src by one warp (WIDE = false; lane = its
// thread) or the whole CTA.  Over the candidates a step whose elements
// may leave them stops and leaves the rest to the row pass.
//
// Up to kDirectCands candidates the branches come without a reduction a
// step: count(y >= mid) >= k iff mid <= tau_k, the largest candidate with
// at least k candidates at or above it (the k-th value), and mass(y >
// mid) >= target iff mid < tau_p, the largest kept candidate whose mass
// at or above it (plus the committed mass) reaches the target; so the
// 64 + 64 halvings run in registers on those two values.
template <bool WIDE, typename Src>
__device__ void finish(const Src& src, const Row& r, Cut& cut, Scratch& s) {
  const int nt = WIDE ? kThreads : 32;
  const int t = WIDE ? (int)threadIdx.x : (int)(threadIdx.x & 31);
  const int n = src.size();
  const bool direct = !Src::kRow && n <= kDirectCands;
  const bool topk = r.top_k > 0;
  if (topk && !cut.have_kth) {
    if (direct) {
      float tau = -INFINITY;
      for (int i = t; i < n; i += nt) {
        int c;
        const float yi = src.get(i, c);
        int cnt = 0;
        for (int l = 0; l < n; ++l) cnt += src.get(l, c) >= yi;
        if (cnt >= r.top_k) tau = fmaxf(tau, yi);
      }
      tau = red_max<WIDE>(tau, s);
      cut.kth = halve(r.lo0, r.hi0, [&](float mid) { return mid <= tau; });
    } else {
      cut.kth = halve(r.lo0, r.hi0, [&](float mid) {
        int cnt = 0;
        for (int i = t; i < n; i += nt) {
          int c;
          cnt += src.get(i, c) >= mid;
        }
        return red_count<WIDE>(cnt, s) >= r.top_k;
      });
    }
    cut.have_kth = 1;
    // every y >= kth a candidate?
    if (!Src::kRow &&
        (cut.kth < r.floor0 || bucket(cut.kth, r.floor0, r.sc) < r.jc))
      return;
  }
  const float kth = cut.kth;
  // in the nucleus's set: live and kept by top-k
  auto in_l = [&](float y) { return y > kLive && (!topk || y >= kth); };
  if (r.use_top_p && !cut.have_theta) {
    float target = r.target, lmin = r.lo0;
    if (topk) {
      float sum = 0.0f, mn = INFINITY;
      for (int i = t; i < n; i += nt) {
        int c;
        const float y = src.get(i, c);
        if (in_l(y)) {
          sum += src.ex(i, y, r.hi0);
          mn = fminf(mn, y);
        }
      }
      target = r.top_p * red_sum<WIDE>(sum, s);
      mn = red_min<WIDE>(mn, s);
      lmin = mn == INFINITY ? r.hi0 : mn;
    }
    if (direct) {
      float tau = target <= 0.0f ? INFINITY : -INFINITY;
      for (int i = t; i < n; i += nt) {
        int c;
        const float yi = src.get(i, c);
        if (!in_l(yi)) continue;
        float m = r.committed;
        for (int l = 0; l < n; ++l) {
          const float yl = src.get(l, c);
          if (yl >= yi && in_l(yl)) m += src.ex(l, yl, r.hi0);
        }
        if (m >= target) tau = fmaxf(tau, yi);
      }
      tau = red_max<WIDE>(tau, s);
      cut.theta =
          halve(lmin - 1.0f, r.hi0, [&](float mid) { return mid < tau; });
    } else {
      // above the largest candidate only committed elements remain, whose
      // mass is below the target
      float top = -INFINITY;
      for (int i = t; i < n; i += nt) {
        int c;
        const float y = src.get(i, c);
        if (in_l(y)) top = fmaxf(top, y);
      }
      top = Src::kRow ? INFINITY : red_max<WIDE>(top, s);
      cut.theta = halve(lmin - 1.0f, r.hi0, [&](float mid) {
        float mass = 0.0f;
        for (int i = t; i < n; i += nt) {
          int c;
          const float y = src.get(i, c);
          if (y > mid && in_l(y)) mass += src.ex(i, y, r.hi0);
        }
        mass = r.committed + red_sum<WIDE>(mass, s);
        return target <= 0.0f || (mid < top && mass >= target);
      });
    }
    cut.have_theta = 1;
    // top-p alone: every y > theta a candidate or committed?
    if (!Src::kRow && !topk &&
        bucket(nextafterf(cut.theta, INFINITY), r.floor0, r.sc) < r.jc)
      return;
  }
  // the draw: Gumbel-max over the filtered row, lowest index on ties
  Best z{-INFINITY, kNone};
  for (int i = t; i < n; i += nt) {
    int c;
    float y = src.get(i, c);
    const bool kept = (!topk || y >= cut.kth) &&
                      (!r.use_top_p || y > cut.theta || c == r.greedy);
    if (!kept) {
      if (!Src::kRow) continue;
      y = APEX_NEG_INF;
    }
    z = better(z, Best{y + gumbel(c, r.row, r.s0, r.s1), c});
  }
  z = better(red_best<WIDE>(z, s), r.cz);
  // over the candidates only a live kept element proves the draw
  if (Src::kRow || z.i != kNone) cut.token = z.i;
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
    sampling_kernel(const T* __restrict__ logits, long long ld,
                    const float* __restrict__ temps,
                    const long long* __restrict__ words,
                    int* __restrict__ out, int V, int n_valid, int top_k,
                    float top_p, int use_top_p, int S, int cap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool filter = top_k > 0 || use_top_p;
  const bool topp_only = use_top_p && top_k == 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sy = reinterpret_cast<float*>(smem);
  const int slice_bytes = STAGED ? S * (int)sizeof(float) : 0;
  int* hist = reinterpret_cast<int*>(smem + slice_bytes);
  unsigned long long* hmass =
      reinterpret_cast<unsigned long long*>(hist + kBins);
  float* cy = reinterpret_cast<float*>(hmass + kBins);
  float* ce = cy + cap;
  int* cc = reinterpret_cast<int*>(ce + cap);

  // slots the ranks push their partials into, indexed by rank
  __shared__ float p_bx[kMaxCluster], p_hi[kMaxCluster], p_lo[kMaxCluster],
      p_lk[kMaxCluster];
  __shared__ int p_bi[kMaxCluster];
  __shared__ float p_mass[kMaxCluster], p_cm[kMaxCluster], p_z[kMaxCluster];
  __shared__ int p_zi[kMaxCluster];
  __shared__ float w_f[3][kWarps];
  __shared__ int w_i[kWarps];
  __shared__ unsigned long long w_m[kWarps];
  __shared__ int w_pr[kWarps][kMaxCluster];
  __shared__ int s_jc, s_jhi;
  __shared__ Scratch scratch;
  __shared__ Cut s_cut;

  if (filter)
    for (int j = tid; j < kBins; j += kThreads) {
      hist[j] = 0;
      hmass[j] = 0ull;
    }
  if (tid == 0) {
    s_jc = 0;
    s_jhi = kBins - 1;
  }
  cluster_arrive_relaxed();  // waited for before the first remote write

  const T* x = logits + (size_t)row * ld;
  const int c0 = rank * S;
  const int n = max(0, min(S, V - c0));
  const float temp = temps[row];
  const float div = fmaxf(temp, 1e-6f);

  // ---- 1. one read: greedy, max y, min live y (and the slice staged)
  Best best{-INFINITY, V};
  float hi = -INFINITY, lo = INFINITY;
  auto visit = [&](int j, float xv) {
    const int col = c0 + j;
    const bool valid = col < n_valid;
    best = better(best, Best{valid ? xv : APEX_NEG_INF, valid ? col : V});
    const float y = valid ? xv / div : APEX_NEG_INF;
    if (STAGED) sy[j] = y;
    hi = fmaxf(hi, y);
    if (y > kLive) lo = fminf(lo, y);
  };
  constexpr int E = 16 / (int)sizeof(T);
  const T* xs = x + c0;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(xs) & 15) == 0) {
    const int nv = n / E;
    for (int v0 = tid; v0 < nv; v0 += kBatch * kThreads) {
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (v0 + u * kThreads < nv)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(xs) + v0 +
                         u * kThreads);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = v0 + u * kThreads;
        if (v >= nv) break;
        const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (sizeof(T) == 4) {
            visit(v * E + q, __uint_as_float(w[q]));
          } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
            visit(v * E + 2 * q, __uint_as_float(w[q] << 16));
            visit(v * E + 2 * q + 1, __uint_as_float(w[q] & 0xffff0000u));
          } else {
            visit(v * E + 2 * q,
                  __half2float(__ushort_as_half((unsigned short)(w[q]))));
            visit(v * E + 2 * q + 1, __half2float(__ushort_as_half(
                                         (unsigned short)(w[q] >> 16))));
          }
        }
      }
    }
    done = nv * E;
  }
  for (int j = done + tid; j < n; j += kThreads) {
    visit(j, apex_to_float(xs[j]));
  }
  best = warp_best(best);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
  }
  if (lane == 0) {
    w_f[0][warp] = best.v;
    w_i[warp] = best.i;
    w_f[1][warp] = hi;
    w_f[2][warp] = lo;
  }
  __syncthreads();
  cluster_wait();
  if (warp == 0) {
    // top-k: the m-th largest of the 16 warp maxima, m = ceil(k / c)
    // (-inf past 16).  Each is a distinct element, so the c CTAs hold at
    // least k elements at or above the smallest of theirs: a lower bound
    // of the k-th value, below which nothing is a candidate
    const int m = top_k > 0 ? (top_k + c - 1) / c : kWarps + 1;
    float lk = -INFINITY;
    if (lane < kWarps && m <= kWarps) {
      const float v = w_f[1][lane];
      int above = 0;
      for (int w = 0; w < kWarps; ++w)
        above += w_f[1][w] > v || (w_f[1][w] == v && w < lane);
      lk = above == m - 1 ? v : -INFINITY;
    }
    lk = -warp_min(-lk);
    if (tid < c) {  // this CTA's partial into rank tid's slot `rank`
      Best b{w_f[0][0], w_i[0]};
      float h = w_f[1][0], l = w_f[2][0];
      for (int w = 1; w < kWarps; ++w) {
        b = better(b, Best{w_f[0][w], w_i[w]});
        h = fmaxf(h, w_f[1][w]);
        l = fminf(l, w_f[2][w]);
      }
      cluster.map_shared_rank(p_bx, tid)[rank] = b.v;
      cluster.map_shared_rank(p_bi, tid)[rank] = b.i;
      cluster.map_shared_rank(p_hi, tid)[rank] = h;
      cluster.map_shared_rank(p_lo, tid)[rank] = l;
      cluster.map_shared_rank(p_lk, tid)[rank] = lk;
    }
  }
  cluster.sync();
  Best g{-INFINITY, V};
  float hi0 = -INFINITY, lmin = INFINITY, lk = INFINITY;
  for (int r = 0; r < c; ++r) {
    g = better(g, Best{p_bx[r], p_bi[r]});
    hi0 = fmaxf(hi0, p_hi[r]);
    lmin = fminf(lmin, p_lo[r]);
    lk = fminf(lk, p_lk[r]);
  }
  const int greedy = g.i;
  const float lo0 = lmin == INFINITY ? hi0 : lmin;
  // the histogram's floor: lo0, or for top-k the lower bound of the k-th
  // value when it is higher (when fewer than k are live it is not a bound,
  // but then every live element is a candidate and the cutoff is lo0)
  const float floor0 = top_k > 0 ? fmaxf(lk, lo0) : lo0;
  if (!(temp > 0.0f)) {
    if (rank == 0 && tid == 0) out[row] = greedy;
    return;
  }
  const uint32_t s0 = (uint32_t)words[0], s1 = (uint32_t)words[1];
  auto y_at = [&](int j) {
    if (STAGED) return sy[j];
    return c0 + j < n_valid ? apex_to_float(xs[j]) / div : APEX_NEG_INF;
  };

  // ---- 2. no filter: the draw over the row, cluster-wide
  if (!filter) {
    Best z{-INFINITY, kNone};
    sweep(n, y_at, [&](int j, float y) {
      z = better(z, Best{y + gumbel(c0 + j, row, s0, s1), c0 + j});
    });
    z = warp_best(z);
    if (lane == 0) {
      w_f[0][warp] = z.v;
      w_i[warp] = z.i;
    }
    __syncthreads();
    if (tid == 0) {
      Best b{w_f[0][0], w_i[0]};
      for (int w = 1; w < kWarps; ++w) b = better(b, Best{w_f[0][w], w_i[w]});
      cluster.map_shared_rank(p_z, 0)[rank] = b.v;
      cluster.map_shared_rank(p_zi, 0)[rank] = b.i;
    }
    cluster.sync();
    if (rank == 0 && tid == 0) {
      Best b{p_z[0], p_zi[0]};
      for (int r = 1; r < c; ++r) b = better(b, Best{p_z[r], p_zi[r]});
      out[row] = b.i;
    }
    return;
  }

  // ---- 3. the histogram of the live y from floor0 up, and the candidates
  float sc = hi0 > floor0 ? (float)kBins / (hi0 - floor0) : 0.0f;
  if (!(sc <= 3.0e38f)) sc = 0.0f;
  float mass = 0.0f;
  sweep(n, y_at, [&](int, float y) {
    if (y > kLive && y >= floor0) {
      const int bk = bucket(y, floor0, sc);
      atomicAdd(&hist[bk], 1);
      if (topp_only) {
        const float e = expf(y - hi0);
        atomicAdd(&hmass[bk], __float2ull_rn(e * kFix));
        mass += e;
      }
    }
  });
  if (topp_only) {
    mass = warp_sum(mass);
    if (lane == 0) w_f[0][warp] = mass;
  }
  __syncthreads();
  if (topp_only && tid < c) {
    float m = 0.0f;
    for (int w = 0; w < kWarps; ++w) m += w_f[0][w];
    cluster.map_shared_rank(p_mass, tid)[rank] = m;
  }
  cluster.sync();
  float target = 0.0f;
  if (topp_only) {
    float m = 0.0f;
    for (int r = 0; r < c; ++r) m += p_mass[r];
    target = top_p * m;
  }
  // every rank's counts of this thread's two buckets 2 tid, 2 tid + 1,
  // and for top-p alone their masses
  int cnt[kMaxCluster][2];
  int tot[2] = {0, 0};
  unsigned long long ms[2] = {0ull, 0ull};
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    cnt[r][0] = cnt[r][1] = 0;
    if (r < c) {
      const int2 h = reinterpret_cast<const int2*>(
          cluster.map_shared_rank(hist, r))[tid];
      cnt[r][0] = h.x;
      cnt[r][1] = h.y;
      tot[0] += h.x;
      tot[1] += h.y;
      if (topp_only) {
        const ulonglong2 m = reinterpret_cast<const ulonglong2*>(
            cluster.map_shared_rank(hmass, r))[tid];
        ms[0] += m.x;
        ms[1] += m.y;
      }
    }
  }
  // suffix sums over the buckets (this thread's two, then the threads
  // above), exact in integers: counts, and for top-p alone masses
  int cs = tot[0] + tot[1];
  unsigned long long mss = ms[0] + ms[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_down_sync(kFull, cs, o);
    const unsigned long long mv = __shfl_down_sync(kFull, mss, o);
    if (lane + o < 32) {
      cs += v;
      mss += mv;
    }
  }
  if (lane == 0) {
    w_i[warp] = cs;
    w_m[warp] = mss;
  }
  __syncthreads();
  int after_c = cs - (tot[0] + tot[1]);
  unsigned long long after_m = mss - (ms[0] + ms[1]);
  for (int w = warp + 1; w < kWarps; ++w) {
    after_c += w_i[w];
    after_m += w_m[w];
  }
  {
    // jc: top-k, the bucket of the k-th value; top-p alone, the highest
    // whose suffix mass surely reaches the target.  jhi (top-p alone): the
    // lowest bucket above which the mass surely stays below it
    const int suf1 = tot[1] + after_c, suf0 = tot[0] + suf1;
    const unsigned long long msuf1 = ms[1] + after_m, msuf0 = ms[0] + msuf1;
    const unsigned long long hi_thr =
        __float2ull_ru(target * (1.0f + kMargin) * kFix);
    const unsigned long long lo_thr =
        __float2ull_rd(target * (1.0f - kMargin) * kFix);
    const bool hit1 = top_k > 0 ? suf1 >= top_k : msuf1 >= hi_thr;
    const bool hit0 = top_k > 0 ? suf0 >= top_k : msuf0 >= hi_thr;
    if (hit1)
      atomicMax(&s_jc, 2 * tid + 1);
    else if (hit0)
      atomicMax(&s_jc, 2 * tid);
    if (topp_only) {
      if (msuf1 < lo_thr)         // above 2 tid
        atomicMin(&s_jhi, 2 * tid);
      else if (after_m < lo_thr)  // above 2 tid + 1
        atomicMin(&s_jhi, 2 * tid + 1);
    }
  }
  __syncthreads();
  const int jc = s_jc, jhi = s_jhi;
  auto is_cand = [&](float y) {
    if (!(y > kLive && y >= floor0)) return false;
    const int bk = bucket(y, floor0, sc);
    return bk >= jc && bk <= jhi;
  };
  // every rank's count of candidates, and this rank's place among them
  {
    int pr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      pr[r] = warp_count((2 * tid >= jc && 2 * tid <= jhi ? cnt[r][0] : 0) +
                         (2 * tid + 1 >= jc && 2 * tid + 1 <= jhi
                              ? cnt[r][1]
                              : 0));
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) w_pr[warp][r] = pr[r];
  }
  __syncthreads();
  int base = 0, n_c = 0;
  for (int r = 0; r < c; ++r) {
    int nr = 0;
    for (int w = 0; w < kWarps; ++w) nr += w_pr[w][r];
    base += r < rank ? nr : 0;
    n_c += nr;
  }
  const bool fits = n_c <= cap;
  if (fits) {
    // this thread's candidates (slice elements tid, tid + 512, ...),
    // placed after the threads before it; above them (top-p alone) the
    // committed elements' mass and draw
    int mine = 0;
    sweep(n, y_at, [&](int, float y) { mine += is_cand(y); });
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    __syncthreads();
    if (lane == 31) w_i[warp] = incl;
    __syncthreads();
    int at = base + incl - mine;
    for (int w = 0; w < warp; ++w) at += w_i[w];
    float* dy = cluster.map_shared_rank(cy, 0);
    float* de = cluster.map_shared_rank(ce, 0);
    int* dc = cluster.map_shared_rank(cc, 0);
    float cm = 0.0f;
    Best cz{-INFINITY, kNone};
    sweep(n, y_at, [&](int j, float y) {
      if (is_cand(y)) {
        dy[at] = y;
        de[at] = expf(y - hi0);
        dc[at] = c0 + j;
        ++at;
      } else if (topp_only && y > kLive && bucket(y, floor0, sc) > jhi) {
        cm += expf(y - hi0);
        cz = better(cz, Best{y + gumbel(c0 + j, row, s0, s1), c0 + j});
      }
    });
    if (topp_only) {
      cm = warp_sum(cm);
      cz = warp_best(cz);
      __syncthreads();  // every warp has read w_i above
      if (lane == 0) {
        w_f[0][warp] = cm;
        w_f[1][warp] = cz.v;
        w_i[warp] = cz.i;
      }
      __syncthreads();
      if (tid == 0) {
        float m = 0.0f;
        Best b{-INFINITY, kNone};
        for (int w = 0; w < kWarps; ++w) {
          m += w_f[0][w];
          b = better(b, Best{w_f[1][w], w_i[w]});
        }
        cluster.map_shared_rank(p_cm, 0)[rank] = m;
        cluster.map_shared_rank(p_z, 0)[rank] = b.v;
        cluster.map_shared_rank(p_zi, 0)[rank] = b.i;
      }
    }
  }
  cluster.sync();  // the candidates are in rank 0; no more remote reads
  if (rank != 0) return;

  // ---- 4. rank 0: the cutoffs and the draw over the candidates
  float committed = 0.0f;
  Best cz{-INFINITY, kNone};
  if (topp_only && fits)
    for (int r = 0; r < c; ++r) {
      committed += p_cm[r];
      cz = better(cz, Best{p_z[r], p_zi[r]});
    }
  const Row r{row, greedy, top_k, use_top_p, jc, hi0, lo0, floor0, sc, top_p,
              target, committed, cz, s0, s1};
  if (tid == 0) s_cut = Cut{0, 0, -1, 0.0f, 0.0f};
  __syncthreads();
  if (fits) {
    const CandSrc cand{cy, ce, cc, n_c};
    if (n_c <= kWarpCands) {
      if (warp == 0) {
        Cut cut = s_cut;
        finish<false>(cand, r, cut, scratch);
        if (lane == 0) s_cut = cut;
      }
    } else {
      Cut cut = s_cut;
      finish<true>(cand, r, cut, scratch);
      if (tid == 0) s_cut = cut;
    }
    __syncthreads();
  }
  // ---- 5. the rest over the whole row
  Cut cut = s_cut;
  if (cut.token < 0) {
    const RowSrc<T> whole{x, V, n_valid, div};
    const Row rr{row,   greedy, top_k,  use_top_p, jc,
                 hi0,   lo0,    floor0, sc,        top_p,
                 target, 0.0f,  Best{-INFINITY, kNone}, s0, s1};
    finish<true>(whole, rr, cut, scratch);
  }
  if (tid == 0) out[row] = cut.token;
}

template <typename T, bool STAGED>
int launch(const void* logits, long long ld, const void* temps,
           const void* words, void* out, int b, int V, int n_valid,
           int top_k, float top_p, int use_top_p, int cluster, int S,
           int cap, int smem, cudaStream_t stream) {
  auto kern = sampling_kernel<T, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one CTA: a plain launch
  const T* xp = (const T*)logits;
  const float* tp = (const float*)temps;
  const long long* wp = (const long long*)words;
  int* op = (int*)out;
  void* args[] = {&xp, &ld,   &tp,  &wp,        &op, &V, &n_valid,
                  &top_k, &top_p, &use_top_p, &S, &cap};
  err = cudaLaunchKernelExC(&cfg, (const void*)kern, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// logits [b, V] rows ld elements apart, of dtype (fp32, bf16, fp16);
// temps [b] fp32; words [2] int64 (the low 32 bits of each are the key
// words); out [b] int32.  top_k <= 0: no top-k cutoff; use_top_p = 0: no
// nucleus.  The plan (fused_sampling.sample_plan): `cluster` CTAs (1 ..=
// 8) a row of `slice` logits each (a multiple of 8), the slice in shared
// memory when `staged`, `cap` candidates (0 without a filter) and `smem`
// dynamic bytes, which must be what they take.
extern "C" int apex_fused_sample(const void* logits, long long ld,
                                 const void* temps, const void* words,
                                 void* out, int b, int V, int n_valid,
                                 int top_k, float top_p, int use_top_p,
                                 int cluster, int slice, int staged, int cap,
                                 int smem, int dtype, cudaStream_t stream) {
  const bool filter = top_k > 0 || use_top_p;
  const long long want =
      (staged ? (long long)slice * 4 : 0) +
      (filter ? (long long)kBins * 12 + (long long)cap * 12 : 0);
  if (b <= 0 || b > 65535 || V <= 0 || n_valid < 0 || n_valid > V ||
      ld < V || cluster < 1 || cluster > kMaxCluster || slice <= 0 ||
      slice % 8 != 0 || (long long)cluster * slice < V ||
      (filter ? cap < 1 : cap != 0) || smem != want || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    return staged ? launch<T, true>(logits, ld, temps, words, out, b, V,
                                    n_valid, top_k, top_p, use_top_p,
                                    cluster, slice, cap, smem, stream)
                  : launch<T, false>(logits, ld, temps, words, out, b, V,
                                     n_valid, top_k, top_p, use_top_p,
                                     cluster, slice, cap, smem, stream);
  });
  return (int)cudaErrorInvalidValue;
}

// The kernel's {registers, static shared memory per CTA, CTAs per SM,
// spill bytes} for a dtype, staged or not (apex_kernel_attrs).
extern "C" int apex_fused_sample_attrs(int dtype, int staged, int* out) {
  APEX_DISPATCH_FLOAT(dtype, T, {
    return staged ? apex_kernel_attrs(sampling_kernel<T, true>, kThreads, out)
                  : apex_kernel_attrs(sampling_kernel<T, false>, kThreads,
                                      out);
  });
  return (int)cudaErrorInvalidValue;
}
