// K2: flash-attention forward (BSND), causal and key padding, GQA.
//
// Replaces apex_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd_pallas): FlashAttention-2 online softmax with an additive fp32
// key-padding row, the causal mask from row/column indices, the kv tail
// mask at sk, grouped K/V read by index (kv head = h / (n / g), never
// repeated), and o plus lse written with the -1e30 sentinel and the
// l == 0 guard on fully masked rows.  l sums the fp32 probabilities; they
// are rounded to V's dtype only for the PV product, as the TPU kernel
// does, and the m_new > -1e30/2 guard keeps fully masked rows at 0.
//
// Attention dropout and segment ids (keep_mask.cuh) are runtime arguments
// of both kernels (the Hopper kernel runs an instantiation of its own,
// kExt, when either is on), following _fwd_kernel's dropout_p and has_seg branches
// (:228-234, :246-250, :261-270): l sums the un-dropped probabilities and
// the accumulator takes keep ? p / (1 - p) : 0, lse unchanged; a key of
// another segment (or of a negative id) is masked, and a key tile whose
// ids cannot meet the query tile's is skipped.
//
// Bound on the H100: at the serving shapes (b=8, s<=512, d=64) bytes —
// q, k, v and o are read and written once and the causal, padded pairs
// need fewer flops than the ~295 flop/byte ridge; longer sequences turn
// it compute-bound (4·d flops per open (query, key) pair at the 989
// TFLOP/s bf16 tensor-core rate).
// Design: 16-bit inputs run the Hopper kernel below (TMA ring, wgmma,
// warp specialisation; sm90_tile.cuh).  fp32 inputs take a CUDA-core
// path: one CTA per (64-query tile, batch·head) with a loop over 64-key
// tiles (tiles wholly above the diagonal never loaded), Q, K and V tiles
// in shared memory as fp32 (rows padded one word), four threads per query
// row, each scoring 16 keys and owning d/4 output dims.
#include <type_traits>

#include "common.cuh"
#include "keep_mask.cuh"
#include "sm90_tile.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ kpm,
                     T* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int n, int g, int dr, float scale, int causal,
                     FlashExtras ex) {
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  constexpr int NA = D / 4;           // output dims per thread
  constexpr int NS = kBK / 4;         // keys per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int sub = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / n;
  const int h = bh % n;
  const int kvh = h / (n / g);
  const int q0 = blockIdx.x * kBQ;
  const int row = q0 + r;
  const Dropout drop(ex);
  const int qs = ex.seg != nullptr ? seg_at(ex, b, sq, row) : 0;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int qs = q0 + rr;
    sQ[rr * LD + dd] =
        qs < sq && dd < dr
            ? apex_to_float(q[(((size_t)b * sq + qs) * n + h) * dr + dd])
            : 0.0f;
  }

  __syncthreads();
  float qr[D];  // this thread's query row, kept in registers
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = sQ[r * LD + d];

  float m = APEX_NEG_INF, l = 0.0f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;

  // causal: kv tiles starting past the tile's last query row add nothing
  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    // segments: a key tile no query of the tile can see adds nothing
    if (!seg_tile_live(ex, b, sq, q0, kBQ, k0, kBK)) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int t = i / D, dd = i % D;
      const int ks = k0 + t;
      float kval = 0.0f, vval = 0.0f;
      if (ks < sk && dd < dr) {
        const size_t off = (((size_t)b * sk + ks) * g + kvh) * dr + dd;
        kval = apex_to_float(k[off]);
        vval = apex_to_float(v[off]);
      }
      sK[t * LD + dd] = kval;
      sV[t * LD + dd] = vval;
    }
    __syncthreads();

    float s[NS];
    float mx = APEX_NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = sub + 4 * j;
      const int col = k0 + c;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qr[d] * sK[c * LD + d];
      float sv = dot * scale;
      if (kpm != nullptr && col < sk) sv += kpm[(size_t)b * sk + col];
      const bool pred =
          col < sk && (!causal || col <= row) &&
          (ex.seg == nullptr || seg_open(qs, seg_at(ex, b, sk, col)));
      sv = pred ? sv : APEX_NEG_INF;
      s[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const bool live = m_new > APEX_NEG_INF / 2;
    const float alpha = live ? expf(m - m_new) : 0.0f;
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = live ? expf(s[j] - m_new) : 0.0f;
      ps += p;  // l sums the un-dropped p
      sP[r * LP + sub + 4 * j] = apex_round<T>(
          drop.on ? drop.apply(p, bh, row, k0 + sub + 4 * j) : p);
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * alpha + ps;
    m = m_new;
    __syncwarp();  // a row's four threads share one warp
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= alpha;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = sP[r * LP + kk];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += p * sV[kk * LD + sub + 4 * i];
    }
    __syncwarp();
  }

  if (row < sq) {
    const float safe_l = l == 0.0f ? 1.0f : l;
    T* orow = o + (((size_t)b * sq + row) * n + h) * dr;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (sub + 4 * i < dr)
        orow[sub + 4 * i] = apex_from_float<T>(acc[i] / safe_l);
    if (sub == 0)
      lse[(size_t)bh * sq + row] =
          l == 0.0f ? APEX_NEG_INF : m + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// 16-bit inputs: the Hopper kernel, persistent: one CTA of 384 threads
// per SM walks (128-query tile, b*n) work items, longest first.  Warp 8,
// the producer, issues the TMA loads (each item's Q into one of two
// buffers, so the next item's Q arrives while this one ends; K and V
// into a four-stage ring, each stage freed by the eight consumer warps)
// and copies each key tile's padding row beside it (cp.async).
// Warpgroups 0 and 1 own query rows 0-63 and 64-127 of an item.
// S = Q K^T is a wgmma with its accumulator in registers (Q read once
// into registers as the A operand up to d = 64, from shared memory at
// d = 128); the masked online softmax runs on the accumulator fragments,
// the row max and sum reduced over the quad by shuffles, the causal and
// tail masks only on tiles that cross the diagonal or sk; P, rounded to
// V's dtype, is the register A operand of O += P V, and O stays in
// registers for the whole key loop.  Key tile t's S runs while tile
// t-1's P V runs, and t's softmax overlaps the latter; the warpgroups
// take turns to issue their products, so one's products overlap the
// other's softmax.  Scores are carried in log2 units (exp2), lse
// converted back on the way out.
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  static constexpr int BQ = 128;
  static constexpr int BK = D == 128 ? 64 : 128;
  static constexpr int STAGES = 4;
  using QT = sm90::Tile<D, BQ>;
  using KT = sm90::Tile<D, BK>;
  static constexpr int q_off = 0;  // two Q buffers: this item's, the next
  static constexpr int k_off = q_off + 2 * QT::BYTES;
  static constexpr int v_off = k_off + STAGES * KT::BYTES;
  static constexpr int kpm_off = v_off + STAGES * KT::BYTES;
  static constexpr int bar_off = kpm_off + STAGES * BK * 4;
  // q_full[2], q_empty[2], k_full[S], v_full[S], empty[S]; 1024 bytes of
  // alignment slack
  static constexpr int bytes = bar_off + (4 + 3 * STAGES) * 8 + 1024;
};

// kExt: the instantiation that takes segment ids or dropout.  It is a
// kernel of its own: compiled into the same kernel as a branch, its code
// cost the calls without either 5-12% on an H100 (a variant with the
// branch compiled out timed as the kernel without it).
template <typename T, int D, bool kExt>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ kpm, T* __restrict__ o,
                          float* __restrict__ lse, int nb, int sq, int sk,
                          int n, int g, int dr, float scale, int causal,
                          FlashExtras ex) {
  using C = Fwd<D>;
  constexpr int BQ = C::BQ, BK = C::BK, S = C::STAGES;
  constexpr bool kQRegs = sm90::kStationaryInRegs<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + S;
  uint64_t* empty = v_full + S;
  float* skpm = reinterpret_cast<float*>(smem + C::kpm_off);

  const int bn = nb * n;
  const int nqt = (sq + BQ - 1) / BQ;
  const int items = nqt * bn;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::bar_init(&q_full[i], 1);
      sm90::bar_init(&q_empty[i], sm90::kConsumerWarps);
    }
    for (int s = 0; s < S; ++s) {
      sm90::bar_init(&k_full[s], 32);  // every producer lane (or its copies)
      sm90::bar_init(&v_full[s], 1);
      sm90::bar_init(&empty[s], sm90::kConsumerWarps);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: its first warp loads, the other three leave
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      int ring = 0;  // position in the K/V ring, over all items
      int j = 0;     // items of this CTA so far
      for (int item; (item = sm90::snake_item(j, items)) >= 0; ++j) {
        const sm90::QueryTile w(item, bn, nqt, sk, BQ, BK, causal);
        const int b = w.bh / n, h = w.bh % n, kvh = h / (n / g);
        const int qb = j & 1;
        sm90::bar_wait(&q_empty[qb], ((j >> 1) & 1) ^ 1);
        if (lane == 0) {
          sm90::bar_arrive_tx(&q_full[qb], C::QT::BYTES);
          sm90::tma_tile<D, BQ>(smem + C::q_off + qb * C::QT::BYTES, &tq,
                                &q_full[qb], h, w.q0, b);
        }
        // the live key tiles, in order (the consumers walk the same ones)
        const SegSpan qspan = kExt && ex.seg != nullptr
                                  ? seg_span(ex, b, sq, w.q0, w.q0 + BQ)
                                  : SegSpan{0, 0, 0};
        auto next_live = [&](int t) {
          if constexpr (!kExt) return t;  // no segment ids: every tile
          if (ex.seg == nullptr) return t;
          while (t < w.ntiles &&
                 !seg_meet(qspan, seg_span(ex, b, sq, t * BK, t * BK + BK)))
            ++t;
          return t;
        };
        int t0 = next_live(0);
        if (t0 >= w.ntiles) t0 = 0;  // none live: tile 0, wholly masked
        for (int t = t0; t < w.ntiles; t = next_live(t + 1), ++ring) {
          const int s = ring % S;
          const int k0 = t * BK;
          sm90::bar_wait(&empty[s], ((ring / S) & 1) ^ 1);
          if (lane == 0) {
            sm90::bar_expect_tx(&k_full[s], C::KT::BYTES);
            sm90::tma_tile<D, BK>(smem + C::k_off + s * C::KT::BYTES, &tk,
                                  &k_full[s], kvh, k0, b);
            sm90::bar_arrive_tx(&v_full[s], C::KT::BYTES);
            sm90::tma_tile<D, BK>(smem + C::v_off + s * C::KT::BYTES, &tv,
                                  &v_full[s], kvh, k0, b);
          }
          if (kpm != nullptr) {
            for (int c = lane; c < BK; c += 32) {
              const bool in = k0 + c < sk;
              sm90::cp_async4(&skpm[s * BK + c],
                              kpm + (size_t)b * sk + (in ? k0 + c : 0), in);
            }
            sm90::cp_async_arrive(&k_full[s]);
          } else {
            sm90::bar_arrive(&k_full[s]);
          }
        }
      }
    }
  } else {
    sm90::reg_alloc<sm90::kConsumerRegs>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const float sl2 = scale * sm90::kLog2e;
    int ring = 0;  // ring position of this item's first key tile
    int j = 0;
    if (wg == 1) sm90::turn_end(wg);  // warpgroup 0 issues first
    for (int item; (item = sm90::snake_item(j, items)) >= 0; ++j) {
      const sm90::QueryTile w(item, bn, nqt, sk, BQ, BK, causal);
      const int bh = w.bh, b = bh / n, h = bh % n;
      const int ntiles = w.ntiles;
      const int wg_row = w.q0 + wg * 64;
      const int row0 = wg_row + warp * 16 + (lane >> 2);  // and row0 + 8
      const int qb = j & 1;
      const uint32_t sQ = sm90::smem_addr(smem + C::q_off + qb * C::QT::BYTES);
      // the query tile's ids (segment ids only)
      const SegSpan qspan = kExt && ex.seg != nullptr
                                ? seg_span(ex, b, sq, w.q0, w.q0 + BQ)
                                : SegSpan{0, 0, 0};
      auto next_live = [&](int t) {
        if constexpr (!kExt) return t;  // no segment ids: every tile
        if (ex.seg == nullptr) return warp_uniform(t);
        while (t < ntiles &&
               !seg_meet(qspan, seg_span(ex, b, sq, t * BK, t * BK + BK)))
          ++t;
        return warp_uniform(t);
      };
      float acc_o[D / 2];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) acc_o[r] = 0.0f;
      float m_i[2] = {APEX_NEG_INF, APEX_NEG_INF};
      float l_i[2] = {0.0f, 0.0f};  // this lane's share of the row sums
      float alpha[2];
      uint32_t pa[BK / 16][4];  // the previous tile's p, rounded to V's dtype
      uint32_t qf[kQRegs ? D / 16 : 1][4];  // Q as the A operand of S

      // S = Q K^T of the u-th live key tile into acc, issued and committed,
      // not waited
      auto issue_s = [&](float (&acc)[BK / 2], int u) {
        const int r = ring + u;
        const uint32_t sK =
            sm90::smem_addr(smem + C::k_off + (r % S) * C::KT::BYTES);
        sm90::bar_wait(&k_full[r % S], (r / S) & 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          if constexpr (kQRegs)
            sm90::mma_rs<T, BK, 0>(acc, qf[kk],
                                   sm90::desc_k<D, BK>(sK, 0, kk), kk > 0);
          else
            sm90::mma_ss<T, BK, 0>(acc, sm90::desc_k<D, BQ>(sQ, wg * 64, kk),
                                   sm90::desc_k<D, BK>(sK, 0, kk), kk > 0);
        }
        sm90::mma_commit();
      };
      // O += P V of the u-th live key tile (P in pa), issued and committed
      auto issue_pv = [&](int u) {
        const int r = ring + u;
        const uint32_t sV =
            sm90::smem_addr(smem + C::v_off + (r % S) * C::KT::BYTES);
        sm90::bar_wait(&v_full[r % S], (r / S) & 1);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          sm90::mma_rs<T, D, 1>(acc_o, pa[kk], sm90::desc_mn<D, BK>(sV, kk),
                                1);
        sm90::mma_commit();
      };
      auto release = [&](uint64_t* bar) {
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(bar);
      };
      // scale, padding row and masks of key tile t (the u-th live one),
      // then its probabilities in place, dropped under dropout; folds the
      // row maxima into m_i, the un-dropped row sums into l_i and sets alpha.
      float acc_s[BK / 2];  // S of the tile in flight, then its p
      auto softmax = [&](int t, int u) {
        float(&acc)[BK / 2] = acc_s;
        const int k0 = t * BK;
        // segment ids: a tile whose rows and keys all hold one id is open
        // throughout; others test each element
        bool seg_test = false;
        int qs[2] = {0, 0};  // this thread's two rows' segment ids
        if constexpr (kExt) {
          if (ex.seg != nullptr) {
            seg_test = !seg_inside(qspan, seg_span(ex, b, sq, k0, k0 + BK));
            qs[0] = seg_at(ex, b, sq, row0);
            qs[1] = seg_at(ex, b, sq, row0 + 8);
          }
        }
        const float* kp = skpm + ((ring + u) % S) * BK + 2 * (lane & 3);
        const bool edge =
            k0 + BK > sk || (causal && k0 + BK - 1 > wg_row) || seg_test;
        // inner tiles without padding: the raw maxima scaled once, and p
        // in one FMA and one exp2 per score
        const bool plain = !edge && kpm == nullptr && sl2 > 0.0f;
        float mx[2] = {APEX_NEG_INF, APEX_NEG_INF};
        if (plain) {
#pragma unroll
          for (int r = 0; r < BK / 2; ++r)
            mx[sm90::frag_row(r)] = fmaxf(mx[sm90::frag_row(r)], acc[r]);
          mx[0] *= sl2;
          mx[1] *= sl2;
        } else {
#pragma unroll
          for (int cc = 0; cc < BK / 8; ++cc) {
            float2 kv = make_float2(0.0f, 0.0f);
            if (kpm != nullptr) {
              kv = *reinterpret_cast<const float2*>(kp + 8 * cc);
              kv.x *= sm90::kLog2e;
              kv.y *= sm90::kLog2e;
            }
            // the segment ids of this thread's two columns
            int ks[2] = {0, 0};
            if constexpr (kExt) {
              if (seg_test) {
                const int c0 = k0 + sm90::frag_col(4 * cc, lane);
                ks[0] = seg_at(ex, b, sk, c0);
                ks[1] = seg_at(ex, b, sk, c0 + 1);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 4 * cc + e;
              const int i = sm90::frag_row(r);
              float v = acc[r] * sl2 + ((e & 1) ? kv.y : kv.x);
              if (edge) {
                const int col = k0 + sm90::frag_col(r, lane);
                if (col >= sk || (causal && col > row0 + 8 * i))
                  v = APEX_NEG_INF;
                if constexpr (kExt) {
                  if (seg_test && !seg_open(qs[i], ks[e & 1]))
                    v = APEX_NEG_INF;
                }
              }
              acc[r] = v;
              mx[i] = fmaxf(mx[i], v);
            }
          }
        }
        bool live[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m_i[i], sm90::quad_max(mx[i]));
          live[i] = m_new > APEX_NEG_INF / 2;
          alpha[i] = live[i] ? sm90::ex2(m_i[i] - m_new) : 0.0f;
          m_i[i] = m_new;
          l_i[i] *= alpha[i];
        }
        // acc (scaled or not) minus m, to the power of 2; l sums the fp32 p
        const float a = plain ? sl2 : 1.0f;
#pragma unroll
        for (int r = 0; r < BK / 2; ++r) {
          const int i = sm90::frag_row(r);
          const float p = live[i] ? sm90::ex2(fmaf(acc[r], a, -m_i[i])) : 0.0f;
          l_i[i] += p;
          acc[r] = p;
        }
        if constexpr (kExt) {
          const Dropout drop(ex);
          if (drop.on) {
            // the accumulator takes keep ? p / (1 - p) : 0
#pragma unroll
            for (int r = 0; r < BK / 2; ++r)
              acc[r] = drop.apply(acc[r], bh, row0 + 8 * sm90::frag_row(r),
                                  k0 + sm90::frag_col(r, lane));
          }
        }
      };

      // Software pipeline: key tile t's S = Q K^T runs while tile t-1's
      // O += P V runs, and tile t's softmax overlaps the latter.  The
      // warpgroups take turns to issue their products (sm90::turn_begin),
      // so one's products overlap the other's softmax.
      sm90::bar_wait(&q_full[qb], (j >> 1) & 1);
      if constexpr (kQRegs) {
        sm90::load_a_frags<D, BQ>(sQ, wg * 64, qf);
        release(&q_empty[qb]);  // Q is in registers: the next one may come
      }
      // the live key tiles, as the producer walks them (all of them
      // without segment ids: u == t)
      int t = next_live(0);
      if (t >= ntiles) t = 0;  // none live: tile 0, wholly masked
      {
        sm90::turn_begin(wg);
        sm90::mma_fence();
        issue_s(acc_s, 0);
        sm90::turn_end(wg);
        sm90::mma_wait<0>();
        sm90::fence_regs(acc_s);
        softmax(t, 0);
        sm90::to_a_frags<T>(acc_s, pa);
      }
      int u = 1;  // live tiles so far
      for (t = next_live(t + 1); t < ntiles; t = next_live(t + 1), ++u) {
        sm90::turn_begin(wg);
        sm90::mma_fence();
        issue_s(acc_s, u);
        issue_pv(u - 1);
        sm90::turn_end(wg);
        sm90::mma_wait<1>();  // S of tile t
        sm90::fence_regs(acc_s);
        softmax(t, u);
        sm90::mma_wait<0>();  // P V of the previous live tile
        sm90::fence_regs(acc_o);
        release(&empty[(ring + u - 1) % S]);
#pragma unroll
        for (int r = 0; r < D / 2; ++r) acc_o[r] *= alpha[sm90::frag_row(r)];
        sm90::to_a_frags<T>(acc_s, pa);
      }
      if constexpr (!kQRegs)
        release(&q_empty[qb]);  // every S of the item is done: the next Q
      sm90::turn_begin(wg);
      sm90::mma_fence();
      issue_pv(u - 1);
      sm90::turn_end(wg);
      sm90::mma_wait<0>();
      sm90::fence_regs(acc_o);
      release(&empty[(ring + u - 1) % S]);
      ring += u;

      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float l = sm90::quad_sum(l_i[i]);
        const float safe_l = l == 0.0f ? 1.0f : l;
        inv[i] = 1.0f / safe_l;
        const int row = row0 + 8 * i;
        if (row < sq && (lane & 3) == 0)
          lse[(size_t)bh * sq + row] =
              l == 0.0f ? APEX_NEG_INF
                        : (m_i[i] + log2f(safe_l)) * sm90::kLn2;
      }
      sm90::store_rows<T>(acc_o, inv, o + ((size_t)b * sq * n + h) * dr,
                          (size_t)n * dr, row0, sq, dr);
    }
    if (wg == 0) sm90::turn_begin(wg);  // the last hand-over
  }
}

template <typename T, int D, bool kExt>
int launch_sm90(const void* q, const void* k, const void* v, const void* kpm,
                void* o, void* lse, int b, int sq, int sk, int n, int g,
                int dr, float scale, int causal, const FlashExtras& ex,
                cudaStream_t stream) {
  using C = Fwd<D>;
  CUtensorMap tq, tk, tv;
  int err = sm90::encode_bsnd<T>(&tq, q, b, sq, n, dr, C::BQ);
  if (err == 0) err = sm90::encode_bsnd<T>(&tk, k, b, sk, g, dr, C::BK);
  if (err == 0) err = sm90::encode_bsnd<T>(&tv, v, b, sk, g, dr, C::BK);
  if (err == 0)
    err = sm90::set_smem(flash_fwd_sm90_kernel<T, D, kExt>, C::bytes);
  int grid = 0;
  if (err == 0) err = sm90::persistent_grid((sq + C::BQ - 1) / C::BQ * b * n,
                                            &grid);
  if (err != 0) return err;
  flash_fwd_sm90_kernel<T, D, kExt><<<grid, sm90::kThreads, C::bytes,
                                      stream>>>(
      tq, tk, tv, (const float*)kpm, (T*)o, (float*)lse, b, sq, sk, n, g, dr,
      scale, causal, ex);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kpm,
           void* o, void* lse, int b, int sq, int sk, int n, int g, int dr,
           float scale, int causal, const FlashExtras& ex,
           cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return has_extras(ex)
               ? launch_sm90<T, D, true>(q, k, v, kpm, o, lse, b, sq, sk, n,
                                         g, dr, scale, causal, ex, stream)
               : launch_sm90<T, D, false>(q, k, v, kpm, o, lse, b, sq, sk, n,
                                          g, dr, scale, causal, ex, stream);
  } else {
    const dim3 grid((sq + kBQ - 1) / kBQ, b * n);
    const int bytes = smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)kpm, (T*)o,
        (float*)lse, sq, sk, n, g, dr, scale, causal, ex);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// q [b, sq, n, d], k/v [b, sk, g, d], o like q (dtype), kpm [b, sk] fp32
// additive or NULL, lse [b·n, sq] fp32.  d a multiple of 8 up to 128: the
// kernels of the next of 32, 64 and 128 (sm90::head_panel) run on tiles
// whose columns past d are zeros (TMA's fill, or guarded loads in fp32)
// and store only the first d columns.  seed ([1] int32 on the device, or
// NULL), threshold and inv_keep turn dropout on; seg ([b, s] int32, sq ==
// sk, or NULL) and seg_rng (keep_mask.cuh) the segment ids.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* kpm, void* o, void* lse, int b,
                              int sq, int sk, int n, int g, int d,
                              float scale, int causal, int dtype,
                              const void* seed, unsigned threshold,
                              float inv_keep, const void* seg,
                              const void* seg_rng, cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || g <= 0 || n % g != 0 ||
      (seg != nullptr && (seg_rng == nullptr || sq != sk)))
    return (int)cudaErrorInvalidValue;
  const FlashExtras ex = make_extras(seed, threshold, inv_keep, seg, seg_rng);
  APEX_DISPATCH_FLOAT(dtype, T, {
    switch (sm90::head_panel(d)) {
      case 32:
        return launch<T, 32>(q, k, v, kpm, o, lse, b, sq, sk, n, g, d, scale,
                             causal, ex, stream);
      case 64:
        return launch<T, 64>(q, k, v, kpm, o, lse, b, sq, sk, n, g, d, scale,
                             causal, ex, stream);
      case 128:
        return launch<T, 128>(q, k, v, kpm, o, lse, b, sq, sk, n, g, d,
                              scale, causal, ex, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}

namespace {

template <typename T, bool kExt>
int fwd_attrs(int d, int* out) {
  switch (sm90::head_panel(d)) {
    case 32:
      return sm90::kernel_attrs(flash_fwd_sm90_kernel<T, 32, kExt>,
                                Fwd<32>::bytes, sm90::kThreads, out);
    case 64:
      return sm90::kernel_attrs(flash_fwd_sm90_kernel<T, 64, kExt>,
                                Fwd<64>::bytes, sm90::kThreads, out);
    case 128:
      return sm90::kernel_attrs(flash_fwd_sm90_kernel<T, 128, kExt>,
                                Fwd<128>::bytes, sm90::kThreads, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The 16-bit kernel's {registers, shared memory per CTA, CTAs per SM,
// spill bytes} for head size d, without (ext = 0) or with (ext = 1)
// segment ids or dropout (sm90::kernel_attrs).
extern "C" int apex_flash_fwd_attrs(int dtype, int d, int ext, int* out) {
  if (dtype == APEX_BF16)
    return ext ? fwd_attrs<__nv_bfloat16, true>(d, out)
               : fwd_attrs<__nv_bfloat16, false>(d, out);
  if (dtype == APEX_F16)
    return ext ? fwd_attrs<__half, true>(d, out)
               : fwd_attrs<__half, false>(d, out);
  return (int)cudaErrorInvalidValue;
}
