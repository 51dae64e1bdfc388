// K6 and K7: flash-attention backward (BSND), causal and key padding, GQA.
//
// K6 replaces apex_tpu/ops/flash_attention.py:_bwd_dq_kernel and K7
// replaces :_bwd_dkv_kernel (both launched by _bwd_pallas, the split pair
// that _flash_bwd takes above APEX_TPU_FLASH_BWD_FUSED_MAX keys).  From
// the forward's lse [b*n, sq] and delta = rowsum(do * o) [b*n, sq] (fp32)
// each kernel recomputes the probabilities of its tiles,
//   p  = exp(s * scale + kpm - lse)   (0 where masked or lse is -1e30),
//   ds = p * (dp - delta) * scale,    dp = do v^T,
// and K6 sums dq = ds k over key tiles, K7 sums dv = p^T do and
// dk = ds^T q over query tiles.  Masks as in the forward: causal from
// row/column indices, an additive fp32 key-padding row, the key tail at
// sk, and the lse > -1e30/2 guard on fully masked rows
// (flash_attention.py:418).
//
// Grids.  The TPU kernels walk the (q-block, kv-block) plane in order and
// carry their sums in VMEM scratch across grid steps; Hopper blocks run in
// no order, so the carried axis becomes a loop inside the CTA.  K6: one
// CTA per (query tile, batch*head) looping over key tiles up to the
// diagonal.  K7: one CTA per (key tile, batch*kv-group) looping over the
// group's rep query heads and, per head, over the query tiles from the
// diagonal on; causal tiles above the diagonal are never visited.  Tiles
// are 64 rows on the fp32 path; the 16-bit kernels take 128-row output
// tiles (two warpgroups) as the work items of a persistent grid and
// stream 64-row tiles (32 for K7 at d = 128).
// Under GQA the rep heads accumulate into one dk/dv row as in
// _bwd_dkv_kernel (:464-474).  No atomics: every output tile has one
// writer, so the result is deterministic.
//
// Dropout and segment ids (keep_mask.cuh) are runtime arguments of every
// entry here, as in _bwd_dq_kernel and _bwd_dkv_kernel (the Hopper
// kernels run an instantiation of their own, kExt, when either is on): K6 drops and
// scales dp (:424-427); K7 feeds dV the dropped p and dS the dropped dp
// (:511-527); keys of another segment are masked, and tile pairs whose
// ids cannot meet are skipped (both sides walk the same live tiles).
//
// fp32 outputs (apex_flash_bwd_dq_f32, apex_flash_bwd_dkv_f32):
// _bwd_pallas(..., out_dtype=float32), the ring's chunk backward
// (apex_tpu/parallel/ring_attention.py:179), which passes the global lse
// and delta of the whole ring and sums the chunks' dq, dk and dv in fp32:
// the accumulators are stored unrounded (dk and dv GQA-summed in fp32).  The
// Hopper kernels' epilogue is a template parameter (an instantiation of its
// own), without dropout or segment ids.
//
// Numbers.  The TPU kernels keep p and ds in fp32.  Here 16-bit inputs
// run all four products on the tensor cores with fp32 accumulators, so p
// and ds are rounded to the input type before the dv, dk and dq products;
// scores, dp, lse and delta stay fp32.  fp32 inputs take the same tiles
// through a CUDA-core 16x16x16 product and round nothing.
//
// Bound on the H100 at b16 s1024 n12 d64 bf16 causal: operations.  The
// two kernels do 7 tile products per open (query, key) tile pair (K6: s,
// dp, dq; K7: s, dp, dv, dk), ~4.6 x the forward's flops, against ~50 MB
// of q, k, v, o, do and gradients.  Design: 16-bit inputs run the Hopper
// kernels below (TMA ring, wgmma with the accumulators in registers, warp
// specialisation; sm90_tile.cuh).  fp32 inputs run four warps per CTA,
// each owning 16 rows of a 64-row tile, through flash_bwd_tile.cuh: the
// input tiles in shared memory, scores and dp in fp32 shared memory (two
// lanes per row do the masked elementwise step), loaded synchronously.
#include <type_traits>

#include "flash_bwd_tile.cuh"
#include "sm90_tile.cuh"

namespace {

// K6: dq for one (64-query tile, batch*head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ kpm, T* __restrict__ dq,
                        int sq, int sk, int n, int g, int dr, float scale,
                        int causal, FlashExtras ex) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sdO = reinterpret_cast<T*>(smem + L::do_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  T* sdS = reinterpret_cast<T*>(smem + L::ds_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sL = reinterpret_cast<float*>(smem + L::l_off);
  float* sDl = reinterpret_cast<float*>(smem + L::dl_off);

  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / n, h = bh % n;
  const int kvh = h / (n / g);
  const int q0 = blockIdx.x * kB;
  const int qstride = n * dr, kstride = g * dr;
  const Dropout drop(ex);

  const size_t qbase = (((size_t)b * sq + q0) * n + h) * dr;
  load_tile<T, D>(sQ, q + qbase, q0, sq, qstride, dr);
  load_tile<T, D>(sdO, dout + qbase, q0, sq, qstride, dr);
  load_row_stats(sL, sDl, lse, delta, bh, q0, sq);

  Acc<T> acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i].zero();

  const int kv_end = causal ? min(sk, q0 + kB) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    if (!seg_tile_live(ex, b, sq, q0, kB, k0, kB)) continue;
    __syncthreads();  // the previous tile's readers of sK/sV are done
    const size_t kbase = (((size_t)b * sk + k0) * g + kvh) * dr;
    load_tile<T, D>(sK, k + kbase, k0, sk, kstride, dr);
    load_tile<T, D>(sV, v + kbase, k0, sk, kstride, dr);
    __syncthreads();
    probs_and_ds<T, D>(smem, kpm, b, sk, q0, k0, scale, causal, ex, drop,
                       bh);
    // dq[16 x D] += ds[16 x 64] k[64 x D]
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb)
#pragma unroll
      for (int kk = 0; kk < kB / 16; ++kk)
        mma16<true, true>(acc[nb], sdS + warp * 16 * L::LDP + kk * 16,
                          L::LDP, sK + kk * 16 * L::LDT + nb * 16, L::LDT);
  }

  float* stage = sS + warp * 16 * L::LDS;
  T* out = dq + (((size_t)b * sq) * n + h) * dr;
#pragma unroll
  for (int nb = 0; nb < D / 16; ++nb)
    store_acc<T>(acc[nb], stage, L::LDS, out, q0 + warp * 16, sq,
                 (size_t)qstride, nb * 16, dr);
}

// K7: dk and dv for one (64-key tile, batch*kv-group), summed over the
// group's rep query heads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ kpm, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int sk, int n, int g,
                         int dr, float scale, int causal, FlashExtras ex) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sdO = reinterpret_cast<T*>(smem + L::do_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  T* sdS = reinterpret_cast<T*>(smem + L::ds_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sL = reinterpret_cast<float*>(smem + L::l_off);
  float* sDl = reinterpret_cast<float*>(smem + L::dl_off);

  const int warp = threadIdx.x >> 5;
  const int bg = blockIdx.y;
  const int b = bg / g, kvh = bg % g;
  const int rep = n / g;
  const int k0 = blockIdx.x * kB;
  const int qstride = n * dr, kstride = g * dr;
  const Dropout drop(ex);

  const size_t kbase = (((size_t)b * sk + k0) * g + kvh) * dr;
  load_tile<T, D>(sK, k + kbase, k0, sk, kstride, dr);
  load_tile<T, D>(sV, v + kbase, k0, sk, kstride, dr);

  Acc<T> dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    dk_acc[i].zero();
    dv_acc[i].zero();
  }

  // causal: query tiles wholly above this key tile's first column add 0
  const int q_begin = causal ? k0 : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const int bh = b * n + h;
    for (int q0 = q_begin; q0 < sq; q0 += kB) {
      if (!seg_tile_live(ex, b, sq, q0, kB, k0, kB)) continue;
      __syncthreads();  // the previous tile's readers are done
      const size_t qbase = (((size_t)b * sq + q0) * n + h) * dr;
      load_tile<T, D>(sQ, q + qbase, q0, sq, qstride, dr);
      load_tile<T, D>(sdO, dout + qbase, q0, sq, qstride, dr);
      load_row_stats(sL, sDl, lse, delta, bh, q0, sq);
      __syncthreads();
      probs_and_ds<T, D>(smem, kpm, b, sk, q0, k0, scale, causal, ex, drop,
                         bh);
      __syncthreads();  // p and ds of every query row are in place
      // dv[16 x D] += p^T[16 x 64] do[64 x D]; dk likewise with ds and q
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb)
#pragma unroll
        for (int kk = 0; kk < kB / 16; ++kk) {
          mma16<false, true>(dv_acc[nb], sP + kk * 16 * L::LDP + warp * 16,
                             L::LDP, sdO + kk * 16 * L::LDT + nb * 16,
                             L::LDT);
          mma16<false, true>(dk_acc[nb], sdS + kk * 16 * L::LDP + warp * 16,
                             L::LDP, sQ + kk * 16 * L::LDT + nb * 16,
                             L::LDT);
        }
    }
  }

  __syncthreads();  // every warp is done with sS before it becomes staging
  float* stage = sS + warp * 16 * L::LDS;
  const size_t off = (((size_t)b * sk) * g + kvh) * dr;
#pragma unroll
  for (int nb = 0; nb < D / 16; ++nb) {
    store_acc<T>(dk_acc[nb], stage, L::LDS, dk + off, k0 + warp * 16, sk,
                 (size_t)kstride, nb * 16, dr);
    store_acc<T>(dv_acc[nb], stage, L::LDS, dv + off, k0 + warp * 16, sk,
                 (size_t)kstride, nb * 16, dr);
  }
}

// ---------------------------------------------------------------------------
// 16-bit inputs: the Hopper kernels, persistent: one CTA of 384 threads
// per SM walks its work items, longest first, dealt out in a snake.  Two
// consumer warpgroups own 64 rows each; a producer warp issues the TMA
// loads (each item's stationary operands into one of two buffers, the
// streamed tiles into a ring freed by the eight consumer warps) and
// copies the small rows the tiles need beside them.  Every product is a
// wgmma with fp32 accumulators in registers; p and ds are formed on the
// accumulator fragments and, rounded to T, become the register A operand
// of the next product.  Up to d = 64 the stationary operands (Q and dO
// for K6, K and V for K7) are read once into registers as A operands.
// The warpgroups take turns to issue their products.  Scores are carried
// in log2 units (exp2).
// ---------------------------------------------------------------------------

// K6: dq for (128-query tile, b*n) work items.  Q and dO are loaded once
// an item; K, V and the key tile's padding row arrive by the ring.
// S = Q K^T and dP = dO V^T (B operands in shared memory), then
// dQ += dS K with dS in registers and K read transposed; dQ stays in
// registers.
template <int D>
struct BwdDq {
  static constexpr int BQ = 128;
  static constexpr int BK = 64;
  static constexpr int STAGES = D == 128 ? 2 : 4;
  using QT = sm90::Tile<D, BQ>;
  using KT = sm90::Tile<D, BK>;
  // two (Q, dO) buffers: this item's and the next
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + 2 * QT::BYTES;
  static constexpr int k_off = do_off + 2 * QT::BYTES;
  static constexpr int v_off = k_off + STAGES * KT::BYTES;
  static constexpr int kpm_off = v_off + STAGES * KT::BYTES;
  static constexpr int bar_off = kpm_off + STAGES * BK * 4;
  // qdo_full[2], qdo_empty[2], full[S], empty[S]; 1024 bytes of alignment
  // slack
  static constexpr int bytes = bar_off + (4 + 2 * STAGES) * 8 + 1024;
};

template <typename T, int D, bool kExt, typename TO = T>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ kpm,
                             TO* __restrict__ dq, int nb, int sq, int sk,
                             int n, int g, int dr, float scale, int causal,
                             FlashExtras ex) {
  using C = BwdDq<D>;
  constexpr int BQ = C::BQ, BK = C::BK, S = C::STAGES;
  constexpr bool kRegs = sm90::kStationaryInRegs<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* qdo_empty = qdo_full + 2;
  uint64_t* full = qdo_empty + 2;
  uint64_t* empty = full + S;
  float* skpm = reinterpret_cast<float*>(smem + C::kpm_off);

  const int bn = nb * n;
  const int nqt = (sq + BQ - 1) / BQ;
  const int items = nqt * bn;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::bar_init(&qdo_full[i], 1);
      sm90::bar_init(&qdo_empty[i], sm90::kConsumerWarps);
    }
    for (int s = 0; s < S; ++s) {
      sm90::bar_init(&full[s], 32);  // every producer lane (or its copies)
      sm90::bar_init(&empty[s], sm90::kConsumerWarps);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      int ring = 0, j = 0;
      for (int item; (item = sm90::snake_item(j, items)) >= 0; ++j) {
        const sm90::QueryTile w(item, bn, nqt, sk, BQ, BK, causal);
        const int b = w.bh / n, h = w.bh % n, kvh = h / (n / g);
        const int qb = j & 1;
        sm90::bar_wait(&qdo_empty[qb], ((j >> 1) & 1) ^ 1);
        if (lane == 0) {
          sm90::bar_arrive_tx(&qdo_full[qb], 2 * C::QT::BYTES);
          sm90::tma_tile<D, BQ>(smem + C::q_off + qb * C::QT::BYTES, &tq,
                                &qdo_full[qb], h, w.q0, b);
          sm90::tma_tile<D, BQ>(smem + C::do_off + qb * C::QT::BYTES, &tdo,
                                &qdo_full[qb], h, w.q0, b);
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
            sm90::bar_expect_tx(&full[s], 2 * C::KT::BYTES);
            sm90::tma_tile<D, BK>(smem + C::k_off + s * C::KT::BYTES, &tk,
                                  &full[s], kvh, k0, b);
            sm90::tma_tile<D, BK>(smem + C::v_off + s * C::KT::BYTES, &tv,
                                  &full[s], kvh, k0, b);
          }
          if (kpm != nullptr) {
            for (int c = lane; c < BK; c += 32) {
              const bool in = k0 + c < sk;
              sm90::cp_async4(&skpm[s * BK + c],
                              kpm + (size_t)b * sk + (in ? k0 + c : 0), in);
            }
            sm90::cp_async_arrive(&full[s]);
          } else {
            sm90::bar_arrive(&full[s]);
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
    int ring = 0, j = 0;
    if (wg == 1) sm90::turn_end(wg);  // warpgroup 0 issues first
    for (int item; (item = sm90::snake_item(j, items)) >= 0; ++j) {
      const sm90::QueryTile w(item, bn, nqt, sk, BQ, BK, causal);
      const int bh = w.bh, b = bh / n, h = bh % n;
      const int ntiles = w.ntiles;
      const int wg_row = w.q0 + wg * 64;
      const int row0 = wg_row + warp * 16 + (lane >> 2);  // and row0 + 8
      const int qb = j & 1;
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
      // -lse in log2 units (-1e30 on fully masked rows and rows past sq,
      // so that their p is exp2(-1e30) = 0) and delta * scale
      float nl[2], dls[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        const float l = row < sq ? lse[(size_t)bh * sq + row] : APEX_NEG_INF;
        nl[i] = l > APEX_NEG_INF / 2 ? -l * sm90::kLog2e : APEX_NEG_INF;
        dls[i] = row < sq ? delta[(size_t)bh * sq + row] * scale : 0.0f;
      }
      const uint32_t sQ =
          sm90::smem_addr(smem + C::q_off + qb * C::QT::BYTES);
      const uint32_t sdO =
          sm90::smem_addr(smem + C::do_off + qb * C::QT::BYTES);
      float acc_dq[D / 2];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) acc_dq[r] = 0.0f;
      // Q and dO as the A operands of S and dP
      uint32_t qf[kRegs ? D / 16 : 1][4], dof[kRegs ? D / 16 : 1][4];

      // S = Q K^T and dP = dO V^T of the u-th live key tile, issued and
      // committed
      auto issue_s_dp = [&](float (&s_acc)[BK / 2],
                            float (&dp_acc)[BK / 2], int u) {
        const int s = (ring + u) % S;
        const uint32_t sK =
            sm90::smem_addr(smem + C::k_off + s * C::KT::BYTES);
        const uint32_t sV =
            sm90::smem_addr(smem + C::v_off + s * C::KT::BYTES);
        sm90::bar_wait(&full[s], ((ring + u) / S) & 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          if constexpr (kRegs) {
            sm90::mma_rs<T, BK, 0>(s_acc, qf[kk],
                                   sm90::desc_k<D, BK>(sK, 0, kk), kk > 0);
            sm90::mma_rs<T, BK, 0>(dp_acc, dof[kk],
                                   sm90::desc_k<D, BK>(sV, 0, kk), kk > 0);
          } else {
            sm90::mma_ss<T, BK, 0>(s_acc,
                                   sm90::desc_k<D, BQ>(sQ, wg * 64, kk),
                                   sm90::desc_k<D, BK>(sK, 0, kk), kk > 0);
            sm90::mma_ss<T, BK, 0>(dp_acc,
                                   sm90::desc_k<D, BQ>(sdO, wg * 64, kk),
                                   sm90::desc_k<D, BK>(sV, 0, kk), kk > 0);
          }
        }
        sm90::mma_commit();
      };

      // The warpgroups take turns (sm90::turn_begin): one issues this
      // tile's dQ product and the next tile's S and dP while the other
      // forms its p and ds.
      float acc_s[BK / 2], acc_dp[BK / 2];
      sm90::bar_wait(&qdo_full[qb], (j >> 1) & 1);
      if constexpr (kRegs) {
        sm90::load_a_frags<D, BQ>(sQ, wg * 64, qf);
        sm90::load_a_frags<D, BQ>(sdO, wg * 64, dof);
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(&qdo_empty[qb]);
      }
      // the live key tiles, as the producer walks them (all of them
      // without segment ids: u == t)
      int t = next_live(0);
      if (t >= ntiles) t = 0;  // none live: tile 0, wholly masked
      sm90::turn_begin(wg);
      sm90::mma_fence();
      issue_s_dp(acc_s, acc_dp, 0);
      sm90::turn_end(wg);
      sm90::mma_wait<0>();
      sm90::fence_regs(acc_s);
      sm90::fence_regs(acc_dp);
      int u = 0;  // live tiles consumed
      while (t < ntiles) {
        const int s = (ring + u) % S;
        const int k0 = t * BK;
        const int t_next = next_live(t + 1);

        // p = exp(s * scale + kpm - lse), ds = p * (dp - delta) * scale,
        // packed into A fragments pair by pair; masked scores get -1e30;
        // under dropout dp is dropped and scaled first
        const float* kp = skpm + s * BK + 2 * (lane & 3);
        const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > wg_row);
        uint32_t da[BK / 16][4];  // ds rounded to T
        auto form_ds = [&](auto with_kpm) {
          constexpr bool kKpm = decltype(with_kpm)::value;
          // segment ids: a tile whose rows and keys all hold one id is
          // open throughout; others test each element
          bool seg_test = false;
          int qs[2] = {0, 0};  // this thread's two rows' segment ids
          if constexpr (kExt) {
            if (ex.seg != nullptr) {
              seg_test = !seg_inside(qspan, seg_span(ex, b, sq, k0, k0 + BK));
              qs[0] = seg_at(ex, b, sq, row0);
              qs[1] = seg_at(ex, b, sq, row0 + 8);
            }
          }
          const bool masked = edge || seg_test;
          const Dropout drop(ex);
#pragma unroll
          for (int cc = 0; cc < BK / 8; ++cc) {
            float2 kv = make_float2(0.0f, 0.0f);
            if constexpr (kKpm) {
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
            for (int i = 0; i < 2; ++i) {
              float ds[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = 4 * cc + 2 * i + e;
                float x = fmaf(acc_s[r], sl2, nl[i]);
                if constexpr (kKpm) x += e ? kv.y : kv.x;
                if (masked) {
                  const int col = k0 + sm90::frag_col(r, lane);
                  if (col >= sk || (causal && col > row0 + 8 * i))
                    x = APEX_NEG_INF;
                  if constexpr (kExt) {
                    if (seg_test && !seg_open(qs[i], ks[e]))
                      x = APEX_NEG_INF;
                  }
                }
                float dpv = acc_dp[r];
                if constexpr (kExt) {
                  if (drop.on)
                    dpv = drop.apply(dpv, bh, row0 + 8 * i,
                                     k0 + sm90::frag_col(r, lane));
                }
                ds[e] = sm90::ex2(x) * fmaf(dpv, scale, -dls[i]);
              }
              da[cc / 2][2 * (cc % 2) + i] = sm90::pack2<T>(ds[0], ds[1]);
            }
          }
        };
        if (kpm != nullptr)
          form_ds(std::true_type{});
        else
          form_ds(std::false_type{});

        const uint32_t sK =
            sm90::smem_addr(smem + C::k_off + s * C::KT::BYTES);
        sm90::turn_begin(wg);
        sm90::mma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          sm90::mma_rs<T, D, 1>(acc_dq, da[kk],
                                sm90::desc_mn<D, BK>(sK, kk), 1);
        sm90::mma_commit();
        if (t_next < ntiles) issue_s_dp(acc_s, acc_dp, u + 1);
        sm90::turn_end(wg);
        sm90::mma_wait<0>();
        sm90::fence_regs(acc_dq);
        sm90::fence_regs(acc_s);
        sm90::fence_regs(acc_dp);
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(&empty[s]);
        ++u;
        t = t_next;
      }
      if constexpr (!kRegs) {
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(&qdo_empty[qb]);
      }
      ring += u;
      const float one[2] = {1.0f, 1.0f};
      sm90::store_rows<TO>(acc_dq, one, dq + ((size_t)b * sq * n + h) * dr,
                          (size_t)n * dr, row0, sq, dr);
    }
    if (wg == 0) sm90::turn_begin(wg);  // the last hand-over
  }
}

// K7: dk and dv for (128-key tile, b*g) work items, summed over the
// group's rep query heads.  K and V are loaded once an item; Q, dO and
// the query tile's lse and delta rows arrive by the ring, over the rep
// heads and, per head, the query tiles from the diagonal on.  The
// products run transposed, S^T = K Q^T and dP^T = V dO^T, so that
// dV += P^T dO and dK += dS^T Q (P^T and dS^T the register A operands,
// dO and Q read transposed) keep dK and dV in registers keyed by key row.
template <int D>
struct BwdDkv {
  static constexpr int BK = 128;
  static constexpr int BQ = D == 128 ? 32 : 64;
  static constexpr int STAGES = 4;
  using KT = sm90::Tile<D, BK>;
  using QT = sm90::Tile<D, BQ>;
  // two (K, V) buffers: this item's and the next
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + 2 * KT::BYTES;
  static constexpr int q_off = v_off + 2 * KT::BYTES;
  static constexpr int do_off = q_off + STAGES * QT::BYTES;
  static constexpr int lse_off = do_off + STAGES * QT::BYTES;
  static constexpr int dl_off = lse_off + STAGES * BQ * 4;
  static constexpr int bar_off = dl_off + STAGES * BQ * 4;
  // kv_full[2], kv_empty[2], full[S], empty[S]; 1024 bytes of alignment
  // slack
  static constexpr int bytes = bar_off + (4 + 2 * STAGES) * 8 + 1024;
};

// One K7 work item: a (128-key tile, b*g) pair, the key tiles in order
// (causal: the first ones see the most query tiles).
struct DkvItem {
  int bg, k0, q_begin, nqt, ntiles;
  __device__ DkvItem(int item, int bgn, int sq, int rep, int bq, int bk,
                     int causal) {
    bg = item % bgn;
    k0 = (item / bgn) * bk;
    // causal: query tiles wholly above this key tile's first row add 0
    q_begin = causal ? k0 : 0;
    nqt = q_begin < sq ? (sq - q_begin + bq - 1) / bq : 0;
    ntiles = rep * nqt;
  }
};

template <typename T, int D, bool kExt, typename TO = T>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const float* __restrict__ kpm,
                              TO* __restrict__ dk, TO* __restrict__ dv,
                              int nb,
                              int sq, int sk, int n, int g, int dr,
                              float scale, int causal, FlashExtras ex) {
  using C = BwdDkv<D>;
  constexpr int BQ = C::BQ, BK = C::BK, S = C::STAGES;
  constexpr bool kRegs = sm90::kStationaryInRegs<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + S;
  float* slse = reinterpret_cast<float*>(smem + C::lse_off);
  float* sdl = reinterpret_cast<float*>(smem + C::dl_off);

  const int rep = n / g;
  const int bgn = nb * g;
  const int items = (sk + BK - 1) / BK * bgn;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::bar_init(&kv_full[i], 1);
      sm90::bar_init(&kv_empty[i], sm90::kConsumerWarps);
    }
    for (int s = 0; s < S; ++s) {
      sm90::bar_init(&full[s], 32);  // every producer lane's copies
      sm90::bar_init(&empty[s], sm90::kConsumerWarps);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      int ring = 0, j = 0;
      for (int item; (item = sm90::snake_item(j, items)) >= 0; ++j) {
        const DkvItem w(item, bgn, sq, rep, BQ, BK, causal);
        const int b = w.bg / g, kvh = w.bg % g;
        const int kb = j & 1;
        sm90::bar_wait(&kv_empty[kb], ((j >> 1) & 1) ^ 1);
        if (lane == 0) {
          sm90::bar_arrive_tx(&kv_full[kb], 2 * C::KT::BYTES);
          sm90::tma_tile<D, BK>(smem + C::k_off + kb * C::KT::BYTES, &tk,
                                &kv_full[kb], kvh, w.k0, b);
          sm90::tma_tile<D, BK>(smem + C::v_off + kb * C::KT::BYTES, &tv,
                                &kv_full[kb], kvh, w.k0, b);
        }
        // the live (head, query tile) tiles, in order (the consumers walk
        // the same ones); none may be live
        const SegSpan kspan = kExt && ex.seg != nullptr
                                  ? seg_span(ex, b, sk, w.k0, w.k0 + BK)
                                  : SegSpan{0, 0, 0};
        auto next_live = [&](int t) {
          if constexpr (!kExt) return t;  // no segment ids: every tile
          if (ex.seg == nullptr) return t;
          while (t < w.ntiles) {
            const int q0 = w.q_begin + (t % w.nqt) * BQ;
            if (seg_meet(seg_span(ex, b, sq, q0, q0 + BQ), kspan)) break;
            ++t;
          }
          return t;
        };
        for (int t = next_live(0); t < w.ntiles;
             t = next_live(t + 1), ++ring) {
          const int s = ring % S;
          const int h = kvh * rep + t / w.nqt;
          const int q0 = w.q_begin + (t % w.nqt) * BQ;
          const size_t bh = (size_t)b * n + h;
          sm90::bar_wait(&empty[s], ((ring / S) & 1) ^ 1);
          if (lane == 0) {
            sm90::bar_expect_tx(&full[s], 2 * C::QT::BYTES);
            sm90::tma_tile<D, BQ>(smem + C::q_off + s * C::QT::BYTES, &tq,
                                  &full[s], h, q0, b);
            sm90::tma_tile<D, BQ>(smem + C::do_off + s * C::QT::BYTES, &tdo,
                                  &full[s], h, q0, b);
          }
          // rows past sq read 0: their Q and dO rows are 0 too, so their
          // p is 1 and every product they enter adds 0
          for (int c = lane; c < BQ; c += 32) {
            const int row = q0 + c;
            const bool in = row < sq;
            const size_t at = bh * sq + (in ? row : 0);
            sm90::cp_async4(&slse[s * BQ + c], lse + at, in);
            sm90::cp_async4(&sdl[s * BQ + c], delta + at, in);
          }
          sm90::cp_async_arrive(&full[s]);
        }
      }
    }
  } else {
    sm90::reg_alloc<sm90::kConsumerRegs>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const float sl2 = scale * sm90::kLog2e;
    int ring = 0, j = 0;
    if (wg == 1) sm90::turn_end(wg);  // warpgroup 0 issues first
    for (int item; (item = sm90::snake_item(j, items)) >= 0; ++j) {
      const DkvItem w(item, bgn, sq, rep, BQ, BK, causal);
      const int b = w.bg / g, kvh = w.bg % g;
      const int ntiles = w.ntiles;
      const int wg_key = w.k0 + wg * 64;
      const int key0 = wg_key + warp * 16 + (lane >> 2);  // and key0 + 8
      const int kb = j & 1;
      // the key tile's ids (segment ids only)
      const SegSpan kspan = kExt && ex.seg != nullptr
                                ? seg_span(ex, b, sk, w.k0, w.k0 + BK)
                                : SegSpan{0, 0, 0};
      auto next_live = [&](int t) {
        if constexpr (!kExt) return t;  // no segment ids: every tile
        if (ex.seg == nullptr) return warp_uniform(t);
        while (t < ntiles) {
          const int q0 = w.q_begin + (t % w.nqt) * BQ;
          if (seg_meet(seg_span(ex, b, sq, q0, q0 + BQ), kspan)) break;
          ++t;
        }
        return warp_uniform(t);
      };
      float kp2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * i;
        kp2[i] = kpm != nullptr && key < sk
                     ? kpm[(size_t)b * sk + key] * sm90::kLog2e
                     : 0.0f;
      }
      const uint32_t sK =
          sm90::smem_addr(smem + C::k_off + kb * C::KT::BYTES);
      const uint32_t sV =
          sm90::smem_addr(smem + C::v_off + kb * C::KT::BYTES);
      float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) {
        acc_dk[r] = 0.0f;
        acc_dv[r] = 0.0f;
      }
      // K and V as the A operands of S^T and dP^T
      uint32_t kf[kRegs ? D / 16 : 1][4], vf[kRegs ? D / 16 : 1][4];

      // S^T = K Q^T and dP^T = V dO^T of the u-th live query tile, issued,
      // committed
      auto issue_s_dp = [&](float (&s_acc)[BQ / 2],
                            float (&dp_acc)[BQ / 2], int u) {
        const int s = (ring + u) % S;
        const uint32_t sQ =
            sm90::smem_addr(smem + C::q_off + s * C::QT::BYTES);
        const uint32_t sdO =
            sm90::smem_addr(smem + C::do_off + s * C::QT::BYTES);
        sm90::bar_wait(&full[s], ((ring + u) / S) & 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          if constexpr (kRegs) {
            sm90::mma_rs<T, BQ, 0>(s_acc, kf[kk],
                                   sm90::desc_k<D, BQ>(sQ, 0, kk), kk > 0);
            sm90::mma_rs<T, BQ, 0>(dp_acc, vf[kk],
                                   sm90::desc_k<D, BQ>(sdO, 0, kk), kk > 0);
          } else {
            sm90::mma_ss<T, BQ, 0>(s_acc,
                                   sm90::desc_k<D, BK>(sK, wg * 64, kk),
                                   sm90::desc_k<D, BQ>(sQ, 0, kk), kk > 0);
            sm90::mma_ss<T, BQ, 0>(dp_acc,
                                   sm90::desc_k<D, BK>(sV, wg * 64, kk),
                                   sm90::desc_k<D, BQ>(sdO, 0, kk), kk > 0);
          }
        }
        sm90::mma_commit();
      };

      // The warpgroups take turns (sm90::turn_begin): one issues this
      // tile's dV and dK products and the next tile's S^T and dP^T while
      // the other forms its p^T and ds^T.
      float acc_s[BQ / 2], acc_dp[BQ / 2];
      sm90::bar_wait(&kv_full[kb], (j >> 1) & 1);
      if constexpr (kRegs) {
        sm90::load_a_frags<D, BK>(sK, wg * 64, kf);
        sm90::load_a_frags<D, BK>(sV, wg * 64, vf);
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(&kv_empty[kb]);
      }
      // the live tiles, as the producer walks them (all of them without
      // segment ids: u == t)
      int t = next_live(0);
      sm90::turn_begin(wg);
      if (t < ntiles) {
        sm90::mma_fence();
        issue_s_dp(acc_s, acc_dp, 0);
      }
      sm90::turn_end(wg);
      sm90::mma_wait<0>();
      sm90::fence_regs(acc_s);
      sm90::fence_regs(acc_dp);
      int u = 0;  // live tiles consumed
      while (t < ntiles) {
        const int s = (ring + u) % S;
        const int q0 = w.q_begin + (t % w.nqt) * BQ;
        const int bh = b * n + kvh * rep + t / w.nqt;
        const int t_next = next_live(t + 1);

        // p^T and ds^T (rows are keys, columns queries), packed into A
        // fragments pair by pair; masked scores get -1e30; under dropout
        // dV's p and ds's dp are dropped and scaled
        const float* sl = slse + s * BQ + 2 * (lane & 3);
        const float* sd = sdl + s * BQ + 2 * (lane & 3);
        const bool edge = causal && wg_key + 63 > q0;
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // p^T, ds^T rounded to T
        auto form_p_ds = [&](auto with_kpm) {
          constexpr bool kKpm = decltype(with_kpm)::value;
          // segment ids: a tile whose queries and keys all hold one id is
          // open throughout; others test each element
          bool seg_test = false;
          int ksg[2] = {0, 0};  // this thread's two keys' segment ids
          if constexpr (kExt) {
            if (ex.seg != nullptr) {
              seg_test = !seg_inside(seg_span(ex, b, sq, q0, q0 + BQ), kspan);
              ksg[0] = seg_at(ex, b, sk, key0);
              ksg[1] = seg_at(ex, b, sk, key0 + 8);
            }
          }
          const Dropout drop(ex);
#pragma unroll
          for (int cc = 0; cc < BQ / 8; ++cc) {
            // per query column: -lse in log2 units (-1e30 on fully masked
            // rows) and delta * scale
            const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * cc);
            const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * cc);
            const float nl[2] = {
                l2.x > APEX_NEG_INF / 2 ? -l2.x * sm90::kLog2e : APEX_NEG_INF,
                l2.y > APEX_NEG_INF / 2 ? -l2.y * sm90::kLog2e
                                        : APEX_NEG_INF};
            const float dls[2] = {d2.x * scale, d2.y * scale};
            // the segment ids of this thread's two query columns
            int qsg[2] = {0, 0};
            if constexpr (kExt) {
              if (seg_test) {
                const int c0 = q0 + sm90::frag_col(4 * cc, lane);
                qsg[0] = seg_at(ex, b, sq, c0);
                qsg[1] = seg_at(ex, b, sq, c0 + 1);
              }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float p[2], ds[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = 4 * cc + 2 * i + e;
                float x = fmaf(acc_s[r], sl2, nl[e]);
                if constexpr (kKpm) x += kp2[i];
                if (edge && key0 + 8 * i > q0 + sm90::frag_col(r, lane))
                  x = APEX_NEG_INF;
                if constexpr (kExt) {
                  if (seg_test && !seg_open(qsg[e], ksg[i]))
                    x = APEX_NEG_INF;
                }
                p[e] = sm90::ex2(x);
                float dpv = acc_dp[r];
                bool kept = true;
                if constexpr (kExt) {
                  if (drop.on) {
                    kept = drop.keep(bh, q0 + sm90::frag_col(r, lane),
                                     key0 + 8 * i);
                    dpv = kept ? dpv * drop.inv : 0.0f;
                  }
                }
                ds[e] = p[e] * fmaf(dpv, scale, -dls[e]);
                // dV takes the dropped p
                if constexpr (kExt) {
                  if (drop.on) p[e] = kept ? p[e] * drop.inv : 0.0f;
                }
              }
              pa[cc / 2][2 * (cc % 2) + i] = sm90::pack2<T>(p[0], p[1]);
              da[cc / 2][2 * (cc % 2) + i] = sm90::pack2<T>(ds[0], ds[1]);
            }
          }
        };
        if (kpm != nullptr)
          form_p_ds(std::true_type{});
        else
          form_p_ds(std::false_type{});

        const uint32_t sQ =
            sm90::smem_addr(smem + C::q_off + s * C::QT::BYTES);
        const uint32_t sdO =
            sm90::smem_addr(smem + C::do_off + s * C::QT::BYTES);
        sm90::turn_begin(wg);
        sm90::mma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          sm90::mma_rs<T, D, 1>(acc_dv, pa[kk],
                                sm90::desc_mn<D, BQ>(sdO, kk), 1);
          sm90::mma_rs<T, D, 1>(acc_dk, da[kk], sm90::desc_mn<D, BQ>(sQ, kk),
                                1);
        }
        sm90::mma_commit();
        if (t_next < ntiles) issue_s_dp(acc_s, acc_dp, u + 1);
        sm90::turn_end(wg);
        sm90::mma_wait<0>();
        sm90::fence_regs(acc_dv);
        sm90::fence_regs(acc_dk);
        sm90::fence_regs(acc_s);
        sm90::fence_regs(acc_dp);
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(&empty[s]);
        ++u;
        t = t_next;
      }
      if constexpr (!kRegs) {
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(&kv_empty[kb]);
      }
      ring += u;
      const float one[2] = {1.0f, 1.0f};
      const size_t off = ((size_t)b * sk * g + kvh) * dr;
      sm90::store_rows<TO>(acc_dk, one, dk + off, (size_t)g * dr, key0, sk,
                           dr);
      sm90::store_rows<TO>(acc_dv, one, dv + off, (size_t)g * dr, key0, sk,
                           dr);
    }
    if (wg == 0) sm90::turn_begin(wg);  // the last hand-over
  }
}

template <typename T, int D>
int bwd_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
             CUtensorMap* tdo, const void* q, const void* k, const void* v,
             const void* dout, int b, int sq, int sk, int n, int g, int dr,
             int qrows, int krows) {
  int err = sm90::encode_bsnd<T>(tq, q, b, sq, n, dr, qrows);
  if (err == 0) err = sm90::encode_bsnd<T>(tdo, dout, b, sq, n, dr, qrows);
  if (err == 0) err = sm90::encode_bsnd<T>(tk, k, b, sk, g, dr, krows);
  if (err == 0) err = sm90::encode_bsnd<T>(tv, v, b, sk, g, dr, krows);
  return err;
}

template <typename T, int D, bool kExt, typename TO = T>
int launch_dq_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* kpm, void* dq, int b, int sq, int sk, int n,
                   int g, int dr, float scale, int causal,
                   const FlashExtras& ex, cudaStream_t stream) {
  using C = BwdDq<D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = bwd_maps<T, D>(&tq, &tk, &tv, &tdo, q, k, v, dout, b, sq, sk, n,
                           g, dr, C::BQ, C::BK);
  if (err == 0)
    err = sm90::set_smem(flash_bwd_dq_sm90_kernel<T, D, kExt, TO>,
                         C::bytes);
  int grid = 0;
  if (err == 0)
    err = sm90::persistent_grid((sq + C::BQ - 1) / C::BQ * b * n, &grid);
  if (err != 0) return err;
  flash_bwd_dq_sm90_kernel<T, D, kExt, TO><<<grid, sm90::kThreads, C::bytes,
                                             stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta,
      (const float*)kpm, (TO*)dq, b, sq, sk, n, g, dr, scale, causal, ex);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kExt, typename TO = T>
int launch_dkv_sm90(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* kpm, void* dk, void* dv, int b, int sq,
                    int sk, int n, int g, int dr, float scale, int causal,
                    const FlashExtras& ex, cudaStream_t stream) {
  using C = BwdDkv<D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = bwd_maps<T, D>(&tq, &tk, &tv, &tdo, q, k, v, dout, b, sq, sk, n,
                           g, dr, C::BQ, C::BK);
  if (err == 0)
    err = sm90::set_smem(flash_bwd_dkv_sm90_kernel<T, D, kExt, TO>,
                         C::bytes);
  int grid = 0;
  if (err == 0)
    err = sm90::persistent_grid((sk + C::BK - 1) / C::BK * b * g, &grid);
  if (err != 0) return err;
  flash_bwd_dkv_sm90_kernel<T, D, kExt, TO><<<grid, sm90::kThreads,
                                              C::bytes, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta,
      (const float*)kpm, (TO*)dk, (TO*)dv, b, sq, sk, n, g, dr, scale,
      causal, ex);
  return (int)cudaGetLastError();
}

// out_f32: dq (dk, dv) fp32 whatever T (the 16-bit kernels' fp32
// epilogue; fp32 inputs write fp32 anyway).
template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* kpm, void* dq,
              int b, int sq, int sk, int n, int g, int dr, float scale,
              int causal, const FlashExtras& ex, bool out_f32,
              cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (out_f32)
      return has_extras(ex) ? (int)cudaErrorInvalidValue
                            : launch_dq_sm90<T, D, false, float>(
                                  q, k, v, dout, lse, delta, kpm, dq, b, sq,
                                  sk, n, g, dr, scale, causal, ex, stream);
    return has_extras(ex)
               ? launch_dq_sm90<T, D, true>(q, k, v, dout, lse, delta, kpm,
                                            dq, b, sq, sk, n, g, dr, scale,
                                            causal, ex, stream)
               : launch_dq_sm90<T, D, false>(q, k, v, dout, lse, delta, kpm,
                                             dq, b, sq, sk, n, g, dr, scale,
                                             causal, ex, stream);
  } else {
    const int bytes = Smem<T, D>::bytes;
    int err = prepare(flash_bwd_dq_kernel<T, D>, bytes);
    if (err != 0) return err;
    const dim3 grid((sq + kB - 1) / kB, b * n);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (const float*)kpm, (T*)dq,
        sq, sk, n, g, dr, scale, causal, ex);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* kpm, void* dk,
               void* dv, int b, int sq, int sk, int n, int g, int dr,
               float scale, int causal, const FlashExtras& ex, bool out_f32,
               cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (out_f32)
      return has_extras(ex) ? (int)cudaErrorInvalidValue
                            : launch_dkv_sm90<T, D, false, float>(
                                  q, k, v, dout, lse, delta, kpm, dk, dv, b,
                                  sq, sk, n, g, dr, scale, causal, ex,
                                  stream);
    return has_extras(ex)
               ? launch_dkv_sm90<T, D, true>(q, k, v, dout, lse, delta, kpm,
                                             dk, dv, b, sq, sk, n, g, dr,
                                             scale, causal, ex, stream)
               : launch_dkv_sm90<T, D, false>(q, k, v, dout, lse, delta, kpm,
                                              dk, dv, b, sq, sk, n, g, dr,
                                              scale, causal, ex, stream);
  } else {
    const int bytes = Smem<T, D>::bytes;
    int err = prepare(flash_bwd_dkv_kernel<T, D>, bytes);
    if (err != 0) return err;
    const dim3 grid((sk + kB - 1) / kB, b * g);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (const float*)kpm, (T*)dk,
        (T*)dv, sq, sk, n, g, dr, scale, causal, ex);
  }
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

bool bwd_args_ok(int b, int sq, int sk, int n, int g, const void* seg,
                 const void* seg_rng) {
  return b > 0 && sq > 0 && sk > 0 && g > 0 && n % g == 0 &&
         (seg == nullptr || (seg_rng != nullptr && sq == sk));
}

int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* kpm, void* dq,
             int b, int sq, int sk, int n, int g, int d, float scale,
             int causal, int dtype, const FlashExtras& ex, bool out_f32,
             cudaStream_t stream) {
  APEX_DISPATCH_FLOAT(dtype, T, {
    APEX_DISPATCH_HEAD_DIM(d, D, (launch_dq<T, D>(q, k, v, dout, lse, delta,
                                                  kpm, dq, b, sq, sk, n, g, d,
                                                  scale, causal, ex, out_f32,
                                                  stream)));
  });
  return (int)cudaErrorInvalidValue;
}

int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* kpm, void* dk,
              void* dv, int b, int sq, int sk, int n, int g, int d,
              float scale, int causal, int dtype, const FlashExtras& ex,
              bool out_f32, cudaStream_t stream) {
  APEX_DISPATCH_FLOAT(dtype, T, {
    APEX_DISPATCH_HEAD_DIM(d, D, (launch_dkv<T, D>(q, k, v, dout, lse, delta,
                                                   kpm, dk, dv, b, sq, sk, n,
                                                   g, d, scale, causal, ex,
                                                   out_f32, stream)));
  });
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, do [b, sq, n, d] and k, v [b, sk, g, d] of dtype; lse, delta
// [b*n, sq] fp32; kpm [b, sk] fp32 additive or NULL; dq like q.  d a
// multiple of 8 up to 128, on the tiles of the next of 32, 64 and 128
// (APEX_DISPATCH_HEAD_DIM), their columns past d zeros and not stored.
// seed, threshold, inv_keep, seg and seg_rng as apex_flash_fwd's.
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* kpm, void* dq,
                                 int b, int sq, int sk, int n, int g, int d,
                                 float scale, int causal, int dtype,
                                 const void* seed, unsigned threshold,
                                 float inv_keep, const void* seg,
                                 const void* seg_rng, cudaStream_t stream) {
  if (!bwd_args_ok(b, sq, sk, n, g, seg, seg_rng))
    return (int)cudaErrorInvalidValue;
  return dq_entry(q, k, v, dout, lse, delta, kpm, dq, b, sq, sk, n, g, d,
                  scale, causal, dtype,
                  make_extras(seed, threshold, inv_keep, seg, seg_rng), false,
                  stream);
}

// As apex_flash_bwd_dq with dq fp32 [b, sq, n, d] whatever the inputs'
// dtype (the ring's chunk backward); no dropout or segment ids on 16-bit
// inputs.
extern "C" int apex_flash_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* kpm, void* dq, int b,
                                     int sq, int sk, int n, int g, int d,
                                     float scale, int causal, int dtype,
                                     const void* seed, unsigned threshold,
                                     float inv_keep, const void* seg,
                                     const void* seg_rng,
                                     cudaStream_t stream) {
  if (!bwd_args_ok(b, sq, sk, n, g, seg, seg_rng))
    return (int)cudaErrorInvalidValue;
  return dq_entry(q, k, v, dout, lse, delta, kpm, dq, b, sq, sk, n, g, d,
                  scale, causal, dtype,
                  make_extras(seed, threshold, inv_keep, seg, seg_rng), true,
                  stream);
}

// As apex_flash_bwd_dq; dk, dv like k (summed over each group's heads).
extern "C" int apex_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* kpm, void* dk, void* dv, int b,
                                  int sq, int sk, int n, int g, int d,
                                  float scale, int causal, int dtype,
                                  const void* seed, unsigned threshold,
                                  float inv_keep, const void* seg,
                                  const void* seg_rng, cudaStream_t stream) {
  if (!bwd_args_ok(b, sq, sk, n, g, seg, seg_rng))
    return (int)cudaErrorInvalidValue;
  return dkv_entry(q, k, v, dout, lse, delta, kpm, dk, dv, b, sq, sk, n, g,
                   d, scale, causal, dtype,
                   make_extras(seed, threshold, inv_keep, seg, seg_rng),
                   false, stream);
}

// As apex_flash_bwd_dkv with dk, dv fp32 [b, sk, g, d] (each group's heads
// summed in fp32) whatever the inputs' dtype (the ring's chunk backward).
extern "C" int apex_flash_bwd_dkv_f32(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* kpm, void* dk, void* dv,
                                      int b, int sq, int sk, int n, int g,
                                      int d, float scale, int causal,
                                      int dtype, const void* seed,
                                      unsigned threshold, float inv_keep,
                                      const void* seg, const void* seg_rng,
                                      cudaStream_t stream) {
  if (!bwd_args_ok(b, sq, sk, n, g, seg, seg_rng))
    return (int)cudaErrorInvalidValue;
  return dkv_entry(q, k, v, dout, lse, delta, kpm, dk, dv, b, sq, sk, n, g,
                   d, scale, causal, dtype,
                   make_extras(seed, threshold, inv_keep, seg, seg_rng),
                   true, stream);
}

namespace {

template <typename T, int D, bool kExt>
int bwd_attrs_d(int which, int* out) {
  if (which == 0)
    return sm90::kernel_attrs(flash_bwd_dq_sm90_kernel<T, D, kExt>,
                              BwdDq<D>::bytes, sm90::kThreads, out);
  return sm90::kernel_attrs(flash_bwd_dkv_sm90_kernel<T, D, kExt>,
                            BwdDkv<D>::bytes, sm90::kThreads, out);
}

template <typename T, bool kExt>
int bwd_attrs(int which, int d, int* out) {
  APEX_DISPATCH_HEAD_DIM(d, D, (bwd_attrs_d<T, D, kExt>(which, out)));
}

}  // namespace

// The 16-bit K6 (which = 0) or K7 (which = 1) kernel's {registers, shared
// memory per CTA, CTAs per SM, spill bytes} for head size d, without (ext
// = 0) or with (ext = 1) segment ids or dropout.
extern "C" int apex_flash_bwd_attrs(int which, int dtype, int d, int ext,
                                    int* out) {
  if (dtype == APEX_BF16)
    return ext ? bwd_attrs<__nv_bfloat16, true>(which, d, out)
               : bwd_attrs<__nv_bfloat16, false>(which, d, out);
  if (dtype == APEX_F16)
    return ext ? bwd_attrs<__half, true>(which, d, out)
               : bwd_attrs<__half, false>(which, d, out);
  return (int)cudaErrorInvalidValue;
}
