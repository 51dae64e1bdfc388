// Row 5: the one-pass flash-attention backward for short keys (BSND),
// causal and key padding, GQA.
//
// Replaces apex_tpu/ops/flash_attention.py:_bwd_fused_kernel (launched by
// _bwd_pallas_fused, which _flash_bwd takes for padded key lengths up to
// 512).  Like that kernel it forms each probability tile once and takes
// dq, dk and dv from the same pass:
//   p  = exp(s * scale + kpm - lse)   (0 where masked or lse is -1e30),
//   ds = p * (dp - delta) * scale,    dp = do v^T,
//   dv += p^T do,  dk += ds^T q,  dq += ds k,
// five tile products per (query, key) tile pair where the split pair K6 +
// K7 takes seven (s and dp twice).  Masks as in K6/K7: causal from
// row/column indices, an additive fp32 key-padding row, the key tail at
// sk, and the lse > -1e30/2 guard that zeroes fully masked rows
// (flash_attention.py:608-611).
//
// The TPU kernel keeps the group's whole K/V (<= 512 keys) in VMEM, walks
// the query blocks in order, emits each block's dq complete and carries
// only dk and dv across blocks.  A Hopper SM holds 227 KB of shared
// memory, not the fp32 dk/dv of 512 keys beside the tiles, and its blocks
// run in no order.
//
// 16-bit inputs: a thread-block cluster stands in for the resident K/V.
// The R = ceil(sk / 128) CTAs of one (batch, kv-group) form a cluster (up
// to 8 ranks: 1024 keys).  The keys come in 2R tiles of 64; rank r's two
// consumer warpgroups hold tiles r and 2R - 1 - r, so that under
// causality every rank has one early key tile (many query tiles) and one
// late one (few).  Each CTA is K7's Hopper work item
// (flash_attention_bwd.cu): 384 threads, a producer warp feeding a TMA
// ring of Q, dO and the lse/delta rows, the consumer warpgroups issuing
// wgmma into fp32 registers under setmaxnreg, the transposed products
// S^T = K Q^T and dP^T = V dO^T, and dV += P^T dO, dK += dS^T Q held in
// registers across the group's rep heads and query tiles (64 queries; 32
// at d = 128).  K and V stay in shared memory for the whole item (the dq
// product reads K there).
// The dq: each warpgroup writes its dS^T tile to shared memory (rounded to
// T; two tiles each, by step parity), and warpgroup 1, which issues second,
// forms the rank's contribution over both tiles' 128 keys, dS K (at d =
// 128 the transpose K^T dS^T, whose M is d: wgmma needs 64 rows), into
// an fp32 partial in its CTA's shared memory.  The ranks step through the
// same sequence of (head, query tile) steps; after a step warpgroup 1
// arrives on every rank's "full" mbarrier of that step's partial buffer.
// The producer warpgroup's three idle warps are the reducers: on rank r
// they add the rank's slice of the tile over ranks 0 .. R-1, in that
// order, through distributed shared memory, round it and store it, and
// arrive on every rank's "empty" barrier.  Two partial buffers alternate,
// so the consumers run the next step's products while the reducers sum
// this one.  Every dq element has one writer and a
// fixed order of addition; no fp32 partial reaches device memory and no
// second kernel runs.  Causal calls: a key tile sees the query tiles
// from its first key on; a warpgroup with nothing for a step keeps its
// turn and still arrives (its partial is not read), so the ranks stay in
// step.
//
// Dropout and segment ids (keep_mask.cuh) are runtime arguments, as in
// _bwd_fused_kernel (:613-627; the 16-bit kernel runs an instantiation of
// its own, kExt, when either is on): dV takes the dropped p, dS the dropped dp;
// keys of another segment are masked, and a warpgroup whose key tile no
// query of a step's tile can see skips that step's products (its dS^T
// tile is zero), as a causal one does.
//
// Numbers.  As K6/K7: p and ds are rounded to the input type before the
// tensor-core products; scores, dp, lse, delta and the dq partials stay
// fp32.
//
// fp32 inputs (no main path) keep the CUDA-core design of
// flash_bwd_tile.cuh: one CTA per (64-key tile, batch*kv-group), the
// tiles loaded synchronously, each key tile's dq contribution written as
// an fp32 partial [key tile, b*n, sqp, d] and summed over the key tiles in
// fixed order by a second kernel.
//
// Bound on the H100 at b8 s512 n16 d64 bf16 (BERT-large), key padding:
// about even between operations (5 products of 2*d flops per open
// (query, key) pair, ~0.02 ms at 989 TFLOP/s) and bytes (q, k, v, do,
// dq, dk, dv, lse, delta: ~59 MB, ~0.018 ms).
#include <cooperative_groups.h>

#include <type_traits>

#include "flash_bwd_tile.cuh"
#include "sm90_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 inputs
// ---------------------------------------------------------------------------

// dk and dv for one (64-key tile, batch*kv-group), summed over the
// group's rep query heads, and each visited query tile's dq partial.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ kpm,
                           float* __restrict__ dq_part, T* __restrict__ dk,
                           T* __restrict__ dv, int b_total, int sq, int sk,
                           int n, int g, int dr, float scale, int causal,
                           FlashExtras ex) {
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
  const int kt = blockIdx.x;
  const int k0 = kt * kB;
  const int qstride = n * dr, kstride = g * dr;
  const int sqp = (sq + kB - 1) / kB * kB;
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
      // this warp's 16 rows of the dq partial
      float* part = dq_part + (((size_t)kt * b_total * n + bh) * sqp + q0 +
                               warp * 16) * D;
      if (!seg_tile_live(ex, b, sq, q0, kB, k0, kB)) {
        // no query of the tile sees these keys: a zero partial
        const int lane = threadIdx.x & 31;
        for (int e = lane; e < 16 * D; e += 32) part[e] = 0.0f;
        continue;
      }
      __syncthreads();  // the previous tile's readers are done
      const size_t qbase = (((size_t)b * sq + q0) * n + h) * dr;
      load_tile<T, D>(sQ, q + qbase, q0, sq, qstride, dr);
      load_tile<T, D>(sdO, dout + qbase, q0, sq, qstride, dr);
      load_row_stats(sL, sDl, lse, delta, bh, q0, sq);
      __syncthreads();
      probs_and_ds<T, D>(smem, kpm, b, sk, q0, k0, scale, causal, ex, drop,
                         bh);
      // ds[16 x 64] k[64 x D], stored straight to global memory
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb) {
        Acc<T> acc;
        acc.zero();
#pragma unroll
        for (int kk = 0; kk < kB / 16; ++kk)
          mma16<true, true>(acc, sdS + warp * 16 * L::LDP + kk * 16, L::LDP,
                            sK + kk * 16 * L::LDT + nb * 16, L::LDT);
        acc.store(part + nb * 16, D);
      }
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

// dq[b, row, h, :] = sum over the key tiles that visited the row's query
// tile (all of them, or those up to the diagonal when causal) of the
// partials (D columns a row), in key-tile order; four columns per thread,
// the first dr stored.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_short_dq_sum(const float* __restrict__ dq_part,
                           T* __restrict__ dq, int b_total, int sq, int sk,
                           int n, int dr, int causal) {
  const int sqp = (sq + kB - 1) / kB * kB;
  const long long total = (long long)b_total * n * sq * (D / 4);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % (D / 4)) * 4;
  const long long t = i / (D / 4);
  const int row = (int)(t % sq);
  const int bh = (int)(t / sq);
  const int nkt = (sk + kB - 1) / kB;
  const int kt_end = causal ? min(nkt, row / kB + 1) : nkt;
  const size_t plane = (size_t)b_total * n * sqp * D;
  const float* src = dq_part + ((size_t)bh * sqp + row) * D + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt < kt_end; ++kt) {
    const float4 p = *reinterpret_cast<const float4*>(src + kt * plane);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  if (c >= dr) return;
  const int b = bh / n, h = bh % n;
  T* out = dq + (((size_t)b * sq + row) * n + h) * dr + c;
  out[0] = apex_from_float<T>(acc.x);
  out[1] = apex_from_float<T>(acc.y);
  out[2] = apex_from_float<T>(acc.z);
  out[3] = apex_from_float<T>(acc.w);
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* kpm, void* dq_part, void* dq, void* dk, void* dv,
                int b, int sq, int sk, int n, int g, int dr, float scale,
                int causal, const FlashExtras& ex, cudaStream_t stream) {
  if (dq_part == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = Smem<float, D>::bytes;
  int err = prepare(flash_bwd_short_kernel<float, D>, bytes);
  if (err != 0) return err;
  const dim3 grid((sk + kB - 1) / kB, b * g);
  flash_bwd_short_kernel<float, D><<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (const float*)kpm,
      (float*)dq_part, (float*)dk, (float*)dv, b, sq, sk, n, g, dr, scale,
      causal, ex);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long total = (long long)b * n * sq * (D / 4);
  flash_bwd_short_dq_sum<float, D><<<(unsigned)((total + 255) / 256), 256,
                                     0, stream>>>(
      (const float*)dq_part, (float*)dq, b, sq, sk, n, dr, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 16-bit inputs: the Hopper kernel, one cluster of R CTAs per
// (batch, kv-group).
// ---------------------------------------------------------------------------

constexpr int kMaxRanks = 8;  // the portable cluster size: up to 1024 keys
// Threads 288-383 (the producer warpgroup's last three warps) sum dq
// across the cluster.  Registers move from the producer warpgroup (56) to
// the consumers (224): 128 * 56 + 256 * 224 <= 65536, the launch's whole
// file.
constexpr int kReducerThreads = 96;
constexpr int kShortProducerRegs = 56;
constexpr int kShortConsumerRegs = 224;

template <int D>
struct Short {
  static constexpr int BK = 64;                  // keys per warpgroup
  static constexpr int BQ = D == 128 ? 32 : 64;  // queries per ring tile
  static constexpr int STAGES = D == 128 ? 3 : 4;
  // dq^T = K^T dS^T where 32 query rows are too few for wgmma's M
  static constexpr bool kSwap = BQ < 64;
  static constexpr int RP = D + 8;  // fp32 pitch of a dq partial row
  static constexpr int RED = BQ * RP;  // floats of one rank's partial
  using KT = sm90::Tile<D, BK>;   // one warpgroup's K or V
  using QT = sm90::Tile<D, BQ>;
  using ST = sm90::Tile<BQ, BK>;  // a warpgroup's dS^T: 64 keys x BQ queries
  // K of warpgroups 0 and 1, then V of both
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + 2 * KT::BYTES;
  static constexpr int q_off = v_off + 2 * KT::BYTES;
  static constexpr int do_off = q_off + STAGES * QT::BYTES;
  // dS^T tiles [step parity][warpgroup]
  static constexpr int ds_off = do_off + STAGES * QT::BYTES;
  // the rank's dq partial [step parity][BQ][RP] fp32
  static constexpr int red_off = ds_off + 4 * ST::BYTES;
  static constexpr int lse_off = red_off + 2 * RED * 4;
  static constexpr int dl_off = lse_off + STAGES * BQ * 4;
  static constexpr int bar_off = dl_off + STAGES * BQ * 4;
  // kv_full, full[S], empty[S], rfull[2], rempty[2], ds_free[2]; 1024
  // bytes of alignment slack
  static constexpr int bytes = bar_off + (7 + 2 * STAGES) * 8 + 1024;
};

// The first key of warpgroup w of rank r among 2R tiles of 64 keys: tile
// r for warpgroup 0, tile 2R - 1 - r for warpgroup 1, so that under
// causality every rank holds one early key tile (many query tiles) and
// one late one (few) and the ranks' work evens out.
__device__ __forceinline__ int short_key0(int r, int w, int R) {
  return (w == 0 ? r : 2 * R - 1 - r) * 64;
}

// The first query tile (of bq rows) that keys from kw on can see.
__device__ __forceinline__ int short_first_tile(int kw, int bq, int nqt,
                                                int causal) {
  return causal ? min(kw / bq, nqt) : 0;
}

// kExt: the instantiation that takes segment ids or dropout (a kernel of
// its own, as K2's, so that a call with neither runs the code it ran
// before).
template <typename T, int D, bool kExt>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_bwd_short_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const float* __restrict__ kpm,
                                T* __restrict__ dq, T* __restrict__ dk,
                                T* __restrict__ dv, int sq, int sk, int n,
                                int g, int dr, float scale, int causal,
                                FlashExtras ex) {
  using C = Short<D>;
  constexpr int BQ = C::BQ, BK = C::BK, S = C::STAGES;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;
  uint64_t* rfull = empty + S;
  uint64_t* rempty = rfull + 2;
  uint64_t* ds_free = rempty + 2;
  float* slse = reinterpret_cast<float*>(smem + C::lse_off);
  float* sdl = reinterpret_cast<float*>(smem + C::dl_off);
  float* red = reinterpret_cast<float*>(smem + C::red_off);

  const int rep = n / g;
  const int bg = blockIdx.y, b = bg / g, kvh = bg % g;
  const int nqt = (sq + BQ - 1) / BQ;
  const int steps = rep * nqt;  // (head, query tile), the same on every rank
  // the ring carries the query tiles warpgroup 0's keys (the rank's
  // earlier tile) see; warpgroup 1's are a suffix of them
  const int qt_begin =
      short_first_tile(short_key0(rank, 0, R), BQ, nqt, causal);
  const int nq = nqt - qt_begin;
  const int nopen = rep * nq;

  if (threadIdx.x == 0) {
    sm90::bar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::bar_init(&full[s], 32);  // every producer lane's copies
      sm90::bar_init(&empty[s], sm90::kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      sm90::bar_init(&rfull[i], R);   // each rank's warpgroup 1
      sm90::bar_init(&rempty[i], R);  // each rank's reducer warps
      sm90::bar_init(&ds_free[i], 1);
    }
    sm90::bar_init_fence();
  }
  cluster.sync();  // every rank's barriers exist before a peer arrives

  if (threadIdx.x >= 256) {
    sm90::reg_dealloc<kShortProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        sm90::bar_arrive_tx(kv_full, 4 * C::KT::BYTES);
        for (int w = 0; w < 2; ++w) {
          const int kw = short_key0(rank, w, R);
          sm90::tma_tile<D, BK>(smem + C::k_off + w * C::KT::BYTES, &tk,
                                kv_full, kvh, kw, b);
          sm90::tma_tile<D, BK>(smem + C::v_off + w * C::KT::BYTES, &tv,
                                kv_full, kvh, kw, b);
        }
      }
      for (int u = 0; u < nopen; ++u) {
        const int s = u % S;
        const int h = kvh * rep + u / nq;
        const int q0 = (qt_begin + u % nq) * BQ;
        const size_t bh = (size_t)b * n + h;
        sm90::bar_wait(&empty[s], ((u / S) & 1) ^ 1);
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
    } else {
      // The reducer warps.  Step t's dq: this rank's slice of the tile,
      // the ranks' partials whose keys see the tile added in rank order,
      // rounded to T and stored; then every rank is told that this rank
      // is done reading the step's buffer.
      const int rtid = threadIdx.x - 288;
      constexpr int E4 = BQ * D / 4;  // float4s of a tile
      const int lo = rank * E4 / R, hi = (rank + 1) * E4 / R;
      for (int t = 0; t < steps; ++t) {
        const int buf = t & 1;
        sm90::bar_wait(&rfull[buf], (t >> 1) & 1);
        sm90::fence_cluster();  // acquire: the peers' partials are visible
        const int qt = t % nqt;
        const int h = kvh * rep + t / nqt;
        // ranks with a partial: those whose warpgroup 0 sees the tile
        int nr = 0;
        while (nr < R && qt >= short_first_tile(short_key0(nr, 0, R), BQ,
                                                nqt, causal))
          ++nr;
        for (int e = lo + rtid; e < hi; e += kReducerThreads) {
          const int row = e / (D / 4), col = (e % (D / 4)) * 4;
          const uint32_t at =
              sm90::smem_addr(red + buf * C::RED + row * C::RP + col);
          float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int j0 = 0; j0 < nr; j0 += 4) {
            // four ranks' partials in flight at once, then added
            float4 v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = j0 + i < nr
                         ? sm90::ld_cluster4(sm90::map_rank(red, j0 + i) -
                                             sm90::smem_addr(red) + at)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              sum.x += v[i].x;
              sum.y += v[i].y;
              sum.z += v[i].z;
              sum.w += v[i].w;
            }
          }
          const int q = qt * BQ + row;
          if (q < sq && col < dr) {
            const uint2 packed = make_uint2(sm90::pack2<T>(sum.x, sum.y),
                                            sm90::pack2<T>(sum.z, sum.w));
            *reinterpret_cast<uint2*>(
                dq + (((size_t)b * sq + q) * n + h) * dr + col) = packed;
          }
        }
        // every read has returned its value (the sums are stored): lane
        // j of the first reducer warp tells rank j
        sm90::named_sync(5, kReducerThreads);
        if (rtid < R) sm90::bar_arrive_rank(&rempty[buf], rtid);
      }
    }
  } else {
    sm90::reg_alloc<kShortConsumerRegs>();
    // the warpgroup, from lane 0: the compiler then knows it is the same
    // across the warp, and does not serialize the wgmma of a branch on it
    const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int wtid = threadIdx.x & 127;
    const float sl2 = scale * sm90::kLog2e;
    const int wg_key = short_key0(rank, wg, R);
    // this warpgroup's first query tile
    const int qt_w = short_first_tile(wg_key, BQ, nqt, causal);
    const int key0 = wg_key + warp * 16 + (lane >> 2);  // and key0 + 8
    // whether this warpgroup's keys can see query tile qt: causally, and
    // by segment (warp-uniform, so that the products' branches stay whole)
    // this warpgroup's keys' ids (segment ids only)
    const SegSpan wspan = kExt && ex.seg != nullptr
                              ? seg_span(ex, b, sk, wg_key, wg_key + BK)
                              : SegSpan{0, 0, 0};
    auto opens = [&](int qt) {
      if constexpr (kExt)
        return warp_uniform(qt >= qt_w &&
                            (ex.seg == nullptr ||
                             seg_meet(seg_span(ex, b, sq, qt * BQ,
                                               qt * BQ + BQ),
                                      wspan))) != 0;
      else
        return qt >= qt_w;
    };
    // the key's padding in log2 units; -1e30 past sk, so that no key of
    // the tail (K and V rows of zeros) enters a product
    float kp2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      kp2[i] = key >= sk ? APEX_NEG_INF
               : kpm != nullptr ? kpm[(size_t)b * sk + key] * sm90::kLog2e
                                : 0.0f;
    }
    const uint32_t sK = sm90::smem_addr(smem + C::k_off + wg * C::KT::BYTES);
    const uint32_t sV = sm90::smem_addr(smem + C::v_off + wg * C::KT::BYTES);
    // warpgroup w's K, and its dS^T tile of steps of parity par
    auto k_of = [&](int w) {
      return sm90::smem_addr(smem + C::k_off + w * C::KT::BYTES);
    };
    auto ds_of = [&](int par, int w) {
      return sm90::smem_addr(smem + C::ds_off + (2 * par + w) * C::ST::BYTES);
    };
    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) {
      acc_dk[r] = 0.0f;
      acc_dv[r] = 0.0f;
    }
    // whether ring tile u's query tile is one this warpgroup's keys see
    auto sees = [&](int u) { return opens(qt_begin + u % nq); };

    // S^T = K Q^T and dP^T = V dO^T of ring tile u, issued and committed
    auto issue_s_dp = [&](float (&s_acc)[BQ / 2], float (&dp_acc)[BQ / 2],
                          int u) {
      const int s = u % S;
      const uint32_t sQ = sm90::smem_addr(smem + C::q_off + s * C::QT::BYTES);
      const uint32_t sdO =
          sm90::smem_addr(smem + C::do_off + s * C::QT::BYTES);
      sm90::bar_wait(&full[s], (u / S) & 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::mma_ss<T, BQ, 0>(s_acc, sm90::desc_k<D, BK>(sK, 0, kk),
                               sm90::desc_k<D, BQ>(sQ, 0, kk), kk > 0);
        sm90::mma_ss<T, BQ, 0>(dp_acc, sm90::desc_k<D, BK>(sV, 0, kk),
                               sm90::desc_k<D, BQ>(sdO, 0, kk), kk > 0);
      }
      sm90::mma_commit();
    };

    // The rank's dq contribution of step parity par over both warpgroups'
    // keys, into red[par] ([BQ][RP] fp32, query rows): issued by
    // warpgroup 1, after both dS^T tiles are in.
    auto dq_partial = [&](int par) {
      float* dst = red + par * C::RED;
      if constexpr (!C::kSwap) {
        // dQ[64 q x D] = dS[64 q x 128 keys] K[128 keys x D]: dS^T is the
        // transposed (MN-major) A, K the MN-major B, 16 keys a step
        float acc_q[D / 2];
        sm90::mma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::mma_ss<T, D, 1, 1>(acc_q, sm90::desc_mn<BQ, BK>(ds_of(par, 0),
                                                                kk),
                                   sm90::desc_mn<D, BK>(k_of(0), kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::mma_ss<T, D, 1, 1>(acc_q,
                                   sm90::desc_mn<BQ, BK>(ds_of(par, 1), kk),
                                   sm90::desc_mn<D, BK>(k_of(1), kk), 1);
        sm90::mma_commit();
        sm90::mma_wait<0>();
        sm90::fence_regs(acc_q);
#pragma unroll
        for (int r = 0; r < D / 2; r += 2) {
          const int row = warp * 16 + (lane >> 2) + 8 * sm90::frag_row(r);
          *reinterpret_cast<float2*>(dst + row * C::RP +
                                     sm90::frag_col(r, lane)) =
              make_float2(acc_q[r], acc_q[r + 1]);
        }
      } else {
        // dQ^T[64 d x BQ] = K^T[64 d x 128 keys] dS^T[128 keys x BQ],
        // one 64-column panel of K at a time: K^T the MN-major A, dS^T the
        // MN-major B
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          float acc_q[BQ / 2];
          sm90::mma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::mma_ss<T, BQ, 1, 1>(
                acc_q,
                sm90::desc_mn<64, BK>(k_of(0) + p * C::KT::PANEL_BYTES, kk),
                sm90::desc_mn<BQ, BK>(ds_of(par, 0), kk), kk > 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::mma_ss<T, BQ, 1, 1>(
                acc_q,
                sm90::desc_mn<64, BK>(k_of(1) + p * C::KT::PANEL_BYTES, kk),
                sm90::desc_mn<BQ, BK>(ds_of(par, 1), kk), 1);
          sm90::mma_commit();
          sm90::mma_wait<0>();
          sm90::fence_regs(acc_q);
#pragma unroll
          for (int r = 0; r < BQ / 2; ++r) {
            const int d =
                p * 64 + warp * 16 + (lane >> 2) + 8 * sm90::frag_row(r);
            dst[sm90::frag_col(r, lane) * C::RP + d] = acc_q[r];
          }
        }
      }
    };

    // The warpgroups take turns (sm90::turn_begin): one issues this
    // tile's dV and dK products and the next tile's S^T and dP^T while
    // the other forms its p^T and ds^T.  A warpgroup whose keys a ring
    // tile's queries cannot see (causal) skips its products but keeps
    // its turn.
    float acc_s[BQ / 2], acc_dp[BQ / 2];
    sm90::bar_wait(kv_full, 0);
    if (wg == 1) sm90::turn_end(wg);  // warpgroup 0 issues first
    sm90::turn_begin(wg);
    if (nopen > 0 && sees(0)) {
      sm90::mma_fence();
      issue_s_dp(acc_s, acc_dp, 0);
    }
    sm90::turn_end(wg);
    sm90::mma_wait<0>();
    sm90::fence_regs(acc_s);
    sm90::fence_regs(acc_dp);
    int u = 0;  // ring tiles consumed
    for (int t = 0; t < steps; ++t) {
      const int buf = t & 1;
      const int qt = t % nqt;
      const bool mine = opens(qt);  // this warpgroup has products
      // warpgroup 0's dS^T tile of this parity is free once warpgroup 1's
      // dq product of step t - 2 has read it.  Waited at every step, ring
      // tile or not: a wait that skipped a phase could match the parity
      // of the phase before it.
      if (wg == 0 && t >= 2)
        sm90::bar_wait(&ds_free[buf], ((t >> 1) - 1) & 1);
      if (qt >= qt_begin) {          // a ring tile
        const int s = u % S;
        const int q0 = qt * BQ;
        // whether this warpgroup issues the next ring tile's products:
        // decided before the fragments below are live (with segment ids
        // the decision reads the tiles' id ranges)
        const bool next_sees = u + 1 < nopen && sees(u + 1);
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // p^T, ds^T rounded to T
        // p^T and ds^T (rows are keys, columns queries), packed into A
        // fragments pair by pair; masked scores get -1e30
        auto form = [&]() {
          const uint32_t dsw = ds_of(buf, wg);
          const float* sl = slse + s * BQ + 2 * (lane & 3);
          const float* sd = sdl + s * BQ + 2 * (lane & 3);
          const bool edge = causal && wg_key + 63 > q0;
          if constexpr (kExt) {
            // Segment ids or dropout, in two passes, so that the packed
            // fragments never live beside the verdicts' inputs (the
            // accumulators of d = 128 leave no register for both): first
            // p (dropped for dV) into acc_s and ds into acc_dp, in place
            // a tile whose queries and keys all hold one id is open
            // throughout; others test each element
            const bool segs =
                ex.seg != nullptr &&
                !seg_inside(seg_span(ex, b, sq, q0, q0 + BQ), wspan);
            const bool drops = ex.seed != nullptr;
            const int ks[2] = {segs ? seg_at(ex, b, sk, key0) : 0,
                               segs ? seg_at(ex, b, sk, key0 + 8) : 0};
            // seed + bh * 0x9E3779B1 of this step's head
            const uint32_t hb =
                drops ? (uint32_t)__ldg(ex.seed) +
                            (uint32_t)(b * n + kvh * rep + t / nqt) *
                                0x9E3779B1u
                      : 0u;
#pragma unroll
            for (int cc = 0; cc < BQ / 8; ++cc) {
              // per query column: -lse in log2 units (-1e30 on fully
              // masked rows) and delta * scale
              const float2 l2 =
                  *reinterpret_cast<const float2*>(sl + 8 * cc);
              const float2 d2 =
                  *reinterpret_cast<const float2*>(sd + 8 * cc);
              const float nl[2] = {
                  l2.x > APEX_NEG_INF / 2 ? -l2.x * sm90::kLog2e
                                          : APEX_NEG_INF,
                  l2.y > APEX_NEG_INF / 2 ? -l2.y * sm90::kLog2e
                                          : APEX_NEG_INF};
              const float dls[2] = {d2.x * scale, d2.y * scale};
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int r = 4 * cc + 2 * i + e;
                  const int qcol = q0 + sm90::frag_col(r, lane);
                  float x = fmaf(acc_s[r], sl2, nl[e]) + kp2[i];
                  if ((edge && key0 + 8 * i > qcol) ||
                      (segs && !seg_open(seg_at(ex, b, sq, qcol), ks[i])))
                    x = APEX_NEG_INF;
                  const float pv = sm90::ex2(x);
                  const bool kept =
                      !drops || keep_hash_hb(hb, (uint32_t)qcol,
                                             (uint32_t)(key0 + 8 * i)) <
                                    ex.threshold;
                  const float dpv = drops ? (kept ? acc_dp[r] * ex.inv_keep
                                                  : 0.0f)
                                          : acc_dp[r];
                  acc_dp[r] = pv * fmaf(dpv, scale, -dls[e]);
                  acc_s[r] = drops ? (kept ? pv * ex.inv_keep : 0.0f) : pv;
                }
            }
          }
#pragma unroll
          for (int cc = 0; cc < BQ / 8; ++cc) {
            // per query column: -lse in log2 units (-1e30 on fully masked
            // rows) and delta * scale (read again only without extras)
            float nl[2] = {0.0f, 0.0f}, dls[2] = {0.0f, 0.0f};
            if constexpr (!kExt) {
              const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * cc);
              const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * cc);
              nl[0] = l2.x > APEX_NEG_INF / 2 ? -l2.x * sm90::kLog2e
                                              : APEX_NEG_INF;
              nl[1] = l2.y > APEX_NEG_INF / 2 ? -l2.y * sm90::kLog2e
                                              : APEX_NEG_INF;
              dls[0] = d2.x * scale;
              dls[1] = d2.y * scale;
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float p[2], ds[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = 4 * cc + 2 * i + e;
                if constexpr (kExt) {
                  p[e] = acc_s[r];
                  ds[e] = acc_dp[r];
                } else {
                  float x = fmaf(acc_s[r], sl2, nl[e]) + kp2[i];
                  if (edge && key0 + 8 * i > q0 + sm90::frag_col(r, lane))
                    x = APEX_NEG_INF;
                  p[e] = sm90::ex2(x);
                  ds[e] = p[e] * fmaf(acc_dp[r], scale, -dls[e]);
                }
              }
              pa[cc / 2][2 * (cc % 2) + i] = sm90::pack2<T>(p[0], p[1]);
              da[cc / 2][2 * (cc % 2) + i] = sm90::pack2<T>(ds[0], ds[1]);
              // ds^T into this warpgroup's tile, the dq product's operand
              sm90::st_shared4(
                  sm90::swz_addr<BQ, BK>(dsw,
                                         warp * 16 + (lane >> 2) + 8 * i,
                                         8 * cc + 2 * (lane & 3)),
                  da[cc / 2][2 * (cc % 2) + i]);
            }
          }
          sm90::fence_proxy_async();
          sm90::named_sync(3 + wg, 128);  // the whole dS^T tile is written
        };
        if (mine) {
          form();
        } else if (kExt || wg == 1) {
          // no key of this warpgroup sees this tile (without segment ids
          // only warpgroup 1 can meet this): its dS^T is zero, so
          // that the rank's dq product runs over both tiles unbranched
          const uint32_t dsw = ds_of(buf, wg);
#pragma unroll
          for (int cc = 0; cc < BQ / 8; ++cc)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              sm90::st_shared4(
                  sm90::swz_addr<BQ, BK>(dsw,
                                         warp * 16 + (lane >> 2) + 8 * i,
                                         8 * cc + 2 * (lane & 3)),
                  0u);
          sm90::fence_proxy_async();
          sm90::named_sync(3 + wg, 128);
        }

        const uint32_t sQ =
            sm90::smem_addr(smem + C::q_off + s * C::QT::BYTES);
        const uint32_t sdO =
            sm90::smem_addr(smem + C::do_off + s * C::QT::BYTES);
        sm90::turn_begin(wg);
        if (mine) {
          sm90::mma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            sm90::mma_rs<T, D, 1>(acc_dv, pa[kk],
                                  sm90::desc_mn<D, BQ>(sdO, kk), 1);
            sm90::mma_rs<T, D, 1>(acc_dk, da[kk],
                                  sm90::desc_mn<D, BQ>(sQ, kk), 1);
          }
          sm90::mma_commit();
        }
        if (next_sees) {
          if (!mine) sm90::mma_fence();
          issue_s_dp(acc_s, acc_dp, u + 1);
        }
        sm90::turn_end(wg);
        sm90::mma_wait<0>();
        sm90::fence_regs(acc_dv);
        sm90::fence_regs(acc_dk);
        sm90::fence_regs(acc_s);
        sm90::fence_regs(acc_dp);
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(&empty[s]);
        ++u;
      }
      // warpgroup 1 publishes step t's partial (a rank with none only
      // arrives): first every rank must be done reading step t - 2's
      // from this buffer
      if (wg == 1) {
        if (t >= 2) sm90::bar_wait(&rempty[buf], ((t >> 1) - 1) & 1);
        if (qt >= qt_begin) dq_partial(buf);
        sm90::named_sync(4, 128);
        if (wtid == 0) sm90::bar_arrive(&ds_free[buf]);
        if (wtid < R) {  // release: the partial is visible to rank wtid
          sm90::fence_cluster();
          sm90::bar_arrive_rank(&rfull[buf], wtid);
        }
      }
    }
    if (wg == 0) sm90::turn_begin(wg);  // the last hand-over
    const float one[2] = {1.0f, 1.0f};
    const size_t off = ((size_t)b * sk * g + kvh) * dr;
    sm90::store_rows<T>(acc_dk, one, dk + off, (size_t)g * dr, key0, sk, dr);
    sm90::store_rows<T>(acc_dv, one, dv + off, (size_t)g * dr, key0, sk, dr);
  }
  // no CTA leaves while a peer may still read its partials or arrive on
  // its barriers
  cluster.sync();
}

template <typename T, int D, bool kExt>
int launch_sm90(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, const void* kpm, void* dq,
                void* dk, void* dv, int b, int sq, int sk, int n, int g,
                int dr, float scale, int causal, const FlashExtras& ex,
                cudaStream_t stream) {
  using C = Short<D>;
  const int ranks = (sk + 2 * C::BK - 1) / (2 * C::BK);
  if (ranks > kMaxRanks || (long long)b * g > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::encode_bsnd<T>(&tq, q, b, sq, n, dr, C::BQ);
  if (err == 0) err = sm90::encode_bsnd<T>(&tdo, dout, b, sq, n, dr, C::BQ);
  if (err == 0) err = sm90::encode_bsnd<T>(&tk, k, b, sk, g, dr, C::BK);
  if (err == 0) err = sm90::encode_bsnd<T>(&tv, v, b, sk, g, dr, C::BK);
  if (err == 0)
    err = sm90::set_smem(flash_bwd_short_sm90_kernel<T, D, kExt>, C::bytes);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, b * g, 1);
  cfg.blockDim = dim3(sm90::kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* lp = (const float*)lse;
  const float* dp = (const float*)delta;
  const float* kp = (const float*)kpm;
  T* dqp = (T*)dq;
  T* dkp = (T*)dk;
  T* dvp = (T*)dv;
  FlashExtras exv = ex;
  void* args[] = {&tq, &tk, &tv, &tdo, &lp, &dp, &kp, &dqp, &dkp, &dvp,
                  &sq, &sk, &n, &g, &dr, &scale, &causal, &exv};
  err = (int)cudaLaunchKernelExC(
      &cfg, (const void*)flash_bwd_short_sm90_kernel<T, D, kExt>, args);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_short(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* kpm, void* dq_part, void* dq, void* dk,
                 void* dv, int b, int sq, int sk, int n, int g, int dr,
                 float scale, int causal, const FlashExtras& ex,
                 cudaStream_t stream) {
  if constexpr (sizeof(T) == 2)
    return has_extras(ex)
               ? launch_sm90<T, D, true>(q, k, v, dout, lse, delta, kpm, dq,
                                         dk, dv, b, sq, sk, n, g, dr, scale,
                                         causal, ex, stream)
               : launch_sm90<T, D, false>(q, k, v, dout, lse, delta, kpm, dq,
                                          dk, dv, b, sq, sk, n, g, dr, scale,
                                          causal, ex, stream);
  else
    return launch_fp32<D>(q, k, v, dout, lse, delta, kpm, dq_part, dq, dk,
                          dv, b, sq, sk, n, g, dr, scale, causal, ex, stream);
}

template <typename T, int D, bool kExt>
int short_attrs_d(int* out) {
  return sm90::kernel_attrs(flash_bwd_short_sm90_kernel<T, D, kExt>,
                            Short<D>::bytes, sm90::kThreads, out);
}

template <typename T, bool kExt>
int short_attrs(int d, int* out) {
  APEX_DISPATCH_HEAD_DIM(d, D, (short_attrs_d<T, D, kExt>(out)));
}

// How many clusters of `ranks` CTAs the device holds at once.
template <typename T, int D>
int short_clusters_d(int ranks, int* out) {
  using C = Short<D>;
  int err = sm90::set_smem(flash_bwd_short_sm90_kernel<T, D, false>, C::bytes);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, 1, 1);
  cfg.blockDim = dim3(sm90::kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)flash_bwd_short_sm90_kernel<T, D, false>, &cfg);
}

template <typename T>
int short_clusters(int d, int ranks, int* out) {
  APEX_DISPATCH_HEAD_DIM(d, D, (short_clusters_d<T, D>(ranks, out)));
}

}  // namespace

// q, do [b, sq, n, d] and k, v [b, sk, g, d] of dtype; lse, delta
// [b*n, sq] fp32; kpm [b, sk] fp32 additive or NULL; dq like q, dk and dv
// like k (summed over each group's heads).  bf16 and fp16 take the
// cluster kernel (sk <= 1024, b * g <= 65535; dq_part unused, may be
// NULL); fp32 takes dq_part, fp32 scratch of [ceil(sk/64), b*n,
// ceil(sq/64)*64, D] with D = sm90::head_panel(d) (d a multiple of 8 up
// to 128).  seed, threshold, inv_keep, seg and seg_rng as apex_flash_fwd's.
extern "C" int apex_flash_bwd_short(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* kpm, void* dq_part, void* dq,
                                    void* dk, void* dv, int b, int sq, int sk,
                                    int n, int g, int d, float scale,
                                    int causal, int dtype, const void* seed,
                                    unsigned threshold, float inv_keep,
                                    const void* seg, const void* seg_rng,
                                    cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || g <= 0 || n % g != 0 ||
      (seg != nullptr && (seg_rng == nullptr || sq != sk)))
    return (int)cudaErrorInvalidValue;
  const FlashExtras ex = make_extras(seed, threshold, inv_keep, seg, seg_rng);
  APEX_DISPATCH_FLOAT(dtype, T, {
    APEX_DISPATCH_HEAD_DIM(d, D, (launch_short<T, D>(
                                     q, k, v, dout, lse, delta, kpm, dq_part,
                                     dq, dk, dv, b, sq, sk, n, g, d, scale,
                                     causal, ex, stream)));
  });
  return (int)cudaErrorInvalidValue;
}

// The 16-bit cluster kernel's {registers, shared memory per CTA, CTAs per
// SM, spill bytes} for head size d, without (ext = 0) or with (ext = 1)
// segment ids or dropout.
extern "C" int apex_flash_bwd_short_attrs(int dtype, int d, int ext,
                                          int* out) {
  if (dtype == APEX_BF16)
    return ext ? short_attrs<__nv_bfloat16, true>(d, out)
               : short_attrs<__nv_bfloat16, false>(d, out);
  if (dtype == APEX_F16)
    return ext ? short_attrs<__half, true>(d, out)
               : short_attrs<__half, false>(d, out);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `ranks` CTAs (1 ..= 8) of the 16-bit cluster
// kernel at head size d fit on the device at once.
extern "C" int apex_flash_bwd_short_clusters(int dtype, int d, int ranks,
                                             int* out) {
  if (ranks < 1 || ranks > kMaxRanks) return (int)cudaErrorInvalidValue;
  if (dtype == APEX_BF16) return short_clusters<__nv_bfloat16>(d, ranks, out);
  if (dtype == APEX_F16) return short_clusters<__half>(d, ranks, out);
  return (int)cudaErrorInvalidValue;
}
