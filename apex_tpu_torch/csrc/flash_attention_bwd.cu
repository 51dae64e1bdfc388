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
// CTA per (64-query tile, batch*head) looping over key tiles up to the
// diagonal.  K7: one CTA per (64-key tile, batch*kv-group) looping over
// the group's rep query heads and, per head, over the query tiles from
// the diagonal on; causal tiles above the diagonal are never visited.
// Under GQA the rep heads accumulate into one dk/dv row as in
// _bwd_dkv_kernel (:464-474).  No atomics: every output tile has one
// writer, so the result is deterministic.
//
// Numbers.  The TPU kernels keep p and ds in fp32.  Here 16-bit inputs
// run all four products on the tensor cores (WMMA 16x16x16, fp32
// accumulators), so p and ds are rounded to the input type before the
// dv, dk and dq products; scores, dp, lse and delta stay fp32.  fp32
// inputs take the same tiles through a CUDA-core 16x16x16 product and
// round nothing.
//
// Bound on the H100 at b16 s1024 n12 d64 bf16 causal: operations.  The
// two kernels do 7 tile products per open (query, key) tile pair (K6: s,
// dp, dq; K7: s, dp, dv, dk), ~4.6 x the forward's flops, against ~50 MB
// of q, k, v, o, do and gradients.  Design: four warps per CTA, each
// owning 16 rows; the input tiles sit in shared memory in their own type,
// scores and dp in fp32 shared memory (two lanes per row do the masked
// elementwise step), and the dq / dk / dv sums stay in WMMA accumulator
// fragments in registers across the whole loop.  Tiles are loaded
// synchronously; a TMA ring with wgmma is the next step (ROADMAP.md).
#include "flash_bwd_tile.cuh"

namespace {

// K6: dq for one (64-query tile, batch*head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ kpm, T* __restrict__ dq,
                        int sq, int sk, int n, int g, float scale,
                        int causal) {
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
  const int qstride = n * D, kstride = g * D;

  const size_t qbase = (((size_t)b * sq + q0) * n + h) * D;
  load_tile<T, D>(sQ, q + qbase, q0, sq, qstride);
  load_tile<T, D>(sdO, dout + qbase, q0, sq, qstride);
  load_row_stats(sL, sDl, lse, delta, bh, q0, sq);

  Acc<T> acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i].zero();

  const int kv_end = causal ? min(sk, q0 + kB) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();  // the previous tile's readers of sK/sV are done
    const size_t kbase = (((size_t)b * sk + k0) * g + kvh) * D;
    load_tile<T, D>(sK, k + kbase, k0, sk, kstride);
    load_tile<T, D>(sV, v + kbase, k0, sk, kstride);
    __syncthreads();
    probs_and_ds<T, D>(smem, kpm, b, sk, q0, k0, scale, causal);
    // dq[16 x D] += ds[16 x 64] k[64 x D]
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb)
#pragma unroll
      for (int kk = 0; kk < kB / 16; ++kk)
        mma16<true, true>(acc[nb], sdS + warp * 16 * L::LDP + kk * 16,
                          L::LDP, sK + kk * 16 * L::LDT + nb * 16, L::LDT);
  }

  float* stage = sS + warp * 16 * L::LDS;
  T* out = dq + (((size_t)b * sq) * n + h) * D;
#pragma unroll
  for (int nb = 0; nb < D / 16; ++nb)
    store_acc<T>(acc[nb], stage, L::LDS, out, q0 + warp * 16, sq,
                 (size_t)qstride, nb * 16);
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
                         float scale, int causal) {
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
  const int qstride = n * D, kstride = g * D;

  const size_t kbase = (((size_t)b * sk + k0) * g + kvh) * D;
  load_tile<T, D>(sK, k + kbase, k0, sk, kstride);
  load_tile<T, D>(sV, v + kbase, k0, sk, kstride);

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
      __syncthreads();  // the previous tile's readers are done
      const size_t qbase = (((size_t)b * sq + q0) * n + h) * D;
      load_tile<T, D>(sQ, q + qbase, q0, sq, qstride);
      load_tile<T, D>(sdO, dout + qbase, q0, sq, qstride);
      load_row_stats(sL, sDl, lse, delta, bh, q0, sq);
      __syncthreads();
      probs_and_ds<T, D>(smem, kpm, b, sk, q0, k0, scale, causal);
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
  const size_t off = (((size_t)b * sk) * g + kvh) * D;
#pragma unroll
  for (int nb = 0; nb < D / 16; ++nb) {
    store_acc<T>(dk_acc[nb], stage, L::LDS, dk + off, k0 + warp * 16, sk,
                 (size_t)kstride, nb * 16);
    store_acc<T>(dv_acc[nb], stage, L::LDS, dv + off, k0 + warp * 16, sk,
                 (size_t)kstride, nb * 16);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* kpm, void* dq,
              int b, int sq, int sk, int n, int g, float scale, int causal,
              cudaStream_t stream) {
  const int bytes = Smem<T, D>::bytes;
  int err = prepare(flash_bwd_dq_kernel<T, D>, bytes);
  if (err != 0) return err;
  const dim3 grid((sq + kB - 1) / kB, b * n);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const float*)kpm, (T*)dq, sq,
      sk, n, g, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* kpm, void* dk,
               void* dv, int b, int sq, int sk, int n, int g, float scale,
               int causal, cudaStream_t stream) {
  const int bytes = Smem<T, D>::bytes;
  int err = prepare(flash_bwd_dkv_kernel<T, D>, bytes);
  if (err != 0) return err;
  const dim3 grid((sk + kB - 1) / kB, b * g);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const float*)kpm, (T*)dk,
      (T*)dv, sq, sk, n, g, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, do [b, sq, n, d] and k, v [b, sk, g, d] of dtype; lse, delta
// [b*n, sq] fp32; kpm [b, sk] fp32 additive or NULL; dq like q.
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* kpm, void* dq,
                                 int b, int sq, int sk, int n, int g, int d,
                                 float scale, int causal, int dtype,
                                 cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || g <= 0 || n % g != 0)
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    APEX_DISPATCH_HEAD_DIM(d, D, (launch_dq<T, D>(q, k, v, dout, lse, delta,
                                                  kpm, dq, b, sq, sk, n, g,
                                                  scale, causal, stream)));
  });
  return (int)cudaErrorInvalidValue;
}

// As apex_flash_bwd_dq; dk, dv like k (summed over each group's heads).
extern "C" int apex_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* kpm, void* dk, void* dv, int b,
                                  int sq, int sk, int n, int g, int d,
                                  float scale, int causal, int dtype,
                                  cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || g <= 0 || n % g != 0)
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    APEX_DISPATCH_HEAD_DIM(d, D, (launch_dkv<T, D>(q, k, v, dout, lse, delta,
                                                   kpm, dk, dv, b, sq, sk, n,
                                                   g, scale, causal,
                                                   stream)));
  });
  return (int)cudaErrorInvalidValue;
}
