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
// Grid.  The TPU kernel walks (b*n, q-block) in order and carries fp32
// dk/dv accumulators of [skp, d] in VMEM across its q-blocks; Hopper
// blocks run in no order, and at skp = 512, d = 64 the two accumulators
// (256 KB) exceed one SM's shared memory.  So each CTA owns one (64-key
// tile, batch*kv-group) pair, keeps that tile's dk and dv in WMMA
// accumulator fragments in registers, and loops over the group's rep
// query heads and their query tiles (from the diagonal on when causal).
// For each query tile it writes that tile's dq contribution, ds k, as an
// fp32 partial [key tile, b*n, sqp, d]; a second kernel sums the
// partials of each query row over the key tiles in fixed order and
// rounds once.  Every output has one writer and no atomics are used, so
// the result is deterministic, as with K5 and row 10.
//
// Numbers.  As K6/K7: p and ds are rounded to the input type before the
// tensor-core products (WMMA 16x16x16, fp32 accumulators); scores, dp,
// lse, delta, the partials and their sum stay fp32.  fp32 inputs take a
// CUDA-core product and round nothing.
//
// Bound on the H100 at b8 s512 n16 d64 bf16 (BERT-large), key padding:
// about even between operations (5 products of 2*d flops per open
// (query, key) pair, ~0.02 ms at 989 TFLOP/s) and bytes (q, k, v, do,
// dq, dk, dv, lse, delta: ~59 MB, ~0.018 ms).  This design adds the fp32
// partials (written once, read once: 2 * nkt * b*n * sqp * d * 4 bytes,
// 268 MB at that shape) and loads its tiles synchronously; a TMA ring
// with wgmma and a dq sum held in shared memory across key tiles are the
// next steps.
#include "flash_bwd_tile.cuh"

namespace {

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
                           int n, int g, float scale, int causal) {
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
  const int qstride = n * D, kstride = g * D;
  const int sqp = (sq + kB - 1) / kB * kB;

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
      // this warp's 16 rows of the dq partial: ds[16 x 64] k[64 x D],
      // stored straight to global memory
      float* part = dq_part + (((size_t)kt * b_total * n + bh) * sqp + q0 +
                               warp * 16) * D;
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
  const size_t off = (((size_t)b * sk) * g + kvh) * D;
#pragma unroll
  for (int nb = 0; nb < D / 16; ++nb) {
    store_acc<T>(dk_acc[nb], stage, L::LDS, dk + off, k0 + warp * 16, sk,
                 (size_t)kstride, nb * 16);
    store_acc<T>(dv_acc[nb], stage, L::LDS, dv + off, k0 + warp * 16, sk,
                 (size_t)kstride, nb * 16);
  }
}

// dq[b, row, h, :] = sum over the key tiles that visited the row's query
// tile (all of them, or those up to the diagonal when causal) of the
// partials, in key-tile order; four columns per thread.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_short_dq_sum(const float* __restrict__ dq_part,
                           T* __restrict__ dq, int b_total, int sq, int sk,
                           int n, int causal) {
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
  const int b = bh / n, h = bh % n;
  T* out = dq + (((size_t)b * sq + row) * n + h) * D + c;
  out[0] = apex_from_float<T>(acc.x);
  out[1] = apex_from_float<T>(acc.y);
  out[2] = apex_from_float<T>(acc.z);
  out[3] = apex_from_float<T>(acc.w);
}

template <typename T, int D>
int launch_short(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* kpm, void* dq_part, void* dq, void* dk,
                 void* dv, int b, int sq, int sk, int n, int g, float scale,
                 int causal, cudaStream_t stream) {
  const int bytes = Smem<T, D>::bytes;
  int err = prepare(flash_bwd_short_kernel<T, D>, bytes);
  if (err != 0) return err;
  const dim3 grid((sk + kB - 1) / kB, b * g);
  flash_bwd_short_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const float*)kpm,
      (float*)dq_part, (T*)dk, (T*)dv, b, sq, sk, n, g, scale, causal);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long total = (long long)b * n * sq * (D / 4);
  flash_bwd_short_dq_sum<T, D><<<(unsigned)((total + 255) / 256), 256, 0,
                                 stream>>>((const float*)dq_part, (T*)dq, b,
                                           sq, sk, n, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, do [b, sq, n, d] and k, v [b, sk, g, d] of dtype; lse, delta
// [b*n, sq] fp32; kpm [b, sk] fp32 additive or NULL; dq_part fp32
// scratch of [ceil(sk/64), b*n, ceil(sq/64)*64, d]; dq like q, dk and dv
// like k (summed over each group's heads).
extern "C" int apex_flash_bwd_short(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* kpm, void* dq_part, void* dq,
                                    void* dk, void* dv, int b, int sq, int sk,
                                    int n, int g, int d, float scale,
                                    int causal, int dtype,
                                    cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || g <= 0 || n % g != 0)
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    APEX_DISPATCH_HEAD_DIM(d, D, (launch_short<T, D>(
                                     q, k, v, dout, lse, delta, kpm, dq_part,
                                     dq, dk, dv, b, sq, sk, n, g, scale,
                                     causal, stream)));
  });
  return (int)cudaErrorInvalidValue;
}
