// K2: flash-attention forward (BSND), causal and key padding, GQA.
//
// Replaces apex_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd_pallas): FlashAttention-2 online softmax with an additive fp32
// key-padding row, the causal mask from row/column indices, the kv tail
// mask at sk, grouped K/V read by index (kv head = h / (n / g), never
// repeated), and o plus lse written with the -1e30 sentinel and the
// l == 0 guard on fully masked rows.  The probabilities are rounded to
// V's dtype before the PV product, as the TPU kernel does.
//
// Bound on the H100: at the serving shapes (b=8, s<=512, d=64) bytes —
// q, k, v and o are read and written once and the causal, padded pairs
// need fewer flops than the ~295 flop/byte ridge; longer sequences turn
// it compute-bound (4·d flops per open (query, key) pair at the 989
// TFLOP/s bf16 tensor-core rate).
// Design: one CTA per (64-query tile, batch·head) with a loop over
// 64-key tiles; kv tiles wholly above the diagonal are never loaded.
// 16-bit inputs run QK^T and PV on the tensor cores (WMMA 16x16x16, fp32
// accumulators, four warps of 16 query rows): Q/K/V tiles sit in shared
// memory in their own type, scores and the output accumulator in fp32
// shared memory, and two lanes per row run the masked online softmax.
// fp32 inputs take a CUDA-core path: Q, K and V tiles in shared memory
// as fp32 (rows padded one word), four threads per query row, each
// scoring 16 keys and owning d/4 output dims.  Tiles are loaded
// synchronously; a TMA ring with wgmma is the next step (ROADMAP.md).
#include <mma.h>

#include "common.cuh"

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
                     int sk, int n, int g, float scale, int causal) {
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

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int qs = q0 + rr;
    sQ[rr * LD + dd] =
        qs < sq ? apex_to_float(q[(((size_t)b * sq + qs) * n + h) * D + dd])
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
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int t = i / D, dd = i % D;
      const int ks = k0 + t;
      float kval = 0.0f, vval = 0.0f;
      if (ks < sk) {
        const size_t off = (((size_t)b * sk + ks) * g + kvh) * D + dd;
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
      const bool pred = col < sk && (!causal || col <= row);
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
      ps += p;
      sP[r * LP + sub + 4 * j] = apex_round<T>(p);
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
    T* orow = o + (((size_t)b * sq + row) * n + h) * D;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      orow[sub + 4 * i] = apex_from_float<T>(acc[i] / safe_l);
    if (sub == 0)
      lse[(size_t)bh * sq + row] =
          l == 0.0f ? APEX_NEG_INF : m + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// 16-bit inputs: QK^T and PV on the tensor cores (WMMA 16x16x16, fp32
// accumulators).  Four warps per 64-query tile, each owning 16 rows.  The
// scores go to shared memory (fp32) for the masked online softmax, done
// by two lanes per row; the probabilities are written back in T (the
// TPU kernel's rounding of p to V's dtype) and the output accumulator
// lives in shared memory (fp32), rescaled by each row's alpha before
// the PV product adds into it.
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;

template <typename T, int D>
struct TcSmem {
  static constexpr int LDT = D + 8;         // T tiles (Q, K, V)
  static constexpr int LDS = kBK + 4;       // fp32 scores
  static constexpr int LDP = kBK + 8;       // T probabilities
  static constexpr int LDO = D + 4;         // fp32 output accumulator
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kBQ * LDT * (int)sizeof(T);
  static constexpr int v_off = k_off + kBK * LDT * (int)sizeof(T);
  static constexpr int s_off = v_off + kBK * LDT * (int)sizeof(T);
  static constexpr int p_off = s_off + kBQ * LDS * 4;
  static constexpr int o_off = p_off + kBQ * LDP * (int)sizeof(T);
  static constexpr int a_off = o_off + kBQ * LDO * 4;
  static constexpr int bytes = a_off + kBQ * 4;
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          int row0, int nrows, int stride) {
  // rows x D of T from src (row r at src + r * stride) into dst with
  // leading dimension D + 8; rows at or past nrows are zero
  constexpr int kVec = 8;                    // 16 bytes of 16-bit values
  constexpr int LDT = D + 8;
  for (int i = threadIdx.x; i < rows * (D / kVec); i += kTcThreads) {
    const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ kpm,
                        T* __restrict__ o, float* __restrict__ lse, int sq,
                        int sk, int n, int g, float scale, int causal) {
  using namespace nvcuda;
  using L = TcSmem<T, D>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  T* sQ = reinterpret_cast<T*>(tc_smem + L::q_off);
  T* sK = reinterpret_cast<T*>(tc_smem + L::k_off);
  T* sV = reinterpret_cast<T*>(tc_smem + L::v_off);
  float* sS = reinterpret_cast<float*>(tc_smem + L::s_off);
  T* sP = reinterpret_cast<T*>(tc_smem + L::p_off);
  float* sO = reinterpret_cast<float*>(tc_smem + L::o_off);
  float* sAlpha = reinterpret_cast<float*>(tc_smem + L::a_off);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / n;
  const int h = bh % n;
  const int kvh = h / (n / g);
  const int q0 = blockIdx.x * kBQ;
  const int qstride = n * D, kstride = g * D;

  load_tile<T, D>(sQ, q + (((size_t)b * sq + q0) * n + h) * D, kBQ, q0, sq,
                  qstride);
  for (int i = threadIdx.x; i < kBQ * L::LDO; i += kTcThreads) sO[i] = 0.0f;

  // softmax ownership: lane pair (2r, 2r+1) of warp w holds row
  // w*16 + r; each lane scores half of the 64 keys of a tile
  const int lrow = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int row = q0 + lrow;
  float m = APEX_NEG_INF, l = 0.0f;

  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers of sK/sV are done
    const size_t kbase = (((size_t)b * sk + k0) * g + kvh) * D;
    load_tile<T, D>(sK, k + kbase, kBK, k0, sk, kstride);
    load_tile<T, D>(sV, v + kbase, kBK, k0, sk, kstride);
    __syncthreads();

    // S[16 x 64] of this warp = Q[16 x D] K^T
#pragma unroll
    for (int nb = 0; nb < kBK / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + (warp * 16) * L::LDT + kk * 16,
                               L::LDT);
        wmma::load_matrix_sync(fb, sK + (nb * 16) * L::LDT + kk * 16,
                               L::LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + (warp * 16) * L::LDS + nb * 16, acc,
                              L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // masked online softmax over this row's 32 keys, shared with the pair
    float* srow = sS + lrow * L::LDS + half * 32;
    float mx = APEX_NEG_INF;
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      float sv = srow[c] * scale;
      if (kpm != nullptr && col < sk) sv += kpm[(size_t)b * sk + col];
      const bool pred = col < sk && (!causal || col <= row);
      sv = pred ? sv : APEX_NEG_INF;
      srow[c] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const bool live = m_new > APEX_NEG_INF / 2;
    const float alpha = live ? expf(m - m_new) : 0.0f;
    float ps = 0.0f;
    T* prow = sP + lrow * L::LDP + half * 32;
    for (int c = 0; c < 32; ++c) {
      const float p = live ? expf(srow[c] - m_new) : 0.0f;
      ps += p;
      prow[c] = apex_from_float<T>(p);
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l = l * alpha + ps;
    m = m_new;
    if (half == 0) sAlpha[lrow] = alpha;
    __syncwarp();

    // O[16 x D] = alpha * O + P[16 x 64] V[64 x D]
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = warp * 16 + e / D;
      sO[r * L::LDO + e % D] *= sAlpha[r];
    }
    __syncwarp();
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* optr = sO + (warp * 16) * L::LDO + nb * 16;
      wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + (warp * 16) * L::LDP + kk * 16,
                               L::LDP);
        wmma::load_matrix_sync(fb, sV + (kk * 16) * L::LDT + nb * 16,
                               L::LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (row < sq) {
    const float safe_l = l == 0.0f ? 1.0f : l;
    T* orow = o + (((size_t)b * sq + row) * n + h) * D;
    const float* orow_s = sO + lrow * L::LDO;
    for (int d = half; d < D; d += 2)
      orow[d] = apex_from_float<T>(orow_s[d] / safe_l);
    if (half == 0)
      lse[(size_t)bh * sq + row] =
          l == 0.0f ? APEX_NEG_INF : m + logf(safe_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kpm,
           void* o, void* lse, int b, int sq, int sk, int n, int g,
           float scale, int causal, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, b * n);
  if constexpr (sizeof(T) == 2) {
    const int bytes = TcSmem<T, D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_tc_kernel<T, D><<<grid, kTcThreads, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)kpm, (T*)o,
        (float*)lse, sq, sk, n, g, scale, causal);
  } else {
    const int bytes = smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)kpm, (T*)o,
        (float*)lse, sq, sk, n, g, scale, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q [b, sq, n, d], k/v [b, sk, g, d], o like q (dtype), kpm [b, sk] fp32
// additive or NULL, lse [b·n, sq] fp32.  d in {32, 64, 128}.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* kpm, void* o, void* lse, int b,
                              int sq, int sk, int n, int g, int d,
                              float scale, int causal, int dtype,
                              cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || g <= 0 || n % g != 0)
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    switch (d) {
      case 32:
        return launch<T, 32>(q, k, v, kpm, o, lse, b, sq, sk, n, g, scale,
                             causal, stream);
      case 64:
        return launch<T, 64>(q, k, v, kpm, o, lse, b, sq, sk, n, g, scale,
                             causal, stream);
      case 128:
        return launch<T, 128>(q, k, v, kpm, o, lse, b, sq, sk, n, g, scale,
                              causal, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}
