// Kernel row 10: the weight-only int8 matmul  y = x @ (wire * scale).
//
// Replaces apex_tpu/ops/dense.py:_dq_kernel (launched by _dq_pallas):
// x [M, K] in the compute dtype, wire [K, N] int8, scale [K/kb, N] fp32
// with one scale per (kb-row block of the contraction axis, column);
// y [M, N] in x's dtype, accumulated in fp32.  The TPU kernel's k grid
// is the quantization blocking: it dots each [kb, N] tile and multiplies
// the partial by the tile's scale row before adding it to the
// accumulator.  These kernels do the same: the partial of each k block
// lives in registers and is scaled when the block ends.
//
// Bound on the H100: bytes at decode (M = the engine's 32 lanes: the
// whole int8 slab is read for 2*M flops per weight byte), operations at
// prefill (M of 1024 and more).  Three routes, one entry point each:
//
// * apex_dense_int8, the tensor-core route above 64 rows (16-bit x,
//   kb % 32 == 0, N % 16 == 0): row 9's int8-slab GEMM (sm90_gemm.cuh)
//   with one group of all M rows: TMA ring, the int8 tile widened to x's
//   16-bit type (exact for |q| <= 127) by the consumer warpgroups, wgmma
//   m64n128k16 into an fp32 partial per scale block, scaled per column in
//   registers into a second accumulator.  A product of two 16-bit floats
//   is exact in fp32, so this is the TPU kernel's function up to
//   summation order.
//
// * apex_dense_int8_decode, the same shapes at M <= 64 (decode): the
//   operand roles swap, y^T = W^T x^T, so the weight's N fills wgmma's M of
//   64 and no zero rows are multiplied: the widened [32 k, 64 n] tile is
//   the transposed (MN-major) A and x's rows the K-major B, n = M rounded
//   up to 16, 32 or 64.  The per-column scale becomes a per-row one.  A
//   CTA of one warpgroup owns 64 columns and a range of whole scale blocks;
//   the splits of the contraction are the CTAs of one thread-block cluster
//   (up to 8), whose fp32 partials are added in cluster-rank order through
//   distributed shared memory and rounded once: one launch, no partials in
//   device memory, no atomics.  Its loads (x and the int8 tile of each
//   chunk of 128 k rows, or 32 when kb is not a multiple of 128) are
//   issued up to 2 (8) chunks ahead by one thread; the CTA widens the
//   next chunk while the current chunk's products run.  The peers'
//   partials of an output element are read at once and then added in
//   rank order.
//
// * apex_dense_int8_simt, fp32 x and the shapes the tiles do not take (kb
//   not a multiple of 32, N not of 16): the CUDA cores, one CTA per (row,
//   256 columns), the x row staged in shared memory, one column per
//   thread, fp32 products summed block by block.
#include <cooperative_groups.h>

#include "sm90_gemm.cuh"

namespace {

// ----------------------------------------------------------- decode --

constexpr int kDN = 64;  // weight columns per CTA: wgmma's M
constexpr int kDThreads = 128;
constexpr int kMaxCluster = 8;

// KC k rows per chunk: 128 (one chunk per scale block of 128, the GPT-2
// slabs) or 32 (any kb % 32 == 0); MP = M rounded up to 16, 32 or 64.
template <int MP, int KC>
struct Dec {
  static constexpr int STAGES = KC == 128 ? 2 : 8;  // chunks in flight
  using XT = sm90::Tile<KC, MP>;   // x rows: the K-major B
  using WT = sm90::Tile<kDN, KC>;  // widened weights: the MN-major A
  static constexpr int RAW = KC * kDN;
  static constexpr int x_off = 0;
  static constexpr int raw_off = x_off + STAGES * XT::BYTES;
  static constexpr int wide_off = raw_off + STAGES * RAW;
  static constexpr int red_off = wide_off + 2 * WT::BYTES;
  static constexpr int bar_off = red_off + MP * kDN * 4;
  static constexpr int bytes = bar_off + STAGES * 8 + 1024;
};

template <typename T, int MP, int KC>
__global__ void __launch_bounds__(kDThreads)
    dq_decode_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tw,
                          const float* __restrict__ scale, T* __restrict__ y,
                          int M, int K, int N, int kb) {
  using C = Dec<MP, KC>;
  constexpr int S = C::STAGES;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  float* red = reinterpret_cast<float*>(smem + C::red_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * kDN;
  // this CTA's whole scale blocks of the contraction axis
  const int nkb = K / kb;
  const int blk_lo = rank * nkb / splits, blk_hi = (rank + 1) * nkb / splits;
  const int k_lo = blk_lo * kb;
  const int nch = (blk_hi - blk_lo) * kb / KC;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) sm90::bar_init(&full[s], 1);
    sm90::bar_init_fence();
  }
  __syncthreads();
  // chunk c: x's rows (one box per 64-column panel) and the int8 tile
  auto issue = [&](int c) {
    const int s = c % S;
    unsigned char* xs = smem + C::x_off + s * C::XT::BYTES;
    sm90::bar_arrive_tx(&full[s], C::XT::BYTES + C::RAW);
#pragma unroll
    for (int p = 0; p < C::XT::PANELS; ++p)
      sm90::tma_load_2d(xs + p * C::XT::PANEL_BYTES, &tx, &full[s],
                        k_lo + c * KC + p * C::XT::W, 0);
    sm90::tma_load_2d(smem + C::raw_off + s * C::RAW, &tw, &full[s], n0,
                      k_lo + c * KC);
  };
  if (tid == 0)
    for (int c = 0; c < min(nch, S); ++c) issue(c);
  // chunk c's int8 tile widened into wide[c % 2], 16 bytes at a time
  auto widen = [&](int c) {
    const int s = c % S;
    sm90::bar_wait(&full[s], (c / S) & 1);
    const unsigned char* raw = smem + C::raw_off + s * C::RAW;
    const uint32_t wide =
        sm90::smem_addr(smem + C::wide_off + (c % 2) * C::WT::BYTES);
#pragma unroll
    for (int i = tid; i < C::RAW / 16; i += kDThreads) {
      const int k = i >> 2, n = (i & 3) * 16;
      uint4 lo, hi;
      sm90::widen16<T>(*reinterpret_cast<const uint4*>(raw + k * kDN + n),
                       lo, hi);
      sm90::st_shared16(sm90::swz_addr<kDN, KC>(wide, k, n), lo);
      sm90::st_shared16(sm90::swz_addr<kDN, KC>(wide, k, n + 8), hi);
    }
    sm90::fence_proxy_async();
  };

  float acc[MP / 2], part[MP / 2];
#pragma unroll
  for (int r = 0; r < MP / 2; ++r) acc[r] = 0.0f;
  // this thread's accumulator rows are weight columns nc and nc + 8
  const int nc = n0 + warp * 16 + (lane >> 2);
  widen(0);
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    const int kend = k_lo + (c + 1) * KC;
    const bool block_end = kend % kb == 0;
    // the scale row of a block that ends here, loaded before the products
    float s0 = 0.0f, s1 = 0.0f;
    if (block_end) {
      const float* srow = scale + (size_t)(kend / kb - 1) * N;
      if (nc < N) s0 = __ldg(srow + nc);
      if (nc + 8 < N) s1 = __ldg(srow + nc + 8);
    }
    const uint32_t wa =
        sm90::smem_addr(smem + C::wide_off + (c % 2) * C::WT::BYTES);
    const uint32_t xb =
        sm90::smem_addr(smem + C::x_off + (c % S) * C::XT::BYTES);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      sm90::mma_ss<T, MP, 0, 1>(part, sm90::desc_mn<kDN, KC>(wa, kk),
                                sm90::desc_k<KC, MP>(xb, 0, kk),
                                (k_lo + c * KC + kk * 16) % kb != 0);
    sm90::mma_commit();
    // the next chunk widens while these products run, into the buffer
    // chunk c - 1's products read: every thread waited for them before
    // the last barrier
    if (c + 1 < nch) widen(c + 1);
    sm90::mma_wait<0>();
    if (block_end) {  // a scale block ends: scale its rows and add
      sm90::fence_regs(part);
#pragma unroll
      for (int r = 0; r < MP / 2; ++r)
        acc[r] += part[r] * (sm90::frag_row(r) ? s1 : s0);
    }
    __syncthreads();
    // chunk c is consumed by every thread (its products waited for, its
    // int8 tile widened a chunk ago): its stage takes chunk c + S
    if (tid == 0 && c + S < nch) issue(c + S);
  }

  // the cluster's partials, [m][n] fp32, added in rank order; each
  // element's peers are read at once, then summed in order
#pragma unroll
  for (int r = 0; r < MP / 2; ++r)
    red[sm90::frag_col(r, lane) * kDN + warp * 16 + (lane >> 2) +
        8 * sm90::frag_row(r)] = acc[r];
  cluster.sync();
  const float* peer[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    peer[q] = cluster.map_shared_rank(red, q < splits ? q : 0);
  const int E = M * kDN;
  const int e_hi = (rank + 1) * E / splits;
  for (int e = rank * E / splits + tid; e < e_hi; e += kDThreads) {
    const int m = e / kDN, n = e % kDN;
    if (n0 + n >= N) continue;
    float v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) v[q] = q < splits ? peer[q][e] : 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < splits) sum += v[q];
    y[(size_t)m * N + n0 + n] = apex_from_float<T>(sum);
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

template <typename T, int MP, int KC>
int launch_decode(const void* x, const void* wire, const void* scale, void* y,
                  int M, int K, int N, int kb, int splits,
                  cudaStream_t stream) {
  using C = Dec<MP, KC>;
  CUtensorMap tx, tw;
  const uint64_t xd[2] = {(uint64_t)K, (uint64_t)M};
  const uint32_t xb[2] = {(uint32_t)C::XT::W, (uint32_t)MP};
  int err = sm90::encode_map<T>(&tx, x, 2, xd, xb);
  const uint64_t wd[2] = {(uint64_t)N, (uint64_t)K};
  const uint32_t wb[2] = {(uint32_t)kDN, (uint32_t)KC};
  if (err == 0) err = sm90::encode_map<int8_t>(&tw, wire, 2, wd, wb);
  if (err == 0)
    err = sm90::set_smem(dq_decode_sm90_kernel<T, MP, KC>, C::bytes);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kDN - 1) / kDN, 1);
  cfg.blockDim = dim3(kDThreads, 1, 1);
  cfg.dynamicSmemBytes = C::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* sp = (const float*)scale;
  T* yp = (T*)y;
  void* args[] = {&tx, &tw, &sp, &yp, &M, &K, &N, &kb};
  err = (int)cudaLaunchKernelExC(
      &cfg, (const void*)dq_decode_sm90_kernel<T, MP, KC>, args);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <typename T, int KC>
int decode_rows(const void* x, const void* wire, const void* scale, void* y,
                int M, int K, int N, int kb, int splits,
                cudaStream_t stream) {
  if (M <= 16)
    return launch_decode<T, 16, KC>(x, wire, scale, y, M, K, N, kb, splits,
                                    stream);
  if (M <= 32)
    return launch_decode<T, 32, KC>(x, wire, scale, y, M, K, N, kb, splits,
                                    stream);
  return launch_decode<T, 64, KC>(x, wire, scale, y, M, K, N, kb, splits,
                                  stream);
}

template <typename T>
int decode(const void* x, const void* wire, const void* scale, void* y,
           int M, int K, int N, int kb, int splits, cudaStream_t stream) {
  return kb % 128 == 0
             ? decode_rows<T, 128>(x, wire, scale, y, M, K, N, kb, splits,
                                   stream)
             : decode_rows<T, 32>(x, wire, scale, y, M, K, N, kb, splits,
                                  stream);
}

// ------------------------------------------------------------- simt --

// Any dtype and shape on the CUDA cores: CTA (column block, row), the
// x row in shared memory, one output column per thread.
constexpr int kColThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kColThreads) dq_simt_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wire,
    const float* __restrict__ scale, T* __restrict__ y, int M, int K, int N,
    int kb) {
  extern __shared__ float sx[];
  const int row = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += kColThreads)
    sx[k] = apex_to_float(x[(size_t)row * K + k]);
  __syncthreads();
  const int n = blockIdx.x * kColThreads + threadIdx.x;
  if (n >= N) return;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kb) {
    float part = 0.0f;
    for (int k = k0; k < k0 + kb; ++k)
      part += sx[k] * (float)wire[(size_t)k * N + n];
    acc += part * scale[(size_t)(k0 / kb) * N + n];
  }
  y[(size_t)row * N + n] = apex_from_float<T>(acc);
}

template <typename T>
int launch_simt(const void* x, const void* wire, const void* scale, void* y,
                int M, int K, int N, int kb, cudaStream_t stream) {
  const int bytes = K * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((N + kColThreads - 1) / kColThreads, M);
  dq_simt_kernel<T><<<grid, kColThreads, bytes, stream>>>(
      (const T*)x, (const int8_t*)wire, (const float*)scale, (T*)y, M, K, N,
      kb);
  return (int)cudaGetLastError();
}

// the shapes both tensor-core routes take
bool tiles_take(int K, int N, int kb) {
  return K > 0 && N > 0 && kb > 0 && kb % 32 == 0 && K % kb == 0 &&
         N % 16 == 0;
}

}  // namespace

// x [M, K] bf16/fp16 with M > 64; wire [K, N] int8; scale [K / kb, N]
// fp32; y [M, N] in x's dtype; tiles of 64 columns with narrow = 1 (when
// kb % 64 == 0), else 128.  Needs kb % 32 == 0, K % kb == 0, N % 16 == 0
// and 16-byte-aligned x and wire.
extern "C" int apex_dense_int8(const void* x, const void* wire,
                               const void* scale, void* y, int M, int K,
                               int N, int kb, int narrow, int dtype,
                               cudaStream_t stream) {
  if (M <= 0 || !tiles_take(K, N, kb)) return (int)cudaErrorInvalidValue;
  if (dtype == APEX_BF16)
    return gemm::launch_int8<__nv_bfloat16>(x, wire, scale, nullptr, y, M, K,
                                            N, 1, kb, narrow, stream);
  if (dtype == APEX_F16)
    return gemm::launch_int8<__half>(x, wire, scale, nullptr, y, M, K, N, 1,
                                     kb, narrow, stream);
  return (int)cudaErrorInvalidValue;
}

// The same operands at 1 <= M <= 64; splits (1 ..= min(8, K / kb)) is the
// cluster's size, whole scale blocks per CTA.
extern "C" int apex_dense_int8_decode(const void* x, const void* wire,
                                      const void* scale, void* y, int M,
                                      int K, int N, int kb, int splits,
                                      int dtype, cudaStream_t stream) {
  if (M <= 0 || M > 64 || !tiles_take(K, N, kb) || splits < 1 ||
      splits > kMaxCluster || splits > K / kb)
    return (int)cudaErrorInvalidValue;
  if (dtype == APEX_BF16)
    return decode<__nv_bfloat16>(x, wire, scale, y, M, K, N, kb, splits,
                                 stream);
  if (dtype == APEX_F16)
    return decode<__half>(x, wire, scale, y, M, K, N, kb, splits, stream);
  return (int)cudaErrorInvalidValue;
}

// Any float dtype and shape with K % kb == 0 and K <= 57344 (the x row in
// shared memory).
extern "C" int apex_dense_int8_simt(const void* x, const void* wire,
                                    const void* scale, void* y, int M, int K,
                                    int N, int kb, int dtype,
                                    cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || kb <= 0 || K % kb != 0 || K > 57344)
    return (int)cudaErrorInvalidValue;
  APEX_DISPATCH_FLOAT(dtype, T, {
    return launch_simt<T>(x, wire, scale, y, M, K, N, kb, stream);
  });
  return (int)cudaErrorInvalidValue;
}

// {registers, shared memory per CTA, CTAs per SM, spill bytes} of the
// tensor-core route (route 0: stages of 64 k rows; route 3: of 32; route
// 4: of 64 at 64 columns) or of the decode route at n = mp with chunks of
// 128 (route 1) or 32 k rows (route 2).
extern "C" int apex_dense_int8_attrs(int route, int dtype, int mp, int* out) {
  const bool bf = dtype == APEX_BF16;
  if (!bf && dtype != APEX_F16) return (int)cudaErrorInvalidValue;
  if (route == 0)
    return bf ? gemm::attrs<__nv_bfloat16, gemm::kInt8>(out)
              : gemm::attrs<__half, gemm::kInt8>(out);
  if (route == 3)
    return bf ? gemm::attrs<__nv_bfloat16, gemm::kInt8K32>(out)
              : gemm::attrs<__half, gemm::kInt8K32>(out);
  if (route == 4)
    return bf ? gemm::attrs<__nv_bfloat16, gemm::kInt8N64>(out)
              : gemm::attrs<__half, gemm::kInt8N64>(out);
#define APEX_DQ_ATTRS(MP, KC)                                             \
  if (mp == MP)                                                           \
    return bf ? sm90::kernel_attrs(                                       \
                    dq_decode_sm90_kernel<__nv_bfloat16, MP, KC>,         \
                    Dec<MP, KC>::bytes, kDThreads, out)                   \
              : sm90::kernel_attrs(dq_decode_sm90_kernel<__half, MP, KC>, \
                                   Dec<MP, KC>::bytes, kDThreads, out);
  if (route == 1) {
    APEX_DQ_ATTRS(16, 128)
    APEX_DQ_ATTRS(32, 128)
    APEX_DQ_ATTRS(64, 128)
  }
  if (route == 2) {
    APEX_DQ_ATTRS(16, 32)
    APEX_DQ_ATTRS(32, 32)
    APEX_DQ_ATTRS(64, 32)
  }
#undef APEX_DQ_ATTRS
  return (int)cudaErrorInvalidValue;
}
