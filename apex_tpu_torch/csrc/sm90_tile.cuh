// Hopper (sm_90a) building blocks of the port's attention kernels: TMA
// tensor maps over BSND tensors, mbarrier rings, wgmma products, register
// rebalancing and signalling within a thread-block cluster.  K2
// (flash_attention.cu), K6 / K7 (flash_attention_bwd.cu) and row 5
// (flash_attention_bwd_short.cu) are built from these.
//
// Tiles.  A tile of `rows` x D 16-bit values sits in shared memory as D / W
// panels of rows x W (W = min(D, 64)), each row W * 2 bytes, swizzled over
// W * 2 bytes (128B for D >= 64, 64B for D = 32): the layout one TMA box of
// (W, 1, rows, 1) writes, and the canonical wgmma layout of that swizzle.
// Every panel starts on a 1024-byte boundary.
//
// Operands.  A tile read with its D columns as the reduction (Q, K in
// S = Q K^T) is K-major: the k-th 16-column step starts 32 bytes further
// along the row, and 8-row groups lie 8 * W * 2 bytes apart.  A tile read
// with its rows as the reduction (V in O = P V, K in dQ = dS K) is
// MN-major (transposed B): the k-th 16-row step starts 16 rows further
// down, 8-row groups lie 8 * W * 2 bytes apart and the panels (64 columns
// each) rows * W * 2 bytes apart.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, found
// through cudaGetDriverEntryPoint: the library links no libcuda and
// includes no PyTorch header.  They pass to the kernel as
// `const __grid_constant__ CUtensorMap` parameters, so a launch captured
// in a CUDA graph keeps them by value.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace sm90 {

// ---------------------------------------------------------------- host --

// A failed encode returns kTensorMapError + its CUresult; a driver without
// the entry point returns kTensorMapError.
constexpr int kTensorMapError = 10000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The CUDA driver's encode needs the device's context current on the
// thread.  A host thread that has made no runtime call yet (autograd's
// backward thread, say) has none until the runtime binds it.
inline int bind_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  return (int)err;
}

// The attention kernels' tile width for a head size d: the smallest of
// 32, 64 and 128 that holds it; 0 unless d is a multiple of 8 (TMA needs
// 16-byte row strides) in 8 ..= 128.
inline int head_panel(int d) {
  if (d <= 0 || d > 128 || d % 8 != 0) return 0;
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// The map of a [batch, seq, heads, d] tensor of T (16-bit) as the 4-D
// (d, heads, seq, batch), box (W, 1, rows, 1) with W = min(D, 64) and the
// W * 2-byte swizzle, D = head_panel(d).  Rows past seq, and columns past
// d of a box (d < D), read as zeros.  Returns 0 or an error.
template <typename T>
int encode_bsnd(CUtensorMap* map, const void* base, int batch, int seq,
                int heads, int d, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError;
  if (int err = bind_context()) return err;
  const int D = head_panel(d);
  if (D == 0) return (int)cudaErrorInvalidValue;
  const int w = D < 64 ? D : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)seq * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)w, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      w == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// TMA's element type of T: bf16, fp16, or the bytes of an int8 slab.
template <typename T>
constexpr CUtensorMapDataType map_type() {
  if (std::is_same<T, __half>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (std::is_same<T, __nv_bfloat16>::value)
    return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// The map of a dense row-major tensor of T as `rank` (2 or 3) dimensions,
// innermost first (x [N, K] is (K, N); a slab [G, K, P] is (P, K, G), so
// that a box never crosses a group), box `box`.  The swizzle follows the
// box's inner bytes: 128 or 64 bytes swizzle over themselves (the wgmma
// operand layouts of Tile), anything else, an int8 tile that is widened
// before any product reads it, lands unswizzled.  Boxes past an edge read
// zeros.  Needs a 16-byte-aligned base and every row stride a multiple of
// 16 bytes.  Returns 0 or an error.
template <typename T>
int encode_map(CUtensorMap* map, const void* base, int rank,
               const uint64_t* dims, const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError;
  if (int err = bind_context()) return err;
  cuuint64_t d[3], strides[2];
  cuuint32_t b[3], elem[3] = {1, 1, 1};
  uint64_t stride = sizeof(T);
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
  }
  const uint32_t inner = box[0] * (uint32_t)sizeof(T);
  const CUtensorMapSwizzle swz = inner == 128 && sizeof(T) == 2
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : inner == 64 && sizeof(T) == 2
                                     ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r =
      fn(map, map_type<T>(), rank, const_cast<void*>(base), d, strides, b,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

template <typename Kern>
int set_smem(Kern kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// What the driver reports for a kernel launched with `bytes` of dynamic
// shared memory and kThreads threads: out = {registers per thread, shared
// memory per CTA, resident CTAs per SM, local (spill) bytes per thread}.
template <typename Kern>
int kernel_attrs(Kern kern, int bytes, int threads, int* out) {
  cudaFuncAttributes a;
  int ctas = 0;
  int err = set_smem(kern, bytes);
  if (err == 0) err = (int)cudaFuncGetAttributes(&a, kern);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern,
                                                             threads, bytes);
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = bytes + (int)a.sharedSizeBytes;
  out[2] = ctas;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

// A persistent kernel's grid: one CTA per SM of the current device, or
// one per work item when there are fewer.
inline int persistent_grid(int items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *grid = items < sms ? items : sms;
  return 0;
}

// ------------------------------------------------------------- layout --

// A rows x D tile of a 16-bit type in panels (see the top of the file).
template <int D, int ROWS>
struct Tile {
  static constexpr int W = D < 64 ? D : 64;          // panel width
  static constexpr int PITCH = W * 2;                // bytes per panel row
  static constexpr int PANELS = D / W;
  static constexpr int PANEL_BYTES = ROWS * PITCH;
  static constexpr int BYTES = PANELS * PANEL_BYTES;
  static constexpr uint64_t LAYOUT = W == 64 ? 1 : 2;  // 128B / 64B swizzle
  static_assert(PANEL_BYTES % 1024 == 0, "panels must stay 1024-aligned");
};

// ------------------------------------------------------------- device --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the swizzle atom).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count of the current phase.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Add `bytes` to the transaction count without arriving.
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------ cluster --
// Signalling between the CTAs of one thread-block cluster through each
// other's mbarriers (distributed shared memory).  The threads of a
// writer store into their own shared memory and meet at a barrier; one
// thread per reader fences at cluster scope and arrives on that reader's
// barrier.  A reader waits on its own barrier, fences, and reads the
// writers' shared memory through cluster-mapped pointers.  One fence per
// arrival, not a release on every remote arrive: each cluster-scope
// release waits for the thread's memory operations to complete.

// The cluster address of p's offset in the shared memory of cluster CTA
// `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  return remote;
}

// A 16-byte load from a cluster address (another CTA's shared memory).
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Arrive on the barrier at bar's offset in the shared memory of cluster
// CTA `rank` (after a fence_cluster that orders what it announces).
__device__ __forceinline__ void bar_arrive_rank(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   map_rank(bar, rank))
               : "memory");
}

// Orders this thread's earlier accesses of shared memory, its own or a
// peer's, before its later ones as the whole cluster sees them.
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

// A barrier of the `threads` threads of named barrier `id` (a warpgroup's
// 128, say), which must all call it.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A 4-byte asynchronous copy from global to shared memory (zeros when
// !valid; src must still be a mapped address).  The producer copies the
// small per-tile rows (padding, lse, delta) this way, so it never waits
// for them.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on bar once this thread's earlier cp.async copies have landed;
// the arrival counts toward the barrier's initial count.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

// One TMA box of a 4-D map at (c0, c1, c2, c3) into dst; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One TMA box of a 2-D or 3-D map at (c0, c1[, c2]) into dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Orders this thread's generic writes to shared memory before later
// reads by the asynchronous proxy (wgmma, TMA): a tile written by
// threads (an int8 tile widened to 16 bits) is fenced by its writers
// before they signal the warps whose wgmma reads it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Every panel of a rows x D tile: rows row0.. of head `head`, batch b.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int head, int row0,
                                         int b) {
  using L = Tile<D, ROWS>;
#pragma unroll
  for (int p = 0; p < L::PANELS; ++p)
    tma_load(dst + p * L::PANEL_BYTES, map, bar, p * L::W, head, row0, b);
}

// The shared-memory address of element (row, col) of a rows x D tile:
// the swizzle XORs address bits 4-6 (128B) or 4-5 (64B) with bits 7-9.
template <int D, int ROWS>
__device__ __forceinline__ uint32_t swz_addr(uint32_t tile, int row,
                                             int col) {
  using L = Tile<D, ROWS>;
  const uint32_t off = (col / L::W) * L::PANEL_BYTES + row * L::PITCH +
                       (col % L::W) * 2;
  constexpr uint32_t mask = L::W == 64 ? 7 : 3;
  return tile + (off ^ (((off >> 7) & mask) << 4));
}

// The A fragments (all D / 16 k-steps) of this warpgroup's 64 rows from
// row0 of a rows x D tile, by ldmatrix: an operand that stays for a whole
// work item is read from shared memory once, not once per product.
template <int D, int ROWS>
__device__ __forceinline__ void load_a_frags(uint32_t tile, int row0,
                                             uint32_t (&a)[D / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;  // the 8 x 8 matrix this lane addresses
  const int row = row0 + 16 * ((threadIdx.x >> 5) & 3) + 8 * (m & 1) +
                  (lane & 7);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(swz_addr<D, ROWS>(tile, row, 16 * kk + 8 * (m >> 1))));
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// K-major operand: 64 (A) or N (B) rows from row0, columns 16kk .. 16kk+15.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  using L = Tile<D, ROWS>;
  const uint32_t addr = tile + (kk * 16 / L::W) * L::PANEL_BYTES +
                        row0 * L::PITCH + (kk * 16 % L::W) * 2;
  return make_desc(addr, 16, 8 * L::PITCH, L::LAYOUT);
}

// MN-major (transposed) B operand: rows 16kk .. 16kk+15, all D columns.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using L = Tile<D, ROWS>;
  return make_desc(tile + kk * 16 * L::PITCH, L::PANEL_BYTES, 8 * L::PITCH,
                   L::LAYOUT);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of d across the asynchronous
// products that read and write it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Two floats rounded to T and packed low-first: one 32-bit register of a
// wgmma A fragment, or two adjacent output columns.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// 16 int8 values (one 16-byte load) widened to T, which is exact for
// |q| <= 127: lo holds values 0-7 and hi 8-15, packed low-first as in
// memory.  No I2F (a quarter-rate unit): each byte, flipped to q + 128,
// is placed under a magic exponent by a byte permute and the bias taken
// off in the float unit.  fp16: 0x64uu is the half 1024 + u, minus 1152
// (two values an instruction).  bf16: 0x4B0000uu is the float 2^23 + u,
// minus 2^23 + 128; the bf16 of a small integer is its float's upper half.
template <typename T>
__device__ __forceinline__ void widen16(uint4 raw, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    if constexpr (std::is_same<T, __half>::value) {
      const __half2 bias = __float2half2_rn(1152.0f);
      uint32_t a = __byte_perm(u, 0x64646464u, 0x5140);
      uint32_t b = __byte_perm(u, 0x64646464u, 0x5342);
      __half2 ha = __hsub2(*reinterpret_cast<__half2*>(&a), bias);
      __half2 hb = __hsub2(*reinterpret_cast<__half2*>(&b), bias);
      o[2 * i] = *reinterpret_cast<uint32_t*>(&ha);
      o[2 * i + 1] = *reinterpret_cast<uint32_t*>(&hb);
    } else {
      uint32_t f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[j] = __float_as_uint(
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | j)) -
            8388736.0f);
      o[2 * i] = __byte_perm(f[0], f[1], 0x7632);
      o[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
    }
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// wgmma.mma_async m64nNk16, fp32 accumulators d (N / 2 per thread), A from
// shared memory (descriptor a) or from registers (a[4], the fragment
// layout of an m64 x k16 accumulator slice), B by descriptor; TB = 1
// reads B MN-major, TA = 1 a shared-memory A MN-major (16-bit types
// only; the MN-major descriptor of an m64 A is desc_mn of a 64-column
// tile).  scale_d = 0 overwrites d.

template <typename T, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n16(float (&d)[8], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        "%8, %9, p, 1, 1, %12, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        "%8, %9, p, 1, 1, %12, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
}

template <typename T, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15},"
        "%16, %17, p, 1, 1, %20, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15},"
        "%16, %17, p, 1, 1, %20, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
}

template <typename T, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31},"
        "%32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31},"
        "%32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
}

template <typename T, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63},"
        "%64, %65, p, 1, 1, %68, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63},"
        "%64, %65, p, 1, 1, %68, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
}

template <typename T, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n256(float (&d)[128], uint64_t a,
                                            uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
        "},"
        "%128, %129, p, 1, 1, %132, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
        "},"
        "%128, %129, p, 1, 1, %132, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
}

template <typename T, int TB>
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15},"
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15},"
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
}

template <typename T, int TB>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31},"
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31},"
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
}

template <typename T, int TB>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63},"
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63},"
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
}

template <typename T, int N, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (N == 16) {
    mma_ss_n16<T, TB, TA>(d, a, b, scale_d);
  } else if constexpr (N == 32) {
    mma_ss_n32<T, TB, TA>(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    mma_ss_n64<T, TB, TA>(d, a, b, scale_d);
  } else if constexpr (N == 128) {
    mma_ss_n128<T, TB, TA>(d, a, b, scale_d);
  } else {
    static_assert(N == 256, "wgmma widths 16, 32, 64, 128 and 256");
    mma_ss_n256<T, TB, TA>(d, a, b, scale_d);
  }
}

template <typename T, int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  if constexpr (N == 32) {
    mma_rs_n32<T, TB>(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    mma_rs_n64<T, TB>(d, a, b, scale_d);
  } else {
    static_assert(N == 128, "wgmma widths 32, 64 and 128");
    mma_rs_n128<T, TB>(d, a, b, scale_d);
  }
}

// The m64nN accumulator fragment: register r of lane l in warp w of the
// warpgroup holds row 16w + l/4 + 8 * frag_row(r), column
// 8 * (r / 4) + 2 * (l % 4) + (r % 2).
__device__ __forceinline__ constexpr int frag_row(int r) { return (r >> 1) & 1; }
__device__ __forceinline__ constexpr int frag_col(int r, int lane) {
  return 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
}

// An accumulator block (R = N / 2 registers) rounded to T as the A
// fragments of the N / 16 k-steps of a product that reduces over its
// columns: the accumulator and A layouts coincide, register for register.
template <typename T, int R>
__device__ __forceinline__ void to_a_frags(const float (&s)[R],
                                           uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack2<T>(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// Sum over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Rows row0, row0 + 8 of an m64nD accumulator (this thread's two rows),
// scaled by mul[i], rounded to T (or kept, when T is float: the fp32
// epilogue of the ring's chunk calls) and stored to out + row * stride if
// the row is below nrows; columns from ncols (even) on are not stored.
template <typename T, int R>
__device__ __forceinline__ void store_rows(const float (&acc)[R],
                                           const float (&mul)[2], T* out,
                                           size_t stride, int row0,
                                           int nrows, int ncols) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= nrows) continue;
    T* dst = out + (size_t)row * stride;
#pragma unroll
    for (int r = 2 * i; r < R; r += 4) {
      if (frag_col(r, lane) >= ncols) continue;
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(dst + frag_col(r, lane)) =
            make_float2(acc[r] * mul[i], acc[r + 1] * mul[i]);
      else
        *reinterpret_cast<uint32_t*>(dst + frag_col(r, lane)) =
            pack2<T>(acc[r] * mul[i], acc[r + 1] * mul[i]);
    }
  }
}

// The k-th work item of this CTA: items are sorted longest first and
// dealt out in rounds of gridDim.x, every other round in reverse (a snake),
// so that the CTAs' sums of item lengths even out.  -1 past the end.
__device__ __forceinline__ int snake_item(int k, int items) {
  const int g = gridDim.x, c = blockIdx.x;
  const int item = k * g + ((k & 1) ? g - 1 - c : c);
  return item < items ? item : -1;
}

// A work item of K2 and K6: a (query tile, b*n) pair and its key-tile
// count; causal calls take the longest query tiles (the most key tiles)
// first.
struct QueryTile {
  int bh, q0, ntiles;
  __device__ QueryTile(int item, int bn, int nqt, int sk, int bq, int bk,
                       int causal) {
    const int t = item / bn;
    bh = item % bn;
    q0 = (causal ? nqt - 1 - t : t) * bq;
    // causal: key tiles past the query tile's last row are never loaded
    const int kv_end = causal ? min(sk, q0 + bq) : sk;
    ntiles = (kv_end + bk - 1) / bk;
  }
};

// Turn-taking of the two consumer warpgroups ("ping-pong"): warpgroup w
// waits for named barrier 1 + w before it issues its products and then
// hands the turn to the other, so that one warpgroup's products overlap
// the other's softmax.  Warpgroup 1 hands warpgroup 0 the first turn.
__device__ __forceinline__ void turn_begin(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_end(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// 2^x by the MUFU unit (ex2.approx, flush to zero: 2^-1e30 is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Warp specialisation shared by K2, K6 and K7: two consumer warpgroups
// (threads 0-255) and a producer warpgroup whose first warp issues the
// loads.  Registers move from the producer (24) to the consumers (240):
// 128 * 24 + 256 * 240 = 384 * 168, the launch's whole file.
constexpr int kThreads = 384;
// Up to d = 64 an operand that stays for a work item (Q, dO; K, V) is
// held in registers as the A operand; at d = 128 the accumulators leave
// no room and it is read from shared memory.
template <int D>
constexpr bool kStationaryInRegs = D <= 64;
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

}  // namespace sm90
