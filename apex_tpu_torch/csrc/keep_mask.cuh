// Attention dropout and segment ids, shared by rows 3, 4a, 4b and 5
// (flash_attention.cu, flash_attention_bwd.cu, flash_attention_bwd_short.cu,
// flash_attention_wide.cu).
//
// The keep mask is apex_tpu/ops/flash_attention.py:_keep_mask operation
// for operation: a murmur-style uint32 hash of (seed, bh, row, col) with
// bh = batch * n + query head (under GQA the query head, not the K/V
// group), row the global query position and col the global key position;
// a probability is kept when the hash is below the threshold
// min(round(keep * 2^32), 2^32 - 1), which the wrapper computes in
// Python as JAX does.  It depends on the global coordinates only, so every
// kernel, whatever its tiles, draws JAX's bits.  The seed is a [1] int32
// on the device (the bits of _seed_from_rng), read by the kernels: no host
// scalar reaches a launch, so a captured call replays with new words.
//
// Segment ids are [b, s] int32 (self-attention, sq == sk): a query sees a
// key only when their ids are equal and the key's is not negative
// (flash_attention.py:228-234).  seg_rng holds, for each 32-row granule,
// the least and greatest non-negative id ({INT_MAX, INT_MIN} when it has
// none) and the id every row of the granule holds (-1 unless all hold the
// same non-negative one).  A query tile and a key tile whose ranges are
// disjoint have no visible pair and are skipped (flash_attention.py:
// 261-270), so packed rows pay for their own tiles; a pair whose rows all
// hold one id is open throughout and skips the per-element test.
#pragma once

#include <stdint.h>

#include <climits>

struct FlashExtras {
  const int* seed;      // [1] int32 on the device, or NULL: no dropout
  uint32_t threshold;   // kept when the hash is below it
  float inv_keep;       // 1 / (1 - p)
  const int* seg;       // [b, s] int32 segment ids, or NULL
  const int4* seg_rng;  // [b, ceil(s / 32)] {min, max, uniform id, 0}
};

inline FlashExtras make_extras(const void* seed, unsigned threshold,
                               float inv_keep, const void* seg,
                               const void* seg_rng) {
  FlashExtras ex;
  ex.seed = (const int*)seed;
  ex.threshold = threshold;
  ex.inv_keep = inv_keep;
  ex.seg = (const int*)seg;
  ex.seg_rng = (const int4*)seg_rng;
  return ex;
}

constexpr int kSegGranule = 32;

// Whether a call takes segment ids or dropout: the Hopper kernels run an
// instantiation of their own for it.
inline bool has_extras(const FlashExtras& ex) {
  return ex.seed != nullptr || ex.seg != nullptr;
}

// The hash of flash_attention.py:_keep_mask before its threshold, from
// hb = seed + bh * 0x9E3779B1 (one register a flat head).
__device__ __forceinline__ uint32_t keep_hash_hb(uint32_t hb, uint32_t row,
                                                 uint32_t col) {
  uint32_t h = hb;
  h ^= row * 0x85EBCA77u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= col * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t keep_hash(uint32_t seed, uint32_t bh,
                                              uint32_t row, uint32_t col) {
  return keep_hash_hb(seed + bh * 0x9E3779B1u, row, col);
}

// The dropout state of one thread: on, the seed and threshold.
struct Dropout {
  bool on;
  uint32_t seed, threshold;
  float inv;
  __device__ __forceinline__ explicit Dropout(const FlashExtras& ex) {
    on = ex.seed != nullptr;
    seed = on ? (uint32_t)__ldg(ex.seed) : 0u;
    threshold = ex.threshold;
    inv = ex.inv_keep;
  }
  __device__ __forceinline__ bool keep(int bh, int row, int col) const {
    return keep_hash(seed, (uint32_t)bh, (uint32_t)row, (uint32_t)col) <
           threshold;
  }
  // x kept and scaled by 1 / (1 - p), or 0
  __device__ __forceinline__ float apply(float x, int bh, int row,
                                         int col) const {
    return keep(bh, row, col) ? x * inv : 0.0f;
  }
};

// The segment id of position pos < s of batch row b (-2, matching
// nothing, past s).
__device__ __forceinline__ int seg_at(const FlashExtras& ex, int b, int s,
                                      int pos) {
  return pos < s ? __ldg(ex.seg + (size_t)b * s + pos) : -2;
}

// Whether query id qs sees key id ks.
__device__ __forceinline__ bool seg_open(int qs, int ks) {
  return qs == ks && ks >= 0;
}

// The ids of rows [r0, r1) of batch row b (r0 a multiple of 32; rows
// past s hold none): least and greatest non-negative id, and the id all of
// them hold (-1 unless one non-negative id).
struct SegSpan {
  int lo, hi, uni;
};

__device__ __forceinline__ SegSpan seg_span(const FlashExtras& ex, int b,
                                            int s, int r0, int r1) {
  const int gn = (s + kSegGranule - 1) / kSegGranule;
  const int g1 = min((r1 + kSegGranule - 1) / kSegGranule, gn);
  SegSpan out{INT_MAX, INT_MIN, -2};
  for (int g = r0 / kSegGranule; g < g1; ++g) {
    const int4 r = __ldg(ex.seg_rng + (size_t)b * gn + g);
    out.lo = min(out.lo, r.x);
    out.hi = max(out.hi, r.y);
    out.uni = out.uni == -2 || out.uni == r.z ? r.z : -1;
  }
  if (out.uni == -2) out.uni = -1;
  return out;
}

// Whether two spans can hold a visible pair (an empty one holds none).
__device__ __forceinline__ bool seg_meet(SegSpan a, SegSpan b) {
  return a.lo <= b.hi && b.lo <= a.hi;
}

// Whether every pair of two spans is open: all their rows hold one id.
__device__ __forceinline__ bool seg_inside(SegSpan a, SegSpan b) {
  return a.uni >= 0 && a.uni == b.uni;
}

// x as lane 0 holds it: a value ptxas knows to be warp-uniform, so that a
// wgmma in a branch on it is not serialized (C7520).  The live-tile walks
// read their ranges from memory.
__device__ __forceinline__ int warp_uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// Whether the (query rows [q0, q0 + bq), keys [k0, k0 + bk)) tile pair of
// batch row b can hold a visible pair: always without segment ids.
__device__ __forceinline__ bool seg_tile_live(const FlashExtras& ex, int b,
                                              int s, int q0, int bq, int k0,
                                              int bk) {
  if (ex.seg == nullptr) return true;
  return seg_meet(seg_span(ex, b, s, q0, q0 + bq),
                  seg_span(ex, b, s, k0, k0 + bk));
}
