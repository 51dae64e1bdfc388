// Multi-tensor kernels of the port (M1-M4): one launch covers a list of up
// to 320 tensors (mt::kMaxTensors), the role of the reference's multi_tensor_apply kernels
// (csrc/multi_tensor_{scale,axpby,l2norm,adam,lamb}*.cu).
//
// They replace no TPU kernel: the JAX package leaves these updates to XLA,
// which fuses a whole tree's update into one pass over device memory
// (apex_tpu/ops/flat_adam.py:1-21 records that its Pallas kernel lost to
// that fusion and was deleted).  Eager PyTorch fuses nothing, so the port's
// per-leaf torch composition paid one full pass over the parameters for
// every elementwise op of the AMP unscale and the optimizer update
// (~25 passes a step).  Each kernel here reads and writes every element
// once: all four are bound by device memory bytes (a few flops an element
// against ~30-40 bytes).  Their plain versions are the per-leaf torch
// compositions in apex_tpu_torch/multi_tensor/multi_tensor_apply.py; the
// arithmetic below repeats theirs operation by operation in round-to-
// nearest intrinsics (no fused multiply-adds), so a kernel and its plain
// version on the card agree to the last bit but for the norms' summation
// order.
//
//   M1 apex_mt_scale        out = a*x (+ b*y): the AMP unscale, the
//                           accumulation add; the non-finite flag OR'ed
//                           into a device int32; a set incoming flag
//                           passes x through unscaled
//   M2 apex_mt_l2norm       per-tensor and global L2 norms: per-chunk
//                           partial sums, then one CTA adds them in order
//   M3 apex_mt_adam         Adam/AdamW over (g, p, m, v), out of place
//   M4 apex_mt_lamb         LAMB in two launches: stage 1 the clipped
//                           moments, the raw update u and per-chunk
//                           partials of |u|^2 and |p|^2; stage 2
//                           p - lr * ratio * u, the ratio per tensor from
//                           the ordered sum of its partials
//
// M3 and M4 run in one of two modes: "update" writes the optimizer's
// update u (fp32) where the new parameter would go (GradientTransformation
// .update's contract), "apply" writes p + u in p's type, the model-type
// copy of it (when a list-7 pointer is given), and on the step's overflow
// flag (the loss scaler's skip decision, read from device memory) the old
// p, m and v unchanged.  Every scalar that a step computes on the device
// (lr from a schedule, the bias corrections, 1/scale, the clip factor) is
// read from device memory, so a step makes no host read.
//
// A list longer than the table (kMaxTensors) goes in groups, one call of
// the entry each (multi_tensor_apply.py).  M1, M3 and M4 need nothing
// across groups: M1's flag is OR'ed, M4's trust ratios read only their own
// tensor's partials.  M2's per-tensor squares go to device memory, and the
// last group's finish adds all of them in tensor order.
#include <stddef.h>

#include "multi_tensor_apply.cuh"

namespace mt {

// a device scalar when given, else the host value
__device__ __forceinline__ float scalar(const float* dev, float host) {
  return dev ? *dev : host;
}

// The optimizers' hyperparameters (M3, M4): the host's values, or (M3)
// read from device memory when `dev` is given (ops/flat_adam.
// adam_kernel_flat, whose scalars live on the device)
struct Hyper {
  float beta1, beta2;
  float gm;     // the gradient's weight in m: Adam 1 - beta1, LAMB beta3
  float omb2;   // 1 - beta2
  float eps, wd;
};

__device__ __forceinline__ Hyper hyper(const Hyper& host, const Hyper* dev) {
  return dev ? *dev : host;
}

// ---- M1: scale / axpby ---------------------------------------------------

struct ScaleOp {
  const void* x; const void* y; void* out;
  int cx, cy, co;
  float a, b;
  bool pass, axpby, bad;

  template <int W>
  __device__ __forceinline__ void apply(long long i) {
    float vx[W], vy[W], r[W];
    load<W>(x, cx, i, vx);
    if (axpby) load<W>(y, cy, i, vy);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      bad |= !finite(vx[k]) || (axpby && !finite(vy[k]));
      r[k] = pass ? vx[k]
                  : axpby ? __fadd_rn(__fmul_rn(a, vx[k]), __fmul_rn(b, vy[k]))
                          : __fmul_rn(vx[k], a);
    }
    if (out) store<W>(out, co, i, r);
  }
};

__global__ void __launch_bounds__(kThreads)
    scale_kernel(const __grid_constant__ Table<3> tab, float a,
                 const float* a_dev, float b, const float* b_dev,
                 const int* noop, int* flag, int axpby) {
  const bool pass = noop != nullptr && *noop != 0;
  if (blockIdx.x == 0 && threadIdx.x == 0 && pass) *flag = 1;
  const int chunk = blockIdx.x;
  if (chunk >= tab.chunks) return;
  const int t = find_tensor(tab, chunk);
  ScaleOp op{tab.ptr[0][t], tab.ptr[1][t], tab.ptr[2][t],
             tab.code[0][t], tab.code[1][t], tab.code[2][t],
             scalar(a_dev, a), scalar(b_dev, b), pass, axpby != 0, false};
  const long long c0 = (long long)(chunk - tab.start[t]) * kChunk;
  const long long c1 = c0 + kChunk < tab.numel[t] ? c0 + kChunk
                                                  : tab.numel[t];
  for_chunk(op, c0, c1, tab.vec[t] != 0);
  // every writer stores the same 1: a flag, not a sum
  if (__syncthreads_or(op.bad) && threadIdx.x == 0) *flag = 1;
}

// ---- M2: L2 norms ----------------------------------------------------------

struct SquareOp {
  const void* x; int cx; float acc;

  template <int W>
  __device__ __forceinline__ void apply(long long i) {
    float v[W];
    load<W>(x, cx, i, v);
#pragma unroll
    for (int k = 0; k < W; ++k) acc = fmaf(v[k], v[k], acc);
  }
};

__global__ void __launch_bounds__(kThreads)
    l2norm_partial_kernel(const __grid_constant__ Table<1> tab,
                          float* partial) {
  __shared__ float red[32];
  const int chunk = blockIdx.x;
  if (chunk >= tab.chunks) return;
  const int t = find_tensor(tab, chunk);
  SquareOp op{tab.ptr[0][t], tab.code[0][t], 0.f};
  const long long c0 = (long long)(chunk - tab.start[t]) * kChunk;
  const long long c1 = c0 + kChunk < tab.numel[t] ? c0 + kChunk
                                                  : tab.numel[t];
  for_chunk(op, c0, c1, tab.vec[t] != 0);
  const float s = block_sum(op.acc, red);
  if (threadIdx.x == 0) partial[chunk] = s;
}

// One CTA over one group of tensors, the first of which is tensor t0 of
// the whole list: warp w adds the partials of tensors w, w + 32, ...
// (lanes strided, then a butterfly) into sq[t0 + t], and per[t0 + t] =
// |x_t| when given.  The last group's finish (total given) then adds the
// squares of every tensor of the list, earlier groups' included, in
// tensor order: total = sqrt(sum_t |x_t|^2), the same bits however the
// list was grouped.
constexpr int kFinishThreads = 1024;

__global__ void __launch_bounds__(kFinishThreads)
    l2norm_finish_kernel(const __grid_constant__ Table<1> tab,
                         const float* partial, float* sq, int t0, float* per,
                         float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < tab.n; t += kFinishThreads / 32) {
    float s = 0.f;
    for (int c = tab.start[t] + lane; c < tab.start[t + 1]; c += 32)
      s += partial[c];
    s = apex_warp_sum(s);
    if (lane == 0) {
      sq[t0 + t] = s;
      if (per) per[t0 + t] = __fsqrt_rn(s);
    }
  }
  if (total == nullptr) return;
  __syncthreads();   // this CTA's writes of sq, seen by thread 0
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int t = 0; t < t0 + tab.n; ++t) s += sq[t];
    *total = __fsqrt_rn(s);
  }
}

// ---- M3: Adam ----------------------------------------------------------------
// lists: 0 g, 1 p, 2 m, 3 v, 4 p_out, 5 m_out, 6 v_out, 7 model copy

struct AdamOp {
  const void* g; const void* p; const float* m; const float* v;
  void* p_out; float* m_out; float* v_out; void* model;
  int cg, cp, cmodel;
  float lr, lrwd, bc1, bc2;
  Hyper h;
  bool adam_w, decay, update_mode, overflow;
  float usq;

  template <int W>
  __device__ __forceinline__ void apply(long long i) {
    float vg[W], vp[W], vm[W], vv[W], out[W], mo[W], vo[W];
    load<W>(g, cg, i, vg);
    load<W>(p, cp, i, vp);
    load<W>(m, APEX_F32, i, vm);
    load<W>(v, APEX_F32, i, vv);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      float g32 = vg[k];
      if (!adam_w && decay) g32 = __fadd_rn(g32, __fmul_rn(h.wd, vp[k]));
      const float m1 = __fadd_rn(__fmul_rn(h.beta1, vm[k]),
                                 __fmul_rn(h.gm, g32));
      const float v1 = __fadd_rn(__fmul_rn(h.beta2, vv[k]),
                                 __fmul_rn(h.omb2, __fmul_rn(g32, g32)));
      const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, bc2)), h.eps);
      float u = __fdiv_rn(__fmul_rn(-lr, __fdiv_rn(m1, bc1)), denom);
      if (adam_w && decay) u = __fsub_rn(u, __fmul_rn(lrwd, vp[k]));
      usq = fmaf(u, u, usq);
      if (update_mode) {
        out[k] = u; mo[k] = m1; vo[k] = v1;
      } else if (overflow) {
        out[k] = vp[k]; mo[k] = vm[k]; vo[k] = vv[k];
      } else {
        // p + u in p's type: a 16-bit p adds u rounded to its type
        out[k] = round_to(__fadd_rn(vp[k], round_to(u, cp)), cp);
        mo[k] = m1; vo[k] = v1;
      }
    }
    store<W>(p_out, update_mode ? APEX_F32 : cp, i, out);
    store<W>(m_out, APEX_F32, i, mo);
    store<W>(v_out, APEX_F32, i, vo);
    if (model) store<W>(model, cmodel, i, out);
  }
};

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Table<8> tab, float lr,
                const float* lr_dev, Hyper h_host, const Hyper* h_dev,
                const float* bc1, const float* bc2, int adam_w,
                int update_mode, const unsigned char* overflow, float* usq) {
  __shared__ float red[32];
  const int chunk = blockIdx.x;
  if (chunk >= tab.chunks) return;
  const int t = find_tensor(tab, chunk);
  const float lr_t = scalar(lr_dev, lr);
  const Hyper h = hyper(h_host, h_dev);
  AdamOp op{tab.ptr[0][t], tab.ptr[1][t],
            static_cast<const float*>(tab.ptr[2][t]),
            static_cast<const float*>(tab.ptr[3][t]), tab.ptr[4][t],
            static_cast<float*>(tab.ptr[5][t]),
            static_cast<float*>(tab.ptr[6][t]), tab.ptr[7][t],
            tab.code[0][t], tab.code[1][t], tab.code[7][t],
            lr_t, __fmul_rn(lr_t, h.wd), scalar(bc1, 1.f), scalar(bc2, 1.f),
            h, adam_w != 0, h.wd != 0.f,
            update_mode != 0, overflow != nullptr && *overflow != 0, 0.f};
  const long long c0 = (long long)(chunk - tab.start[t]) * kChunk;
  const long long c1 = c0 + kChunk < tab.numel[t] ? c0 + kChunk
                                                  : tab.numel[t];
  for_chunk(op, c0, c1, tab.vec[t] != 0);
  if (usq) {
    const float s = block_sum(op.usq, red);
    if (threadIdx.x == 0) usq[chunk] = s;
  }
}

// ---- M4: LAMB ----------------------------------------------------------------
// lists: 0 g, 1 p, 2 m, 3 v, 4 p_out, 5 m_out, 6 v_out, 7 model copy,
// 8 u (fp32 scratch, stage 1 → stage 2)

struct LambStage1Op {
  const void* g; const void* p; const float* m; const float* v;
  float* m_out; float* v_out; float* u_out;
  int cg, cp;
  Hyper h;
  float bc1, bc2, clip;
  bool clipped, adam_w, decay, overflow;
  float usq, psq;

  template <int W>
  __device__ __forceinline__ void apply(long long i) {
    float vg[W], vp[W], vm[W], vv[W], u[W], mo[W], vo[W];
    load<W>(g, cg, i, vg);
    load<W>(p, cp, i, vp);
    load<W>(m, APEX_F32, i, vm);
    load<W>(v, APEX_F32, i, vv);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      float sg = clipped ? __fdiv_rn(vg[k], clip) : vg[k];
      if (!adam_w && decay) sg = __fadd_rn(sg, __fmul_rn(h.wd, vp[k]));
      const float m1 = __fadd_rn(__fmul_rn(h.beta1, vm[k]),
                                 __fmul_rn(h.gm, sg));
      const float v1 = __fadd_rn(__fmul_rn(h.beta2, vv[k]),
                                 __fmul_rn(h.omb2, __fmul_rn(sg, sg)));
      float uk = __fdiv_rn(__fdiv_rn(m1, bc1),
                           __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, bc2)), h.eps));
      if (adam_w && decay) uk = __fadd_rn(uk, __fmul_rn(h.wd, vp[k]));
      u[k] = uk;
      usq = fmaf(uk, uk, usq);
      psq = fmaf(vp[k], vp[k], psq);
      mo[k] = overflow ? vm[k] : m1;
      vo[k] = overflow ? vv[k] : v1;
    }
    store<W>(u_out, APEX_F32, i, u);
    store<W>(m_out, APEX_F32, i, mo);
    store<W>(v_out, APEX_F32, i, vo);
  }
};

__global__ void __launch_bounds__(kThreads)
    lamb_stage1_kernel(const __grid_constant__ Table<9> tab, Hyper h,
                       const float* bc1, const float* bc2, const float* clip,
                       int adam_w, const unsigned char* overflow,
                       float* partial) {
  __shared__ float red[32];
  const int chunk = blockIdx.x;
  if (chunk >= tab.chunks) return;
  const int t = find_tensor(tab, chunk);
  LambStage1Op op{tab.ptr[0][t], tab.ptr[1][t],
                  static_cast<const float*>(tab.ptr[2][t]),
                  static_cast<const float*>(tab.ptr[3][t]),
                  static_cast<float*>(tab.ptr[5][t]),
                  static_cast<float*>(tab.ptr[6][t]),
                  static_cast<float*>(tab.ptr[8][t]),
                  tab.code[0][t], tab.code[1][t],
                  h, scalar(bc1, 1.f), scalar(bc2, 1.f), scalar(clip, 1.f),
                  clip != nullptr, adam_w != 0, h.wd != 0.f,
                  overflow != nullptr && *overflow != 0, 0.f, 0.f};
  const long long c0 = (long long)(chunk - tab.start[t]) * kChunk;
  const long long c1 = c0 + kChunk < tab.numel[t] ? c0 + kChunk
                                                  : tab.numel[t];
  for_chunk(op, c0, c1, tab.vec[t] != 0);
  const float su = block_sum(op.usq, red);
  const float sp = block_sum(op.psq, red);
  if (threadIdx.x == 0) {
    partial[chunk] = su;
    partial[tab.chunks + chunk] = sp;
  }
}

struct LambStage2Op {
  const void* p; const float* u; void* p_out; void* model;
  int cp, cmodel;
  float s;   // -lr * ratio
  bool update_mode, overflow;
  float usq;

  template <int W>
  __device__ __forceinline__ void apply(long long i) {
    float vp[W], vu[W], out[W];
    load<W>(p, cp, i, vp);
    load<W>(u, APEX_F32, i, vu);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float upd = __fmul_rn(s, vu[k]);
      usq = fmaf(upd, upd, usq);
      out[k] = update_mode ? upd
               : overflow  ? vp[k]
                           : round_to(__fadd_rn(vp[k], round_to(upd, cp)), cp);
    }
    store<W>(p_out, update_mode ? APEX_F32 : cp, i, out);
    if (model) store<W>(model, cmodel, i, out);
  }
};

__global__ void __launch_bounds__(kThreads)
    lamb_stage2_kernel(const __grid_constant__ Table<9> tab, float lr,
                       const float* lr_dev, int use_ratio, int update_mode,
                       const unsigned char* overflow, const float* partial,
                       float* usq) {
  __shared__ float red[32];
  __shared__ float ratio_s;
  const int chunk = blockIdx.x;
  if (chunk >= tab.chunks) return;
  const int t = find_tensor(tab, chunk);
  const float lr_t = scalar(lr_dev, lr);
  float ratio = 1.f;
  if (use_ratio) {
    // every CTA of tensor t adds t's partials in the same order
    float su = 0.f, sp = 0.f;
    for (int c = tab.start[t] + threadIdx.x; c < tab.start[t + 1];
         c += blockDim.x) {
      su += partial[c];
      sp += partial[tab.chunks + c];
    }
    su = block_sum(su, red);
    sp = block_sum(sp, red);
    if (threadIdx.x == 0) {
      const float w_norm = __fsqrt_rn(sp), u_norm = __fsqrt_rn(su);
      ratio_s = (w_norm > 0.f && u_norm > 0.f) ? __fdiv_rn(w_norm, u_norm)
                                               : 1.f;
    }
    __syncthreads();
    ratio = ratio_s;
  }
  LambStage2Op op{tab.ptr[1][t], static_cast<const float*>(tab.ptr[8][t]),
                  tab.ptr[4][t], tab.ptr[7][t], tab.code[1][t],
                  tab.code[7][t], __fmul_rn(-lr_t, ratio), update_mode != 0,
                  overflow != nullptr && *overflow != 0, 0.f};
  const long long c0 = (long long)(chunk - tab.start[t]) * kChunk;
  const long long c1 = c0 + kChunk < tab.numel[t] ? c0 + kChunk
                                                  : tab.numel[t];
  for_chunk(op, c0, c1, tab.vec[t] != 0);
  if (usq) {
    const float s = block_sum(op.usq, red);
    if (threadIdx.x == 0) usq[chunk] = s;
  }
}

inline int grid(int chunks) { return chunks > 0 ? chunks : 1; }

}  // namespace mt

extern "C" {

// sizeof(Table<nl>) and the offsets of numel, ptr, code and vec, for the
// wrapper's check of its ctypes mirror
int apex_mt_layout(int nl, long long* out) {
#define APEX_MT_LAYOUT(N)                                  \
  case N:                                                  \
    out[0] = sizeof(mt::Table<N>);                         \
    out[1] = offsetof(mt::Table<N>, numel);                \
    out[2] = offsetof(mt::Table<N>, ptr);                  \
    out[3] = offsetof(mt::Table<N>, code);                 \
    out[4] = offsetof(mt::Table<N>, vec);                  \
    return 0;
  switch (nl) {
    APEX_MT_LAYOUT(1)
    APEX_MT_LAYOUT(3)
    APEX_MT_LAYOUT(8)
    APEX_MT_LAYOUT(9)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef APEX_MT_LAYOUT
}

int apex_mt_scale(const mt::Table<3>* tab, float a, const float* a_dev,
                  float b, const float* b_dev, const int* noop, int* flag,
                  int axpby, cudaStream_t stream) {
  mt::scale_kernel<<<mt::grid(tab->chunks), mt::kThreads, 0, stream>>>(
      *tab, a, a_dev, b, b_dev, noop, flag, axpby);
  return (int)cudaGetLastError();
}

// M2 over one group: `partial` this group's chunks, `sq` the whole list's
// per-tensor squares (the group's first tensor is t0), `per` the whole
// list's norms or NULL, `total` NULL but for the last group
int apex_mt_l2norm(const mt::Table<1>* tab, float* partial, float* sq,
                   int t0, float* per, float* total, cudaStream_t stream) {
  mt::l2norm_partial_kernel<<<mt::grid(tab->chunks), mt::kThreads, 0,
                              stream>>>(*tab, partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  mt::l2norm_finish_kernel<<<1, mt::kFinishThreads, 0, stream>>>(
      *tab, partial, sq, t0, per, total);
  return (int)cudaGetLastError();
}

// M3 takes the hyperparameters as host floats, or from h_dev (an fp32
// mt::Hyper in device memory) when it is not NULL
int apex_mt_adam(const mt::Table<8>* tab, float lr, const float* lr_dev,
                 float beta1, float beta2, float omb1, float omb2, float eps,
                 float wd, const mt::Hyper* h_dev, const float* bc1,
                 const float* bc2, int adam_w, int update_mode,
                 const unsigned char* overflow, float* usq,
                 cudaStream_t stream) {
  mt::adam_kernel<<<mt::grid(tab->chunks), mt::kThreads, 0, stream>>>(
      *tab, lr, lr_dev, mt::Hyper{beta1, beta2, omb1, omb2, eps, wd}, h_dev,
      bc1, bc2, adam_w, update_mode, overflow, usq);
  return (int)cudaGetLastError();
}

// M4: stage 1 then stage 2 on the stream (stage 2 reads stage 1's u and
// partials), one call of the entry
int apex_mt_lamb(const mt::Table<9>* tab, float beta1, float beta2,
                 float beta3, float omb2, float eps, float wd,
                 const float* bc1, const float* bc2, const float* clip,
                 int adam_w, float lr, const float* lr_dev, int use_ratio,
                 int update_mode, const unsigned char* overflow,
                 float* partial, float* usq, cudaStream_t stream) {
  mt::lamb_stage1_kernel<<<mt::grid(tab->chunks), mt::kThreads, 0,
                           stream>>>(
      *tab, mt::Hyper{beta1, beta2, beta3, omb2, eps, wd}, bc1, bc2, clip,
      adam_w, overflow, partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  mt::lamb_stage2_kernel<<<mt::grid(tab->chunks), mt::kThreads, 0,
                           stream>>>(*tab, lr, lr_dev, use_ratio, update_mode,
                                     overflow, partial, usq);
  return (int)cudaGetLastError();
}

// {registers, static shared memory, CTAs per SM, spill bytes} of kernel
// `which`: 0 scale, 1 l2norm partials, 2 l2norm finish, 3 adam, 4 lamb
// stage 1, 5 lamb stage 2
int apex_mt_attrs(int which, int* out) {
  switch (which) {
    case 0: return apex_kernel_attrs(mt::scale_kernel, mt::kThreads, out);
    case 1: return apex_kernel_attrs(mt::l2norm_partial_kernel, mt::kThreads, out);
    case 2: return apex_kernel_attrs(mt::l2norm_finish_kernel, mt::kFinishThreads, out);
    case 3: return apex_kernel_attrs(mt::adam_kernel, mt::kThreads, out);
    case 4: return apex_kernel_attrs(mt::lamb_stage1_kernel, mt::kThreads, out);
    case 5: return apex_kernel_attrs(mt::lamb_stage2_kernel, mt::kThreads, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
