"""Fused decode layer: rope + paged attention + output projection
(``apex_tpu/ops/decode_step.py``).

For CUDA tensors :func:`fused_decode_layer` is one call of kernel K3
(``csrc/decode_step.cu``): row 6's split-key loop with the rope folded
into its query load, writing the context in the compute dtype to a
per-call buffer, then a projection that reads ``w_proj`` once in the
dtype the caller passes and rounds it to the compute dtype in registers
(two launches, one count).  For CPU tensors, and under
``backend="reference"``, it is :func:`decode_layer_reference`, the
composition of rope, :func:`~apex_tpu_torch.ops.paged_attention.
paged_attention_reference` and a matmul with the same dtype edges.

Layout: ``q`` ``[b, num_heads, dh]`` PRE-rope; pools ``[num_blocks,
block_size, kv_groups, dh]`` in any float dtype (whatever q's), or int8
with ``k_scale``/``v_scale`` ``[num_blocks, block_size, kv_groups]``
fp32 (``cache_wire="int8"``); ``block_tables`` ``[b, max_blocks]``
(entries ``>= num_blocks`` unmapped); ``lengths`` ``[b]`` live tokens
(query included); ``w_proj`` ``[num_heads·dh, h_out]`` fp32, bf16 or
fp16;
``rope_cos``/``rope_sin`` ``[b, d2]`` per-sequence angle rows or
``None`` → ``[b, h_out]`` in ``q``'s dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.ops.paged_attention import (
    PagedPlan, _check_paged_shapes, check_kernel_geometry,
    paged_attention_reference, partials, plan_args, plan_for, pool_code)
from apex_tpu_torch.ops.rope import _rope
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["fused_decode_layer", "decode_layer_reference",
           "kernel_attributes", "projection_vectorized"]

DECODE_LAYER = ku.register(ku.Kernel(
    "fused_decode_layer", "decode_step.cu", "apex_decode_layer",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
    + [ctypes.c_float] + [ctypes.c_int] * 14,
    replaces="apex_tpu/ops/decode_step.py:157"))

def projection_vectorized(w: torch.Tensor) -> bool:
    """Whether the projection reads ``w`` in 16-byte vectors: rows that
    start 16-byte aligned (``h_out`` a multiple of 16 bytes of elements,
    an aligned base)."""
    return (w.shape[1] * w.element_size() % 16 == 0
            and w.data_ptr() % 16 == 0)


def kernel_attributes(dtype: torch.dtype, pool_dtype: torch.dtype,
                      plan: PagedPlan, w_dtype: torch.dtype, k_in: int,
                      vec: bool = True) -> dict:
    """What the CUDA runtime reports of K3's two kernels: ``attention``,
    the split-key loop's variant for a ``dtype`` query over a
    ``pool_dtype`` pool under ``plan``, and ``projection`` for a
    ``w_dtype`` W of ``k_in`` rows (``{"registers", "smem_bytes",
    "ctas_per_sm", "spill_bytes"}`` each).  Needs the card."""
    code = ku.dtype_code(torch.empty((), dtype=dtype))
    wcode = ku.dtype_code(torch.empty((), dtype=w_dtype))
    return {
        "attention": ku.hopper_attrs(
            DECODE_LAYER.source, "apex_decode_attention_attrs", code,
            pool_code(pool_dtype), plan.heads, plan.epl, plan.smem),
        "projection": ku.hopper_attrs(
            DECODE_LAYER.source, "apex_decode_projection_attrs", code, wcode,
            int(vec), k_in)}


def _check_fused_shapes(q, w_proj, rope_cos, rope_sin):
    if isinstance(w_proj, dict):
        raise NotImplementedError(
            "quantized projection slabs come with a later slice of the port")
    b, nh, dh = q.shape
    if w_proj.ndim != 2 or w_proj.shape[0] != nh * dh:
        raise ValueError(
            f"expected w_proj [num_heads*dh={nh * dh}, h_out], got "
            f"{tuple(w_proj.shape)}")
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("pass rope_cos and rope_sin together or not at all")
    if rope_cos is not None:
        d2 = rope_cos.shape[-1]
        if tuple(rope_cos.shape) != (b, d2) or \
                tuple(rope_sin.shape) != (b, d2):
            raise ValueError(
                f"expected per-sequence rope rows [b={b}, d2], got cos "
                f"{tuple(rope_cos.shape)} sin {tuple(rope_sin.shape)}")
        if d2 > dh or d2 % 2:
            raise ValueError(
                f"rotary dim d2={d2} must be even and <= head dim {dh}")


def decode_layer_reference(q, k_pool, v_pool, block_tables, lengths, w_proj,
                           *, rope_cos=None, rope_sin=None,
                           scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Rope (fp32 math, rounded to q's dtype) → paged attention (int8
    pools dequantized by their scales) → ``ctx.to(dtype) @
    w_proj.to(dtype)``: the unfused decode layer's op sequence, the
    parity oracle of kernel K3."""
    _check_paged_shapes(q, k_pool, v_pool, block_tables, lengths,
                        k_scale, v_scale)
    _check_fused_shapes(q, w_proj, rope_cos, rope_sin)
    b = q.shape[0]
    if rope_cos is not None:
        q = _rope(q[:, None], rope_cos.float()[:, None, None, :],
                  rope_sin.float()[:, None, None, :])[:, 0]
    ctx = paged_attention_reference(q, k_pool, v_pool, block_tables,
                                    lengths, scale=scale, k_scale=k_scale,
                                    v_scale=v_scale)
    return ctx.to(q.dtype).reshape(b, -1) @ w_proj.to(q.dtype)


def _fused_kernel(q, k_pool, v_pool, block_tables, lengths, w_proj,
                  rope_cos, rope_sin, scale, k_scale, v_scale):
    b, nh, dh = q.shape
    nb, bs, g, _ = k_pool.shape
    mb = block_tables.shape[1]
    h_out = w_proj.shape[1]
    check_kernel_geometry("fused_decode_layer", q, k_pool)
    plan = plan_for(q, k_pool, block_tables)
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    w = w_proj.contiguous()
    cos = None if rope_cos is None else rope_cos.float().contiguous()
    sin = None if rope_sin is None else rope_sin.float().contiguous()
    d2 = 0 if cos is None else cos.shape[-1]
    ku.check_cuda_operands("fused_decode_layer", q, k_pool, v_pool, k_scale,
                           v_scale, tables, lens, w, cos, sin)
    ku.check_aligned("fused_decode_layer", k_pool, v_pool)
    out = torch.empty(b, h_out, dtype=q.dtype, device=q.device)
    ctx = torch.empty(b, nh * dh, dtype=q.dtype, device=q.device)
    # held until the launch: a scratch freed while its pointer is taken
    # goes back to the allocator, and another thread's work on the same
    # stream could take it before this call's kernels are enqueued
    part = partials(q, k_pool, plan)
    DECODE_LAYER(q.device, ku.ptr(q), ku.ptr(k_pool), ku.ptr(v_pool),
                 ku.ptr(k_scale), ku.ptr(v_scale), ku.ptr(tables),
                 ku.ptr(lens), ku.ptr(w), ku.ptr(cos), ku.ptr(sin),
                 ku.ptr(out), ku.ptr(ctx), ku.ptr(part),
                 b, nh, dh, nb, bs, g, mb,
                 h_out, d2, scale, ku.dtype_code(q),
                 pool_code(k_pool.dtype), ku.dtype_code(w),
                 int(projection_vectorized(w)), *plan_args(plan))
    return out


def fused_decode_layer(q, k_pool, v_pool, block_tables, lengths, w_proj, *,
                       rope_cos=None, rope_sin=None,
                       scale: Optional[float] = None,
                       backend: Optional[str] = None,
                       k_scale=None, v_scale=None) -> torch.Tensor:
    """One decode token per sequence: rope the query, attend over its
    paged KV blocks (dequantizing an int8 pool) and project the context
    — one launch of kernel K3 on the card.  Inference only."""
    _check_paged_shapes(q, k_pool, v_pool, block_tables, lengths,
                        k_scale, v_scale)
    _check_fused_shapes(q, w_proj, rope_cos, rope_sin)
    dh = q.shape[-1]
    scale = (1.0 / dh ** 0.5) if scale is None else float(scale)
    if check_backend(backend) is None and on_cuda(q):
        return _fused_kernel(q, k_pool, v_pool, block_tables, lengths,
                             w_proj, rope_cos, rope_sin, scale, k_scale,
                             v_scale)
    return decode_layer_reference(q, k_pool, v_pool, block_tables, lengths,
                                  w_proj, rope_cos=rope_cos,
                                  rope_sin=rope_sin, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale)
