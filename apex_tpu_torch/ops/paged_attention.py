"""Ragged paged decode attention (``apex_tpu/ops/paged_attention.py``).

For CUDA tensors :func:`ragged_paged_attention` is one launch of kernel
row 6 (``csrc/paged_attention.cu``): one CTA per (sequence, kv group)
walks the sequence's block table, folds the group's query heads against
its single K/V block by block with an online softmax, skips blocks past
the length and masks the tail, and dequantizes an int8 pool by its
per-(token, group) scales as it loads.  For CPU tensors, and under
``backend="reference"``, it is :func:`paged_attention_reference`, the
gather-based oracle.

Layout: ``q`` ``[b, num_heads, dh]`` (one query token per sequence),
pools ``[num_blocks, block_size, kv_groups, dh]`` in a float dtype, or
int8 with ``k_scale``/``v_scale`` ``[num_blocks, block_size,
kv_groups]`` fp32 (``cache_wire="int8"``), ``block_tables``
``[b, max_blocks]`` (entries ``>= num_blocks`` unmapped), ``lengths``
``[b]`` live tokens (query included).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["ragged_paged_attention", "paged_attention_reference",
           "_check_paged_shapes", "check_kernel_geometry"]

_NEG_INF = -1e30

PAGED_ATTENTION = ku.register(ku.Kernel(
    "ragged_paged_attention", "paged_attention.cu", "apex_paged_attention",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int],
    replaces="apex_tpu/ops/paged_attention.py:160"))


def _check_paged_shapes(q, k_pool, v_pool, block_tables, lengths,
                        k_scale=None, v_scale=None):
    if q.ndim != 3:
        raise ValueError(
            f"expected q [b, num_heads, dh] (one decode token per "
            f"sequence), got {tuple(q.shape)}")
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"expected k/v pools [num_blocks, block_size, kv_groups, dh], "
            f"got k {tuple(k_pool.shape)} v {tuple(v_pool.shape)}")
    b, nh, dh = q.shape
    if k_pool.shape[-1] != dh:
        raise ValueError(
            f"head dim mismatch: q has {dh}, pool has {k_pool.shape[-1]}")
    g = k_pool.shape[2]
    if nh % g:
        raise ValueError(
            f"query heads ({nh}) must be a multiple of the pool's kv group "
            f"count ({g})")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"expected block_tables [b={b}, max_blocks], got "
            f"{tuple(block_tables.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"expected lengths [b={b}], got "
                         f"{tuple(lengths.shape)}")
    quant = k_pool.dtype == torch.int8
    if quant and (k_scale is None or v_scale is None):
        raise ValueError(
            "int8 pools need k_scale/v_scale [num_blocks, block_size, "
            "kv_groups] (the block-scaled at-rest form of "
            "serving/paged_cache.py)")
    if not quant and (k_scale is not None or v_scale is not None):
        raise ValueError(
            f"k_scale/v_scale only apply to int8 pools, got pool dtype "
            f"{k_pool.dtype}")
    if quant:
        want = tuple(k_pool.shape[:3])
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(
                f"expected scales {want}, got k {tuple(k_scale.shape)} "
                f"v {tuple(v_scale.shape)}")


def paged_attention_reference(q, k_pool, v_pool, block_tables, lengths, *,
                              scale: Optional[float] = None,
                              k_scale=None, v_scale=None):
    """Gather the listed blocks (an int8 pool also gathers and multiplies
    its scales, in fp32), then dense masked decode attention: fp32
    scores, positions ``>= lengths[i]`` masked, probabilities rounded to
    the gathered values' dtype before the PV product (the JAX
    reference's edges).  Unmapped table entries clamp to the last block;
    their positions lie past the length by contract and the mask hides
    them.  A lane of length 0 gives exact zeros, as the kernels do."""
    _check_paged_shapes(q, k_pool, v_pool, block_tables, lengths,
                        k_scale, v_scale)
    b, nh, dh = q.shape
    nb, bs, g, _ = k_pool.shape
    mb = block_tables.shape[1]
    scale = (1.0 / dh ** 0.5) if scale is None else float(scale)
    tbl = block_tables.long().clamp(0, nb - 1)
    k = k_pool[tbl].reshape(b, mb * bs, g, dh)
    v = v_pool[tbl].reshape(b, mb * bs, g, dh)
    if k_scale is not None:
        k = k.float() * k_scale[tbl].reshape(b, mb * bs, g)[..., None]
        v = v.float() * v_scale[tbl].reshape(b, mb * bs, g)[..., None]
    qg = q.reshape(b, g, nh // g, dh)
    s = torch.einsum("bgrd,btgd->bgrt", qg.float(), k.float()) * scale
    live = (torch.arange(mb * bs, device=q.device)[None]
            < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(live, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrt,btgd->bgrd", p.to(v.dtype).float(), v.float())
    o = torch.where((lengths > 0)[:, None, None, None], o, 0.0)
    return o.reshape(b, nh, dh).to(q.dtype)


def check_kernel_geometry(name: str, q, k_pool) -> None:
    """What the paged loop (``csrc/paged_tile.cuh``) takes: at most 8
    query heads per kv group, ``rep * dh <= 1024``, ``dh`` a multiple of
    16 bytes of pool elements, the pool in q's dtype or int8."""
    _, nh, dh = q.shape
    g = k_pool.shape[2]
    rep = nh // g
    vec = 16 // k_pool.element_size()
    if rep > 8 or rep * dh > 1024 or dh % vec:
        raise ValueError(
            f"{name}: the kernel takes num_heads/kv_groups <= 8, "
            f"(num_heads/kv_groups)*dh <= 1024 and dh % {vec} == 0; got "
            f"rep={rep}, dh={dh}")
    if k_pool.dtype not in (q.dtype, torch.int8):
        raise NotImplementedError(
            f"{name}: pool dtype {k_pool.dtype} differs from q's {q.dtype}; "
            "the kernel reads a native pool in the compute dtype")


def _paged_kernel(q, k_pool, v_pool, block_tables, lengths, scale,
                  k_scale, v_scale):
    b, nh, dh = q.shape
    nb, bs, g, _ = k_pool.shape
    mb = block_tables.shape[1]
    check_kernel_geometry("ragged_paged_attention", q, k_pool)
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    ku.check_cuda_operands("ragged_paged_attention", q, k_pool, v_pool,
                           k_scale, v_scale, tables, lens)
    ku.check_aligned("ragged_paged_attention", k_pool, v_pool)
    out = torch.empty_like(q)
    PAGED_ATTENTION(q.device, ku.ptr(q), ku.ptr(k_pool), ku.ptr(v_pool),
                    ku.ptr(k_scale), ku.ptr(v_scale), ku.ptr(tables),
                    ku.ptr(lens), ku.ptr(out), b, nh, dh, nb, bs, g, mb,
                    scale, ku.dtype_code(q), int(k_scale is not None))
    return out


def ragged_paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None,
                           backend: Optional[str] = None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """One decode token per sequence attends over its paged KV blocks →
    context ``[b, num_heads, dh]`` in q's dtype; kernel row 6 on the
    card.  Inference only."""
    _check_paged_shapes(q, k_pool, v_pool, block_tables, lengths,
                        k_scale, v_scale)
    dh = q.shape[-1]
    scale = (1.0 / dh ** 0.5) if scale is None else float(scale)
    if check_backend(backend) is None and on_cuda(q):
        return _paged_kernel(q, k_pool, v_pool, block_tables, lengths,
                             scale, k_scale, v_scale)
    return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                     lengths, scale=scale, k_scale=k_scale,
                                     v_scale=v_scale)
