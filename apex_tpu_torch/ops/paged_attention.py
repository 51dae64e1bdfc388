"""Decode attention over a paged KV pool (``apex_tpu/ops/
paged_attention.py``), plain PyTorch only in this slice.

The serving path's decode attention runs inside kernel K3
(``ops/decode_step.py``), whose loop over the block table is the paged
kernel's.  This module keeps the shape contract and the gather-based
oracle; the stand-alone ``ragged_paged_attention`` kernel (for the LoRA,
int8-weight and reference routes) is queued in ROADMAP.md.

Layout: ``q`` ``[b, num_heads, dh]`` (one query token per sequence),
pools ``[num_blocks, block_size, kv_groups, dh]``, ``block_tables``
``[b, max_blocks]`` (entries ``>= num_blocks`` unmapped), ``lengths``
``[b]`` live tokens (query included).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["paged_attention_reference", "_check_paged_shapes"]

_NEG_INF = -1e30


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
    if k_pool.dtype == torch.int8 or k_scale is not None \
            or v_scale is not None:
        raise NotImplementedError(
            "int8 pools (cache_wire='int8') come with a later slice of "
            "the port")


def paged_attention_reference(q, k_pool, v_pool, block_tables, lengths, *,
                              scale: Optional[float] = None):
    """Gather the listed blocks, then dense masked decode attention: fp32
    scores, positions ``>= lengths[i]`` masked, probabilities rounded to
    the pool's dtype before the PV product (the JAX reference's edges).
    Unmapped table entries clamp to the last block; their positions lie
    past the length by contract and the mask hides them."""
    _check_paged_shapes(q, k_pool, v_pool, block_tables, lengths)
    b, nh, dh = q.shape
    nb, bs, g, _ = k_pool.shape
    mb = block_tables.shape[1]
    scale = (1.0 / dh ** 0.5) if scale is None else float(scale)
    tbl = block_tables.long().clamp(max=nb - 1)
    k = k_pool[tbl].reshape(b, mb * bs, g, dh)
    v = v_pool[tbl].reshape(b, mb * bs, g, dh)
    qg = q.reshape(b, g, nh // g, dh)
    s = torch.einsum("bgrd,btgd->bgrt", qg.float(), k.float()) * scale
    live = (torch.arange(mb * bs, device=q.device)[None]
            < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(live, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrt,btgd->bgrd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, nh, dh).to(q.dtype)
