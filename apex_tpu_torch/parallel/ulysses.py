"""Ulysses all-to-all sequence parallelism for attention
(``apex_tpu/parallel/ulysses.py``).

The second long-context mode beside :mod:`ring_attention`: for the
duration of attention the heads are re-sharded across the group,

    [b, s_local, n, d]  --all_to_all-->  [b, s_global, n/sp, d]

each rank runs one flash attention over the full sequence for its head
subset (kernel K2 forward; K6/K7 backward above 512 keys, row 5 up to
512), and one all_to_all brings the result back.  q, k and v travel in
one stacked all_to_all (DeepSpeed Ulysses, arXiv:2309.14509).  Needs the
head count divisible by the group's size and equal shards; grouped K/V
are broadcast to the query heads by the caller
(``models/transformer_lm``).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.utils.collectives import all_to_all, group_size

__all__ = ["ulysses_attention"]


class _AllToAll(torch.autograd.Function):
    """Tiled all_to_all whose backward is the all_to_all with the split
    and concat axes swapped (its transpose)."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return all_to_all(x, group, split_axis, concat_axis, tiled=True)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (all_to_all(g.contiguous(), ctx.group, concat_axis,
                           split_axis, tiled=True), None, None, None)


def ulysses_attention(q, k, v, group=None, *, causal: bool = False,
                      scale: Optional[float] = None,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Attention over sequence-sharded ``[b, s_local, n, d]`` tensors by
    head re-sharding over ``group`` (``None``: the world); shard ``i``
    owns the global positions ``[i·s_local, (i+1)·s_local)``."""
    if q.ndim != 4:
        raise ValueError(f"expected [b, s_local, n, d], got {tuple(q.shape)}")
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError("ulysses requires equal q/k/v shard shapes")
    sp = group_size(group)
    n = q.shape[2]
    if n % sp != 0:
        raise ValueError(
            f"ulysses_attention needs num_heads ({n}) divisible by the "
            f"group's size ({sp}); use ring_attention for head counts that "
            "don't factor")
    # one stacked collective: [3, b, s_local, n, d] -> [3, b, s, n/sp, d]
    qkv = _AllToAll.apply(torch.stack([q, k, v]), group, 3, 2)
    out = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal, scale=scale,
                          backend=backend)
    # [b, s, n/sp, d] -> [b, s_local, n, d]
    return _AllToAll.apply(out, group, 1, 2)
