"""Ring attention: context parallelism over a process group
(``apex_tpu/parallel/ring_attention.py``).

Each rank of the group holds ``[b, s_local, n, d]`` q, k and v, the
global positions ``[r·s_local, (r+1)·s_local)``.  Q stays; K and V rotate
around the ring (``utils/collectives.ppermute`` to ``(r+1) % n`` from
``(r−1) % n``, one message a hop) while each hop runs the flash kernels on
the local (q, kv chunk) pair, and the chunks' results merge by a stable
logsumexp combine in fp32 (:func:`_merge`).  Memory per rank is
O(s_local·d) whatever the global length.

Causality per (q shard, kv chunk) pair (:func:`_mode`): a chunk below the
diagonal attends in full, the diagonal chunk runs the causal kernel, a
chunk above it is skipped with no launch, so rank ``r`` of a causal ring
launches ``r + 1`` chunk forwards (``n`` without causality).

The backward is the ring algorithm, not autograd through the loop: fp32
dK/dV accumulators travel with their K/V chunks, each hop calling the
flash backward with the **global** lse and ``delta = rowsum(do·o)``
(valid because ``p = exp(s − lse_global)``); after ``n`` hops every
accumulator is home.

Chunk calls: on CUDA tensors kernel K2 with fp32 outputs and K6/K7 with
fp32 outputs from the caller's lse and delta (the fp32-output branches of
``ops/flash_attention.py``, the calls ``_fwd_pallas(..., out_dtype=
float32)`` and ``_bwd_pallas(..., out_dtype=float32)`` of the JAX ring);
grouped K/V stay at group width (the kernels read groups by index and sum
dK/dV over a group's heads in fp32).  On CPU tensors, or under
``backend="reference"``, the chunks run :func:`_chunk_fwd_ref` and
:func:`_chunk_bwd_ref`, the ports of the JAX package's closed forms.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.flash_attention import (
    _NEG_INF, attention_delta, flash_attention_fwd, flash_bwd_dkv,
    flash_bwd_dq, flash_bwd_operands)
from apex_tpu_torch.utils.collectives import group_rank, group_size, ppermute
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["ring_attention"]

FULL, DIAGONAL, SKIP = 0, 1, 2


def _bsn(lse: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """``[b·n, s]`` → ``[b, s, n, 1]`` (broadcasts against ``[b, s, n,
    d]``)."""
    return lse.reshape(b, n, -1).transpose(1, 2)[..., None]


def _merge(o_a, lse_a, o_b, lse_b):
    """Stable fp32 combine of two partial results: ``o [b, s, n, d]``
    with lse ``[b·n, s]``."""
    lse_max = torch.maximum(lse_a, lse_b)
    lse = lse_max + torch.log(torch.exp(lse_a - lse_max)
                              + torch.exp(lse_b - lse_max))
    b, n = o_a.shape[0], o_a.shape[2]
    wa = _bsn(torch.exp(lse_a - lse), b, n)
    wb = _bsn(torch.exp(lse_b - lse), b, n)
    return o_a * wa + o_b * wb, lse


def _mode(my: int, src: int, causal: bool) -> int:
    """FULL, DIAGONAL or SKIP: chunk ``src`` against q shard ``my``."""
    if not causal:
        return FULL
    return DIAGONAL if src == my else FULL if src < my else SKIP


def _expand_groups(x, n: int):
    """``[b, s, g, d]`` → ``[b, s, n, d]``, query head ``h`` reading group
    ``h // (n / g)`` (the plain path's form of the kernels' index maps)."""
    g = x.shape[2]
    return x if g == n else x.repeat_interleave(n // g, dim=2)


def _reduce_groups(x, g: int):
    """``[b, s, n, d]`` gradient → ``[b, s, g, d]``: each group's heads
    summed (the transpose of :func:`_expand_groups`)."""
    b, s, n, d = x.shape
    return x if g == n else x.reshape(b, s, g, n // g, d).sum(3)


def _chunk_scores(q, k, scale: float, causal: bool):
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if causal:
        rows, cols = s.shape[-2], s.shape[-1]
        above = (torch.arange(cols, device=q.device)[None]
                 > torch.arange(rows, device=q.device)[:, None])
        s = s.masked_fill(above, _NEG_INF)
    return s


def _chunk_fwd_ref(q, k, v, scale: float, causal: bool):
    """Closed-form ``(o fp32 [b, s, n, d], lse [b·n, s])`` of one chunk
    (``_chunk_fwd_ref``, ring_attention.py:110): the plain version of
    K2's fp32-output branch."""
    b, sq, n, _ = q.shape
    k, v = _expand_groups(k, n), _expand_groups(v, n)
    s = _chunk_scores(q, k, scale, causal)
    m = s.amax(-1, keepdim=True)
    e = torch.where(m > _NEG_INF / 2, torch.exp(s - m), 0.0)
    l = e.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bnqk,bknd->bqnd", e / safe_l, v.float())
    lse = torch.where(l[..., 0] == 0.0, _NEG_INF,
                      m[..., 0] + torch.log(safe_l[..., 0]))
    return o, lse.reshape(b * n, sq)


def _chunk_bwd_ref(q, k, v, do, lse, delta, scale: float, causal: bool):
    """fp32 ``(dq, dk, dv)`` of one chunk from the ring's global ``lse``
    and ``delta`` ``[b·n, s]`` (``_chunk_bwd_ref``, ring_attention.py:
    127), dk and dv summed over each group's heads: the plain version of
    K6's and K7's fp32-output branches."""
    b, sq, n, _ = q.shape
    g = k.shape[2]
    kf, vf = _expand_groups(k, n).float(), _expand_groups(v, n).float()
    s = _chunk_scores(q, kf, scale, causal)
    lse4 = lse.reshape(b, n, sq, 1)
    p = torch.where(s > _NEG_INF / 2, torch.exp(s - lse4), 0.0)
    dof = do.float()
    dv = torch.einsum("bnqk,bqnd->bknd", p, dof)
    dp = torch.einsum("bqnd,bknd->bnqk", dof, vf)
    ds = p * (dp - delta.reshape(b, n, sq, 1)) * scale
    dq = torch.einsum("bnqk,bknd->bqnd", ds, kf)
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.float())
    return dq, _reduce_groups(dk, g), _reduce_groups(dv, g)


def _chunk_fwd(q, k, v, scale, causal, plain):
    if plain:
        return _chunk_fwd_ref(q, k, v, scale, causal)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               out_dtype=torch.float32)


def _chunk_bwd(q, k, v, do, lse, delta, scale, causal, plain):
    if plain:
        return _chunk_bwd_ref(q, k, v, do, lse, delta, scale, causal)
    ops = flash_bwd_operands(q, k, v, None, lse, do, scale=scale,
                             delta=delta)
    return (flash_bwd_dq(ops, causal=causal, out_dtype=torch.float32),
            *flash_bwd_dkv(ops, causal=causal, out_dtype=torch.float32))


def _ring_perm(n: int) -> list:
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_fwd(q, k, v, group, causal, scale, plain):
    n_ranks, my = group_size(group), group_rank(group)
    perm = _ring_perm(n_ranks)
    b, s, n, _ = q.shape
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b * n, s), _NEG_INF, dtype=torch.float32,
                         device=q.device)
    kv = torch.stack([k, v])
    for t in range(n_ranks):
        mode = _mode(my, (my - t) % n_ranks, causal)
        if mode != SKIP:
            o_c, lse_c = _chunk_fwd(q, kv[0], kv[1], scale,
                                    mode == DIAGONAL, plain)
            o_acc, lse_acc = _merge(o_acc, lse_acc, o_c, lse_c)
        if t < n_ranks - 1:
            kv = ppermute(kv, group, perm)
    return o_acc.to(q.dtype), lse_acc


def _ring_bwd(q, k, v, o, lse, do, group, causal, scale, plain):
    n_ranks, my = group_size(group), group_rank(group)
    perm = _ring_perm(n_ranks)
    do = do.to(q.dtype)
    # once, from the final o in q's dtype (ring_attention.py:295-296)
    delta = attention_delta(do, o)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                      device=k.device)
    kv = torch.stack([k, v])
    for t in range(n_ranks):
        mode = _mode(my, (my - t) % n_ranks, causal)
        if mode != SKIP:
            dq_c, dk_c, dv_c = _chunk_bwd(q, kv[0], kv[1], do, lse, delta,
                                          scale, mode == DIAGONAL, plain)
            dq += dq_c
            dkv[0] += dk_c
            dkv[1] += dv_c
        # K/V and their travelling accumulators rotate together; after
        # n hops the accumulators are home
        if t < n_ranks - 1:
            kv = ppermute(kv, group, perm)
        dkv = ppermute(dkv, group, perm)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, plain):
        o, lse = _ring_fwd(q, k, v, group, causal, scale, plain)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale, ctx.plain = (group, causal, scale,
                                                       plain)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, o, lse, do, ctx.group, ctx.causal,
                               ctx.scale, ctx.plain)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, group=None, *, causal: bool = False,
                   scale: Optional[float] = None,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Context-parallel attention over sequence-sharded ``[b, s_local, n,
    d]`` tensors, differentiable; ``group`` the ring's process group
    (``None``: the world), every rank's shard of equal length, shard
    ``i`` the global positions ``[i·s_local, (i+1)·s_local)``.  Grouped
    K/V ``[b, s_local, g, d]`` (g dividing n) ride the ring at group
    width and their gradients come back at it."""
    if q.ndim != 4:
        raise ValueError(f"expected [b, s_local, n, d], got {tuple(q.shape)}")
    if k.shape != v.shape:
        raise ValueError("ring attention requires equal k/v shard shapes")
    if q.shape[:2] + q.shape[3:] != k.shape[:2] + k.shape[3:]:
        raise ValueError(
            f"q/k shard shapes differ beyond the head axis: "
            f"{tuple(q.shape)} vs {tuple(k.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"query heads ({q.shape[2]}) must be a multiple of the K/V "
            f"group count ({k.shape[2]})")
    d = q.shape[-1]
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    plain = check_backend(backend) is not None or not on_cuda(q)
    return _Ring.apply(q, k, v, group, causal, scale, plain)
