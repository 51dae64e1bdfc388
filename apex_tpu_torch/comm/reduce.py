"""Compressed gradient collectives over a process group
(``apex_tpu/comm/reduce.py``).

The all-reduce is reduce-scatter + all-gather with block-scaled
quantization in both phases (EQuARX, arXiv:2506.17615):

1. scatter — each rank splits its (error-compensated) local gradient
   into ``n`` equal shards, quantizes and ``all_to_all``s the wire
   bytes: rank ``j`` receives every rank's copy of shard ``j``,
   dequantizes in fp32 and sums over ranks in rank order;
2. gather — the owner re-quantizes its reduced shard and
   ``all_gather``s the wire bytes; every rank dequantizes to fp32.

:func:`compressed_allreduce` runs both, :func:`compressed_reduce_scatter`
the first.  Error feedback keeps a per-leaf fp32 residual of this
rank's quantization error (``contribution − dequant(wire)``), added to
the next step's contribution (EF-SGD).  A torch process is one rank, so
its residuals are its own: they ride the train state
(``TrainState.comm_state``) with the JAX layout's leading axis of one.

Every float leaf is this rank's own gradient (no SPMD-AD pre-summing in
torch), so :func:`reduce_gradients` buckets them all.

Telemetry, per executed collective: ``collectives.compressed.calls``,
``.bytes`` (wire payload + scale bytes, both phases) and ``.raw_bytes``
(what fp32 would move: 2 passes for an all-reduce, 1 for a
reduce-scatter).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.comm.bucketing import (
    gather_bucket, plan_buckets, scatter_buckets)
from apex_tpu_torch.comm.config import GradCommConfig
from apex_tpu_torch.comm.quantize import (
    dequantize_blocks, quantize_blocks, scale_bytes_per_element,
    wire_itemsize)
from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.optimizers._common import float_leaves, rebuild
from apex_tpu_torch.utils import collectives as coll

__all__ = ["compressed_allreduce", "compressed_reduce_scatter",
           "reduce_gradients", "init_error_state"]


def _note_compressed(cfg: GradCommConfig, n_elements: int,
                     passes_raw: int, passes_wire: int) -> None:
    reg = _telemetry.registry()
    if reg is None:
        return
    per_el = wire_itemsize(cfg.wire_dtype) + scale_bytes_per_element(
        cfg.wire_dtype, cfg.block)
    reg.counter("collectives.compressed.calls").inc()
    reg.counter("collectives.compressed.bytes").inc(
        int(passes_wire * per_el * n_elements))
    reg.counter("collectives.compressed.raw_bytes").inc(
        int(passes_raw * 4 * n_elements))


def _scatter_phase(flat: torch.Tensor, group, cfg: GradCommConfig, *,
                   shard_size: Optional[int] = None,
                   residual: Optional[torch.Tensor] = None,
                   predivide: Optional[float] = None):
    """Quantize → all_to_all → local dequant-sum: ``(local_sum [shard],
    err [L] | None, shard, padded)``, ``local_sum`` this rank's shard of
    the cross-rank sum."""
    n = coll.group_size(group)
    length = flat.shape[0]
    x = flat.float()
    if predivide:
        x = x / predivide
    c = x + residual if residual is not None else x
    if shard_size is not None:
        shard = shard_size
    else:
        shard = -(-length // n)
        if cfg.wire_dtype == "int8":
            # block-aligned shard rows: a block never straddles two
            # leaves' block-aligned spans
            shard = -(-shard // cfg.block) * cfg.block
    padded = shard * n
    if length > padded:
        raise ValueError(
            f"flat length {length} exceeds shard_size*n = {padded}")
    cp = F.pad(c, (0, padded - length)).reshape(n, shard)
    wire, scales = quantize_blocks(cp, cfg.wire_dtype, cfg.block)
    recv_w = coll.all_to_all(wire, group, 0, 0, tiled=True)
    recv_s = (coll.all_to_all(scales, group, 0, 0, tiled=True)
              if scales is not None else None)
    contrib = dequantize_blocks(recv_w, recv_s, cfg.block, shard)
    # rank order, elementwise over the rank axis: independent of the
    # bucket geometry
    local_sum = contrib.sum(0)
    err = None
    if residual is not None:
        own = dequantize_blocks(wire, scales, cfg.block, shard)
        err = c - own.reshape(padded)[:length]
    return local_sum, err, shard, padded


def compressed_allreduce(flat: torch.Tensor, group, cfg: GradCommConfig, *,
                         residual: Optional[torch.Tensor] = None,
                         average: bool = True,
                         predivide: Optional[float] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Block-scaled quantized all-reduce of a flat fp32 vector over
    ``group``: ``(reduced [L], new_residual [L] | None)``, the mean over
    ranks when ``average`` (``predivide`` as ``parallel.
    allreduce_gradients``'s), the same on every rank."""
    n = coll.group_size(group)
    length = flat.shape[0]
    local_sum, err, shard, padded = _scatter_phase(
        flat, group, cfg, residual=residual, predivide=predivide)
    if average:
        local_sum = local_sum / (n / predivide if predivide else n)
    wire2, scales2 = quantize_blocks(local_sum, cfg.wire_dtype, cfg.block)
    full_w = coll.all_gather(wire2, group)
    full_s = (coll.all_gather(scales2, group)
              if scales2 is not None else None)
    rows = dequantize_blocks(full_w, full_s, cfg.block, shard)
    out = rows.reshape(padded)[:length]
    _note_compressed(cfg, padded, passes_raw=2, passes_wire=2)
    return out, err


def compressed_reduce_scatter(flat: torch.Tensor, group,
                              cfg: GradCommConfig, *, shard_size: int,
                              residual: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    """The scatter phase alone: this rank's ``shard_size`` shard of the
    cross-rank sum (rank ``i`` holds elements ``[i·shard, (i+1)·shard)``
    of ``flat`` zero-padded to ``shard_size·n``), and the new
    residual."""
    local_sum, err, _, padded = _scatter_phase(
        flat, group, cfg, shard_size=shard_size, residual=residual)
    _note_compressed(cfg, padded, passes_raw=1, passes_wire=1)
    return local_sum, err


def init_error_state(tree: Any) -> Tuple[torch.Tensor, ...]:
    """Zero fp32 residuals ``[1, *leaf.shape]`` for every float leaf of
    ``tree`` (its order), on the leaves' devices (the JAX layout, whose
    leading axis is the rank axis a shard_map wrapper splits)."""
    return tuple(torch.zeros((1,) + tuple(x.shape), dtype=torch.float32,
                             device=x.device) for x in float_leaves(tree))


def reduce_gradients(tree: Any, group, cfg: GradCommConfig,
                     residuals: Optional[Sequence[torch.Tensor]] = None, *,
                     average: bool = True,
                     predivide: Optional[float] = None
                     ) -> Tuple[Any, Optional[Tuple[torch.Tensor, ...]]]:
    """Bucketed compressed reduction of a gradient tree: the float leaves
    packed into dtype-segregated greedy buckets (``cfg.bucket_bytes``;
    int8 slices aligned to its block), one :func:`compressed_allreduce`
    a bucket.  ``residuals`` is :func:`init_error_state`'s tuple; returns
    ``(reduced_tree, new_residuals)``."""
    if not cfg.compresses:
        raise ValueError(
            "reduce_gradients is the compressed path; use "
            "utils.collectives.grad_mean / parallel.allreduce_gradients "
            "for fp32 wire")
    leaves = float_leaves(tree)
    if residuals is not None and len(residuals) != len(leaves):
        raise ValueError(
            f"residual count {len(residuals)} != floating leaf count "
            f"{len(leaves)} (build it with comm.init_error_state)")
    plan = plan_buckets(leaves, cfg.bucket_bytes,
                        align=cfg.block if cfg.wire_dtype == "int8" else 1)
    res_leaves = ([r.reshape(x.shape) for r, x in zip(residuals, leaves)]
                  if residuals is not None else None)
    outs: List[torch.Tensor] = []
    errs: List[torch.Tensor] = []
    for bucket in plan:
        flat = gather_bucket(leaves, bucket)
        rflat = (gather_bucket(res_leaves, bucket)
                 if res_leaves is not None else None)
        out, err = compressed_allreduce(flat, group, cfg, residual=rflat,
                                        average=average, predivide=predivide)
        outs.append(out)
        if err is not None:
            errs.append(err)
    reduced = rebuild(tree, scatter_buckets(leaves, plan, outs))
    new_res = None
    if residuals is not None:
        new_res = tuple(e.reshape(r.shape) for e, r in zip(
            scatter_buckets(res_leaves, plan, errs), residuals))
    return reduced, new_res

