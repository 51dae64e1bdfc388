"""Counted collectives over a process group (``apex_tpu/utils/
collectives.py``).

Every helper books ``collectives.<kind>.calls`` and ``.bytes`` (the
local operand's bytes) under the JAX package's names (``psum``,
``pmean``, ``pmin``, ``pmax``, ``all_gather``, ``all_to_all``,
``ppermute``, ``psum_scatter``) when a telemetry registry is installed.
In the port they count executed calls (the JAX package counts each
collective once when it traces it).

``group`` is a ``torch.distributed`` process group, ``None`` for the
world, or :data:`SINGLE` (an axis of one rank: every helper is then the
identity, as a collective over one device is).  Torch has no SPMD-AD:
every gradient reaching these helpers is this rank's own, so
``grad_sum`` always reduces (JAX's ``pvary``, ``vma_of``, ``match_vma``
and ``is_varying`` have no counterpart here).

Transport: NCCL moves device tensors directly.  A gloo group moves CUDA
tensors through host memory, in :func:`_host_staged` (one copy out, the
collective on the host, one copy back), counted as
``collectives.host_staged_bytes``: an explicit transport of the backend,
not a recovery from a refused call.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.optimizers._common import is_float_leaf, tree_map

__all__ = ["SINGLE", "group_size", "group_rank", "group_ranks", "grad_sum",
           "grad_mean", "flag_and", "flag_or", "all_gather", "all_to_all",
           "ppermute", "psum_scatter", "all_reduce", "broadcast"]


class _Single:
    """An axis of one rank (a mesh axis of size 1)."""

    def __repr__(self):
        return "SINGLE"


SINGLE = _Single()


def group_size(group) -> int:
    return 1 if group is SINGLE else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is SINGLE else dist.get_rank(group)


def group_ranks(group) -> list:
    """The group's members as global ranks, in group-rank order."""
    if group is SINGLE:
        return [dist.get_rank() if dist.is_initialized() else 0]
    if group is None:
        return list(range(dist.get_world_size()))
    return dist.get_process_group_ranks(group)


def _note_collective(kind: str, x) -> None:
    reg = _telemetry.registry()
    if reg is None:
        return
    nbytes = (int(math.prod(x.shape)) * x.element_size()
              if torch.is_tensor(x) else 0)
    reg.counter(f"collectives.{kind}.calls").inc()
    reg.counter(f"collectives.{kind}.bytes").inc(nbytes)


def _stages(group, *tensors) -> bool:
    """Whether the group's backend moves these tensors through the host
    (gloo with CUDA tensors)."""
    return (any(t.device.type == "cuda" for t in tensors)
            and dist.get_backend(group) == "gloo")


def _host_staged(group, run: Callable, outs: Sequence[torch.Tensor],
                 ins: Sequence[torch.Tensor]) -> None:
    """``run(outs, ins)`` on the host when the group stages (copies of
    every operand; outputs copied back), else on the tensors as they
    are."""
    if not _stages(group, *outs, *ins):
        run(outs, ins)
        return
    host_in = [t.detach().to("cpu") for t in ins]
    host_out = [torch.empty(t.shape, dtype=t.dtype) for t in outs]
    reg = _telemetry.registry()
    if reg is not None:
        reg.counter("collectives.host_staged_bytes").inc(
            sum(t.numel() * t.element_size() for t in host_in))
    run(host_out, host_in)
    for t, h in zip(outs, host_out):
        t.copy_(h)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
               kind: Optional[str] = "psum",
               inplace: bool = False) -> torch.Tensor:
    """``x`` reduced over the group (``op``): a new tensor, or ``x``
    itself under ``inplace`` (contiguous; no copy of it is made on the
    device).  Counted under ``kind`` (not at all for None: a step of
    another counted helper)."""
    if group is SINGLE:
        return x if inplace else x.clone()
    if kind is not None:
        _note_collective(kind, x)
    if inplace and not x.is_contiguous():
        raise ValueError("all_reduce(inplace=True) needs a contiguous tensor")
    out = x.detach() if inplace else x.detach().clone().contiguous()

    def run(outs, ins):
        if outs[0] is not ins[0]:
            outs[0].copy_(ins[0])
        dist.all_reduce(outs[0], op=op, group=group)

    _host_staged(group, run, [out], [out])
    return out


def broadcast(x: torch.Tensor, group, src_group_rank: int = 0):
    """``x`` of the group's rank ``src_group_rank`` on every rank (a new
    tensor)."""
    if group is SINGLE:
        return x.clone()
    out = x.detach().clone().contiguous()
    src = group_ranks(group)[src_group_rank]

    def run(outs, ins):
        if outs[0] is not ins[0]:
            outs[0].copy_(ins[0])
        dist.broadcast(outs[0], src=src, group=group)

    _host_staged(group, run, [out], [out])
    return out


def grad_sum(tree: Any, group) -> Any:
    """Sum every float leaf over the group (new tensors)."""
    return tree_map(lambda g: all_reduce(g, group)
                    if is_float_leaf(g) else g, tree)


def grad_mean(tree: Any, group, inplace: bool = False) -> Any:
    """Average every float leaf over the group (a sum, then a division
    by the group's size, in the leaf's dtype; ``inplace``: into the
    leaves themselves, which the caller owns: no second gradient tree on
    the device)."""
    n = group_size(group)

    def red(g):
        if not is_float_leaf(g) or group is SINGLE:
            return g
        g = all_reduce(g, group, kind="pmean", inplace=inplace)
        return g.div_(n) if inplace else g / n

    return tree_map(red, tree)


def flag_and(flag: torch.Tensor, group) -> torch.Tensor:
    """AND a boolean over the group (the found-inf combine)."""
    if group is SINGLE:
        return flag
    return all_reduce(flag.to(torch.int32), group, dist.ReduceOp.MIN,
                      kind="pmin") > 0


def flag_or(flag: torch.Tensor, group) -> torch.Tensor:
    if group is SINGLE:
        return flag
    return all_reduce(flag.to(torch.int32), group, dist.ReduceOp.MAX,
                      kind="pmax") > 0


def all_gather(x: torch.Tensor, group, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in group-rank order: stacked on a new ``axis``,
    or (``tiled``) concatenated along it."""
    if group is SINGLE:
        return x.clone() if tiled else x.unsqueeze(axis)
    _note_collective("all_gather", x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]

    def run(outs, ins):
        dist.all_gather(list(outs), ins[0], group=group)

    _host_staged(group, run, parts, [x])
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int,
               *, tiled: bool = False) -> torch.Tensor:
    """JAX's ``all_to_all``: ``x`` split into group-size chunks along
    ``split_axis``, chunk ``j`` sent to rank ``j``; the chunks received
    concatenated along ``concat_axis`` in rank order (``tiled``), or
    stacked on it."""
    n = group_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    if group is SINGLE:
        return x.clone() if tiled else x.unsqueeze(concat_axis)
    _note_collective("all_to_all", x)
    send = torch.stack(x.chunk(n, split_axis)).contiguous()
    recv = torch.empty_like(send)

    def run(outs, ins):
        dist.all_to_all_single(outs[0], ins[0], group=group)

    _host_staged(group, run, [recv], [send])
    parts = list(recv.unbind(0))
    return (torch.cat(parts, concat_axis) if tiled
            else torch.stack(parts, concat_axis))


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """JAX's ``ppermute``: ``perm`` lists ``(source, destination)`` group
    ranks; this rank sends ``x`` to its destination and returns what its
    source sent (zeros without one), by ``batch_isend_irecv``.  The ring's
    permutation is ``[(i, (i + 1) % n)]``."""
    if group is SINGLE:
        return x.clone()
    _note_collective("ppermute", x)
    me, ranks = group_rank(group), group_ranks(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    x = x.contiguous()
    out = torch.zeros_like(x)

    def run(outs, ins):
        ops = [dist.P2POp(dist.isend, ins[0], ranks[d], group=group)
               for d in dst]
        ops += [dist.P2POp(dist.irecv, outs[0], ranks[s], group=group)
                for s in src]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    _host_staged(group, run, [out], [x])
    return out


def psum_scatter(x: torch.Tensor, group, *, scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """This rank's chunk (``scatter_dimension`` split group-size ways) of
    the group's sum of ``x``; without ``tiled`` the chunk's axis (of size
    1) is squeezed, as JAX's is."""
    n = group_size(group)
    if x.shape[scatter_dimension] % n:
        raise ValueError(f"psum_scatter: axis {scatter_dimension} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    if group is not SINGLE:
        _note_collective("psum_scatter", x)
        x = all_reduce(x, group, kind=None)
    part = x.chunk(n, scatter_dimension)[group_rank(group)]
    return part if tiled else part.squeeze(scatter_dimension)
