"""The rank mesh (``apex_tpu/parallel/mesh.py``): the process-group layer.

The JAX package names the axes of a ``jax.sharding.Mesh`` of devices,
outer to inner ``('pp', 'dp', 'sp', 'ep', 'tp')``.  Here the mesh is
over the world's ranks, ``reshape(pp, dp, sp, ep, tp)`` of the rank list
in the same order, and each axis is a family of process groups: the
lines of the reshaped array along that axis, one group each.  A rank
holds its coordinate on every axis and the group of its own line
(:meth:`Mesh.group`; an axis of size 1 is :data:`~apex_tpu_torch.utils.
collectives.SINGLE`, no group).  Without an initialised process group
the mesh is one rank with every axis of size 1.

``torch.distributed.new_group`` is collective over the world: every
rank creates every line's group, in the same order.  :func:`create_mesh`
creates each axis's groups at once; a group over several axes
(``mesh.group(("dp", "sp"))``) is created at its first request, which
every rank makes at the same point (the step builders ask while they
build).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.utils.collectives import SINGLE, broadcast
from apex_tpu_torch.optimizers._common import tree_map

__all__ = ["Mesh", "create_mesh", "data_parallel_mesh", "replicate",
           "shard_batch", "AXES"]

AXES = ("pp", "dp", "sp", "ep", "tp")


class Mesh:
    """Ranks ``[pp, dp, sp, ep, tp]`` and this rank's place in them."""

    def __init__(self, ranks: np.ndarray, rank: int):
        self.devices = ranks            # the JAX attribute's name
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, ranks.shape))
        self.rank = rank
        where = np.argwhere(ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh {ranks}")
        self.coords: Dict[str, int] = dict(zip(AXES, map(int, where[0])))
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r}; axes are {AXES}")
        return tuple(a for a in AXES if a in axes)

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._key(axes)]))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over several)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def lines(self, axes) -> list:
        """Every line of ranks along ``axes`` (global ranks, each in its
        axis-index order), in a fixed order."""
        key = self._key(axes)
        inner = [AXES.index(a) for a in key]
        outer = [i for i in range(len(AXES)) if i not in inner]
        arr = np.transpose(self.devices, outer + inner)
        n = int(np.prod([self.devices.shape[i] for i in inner]))
        return [list(map(int, row)) for row in arr.reshape(-1, n)]

    def group(self, axes):
        """The process group of this rank's line along ``axes`` (an axis
        name or several), :data:`SINGLE` where that line is one rank."""
        key = self._key(axes)
        if key not in self._groups:
            if self.axis_size(key) == 1:
                self._groups[key] = SINGLE
            elif not dist.is_initialized():
                raise RuntimeError(
                    f"axis {key} spans {self.axis_size(key)} ranks but no "
                    "process group is open (parallel.init_distributed)")
            else:
                mine = None
                for line in self.lines(key):
                    g = dist.new_group(line)
                    if self.rank in line:
                        mine = g
                self._groups[key] = mine
        return self._groups[key]


def create_mesh(dp: Optional[int] = None, tp: int = 1, pp: int = 1,
                sp: int = 1, ep: int = 1,
                ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A ``('pp', 'dp', 'sp', 'ep', 'tp')`` mesh over ``ranks`` (default:
    the world's, or rank 0 alone without a process group).  ``dp=None``
    takes what is left after tp, pp, sp and ep; the divisibility errors
    are the JAX package's.  Creates each axis's groups (with a process
    group open; without one the mesh shows its layout, seen from the
    first rank)."""
    if ranks is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = list(range(world))
    ranks = list(ranks)
    world = len(ranks)
    denom = tp * pp * sp * ep
    if world % denom != 0:
        raise ValueError(
            f"world size {world} is not divisible by tp*pp*sp*ep = {denom}")
    if dp is None:
        dp = world // denom
    if dp * denom != world:
        raise ValueError(
            f"dp*tp*pp*sp*ep = {dp * denom} != world size {world}")
    me = dist.get_rank() if dist.is_initialized() else ranks[0]
    mesh = Mesh(np.asarray(ranks).reshape(pp, dp, sp, ep, tp), me)
    if dist.is_initialized():
        for a in AXES:
            mesh.group(a)
    return mesh


def data_parallel_mesh(ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Pure data-parallel mesh (apex DDP's world)."""
    return create_mesh(tp=1, pp=1, sp=1, ranks=ranks)


def replicate(mesh: Mesh, tree, *, axes: Union[str, Tuple[str, ...]] = AXES):
    """``tree`` with every tensor broadcast from the first rank of this
    rank's line along ``axes`` (default: the whole mesh), so that every
    replica holds the same values: plain DDP's replicated parameters."""
    group = mesh.group(axes)
    return tree_map(lambda x: broadcast(x, group)
                    if torch.is_tensor(x) else x, tree)


def shard_batch(mesh: Mesh, x: torch.Tensor, *, axis: str = "dp",
                dim: int = 0) -> torch.Tensor:
    """This rank's shard of a global batch: ``x`` cut into the axis's
    size equal parts along ``dim``, the part of this rank's index."""
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(
            f"dimension {dim} of {tuple(x.shape)} does not split over the "
            f"{n} ranks of axis {axis!r}")
    return x.chunk(n, dim)[mesh.axis_index(axis)]
