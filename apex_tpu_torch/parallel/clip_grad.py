"""Fused gradient clipping (``apex_tpu/parallel/clip_grad.py``).

Reference: apex/contrib/clip_grad/clip_grad.py:16 ``clip_grad_norm_`` —
one ``multi_tensor_l2norm`` for the global norm and one scale for the
clip.  ``group=`` makes the norm global over a process group whose ranks
each hold a part of the gradients (the squared sums, or the maxima,
reduced over it); data-parallel replicas hold the same gradients after
their reduction and need no group.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.optimizers._common import (
    float_leaves, global_norm, is_float_leaf, tree_map)
from apex_tpu_torch.utils.collectives import all_reduce

__all__ = ["clip_grad_norm", "clip_grad_norm_"]


def clip_grad_norm(grads: Any, max_norm: float, norm_type: float = 2.0,
                   error_if_nonfinite: bool = False, *, group=None,
                   backend: Optional[str] = None
                   ) -> Tuple[Any, torch.Tensor]:
    """``(clipped_grads, total_norm)``: every float leaf times
    ``min(max_norm / (total + 1e-6), 1)`` in fp32, cast back to its
    dtype.  ``error_if_nonfinite`` poisons the scale with NaN on a
    non-finite norm (the JAX package's jit-safe form of the raise), so
    the AMP overflow check catches the step.  ``group``: the norm over
    every rank's leaves."""
    leaves = float_leaves(grads)
    dev = leaves[0].device if leaves else None
    inf = norm_type == float("inf")
    if norm_type == 2.0 and group is None:
        total = (global_norm(grads, backend=backend) if leaves
                 else torch.zeros(()))
    elif inf:
        total = (torch.stack([x.float().abs().amax() for x in leaves]).amax()
                 if leaves else torch.zeros((), device=dev))
    else:
        p = float(norm_type)
        total = (sum(x.float().abs().pow(p).sum() for x in leaves)
                 if leaves else torch.zeros((), device=dev))
    if group is not None:
        if inf:
            total = all_reduce(total, group, dist.ReduceOp.MAX, kind="pmax")
        else:
            total = all_reduce(total, group) ** (1.0 / float(norm_type))
    elif not inf and norm_type != 2.0:
        total = total ** (1.0 / float(norm_type))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    if error_if_nonfinite:
        scale = torch.where(torch.isfinite(total), scale, float("nan"))
    clipped = tree_map(lambda g: (g.float() * scale).to(g.dtype)
                       if is_float_leaf(g) else g, grads)
    return clipped, total


clip_grad_norm_ = clip_grad_norm
