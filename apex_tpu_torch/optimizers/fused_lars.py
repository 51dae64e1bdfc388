"""FusedLARS — layer-wise adaptive rate scaling on momentum SGD
(``apex_tpu/optimizers/fused_lars.py``)::

    trust = tc * |p| / (|g| + wd*|p| + eps)          (1 if either norm is 0)
    scaled_lr = lr * trust                           (plain lr for skipped
                                                      tensors)
    d    = g + wd * p
    mom  = momentum * mom - scaled_lr * d
    p   += momentum * mom - scaled_lr * d            if nesterov
    p   += mom                                       otherwise

``skip_predicate(path) -> bool`` selects the tensors that bypass the
trust ratio (conventionally biases and norm parameters); a path is the
tuple of dict keys and sequence indices from the root to the leaf.  The
norms of every parameter and gradient come from two
``multi_tensor_l2norm`` calls (M2 on the card); the rest is a torch
composition, as the JAX package's is XLA.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from apex_tpu_torch.multi_tensor.multi_tensor_apply import multi_tensor_l2norm
from apex_tpu_torch.optimizers._common import (
    GradientTransformation, ScheduleOrScalar, float_leaves, is_float_leaf,
    rebuild, resolve_lr, tree_zeros_like_f32)

__all__ = ["FusedLARS", "fused_lars", "LARSState"]


class LARSState(NamedTuple):
    step: torch.Tensor
    momentum_buffer: Any


def _float_paths(tree, path=()) -> list:
    """The paths of ``tree``'s float leaves, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _float_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree)
                for q in _float_paths(v, path + (i,))]
    return [path] if is_float_leaf(tree) else []


def fused_lars(lr: ScheduleOrScalar = 1e-2, momentum: float = 0.9,
               dampening: float = 0.0, weight_decay: float = 0.0,
               nesterov: bool = False, trust_coefficient: float = 0.001,
               eps: float = 0.0,
               skip_predicate: Optional[Callable[[tuple], bool]] = None
               ) -> GradientTransformation:
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError(
            "Nesterov momentum requires a momentum and zero dampening")

    def init(params) -> LARSState:
        leaves = float_leaves(params)
        dev = leaves[0].device if leaves else None
        return LARSState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         momentum_buffer=tree_zeros_like_f32(params))

    def update(grads, state: LARSState, params=None):
        if params is None:
            raise ValueError("fused_lars requires params")
        step = state.step + 1
        lr_t = resolve_lr(lr, step)
        gs, ps = float_leaves(grads), float_leaves(params)
        moms = float_leaves(state.momentum_buffer)
        paths = _float_paths(grads)
        if gs:
            p_norms = multi_tensor_l2norm(ps, per_tensor=True)[1]
            g_norms = multi_tensor_l2norm(gs, per_tensor=True)[1]
        new_mom, updates = [], []
        for i, (path, g, p, mom) in enumerate(zip(paths, gs, ps, moms)):
            g32, p32 = g.float(), p.float()
            if skip_predicate is not None and skip_predicate(path):
                scaled_lr = lr_t
            else:
                p_norm, g_norm = p_norms[i], g_norms[i]
                trust = torch.where(
                    (g_norm > 0.0) & (p_norm > 0.0),
                    trust_coefficient * p_norm
                    / (g_norm + p_norm * weight_decay + eps), 1.0)
                scaled_lr = lr_t * trust
            d = g32 + weight_decay * p32
            m_new = momentum * mom - scaled_lr * d
            new_mom.append(m_new)
            updates.append(momentum * m_new - scaled_lr * d if nesterov
                           else m_new)
        return (rebuild(grads, updates),
                LARSState(step, rebuild(state.momentum_buffer, new_mom)))

    return GradientTransformation(init, update)


FusedLARS = fused_lars
