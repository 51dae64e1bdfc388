"""FusedNovoGrad — NovoGrad with per-tensor second-moment norms
(``apex_tpu/optimizers/fused_novograd.py``).

The second moment is one scalar a tensor: an EMA of the gradient's norm
(kept as a norm, not its square), L2 norms blended in quadrature
``v = sqrt(beta2·v² + (1-beta2)·|g|²)``, inf norms linearly, with bias
correction ``sqrt(1-beta2^t)``.  Knobs as the reference's:
``reg_inside_moment``, ``grad_averaging`` (beta3), ``norm_type`` (2 or
0 = inf), ``init_zero`` (start the EMA at 0, or at the first norm so the
first blend is a no-op).  The L2 norms of every tensor come from one
``multi_tensor_l2norm`` call (M2 on the card); the rest is a torch
composition, as the JAX package's is XLA.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.multi_tensor.multi_tensor_apply import multi_tensor_l2norm
from apex_tpu_torch.optimizers._common import (
    GradientTransformation, ScheduleOrScalar, float_leaves, rebuild,
    resolve_lr, tree_map_float, tree_zeros_like_f32)

__all__ = ["FusedNovoGrad", "fused_novograd", "NovoGradState"]


class NovoGradState(NamedTuple):
    step: torch.Tensor
    exp_avg: Any
    exp_avg_norm: Any   # one 0-d norm per tensor


def fused_novograd(lr: ScheduleOrScalar = 1e-3,
                   betas: Tuple[float, float] = (0.95, 0.98),
                   eps: float = 1e-8, weight_decay: float = 0.0,
                   bias_correction: bool = True,
                   reg_inside_moment: bool = False,
                   grad_averaging: bool = True, norm_type: int = 2,
                   init_zero: bool = False) -> GradientTransformation:
    if norm_type not in (0, 2):
        raise RuntimeError("FusedNovoGrad only supports l2/inf norm now.")
    beta1, beta2 = betas
    beta3 = (1.0 - beta1) if grad_averaging else 1.0

    def init(params) -> NovoGradState:
        leaves = float_leaves(params)
        dev = leaves[0].device if leaves else None
        return NovoGradState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg=tree_zeros_like_f32(params),
            exp_avg_norm=tree_map_float(
                lambda p: torch.zeros((), dtype=torch.float32,
                                      device=p.device), params))

    def grad_norms(grads):
        leaves = float_leaves(grads)
        if norm_type == 0:
            return [torch.max(torch.abs(g.float())) for g in leaves]
        if not leaves:
            return []
        return list(multi_tensor_l2norm(leaves, per_tensor=True)[1])

    def update(grads, state: NovoGradState, params=None):
        if params is None:
            raise ValueError("fused_novograd requires params")
        step = state.step + 1
        lr_t = resolve_lr(lr, step)
        first = state.step == 0
        t = step.float()
        if bias_correction:
            bc1 = 1.0 - torch.pow(torch.full_like(t, beta1), t)
            bc2 = torch.sqrt(1.0 - torch.pow(torch.full_like(t, beta2), t))
        else:
            bc1 = bc2 = torch.ones_like(t)

        def v_leaf(n, v):
            v_prev = v if init_zero else torch.where(first, n, v)
            if norm_type == 2:
                return torch.sqrt(beta2 * torch.square(v_prev)
                                  + (1.0 - beta2) * torch.square(n))
            return beta2 * v_prev + (1.0 - beta2) * n

        norms = rebuild(grads, grad_norms(grads))
        v_tree = tree_map_float(v_leaf, norms, state.exp_avg_norm)

        def m_leaf(g, p, m, v):
            g32, p32 = g.float(), p.float()
            if reg_inside_moment:
                d = g32 / (v / bc2 + eps) + weight_decay * p32
                return beta1 * m + beta3 * d
            return beta1 * m + beta3 * g32

        m_tree = tree_map_float(m_leaf, grads, params, state.exp_avg, v_tree)

        def upd_leaf(m, v, p):
            if reg_inside_moment:
                return -lr_t * (m / bc1)
            u = (m / bc1) / (v / bc2 + eps) + weight_decay * p.float()
            return -lr_t * u

        updates = tree_map_float(upd_leaf, m_tree, v_tree, params)
        return updates, NovoGradState(step, m_tree, v_tree)

    return GradientTransformation(init, update)


FusedNovoGrad = fused_novograd
