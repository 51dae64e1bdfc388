"""FusedAdagrad (``apex_tpu/optimizers/fused_adagrad.py``)::

    h += g^2
    p -= lr * g / (sqrt(h) + eps)          (+ decoupled ``adagrad_w_mode``
    weight decay: p -= lr * wd * p)

Weight decay goes into the gradient (L2, the default) or is decoupled
(``adagrad_w_mode=True``).  A torch composition over each float leaf, as
the JAX package's is XLA: no train step of the repository runs it yet,
so a multi-tensor kernel for it waits for a measurement.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from apex_tpu_torch.optimizers._common import (
    GradientTransformation, ScheduleOrScalar, float_leaves, resolve_lr,
    tree_map_float, tree_zeros_like_f32)

__all__ = ["FusedAdagrad", "fused_adagrad", "AdagradState"]


class AdagradState(NamedTuple):
    step: torch.Tensor
    sum_sq: Any


def fused_adagrad(lr: ScheduleOrScalar = 1e-2, eps: float = 1e-10,
                  weight_decay: float = 0.0,
                  adagrad_w_mode: bool = False) -> GradientTransformation:
    def init(params) -> AdagradState:
        leaves = float_leaves(params)
        dev = leaves[0].device if leaves else None
        return AdagradState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            sum_sq=tree_zeros_like_f32(params))

    def update(grads, state: AdagradState, params=None):
        if params is None:
            raise ValueError("fused_adagrad requires params")
        step = state.step + 1
        lr_t = resolve_lr(lr, step)

        def grad32(g, p):
            g32 = g.float()
            if not adagrad_w_mode and weight_decay != 0.0:
                g32 = g32 + weight_decay * p.float()
            return g32

        h_tree = tree_map_float(lambda g, p, h: h + torch.square(grad32(g, p)),
                                grads, params, state.sum_sq)

        def upd_leaf(g, p, h):
            u = -lr_t * grad32(g, p) / (torch.sqrt(h) + eps)
            if adagrad_w_mode and weight_decay != 0.0:
                u = u - lr_t * weight_decay * p.float()
            return u

        updates = tree_map_float(upd_leaf, grads, params, h_tree)
        return updates, AdagradState(step, h_tree)

    return GradientTransformation(init, update)


FusedAdagrad = fused_adagrad
