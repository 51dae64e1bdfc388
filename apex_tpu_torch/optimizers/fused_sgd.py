"""FusedSGD — SGD with momentum, dampening, Nesterov and weight decay
(``apex_tpu/optimizers/fused_sgd.py``), torch.optim.SGD's semantics::

    d = g + wd * p
    buf = momentum * buf + (1 - dampening) * d        (first step: buf = d)
    update = d + momentum * buf        if nesterov
           = buf                       otherwise
    p -= lr * update

A torch composition over each float leaf, as the JAX package's is XLA: no
train step of the repository runs it yet, so a multi-tensor kernel for it
waits for a measurement.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from apex_tpu_torch.optimizers._common import (
    GradientTransformation, ScheduleOrScalar, float_leaves, resolve_lr,
    tree_map_float, tree_zeros_like_f32)

__all__ = ["FusedSGD", "fused_sgd", "SGDState"]


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum_buffer: Any


def fused_sgd(lr: ScheduleOrScalar = 1e-3, momentum: float = 0.0,
              dampening: float = 0.0, weight_decay: float = 0.0,
              nesterov: bool = False) -> GradientTransformation:
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError(
            "Nesterov momentum requires a momentum and zero dampening")

    def init(params) -> SGDState:
        leaves = float_leaves(params)
        dev = leaves[0].device if leaves else None
        return SGDState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        momentum_buffer=tree_zeros_like_f32(params))

    def update(grads, state: SGDState, params=None):
        if params is None:
            raise ValueError("fused_sgd requires params")
        step = state.step + 1
        lr_t = resolve_lr(lr, step)
        first = state.step == 0

        def decayed(g, p):
            d = g.float()
            if weight_decay != 0.0:
                d = d + weight_decay * p.float()
            return d

        def bufs(g, p, b):
            d = decayed(g, p)
            if momentum == 0.0:
                return d
            # torch keeps buf = d on the very first step (no dampening)
            return torch.where(first, d, momentum * b + (1.0 - dampening) * d)

        new_buf = tree_map_float(bufs, grads, params, state.momentum_buffer)

        def upd(g, p, b):
            d = decayed(g, p)
            if momentum == 0.0:
                u = d
            elif nesterov:
                u = d + momentum * b
            else:
                u = b
            return -lr_t * u

        updates = tree_map_float(upd, grads, params, new_buf)
        return updates, SGDState(step, new_buf)

    return GradientTransformation(init, update)


FusedSGD = fused_sgd
