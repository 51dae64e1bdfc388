"""FusedAdam — Adam/AdamW as a ``GradientTransformation``
(``apex_tpu/optimizers/fused_adam.py``, the tree path :117-142).

- ``adam_w_mode=True`` → decoupled weight decay (AdamW); False → L2-style
  decay added to the gradient (classic Adam).
- ``bias_correction`` as in the reference.
- ``step`` is a device tensor and lr may be a schedule.
- ``amsgrad`` is rejected as in the reference.

The update is a torch composition over each leaf (fp32 moments whatever
the parameter dtype): the JAX package computes it in XLA, not Pallas
(``ops/flat_adam.py``), so there is no TPU kernel to port; a CUDA kernel
for it comes only after a measurement shows the need.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.optimizers._common import (
    GradientTransformation, ScheduleOrScalar, resolve_lr, tree_leaves,
    tree_map_float, tree_zeros_like_f32)

__all__ = ["FusedAdam", "fused_adam", "AdamState"]


class AdamState(NamedTuple):
    step: torch.Tensor
    exp_avg: Any
    exp_avg_sq: Any


def fused_adam(lr: ScheduleOrScalar = 1e-3,
               betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True, amsgrad: bool = False,
               use_flat_buffer: bool = False,
               norm_telemetry: bool = False) -> GradientTransformation:
    if amsgrad:
        raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
    if use_flat_buffer or norm_telemetry:
        raise NotImplementedError(
            "use_flat_buffer and norm_telemetry come with the distributed "
            "training slice of the port")
    beta1, beta2 = betas

    def init(params) -> AdamState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         exp_avg=tree_zeros_like_f32(params),
                         exp_avg_sq=tree_zeros_like_f32(params))

    def update(grads, state: AdamState, params=None):
        if params is None:
            raise ValueError("fused_adam requires params")
        step = state.step + 1
        lr_t = resolve_lr(lr, step)
        if bias_correction:
            t = step.float()
            bc1 = 1.0 - torch.pow(torch.full_like(t, beta1), t)
            bc2 = 1.0 - torch.pow(torch.full_like(t, beta2), t)
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32,
                                   device=step.device)

        def adj_grad(g, p):
            g32 = g.float()
            if not adam_w_mode and weight_decay != 0.0:
                g32 = g32 + weight_decay * p.float()
            return g32

        m_tree = tree_map_float(
            lambda g, p, m: beta1 * m + (1.0 - beta1) * adj_grad(g, p),
            grads, params, state.exp_avg)
        v_tree = tree_map_float(
            lambda g, p, v: beta2 * v
            + (1.0 - beta2) * torch.square(adj_grad(g, p)),
            grads, params, state.exp_avg_sq)

        def upd_leaf(m, v, p):
            denom = torch.sqrt(v / bc2) + eps
            upd = -lr_t * (m / bc1) / denom
            if adam_w_mode and weight_decay != 0.0:
                upd = upd - lr_t * weight_decay * p.float()
            return upd

        updates = tree_map_float(upd_leaf, m_tree, v_tree, params)
        return updates, AdamState(step, m_tree, v_tree)

    return GradientTransformation(init, update)


# Drop-in-named alias: `FusedAdam(lr=...)` reads like the reference ctor.
FusedAdam = fused_adam
