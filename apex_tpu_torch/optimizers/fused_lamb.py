"""FusedLAMB — layer-wise adaptive moments with global gradient clipping
(``apex_tpu/optimizers/fused_lamb.py``).

Two phases, as the reference's ``multi_tensor_lamb``:

1. the global gradient norm over every float leaf clips the gradients
   (each divided by ``max(norm / max_grad_norm, 1)``), then each leaf's
   moments update, with the L2 term ``weight_decay · p`` folded into the
   gradient when ``adam_w_mode=False``;
2. each leaf's update ``u = m̂ / (sqrt(v̂) + eps)`` (plus ``weight_decay ·
   p`` in AdamW mode) is scaled by the trust ratio ``‖p‖ / ‖u‖`` (1 when
   either norm is 0, and 1 for ``weight_decay == 0`` unless
   ``use_nvlamb``), and ``-lr · ratio · u`` is returned.

The ratio is per leaf, as in the JAX package.  The layer weights are
stacked on a leading ``L`` axis, so one ratio spans all layers of a
weight; the reference Apex computes one per parameter tensor (per
layer).  The JAX package computes this in XLA, not Pallas, so it is a
torch composition here.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.optimizers._common import (
    GradientTransformation, ScheduleOrScalar, global_norm, resolve_lr,
    tree_leaves, tree_map_float, tree_zeros_like_f32)

__all__ = ["FusedLAMB", "fused_lamb", "LambState"]


class LambState(NamedTuple):
    step: torch.Tensor
    exp_avg: Any
    exp_avg_sq: Any


def fused_lamb(lr: ScheduleOrScalar = 1e-3,
               betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
               weight_decay: float = 0.01, bias_correction: bool = True,
               adam_w_mode: bool = True, grad_averaging: bool = True,
               max_grad_norm: float = 1.0, use_nvlamb: bool = False,
               norm_telemetry: bool = False) -> GradientTransformation:
    if norm_telemetry:
        raise NotImplementedError(
            "norm_telemetry comes with the distributed training slice of "
            "the port")
    beta1, beta2 = betas

    def init(params) -> LambState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return LambState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         exp_avg=tree_zeros_like_f32(params),
                         exp_avg_sq=tree_zeros_like_f32(params))

    def update(grads, state: LambState, params=None):
        if params is None:
            raise ValueError("fused_lamb requires params")
        step = state.step + 1
        lr_t = resolve_lr(lr, step)
        gnorm = global_norm(grads)
        if max_grad_norm is not None and max_grad_norm > 0:
            clip = torch.clamp(gnorm / max_grad_norm, min=1.0)
        else:
            clip = torch.ones((), dtype=torch.float32, device=step.device)
        beta3 = (1.0 - beta1) if grad_averaging else 1.0
        if bias_correction:
            t = step.float()
            bc1 = 1.0 - torch.pow(torch.full_like(t, beta1), t)
            bc2 = 1.0 - torch.pow(torch.full_like(t, beta2), t)
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32,
                                   device=step.device)

        def scaled_grad(g, p):
            sg = g.float() / clip
            if not adam_w_mode and weight_decay != 0.0:
                sg = sg + weight_decay * p.float()
            return sg

        m_tree = tree_map_float(
            lambda g, p, m: beta1 * m + beta3 * scaled_grad(g, p),
            grads, params, state.exp_avg)
        v_tree = tree_map_float(
            lambda g, p, v: beta2 * v
            + (1.0 - beta2) * torch.square(scaled_grad(g, p)),
            grads, params, state.exp_avg_sq)

        def upd_leaf(m, v, p):
            p32 = p.float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if adam_w_mode and weight_decay != 0.0:
                u = u + weight_decay * p32
            if weight_decay == 0.0 and not use_nvlamb:
                return -lr_t * u
            w_norm = torch.sqrt(torch.sum(torch.square(p32)))
            u_norm = torch.sqrt(torch.sum(torch.square(u)))
            ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                w_norm / u_norm, 1.0)
            return -lr_t * ratio * u

        updates = tree_map_float(upd_leaf, m_tree, v_tree, params)
        return updates, LambState(step, m_tree, v_tree)

    return GradientTransformation(init, update)


FusedLAMB = fused_lamb
