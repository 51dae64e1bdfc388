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
layer).  On the card the update is the multi-tensor kernels: M2
(``multi_tensor_l2norm``) for the clip norm, then M4's two stages
(``multi_tensor.multi_tensor_lamb``); ``fused_apply`` is the AMP step's
tail in the same launches (the update applied to the masters, the
overflow select, the model-dtype copy).  ``norm_telemetry=True`` wraps
the transformation with ``_common.with_norm_telemetry``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.multi_tensor.multi_tensor_apply import multi_tensor_lamb
from apex_tpu_torch.optimizers._common import (
    GradientTransformation, ScheduleOrScalar, bias_corrections, float_leaves,
    global_norm, rebuild, tree_zeros_like_f32, with_norm_telemetry)
from apex_tpu_torch.optimizers.fused_adam import kernel_lr

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
    beta1, beta2 = betas
    hyper = dict(betas=(beta1, beta2),
                 beta3=(1.0 - beta1) if grad_averaging else 1.0, eps=eps,
                 weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                 use_ratio=weight_decay != 0.0 or use_nvlamb)

    def init(params) -> LambState:
        leaves = float_leaves(params)
        dev = leaves[0].device if leaves else None
        return LambState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         exp_avg=tree_zeros_like_f32(params),
                         exp_avg_sq=tree_zeros_like_f32(params))

    def run(grads, state: LambState, params, **kw):
        step = state.step + 1
        clip = None
        if max_grad_norm is not None and max_grad_norm > 0:
            gnorm = global_norm(grads, backend=kw.get("backend"))
            clip = torch.clamp(gnorm / max_grad_norm, min=1.0)
        bc1, bc2 = bias_corrections(step, beta1, beta2, bias_correction)
        out = multi_tensor_lamb(
            float_leaves(grads), float_leaves(params),
            float_leaves(state.exp_avg), float_leaves(state.exp_avg_sq),
            lr=kernel_lr(lr, step), bc1=bc1, bc2=bc2, clip=clip, **hyper,
            **kw)
        return step, out

    def update(grads, state: LambState, params=None):
        if params is None:
            raise ValueError("fused_lamb requires params")
        step, out = run(grads, state, params)
        return rebuild(params, out.params), LambState(
            step, rebuild(state.exp_avg, out.exp_avg),
            rebuild(state.exp_avg_sq, out.exp_avg_sq))

    def fused_apply(grads, state: LambState, params, *, overflow=None,
                    model_like=None, update_norm=False, backend=None):
        step, out = run(
            grads, state, params, apply=True, overflow=overflow,
            model_dtypes=(None if model_like is None else
                          [x.dtype for x in float_leaves(model_like)]),
            update_norm=update_norm, backend=backend)
        if overflow is not None:
            step = torch.where(overflow, state.step, step)
        new_state = LambState(step, rebuild(state.exp_avg, out.exp_avg),
                              rebuild(state.exp_avg_sq, out.exp_avg_sq))
        model = None if model_like is None else rebuild(model_like, out.model)
        return rebuild(params, out.params), new_state, model, out.update_sq

    tx = GradientTransformation(init, update, fused_apply)
    return with_norm_telemetry(tx) if norm_telemetry else tx


FusedLAMB = fused_lamb
