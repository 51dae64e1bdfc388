"""FusedAdam — Adam/AdamW as a ``GradientTransformation``
(``apex_tpu/optimizers/fused_adam.py``).

- ``adam_w_mode=True`` → decoupled weight decay (AdamW); False → L2-style
  decay added to the gradient (classic Adam).
- ``bias_correction`` as in the reference.
- ``step`` is a device tensor and lr may be a schedule.
- ``amsgrad`` is rejected as in the reference.

The update runs as one multi-tensor kernel over every float leaf on the
card (M3, ``multi_tensor.multi_tensor_adam``; its plain version, the
per-leaf torch composition, on the CPU).  ``fused_apply`` is the AMP
step's tail in the same launch: the update applied to the masters, the
overflow select and the model-dtype copy.  ``use_flat_buffer=True``
routes ``update`` through ``ops.flat_adam`` (one flat buffer, the layout
of a ZeRO-sharded optimizer); ``norm_telemetry=True`` wraps the
transformation with ``_common.with_norm_telemetry``.  The JAX package's
deprecated ``use_pallas`` alias names a TPU kernel and is not ported.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.multi_tensor.multi_tensor_apply import multi_tensor_adam
from apex_tpu_torch.optimizers._common import (
    GradientTransformation, ScheduleOrScalar, bias_corrections, float_leaves,
    rebuild, resolve_lr, tree_zeros_like_f32, with_norm_telemetry)

__all__ = ["FusedAdam", "fused_adam", "AdamState"]


class AdamState(NamedTuple):
    step: torch.Tensor
    exp_avg: Any
    exp_avg_sq: Any


def kernel_lr(lr: ScheduleOrScalar, step: torch.Tensor):
    """lr as the kernels take it: a Python number as it is (no copy to the
    device), a schedule's or a tensor's value as a 0-d fp32 device
    tensor."""
    if isinstance(lr, (int, float)):
        return float(lr)
    return resolve_lr(lr, step)


def fused_adam(lr: ScheduleOrScalar = 1e-3,
               betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True, amsgrad: bool = False,
               use_flat_buffer: bool = False,
               norm_telemetry: bool = False) -> GradientTransformation:
    if amsgrad:
        raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
    beta1, beta2 = betas
    hyper = dict(betas=(beta1, beta2), eps=eps, weight_decay=weight_decay,
                 adam_w_mode=adam_w_mode)

    def init(params) -> AdamState:
        leaves = float_leaves(params)
        dev = leaves[0].device if leaves else None
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         exp_avg=tree_zeros_like_f32(params),
                         exp_avg_sq=tree_zeros_like_f32(params))

    def update(grads, state: AdamState, params=None):
        if params is None:
            raise ValueError("fused_adam requires params")
        step = state.step + 1
        lr_t = kernel_lr(lr, step)
        bc1, bc2 = bias_corrections(step, beta1, beta2, bias_correction)
        if use_flat_buffer:
            from apex_tpu_torch.ops.flat_adam import flat_adam_update

            updates, m, v = flat_adam_update(
                grads, params, state.exp_avg, state.exp_avg_sq, lr_t, beta1,
                beta2, eps, weight_decay, 1.0 if bc1 is None else bc1,
                1.0 if bc2 is None else bc2, adam_w_mode)
            return updates, AdamState(step, m, v)
        out = multi_tensor_adam(
            float_leaves(grads), float_leaves(params),
            float_leaves(state.exp_avg), float_leaves(state.exp_avg_sq),
            lr=lr_t, bc1=bc1, bc2=bc2, **hyper)
        return rebuild(params, out.params), AdamState(
            step, rebuild(state.exp_avg, out.exp_avg),
            rebuild(state.exp_avg_sq, out.exp_avg_sq))

    def fused_apply(grads, state: AdamState, params, *, overflow=None,
                    model_like=None, update_norm=False, backend=None):
        step = state.step + 1
        bc1, bc2 = bias_corrections(step, beta1, beta2, bias_correction)
        out = multi_tensor_adam(
            float_leaves(grads), float_leaves(params),
            float_leaves(state.exp_avg), float_leaves(state.exp_avg_sq),
            lr=kernel_lr(lr, step), bc1=bc1, bc2=bc2, apply=True,
            overflow=overflow,
            model_dtypes=(None if model_like is None else
                          [x.dtype for x in float_leaves(model_like)]),
            update_norm=update_norm, backend=backend, **hyper)
        if overflow is not None:
            step = torch.where(overflow, state.step, step)
        new_state = AdamState(step, rebuild(state.exp_avg, out.exp_avg),
                              rebuild(state.exp_avg_sq, out.exp_avg_sq))
        model = None if model_like is None else rebuild(model_like, out.model)
        return rebuild(params, out.params), new_state, model, out.update_sq

    tx = GradientTransformation(init, update, fused_apply)
    return with_norm_telemetry(tx) if norm_telemetry else tx


# Drop-in-named alias: `FusedAdam(lr=...)` reads like the reference ctor.
FusedAdam = fused_adam
