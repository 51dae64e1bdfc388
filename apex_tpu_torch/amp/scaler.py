"""Dynamic loss scaling as device-side state (``apex_tpu/amp/scaler.py``).

Scale the loss before the backward, unscale and check the gradients for
inf/nan after, then update the scale: on overflow halve it and skip the
step; after ``scale_window`` clean steps double it.  The finite check,
the window bookkeeping and the skip decision are tensor arithmetic on
the device, so a train step never reads a value back to the host; "skip
the step" is a ``torch.where`` select between old and new state
(``amp/frontend.py``; on the card the optimizer's multi-tensor kernel
reads the skip flag itself).  The unscale and the finite check are one
``multi_tensor_scale`` launch (M1) over every gradient on the card.
:func:`record_scaler_step` is the host-side telemetry at the step
boundary.
"""

from __future__ import annotations

import logging
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from apex_tpu_torch.multi_tensor.multi_tensor_apply import (
    all_finite_flag, multi_tensor_scale)
from apex_tpu_torch.optimizers._common import float_leaves, rebuild
from apex_tpu_torch.utils.registry import resolve_device

__all__ = ["LossScaleConfig", "LossScaleState", "init_loss_scale",
           "all_finite", "scale_loss", "unscale_grads", "update_loss_scale",
           "record_scaler_step"]

_log = logging.getLogger("apex_tpu_torch.amp")


class LossScaleConfig(NamedTuple):
    """Static scaler configuration; defaults as the reference: init 2**16,
    factor 2, window 2000, max 2**24, no min."""

    dynamic: bool = True
    init_scale: float = 2.0 ** 16
    scale_factor: float = 2.0
    scale_window: int = 2000
    min_loss_scale: float = 0.0   # 0 → unbounded below
    max_loss_scale: float = 2.0 ** 24


class LossScaleState(NamedTuple):
    """Device-side scaler state."""

    loss_scale: torch.Tensor   # f32 scalar
    unskipped: torch.Tensor    # i32 scalar — clean steps since last change


def init_loss_scale(loss_scale: Union[str, float] = "dynamic", *,
                    device=None, **kwargs
                    ) -> Tuple[LossScaleConfig, LossScaleState]:
    """Build (config, state) on ``device`` (default ``cuda``).
    ``loss_scale`` is 'dynamic' or a static number."""
    dev = resolve_device(device)
    if loss_scale == "dynamic":
        cfg = LossScaleConfig(dynamic=True, **kwargs)
        init = min(cfg.max_loss_scale, cfg.init_scale)
    else:
        cfg = LossScaleConfig(dynamic=False, **kwargs)
        init = float(loss_scale)
    state = LossScaleState(
        loss_scale=torch.tensor(init, dtype=torch.float32, device=dev),
        unskipped=torch.tensor(0, dtype=torch.int32, device=dev))
    return cfg, state


def all_finite(tree: Any, *, backend: Optional[str] = None) -> torch.Tensor:
    """Device-side bool: every float leaf is finite (M1's flag, no output
    written, on the card)."""
    leaves = float_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return all_finite_flag(leaves, backend=backend) == 0


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    """``loss * loss_scale`` in fp32."""
    return loss.float() * state.loss_scale


def unscale_grads(grads: Any, state: LossScaleState, *,
                  divide_by: int = 1,
                  backend: Optional[str] = None) -> Tuple[Any, torch.Tensor]:
    """Grads times ``1/scale`` in fp32, and whether they were all finite
    (a device bool): one ``multi_tensor_scale`` (M1) over every float
    leaf, reading ``1/scale`` from device memory.  ``divide_by`` (the
    train step's ``accum_steps``) divides them in the same pass, by
    ``1/scale/divide_by`` as one device scalar."""
    leaves = float_leaves(grads)
    if not leaves:
        return grads, torch.ones((), dtype=torch.bool,
                                 device=state.loss_scale.device)
    inv = 1.0 / state.loss_scale
    if divide_by != 1:
        inv = inv / divide_by
    outs, flag = multi_tensor_scale(leaves, inv,
                                    out_dtypes=[torch.float32] * len(leaves),
                                    backend=backend)
    return rebuild(grads, outs), flag == 0


def update_loss_scale(cfg: LossScaleConfig, state: LossScaleState,
                      found_inf: torch.Tensor
                      ) -> Tuple[LossScaleState, torch.Tensor]:
    """Window-doubling update → ``(new_state, should_skip)``:
    overflow & dynamic: scale = max(min_scale, scale/factor), unskipped
    = 0, skip; clean: unskipped += 1 and at the window scale =
    min(max_scale, scale·factor), unskipped = 0.  A static scale never
    skips and never changes."""
    if not cfg.dynamic:
        return state, torch.zeros((), dtype=torch.bool,
                                  device=state.loss_scale.device)
    overflow = found_inf.bool()
    shrunk = state.loss_scale / cfg.scale_factor
    if cfg.min_loss_scale > 0.0:
        shrunk = torch.clamp(shrunk, min=cfg.min_loss_scale)
    unskipped_clean = state.unskipped + 1
    window_hit = unskipped_clean >= cfg.scale_window
    grown = torch.clamp(state.loss_scale * cfg.scale_factor,
                        max=cfg.max_loss_scale)
    new_scale = torch.where(overflow, shrunk,
                            torch.where(window_hit, grown, state.loss_scale))
    new_unskipped = torch.where(overflow | window_hit,
                                torch.zeros_like(state.unskipped),
                                unskipped_clean)
    return LossScaleState(new_scale, new_unskipped), overflow


def _host_value(x):
    return x.item() if torch.is_tensor(x) else x


def record_scaler_step(metrics) -> None:
    """Host-side AMP telemetry at the step boundary
    (``apex_tpu/amp/scaler.py:150``), from the metrics dict a train step
    returns (``loss_scale``, ``overflow``): the gauge
    ``amp.loss_scale``; the counters ``amp.overflow_count`` and
    ``amp.skipped_steps``; on every change of the scale (an overflow's
    halving or a window's doubling) the event ``amp.loss_scale_change``
    and an INFO line on the ``apex_tpu_torch.amp`` logger; and the
    scaler-thrash detector's feed where the registry has detectors.
    Nothing (one ``registry() is None`` check) when telemetry is off.
    Reading the metrics syncs with the device, as any per-step logging
    does."""
    from apex_tpu_torch.observability import metrics as _telemetry

    reg = _telemetry.registry()
    if reg is None:
        return
    # adopt this step's index first: a loop calls record_scaler_step
    # before record_step_metrics, and the amp.* records and the thrash
    # feed carry THIS step
    if "step" in metrics:
        try:
            reg.set_step(int(_host_value(metrics["step"])))
        except (TypeError, ValueError):
            pass
    scale = float(_host_value(metrics["loss_scale"]))
    overflow = bool(_host_value(metrics.get("overflow", False)))
    g = reg.gauge("amp.loss_scale")
    prev = g.value
    g.set(scale)
    bank = reg.detectors
    if bank is not None:
        bank.feed_scaler(reg.step, overflow)
    if overflow:
        reg.counter("amp.overflow_count").inc()
        reg.counter("amp.skipped_steps").inc()
    if prev is not None and prev != scale:
        reg.event("amp.loss_scale_change", old=prev, new=scale,
                  overflow=overflow)
        _log.info("loss scale %s -> %s%s", prev, scale,
                  " (gradient overflow: step skipped)" if overflow else
                  " (scale window reached)")
