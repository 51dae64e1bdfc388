"""Dynamic loss scaling as device-side state (``apex_tpu/amp/scaler.py``).

Scale the loss before the backward, unscale and check the gradients for
inf/nan after, then update the scale: on overflow halve it and skip the
step; after ``scale_window`` clean steps double it.  The finite check,
the window bookkeeping and the skip decision are tensor arithmetic on
the device, so a train step never reads a value back to the host; "skip
the step" is a ``torch.where`` select between old and new state
(``amp/frontend.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple, Union

import torch

from apex_tpu_torch.optimizers._common import tree_leaves, tree_map
from apex_tpu_torch.utils.registry import resolve_device

__all__ = ["LossScaleConfig", "LossScaleState", "init_loss_scale",
           "all_finite", "scale_loss", "unscale_grads", "update_loss_scale"]


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


def all_finite(tree: Any) -> torch.Tensor:
    """Device-side bool: every float leaf is finite."""
    leaves = [x for x in tree_leaves(tree)
              if torch.is_tensor(x) and x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    """``loss * loss_scale`` in fp32."""
    return loss.float() * state.loss_scale


def unscale_grads(grads: Any, state: LossScaleState
                  ) -> Tuple[Any, torch.Tensor]:
    """Grads times ``1/scale`` in fp32, and whether they were all finite."""
    inv = 1.0 / state.loss_scale
    finite = all_finite(grads)
    unscaled = tree_map(
        lambda g: g.float() * inv
        if torch.is_tensor(g) and g.is_floating_point() else g, grads)
    return unscaled, finite


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
