"""Automatic mixed precision of the port (``apex_tpu/amp``): opt-level
policies, dynamic loss scaling on the device, the AMP train step with
the O1/O4 per-op casts (``amp_patch_scope``), and the train-state
checkpoint hooks."""

from apex_tpu_torch.amp.policy import (  # noqa: F401
    O0, O1, O2, O3, O4, O5, Policy, opt_levels, policy_for_opt_level)
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    LossScaleConfig, LossScaleState, all_finite, init_loss_scale,
    record_scaler_step, scale_loss, unscale_grads, update_loss_scale)
from apex_tpu_torch.amp.frontend import (  # noqa: F401
    AmpState, TrainState, initialize, load_state_dict, make_train_step,
    restore_train_state, save_train_state, state_dict)
from apex_tpu_torch.amp.patch import amp_patch_scope  # noqa: F401
