"""Automatic mixed precision of the port (``apex_tpu/amp``): opt-level
policies, dynamic loss scaling on the device, and the AMP train step."""

from apex_tpu_torch.amp.policy import (  # noqa: F401
    O0, O1, O2, O3, O4, O5, Policy, opt_levels, policy_for_opt_level)
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    LossScaleConfig, LossScaleState, all_finite, init_loss_scale,
    scale_loss, unscale_grads, update_loss_scale)
from apex_tpu_torch.amp.frontend import (  # noqa: F401
    AmpState, TrainState, initialize, make_train_step)
