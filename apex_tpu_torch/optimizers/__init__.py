"""Optimizers of the port (``apex_tpu/optimizers``): FusedAdam so far."""

from apex_tpu_torch.optimizers._common import (  # noqa: F401
    GradientTransformation,
    apply_updates,
    global_norm,
)
from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    AdamState,
    FusedAdam,
    fused_adam,
)
