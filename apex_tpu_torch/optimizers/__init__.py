"""Optimizers of the port (``apex_tpu/optimizers``): FusedAdam, FusedLAMB
and the mixed-precision LAMB aliases so far."""

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
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    LambState,
    fused_lamb,
)
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (  # noqa: F401
    FusedMixedPrecisionLamb,
    fused_mixed_precision_lamb,
)
