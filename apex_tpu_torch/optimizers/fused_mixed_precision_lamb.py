"""FusedMixedPrecisionLamb (``apex_tpu/optimizers/
fused_mixed_precision_lamb.py``): name-parity aliases of
:func:`~apex_tpu_torch.optimizers.fused_lamb.fused_lamb`.  The fp32
master weights are the AMP train step's (``amp.make_train_step`` keeps
them and re-casts the model parameters each step), so the optimizer is
LAMB over those masters."""

from apex_tpu_torch.optimizers.fused_lamb import fused_lamb

__all__ = ["FusedMixedPrecisionLamb", "fused_mixed_precision_lamb"]

fused_mixed_precision_lamb = fused_lamb
FusedMixedPrecisionLamb = fused_lamb
