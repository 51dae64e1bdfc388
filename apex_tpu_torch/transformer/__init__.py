"""Transformer building blocks of the port (``apex_tpu/transformer``):
the enums, ``functional.FusedScaleMaskSoftmax`` and the single-device
MoE FFN (``moe.switch_moe_mlp``)."""

from apex_tpu_torch.transformer import functional  # noqa: F401
from apex_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)
from apex_tpu_torch.transformer.moe import (  # noqa: F401
    MOE_ROUTINGS,
    MoEOutput,
    init_moe_params,
    switch_moe_mlp,
)
