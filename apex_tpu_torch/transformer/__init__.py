"""Transformer building blocks of the port (``apex_tpu/transformer``):
the enums and ``functional.FusedScaleMaskSoftmax`` so far."""

from apex_tpu_torch.transformer import functional  # noqa: F401
from apex_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)
