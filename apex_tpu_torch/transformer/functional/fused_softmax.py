"""FusedScaleMaskSoftmax — the dispatching softmax module
(``apex_tpu/transformer/functional/fused_softmax.py``).

It routes on the mask type only: causal square inputs go to
``scaled_upper_triang_masked_softmax``, rectangular causal inputs to
``scaled_masked_softmax`` with an explicit end-aligned triangle, padding
masks to ``scaled_masked_softmax`` (or through ``mask_func`` first when
one is given), and no mask to ``scaled_softmax``.  Each of those runs
kernel row 11 on CUDA tensors (``ops/softmax.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops.softmax import (
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = ["FusedScaleMaskSoftmax"]


class FusedScaleMaskSoftmax:
    """Callable with the reference module's constructor surface:
    ``input_in_fp16``/``input_in_bf16`` (informational),
    ``attn_mask_type``, ``scaled_masked_softmax_fusion`` (kept; the
    kernel is always there), ``mask_func``, ``softmax_in_fp32`` and
    ``scale``."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = False,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        if not softmax_in_fp32 and scale is not None:
            raise ValueError("softmax should be in fp32 when scaled")
        self.attn_mask_type = attn_mask_type
        self.mask_func = mask_func
        self.scale = 1.0 if scale is None else float(scale)
        self.fusion = scaled_masked_softmax_fusion

    def __call__(self, x: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
        if self.attn_mask_type == AttnMaskType.causal:
            sq, sk = x.shape[-2], x.shape[-1]
            if sq == sk:
                return scaled_upper_triang_masked_softmax(x, self.scale)
            # rectangular causal (inference/kv-cache): an explicit mask
            row = torch.arange(sq, device=x.device)[:, None]
            col = torch.arange(sk, device=x.device)[None]
            return scaled_masked_softmax(x, col > row + (sk - sq),
                                         self.scale)
        if mask is not None and self.mask_func is not None:
            x = self.mask_func(x, mask)
            mask = None
        if mask is None:
            return scaled_softmax(x, self.scale)
        return scaled_masked_softmax(x, mask, self.scale)
