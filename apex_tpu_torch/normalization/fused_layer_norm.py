"""``FusedLayerNorm`` / ``FusedRMSNorm`` as ``torch.nn.Module``s
(``apex_tpu/normalization/fused_layer_norm.py``, flax modules there).

The parameters are fp32 whatever the activations' dtype (the reference's
``Mixed*`` contract, so the ``Mixed*`` names are aliases) and carry the
flax modules' names, ``scale`` and ``bias``: ``module.load_state_dict(
models.convert.params_from_numpy(variables["params"], device=...))``
takes a flax module's variables as they are.  The forward is
``ops/layer_norm.fused_layer_norm`` / ``fused_rms_norm`` (kernels K1 and
K5 on the card), ``memory_efficient=True`` saving the output instead of
the input.  The parameters live on ``device`` (default ``cuda``; pass
``device="cpu"`` on the CPU).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from apex_tpu_torch.ops.layer_norm import fused_layer_norm, fused_rms_norm
from apex_tpu_torch.utils.registry import check_backend, resolve_device

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm"]


def _last_dim(shape: Union[int, Sequence[int]]) -> int:
    if isinstance(shape, int):
        return shape
    if len(shape) != 1:
        raise NotImplementedError(
            "the norms normalize over the last dimension; pass "
            "normalized_shape as an int (a multi-dimensional shape maps to "
            "flattening those dimensions first)")
    return int(shape[0])


class _FusedNorm(torch.nn.Module):
    rms = False

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 memory_efficient: bool = False, *, device=None,
                 backend: Optional[str] = None):
        super().__init__()
        self.hidden = _last_dim(normalized_shape)
        self.eps = float(eps)
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        self.backend = check_backend(backend)
        dev = resolve_device(device)
        if elementwise_affine:
            self.scale = torch.nn.Parameter(
                torch.ones(self.hidden, dtype=torch.float32, device=dev))
            if not self.rms:
                self.bias = torch.nn.Parameter(
                    torch.zeros(self.hidden, dtype=torch.float32,
                                device=dev))
        else:
            self.scale = None
        if self.rms or not elementwise_affine:
            self.bias = None

    def _check(self, x) -> None:
        if x.shape[-1] != self.hidden:
            raise ValueError(f"input last dim {x.shape[-1]} != "
                             f"normalized_shape {self.hidden}")

    def extra_repr(self) -> str:
        return (f"{self.hidden}, eps={self.eps}, elementwise_affine="
                f"{self.elementwise_affine}, memory_efficient="
                f"{self.memory_efficient}")


class FusedLayerNorm(_FusedNorm):
    """Drop-in for the reference ``apex.normalization.FusedLayerNorm``."""

    def forward(self, x):
        self._check(x)
        return fused_layer_norm(x, self.scale, self.bias, self.eps,
                                self.memory_efficient, backend=self.backend)


class FusedRMSNorm(_FusedNorm):
    """Drop-in for the reference ``apex.normalization.FusedRMSNorm``."""

    rms = True

    def forward(self, x):
        self._check(x)
        return fused_rms_norm(x, self.scale, self.eps, self.memory_efficient,
                              backend=self.backend)


# the parameters are fp32 whatever the activations, which is what the
# reference's Mixed* variants add
MixedFusedLayerNorm = FusedLayerNorm
MixedFusedRMSNorm = FusedRMSNorm
