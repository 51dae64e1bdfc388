"""Gradient-communication spec (``apex_tpu/comm/config.py``): wire dtype,
scaling blocks, error feedback, and bucket geometry.

Every entry point that moves gradients (``amp.frontend.make_train_step``,
``parallel.distributed``) takes a ``grad_comm=`` argument resolved
here: the strings ``"fp32"`` / ``"bf16"`` / ``"int8"`` pick a wire dtype
with defaults, a
:class:`GradCommConfig` sets everything explicitly, and ``None`` keeps
the legacy uncompressed behavior byte-for-byte.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from apex_tpu_torch.comm.quantize import WIRE_DTYPES

__all__ = ["GradCommConfig", "resolve"]


@dataclasses.dataclass(frozen=True)
class GradCommConfig:
    """How gradients travel over the data-parallel axis.

    Attributes:
      wire_dtype: ``"fp32"`` (no compression — plain psum/pmean),
        ``"bf16"`` (elementwise cast, 2 bytes/element, bitwise
        independent of bucket geometry), or ``"int8"`` (block-scaled
        symmetric int8, ~1 byte/element + ``4/block`` scale overhead).
      block: elements per fp32 scale block for ``"int8"`` (EQuARX-style
        per-block dynamic range).  256 keeps scale overhead under 2%.
      error_feedback: carry a per-leaf fp32 residual of the local
        quantization error into the next step so compression error
        cancels instead of accumulating (1-bit-Adam/EF-SGD residual
        trick).  ``None`` resolves to True for int8 and False
        otherwise; bf16's rounding error is small enough that the
        extra state rarely pays for itself.
      bucket_bytes: greedy bucket target in **raw fp32 bytes**
        (reference Reducer default ~16MB; 4MB here keeps several
        independent collectives in flight for the latency-hiding
        scheduler to overlap with backward).  Leaves larger than one
        bucket are split into bucket-sized chunks.
    """

    wire_dtype: str = "fp32"
    block: int = 256
    error_feedback: Optional[bool] = None
    bucket_bytes: int = 4 << 20

    def __post_init__(self):
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"wire_dtype {self.wire_dtype!r} not in {WIRE_DTYPES}")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")
        if self.bucket_bytes <= 0:
            raise ValueError(
                f"bucket_bytes must be positive, got {self.bucket_bytes}")

    @property
    def compresses(self) -> bool:
        """True when the wire dtype actually shrinks the payload."""
        return self.wire_dtype != "fp32"

    @property
    def use_error_feedback(self) -> bool:
        if self.error_feedback is None:
            return self.wire_dtype == "int8"
        return self.error_feedback and self.compresses


def resolve(
    spec: Union[None, str, GradCommConfig]
) -> Optional[GradCommConfig]:
    """``None`` | ``"fp32"``/``"bf16"``/``"int8"`` | config → config.

    ``None`` stays ``None`` so call sites can distinguish "not asked"
    (legacy path, no comm import at all) from an explicit fp32 spec.
    """
    if spec is None:
        return None
    if isinstance(spec, GradCommConfig):
        return spec
    if isinstance(spec, str):
        return GradCommConfig(wire_dtype=spec)
    raise TypeError(
        "grad_comm must be None, one of "
        f"{WIRE_DTYPES}, or a GradCommConfig; got {type(spec).__name__}")
