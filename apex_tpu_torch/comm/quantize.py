"""Block-scaled wire-format quantization (``apex_tpu/comm/quantize.py``),
the codec half: pure elementwise and blockwise math over the last axis,
bit for bit the JAX package's.

Wire formats:

- ``"int8"`` — symmetric round-half-to-even int8 in [-127, 127] with one
  fp32 scale per ``block`` elements (``scale = max|x| / 127``; an
  all-zero block gets scale 1, so it dequantizes exactly); a last axis
  that ``block`` does not divide is zero-padded to a multiple of it;
- ``"bf16"`` — an elementwise cast, no scales;
- ``"fp32"`` — the input as it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["WIRE_DTYPES", "quantize_blocks", "dequantize_blocks",
           "wire_itemsize"]

WIRE_DTYPES = ("fp32", "bf16", "int8")

_INT8_MAX = 127.0


def wire_itemsize(wire_dtype: str) -> int:
    """Bytes per element on the wire for ``wire_dtype``."""
    return {"fp32": 4, "bf16": 2, "int8": 1}[wire_dtype]


def _pad_last(x: torch.Tensor, multiple: int) -> torch.Tensor:
    rem = x.shape[-1] % multiple
    return x if rem == 0 else F.pad(x, (0, multiple - rem))


def quantize_blocks(x: torch.Tensor, wire_dtype: str, block: int
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantize ``x`` over its last axis → ``(wire, scales)``: int8 with
    the last axis zero-padded to a multiple of ``block`` and fp32 scales
    ``[..., ceil(n / block)]``; bf16 and fp32 without scales."""
    if wire_dtype == "fp32":
        return x, None
    if wire_dtype == "bf16":
        return x.to(torch.bfloat16), None
    if wire_dtype != "int8":
        raise ValueError(f"unknown wire dtype {wire_dtype!r}; expected one "
                         f"of {WIRE_DTYPES}")
    xp = _pad_last(x.float(), block)
    blocks = xp.reshape(xp.shape[:-1] + (-1, block))
    amax = blocks.abs().amax(-1)
    # amax == 0 (not amax > 0): a NaN block keeps a NaN scale
    scales = torch.where(amax == 0, torch.ones_like(amax), amax / _INT8_MAX)
    q = torch.round(blocks / scales[..., None])
    wire = q.clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8)
    return wire.reshape(xp.shape), scales


def dequantize_blocks(wire: torch.Tensor, scales: Optional[torch.Tensor],
                      block: int, length: int) -> torch.Tensor:
    """Invert :func:`quantize_blocks` to fp32, truncating the last axis to
    ``length``."""
    if scales is None:
        return wire.float()[..., :length]
    blocks = wire.float().reshape(wire.shape[:-1] + (-1, block))
    return (blocks * scales[..., None]).reshape(wire.shape)[..., :length]
