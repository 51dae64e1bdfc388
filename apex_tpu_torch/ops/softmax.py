"""Scaled (masked / causal / generic) softmax family
(``apex_tpu/ops/softmax.py``).

Semantics, as in the JAX package:

- the input is multiplied by ``scale`` *before* the mask and softmax;
- ``mask`` is boolean, True = masked, broadcastable against the input,
  and masked entries are filled with -10000.0 (not -inf);
- a fully masked row gives zeros (the reference kernels' scale_value=0);
- the causal variant requires square inputs (sq == sk);
- softmax math is fp32, the result has the input's dtype;
- the backward is ``(dy − Σ dy·y) · y · scale`` in fp32 from the saved
  y (:class:`_ScaledSoftmax`).

For CUDA tensors the forward is kernel row 11 (``csrc/softmax.cu``) on
every call: the mask is read through its broadcast strides, any row
length works, and autograd runs the torch backward around it.  The JAX
package's routing away from its Pallas kernel (broadcast masks, sk >
512, differentiation) rested on TPU measurements and is not carried
over; the function computed is the same on every route.  For CPU
tensors, and under ``backend="reference"``, the forward is
:func:`_softmax_fwd_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["scaled_softmax", "scaled_masked_softmax",
           "scaled_upper_triang_masked_softmax",
           "generic_scaled_masked_softmax", "softmax_fwd"]

_MASK_FILL = -10000.0

SOFTMAX_FWD = ku.register(ku.Kernel(
    "scaled_softmax_fwd", "softmax.cu", "apex_scaled_softmax_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
    + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_int],
    replaces="apex_tpu/ops/softmax.py:79"))


def _softmax_fwd_ref(x, scale, mask=None, causal=False):
    """The plain forward: fp32 scale, fill, softmax; zeros on fully
    masked rows; the result in x's dtype."""
    x32 = x.float() * scale
    if mask is not None:
        x32 = torch.where(mask.bool(), _MASK_FILL, x32)
    if causal:
        sq, sk = x.shape[-2], x.shape[-1]
        row = torch.arange(sq, device=x.device)[:, None]
        col = torch.arange(sk, device=x.device)[None]
        x32 = torch.where(col > row, _MASK_FILL, x32)
    y = torch.softmax(x32, dim=-1)
    if mask is not None or causal:
        all_masked = torch.amax(x32, dim=-1, keepdim=True) <= _MASK_FILL
        y = torch.where(all_masked, 0.0, y)
    return y.to(x.dtype)


def _mask_view(mask: torch.Tensor, shape) -> torch.Tensor:
    """The mask broadcast to ``shape`` and viewed 4-D ``[d0, d1, sq, sk]``
    (stride 0 along broadcast axes; copied only when more than two
    leading axes cannot be merged)."""
    m = mask.to(torch.bool).broadcast_to(shape)
    if m.ndim < 4:
        m = m.reshape((1,) * (4 - m.ndim) + tuple(shape))
    elif m.ndim > 4:
        m = m.reshape(-1, *shape[-3:])
    return m


def softmax_fwd(x, scale: float, mask=None, causal: bool = False):
    """Kernel row 11 on a CUDA tensor ``[..., sq, sk]`` → y like x."""
    if x.ndim < 2:
        raise ValueError(f"softmax input needs [..., sq, sk], got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    sq, sk = x.shape[-2], x.shape[-1]
    if causal and sq != sk:
        raise ValueError(f"causal softmax needs sq == sk, got {sq}x{sk}")
    m = None if mask is None else _mask_view(mask, x.shape)
    ku.check_cuda_operands("scaled softmax", x)
    if m is not None and m.device != x.device:
        raise ValueError(f"scaled softmax: mask on {m.device}, x on "
                         f"{x.device}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    rows = x.numel() // sk
    d1 = 1 if x.ndim < 3 else x.shape[-3]
    strides = (0, 0, 0, 0) if m is None else m.stride()
    SOFTMAX_FWD(x.device, ku.ptr(x), ku.ptr(m), ku.ptr(y), rows, sk, sq,
                d1, *strides, float(scale), int(causal), ku.dtype_code(x))
    return y


class _ScaledSoftmax(torch.autograd.Function):
    """Forward row 11 (or the plain version), saving y; backward in fp32
    (``softmax.py:195-200``).  The mask takes no gradient."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal, plain):
        fwd = _softmax_fwd_ref if plain else softmax_fwd
        y = fwd(x, scale, mask, causal)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        y32, dy32 = y.float(), dy.float()
        inner = dy32 - (dy32 * y32).sum(-1, keepdim=True)
        return (inner * y32 * ctx.scale).to(dy.dtype), None, None, None, None


def _scaled_softmax(x, mask, scale, causal, backend):
    plain = check_backend(backend) is not None or not on_cuda(x)
    return _ScaledSoftmax.apply(x, mask, float(scale), causal, plain)


def scaled_softmax(x: torch.Tensor, scale: float = 1.0, *,
                   backend: Optional[str] = None) -> torch.Tensor:
    """softmax(x·scale) over the last axis (any length)."""
    return _scaled_softmax(x, None, scale, False, backend)


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float = 1.0, *,
                          backend: Optional[str] = None) -> torch.Tensor:
    """softmax(fill(x·scale, mask, -10000)); ``mask`` bool, True = masked,
    broadcastable (typically ``[b, 1, sq, sk]`` or ``[b, 1, 1, sk]``
    against ``[b, n, sq, sk]``)."""
    if mask is None:
        return scaled_softmax(x, scale, backend=backend)
    return _scaled_softmax(x, mask, scale, False, backend)


def scaled_upper_triang_masked_softmax(x: torch.Tensor, scale: float = 1.0,
                                       *, backend: Optional[str] = None
                                       ) -> torch.Tensor:
    """Causal softmax (key c > query r masked); requires sq == sk."""
    if x.shape[-1] != x.shape[-2]:
        raise ValueError(
            "scaled_upper_triang_masked_softmax requires square inputs "
            f"(got {x.shape[-2]}x{x.shape[-1]}); use scaled_masked_softmax "
            "with an explicit mask for rectangular attention.")
    return _scaled_softmax(x, None, scale, True, backend)


def generic_scaled_masked_softmax(x: torch.Tensor,
                                  mask: Optional[torch.Tensor],
                                  scale: float = 1.0, *,
                                  backend: Optional[str] = None
                                  ) -> torch.Tensor:
    """Arbitrary-broadcast masked softmax (the reference's generic
    module): :func:`scaled_masked_softmax`."""
    return scaled_masked_softmax(x, mask, scale, backend=backend)
