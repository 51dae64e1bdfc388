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
length works, and autograd runs the torch backward around it.
:func:`softmax_plan` chooses the kernel's variant from the row length,
the element size and the alignment: rows that fit in registers are read
once by a group of lanes, longer or unaligned rows take a looped kernel.
The JAX package's routing away from its Pallas kernel (broadcast masks,
sk > 512, differentiation) rested on TPU measurements and is not carried
over; the function computed is the same on every route.  For CPU
tensors, and under ``backend="reference"``, the forward is
:func:`_softmax_fwd_ref`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.amp.patch import unpatched
from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["scaled_softmax", "scaled_masked_softmax",
           "scaled_upper_triang_masked_softmax",
           "generic_scaled_masked_softmax", "softmax_fwd", "softmax_plan",
           "SoftmaxPlan", "kernel_attributes"]

_MASK_FILL = -10000.0

SOFTMAX_FWD = ku.register(ku.Kernel(
    "scaled_softmax_fwd", "softmax.cu", "apex_scaled_softmax_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
    + [ctypes.c_longlong] * 4 + [ctypes.c_float] + [ctypes.c_int] * 6,
    replaces="apex_tpu/ops/softmax.py:79"))

# how row 11 reads the mask (csrc/softmax.cu MaskMode): none, one vector
# load covering a step's elements, or element by element through the
# strides
MASK_NONE, MASK_VECTOR, MASK_STRIDED = 0, 1, 2
# 16-byte vectors a lane holds in the one-read kernel, at most
ROW_MAX_VECTORS = 8


class SoftmaxPlan(NamedTuple):
    """Row 11's launch: ``lanes`` > 0 is the one-read kernel, a group of
    ``lanes`` lanes per row holding ``vectors`` 16-byte vectors each;
    ``lanes`` == 0 the looped kernel (one warp per row) stepping ``vec``
    elements at a time.  ``vec`` is the elements of one step (16 bytes,
    or 1 when the row is not aligned); ``mask`` how the mask is read."""
    lanes: int
    vectors: int
    vec: int
    mask: int


def softmax_plan(sk: int, itemsize: int, x_ptr: int, y_ptr: int,
                 mask_ptr: Optional[int] = None,
                 mask_strides: Optional[tuple] = None) -> SoftmaxPlan:
    """The row 11 variant for rows of ``sk`` elements of ``itemsize``
    bytes at ``x_ptr``/``y_ptr``, and a mask (``None``, or its byte
    address and 4-D strides): a pure function of shape, element size and
    alignment.  Rows whose start is 16-byte aligned and that fit in
    ``ROW_MAX_VECTORS`` vectors a lane (1024 fp32 or 2048 16-bit values)
    are read once; a row of at most 16 vectors takes 8 or 16 lanes (two
    or four rows a warp).  The mask is read in vectors when its last
    stride is 1 and every row of it starts at a multiple of the step."""
    vec = 16 // itemsize
    aligned = sk % vec == 0 and x_ptr % 16 == 0 and y_ptr % 16 == 0
    step = vec if aligned else 1
    mode = MASK_NONE
    if mask_strides is not None:
        *lead, last = mask_strides
        mode = (MASK_VECTOR if last == 1 and all(
            s % step == 0 for s in [mask_ptr, *lead]) else MASK_STRIDED)
    nvec = sk // vec
    if not aligned or nvec > 32 * ROW_MAX_VECTORS:
        return SoftmaxPlan(0, 0, step, mode)
    if nvec <= 16:
        return SoftmaxPlan(8 if nvec <= 8 else 16, 1, vec, mode)
    vectors = 1
    while 32 * vectors < nvec:
        vectors *= 2
    return SoftmaxPlan(32, vectors, vec, mode)


def kernel_attributes(dtype: torch.dtype = torch.float32) -> dict:
    """What the CUDA runtime reports for row 11's instantiations of one
    element type (``{name: {"registers", "smem_bytes", "ctas_per_sm",
    "spill_bytes"}}``): the one-read kernel at every lane and vector
    count with a vector mask, and the looped kernel in vectors and one
    element at a time with a strided mask.  Needs the card."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    plans = {f"row {lanes}x{nv}": SoftmaxPlan(lanes, nv, vec, MASK_VECTOR)
             for lanes, nv in ((8, 1), (16, 1), (32, 1), (32, 2), (32, 4),
                               (32, 8))}
    plans["loop"] = SoftmaxPlan(0, 0, vec, MASK_STRIDED)
    plans["loop scalar"] = SoftmaxPlan(0, 0, 1, MASK_STRIDED)
    code = ku.dtype_code(torch.empty((), dtype=dtype))
    return {name: ku.hopper_attrs(SOFTMAX_FWD.source,
                                  "apex_scaled_softmax_attrs", code, *p)
            for name, p in plans.items()}


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
    plan = softmax_plan(sk, x.element_size(), x.data_ptr(), y.data_ptr(),
                        None if m is None else m.data_ptr(),
                        None if m is None else strides)
    SOFTMAX_FWD(x.device, ku.ptr(x), ku.ptr(m), ku.ptr(y), rows, sk, sq,
                d1, *strides, float(scale), int(causal), ku.dtype_code(x),
                *plan)
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


@unpatched
def scaled_softmax(x: torch.Tensor, scale: float = 1.0, *,
                   backend: Optional[str] = None) -> torch.Tensor:
    """softmax(x·scale) over the last axis (any length)."""
    return _scaled_softmax(x, None, scale, False, backend)


@unpatched
def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float = 1.0, *,
                          backend: Optional[str] = None) -> torch.Tensor:
    """softmax(fill(x·scale, mask, -10000)); ``mask`` bool, True = masked,
    broadcastable (typically ``[b, 1, sq, sk]`` or ``[b, 1, 1, sk]``
    against ``[b, n, sq, sk]``)."""
    if mask is None:
        return scaled_softmax(x, scale, backend=backend)
    return _scaled_softmax(x, mask, scale, False, backend)


@unpatched
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
