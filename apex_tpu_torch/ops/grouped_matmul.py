"""Grouped (segment) matmul (``apex_tpu/ops/grouped_matmul.py``, the float
forward): ``out[r] = x[r] @ w[g]`` for rows ``r`` in group ``g``'s span
``[offsets[g], offsets[g+1])`` of ``x`` sorted by group.

Rows outside ``[offsets[0], offsets[-1])`` come back exactly zero: the
LoRA path (``models/lora.py``) packs its no-adapter rows before
``offsets[0]``, where their delta is 0 without a zero-weight group.

For CUDA tensors it is one launch of kernel row 9
(``csrc/grouped_matmul.cu``): rows split into segments by the offsets,
which the kernel reads on the device (no host read, so the launch can
sit in a CUDA graph), each segment into tiles of 16 rows of one group;
fp32 FMA on the CUDA cores, the contraction split across CTAs with a
fixed-order second pass when the tiles are few.  For CPU tensors, and
under ``backend="reference"``, it is :func:`grouped_matmul_reference`:
one masked fp32 product per group, the JAX reference route.

Not ported here: the gradient (``_gmm_bwd``, the MoE training slice) and
the int8-slab branch (``grouped_matmul_quantized``, the MoE slice).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["group_ids", "grouped_matmul", "grouped_matmul_reference"]

GROUPED_MATMUL = ku.register(ku.Kernel(
    "grouped_matmul", "grouped_matmul.cu", "apex_grouped_matmul",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6,
    replaces="apex_tpu/ops/grouped_matmul.py:113"))

# csrc/grouped_matmul.cu's tile rows, contraction chunk and CTA width,
# and the H100's SM count
_BM, _KC, _THREADS, _SMS = 16, 256, 256, 132


def group_ids(offsets: torch.Tensor, n_rows: int, n_groups: int):
    """Group index per row: ``[n_rows]`` int32 in ``[0, n_groups]``; rows
    outside the ``[offsets[0], offsets[-1])`` window get ``n_groups``."""
    off = offsets.to(torch.int32)
    r = torch.arange(n_rows, dtype=torch.int32, device=off.device)
    g = torch.searchsorted(off, r, right=True).to(torch.int32) - 1
    valid = (r >= off[0]) & (r < off[-1])
    return torch.where(valid, g.clamp(0, n_groups - 1),
                       torch.full_like(g, n_groups))


def _check(x, w, offsets):
    if x.ndim != 2 or w.ndim != 3 or offsets.ndim != 1:
        raise ValueError(
            f"grouped_matmul: expected x [N, k], w [G, k, p], offsets "
            f"[G+1]; got {tuple(x.shape)}, {tuple(w.shape)}, "
            f"{tuple(offsets.shape)}")
    if w.shape[0] + 1 != offsets.shape[0]:
        raise ValueError(
            f"grouped_matmul: offsets length {offsets.shape[0]} != "
            f"G + 1 = {w.shape[0] + 1}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(
            f"grouped_matmul: contraction mismatch — x [..., {x.shape[1]}]"
            f" vs w [., {w.shape[1]}, .]")


def grouped_matmul_reference(x, w, offsets):
    """Plain version of kernel row 9: one masked fp32 product per group,
    zero outside every span, in ``promote_types(x, w)``."""
    _check(x, w, offsets)
    n = x.shape[0]
    off = offsets.to(torch.int32)
    rows = torch.arange(n, dtype=torch.int32, device=x.device)
    xf = x.float()
    out = torch.zeros(n, w.shape[-1], dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(w.shape[0]):
        mask = ((rows >= off[g]) & (rows < off[g + 1]))[:, None]
        xg = torch.where(mask, xf, zero)
        out = out + torch.where(mask, xg @ w[g].float(), zero)
    return out.to(torch.promote_types(x.dtype, w.dtype))


def _column_tile(p: int) -> int:
    bn = 1
    while bn < p and bn < _THREADS:
        bn *= 2
    return bn


def _splits(n: int, k: int, p: int, g: int) -> int:
    """Contraction splits: whole 256-wide chunks, enough for ~2 CTAs per
    SM when the tile grid is small (the LoRA A side at decode)."""
    chunks = -(-k // _KC)
    ctas = (-(-n // _BM) + g + 2) * -(-p // _column_tile(p))
    if chunks <= 1 or ctas >= _SMS:
        return 1
    return min(chunks, -(-2 * _SMS // ctas))


def _gmm_kernel(x, w, offsets, splits: Optional[int] = None):
    dtype = torch.promote_types(x.dtype, w.dtype)
    x = x.to(dtype).contiguous()
    w = w.to(dtype).contiguous()
    off = offsets.to(torch.int32).contiguous()
    ku.check_cuda_operands("grouped_matmul", x, w, off)
    n, k = x.shape
    g, _, p = w.shape
    out = torch.empty(n, p, dtype=dtype, device=x.device)
    if splits is None:
        splits = _splits(n, k, p, g)
    partial = (None if splits == 1 else
               torch.empty(splits, n, p, dtype=torch.float32,
                           device=x.device))
    GROUPED_MATMUL(x.device, ku.ptr(x), ku.ptr(w), ku.ptr(off), ku.ptr(out),
                   ku.ptr(partial), n, k, p, g, splits, ku.dtype_code(x))
    return out


def grouped_matmul(x, w, offsets, *, backend: Optional[str] = None):
    """``out[r] = x[r] @ w[g]`` for rows ``r`` in group ``g``'s span
    ``[offsets[g], offsets[g+1])``; rows outside every span (including
    outside a window: ``offsets[0] > 0`` or ``offsets[-1] < N``) come back
    exactly zero.

    ``x`` ``[N, k]`` sorted by group, ``w`` ``[G, k, p]``, ``offsets``
    ``[G+1]`` non-decreasing integers on ``x``'s device.  fp32
    accumulation, output in ``promote_types(x, w)``.  ``backend=
    "reference"`` pins the plain version."""
    _check(x, w, offsets)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "grouped_matmul's gradient (_gmm_bwd) comes with the MoE "
            "training slice of the port; call it under torch.no_grad()")
    if x.shape[0] == 0 or w.shape[-1] == 0:
        return torch.zeros(x.shape[0], w.shape[-1], device=x.device,
                           dtype=torch.promote_types(x.dtype, w.dtype))
    if check_backend(backend) == "reference" or not on_cuda(x):
        return grouped_matmul_reference(x, w, offsets)
    return _gmm_kernel(x, w, offsets)
