"""LayerNorm / RMSNorm with their backward (``apex_tpu/ops/layer_norm.py``).

Statistics and the affine epilogue run in fp32; the output takes the
input's dtype while the parameters may stay fp32 or fp16 (the
mixed-dtype contract of the JAX package).  :func:`fused_layer_norm` and
:func:`fused_rms_norm` are a ``torch.autograd.Function`` that saves the
forward's ``mu`` and ``rstd``.  For CUDA tensors the forward is kernel K1
(``csrc/layer_norm.cu``) and the backward kernel K5
(``csrc/layer_norm_bwd.cu``); for CPU tensors, and under
``backend="reference"``, they are :func:`_fwd_plain` and
:func:`_bwd_plain`, the formulas of the JAX ``_norm_fwd`` / ``_norm_bwd``
XLA branches.  ``dγ``/``dβ`` come back in the parameters' dtype, as in
JAX.  ``memory_efficient=True`` (save y, rebuild x) is not ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["fused_layer_norm", "fused_rms_norm", "layer_norm_ref",
           "rms_norm_ref", "layer_norm_fwd_stats", "layer_norm_bwd"]

LN_FWD = ku.register(ku.Kernel(
    "layer_norm_fwd", "layer_norm.cu", "apex_layer_norm_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, ctypes.c_int],
    replaces="apex_tpu/ops/layer_norm.py:87"))

LN_BWD = ku.register(ku.Kernel(
    "layer_norm_bwd", "layer_norm_bwd.cu", "apex_layer_norm_bwd",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6,
    replaces="apex_tpu/ops/layer_norm.py:115"))

# rows per CTA of K5, one fp32 dγ/dβ partial row each
LN_BWD_ROWS_PER_BLOCK = 64


def _fwd_plain(x2, weight, bias, eps, rms):
    """Kernel K1's formula on ``[rows, hidden]``: fp32 mean, then the mean
    of squared deviations (RMS: no mean), affine in fp32, y in x's dtype."""
    x32 = x2.float()
    if rms:
        mu = torch.zeros(x32.shape[0], 1, dtype=torch.float32,
                         device=x2.device)
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    else:
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    rs = torch.rsqrt(var + eps)
    y = (x32 - mu) * rs
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2.dtype), mu[:, 0], rs[:, 0]


def _fwd_kernel(x2, weight, bias, eps, rms):
    rows, hidden = x2.shape
    w = None if weight is None else weight.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    ku.check_cuda_operands("layer_norm", x2, w, b)
    y = torch.empty_like(x2)
    mu = torch.empty(rows, dtype=torch.float32, device=x2.device)
    rs = torch.empty(rows, dtype=torch.float32, device=x2.device)
    LN_FWD(x2.device, ku.ptr(x2), ku.ptr(w), ku.ptr(b), ku.ptr(y),
           ku.ptr(mu), ku.ptr(rs), rows, hidden, float(eps), int(rms),
           ku.dtype_code(x2))
    return y, mu, rs


def _bwd_plain(dy2, x2, weight, mu, rs, rms, has_bias):
    """The JAX ``_norm_bwd`` XLA branch on ``[rows, hidden]``:
    ``(dx in x's dtype, dγ fp32 or None, dβ fp32 or None)``."""
    dy32 = dy2.float()
    xhat = (x2.float() - mu[:, None]) * rs[:, None]
    wdy = dy32 if weight is None else dy32 * weight.float()
    c2 = torch.mean(wdy * xhat, dim=-1, keepdim=True)
    if rms:
        dx = (wdy - xhat * c2) * rs[:, None]
    else:
        c1 = torch.mean(wdy, dim=-1, keepdim=True)
        dx = (wdy - c1 - xhat * c2) * rs[:, None]
    dw = None if weight is None else torch.sum(dy32 * xhat, dim=0)
    db = torch.sum(dy32, dim=0) if has_bias else None
    return dx.to(x2.dtype), dw, db


def _bwd_kernel(dy2, x2, weight, mu, rs, rms, has_bias):
    if weight is None and has_bias:
        raise NotImplementedError(
            "K5 takes a bias only beside a scale (as the TPU kernel does)")
    rows, hidden = x2.shape
    dy2 = dy2.to(x2.dtype).contiguous()
    w = None if weight is None else weight.float().contiguous()
    ku.check_cuda_operands("layer_norm backward", dy2, x2, w, mu, rs)
    dx = torch.empty_like(x2)
    part = dwdb = None
    if w is not None:
        nblk = -(-rows // LN_BWD_ROWS_PER_BLOCK)
        nout = 2 if has_bias else 1
        part = torch.empty(nout, nblk, hidden, dtype=torch.float32,
                           device=x2.device)
        dwdb = torch.empty(nout, hidden, dtype=torch.float32,
                           device=x2.device)
    LN_BWD(x2.device, ku.ptr(dy2), ku.ptr(x2), ku.ptr(w), ku.ptr(mu),
           ku.ptr(rs), ku.ptr(dx), ku.ptr(part), ku.ptr(dwdb), rows, hidden,
           LN_BWD_ROWS_PER_BLOCK, int(rms), int(has_bias),
           ku.dtype_code(x2))
    dw = None if w is None else dwdb[0]
    db = dwdb[1] if has_bias else None
    return dx, dw, db


def layer_norm_fwd_stats(x, weight=None, bias=None, eps: float = 1e-5, *,
                         rms: bool = False, backend: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The kernel's full output: ``(y, mu, rstd)`` with ``y`` shaped like
    ``x`` and the fp32 statistics flattened to ``[rows]``."""
    check_backend(backend)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if on_cuda(x) and backend is None:
        y, mu, rs = _fwd_kernel(x2.contiguous(), weight, bias, eps, rms)
    else:
        y, mu, rs = _fwd_plain(x2, weight, bias, eps, rms)
    return y.reshape(shape), mu, rs


def layer_norm_bwd(dy, x, weight, mu, rs, *, rms: bool = False,
                   has_bias: bool = True, backend: Optional[str] = None):
    """Gradients of the norm from the forward's fp32 ``mu``/``rstd``
    ``[rows]``: ``(dx like x, dγ fp32 [hidden] or None, dβ fp32 or
    None)``.  Kernel K5 for CUDA tensors, :func:`_bwd_plain` otherwise."""
    check_backend(backend)
    x2 = x.reshape(-1, x.shape[-1])
    dy2 = dy.reshape(x2.shape)
    if on_cuda(x) and backend is None:
        dx, dw, db = _bwd_kernel(dy2, x2.contiguous(), weight, mu, rs, rms,
                                 has_bias)
    else:
        dx, dw, db = _bwd_plain(dy2, x2, weight, mu, rs, rms, has_bias)
    return dx.reshape(x.shape), dw, db


class _Norm(torch.autograd.Function):
    """``y = norm(x) * γ + β`` saving ``(x, γ, β, mu, rstd)``; the
    backward returns ``dγ``/``dβ`` cast to the parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, rms, backend):
        y, mu, rs = layer_norm_fwd_stats(x, weight, bias, eps, rms=rms,
                                         backend=backend)
        ctx.save_for_backward(x, weight, bias, mu, rs)
        ctx.rms, ctx.backend = rms, backend
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mu, rs = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(dy, x, weight, mu, rs, rms=ctx.rms,
                                    has_bias=bias is not None,
                                    backend=ctx.backend)
        dw = None if dw is None else dw.to(weight.dtype)
        db = None if db is None else db.to(bias.dtype)
        return dx, dw, db, None, None, None


def _no_memory_efficient(memory_efficient: bool) -> None:
    if memory_efficient:
        raise NotImplementedError(
            "memory_efficient=True (save the output, rebuild x in the "
            "backward) is not ported yet")


def layer_norm_ref(x, weight=None, bias=None, eps: float = 1e-5):
    """Plain LayerNorm: fp32 statistics and affine, output in x's dtype."""
    return _fwd_plain(x.reshape(-1, x.shape[-1]), weight, bias, eps,
                      False)[0].reshape(x.shape)


def rms_norm_ref(x, weight=None, eps: float = 1e-5):
    """Plain RMSNorm: ``x * rsqrt(mean(x^2) + eps) * weight``."""
    return _fwd_plain(x.reshape(-1, x.shape[-1]), weight, None, eps,
                      True)[0].reshape(x.shape)


def fused_layer_norm(x, weight=None, bias=None, eps: float = 1e-5,
                     memory_efficient: bool = False, *,
                     backend: Optional[str] = None) -> torch.Tensor:
    """LayerNorm over the last dimension (affine when weight/bias given),
    differentiable.  CUDA tensors run kernels K1 and K5; CPU tensors and
    ``backend="reference"`` run the plain formulas."""
    _no_memory_efficient(memory_efficient)
    return _Norm.apply(x, weight, bias, float(eps), False,
                       check_backend(backend))


def fused_rms_norm(x, weight=None, eps: float = 1e-5,
                   memory_efficient: bool = False, *,
                   backend: Optional[str] = None) -> torch.Tensor:
    """RMSNorm over the last dimension; routed like
    :func:`fused_layer_norm`."""
    _no_memory_efficient(memory_efficient)
    return _Norm.apply(x, weight, None, float(eps), True,
                       check_backend(backend))
