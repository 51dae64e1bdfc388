"""LayerNorm / RMSNorm forward (``apex_tpu/ops/layer_norm.py``).

Statistics and the affine epilogue run in fp32; the output takes the
input's dtype while the parameters may stay fp32 (the mixed-dtype
contract of the JAX package).  For CUDA tensors the forward is kernel K1
(``csrc/layer_norm.cu``); for CPU tensors it is :func:`layer_norm_ref` /
:func:`rms_norm_ref`, the same two-pass formula.  Forward only in this
slice: the backward kernel comes with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["fused_layer_norm", "fused_rms_norm", "layer_norm_ref",
           "rms_norm_ref", "layer_norm_fwd_stats"]

LN_FWD = ku.register(ku.Kernel(
    "layer_norm_fwd", "layer_norm.cu", "apex_layer_norm_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, ctypes.c_int],
    replaces="apex_tpu/ops/layer_norm.py:87"))


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


def layer_norm_ref(x, weight=None, bias=None, eps: float = 1e-5):
    """Plain LayerNorm: fp32 statistics and affine, output in x's dtype."""
    return _fwd_plain(x.reshape(-1, x.shape[-1]), weight, bias, eps,
                      False)[0].reshape(x.shape)


def rms_norm_ref(x, weight=None, eps: float = 1e-5):
    """Plain RMSNorm: ``x * rsqrt(mean(x^2) + eps) * weight``."""
    return _fwd_plain(x.reshape(-1, x.shape[-1]), weight, None, eps,
                      True)[0].reshape(x.shape)


def fused_layer_norm(x, weight=None, bias=None, eps: float = 1e-5, *,
                     backend: Optional[str] = None) -> torch.Tensor:
    """LayerNorm over the last dimension (affine when weight/bias given).
    CUDA tensors run kernel K1; CPU tensors and ``backend="reference"``
    run :func:`layer_norm_ref`."""
    if check_backend(backend) is None and on_cuda(x):
        return layer_norm_fwd_stats(x, weight, bias, eps)[0]
    return layer_norm_ref(x, weight, bias, eps)


def fused_rms_norm(x, weight=None, eps: float = 1e-5, *,
                   backend: Optional[str] = None) -> torch.Tensor:
    """RMSNorm over the last dimension; routed like
    :func:`fused_layer_norm`."""
    if check_backend(backend) is None and on_cuda(x):
        return layer_norm_fwd_stats(x, weight, None, eps, rms=True)[0]
    return rms_norm_ref(x, weight, eps)
