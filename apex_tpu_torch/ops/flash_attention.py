"""Flash attention forward over BSND tensors (``apex_tpu/ops/
flash_attention.py``).

For CUDA tensors :func:`flash_attention` runs kernel K2
(``csrc/flash_attention.cu``): online softmax, causal, an additive or
boolean key-padding mask, grouped K/V.  For CPU tensors, and under
``backend="reference"``, it runs :func:`mha_reference`, the materialized
softmax with the same masks and sentinels.

Not yet on the kernel (the training slice): segment ids, attention
dropout, generic ``mask``/``bias`` and the backward.  On a CUDA tensor
they raise; :func:`mha_reference` computes masks and biases on any
device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["flash_attention", "flash_attention_fwd", "mha_reference"]

_NEG_INF = -1e30

FLASH_FWD = ku.register(ku.Kernel(
    "flash_attention_fwd", "flash_attention.cu", "apex_flash_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int],
    replaces="apex_tpu/ops/flash_attention.py:191"))


def _additive_kpm(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """bool (True = masked) → additive fp32 -1e30 / 0, as the JAX wrapper
    feeds its kernel."""
    if key_padding_mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=torch.float32,
                           device=key_padding_mask.device)
        return torch.where(key_padding_mask, _NEG_INF, zero)
    return key_padding_mask.float()


def mha_reference(q, k, v, *, causal: bool = False, key_padding_mask=None,
                  mask=None, bias=None, scale: Optional[float] = None):
    """Materialized softmax(QK^T)V in fp32 with the kernel's masks and
    sentinels: grouped K/V broadcast up to the query heads, scores in
    fp32, fully masked rows give 0, probabilities rounded to V's dtype
    before the PV product."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    s = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = s.masked_fill(mask, _NEG_INF)
    if key_padding_mask is not None:
        if key_padding_mask.dtype == torch.bool:
            s = s.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
        else:
            s = s + key_padding_mask[:, None, None, :].float()
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None]
        s = s.masked_fill((col > row)[None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    any_open = torch.amax(s, dim=-1, keepdim=True) > _NEG_INF / 2
    p = torch.where(any_open, p, 0.0)
    o = torch.einsum("bnst,btnd->bsnd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _check(q, k, v):
    if q.ndim != 4:
        raise ValueError(f"expected [b, s, n, d], got {tuple(q.shape)}")
    if v.shape != k.shape:
        raise ValueError(
            f"K/V shapes differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"query heads ({q.shape[2]}) must be a multiple of the K/V "
            f"group count ({k.shape[2]})")


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        key_padding_mask=None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2 on CUDA tensors → ``(o [b, sq, n, d] in q's dtype,
    lse [b·n, sq] fp32)``; fully masked rows get o = 0, lse = -1e30."""
    _check(q, k, v)
    b, sq, n, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    if d not in (32, 64, 128):
        raise ValueError(f"flash kernel head dim {d}: expected 32, 64 or 128")
    if k.dtype != q.dtype:
        raise TypeError(f"q is {q.dtype} but K/V are {k.dtype}")
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    kpm = (None if key_padding_mask is None
           else _additive_kpm(key_padding_mask).contiguous())
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ku.check_cuda_operands("flash_attention", q, k, v, kpm)
    if kpm is not None and kpm.shape != (b, sk):
        raise ValueError(f"key_padding_mask {tuple(kpm.shape)}, want "
                         f"{(b, sk)}")
    ku.check_aligned("flash_attention", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(b * n, sq, dtype=torch.float32, device=q.device)
    FLASH_FWD(q.device, ku.ptr(q), ku.ptr(k), ku.ptr(v), ku.ptr(kpm),
              ku.ptr(o), ku.ptr(lse), b, sq, sk, n, g, d, scale,
              int(causal), ku.dtype_code(q))
    return o, lse


def flash_attention(q, k, v, *, causal: bool = False,
                    key_padding_mask=None, mask=None, bias=None,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    segment_ids=None, backend: Optional[str] = None
                    ) -> torch.Tensor:
    """Attention over ``[b, s, n, d]`` tensors; ``key_padding_mask``
    ``[b, sk]`` is bool (True = masked) or additive float.  K/V may
    carry fewer heads than Q (GQA), read by index, never repeated."""
    _check(q, k, v)
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout comes with the training slice of the port")
    if check_backend(backend) is None and on_cuda(q):
        if segment_ids is not None or mask is not None or bias is not None:
            raise NotImplementedError(
                "segment_ids, mask and bias are not on the CUDA flash "
                "kernel yet (training slice); call mha_reference for masks")
        return flash_attention_fwd(q, k, v, causal=causal,
                                   key_padding_mask=key_padding_mask,
                                   scale=scale)[0]
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids come with the training slice of the port")
    return mha_reference(q, k, v, causal=causal,
                         key_padding_mask=key_padding_mask, mask=mask,
                         bias=bias, scale=scale)
