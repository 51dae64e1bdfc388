"""Flash attention over BSND tensors, forward and backward
(``apex_tpu/ops/flash_attention.py``).

:func:`flash_attention` is a ``torch.autograd.Function`` that saves
``q, k, v, o`` and the forward's ``lse``.  For CUDA tensors the forward
is kernel K2 (``csrc/flash_attention.cu``: online softmax, causal, an
additive or boolean key-padding mask, grouped K/V) and the backward the
split pair K6 (dq) and K7 (dk/dv) of ``csrc/flash_attention_bwd.cu``,
after ``delta = rowsum(do·o)`` in fp32 (XLA in JAX, a torch op here).
For CPU tensors, and under ``backend="reference"``, the forward is
:func:`flash_attention_fwd_ref` (the materialized softmax of
:func:`mha_reference`, plus its lse) and the backward
:func:`flash_attention_bwd_ref` (``p = exp(s − lse)``,
``ds = p·(dp − delta)·scale``).

Not on the kernels: segment ids and attention dropout (they raise), and
a generic ``mask``/``bias``, which :func:`mha_reference` computes (and
autograd differentiates) on any device but a CUDA tensor refuses.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend, on_cuda

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_bwd_operands", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_attention_fwd_ref", "flash_attention_bwd_ref",
           "mha_reference"]

_NEG_INF = -1e30

FLASH_FWD = ku.register(ku.Kernel(
    "flash_attention_fwd", "flash_attention.cu", "apex_flash_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int],
    replaces="apex_tpu/ops/flash_attention.py:191"))

_BWD_ARGS = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]

FLASH_BWD_DQ = ku.register(ku.Kernel(
    "flash_attention_bwd_dq", "flash_attention_bwd.cu", "apex_flash_bwd_dq",
    [ctypes.c_void_p] * 8 + _BWD_ARGS,
    replaces="apex_tpu/ops/flash_attention.py:375"))

FLASH_BWD_DKV = ku.register(ku.Kernel(
    "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "apex_flash_bwd_dkv",
    [ctypes.c_void_p] * 9 + _BWD_ARGS,
    replaces="apex_tpu/ops/flash_attention.py:452"))


def _additive_kpm(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """bool (True = masked) → additive fp32 -1e30 / 0, as the JAX wrapper
    feeds its kernel."""
    if key_padding_mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=torch.float32,
                           device=key_padding_mask.device)
        return torch.where(key_padding_mask, _NEG_INF, zero)
    return key_padding_mask.float()


def _repeat_kv(q, k, v):
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def _scores(q, k, *, causal, key_padding_mask, mask, bias, scale):
    """Masked fp32 scores ``[b, n, sq, sk]`` (k already at q's heads)."""
    sq, sk = q.shape[1], k.shape[1]
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
    return s


def _fwd_plain(q, k, v, *, causal, key_padding_mask, mask, bias, scale):
    k, v = _repeat_kv(q, k, v)
    s = _scores(q, k, causal=causal, key_padding_mask=key_padding_mask,
                mask=mask, bias=bias, scale=scale)
    p = torch.softmax(s, dim=-1)
    any_open = torch.amax(s, dim=-1, keepdim=True) > _NEG_INF / 2
    p = torch.where(any_open, p, 0.0)
    o = torch.einsum("bnst,btnd->bsnd", p.to(v.dtype).float(), v.float())
    lse = torch.where(any_open, torch.logsumexp(s, dim=-1, keepdim=True),
                      _NEG_INF)
    return o.to(q.dtype), lse


def mha_reference(q, k, v, *, causal: bool = False, key_padding_mask=None,
                  mask=None, bias=None, scale: Optional[float] = None):
    """Materialized softmax(QK^T)V in fp32 with the kernel's masks and
    sentinels: grouped K/V broadcast up to the query heads, scores in
    fp32, fully masked rows give 0, probabilities rounded to V's dtype
    before the PV product."""
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    return _fwd_plain(q, k, v, causal=causal,
                      key_padding_mask=key_padding_mask, mask=mask,
                      bias=bias, scale=scale)[0]


def flash_attention_fwd_ref(q, k, v, *, causal: bool = False,
                            key_padding_mask=None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mha_reference` plus its lse ``[b·n, sq]`` fp32 (-1e30 on
    fully masked rows): the plain version of :func:`flash_attention_fwd`."""
    b, sq, n, d = q.shape
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    o, lse = _fwd_plain(q, k, v, causal=causal,
                        key_padding_mask=key_padding_mask, mask=None,
                        bias=None, scale=scale)
    return o, lse.reshape(b * n, sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = False,
                            key_padding_mask=None,
                            scale: Optional[float] = None):
    """Materialized backward from the saved lse, in fp32: ``p = exp(s −
    lse)`` (0 where masked or on -1e30 rows), ``ds = p·(dp − delta)·
    scale`` with ``delta = rowsum(do·o)``; grouped dk/dv summed over each
    group's heads.  Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    b, sq, n, d = q.shape
    g = k.shape[2]
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    kf, vf = _repeat_kv(q, k.float(), v.float())
    s = _scores(q, kf, causal=causal, key_padding_mask=key_padding_mask,
                mask=None, bias=None, scale=scale)
    lse4 = lse.reshape(b, n, sq, 1)
    open_ = (s > _NEG_INF / 2) & (lse4 > _NEG_INF / 2)
    p = torch.where(open_, torch.exp(s - lse4), 0.0)
    dof = do.float()
    dp = torch.einsum("bsnd,btnd->bnst", dof, vf)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bnst,btnd->bsnd", ds, kf)
    dk = torch.einsum("bnst,bsnd->btnd", ds, q.float())
    dv = torch.einsum("bnst,bsnd->btnd", p, dof)
    if g != n:
        sk = k.shape[1]
        dk = dk.reshape(b, sk, g, n // g, d).sum(3)
        dv = dv.reshape(b, sk, g, n // g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _kernel_operands(q, k, v, key_padding_mask, scale):
    """Checks shared by K2, K6 and K7; returns (kpm, scale)."""
    _check(q, k, v)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if d not in (32, 64, 128):
        raise ValueError(f"flash kernel head dim {d}: expected 32, 64 or 128")
    if k.dtype != q.dtype:
        raise TypeError(f"q is {q.dtype} but K/V are {k.dtype}")
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    kpm = (None if key_padding_mask is None
           else _additive_kpm(key_padding_mask).contiguous())
    if kpm is not None and kpm.shape != (b, sk):
        raise ValueError(f"key_padding_mask {tuple(kpm.shape)}, want "
                         f"{(b, sk)}")
    return kpm, scale


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        key_padding_mask=None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2 on CUDA tensors → ``(o [b, sq, n, d] in q's dtype,
    lse [b·n, sq] fp32)``; fully masked rows get o = 0, lse = -1e30."""
    kpm, scale = _kernel_operands(q, k, v, key_padding_mask, scale)
    b, sq, n, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ku.check_cuda_operands("flash_attention", q, k, v, kpm)
    ku.check_aligned("flash_attention", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(b * n, sq, dtype=torch.float32, device=q.device)
    FLASH_FWD(q.device, ku.ptr(q), ku.ptr(k), ku.ptr(v), ku.ptr(kpm),
              ku.ptr(o), ku.ptr(lse), b, sq, sk, n, g, d, scale,
              int(causal), ku.dtype_code(q))
    return o, lse


def flash_bwd_operands(q, k, v, o, lse, do, *, key_padding_mask=None,
                       scale: Optional[float] = None) -> dict:
    """Checked, contiguous operands of K6 and K7, with ``delta =
    rowsum(do·o)`` ``[b·n, sq]`` fp32 (XLA in JAX, a torch op here)."""
    kpm, scale = _kernel_operands(q, k, v, key_padding_mask, scale)
    b, sq, n, _ = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.to(q.dtype).contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        b * n, sq).contiguous()
    lse = lse.contiguous()
    ku.check_cuda_operands("flash_attention backward", q, k, v, do, lse,
                           delta, kpm)
    ku.check_aligned("flash_attention backward", q, k, v, do)
    if lse.shape != (b * n, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}, want "
                         f"{(b * n, sq)} float32")
    return dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, kpm=kpm,
                scale=scale)


def _bwd_tail(ops, causal):
    q, k = ops["q"], ops["k"]
    b, sq, n, d = q.shape
    return (b, sq, k.shape[1], n, k.shape[2], d, ops["scale"], int(causal),
            ku.dtype_code(q))


def flash_bwd_dq(ops: dict, *, causal: bool) -> torch.Tensor:
    """Kernel K6 on :func:`flash_bwd_operands` → dq like q."""
    dq = torch.empty_like(ops["q"])
    FLASH_BWD_DQ(dq.device, *(ku.ptr(ops[n]) for n in (
        "q", "k", "v", "do", "lse", "delta", "kpm")), ku.ptr(dq),
        *_bwd_tail(ops, causal))
    return dq


def flash_bwd_dkv(ops: dict, *, causal: bool):
    """Kernel K7 on :func:`flash_bwd_operands` → (dk, dv) like k, each
    group's query heads summed into its row."""
    dk, dv = torch.empty_like(ops["k"]), torch.empty_like(ops["v"])
    FLASH_BWD_DKV(dk.device, *(ku.ptr(ops[n]) for n in (
        "q", "k", "v", "do", "lse", "delta", "kpm")), ku.ptr(dk), ku.ptr(dv),
        *_bwd_tail(ops, causal))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        key_padding_mask=None,
                        scale: Optional[float] = None):
    """Kernels K6 (dq) and K7 (dk, dv) on CUDA tensors, from K2's ``o``
    and ``lse [b·n, sq]`` → ``(dq, dk, dv)`` in the inputs' dtypes."""
    ops = flash_bwd_operands(q, k, v, o, lse, do,
                             key_padding_mask=key_padding_mask, scale=scale)
    return (flash_bwd_dq(ops, causal=causal),
            *flash_bwd_dkv(ops, causal=causal))


class _Flash(torch.autograd.Function):
    """Attention saving ``(q, k, v, o, lse)``; the key-padding row is a
    constant (no gradient), as the JAX wrapper stop-gradients it."""

    @staticmethod
    def forward(ctx, q, k, v, kpm, causal, scale, plain):
        fwd = flash_attention_fwd_ref if plain else flash_attention_fwd
        o, lse = fwd(q, k, v, causal=causal, key_padding_mask=kpm,
                     scale=scale)
        ctx.save_for_backward(q, k, v, o, lse, kpm)
        ctx.causal, ctx.scale, ctx.plain = causal, scale, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kpm = ctx.saved_tensors
        bwd = flash_attention_bwd_ref if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=ctx.causal,
                         key_padding_mask=kpm, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    key_padding_mask=None, mask=None, bias=None,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    segment_ids=None, backend: Optional[str] = None
                    ) -> torch.Tensor:
    """Differentiable attention over ``[b, s, n, d]`` tensors;
    ``key_padding_mask`` ``[b, sk]`` is bool (True = masked) or additive
    float.  K/V may carry fewer heads than Q (GQA), read by index, never
    repeated."""
    _check(q, k, v)
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout (the in-kernel _keep_mask hash) is not "
            "ported yet")
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids (packed sequences) are not ported yet")
    plain = check_backend(backend) is not None or not on_cuda(q)
    if mask is not None or bias is not None:
        if not plain:
            raise NotImplementedError(
                "mask and bias are not on the CUDA flash kernels; call "
                "mha_reference for generic masks")
        return mha_reference(q, k, v, causal=causal,
                             key_padding_mask=key_padding_mask, mask=mask,
                             bias=bias, scale=scale)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else float(scale)
    kpm = (None if key_padding_mask is None
           else _additive_kpm(key_padding_mask))
    return _Flash.apply(q, k, v, kpm, causal, scale, plain)
