"""Fused bias + SwiGLU (``apex_tpu/ops/swiglu.py``).

Given ``y = x + bias`` split in two halves ``[y1 ‖ y2]``, ``out =
silu(y1) · y2``, in fp32 and rounded once to x's dtype.  Both forms are a
``torch.autograd.Function`` that saves its inputs (``x`` and ``bias``,
not the silu activations) and recomputes ``y`` in the backward, as the
JAX custom VJP does:

    dsilu(z) = sigmoid(z) · (1 + z · (1 − sigmoid(z)))
    dy1 = g · y2 · dsilu(y1);   dy2 = g · silu(y1);   dbias = Σ dy

The JAX package computes it as XLA elementwise ops (no Pallas kernel),
and so does the port: a torch composition on the CPU and on the card.
``dbias`` sums ``dy`` over the dimensions the bias broadcast across: for
the JAX package's 1-D bias the leading dimensions, and for a per-row
bias (the ragged MoE experts' ``[N, 2f]``) none, where the JAX backward
returns a ``[2f]`` cotangent for a ``[N, 2f]`` bias and the JAX step
raises.

:func:`mlp_gelu` is the MLP's other activation, kept beside swiglu so
that the dense MLP (``models/transformer_lm``) and the experts
(``transformer/moe``) take both from one place.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.amp.patch import unpatched

__all__ = ["fused_bias_swiglu", "fused_bias_swiglu_paired",
           "bias_swiglu_ref", "mlp_gelu"]


def mlp_gelu(activation: str, h):
    """gelu (``"gelu_tanh"``: the tanh form) in fp32 rounded to h's
    dtype: PyTorch's gelu computes a 16-bit input in fp32 and rounds
    once, forward and backward (the JAX package's fp32 round trip);
    under ``amp_patch_scope`` it takes fp32 in, as JAX's patched
    ``jax.nn.gelu`` does, and the cast keeps h's dtype."""
    return F.gelu(h, approximate="tanh" if activation == "gelu_tanh"
                  else "none").to(h.dtype)


def _silu(z):
    return z * torch.sigmoid(z)


def bias_swiglu_ref(x, bias=None):
    """Plain SwiGLU of ``x + bias`` over the (even) last dimension."""
    y = x.float()
    if bias is not None:
        y = y + bias.float()
    y1, y2 = y.chunk(2, dim=-1)
    return (_silu(y1) * y2).to(x.dtype)


def _grads(y1, y2, g):
    """(dy1, dy2) in fp32 from the fp32 halves and the output grad."""
    g32 = g.float()
    sig = torch.sigmoid(y1)
    dsilu = sig * (1.0 + y1 * (1.0 - sig))
    return g32 * y2 * dsilu, g32 * _silu(y1)


def _dbias(dy, bias):
    """Σ dy over the dimensions ``bias`` broadcast across, in the bias's
    dtype (the sum in fp32)."""
    if bias is None:
        return None
    lead = dy.ndim - bias.ndim
    dims = tuple(range(lead)) + tuple(
        lead + i for i, n in enumerate(bias.shape)
        if n == 1 and dy.shape[lead + i] != 1)
    out = dy.sum(dim=dims) if dims else dy
    return out.reshape(bias.shape).to(bias.dtype)


class _BiasSwiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return bias_swiglu_ref(x, bias)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        y = x.float()
        if bias is not None:
            y = y + bias.float()
        y1, y2 = y.chunk(2, dim=-1)
        dy = torch.cat(_grads(y1, y2, g), dim=-1)
        return dy.to(x.dtype), _dbias(dy, bias)


class _BiasSwigluPaired(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias):
        ctx.save_for_backward(y, bias)
        yf = y.float()
        if bias is not None:
            yf = yf + bias.float()
        return (_silu(yf[..., 0, :]) * yf[..., 1, :]).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        y, bias = ctx.saved_tensors
        yf = y.float()
        if bias is not None:
            yf = yf + bias.float()
        dy = torch.stack(_grads(yf[..., 0, :], yf[..., 1, :], g), dim=-2)
        return dy.to(y.dtype), _dbias(dy, bias)


@unpatched
def fused_bias_swiglu(x, bias: Optional[torch.Tensor] = None):
    """SwiGLU over the (even) last dimension of ``x + bias``,
    differentiable (module docstring)."""
    if x.shape[-1] % 2 != 0:
        raise ValueError("fused_bias_swiglu needs an even last dimension")
    return _BiasSwiglu.apply(x, bias)


@unpatched
def fused_bias_swiglu_paired(y, bias: Optional[torch.Tensor] = None):
    """SwiGLU on the paired layout ``[..., 2, f]``: gate at index 0, up at
    index 1 of the second-to-last dimension (the GPT MLP's ``[h, 2, f]``
    fc1)."""
    if y.ndim < 2 or y.shape[-2] != 2:
        raise ValueError("paired layout requires shape [..., 2, f]")
    return _BiasSwigluPaired.apply(y, bias)
