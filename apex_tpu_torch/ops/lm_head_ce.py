"""Fused LM-head matmul + softmax cross-entropy, chunked over tokens
(``apex_tpu/ops/lm_head_ce.py``).

The forward computes each chunk's logits ``hidden_c @ head^T`` (fp32
products and sums), reduces them to the per-token loss and lse, and
drops the chunk; the backward recomputes each chunk's logits from the
saved lse and contracts ``dlogits`` (in the hidden dtype) into
``dhidden`` and an fp32 ``dhead`` accumulator.  The ``[tokens, vocab]``
logits never exist whole: at b16 × s1024 × v50304 they would be 3.3 GB
in fp32; a 2048-token chunk is 412 MB.  The JAX package writes these
matmuls as XLA einsums, so they are ``torch`` matmuls here, not a
kernel.  Same per-row semantics as :mod:`apex_tpu_torch.ops.xentropy`.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["lm_head_cross_entropy", "matmul_f32"]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 products, sums and result (the JAX einsum's
    ``preferred_element_type=float32``): one cuBLAS call with an fp32
    output for 16-bit CUDA operands, an fp32 product otherwise."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b.to(a.dtype), out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_math(hc, head, lc, smoothing):
    """One chunk's fp32 logits, per-token loss and lse."""
    logits = matmul_f32(hc, head.t())
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, lc[:, None])[:, 0]
    loss = (lse - picked) * (1.0 - smoothing)
    if smoothing:
        loss = loss + (lse - logits.mean(-1)) * smoothing
    return logits, loss, lse


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, head, labels, smoothing, chunk):
        head_f = head.to(hidden.dtype)
        losses, lses = [], []
        for i in range(0, hidden.shape[0], chunk):
            _, loss, lse = _chunk_math(hidden[i:i + chunk], head_f,
                                       labels[i:i + chunk], smoothing)
            losses.append(loss)
            lses.append(lse)
        lses = torch.cat(lses)
        ctx.save_for_backward(hidden, head, labels, lses)
        ctx.smoothing, ctx.chunk = smoothing, chunk
        return torch.cat(losses)

    @staticmethod
    def backward(ctx, g):
        hidden, head, labels, lses = ctx.saved_tensors
        smoothing, chunk = ctx.smoothing, ctx.chunk
        v = head.shape[0]
        head_f = head.to(hidden.dtype)
        g = g.float()
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=head.device)
        dhs = []
        for i in range(0, hidden.shape[0], chunk):
            hc, lc = hidden[i:i + chunk], labels[i:i + chunk]
            # in place on the chunk's fresh fp32 logits: each pass over
            # [chunk, vocab] costs as much as the chunk's matmul
            dlogits = matmul_f32(hc, head_f.t())
            dlogits.sub_(lses[i:i + chunk, None]).exp_()
            if smoothing:
                dlogits -= smoothing / v
            rows = torch.arange(hc.shape[0], device=hc.device)
            dlogits[rows, lc] -= 1.0 - smoothing
            dlogits = dlogits.mul_(g[i:i + chunk, None]).to(hc.dtype)
            dhs.append(matmul_f32(dlogits, head_f))
            dhead += matmul_f32(dlogits.t(), hc)
        dhidden = torch.cat(dhs).to(hidden.dtype)
        return dhidden, dhead.to(head.dtype), None, None, None


def lm_head_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, smoothing: float = 0.0,
                          chunk: int = 2048,
                          ignore_index: Optional[int] = None
                          ) -> torch.Tensor:
    """Per-token CE of ``softmax(hidden @ head.T)`` without materializing
    the ``[tokens, vocab]`` logits.  ``hidden`` ``[..., h]``, ``head``
    ``[v, h]``, ``labels`` int ``[...]``; rows whose label equals
    ``ignore_index`` get loss 0 and zero gradients.  Losses are fp32."""
    lead = hidden.shape[:-1]
    hidden2 = hidden.reshape(-1, hidden.shape[-1])
    labels2 = labels.reshape(-1).long()
    valid = None
    if ignore_index is not None:
        valid = labels2 != ignore_index
        labels2 = torch.where(valid, labels2, 0)
    losses = _FusedCE.apply(hidden2, head, labels2, float(smoothing),
                            int(chunk))
    if valid is not None:
        losses = torch.where(valid, losses, 0.0)
    return losses.reshape(lead)
