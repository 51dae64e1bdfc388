"""Softmax cross-entropy with label smoothing (``apex_tpu/ops/xentropy.py``).

The JAX package writes it as an XLA composition with a custom VJP that
saves only the per-row ``lse``; here it is a torch composition whose
autograd gives the same per-row gradient::

    lse  = max(x) + log Σ exp(x - max)
    loss = (lse - mean(x)) · smoothing + (lse - x[label]) · (1-smoothing)
    loss = 0                            where label == padding_idx
    dx_j = g · (softmax_j - smoothing/K - (1-smoothing)·1[j==label])
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss"]


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               padding_idx: Optional[int] = 0,
                               half_to_float: bool = False) -> torch.Tensor:
    """Per-row fp32 losses (reference ``softmax_xentropy`` signature;
    ``half_to_float`` is accepted for parity).  Autograd of this fp32
    composition is the formula above, dx in the logits' dtype."""
    del half_to_float
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    picked = x.gather(-1, labels[..., None].long())[..., 0]
    loss = ((lse - x.mean(-1)) * smoothing
            + (lse - picked) * (1.0 - smoothing))
    if padding_idx is not None:
        loss = torch.where(labels == padding_idx, 0.0, loss)
    return loss


SoftmaxCrossEntropyLoss = softmax_cross_entropy_loss
