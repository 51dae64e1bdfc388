"""Adam over one flattened buffer (``apex_tpu/ops/flat_adam.py``).

``adam_kernel_flat`` is the flat-buffer entry point of the layout a
ZeRO-sharded optimizer stores (raw 1-D shards); ``flat_adam_update`` is
the tree-level wrapper (``fused_adam(use_flat_buffer=True)``): flatten,
update, split back into views of the flat results.

On the card ``adam_kernel_flat`` is the multi-tensor Adam kernel (M3,
``multi_tensor.multi_tensor_adam``) over lists of one tensor each,
reading the seven scalars from the device vector; on the CPU it is the
JAX function's arithmetic in torch (1 - beta in fp32, from the vector).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from apex_tpu_torch.multi_tensor.multi_tensor_apply import (
    as_f32, multi_tensor_adam)
from apex_tpu_torch.optimizers._common import float_leaves, rebuild
from apex_tpu_torch.utils.registry import check_backend

__all__ = ["flat_adam_update", "adam_kernel_flat"]


def adam_kernel_flat(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, scalars: torch.Tensor,
                     adam_w_mode: bool = True, *,
                     backend: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adam on 1-D fp32 buffers → ``(update, new_m, new_v)``.
    ``scalars`` = [lr, beta1, beta2, eps, weight_decay, bc1, bc2] (fp32
    ``[7]`` on the buffers' device; the kernel reads it there)."""
    check_backend(backend)
    if g.device.type == "cuda" and backend is None:
        # the kernel reads lr and the bias corrections where they lie in
        # the vector, the rest in mt::Hyper's layout (1 - beta in fp32)
        scalars = scalars.to(device=g.device, dtype=torch.float32)
        lr, bc1, bc2 = scalars[0], scalars[5], scalars[6]
        betas = scalars[1:3]
        hyper_dev = torch.cat([betas, 1.0 - betas, scalars[3:5]])
        out = multi_tensor_adam([g], [p], [m], [v], lr=lr, betas=(0.0, 0.0),
                                eps=0.0, weight_decay=0.0,
                                adam_w_mode=adam_w_mode, bc1=bc1, bc2=bc2,
                                hyper_dev=hyper_dev)
        return out.params[0], out.exp_avg[0], out.exp_avg_sq[0]
    lr, beta1, beta2, eps, wd, bc1, bc2 = (scalars[i] for i in range(7))
    if not adam_w_mode:
        g = g + wd * p
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    u = -lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if adam_w_mode:
        u = u - lr * wd * p
    return u, m_new, v_new


def _flat(tree) -> torch.Tensor:
    return torch.cat([x.float().reshape(-1) for x in float_leaves(tree)])


def _unflat(flat: torch.Tensor, like):
    """Views of ``flat`` in the shapes of ``like``'s float leaves."""
    leaves = float_leaves(like)
    parts = torch.split(flat, [x.numel() for x in leaves])
    return rebuild(like, [t.view(x.shape) for t, x in zip(parts, leaves)])


def flat_adam_update(grads: Any, params: Any, m: Any, v: Any, lr, beta1,
                     beta2, eps, weight_decay, bc1, bc2, adam_w_mode: bool):
    """Tree-level wrapper: flatten → :func:`adam_kernel_flat` → the
    update, m and v as views of the three flat results, in the trees'
    shapes."""
    dev = float_leaves(params)[0].device
    scalars = torch.stack([as_f32(x, dev).reshape(())
                           for x in (lr, beta1, beta2, eps, weight_decay,
                                     bc1, bc2)])
    u, m_new, v_new = adam_kernel_flat(_flat(grads), _flat(params), _flat(m),
                                       _flat(v), scalars,
                                       adam_w_mode=adam_w_mode)
    return _unflat(u, params), _unflat(m_new, m), _unflat(v_new, v)
