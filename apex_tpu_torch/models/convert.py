"""Parameters and train states across the two packages, through numpy.

``params_from_numpy`` takes the JAX package's parameter tree as a nested
dict of numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's
side) and returns the port's dict of tensors with the same keys; a bf16
leaf (ml_dtypes in numpy) travels through float32.
``train_state_from_jax`` carries a whole JAX ``TrainState`` (params, fp32
masters, Adam moments and step, loss-scale state) across, so both
packages can start from one mid-training state.  Nothing here imports
JAX: the caller hands over numpy.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy", "train_state_from_jax"]


def params_from_numpy(tree, *, device: Union[str, torch.device],
                      dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy arrays (or one array) → the same tree of
    tensors on ``device``; floating leaves cast to ``dtype`` when given,
    else kept in their own dtype (bf16 leaves, which numpy holds as
    ml_dtypes bfloat16, come back as torch bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    bf16 = arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16"
    t = torch.from_numpy(np.array(arr.astype(np.float32) if bf16 else arr,
                                  copy=True)).to(device)
    if dtype is not None and t.is_floating_point():
        return t.to(dtype)
    return t.to(torch.bfloat16) if bf16 else t


def params_to_numpy(params: dict) -> dict:
    """The port's parameter dict → nested dict of numpy arrays (bf16
    leaves widen to float32)."""
    out = {}
    for key, leaf in params.items():
        if isinstance(leaf, dict):
            out[key] = params_to_numpy(leaf)
            continue
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[key] = t.numpy()
    return out


def train_state_from_jax(state, *, device: Union[str, torch.device]):
    """The JAX package's ``TrainState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)``; ``opt_state`` a FusedAdam ``AdamState``) → the
    port's :class:`~apex_tpu_torch.amp.frontend.TrainState` on
    ``device``, every leaf in its own dtype."""
    from apex_tpu_torch.amp.frontend import TrainState
    from apex_tpu_torch.amp.scaler import LossScaleState
    from apex_tpu_torch.optimizers.fused_adam import AdamState

    def conv(tree):
        return params_from_numpy(tree, device=device)

    opt, ls = state.opt_state, state.loss_scale_state
    return TrainState(
        step=conv(state.step), params=conv(state.params),
        master_params=conv(state.master_params),
        opt_state=AdamState(conv(opt.step), conv(opt.exp_avg),
                            conv(opt.exp_avg_sq)),
        loss_scale_state=LossScaleState(conv(ls.loss_scale),
                                        conv(ls.unskipped)))
