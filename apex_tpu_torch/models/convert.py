"""Parameters and train states across the two packages, through numpy.

``params_from_numpy`` takes the JAX package's parameter tree as a nested
dict of numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's
side) and returns the port's dict of tensors with the same keys; a bf16
leaf (ml_dtypes in numpy) travels through float32; a quantized weight
leaf ``{"wire": int8, "scale": fp32}`` (``models/quantized.py``) crosses
as it is, the int8 unchanged and never through a float.  An MoE tree
(``router_kernel``, ``moe_fc1``/``moe_fc2`` and their biases, or their
quantized expert slabs) crosses with no renaming like any other.
``train_state_from_jax`` carries a whole JAX ``TrainState`` (params, fp32
masters, Adam or LAMB moments and step, loss-scale state) across, so both
packages can start from one mid-training state, and
``lora_adapter_from_jax`` one LoRA adapter, so both serve the same
factors.  Nothing here imports JAX: the caller hands over numpy.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["lora_adapter_from_jax", "params_from_numpy", "params_to_numpy",
           "train_state_from_jax"]


def params_from_numpy(tree, *, device: Union[str, torch.device],
                      dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy arrays (or one array) → the same tree of
    tensors on ``device``; floating leaves cast to ``dtype`` when given,
    else kept in their own dtype (bf16 leaves, which numpy holds as
    ml_dtypes bfloat16, come back as torch bfloat16)."""
    if isinstance(tree, dict):
        # a quantized slab keeps its int8 wire and fp32 scales whatever
        # ``dtype`` the float leaves take
        keep = "wire" in tree and "scale" in tree
        return {k: params_from_numpy(v, device=device,
                                     dtype=None if keep else dtype)
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
    np.asarray, state)``; ``opt_state`` a FusedAdam ``AdamState`` or a
    FusedLAMB ``LambState``) → the port's
    :class:`~apex_tpu_torch.amp.frontend.TrainState` on ``device``, every
    leaf in its own dtype.  Parameter keys cross with no renaming, BERT's
    (``embedding.tokentype``, ``embedding_ln``, ``lm_head``,
    ``binary_head``) as GPT's."""
    from apex_tpu_torch.amp.frontend import TrainState
    from apex_tpu_torch.amp.scaler import LossScaleState
    from apex_tpu_torch.optimizers.fused_adam import AdamState
    from apex_tpu_torch.optimizers.fused_lamb import LambState

    def conv(tree):
        return params_from_numpy(tree, device=device)

    opt, ls = state.opt_state, state.loss_scale_state
    opt_cls = {"AdamState": AdamState, "LambState": LambState}.get(
        type(opt).__name__)
    if opt_cls is None:
        raise TypeError(f"opt_state {type(opt).__name__}: expected an "
                        "AdamState or a LambState")
    return TrainState(
        step=conv(state.step), params=conv(state.params),
        master_params=conv(state.master_params),
        opt_state=opt_cls(conv(opt.step), conv(opt.exp_avg),
                          conv(opt.exp_avg_sq)),
        loss_scale_state=LossScaleState(conv(ls.loss_scale),
                                        conv(ls.unskipped)))


def lora_adapter_from_jax(adapter, *, device: Union[str, torch.device]):
    """The JAX package's ``LoRAAdapter`` (its ``a``/``b`` factor dicts as
    numpy-convertible arrays, ``rank``, ``alpha``) → the port's
    :class:`~apex_tpu_torch.models.lora.LoRAAdapter` on ``device``, each
    factor in its own dtype."""
    from apex_tpu_torch.models.lora import LoRAAdapter

    return LoRAAdapter(
        rank=int(adapter.rank), alpha=float(adapter.alpha),
        a=params_from_numpy({k: np.asarray(v) for k, v in adapter.a.items()},
                            device=device),
        b=params_from_numpy({k: np.asarray(v) for k, v in adapter.b.items()},
                            device=device))
