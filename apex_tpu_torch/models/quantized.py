"""Weight-only quantized serving parameters (``apex_tpu/models/
quantized.py``): the one-shot conversion.

:func:`quantize_params` turns every per-layer matmul kernel
(``qkv_kernel``, ``proj_kernel``, ``fc1_kernel``, ``fc2_kernel``) into a
``{"wire": int8, "scale": fp32}`` slab with one scale per
(contraction block, output column) — per layer, so each layer's scale
grid matches the JAX package's ``vmap`` bit for bit.  The model code
branches on :func:`~apex_tpu_torch.ops.dense.is_quantized` at each
matmul site and runs kernel row 10.  Embedding, head, biases and norms
stay float.  The MoE expert slabs (``moe_fc1``, ``moe_fc2``) become
``{"wire": int8 [L, E, k, p], "scale": fp32 [L, E, k/kb, p]}`` through
:func:`~apex_tpu_torch.ops.grouped_matmul.quantize_group_weights`, per
layer, and run kernel row 9's int8 branch (``grouped_matmul_quantized``);
the router stays float.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.dense import (
    QUANT_BLOCK, dequantize_weight, is_quantized, quantize_weight)
from apex_tpu_torch.ops.grouped_matmul import (
    _dequantize_group, quantize_group_weights)

__all__ = ["dequantize_params", "is_quantized_tree", "param_bytes",
           "quantize_params"]

_DENSE_KERNELS = ("qkv_kernel", "proj_kernel", "fc1_kernel",
                  "fc2_kernel")
_GROUPED_KERNELS = ("moe_fc1", "moe_fc2")


def _per_layer(fn, *stacked):
    outs = [fn(*(t[i] for t in stacked)) for i in range(stacked[0].shape[0])]
    if isinstance(outs[0], dict):
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return torch.stack(outs)


def quantize_params(params: dict, *, block: Optional[int] = None) -> dict:
    """A new tree whose per-layer matmul kernels are int8 weight slabs;
    ``block`` bounds the contraction-axis scale block (default 128,
    clamped to a divisor of each in-dim).  Unquantized leaves are
    shared; a tree that is already quantized raises."""
    block = int(block or QUANT_BLOCK)
    layers = dict(params["layers"])
    for names, quantize in ((_DENSE_KERNELS, quantize_weight),
                            (_GROUPED_KERNELS, quantize_group_weights)):
        for name in names:
            w = layers.get(name)
            if w is None:
                continue
            if is_quantized(w):
                raise ValueError(
                    f"params['layers'][{name!r}] is already quantized — "
                    "quantize_params expects a float tree")
            layers[name] = _per_layer(
                lambda wl, q=quantize: q(wl, block), w)
    return dict(params, layers=layers)


def dequantize_params(params: dict) -> dict:
    """The fake-quant oracle: every quantized slab replaced by its fp32
    dequantized kernel."""
    layers = dict(params["layers"])
    for name, leaf in list(layers.items()):
        if is_quantized(leaf):
            fn = (_dequantize_group if name in _GROUPED_KERNELS
                  else dequantize_weight)
            layers[name] = _per_layer(fn, leaf["wire"], leaf["scale"])
    return dict(params, layers=layers)


def is_quantized_tree(params: dict) -> bool:
    """True when any layer kernel carries the int8 slab form."""
    return any(is_quantized(leaf)
               for leaf in params.get("layers", {}).values())


def param_bytes(params) -> int:
    """Resident bytes of a parameter tree (quantized dicts count wire +
    scales)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if params is None:
        return 0
    return params.numel() * params.element_size()
