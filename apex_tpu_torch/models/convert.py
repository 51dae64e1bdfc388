"""Parameters across the two packages, through numpy.

``params_from_numpy`` takes the JAX package's parameter tree as a nested
dict of numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's
side) and returns the port's dict of tensors with the same keys.  numpy
has no bfloat16, so a bf16 leaf travels as float32 and is cast back
(``dtype=``).  Nothing here imports JAX: the caller hands over numpy.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree: dict, *, device: Union[str, torch.device],
                      dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of numpy arrays → the same dict of tensors on
    ``device``; floating leaves cast to ``dtype`` when given."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = params_from_numpy(leaf, device=device, dtype=dtype)
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            arr = arr.astype(np.float32)      # ml_dtypes bf16 → f32
        t = torch.from_numpy(np.array(arr, copy=True)).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[key] = t
    return out


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
