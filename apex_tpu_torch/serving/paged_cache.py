"""Paged KV pool allocation (``apex_tpu/serving/paged_cache.py``), the
native-wire subset the one-shot ``generate`` path needs.

The pool is one buffer per K/V side, ``[num_layers, num_blocks,
block_size, kv_groups, dh]``; block tables index it, with entries
``>= num_blocks`` unmapped.  The host-side ``BlockManager`` and the
int8 wire come with the serving-engine slice.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from apex_tpu_torch.models.config import TransformerConfig

__all__ = ["blocks_for", "init_paged_pool"]


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` (ceil division)."""
    if n_tokens < 0:
        raise ValueError(f"n_tokens={n_tokens} must be >= 0")
    if block_size < 1:
        raise ValueError(f"block_size={block_size} must be positive")
    return -(-n_tokens // block_size)


def init_paged_pool(cfg: TransformerConfig, num_blocks: int,
                    block_size: int, cache_dtype: Optional[torch.dtype] = None,
                    cache_wire: Optional[str] = None, *,
                    device: Union[str, torch.device]) -> dict:
    """Zeroed K/V pools ``[L, num_blocks, block_size, kv_groups, dh]`` in
    ``cache_dtype`` (default ``cfg.compute_dtype``) on ``device``."""
    if num_blocks < 1:
        raise ValueError(f"num_blocks={num_blocks} must be positive")
    if block_size < 1:
        raise ValueError(f"block_size={block_size} must be positive")
    if cache_wire not in (None, "native"):
        if cache_wire == "int8":
            raise NotImplementedError(
                "cache_wire='int8' comes with the serving-engine slice of "
                "the port")
        raise ValueError(
            f"cache_wire={cache_wire!r}: expected 'native' or 'int8'")
    dt = cfg.compute_dtype if cache_dtype is None else cache_dtype
    shape = (cfg.num_layers, num_blocks, block_size, cfg.kv_groups,
             cfg.kv_channels)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
