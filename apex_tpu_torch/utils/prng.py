"""JAX's default PRNG keys, bit for bit, in torch (no counterpart in the
JAX package, which calls ``jax.random``).

The train steps take JAX's raw keys: a ``[2]`` tensor of uint32 words
(``jax.random.key_data`` of a threefry key, or ``jax.random.PRNGKey``).
This module repeats what the JAX package does with such a key: the
Threefry-2x32 block cipher (20 rounds, Salmon et al. 2011, "Parallel
random numbers: as easy as 1, 2, 3") and ``jax.random.split`` over it, so
the port derives the same per-microbatch and per-layer keys as the JAX
step.  It follows JAX 0.9.0 under its defaults ``jax_default_prng_impl =
threefry2x32`` and ``jax_threefry_partitionable = True``: ``split(key,
n)`` enciphers the counters ``(0, i)`` for ``i < n`` (the high and low
words of ``iota(n)``) under ``key`` and the pair of outputs is key ``i``.
The older non-partitionable split (``jax_threefry_partitionable =
False``) enciphers other counters and is not reproduced.

Words are uint32 values held in int64 tensors (torch has no uint32
arithmetic on every device); every sum and shift is reduced modulo
2**32.  Nothing here draws from torch's generators: a key is a counter
hash, like the dropout masks of ``ops/flash_attention.keep_mask``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = ["MASK32", "threefry2x32", "key", "split", "key_data",
           "layer_words"]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key
    ``(k1, k2)``: uint32 values in int64 tensors (or ints), broadcast
    together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int, device: Union[str, torch.device] = "cpu"):
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` under JAX's
    default 32-bit integers (``jax_enable_x64`` off): ``[0, seed mod
    2**32]``, a ``[2]`` int64 tensor."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def key_data(k) -> torch.Tensor:
    """A raw key's words as int64 (uint32 values): a tensor of any
    integer dtype (an int32 view of uint32 words is read back modulo
    2**32) or a numpy array; the last dimension is 2."""
    t = (k if torch.is_tensor(k)
         else torch.tensor(np.asarray(k).astype(np.int64)))
    t = t.to(torch.int64) & MASK32
    if t.shape[-1:] != (2,):
        raise ValueError(f"a raw key has 2 words in its last dimension; "
                         f"got shape {tuple(t.shape)}")
    return t


def split(k, num: int = 2) -> torch.Tensor:
    """``jax.random.key_data(jax.random.split(k, num))`` for a raw key
    ``k`` ``[..., 2]``: ``[..., num, 2]`` int64 words, on ``k``'s
    device."""
    words = key_data(k)
    k1, k2 = words[..., 0:1], words[..., 1:2]
    lo = torch.arange(num, dtype=torch.int64, device=words.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def layer_words(k, num_layers: int) -> torch.Tensor:
    """The ``[L, 5, 2]`` dropout key words a JAX backbone derives from
    one step's raw key: ``split(k, L)``, then five keys a layer (the JAX
    ``_layer``'s ``r1``…``r5``, ``split(layer_key, 5)``)."""
    return split(split(k, num_layers), 5)
