"""Bucketing + slot bookkeeping for the continuous-batching engine
(``apex_tpu/serving/batching.py``, which imports no JAX; copied, not
imported).

- **prompt-length buckets** — prompts are padded up to a fixed ladder
  (default: powers of two up to ``max_len``), so prefill sees
  ``len(buckets)`` shapes however many requests arrive: the shapes a
  CUDA-graph capture per bucket would need;
- **slot pool** — free-list arithmetic over the engine's decode lanes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["default_buckets", "pick_bucket", "pad_prompt", "SlotPool"]


def default_buckets(max_len: int, min_bucket: int = 32) -> Tuple[int, ...]:
    """Powers of two from ``min_bucket`` up to (and always including)
    ``max_len`` — the prefill compile ladder."""
    if max_len < 1:
        raise ValueError(f"max_len={max_len} must be positive")
    out = []
    b = min_bucket
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets must be sorted ascending)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"prompt length {n} exceeds the largest bucket {buckets[-1]}")


def pad_prompt(prompt: np.ndarray, bucket: int,
               pad_id: int = 0) -> np.ndarray:
    """Right-pad a 1-D token array to ``bucket`` (left-aligned rows are
    the ragged-batch contract of models/generate.py)."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    if prompt.shape[0] > bucket:
        raise ValueError(
            f"prompt length {prompt.shape[0]} exceeds bucket {bucket}")
    out = np.full((bucket,), pad_id, np.int32)
    out[: prompt.shape[0]] = prompt
    return out


class SlotPool:
    """Free-list over the cache's batch axis.

    Pure host bookkeeping — the device-side cache rows themselves are
    never moved; claiming a slot only grants the right to overwrite
    that row (prefill) and to interpret its decode lane.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} must be positive")
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))  # pop() -> slot 0 first
        self._active: set = set()

    def claim(self) -> Optional[int]:
        """Lowest free slot id, or None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._active.add(slot)
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        self._active.discard(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)

    def is_active(self, slot: int) -> bool:
        """O(1) membership — failure-path unwind code checks this on
        every exception; don't make it build the sorted ``active``
        tuple."""
        return slot in self._active

    @property
    def active(self) -> Tuple[int, ...]:
        return tuple(sorted(self._active))

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_free(self) -> int:
        return len(self._free)
