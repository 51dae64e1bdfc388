"""Greedy size-bucketed flattening of gradient trees
(``apex_tpu/comm/bucketing.py``).

The reference DDP ``Reducer`` builds dtype-segregated greedy buckets
(apex/parallel/distributed.py:369-390) so that each collective moves a
worthwhile payload; leaves larger than a bucket are split across
buckets.  :func:`plan_buckets` is the JAX package's plan, element for
element (pure Python over shapes); :func:`gather_bucket` and
:func:`scatter_buckets` move the data with torch ops.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["BucketSlice", "Bucket", "plan_buckets", "gather_bucket",
           "scatter_buckets"]


class BucketSlice(NamedTuple):
    """One contiguous span of a flattened leaf assigned to a bucket."""

    leaf_index: int
    start: int     # element offset into the flattened leaf
    stop: int


def _aligned(n: int, align: int) -> int:
    return -(-n // align) * align


class Bucket(NamedTuple):
    slices: Tuple[BucketSlice, ...]
    size: int       # flat elements including per-slice alignment padding
    align: int = 1  # per-slice padding granularity (the scale block)

    @property
    def nbytes(self) -> int:
        # planning accounting is in raw fp32 gradient bytes
        return self.size * 4


def _dtype_key(leaf) -> str:
    """The JAX package's dtype key (``str(jnp dtype)``: ``float32``,
    ``bfloat16``, ...) of a tensor or of anything with a ``dtype``."""
    dt = getattr(leaf, "dtype", "f32")
    return str(dt).replace("torch.", "")


def plan_buckets(leaves: Sequence[Any], bucket_bytes: int,
                 align: int = 1) -> List[Bucket]:
    """Partition ``leaves`` (tensors, or anything with ``shape`` and
    ``dtype``) into greedy buckets of at most ``bucket_bytes`` raw fp32
    bytes: leaves of different dtypes never share a bucket, leaves larger
    than a bucket are split into bucket-sized chunks, every element of
    every leaf is covered once, empty leaves are skipped.  ``align > 1``
    zero-pads every slice's span in the flat bucket to a multiple of
    ``align`` (the int8 scale block: no block mixes two leaves)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    if align <= 0:
        raise ValueError(f"align must be positive, got {align}")
    cap = max(align, (bucket_bytes // 4) // align * align)
    buckets: List[Bucket] = []
    open_slices: dict = {}
    open_size: dict = {}

    def close(key):
        if open_slices.get(key):
            buckets.append(
                Bucket(tuple(open_slices[key]), open_size[key], align))
            open_slices[key] = []
            open_size[key] = 0

    for i, leaf in enumerate(leaves):
        n = 1
        for d in getattr(leaf, "shape", ()):
            n *= int(d)
        if n == 0:
            continue
        key = _dtype_key(leaf)
        open_slices.setdefault(key, [])
        open_size.setdefault(key, 0)
        off = 0
        while off < n:
            room = cap - open_size[key]
            take = min(n - off, room)
            if take == 0:
                close(key)
                continue
            open_slices[key].append(BucketSlice(i, off, off + take))
            open_size[key] += _aligned(take, align)
            off += take
            if open_size[key] >= cap:
                close(key)
    for key in list(open_slices):
        close(key)
    return buckets


def gather_bucket(leaves: Sequence[torch.Tensor],
                  bucket: Bucket) -> torch.Tensor:
    """The bucket's slices as one flat fp32 vector (each slice
    zero-padded to the bucket's alignment)."""
    parts = []
    for s in bucket.slices:
        piece = leaves[s.leaf_index].reshape(-1)[s.start:s.stop].float()
        pad = _aligned(s.stop - s.start, bucket.align) - (s.stop - s.start)
        parts.append(F.pad(piece, (0, pad)) if pad else piece)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def scatter_buckets(leaves: Sequence[torch.Tensor],
                    buckets: Sequence[Bucket],
                    flats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Full leaves rebuilt (each leaf's dtype and shape) from per-bucket
    flat vectors, the inverse of :func:`gather_bucket`; leaves the plan
    does not cover pass through."""
    pieces: dict = {i: [] for i in range(len(leaves))}
    for bucket, flat in zip(buckets, flats):
        off = 0
        for s in bucket.slices:
            take = s.stop - s.start
            pieces[s.leaf_index].append((s.start, flat[off:off + take]))
            off += _aligned(take, bucket.align)
    out: List[torch.Tensor] = []
    for i, leaf in enumerate(leaves):
        if not pieces[i]:
            out.append(leaf)
            continue
        parts = [p for _, p in sorted(pieces[i], key=lambda t: t[0])]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        out.append(flat.reshape(leaf.shape).to(leaf.dtype))
    return out
