"""Host-DRAM KV offload tier (``apex_tpu/serving/host_tier.py``): the
second level of the paged cache.

:class:`HostTier` is a bounded host-memory LRU page store behind the
``BlockManager`` ledger.  It catches two things the HBM pool would lose:

- **preemption parking** — the engine gathers the victim's pages (an
  int8 pool dequantized), serializes them through the KV handoff codec
  (:func:`~apex_tpu_torch.serving.cluster.handoff.encode_kv`, ``raw`` or
  block-scaled ``int8`` wire) and parks them under ``(request_id,
  materialized_tokens)``.  Resume pages them back in through the
  engine's bucket-shaped insert instead of replaying the prefill; on the
  raw wire the round trip is bitwise, so greedy continuation is
  token-identical;
- **cold-prefix eviction** — when the last HBM reference to a published
  block drops, the engine parks its page under its chain digest (raw
  wire only: a digest hit maps pages with no token re-check).  A later
  admission whose digest misses HBM but hits here pages the block back
  in and republishes it.

The store is bounded by ``capacity_bytes``: an insert evicts the least
recently used entries until it fits, and an entry larger than the whole
budget is refused (counted as an eviction, never stored).  Unlike the
JAX package, no environment variable overrides ``host_tier_bytes`` or
``host_tier_wire``: nothing in the port routes by environment.

Telemetry (no-op unless :func:`~apex_tpu_torch.observability.configure`
ran): ``serving.host_tier.{bytes,pages}`` gauges,
``serving.host_tier.{hits,misses,evictions,prefetches}`` counters (the
engine adds ``page_ins``, ``resumes`` and ``replays``) and the
``serving.host_tier.{page_in_ms,page_out_ms}`` sketches.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.serving.cluster.handoff import (
    decode_kv, encode_kv, wire_bytes)
from apex_tpu_torch.serving.paged_cache import blocks_for

__all__ = ["DIGEST_INVENTORY_N", "HOST_TIER_WIRES", "HostTier",
           "resolve_host_tier_bytes", "resolve_host_tier_wire"]

# the offload wires: raw (bitwise round trips) and int8 (denser, lossy)
HOST_TIER_WIRES = ("raw", "int8")

# newest-N bound of the digest-inventory summary ``stats()`` reports
DIGEST_INVENTORY_N = 32


def _parse_bytes(text: str) -> int:
    """A byte count as a plain int or with a binary-unit suffix (``64k``,
    ``256m``, ``2g``); raises ValueError otherwise."""
    s = text.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(s[-1:], 1)
    if mult != 1:
        s = s[:-1]
    n = int(s) * mult
    if n < 1:
        raise ValueError(text)
    return n


def resolve_host_tier_bytes(value) -> Optional[int]:
    """The capacity knob: ``None``, ``"off"`` or ``"0"`` disable the tier;
    a positive int or a ``256m``/``2g``-style string is the capacity in
    bytes."""
    if value is None:
        return None
    if isinstance(value, str):
        if value.strip().lower() in ("off", "0"):
            return None
        return _parse_bytes(value)
    if int(value) < 1:
        raise ValueError(f"host_tier_bytes={value} must be >= 1 (or None to "
                         "disable the host tier)")
    return int(value)


def resolve_host_tier_wire(value: Optional[str]) -> str:
    """The offload wire: ``"raw"`` (the default; bitwise round trips) or
    ``"int8"``."""
    wire = "raw" if value is None else str(value)
    if wire not in HOST_TIER_WIRES:
        raise ValueError(f"host_tier_wire={value!r}: expected one of "
                         f"{HOST_TIER_WIRES}")
    return wire


class _Entry:
    """One parked page set: its wire form and, once prefetched, the
    decoded copy."""

    __slots__ = ("header", "blobs", "nbytes", "pages", "staged")

    def __init__(self, header: dict, blobs: List[bytes], pages: int):
        self.header = header
        self.blobs = blobs
        self.nbytes = wire_bytes(blobs)
        self.pages = pages
        self.staged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class HostTier:
    """Bounded host-DRAM LRU page store keyed by (request, tokens) for
    preemption parking and by chain digest for cold-prefix eviction.  Used
    from the owning engine's thread only, as its ``BlockManager``."""

    def __init__(self, capacity_bytes: int, *, wire: str = "raw",
                 block_size: int = 16):
        if capacity_bytes < 1:
            raise ValueError(f"capacity_bytes={capacity_bytes} must be >= 1")
        if wire not in HOST_TIER_WIRES:
            raise ValueError(
                f"wire={wire!r}: expected one of {HOST_TIER_WIRES}")
        self.capacity_bytes = int(capacity_bytes)
        self.wire = wire
        self.block_size = int(block_size)
        self._lru: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._bytes = 0
        self._pages = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    # -- store internals -----------------------------------------------------

    def _evict_until(self, need: int) -> None:
        while self._lru and self._bytes + need > self.capacity_bytes:
            _, old = self._lru.popitem(last=False)
            self._bytes -= old.nbytes
            self._pages -= old.pages
            self._evictions += 1
            _telemetry.counter("serving.host_tier.evictions").inc()
        self._set_gauges()

    def _put(self, key: tuple, k, v) -> bool:
        t0 = time.perf_counter()
        header, blobs = encode_kv(k, v, wire_dtype=self.wire)
        entry = _Entry(header, blobs,
                       pages=blocks_for(int(header["shape"][1]),
                                        self.block_size))
        if entry.nbytes > self.capacity_bytes:
            # larger than the whole budget: refused, not stored
            self._evictions += 1
            _telemetry.counter("serving.host_tier.evictions").inc()
            return False
        old = self._lru.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
            self._pages -= old.pages
        self._evict_until(entry.nbytes)
        self._lru[key] = entry
        self._bytes += entry.nbytes
        self._pages += entry.pages
        self._set_gauges()
        _telemetry.sketch("serving.host_tier.page_out_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return True

    def _get(self, key: tuple, *, pop: bool
             ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        entry = self._lru.get(key)
        if entry is None:
            self._misses += 1
            _telemetry.counter("serving.host_tier.misses").inc()
            return None
        self._hits += 1
        _telemetry.counter("serving.host_tier.hits").inc()
        out = (entry.staged if entry.staged is not None
               else decode_kv(entry.header, entry.blobs))
        if pop:
            del self._lru[key]
            self._bytes -= entry.nbytes
            self._pages -= entry.pages
            self._set_gauges()
        else:
            self._lru.move_to_end(key)
        return out

    def _set_gauges(self) -> None:
        _telemetry.gauge("serving.host_tier.bytes").set(self._bytes)
        _telemetry.gauge("serving.host_tier.pages").set(self._pages)

    # -- request parking (preempt -> page-in resume) -------------------------

    def put_request(self, request_id: int, n_tokens: int, k, v) -> bool:
        """Park a preempted request's materialized pages (per-token float
        K/V ``[L, n_tokens, g, dh]``).  False when they exceed the whole
        budget."""
        return self._put(("req", int(request_id), int(n_tokens)), k, v)

    def has_request(self, request_id: int, n_tokens: int) -> bool:
        return ("req", int(request_id), int(n_tokens)) in self._lru

    def take_request(self, request_id: int, n_tokens: int
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Pop and decode a parked request's pages, or None (evicted or
        never parked: the caller replays the prefill).  One hit or miss
        either way."""
        return self._get(("req", int(request_id), int(n_tokens)), pop=True)

    def drop_request(self, request_id: int, n_tokens: int) -> None:
        """Discard a parked request without hit or miss accounting."""
        entry = self._lru.pop(("req", int(request_id), int(n_tokens)), None)
        if entry is not None:
            self._bytes -= entry.nbytes
            self._pages -= entry.pages
            self._set_gauges()

    def prefetch_request(self, request_id: int, n_tokens: int) -> bool:
        """Decode a parked request's wire bytes into a staged copy ahead of
        its re-admission (the engine calls this while the request waits at
        the queue head), so the page-in does not wait on the decode."""
        entry = self._lru.get(("req", int(request_id), int(n_tokens)))
        if entry is None or entry.staged is not None:
            return False
        entry.staged = decode_kv(entry.header, entry.blobs)
        _telemetry.counter("serving.host_tier.prefetches").inc()
        return True

    # -- digest parking (cold-prefix eviction -> republish) ------------------

    def put_block(self, digest: bytes, k, v) -> bool:
        """Park one evicted published block's pages ``[L, block_size, g,
        dh]`` under its chain digest; raw wire only (a digest hit maps
        pages with no token re-check)."""
        if self.wire != "raw":
            return False
        return self._put(("digest", bytes(digest)), k, v)

    def has_block(self, digest: bytes) -> bool:
        return ("digest", bytes(digest)) in self._lru

    def peek_block(self, digest: bytes
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Decode a parked block without removing it (page-in keeps the
        host copy until the LRU ages it out)."""
        return self._get(("digest", bytes(digest)), pop=False)

    # -- inventory / accounting ----------------------------------------------

    def newest_digests(self, limit: int = DIGEST_INVENTORY_N) -> List[bytes]:
        """The newest ``limit`` host-resident chain digests, newest
        first."""
        if limit <= 0:
            return []
        out = [key[1] for key in self._lru if key[0] == "digest"][-limit:]
        out.reverse()
        return out

    def stats(self) -> Dict[str, int]:
        return {
            "capacity_bytes": self.capacity_bytes,
            "bytes": self._bytes,
            "free_bytes": max(0, self.capacity_bytes - self._bytes),
            "pages": self._pages,
            "entries": len(self._lru),
            "hits": self._hits,
            "misses": self._misses,
            "evictions": self._evictions,
            "wire": self.wire,
        }
