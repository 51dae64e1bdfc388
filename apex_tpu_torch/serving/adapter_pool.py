"""Refcounted device slab pool for LoRA adapters
(``apex_tpu/serving/adapter_pool.py``).

The batched LoRA decode path (:mod:`apex_tpu_torch.models.lora`) reads
stacked ``[L, G, in, r]`` / ``[L, G, r, out]`` factor slabs and a per-lane
slot index.  This pool owns the slabs with the block ledger's discipline:

- **register** an adapter by id (a host-side catalog; geometry checked
  against the first adapter, since a slab is one tensor per target);
- **acquire** at admission: a resident adapter's slot is a refcount
  bump; a miss pages the factors into a free slot, evicting the least
  recently used zero-ref resident when the pool is full, and returns
  ``None`` when every slot is pinned by a live lane (admission blocks);
- **release** at completion or preemption: at zero refs the adapter
  stays resident (warm) and becomes evictable.

The slot count is fixed at the first build: the slabs keep one shape and
the per-lane index is a tensor, so one decode step serves every adapter
mix.  ``pool_bytes`` (or ``APEX_TPU_ADAPTER_POOL_BYTES``, which beats
it) divides by the per-adapter footprint to fix the slot count;
``slots=`` pins it.  The ledger is a partition: every slot is exactly one
of free, pinned (refs > 0) or evictable (resident at zero refs), and
:meth:`AdapterPool.census` checks it.

Telemetry (no-op unless configured): ``serving.adapter.{hits,misses,
evictions}`` counters, ``serving.adapter.{resident,bytes}`` gauges.
"""

from __future__ import annotations

import os
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from apex_tpu_torch.observability import metrics as _telemetry

__all__ = ["AdapterPool", "resolve_adapter_pool_bytes"]


def _parse_bytes(text: str) -> int:
    """A byte count as a plain int or with a binary-unit suffix (``64k`` /
    ``256m`` / ``2g``); raises ValueError otherwise (the JAX package's
    ``serving/host_tier._parse_bytes``)."""
    s = text.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(s[-1:], 1)
    if mult != 1:
        s = s[:-1]
    n = int(s) * mult
    if n < 1:
        raise ValueError(text)
    return n


def resolve_adapter_pool_bytes(value) -> Optional[int]:
    """The pool's capacity knob: ``APEX_TPU_ADAPTER_POOL_BYTES`` beats the
    caller's ``pool_bytes=`` (a positive byte count, plain or
    ``256m``/``2g``; ``off``/``0`` = no byte bound); a malformed
    environment value warns by name and falls back to the caller's."""
    raw = os.environ.get("APEX_TPU_ADAPTER_POOL_BYTES")
    if raw is not None:
        if raw.strip().lower() in ("off", "0"):
            return None
        try:
            return _parse_bytes(raw)
        except ValueError:
            warnings.warn(
                f"APEX_TPU_ADAPTER_POOL_BYTES={raw!r} is malformed "
                "(expected a positive byte count like 268435456 or "
                "256m, or off/0 for no byte bound); using the "
                "caller's pool_bytes", stacklevel=3)
    if value is None:
        return None
    if isinstance(value, str):
        if value.strip().lower() in ("off", "0"):
            return None
        return _parse_bytes(value)
    if int(value) < 1:
        raise ValueError(
            f"pool_bytes={value} must be >= 1 (or None for no byte "
            "bound)")
    return int(value)


class AdapterPool:
    """Refcounted LRU slab pool over ``G`` adapter slots.  ``slots=``
    pins the slot count; otherwise ``pool_bytes`` (environment
    overridable) divides by the per-adapter footprint at the first build;
    with neither, 8 slots.  The slabs live where the first registered
    adapter's factors do."""

    DEFAULT_SLOTS = 8
    # count bound of the resident-id inventory in stats()
    INVENTORY_N = 64

    def __init__(self, cfg, *, slots: Optional[int] = None,
                 pool_bytes=None):
        if slots is not None and int(slots) < 1:
            raise ValueError(f"slots={slots}: need >= 1 adapter slots")
        self.cfg = cfg
        self._slots_arg = None if slots is None else int(slots)
        self._pool_bytes = resolve_adapter_pool_bytes(pool_bytes)
        self._registry: Dict[int, object] = {}     # adapter_id -> adapter
        self._adapter_bytes: Optional[int] = None
        self._slabs = None
        self.n_slots: Optional[int] = None
        self._slot_of: Dict[int, int] = {}         # adapter_id -> slot
        self._ids: List[Optional[int]] = []        # slot -> adapter_id
        self._refs: List[int] = []                 # slot -> live lanes
        # zero-ref residents in LRU order (the evictable set)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- catalog ------------------------------------------------------------

    def register(self, adapter_id: int, adapter) -> None:
        """Catalog one adapter under a positive integer id (0 is the
        no-adapter id).  Geometry must match the pool's first adapter; a
        resident id cannot be re-registered."""
        from apex_tpu_torch.models.lora import adapter_bytes

        aid = int(adapter_id)
        if aid < 1:
            raise ValueError(
                f"adapter_id={adapter_id}: ids start at 1 (0 is the "
                "no-adapter sentinel)")
        if self._registry:
            ref = next(iter(self._registry.values()))
            if (adapter.rank != ref.rank
                    or adapter.targets != ref.targets):
                raise ValueError(
                    f"adapter {aid}: rank/targets ({adapter.rank}, "
                    f"{adapter.targets}) do not match the pool's "
                    f"({ref.rank}, {ref.targets}) — one slab per "
                    "target means uniform geometry")
        if aid in self._slot_of:
            raise ValueError(
                f"adapter {aid} is resident; evict it (drop all refs "
                "and let LRU churn it out) before re-registering")
        self._registry[aid] = adapter
        if self._adapter_bytes is None:
            self._adapter_bytes = adapter_bytes(adapter)

    def registered(self, adapter_id: int) -> bool:
        return int(adapter_id) in self._registry

    # -- slab build ---------------------------------------------------------

    def _resolve_slots(self) -> int:
        if self._slots_arg is not None:
            return self._slots_arg
        if self._pool_bytes is not None:
            per = self._adapter_bytes or 1
            n = self._pool_bytes // per
            if n < 1:
                raise ValueError(
                    f"APEX_TPU_ADAPTER_POOL_BYTES/pool_bytes "
                    f"({self._pool_bytes}) is smaller than one "
                    f"adapter ({per} bytes) — the pool cannot hold "
                    "anything")
            return int(n)
        return self.DEFAULT_SLOTS

    def _build(self) -> None:
        from apex_tpu_torch.models.lora import stack_adapter_slabs

        self.n_slots = self._resolve_slots()
        self._ids = [None] * self.n_slots
        self._refs = [0] * self.n_slots
        # zero slabs of the template's geometry: one template slot, then
        # that slot wiped, the one build path
        template = next(iter(self._registry.values()))
        self._slabs = stack_adapter_slabs(
            [None] * (self.n_slots - 1) + [template], self.cfg)
        self._scatter(self.n_slots - 1, None)

    def _scatter(self, slot: int, adapter) -> None:
        """Write one slot of every slab in place (zeros for ``None``): the
        page-in an admission miss pays."""
        with torch.no_grad():
            for t, pair in self._slabs.items():
                for fk in ("a", "b"):
                    arr = pair[fk]
                    if adapter is None:
                        arr[:, slot] = 0
                    else:
                        val = getattr(adapter, fk)[t].to(arr)
                        arr[:, slot] = (val * adapter.scaling if fk == "b"
                                        else val)

    # -- the ledger ---------------------------------------------------------

    def acquire(self, adapter_id: int) -> Optional[int]:
        """Pin one adapter for a lane → its 1-based slab index (``slot +
        1``; 0 stays the no-adapter id), or ``None`` when every slot is
        pinned (the caller blocks admission).  An unregistered id
        raises."""
        aid = int(adapter_id)
        if aid == 0:
            return 0
        if aid not in self._registry:
            raise KeyError(f"adapter {aid} is not registered")
        if self._slabs is None:
            self._build()
        slot = self._slot_of.get(aid)
        if slot is not None:
            self._refs[slot] += 1
            self._lru.pop(aid, None)
            self.hits += 1
            _telemetry.counter("serving.adapter.hits").inc()
            self._set_gauges()
            return slot + 1
        self.misses += 1
        _telemetry.counter("serving.adapter.misses").inc()
        slot = self._free_slot()
        if slot is None:
            return None
        self._scatter(slot, self._registry[aid])
        self._ids[slot] = aid
        self._slot_of[aid] = slot
        self._refs[slot] = 1
        self._set_gauges()
        return slot + 1

    def _free_slot(self) -> Optional[int]:
        for s, aid in enumerate(self._ids):
            if aid is None:
                return s
        if self._lru:
            victim, _ = self._lru.popitem(last=False)
            s = self._slot_of.pop(victim)
            self._ids[s] = None
            self._refs[s] = 0
            self.evictions += 1
            _telemetry.counter("serving.adapter.evictions").inc()
            return s
        return None                    # every slot pinned: block

    def release(self, adapter_id: int) -> None:
        """Drop one lane's pin; at zero refs the adapter becomes
        evictable but stays resident."""
        aid = int(adapter_id)
        if aid == 0:
            return
        slot = self._slot_of.get(aid)
        if slot is None or self._refs[slot] < 1:
            raise RuntimeError(
                f"release of adapter {aid} without a matching acquire "
                "— the refcount ledger is corrupt")
        self._refs[slot] -= 1
        if self._refs[slot] == 0:
            self._lru[aid] = None
        self._set_gauges()

    # -- read side ----------------------------------------------------------

    def slabs(self):
        """The slab dict the decode step reads (built on first use)."""
        if self._slabs is None:
            if not self._registry:
                raise RuntimeError(
                    "AdapterPool.slabs() before any register()")
            self._build()
        return self._slabs

    def resident_ids(self) -> List[int]:
        """Resident adapter ids (pinned and warm), count-bounded."""
        ids = [aid for aid in self._ids if aid is not None]
        return ids[:self.INVENTORY_N]

    def census(self) -> dict:
        """Ledger partition check: every slot is exactly one of free,
        pinned or evictable, and the evictable set is the LRU.  Raises on
        a violation; returns the counts."""
        free = pinned = evictable = 0
        for s, aid in enumerate(self._ids):
            if aid is None:
                if self._refs[s] != 0:
                    raise AssertionError(
                        f"slot {s}: free but refs={self._refs[s]}")
                free += 1
            elif self._refs[s] > 0:
                if aid in self._lru:
                    raise AssertionError(
                        f"adapter {aid}: pinned AND evictable")
                pinned += 1
            else:
                if aid not in self._lru:
                    raise AssertionError(
                        f"adapter {aid}: zero refs but not in the "
                        "LRU order")
                evictable += 1
        if evictable != len(self._lru):
            raise AssertionError(
                f"LRU holds {len(self._lru)} ids but {evictable} "
                "slots are evictable")
        if free + pinned + evictable != (self.n_slots or 0):
            raise AssertionError("slot classes do not partition")
        return {"free": free, "pinned": pinned,
                "evictable": evictable}

    def stats(self) -> dict:
        resident = [aid for aid in self._ids if aid is not None]
        return {
            "slots": self.n_slots or 0,
            "registered": len(self._registry),
            "resident": len(resident),
            "resident_ids": self.resident_ids(),
            "pinned_refs": sum(self._refs),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "adapter_bytes": self._adapter_bytes or 0,
            "pool_bytes": ((self.n_slots or 0)
                           * (self._adapter_bytes or 0)),
        }

    def _set_gauges(self) -> None:
        resident = sum(1 for aid in self._ids if aid is not None)
        _telemetry.gauge("serving.adapter.resident").set(resident)
        _telemetry.gauge("serving.adapter.bytes").set(
            resident * (self._adapter_bytes or 0))
